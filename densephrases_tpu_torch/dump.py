"""Phrase dump: run the phrase tower over a corpus and write the store.

The counterpart of ``densephrases_tpu/dump.py``. A tokenize-ahead thread
turns docs into 512-token windows (``tokenize_ahead`` docs deep) while the
device encodes the previous batch; windows from many docs are batched
together, the last batch padded with all-zero rows (fully masked, so they
reach the attention kernel as rows that mask every key); per-doc vectors
are reassembled on the host,
filtered, quantized to int8 and appended to the store as soon as the window
stream moves past the doc. The store format is the reference's, byte for
byte.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from densephrases_tpu_torch.data.features import (
    ContextFeatures,
    DocContext,
    convert_context_to_features,
)
from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer
from densephrases_tpu_torch.index.store import DocMeta, PhraseStore, StoreWriter
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import EncoderParams, embed_phrase
from densephrases_tpu_torch.ops.quant import float_to_int8

logger = logging.getLogger(__name__)


def _phrase_forward(params: EncoderParams, ids, am, tt,
                    attn_impl: str = "auto"):
    """One batch of windows → host arrays (start [B, L, H], filter start and
    end logits [B, L]) in a single device→host copy."""
    dev = params.device
    start, _end, f_s, f_e = embed_phrase(
        params, torch.as_tensor(ids, device=dev), torch.as_tensor(am, device=dev),
        torch.as_tensor(tt, device=dev), attn_impl=attn_impl)
    out = torch.cat([start, f_s[..., None], f_e[..., None]], -1).cpu().numpy()
    return out[..., :-2], out[..., -2], out[..., -1]


def filter_and_quantize(doc_vecs: np.ndarray, f_start: np.ndarray,
                        f_end: np.ndarray, threshold: float,
                        offset: float, scale: float):
    """Keep the union of start/end filter survivors
    (ref: embed_utils.py:117-138). Returns (codes int8, f2o int32)."""
    keep = (f_start > threshold) | (f_end > threshold)
    idxs = np.nonzero(keep)[0]
    if len(idxs) == 0:
        idxs = np.asarray([0], np.int64)  # keep one vector (ref behavior)
    codes = float_to_int8(doc_vecs[idxs], offset, scale)
    return codes, idxs.astype(np.int32)


def dump_phrases(
    params: EncoderParams,
    config: BertConfig,
    tokenizer: WordPieceTokenizer,
    docs: Iterable[dict],
    store_path: str,
    *,
    max_seq_length: int = 512,
    filter_threshold: float = -1e8,
    batch_size: int = 16,
    offset: float = -2.0,
    scale: float = 20.0,
    attn_impl: str = "auto",
    append_title: bool = True,
    first_passage: bool = False,
    tokenize_ahead: int = 4,
    _stats: Optional[dict] = None,
) -> PhraseStore:
    """docs: iterable of {'doc_id': int, 'title': str, 'paragraphs': [str]}.
    The phrase tower runs on ``params``' device, its attention by
    ``attn_impl`` (``models/attention.py``).

    append_title: prefix each window with the doc's title (``data/
    features.py``). first_passage: index only each doc's first paragraph
    (ref: build_phrase_index.py:204-210). tokenize_ahead: bound, in docs, on
    the tokenizer→encoder queue.
    Resume: docs already in the store are skipped.
    _stats: optional dict; records peak buffered features/open docs and the
    number of windows encoded."""
    writer = StoreWriter(store_path, config.hidden_size, offset, scale)

    q: "queue.Queue" = queue.Queue(maxsize=max(1, tokenize_ahead))

    def produce():
        try:
            for doc in docs:
                did = int(doc["doc_id"])
                if writer.has_doc(did):
                    continue
                paragraphs = (doc["paragraphs"][:1] if first_passage
                              else doc["paragraphs"])
                feats, doc_ctx = convert_context_to_features(
                    did, doc.get("title", ""), paragraphs, tokenizer,
                    max_seq_length=max_seq_length, append_title=append_title)
                if feats:
                    q.put((did, doc_ctx, feats))
            q.put(None)
        except BaseException as e:  # noqa: BLE001 — surface in consumer
            q.put(e)

    threading.Thread(target=produce, daemon=True,
                     name="dump-tokenize-ahead").start()

    doc_ctxs: Dict[int, DocContext] = {}
    pending: Dict[int, List[np.ndarray]] = {}
    buf: List[ContextFeatures] = []

    def flush_doc(did: int):
        parts = pending.pop(did)
        doc_vecs = np.concatenate([p[0] for p in parts], axis=0)
        doc_fs = np.concatenate([p[1] for p in parts], axis=0)
        doc_fe = np.concatenate([p[2] for p in parts], axis=0)
        codes, f2o = filter_and_quantize(
            doc_vecs, doc_fs, doc_fe, filter_threshold, offset, scale)
        ctx = doc_ctxs.pop(did)
        # word2char maps are per *token* position (ref: embed_utils.py:89-105):
        w2c_start = ctx.word_char_start[ctx.tok2word]
        w2c_end = ctx.word_char_end[ctx.tok2word]
        meta = DocMeta(
            doc_id=did, title=ctx.title, context=ctx.context,
            word2char_start=w2c_start.astype(np.int32),
            word2char_end=w2c_end.astype(np.int32),
            f2o_start=f2o,
        )
        writer.add_doc(meta, codes)

    done = False
    open_doc: Optional[int] = None
    peak_feats = peak_docs = n_windows = 0
    while True:
        while not done and len(buf) < batch_size:
            item = q.get()
            if item is None:
                done = True
                break
            if isinstance(item, BaseException):
                raise item
            did, doc_ctx, feats = item
            doc_ctxs[did] = doc_ctx
            buf.extend(feats)
        if not buf:
            break
        peak_feats = max(peak_feats, len(buf))
        peak_docs = max(peak_docs, len(doc_ctxs))
        chunk, buf = buf[:batch_size], buf[batch_size:]
        n_windows += len(chunk)
        ids = np.stack([f.input_ids for f in chunk])
        am = np.stack([f.attention_mask for f in chunk])
        tt = np.stack([f.token_type_ids for f in chunk])
        if len(chunk) < batch_size:
            extra = batch_size - len(chunk)
            ids = np.concatenate([ids, np.zeros((extra,) + ids.shape[1:], ids.dtype)])
            am = np.concatenate([am, np.zeros((extra,) + am.shape[1:], am.dtype)])
            tt = np.concatenate([tt, np.zeros((extra,) + tt.shape[1:], tt.dtype)])
        s, f_s, f_e = _phrase_forward(params, ids, am, tt, attn_impl)
        for j, f in enumerate(chunk):
            c0, c1 = f.content_start, f.content_start + f.content_len
            pending.setdefault(f.doc_id, []).append(
                (s[j, c0:c1], f_s[j, c0:c1], f_e[j, c0:c1]))
            if open_doc is not None and open_doc != f.doc_id \
                    and open_doc in pending:
                flush_doc(open_doc)
            open_doc = f.doc_id
    for did in list(pending):
        flush_doc(did)

    if _stats is not None:
        _stats["peak_buffered_features"] = peak_feats
        _stats["peak_open_docs"] = peak_docs
        _stats["windows"] = n_windows

    store = writer.finalize()
    logger.info("dumped %d docs, %d vectors to %s",
                store.num_docs, store.n_vecs, store_path)
    return store
