"""Single-passage reading with the cross-encoder.

The counterpart of ``densephrases_tpu/eval/reader.py`` (ref
run_demo.py:151-272 serve_bert_encoder; embed_utils.py:432-524,
squad_utils.py:1641-1685): the teacher reads (question, passage) pairs and
extracts the answer span. The cross tower's forward runs on the params'
device (kernel A for CUDA tensors); the input building and the span search
on the host are copies of the reference's.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch

from densephrases_tpu_torch.data.features import whitespace_split
from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer
from densephrases_tpu_torch.models.bert import BertConfig

logger = logging.getLogger(__name__)


def build_cq_inputs(questions: List[str], passages: List[str],
                    tokenizer: WordPieceTokenizer, max_length: int = 384):
    """[CLS] question [SEP] passage [SEP] inputs + token→passage-word maps."""
    batch_ids, batch_mask, batch_types, word_maps, words_all = [], [], [], [], []
    q_ids_all = tokenizer.encode_batch_ids(questions)
    for q_ids, passage in zip(q_ids_all, passages):
        words, _ = whitespace_split(passage)
        p_ids: List[int] = []
        tok2word: List[int] = []
        for wi, w in enumerate(words):
            sub = tokenizer.convert_tokens_to_ids(tokenizer.tokenize_word(w))
            p_ids.extend(sub)
            tok2word.extend([wi] * len(sub))
        head = [tokenizer.cls_token_id] + q_ids[:60] + [tokenizer.sep_token_id]
        room = max_length - len(head) - 1
        p_ids = p_ids[:room]
        tok2word = tok2word[:room]
        ids = head + p_ids + [tokenizer.sep_token_id]
        pad = max_length - len(ids)
        batch_ids.append(ids + [tokenizer.pad_token_id] * pad)
        batch_mask.append([1] * len(ids) + [0] * pad)
        types = [0] * len(head) + [1] * (len(p_ids) + 1) + [0] * pad
        batch_types.append(types)
        # token position in input_ids → passage word index (-1 outside)
        wm = np.full(max_length, -1, np.int32)
        wm[len(head): len(head) + len(tok2word)] = tok2word
        word_maps.append(wm)
        words_all.append(words)
    return (np.asarray(batch_ids, np.int32), np.asarray(batch_mask, np.int32),
            np.asarray(batch_types, np.int32), np.stack(word_maps), words_all)


def read_passages(cross_params, config: BertConfig,
                  tokenizer: WordPieceTokenizer,
                  questions: List[str], passages: List[str],
                  max_length: int = 384, max_answer_words: int = 10,
                  attn_impl: str = "auto", *,
                  compute_dtype: torch.dtype = torch.bfloat16) -> List[dict]:
    """Extract the best answer span from each (question, passage) pair.
    ``cross_params``: a ``CrossParams`` (or any module with ``cross`` and
    ``qa_outputs``) on the device to read on. Returns [{'answer', 'score',
    'start_pos', 'end_pos', 'context'}] with char offsets into the
    whitespace-normalized passage."""
    ids, mask, types, word_maps, words_all = build_cq_inputs(
        questions, passages, tokenizer, max_length)
    dev = cross_params.qa_outputs.w.device
    with torch.no_grad():
        hidden = cross_params.cross(
            *(torch.as_tensor(x, device=dev) for x in (ids, mask, types)),
            attn_impl=attn_impl, compute_dtype=compute_dtype)
        logits = cross_params.qa_outputs(hidden).cpu().numpy()
    s_log, e_log = logits[..., 0], logits[..., 1]

    out = []
    for bi in range(len(questions)):
        valid = word_maps[bi] >= 0
        s = np.where(valid, s_log[bi], -1e9)
        e = np.where(valid, e_log[bi], -1e9)
        s_top = np.argsort(-s)[:10]
        best = (-1e18, 0, 0)
        for si in s_top:
            for ei in range(si, min(si + 30, len(e))):
                if not valid[ei]:
                    break
                if word_maps[bi][ei] - word_maps[bi][si] >= max_answer_words:
                    break
                sc = float(s[si] + e[ei])
                if sc > best[0]:
                    best = (sc, int(si), int(ei))
        score, si, ei = best
        words = words_all[bi]
        w0, w1 = int(word_maps[bi][si]), int(word_maps[bi][ei])
        norm = " ".join(words)
        starts = np.cumsum([0] + [len(w) + 1 for w in words])
        out.append({
            "answer": " ".join(words[w0:w1 + 1]),
            "score": score,
            "start_pos": int(starts[w0]),
            "end_pos": int(starts[w1] + len(words[w1])),
            "context": norm,
        })
    return out
