"""What the harness hands the port: the system under test built from the
inputs the harness made, through the port's public constructors.

The port is imported inside the functions, so that the harness's other
modules (and its tests) import without it, and a checkout that lacks it
fails here, before any result is printed.
"""

from __future__ import annotations

import numpy as np
import torch

# the port's EncoderParams leaf of each DensePhrases embedding key
EMBED_ATTR = {"word": "word_emb", "pos": "pos_emb", "type": "type_emb",
              "ln_scale": "ln_scale", "ln_bias": "ln_bias"}


def bert_config(model: dict):
    from densephrases_tpu_torch.models.bert import BertConfig

    keys = ("vocab_size", "hidden_size", "num_hidden_layers",
            "num_attention_heads", "intermediate_size",
            "max_position_embeddings", "type_vocab_size", "layer_norm_eps",
            "initializer_range", "hidden_act")
    return BertConfig(**{k: model[k] for k in keys})


def encoder_params(model: dict, sd: dict, device):
    """The port's ``EncoderParams`` holding the state dict's two query
    towers, on ``device`` in the state dict's type, mapped by the keys of
    the port's checkpoint importer (``models/hf_import.py``: Linear
    weights transposed to [in, out]). The phrase tower and the filter head,
    which serving never runs, are zeros."""
    from densephrases_tpu_torch.models.encoder import EncoderParams
    from densephrases_tpu_torch.models.hf_import import (
        EMBED_KEYS, LAYER_KEYS, TOWER_PREFIXES)

    with torch.device("meta"):
        params = EncoderParams(bert_config(model))
    dtype = next(iter(sd.values())).dtype

    def put(module, name, t):
        module._parameters[name] = torch.nn.Parameter(t, requires_grad=False)

    for tower in ("query_start", "query_end"):
        prefix = TOWER_PREFIXES[tower][0]
        bert = getattr(params, tower)
        for leaf, key in EMBED_KEYS.items():
            put(bert, EMBED_ATTR[leaf], sd[prefix + key])
        for i, layer in enumerate(bert.layers):
            for leaf, (key, transpose) in LAYER_KEYS.items():
                t = sd[f"{prefix}encoder.layer.{i}.{key}"]
                put(layer, leaf, t.t().contiguous() if transpose else t)
    rest = [(sub, name, p.shape)
            for top in (params.phrase, params.filter)
            for sub in top.modules()
            for name, p in sub.named_parameters(recurse=False)]
    zeros = torch.zeros(sum(int(np.prod(s)) for _, _, s in rest),
                        dtype=dtype, device=device)
    at = 0
    for mod, name, shape in rest:
        n = int(np.prod(shape))
        put(mod, name, zeros[at:at + n].view(shape))
        at += n
    return params


def tokenizer(vocab: list):
    from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer

    return WordPieceTokenizer({t: i for i, t in enumerate(vocab)})


def phrase_store(codes: np.ndarray, layout: dict, offset: float,
                 scale: float):
    """An in-RAM ``PhraseStore`` over host int8 codes: docs of
    ``vecs_per_doc`` rows, every doc's metadata as ``layout`` gives it,
    doc i titled ``doc<i>``."""
    from densephrases_tpu_torch.index.store import DocMeta, PhraseStore

    vpd = layout["vecs_per_doc"]
    n_docs = codes.shape[0] // vpd
    meta = DocMeta(doc_id=0, title="doc0", context=layout["context"],
                   word2char_start=layout["word2char_start"],
                   word2char_end=layout["word2char_end"],
                   f2o_start=layout["f2o_start"]).compress()
    metas = [dict(meta, doc_id=i, title=f"doc{i}") for i in range(n_docs)]
    return PhraseStore(vecs=codes,
                       doc_bases=np.arange(n_docs + 1, dtype=np.int64) * vpd,
                       doc_ids=np.arange(n_docs, dtype=np.int64),
                       metas=metas, offset=offset, scale=scale, path=None)


def served_answers(results) -> list:
    """The port's result dicts of one query → (doc, title, start_pos,
    end_pos, text, score) tuples, best first."""
    return [(int(r["doc_idx"]), r["title"][0], int(r["start_pos"]),
             int(r["end_pos"]), r["answer"], float(r["score"]))
            for r in results]
