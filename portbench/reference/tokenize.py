"""Whole-word tokenization of the benchmark's queries: every query is
lowercase vocab words separated by spaces, so a token is a word. Unknown
words map to [UNK]; [CLS] ... [SEP], cut and padded to ``max_len``."""

from __future__ import annotations

import numpy as np


def encode(texts, vocab: list, max_len: int):
    """→ (ids [B, max_len] int64, mask [B, max_len] int64) numpy arrays."""
    index = {t: i for i, t in enumerate(vocab)}
    cls, sep, unk = index["[CLS]"], index["[SEP]"], index["[UNK]"]
    pad = index["[PAD]"]
    ids = np.full((len(texts), max_len), pad, np.int64)
    mask = np.zeros((len(texts), max_len), np.int64)
    for r, text in enumerate(texts):
        toks = [index.get(w, unk) for w in text.lower().split()]
        row = [cls] + toks[:max_len - 2] + [sep]
        ids[r, :len(row)] = row
        mask[r, :len(row)] = 1
    return ids, mask
