"""Top-k utilities: the counterpart of ``densephrases_tpu/ops/topk.py``.

``topk`` keeps the reference's tie rule (``lax.top_k``: equal values go to
the lower index) by a stable descending sort. ``topk_merge`` merges
per-shard or per-block top-k candidates (scores and global ids) into one
top-k; the tiered flat index merges its tiers with it, and sharded serving
merges per-device candidates with it after an all-gather.
"""

from __future__ import annotations

import torch


def topk(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last dim, ties
    to the lower index, sorted descending."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def topk_merge(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge candidate sets along the second-to-last dim.

    scores, ids: [..., S, K] per-shard top-k scores and their global ids.
    Returns (merged_scores [..., k], merged_ids [..., k]), sorted
    descending."""
    flat_scores = scores.reshape(scores.shape[:-2] + (-1,))
    flat_ids = ids.reshape(ids.shape[:-2] + (-1,))
    vals, pos = topk(flat_scores, k)
    return vals, torch.gather(flat_ids, -1, pos)
