"""Brute-force span oracle for checking the serve path.

For one query ``[q_start; q_end]`` it scores every span of the store on the
host — ``v[s]·q_start + v[e]·q_end`` over the dequantized int8 vectors,
with both ends in one document, ``e − s < max_answer_length`` and an f2o
distance in ``[0, max_answer_length]``, as ``_rescore_spans`` constrains
them — and checks that a search's top-1 result is the best span.

Stage 1 scores anchors with bf16-rounded queries (``index/flat.py``), so a
span whose exact score is within that rounding of the best one may win a
near-tie; ``check_top1`` accepts such a span and says so.
"""

from __future__ import annotations

import numpy as np
import torch

from densephrases_tpu_torch.index.store import PhraseStore


def check_top1(store: PhraseStore, query: np.ndarray, top1: dict,
               max_answer_length: int = 10) -> str:
    """``top1``: the first result dict of ``MIPS.search`` for ``query``.
    Returns "exact" or "near-tie"; raises AssertionError otherwise."""
    n, L = store.n_vecs, max_answer_length
    vf = store.vecs.astype(np.float32) / store.scale + store.offset
    qs, qe = np.split(np.asarray(query, np.float32), 2)
    ss, ee = vf @ qs, vf @ qe
    doc = np.searchsorted(store.doc_bases, np.arange(n), side="right") - 1
    f2o = store.f2o_flat()
    best = (-np.inf, 0, 0)
    for o in range(min(L, n)):
        s = np.arange(n - o)
        e = s + o
        dist = f2o[e] - f2o[s]
        ok = (doc[s] == doc[e]) & (dist >= 0) & (dist <= L)
        score = np.where(ok, ss[s] + ee[e], -np.inf)
        i = int(np.argmax(score))
        if score[i] > best[0]:
            best = (float(score[i]), int(s[i]), int(e[i]))
    score, s, e = best
    base = int(store.doc_bases[doc[s]])
    want = (int(store.doc_ids[doc[s]]), s - base, e - base)
    got = (top1["doc_idx"], top1["start_idx"], top1["end_idx"])
    if got == want:
        return "exact"
    # bound on what bf16 rounding of one query half moves an anchor score
    max_v = np.abs(vf).max(0)
    tol = 2 * max(
        float(np.abs(q - torch.from_numpy(q).to(torch.bfloat16).float()
                     .numpy()) @ max_v) for q in (qs, qe))
    gpos = int(np.nonzero(store.doc_ids == got[0])[0][0])
    gbase = int(store.doc_bases[gpos])
    got_score = float(ss[gbase + got[1]] + ee[gbase + got[2]])
    assert got_score >= score - tol, (
        f"top-1 {got} scores {got_score}, brute force {want} scores {score} "
        f"(bf16 tolerance {tol})")
    return "near-tie"
