"""The comparison that decides ``correct``.

For each sampled request the reference (``reference/``) encodes the
queries in float32 and searches the same corpus. Two numbers are compared,
in units of each query's score spread (the standard deviation of a start
score over all rows plus that of an end score):

- ``score_gap``: the widest distance, over every sampled answer, between
  a served answer's score and the reference's score of the same span.
  It holds the query towers and both stages' arithmetic to float32, and
  catches an answer altered where it is made;
- ``rank_gap_mean``: how far the reference's score of the r-th served
  answer lies below the reference's r-th best answer, averaged over every
  rank r of the reference's lists. It holds stage 1 and stage 2 to
  finding the answers the reference finds. Its widest value,
  ``rank_gap``, is reported beside it and not compared: one start hit
  kept or cut at stage 1's top-k boundary (rank 10 against 11, a swap
  that rounding decides) adds or drops a whole span, whose joint score
  may be the query's best, so the widest gap swings from seed to seed.

A missing answer reads infinity; so does a served answer whose doc,
title, offsets or text do not name a span the query could have (a span of
one doc, ``max_answer_length`` words at most).

Served answers are (doc, title, start_pos, end_pos, text, score).
"""

from __future__ import annotations

import math

INF = float("inf")


def span_of(answer, layout: dict, n_docs: int, max_len: int):
    """The (start row, end row) a served answer names, or None when it
    names no span of the corpus."""
    doc, title, sp, ep, text, _ = answer
    vpd = layout["vecs_per_doc"]
    if not (0 <= doc < n_docs and title == f"doc{doc}"):
        return None
    if sp % 5 or (ep - 4) % 5:
        return None
    sl, el = sp // 5, (ep - 4) // 5
    if not (0 <= sl <= el < vpd and el - sl < max_len):
        return None
    if text != layout["context"][sp:ep]:
        return None
    return doc * vpd + sl, doc * vpd + el


def judge(served, ref_answers, units, span_score, *, layout, n_docs,
          top_k: int, max_len: int) -> dict:
    """served: per query, the port's answers (best first); ref_answers:
    per query the reference's; units: per query its score spread;
    span_score(pairs) → the reference's scores of [(query, s_row, e_row)].
    → {"score_gap", "rank_gap_mean", "rank_gap", "answers"}."""
    pairs, where = [], []
    bad = 0
    for qi, ans in enumerate(served):
        for r, a in enumerate(ans[:top_k]):
            span = span_of(a, layout, n_docs, max_len)
            if span is None:
                bad += 1
                continue
            pairs.append((qi, span[0], span[1]))
            where.append((qi, r))
    ref_of = dict(zip(where, span_score(pairs) if pairs else []))
    score_gap, rank_gap = (INF, INF) if bad else (0.0, -INF)
    n, gaps = 0, []
    for qi, (ans, ref) in enumerate(zip(served, ref_answers)):
        unit = units[qi]
        for r, a in enumerate(ans[:top_k]):
            if (qi, r) in ref_of:
                n += 1
                score_gap = max(score_gap,
                                abs(a[5] - ref_of[qi, r]) / unit)
        for r, best in enumerate(ref[:top_k]):
            got = ref_of.get((qi, r), -INF)
            gap = (best["score"] - got) / unit
            gap = gap if math.isfinite(gap) else INF
            rank_gap = max(rank_gap, gap)
            gaps.append(gap)
    mean = sum(gaps) / len(gaps) if gaps and not bad else INF
    return {"score_gap": score_gap, "rank_gap_mean": mean,
            "rank_gap": rank_gap, "answers": n}


def verdict(numbers: dict, limits: dict) -> bool:
    """Correct when every limited number is at or under its limit."""
    return all(numbers[k] <= lim for k, lim in limits.items())
