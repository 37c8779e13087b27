"""Query traffic: batches of questions or mentions made of vocab words.

The parameters come from a traffic file (``traffic/<mix>.json``):

- ``batch``: queries a request;
- ``words``: [lo, hi], the words of a query. Each request (or, for a
  batch smaller than the range, each run of requests that covers it once)
  takes every length of the range equally often, in an order drawn from
  the seed, so every seed sends the same set of sizes;
- ``lead``: words a query starts with (a question's wh-word), or none;
- the serve options, which the route reads.

Request i depends on the seed and i alone.
"""

from __future__ import annotations

import numpy as np


def lengths(params: dict, seed: int, i: int) -> np.ndarray:
    """The word counts of request i's queries."""
    lo, hi = params["words"]
    span = np.arange(lo, hi + 1)
    batch = params["batch"]
    reps = -(-batch // len(span))
    cycle = len(span) * reps  # queries of a run that covers the range
    if cycle % batch:
        raise ValueError(f"batch {batch} and {len(span)} lengths: a run of "
                         "requests cannot cover the range evenly")
    per = cycle // batch  # requests a run
    rng = np.random.default_rng([seed, 0, i // per])
    order = rng.permutation(np.repeat(span, reps))
    j = i % per
    return order[j * batch:(j + 1) * batch]


def request(params: dict, words: list, lead: list, seed: int,
            i: int) -> list:
    """Request i: ``batch`` query texts."""
    rng = np.random.default_rng([seed, 1, i])
    out = []
    for n in lengths(params, seed, i):
        toks = [words[j] for j in rng.integers(0, len(words), int(n))]
        if lead:
            toks[0] = lead[int(rng.integers(0, len(lead)))]
        out.append(" ".join(toks))
    return out


def stream(params: dict, vocab: list, seed: int):
    """Requests 0, 1, 2, ... as lists of query texts; ``seed`` is the
    run's traffic stream."""
    lead = list(params.get("lead", []))
    skip = set(lead) | {t for t in vocab if t.startswith("[")}
    words = [w for w in vocab if w not in skip]
    i = 0
    while True:
        yield request(params, words, lead, seed, i)
        i += 1
