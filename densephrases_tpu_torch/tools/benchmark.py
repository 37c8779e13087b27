"""Micro-benchmarks + shared benchmark-data construction.

Host copy of ``densephrases_tpu/tools/benchmark.py``: the port never
imports the JAX package, whose ``__init__`` imports jax. Keep the two
in step.

Parity with ref: scripts/benchmark/benchmark_hdf5.py:13-16 (store read
throughput) and scripts/benchmark/create_benchmark_data.py (the shared
1000-question NQ dev fixture in multiple system formats).
"""

from __future__ import annotations

import json
import time
from typing import Dict, List

import numpy as np


def benchmark_store_read(store_path: str, n_reads: int = 1000,
                         window: int = 10, seed: int = 0) -> Dict[str, float]:
    """Random window reads from the flat store (the serve-time stage-2
    access pattern) — replaces the HDF5 read microbenchmark."""
    from densephrases_tpu_torch import native
    from densephrases_tpu_torch.index.store import PhraseStore

    store = PhraseStore.load(store_path, mmap=True)
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, max(store.n_vecs - window, 1), n_reads)
    idx = (starts[:, None] + np.arange(window)[None, :]).astype(np.int64)
    mat = np.asarray(store.vecs) if not isinstance(store.vecs, np.memmap) \
        else store.vecs

    t0 = time.perf_counter()
    out = native.gather_rows(np.ascontiguousarray(mat), idx)
    dt = time.perf_counter() - t0
    bytes_read = out.nbytes
    return {
        "reads_per_sec": n_reads / dt,
        "mb_per_sec": bytes_read / dt / 1e6,
        "total_s": dt,
    }


def create_benchmark_data(qa_path: str, out_prefix: str,
                          n_questions: int = 1000, seed: int = 1):
    """Subsample a fixed benchmark question set and write it in the three
    formats the reference ships (ref: create_benchmark_data.py):
    - {prefix}_denspi.json  : {'data': [{'id','question','answers'}]}
    - {prefix}_dpr.csv      : tab-separated question \t answers-json
    - {prefix}_orqa.jsonl   : {'question', 'answer': [..]} per line
    """
    from densephrases_tpu_torch.data.qa import load_qa_pairs

    qids, questions, answers = load_qa_pairs(qa_path)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(questions))[:n_questions]

    denspi = {"data": [
        {"id": qids[i], "question": questions[i], "answers": answers[i]}
        for i in order]}
    with open(out_prefix + "_denspi.json", "w") as f:
        json.dump(denspi, f)
    with open(out_prefix + "_dpr.csv", "w") as f:
        for i in order:
            f.write(questions[i].replace("\t", " ") + "\t"
                    + json.dumps(answers[i]) + "\n")
    with open(out_prefix + "_orqa.jsonl", "w") as f:
        for i in order:
            f.write(json.dumps({"question": questions[i],
                                "answer": answers[i]}) + "\n")
    return len(order)
