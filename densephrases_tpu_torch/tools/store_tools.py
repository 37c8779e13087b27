"""Store maintenance: integrity check, re-filter, split, stats.

Host copy of ``densephrases_tpu/tools/store_tools.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Parity with ref: scripts/dump/check_dump.py:21-49 (range contiguity +
corruption scan), filter_hdf5.py (re-filter a dump to a smaller index),
split_hdf5.py (split ranges), filter_stats.py (threshold → size tradeoff),
save_meta.py.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from densephrases_tpu_torch.index.store import DocMeta, PhraseStore, StoreWriter

logger = logging.getLogger(__name__)


def check_store(path: str) -> Dict[str, object]:
    """Integrity scan (ref: check_dump.py:21-49): doc-base monotonicity,
    vec-count consistency, metadata decompressibility, offset-map bounds."""
    store = PhraseStore.load(path, mmap=True)
    problems: List[str] = []
    bases = np.asarray(store.doc_bases)
    if not (np.diff(bases) >= 0).all():
        problems.append("doc_bases not monotonically non-decreasing")
    if int(bases[-1]) != store.n_vecs:
        problems.append(
            f"doc_bases end {int(bases[-1])} != n_vecs {store.n_vecs}")
    if len(store.metas) != store.num_docs:
        problems.append("metas length != num_docs")
    for dpos in range(store.num_docs):
        try:
            m = store.meta(dpos)
        except Exception as e:  # noqa: BLE001 — corruption scan
            problems.append(f"doc {dpos}: metadata decompress failed ({e})")
            continue
        n_vecs = int(bases[dpos + 1] - bases[dpos])
        if len(m.f2o_start) != n_vecs:
            problems.append(f"doc {dpos}: f2o {len(m.f2o_start)} != vecs {n_vecs}")
        if len(m.word2char_start) and m.f2o_start.size:
            if int(m.f2o_start.max()) >= len(m.word2char_start):
                problems.append(f"doc {dpos}: f2o out of word2char range")
            if len(m.context) and int(m.word2char_end.max()) > len(m.context):
                problems.append(f"doc {dpos}: char offsets beyond context")
    report = {"ok": not problems, "problems": problems,
              "num_docs": store.num_docs, "n_vecs": store.n_vecs}
    logger.info("check_store %s: %s", path,
                "OK" if report["ok"] else problems[:5])
    return report


def filter_store(in_path: str, out_path: str, keep_fraction: float = 0.5,
                 scores: Optional[np.ndarray] = None) -> PhraseStore:
    """Re-filter a store to fewer vectors per doc (ref: filter_hdf5.py).

    scores: optional per-row keep score [n_vecs] (e.g. saved filter logits);
    without scores the first `keep_fraction` of each doc's rows are kept."""
    store = PhraseStore.load(in_path, mmap=True)
    writer = StoreWriter(out_path, store.dim, store.offset, store.scale)
    for dpos in range(store.num_docs):
        b0, b1 = int(store.doc_bases[dpos]), int(store.doc_bases[dpos + 1])
        meta = store.meta(dpos)
        n = b1 - b0
        if n == 0:
            continue
        if scores is not None:
            k = max(1, int(n * keep_fraction))
            keep = np.sort(np.argsort(-scores[b0:b1])[:k])
        else:
            keep = np.arange(max(1, int(n * keep_fraction)))
        new_meta = DocMeta(
            doc_id=meta.doc_id, title=meta.title, context=meta.context,
            word2char_start=meta.word2char_start,
            word2char_end=meta.word2char_end,
            f2o_start=meta.f2o_start[keep],
        )
        writer.add_doc(new_meta, store.vec_rows(dpos)[keep])
    return writer.finalize()


def split_store(in_path: str, out_dir: str, n_shards: int) -> List[str]:
    """Split a store into doc-contiguous shards (ref: split_hdf5.py)."""
    store = PhraseStore.load(in_path, mmap=True)
    per = (store.num_docs + n_shards - 1) // n_shards
    paths = []
    for s in range(n_shards):
        lo, hi = s * per, min((s + 1) * per, store.num_docs)
        if lo >= hi:
            break
        path = os.path.join(out_dir, f"shard_{s:03d}")
        writer = StoreWriter(path, store.dim, store.offset, store.scale)
        for dpos in range(lo, hi):
            writer.add_doc_raw(int(store.doc_ids[dpos]),
                               store.vec_rows(dpos),
                               store.meta_compressed(dpos))
        writer.finalize()
        paths.append(path)
    return paths


def store_stats(path: str) -> Dict[str, float]:
    """Size/threshold stats (ref: filter_stats.py): bytes per component and
    vectors-per-doc distribution."""
    store = PhraseStore.load(path, mmap=True)
    lens = np.diff(np.asarray(store.doc_bases))
    vec_bytes = store.n_vecs * store.dim
    meta_bytes = sum(
        len(m["context"]) + len(m["word2char_start"])
        + len(m["word2char_end"]) + len(m["f2o_start"])
        for m in store.metas)
    return {
        "num_docs": store.num_docs, "n_vecs": store.n_vecs,
        "vec_bytes": int(vec_bytes), "meta_bytes_compressed": int(meta_bytes),
        "vecs_per_doc_mean": float(lens.mean()) if len(lens) else 0.0,
        "vecs_per_doc_max": int(lens.max()) if len(lens) else 0,
    }
