"""Parallel dump orchestration: file ranges, size-balanced bins, worker
processes and the shard merge.

The counterpart of ``densephrases_tpu/tools/parallel_dump.py`` (ref:
scripts/parallel/dump_phrases.py, scripts/parallel/add_to_index.py). Each
worker is a ``generate_phrase_vecs`` process on its own device over its
own file range, writing ``phrase_shard_{i}``; ``merge_shards`` concatenates
the shards into one store. A worker numbers its docs from 0, as the
reference's do; the merge offsets each shard's doc ids by the docs before
it, so the merged store equals one dump of all the files (the reference's
merge keeps every shard's ids, which repeat; ROADMAP Queue 3).
"""

from __future__ import annotations

import logging
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


def make_ranges(n_files: int, n_workers: int) -> List[Tuple[int, int]]:
    """Even contiguous file ranges (ref: dump_phrases.py:27-38)."""
    per = math.ceil(n_files / n_workers)
    return [(i * per, min((i + 1) * per, n_files))
            for i in range(n_workers) if i * per < n_files]


def bin_by_size(sizes: Dict[str, int], n_bins: int) -> List[List[str]]:
    """Size-balanced binning, largest-first greedy
    (ref: add_to_index.py:14-23 bin_names)."""
    bins: List[List[str]] = [[] for _ in range(n_bins)]
    totals = [0] * n_bins
    for name in sorted(sizes, key=lambda k: -sizes[k]):
        i = totals.index(min(totals))
        bins[i].append(name)
        totals[i] += sizes[name]
    return [b for b in bins if b]


def run_parallel_dump(data_dir: str, dump_dir: str, load_dir: str,
                      n_workers: int = 4, max_seq_length: int = 512,
                      filter_threshold: float = -1e8, draft: bool = False,
                      extra_args: Optional[Sequence[str]] = None,
                      dry_run: bool = False, *,
                      devices: Optional[Sequence[str]] = None,
                      timeout: Optional[float] = None) -> List[List[str]]:
    """Launch one ``generate_phrase_vecs`` process per file range, worker i
    on ``devices[i % len(devices)]`` (None: "cuda:i" over the visible
    cards; workers may share a device). Each writes ``phrase_shard_{i}``;
    merge with ``merge_shards``. Returns the commands (and runs them unless
    dry_run); a worker that fails raises, after every worker has ended."""
    if devices is None:
        import torch

        from densephrases_tpu_torch.utils.device import resolve_device

        resolve_device("cuda")  # raises without a GPU
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    n_files = len([n for n in os.listdir(data_dir) if n.endswith(".json")])
    cmds = []
    for i, (lo, hi) in enumerate(make_ranges(n_files, n_workers)):
        cmd = [sys.executable, "-m",
               "densephrases_tpu_torch.cli.generate_phrase_vecs",
               "--load_dir", load_dir, "--data_dir", data_dir,
               "--predict_file", f"{lo}:{hi}",
               "--dump_dir", dump_dir,
               "--phrase_dir", f"phrase_shard_{i}",
               "--max_seq_length", str(max_seq_length),
               "--index_filter", str(filter_threshold),
               "--device", str(devices[i % len(devices)])]
        if draft:
            cmd.append("--draft")
        cmd.extend(extra_args or [])
        cmds.append(cmd)
    if not dry_run:
        procs = [subprocess.Popen(c) for c in cmds]
        rcs = []
        try:
            for p in procs:
                rcs.append(p.wait(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [rc for rc in rcs if rc != 0]
        if bad:
            raise RuntimeError(f"dump worker failed rc={bad[0]}")
    return cmds


def merge_shards(dump_dir: str, out_name: str = "phrase") -> str:
    """Concatenate the shard stores, in worker order, into the final store
    (``PhraseStore.merge``, which offsets each shard's doc ids by the docs
    of the shards before it)."""
    from densephrases_tpu_torch.index.store import PhraseStore

    names = [n for n in os.listdir(dump_dir) if n.startswith("phrase_shard_")]
    shards = [os.path.join(dump_dir, n) for n in
              sorted(names, key=lambda n: int(n.rsplit("_", 1)[1]))]
    out = os.path.join(dump_dir, out_name)
    PhraseStore.merge(shards, out)
    logger.info("merged %d shards → %s", len(shards), out)
    return out
