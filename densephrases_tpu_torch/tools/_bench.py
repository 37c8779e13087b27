"""Helpers the measurement tools share: where they write by default, how
they time, recall, the bound of a kernel's work, and the JSON they merge
their rows into.

Every tool writes under ``default_workdir()`` unless the caller passes
paths: a directory in the system's temp dir, never the repository (a
corpus memmap there would make the tree too large to copy).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

# the H100 SXM's published peaks (data sheet, dense rates at 700 W): HBM3
# bytes/s, and ops/s for bf16 products on the tensor cores and fp32
# products and adds on the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def default_workdir() -> str:
    """The tools' cache directory: corpora, ground truth, index saves."""
    return os.path.join(tempfile.gettempdir(), "densephrases_tpu_torch_bench")


def default_out(name: str) -> str:
    """The default path of a tool's JSON result."""
    return os.path.join(default_workdir(), name)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_ms(fn, device, n_rep: int = 5, warmup: int = 2) -> float:
    """Median wall ms of fn() on the synchronised host clock."""
    for _ in range(warmup):
        fn()
    sync(device)
    ts = []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(statistics.median(ts))


def device_ms(fn, device, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of fn over ``iters`` calls: CUDA events on the card, the
    host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float, kind: str):
    """(bound_ms, bound_by): the least time the card could take for
    ``ops`` operations of type ``kind`` that move ``nbytes``."""
    t_ops, t_bytes = ops / PEAK_OPS_PER_S[kind], nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes")


def recall(ids, exact) -> float:
    """Mean share of each row's exact ids found in its returned ids."""
    ids, exact = np.asarray(ids), np.asarray(exact)
    return float(np.mean([len(set(a.tolist()) & set(b.tolist()))
                          / exact.shape[1] for a, b in zip(ids, exact)]))


def merge_rows(out: str, key: str, row: dict) -> dict:
    """Put ``row`` under ``rows[key]`` of the JSON at ``out`` (made if
    missing) and return the whole blob."""
    blob = {}
    if os.path.exists(out):
        try:
            with open(out) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            blob = {}
    blob.setdefault("rows", {})[key] = row
    write_json(out, blob)
    return blob


def write_json(out: str, blob: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(blob, f, indent=1)


@contextlib.contextmanager
def uncounted(*kernels):
    """Leave the kernels' launch counters as they were (timing runs)."""
    before = [k.launches for k in kernels]
    try:
        yield
    finally:
        for k, n in zip(kernels, before):
            k.launches = n


def device_tensor_bytes(*objs) -> int:
    """Bytes of the distinct device tensors among ``objs`` (dict values
    are looked into; anything else is skipped)."""
    seen, total = set(), 0
    stack = list(objs)
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, torch.Tensor) and x.data_ptr() not in seen:
            seen.add(x.data_ptr())
            total += x.numel() * x.element_size()
    return total


def allocated(device) -> int:
    """``torch.cuda.memory_allocated`` on the card (after a sync), else 0."""
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize()
    return int(torch.cuda.memory_allocated())


class EncodeOnly:
    """The ``mips`` of a ``DensePhrases`` that only encodes queries: all
    the facade reads of it is its device."""

    def __init__(self, device):
        self.device = device
