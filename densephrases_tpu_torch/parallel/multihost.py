"""Multi-process index sharding: the process bootstrap, the shard layout,
the per-process shard assembly and the query broadcast.

The counterpart of ``densephrases_tpu/parallel/multihost.py``. Every
process joins one ``torch.distributed`` process group (one process a
device), memmaps only its own row range of the store, and uploads it to its
card; the flat search is one SPMD program: per-rank exact scans, then an
all-gather and top-k merge of the ``[B, K]`` candidates (``index/flat.py``).
Queries are broadcast from rank 0, so one frontend drives every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from densephrases_tpu_torch.parallel import Mesh, make_mesh, rank_and_size


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, *, backend: str) -> None:
    """Join the process group (one call a process, before any collective).
    coordinator_address: "host:port" (a TCP rendezvous) or any
    ``init_method`` URL ("tcp://...", "file://..."). backend: "nccl" for
    CUDA tensors, "gloo" for CPU tensors; the caller names it."""
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def global_mesh(axis: str = "shard", *, devices=None) -> Mesh:
    """The mesh over every process's device (rank order)."""
    return make_mesh(axis=axis, devices=devices)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def shard_layout(n_total: int, mesh: Mesh, axis: str = "shard",
                 chunk: int = 4096) -> Tuple[int, int]:
    """(shard_rows, chunk) of the stacked layout, the reference's
    arithmetic exactly (multihost.py:57-65, flat.py:207-213), so global row
    ids agree between the construction paths."""
    n_dev = mesh.shape[axis]
    chunk = min(chunk, max(512, _round_up(n_total // max(n_dev, 1) or 1, 8)))
    shard_rows = _round_up(
        max(n_total // n_dev + (n_total % n_dev > 0), 1), chunk)
    return shard_rows, chunk


def process_row_range(n_total: int, mesh: Mesh, axis: str = "shard",
                      chunk: int = 4096) -> Tuple[int, int]:
    """Global [lo, hi) rows THIS process loads from its store shard
    (clipped to n_total; the assembly pads the tail)."""
    shard_rows, _ = shard_layout(n_total, mesh, axis, chunk)
    lo = mesh.rank * shard_rows
    return min(lo, n_total), min(lo + shard_rows, n_total)


def flat_from_process_shards(local_rows: np.ndarray, n_total: int,
                             mesh: Optional[Mesh] = None,
                             axis: str = "shard", chunk: int = 4096,
                             offset: Optional[float] = None,
                             scale: Optional[float] = None):
    """A mesh ``FlatIndex`` from this process's store shard.

    local_rows: int8 [hi - lo, D], the rows ``process_row_range`` reported,
    in global row order. Every rank calls this with the same n_total, mesh
    and chunk. Search ids are GLOBAL row ids."""
    from densephrases_tpu_torch.index.flat import FlatIndex
    from densephrases_tpu_torch.ops.quant import DEFAULT_OFFSET, DEFAULT_SCALE

    mesh = mesh if mesh is not None else global_mesh(axis)
    shard_rows, chunk = shard_layout(n_total, mesh, axis, chunk)
    d = int(local_rows.shape[1])
    block = torch.zeros((1, shard_rows // chunk, chunk, d), dtype=torch.int8,
                        device=mesh.device)
    e = min(shard_rows, local_rows.shape[0])
    if e > 0:
        block.view(shard_rows, d)[:e].copy_(
            torch.from_numpy(np.array(local_rows[:e], np.int8)))
    return FlatIndex(
        block, offset=DEFAULT_OFFSET if offset is None else offset,
        scale=DEFAULT_SCALE if scale is None else scale, mesh=mesh,
        shard_axis=axis, chunk=chunk, n_total=n_total)


def broadcast_queries(queries: np.ndarray) -> np.ndarray:
    """Rank 0's queries on every rank (each passes an array of the same
    shape and dtype). A no-op in a single process. The tensor crosses on
    the card under NCCL, on the host under gloo."""
    _, size = rank_and_size()
    queries = np.asarray(queries)
    if size == 1:
        return queries
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.as_tensor(np.ascontiguousarray(queries), device=device)
    dist.broadcast(t, src=0)
    return t.cpu().numpy()
