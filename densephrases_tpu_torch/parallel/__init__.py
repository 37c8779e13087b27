"""Meshes as process groups, and the collectives that training, indexing
and serving share.

The counterpart of ``densephrases_tpu/parallel/__init__.py``. The reference
has two ways to use several devices: a single-controller ``jax.sharding.
Mesh`` with ``shard_map``, and multi-controller ``jax.distributed``. The
port uses PyTorch's one idiom for both, SPMD over ``torch.distributed``
with one process per device:

- a ``Mesh`` is the 1-D default process group: its axis name, this rank,
  the world size (``mesh.shape[axis]``) and this rank's device. A process
  that joined no group is a mesh of one, whose collectives are the
  identity;
- ``shard_put`` keeps this rank's contiguous slice of the leading dim (the
  rows ``NamedSharding(P(axis))`` gives the rank's device), and
  ``replicate_put`` the whole;
- ``all_gather`` concatenates every rank's tensor along dim 0, and
  ``all_gather_grad`` is its differentiable form, the counterpart of
  ``jax.lax.all_gather(..., tiled=True)``: its backward is JAX's transpose,
  a sum-scatter (``all_reduce(SUM)`` of the cotangent, then this rank's
  slice), which holds on NCCL and gloo alike;
- ``pmean`` averages a list of tensors over the ranks as one flat buffer.

The backend is the caller's choice (``parallel/multihost.py:
init_multihost``, or ``torchrun``'s environment): "nccl" for CUDA tensors,
"gloo" for CPU ones. Nothing here picks or swaps it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from densephrases_tpu_torch.utils.device import resolve_device

__all__ = ["Mesh", "make_mesh", "shard_put", "replicate_put", "all_gather",
           "all_gather_grad", "pmean", "rank_and_size"]


def rank_and_size():
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the default process group under one axis name, with
    this rank's device."""

    axis: str
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


def _rank_device():
    """This process's card: ``cuda:$LOCAL_RANK`` under ``torchrun``, else
    the current CUDA device. Raises without a GPU."""
    local = os.environ.get("LOCAL_RANK")
    return resolve_device("cuda" if local is None else f"cuda:{int(local)}")


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh over the default process group (a mesh of one without a
    group). n_devices: must equal the world size when given; the port's
    mesh is one device a rank, and a sub-mesh would need a subgroup.
    devices: the rank-indexed device list (one entry a rank; entries may
    repeat, e.g. several gloo ranks on one card); None: this process's
    card."""
    rank, size = rank_and_size()
    if n_devices is not None and n_devices != size:
        raise RuntimeError(f"need {n_devices} devices, the process group "
                           f"has {size} ranks of one device each")
    if devices is None:
        device = _rank_device()
    else:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        device = resolve_device(devices[rank])
    return Mesh(axis, rank, size, device)


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def shard_put(x, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """This rank's contiguous slice ``[r*b, (r+1)*b)`` of x's leading dim,
    on the rank's device; the leading dim must split evenly."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading dim {n} does not split over {mesh.size} "
                         "ranks")
    b = n // mesh.size
    return _as_tensor(x[mesh.rank * b:(mesh.rank + 1) * b], mesh.device)


def replicate_put(x, mesh: Mesh) -> torch.Tensor:
    """The whole of x on the rank's device."""
    return _as_tensor(x, mesh.device)


def all_gather(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along dim 0, in rank
    order; no gradient. mesh None: the default group."""
    _, size = rank_and_size() if mesh is None else (mesh.rank, mesh.size)
    if size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x)
    return torch.cat(parts, 0)


class _AllGatherGrad(torch.autograd.Function):
    """Tiled all-gather whose backward is the sum-scatter."""

    @staticmethod
    def forward(ctx, x, rank: int, size: int):
        ctx.rank, ctx.rows = rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        r0 = ctx.rank * ctx.rows
        return grad[r0:r0 + ctx.rows], None, None


def all_gather_grad(x: torch.Tensor, mesh: Optional[Mesh] = None
                    ) -> torch.Tensor:
    """``all_gather`` with a gradient: the cotangent of the gathered
    tensor is summed over the ranks and each rank keeps its slice (JAX's
    transpose of a tiled all-gather)."""
    rank, size = rank_and_size() if mesh is None else (mesh.rank, mesh.size)
    if size == 1:
        return x
    return _AllGatherGrad.apply(x, rank, size)


def pmean(tensors: List[torch.Tensor], mesh: Optional[Mesh] = None
          ) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (same shapes and dtype on
    every rank), reduced as one flat buffer in one collective."""
    _, size = rank_and_size() if mesh is None else (mesh.rank, mesh.size)
    if size == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= size
    out, i0 = [], 0
    for t in tensors:
        out.append(flat[i0:i0 + t.numel()].view_as(t))
        i0 += t.numel()
    return out
