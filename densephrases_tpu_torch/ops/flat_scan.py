"""Kernel E, ``flat_scan_topk`` (``csrc/flat_scan_topk.cu``): the flat int8
scan of a whole corpus, which keeps each tile's exact top-k.

It shares kernel C's products (``ops/ivf_pack.py``) and its launch
arithmetic's ceilings. It is a CUDA-only wrapper; its plain twin is
``index/flat.py``'s chunked loop, and ``index/flat.py:_scan_topk`` chooses
between them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from densephrases_tpu_torch.ops.ivf_pack import (
    SMEM_MAX, _check_cuda, _round_up, _sm_count, check_aligned)
from densephrases_tpu_torch.utils.cuda_build import CudaKernel

FLAT_SCAN_TOPK = CudaKernel(
    "flat_scan_topk.cu", "dph_flat_scan_topk",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
    + [ctypes.c_int] * 4 + [ctypes.c_void_p])

FLAT_K_MAX = 32  # kernel E's largest k: one list slot a lane
FLAT_TILE_MIN = 2048  # kernel E's fewest rows a tile


class FlatScanPlan(NamedTuple):
    nt: int         # n-tiles of 8 queries a block (2, 4, 8 or 16)
    bq: int         # queries a block
    groups: int     # query groups (grid y)
    stride: int     # a query row in shared memory, bf16
    smem: int       # bytes of shared memory a block
    tile_rows: int  # rows a tile (a block)
    tiles: int      # tiles (grid x)


def flat_scan_plan(b: int, dim: int, k: int, n_rows: int,
                   n_sm: int) -> FlatScanPlan:
    """Kernel E's launch (``csrc/flat_scan_topk.cu``). A block keeps bq =
    8·nt queries (the fewest that hold the batch, at most 128, as
    ``ivf_pack.scan_plan``), each a row of the dims rounded up to 64
    (swizzled, not padded), plus its k-slot list and four words. The tiles
    are multiples of 256 rows (8 warps x 32), at least ``FLAT_TILE_MIN``,
    and as few as make one wave of one block an SM over the query groups."""
    stride = _round_up(dim, 64)
    per_q = 2 * stride + 4 * (2 * k + 4)
    nt = 2
    while nt < 16 and 8 * nt < b and 16 * nt * per_q <= SMEM_MAX:
        nt *= 2
    if 8 * nt * per_q > SMEM_MAX:
        raise ValueError(f"16 query rows of {dim} dims and their top-{k} "
                         f"lists do not fit in shared memory")
    bq = 8 * nt
    groups = -(-b // bq)
    slots = max(1, n_sm // groups)
    tile_rows = max(FLAT_TILE_MIN, _round_up(-(-n_rows // slots), 256))
    return FlatScanPlan(nt, bq, groups, stride, bq * per_q, tile_rows,
                        -(-n_rows // tile_rows))


def flat_scan_topk(q, codes, qsum, n_valid: int, offset: float,
                   scale: float, k: int):
    """Kernel E: each tile's exact top-k of a flat int8 scan.

    q [B, D] fp32 (the kernel rounds it to bf16 for the product, as
    ``.to(torch.bfloat16)``), codes [R, D] int8 with D a multiple of 8,
    qsum [B] fp32 (Σ of each query row, which the kernel multiplies by
    ``offset`` as ``qsum * offset`` rounds): scores raw / scale +
    offset·Σq, and rows >= n_valid are padding and score NEG_INF. →
    (scores [B, tiles·k] fp32, rows [B, tiles·k] int32, tiles): tile j's k
    best rows of each query at columns j·k .. j·k + k - 1, best first, ties
    to the lower row, so one stable top-k over the columns
    (``ops/topk.topk``) keeps the lower row on ties. CUDA tensors only;
    launches on the current stream without synchronising."""
    if q.dim() != 2 or q.dtype != torch.float32:
        raise ValueError(f"q must be fp32 [B, D], got {q.dtype} "
                         f"{tuple(q.shape)}")
    if codes.dim() != 2 or codes.dtype != torch.int8:
        raise ValueError(f"codes must be int8 [R, D], got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    b, d = q.shape
    rows = codes.shape[0]
    if b == 0 or codes.shape[1] != d or d % 8:
        raise ValueError(f"codes of {codes.shape[1]} bytes do not match "
                         f"{b} queries of {d} dims (a multiple of 8)")
    if qsum.dtype != torch.float32 or tuple(qsum.shape) != (b,):
        raise ValueError(f"qsum must be fp32 [{b}], got {qsum.dtype} "
                         f"{tuple(qsum.shape)}")
    if not 1 <= k <= min(FLAT_K_MAX, rows):
        raise ValueError(f"k={k} outside 1..{min(FLAT_K_MAX, rows)}")
    if not (0 <= n_valid <= rows < 2**31 and scale > 0):
        raise ValueError(f"n_valid={n_valid}, rows={rows}, scale={scale}")
    if not (q.is_contiguous() and codes.is_contiguous()
            and qsum.is_contiguous()):
        raise ValueError("q, codes and qsum must be contiguous")
    check_aligned(q.data_ptr(), 16, "q")
    check_aligned(codes.data_ptr(), 8, "codes")
    _check_cuda(q, codes, qsum)
    plan = flat_scan_plan(b, d, k, rows, _sm_count(codes.device))
    vals = torch.empty((b, plan.tiles * k), dtype=torch.float32,
                       device=codes.device)
    ids = torch.empty((b, plan.tiles * k), dtype=torch.int32,
                      device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        FLAT_SCAN_TOPK.launch(
            q.data_ptr(), codes.data_ptr(), qsum.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), b, d, rows, n_valid,
            float(offset), float(scale), k, plan.tile_rows, plan.tiles,
            plan.nt, stream)
    return vals, ids, plan.tiles
