"""Exact-length IVF list scans: the block table and kernels C and D.

The counterpart of ``densephrases_tpu/ops/ivf_pack.py``. Lists are sorted
row ranges of the code matrix. A batch's probed lists are deduplicated on
the device (sort + sentinel) and flattened into a table of 32-row blocks
covering exactly each unique list's extent, rounded to the block. Block
starts are ``max(b0_i, e_{i-1})``, so consecutive lists that share a
boundary block score it once: coverage is disjoint (no duplicate ids) and
complete (with nprobe = nlist the scan equals a flat scan of the codes).
Every query scores the whole union of the batch's probed lists, plus up to
31 edge rows of neighbouring lists; both only add true-scored candidates.

The reference compiles several static block budgets and picks one by
``lax.cond`` on the batch's block total. The port never synchronises with
the host inside a search: it launches the worst-case (guard) budget, whose
all-junk tiles exit at once, and the result does not depend on the tier.

The scans trace their steps as the spans ``index.ivf.probe``,
``index.ivf.block_table``, ``index.ivf.scan``, ``index.ivf.select`` and
``index.ivf.refine`` (``utils/profiling.py``); while tracing is on they
also count their work (``_probe_table``, ``_count_scored``).

Kernels, each with its plain twin in this module:

- C, ``pack_score`` (``csrc/ivf_pack_score.cu``): raw SQ8 / SQ4 scores
  ``bf16(q) · code`` over the rows a block table names;
- D, ``pq_pack_score`` (``csrc/pq_pack_score.cu``): PQ / OPQ ADC scores
  ``Σ_m LUT[b, m, code[row, m]]`` from a natural-layout [B, M, ksub] LUT.

A wrapper takes its plain twin for CPU tensors only; a CUDA tensor goes
through the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from densephrases_tpu_torch.ops.kmeans import _bf16
from densephrases_tpu_torch.ops.pq import pq_lut
from densephrases_tpu_torch.ops.topk import topk as _top_k
from densephrases_tpu_torch.utils import profiling
from densephrases_tpu_torch.utils.cuda_build import CudaKernel

NEG_INF = -1e30

RB = 32          # rows per block-table entry
TPB = 8          # entries per scored tile
TILE = RB * TPB  # rows per tile

IVF_PACK_SCORE = CudaKernel(
    "ivf_pack_score.cu", "dph_ivf_pack_score",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
PQ_PACK_SCORE = CudaKernel(
    "pq_pack_score.cu", "dph_pq_pack_score",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])

SMEM_MAX = 232448  # a block's shared-memory ceiling on the H100 (227 KB)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _table_rows(blk):
    """Block table [budget] → the code rows it names [budget*32] (int64)."""
    return (blk.long()[:, None] * RB
            + torch.arange(RB, device=blk.device)).reshape(-1)


def _impl(impl: str, x) -> str:
    """Resolve a wrapper's impl: "auto" → "cuda" for a CUDA tensor, "plain"
    for a CPU tensor."""
    if impl == "auto":
        return "cuda" if x.is_cuda else "plain"
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def _check_cuda(*tensors):
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the kernel needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the kernel's tensors must be on one CUDA device")


def _check_table(codes, blk, n_q: int):
    if codes.dim() != 2 or codes.shape[0] < RB or codes.shape[0] % RB:
        raise ValueError(f"codes must be [N_pad, C] with N_pad a positive "
                         f"multiple of {RB}, got {tuple(codes.shape)}")
    if blk.dim() != 1 or blk.dtype != torch.int32 or blk.numel() == 0 \
            or blk.numel() % TPB:
        raise ValueError(f"blk must be int32 [budget], budget a positive "
                         f"multiple of {TPB}: {blk.dtype} {tuple(blk.shape)}")
    if n_q <= 0:
        raise ValueError("empty query batch")


def _into(out, res):
    """The plain twin's result, written into the caller's buffer if any."""
    if out is None:
        return res
    return out.copy_(res)


def _out_buffer(out, b: int, blk):
    """The kernel's output: a new [B, budget*32] fp32 tensor, or the
    caller's, checked."""
    shape = (b, blk.numel() * RB)
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=blk.device)
    if (tuple(out.shape) != shape or out.dtype != torch.float32
            or out.device != blk.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous fp32 {shape} tensor on "
                         f"{blk.device}")
    return out


def check_aligned(ptr: int, nbytes: int, name: str):
    """Raise unless the address ``ptr`` is a multiple of ``nbytes``: the
    width of the kernel's vector loads from that tensor."""
    if ptr % nbytes:
        raise ValueError(f"{name} must be {nbytes}-byte aligned for the "
                         f"kernel's loads (address % {nbytes} = "
                         f"{ptr % nbytes})")


def load_width(row_bytes: int, ptr: int, widths) -> int:
    """The widest code load (bytes) that divides the row width and the
    codes' address, so every row's loads are aligned; 0 if none does."""
    return next((w for w in widths if row_bytes % w == 0 and ptr % w == 0),
                0)


def scan_plan(b: int, code_bytes: int, *, sq4: bool):
    """Kernel C's launch (``csrc/ivf_pack_score.cu``): (nt, bq, stride,
    smem). A block scores bq = 8·nt queries (nt 2, 4, 8 or 16 n-tiles):
    the fewest that hold the batch, at most 128, and no more than its
    shared memory holds. It keeps them as [segment 0 | segment 1 (SQ4)],
    each the code row's width rounded up to 32 dims, padded so the row
    stride in bytes is 64 past a multiple of 128."""
    seg_w = _round_up(code_bytes, 32)
    width = (2 if sq4 else 1) * seg_w
    stride = width + (32 if width % 64 == 0 else 0)
    per_q = 2 * stride
    nt = 2
    while nt < 16 and 8 * nt < b and 16 * nt * per_q <= SMEM_MAX:
        nt *= 2
    if 8 * nt * per_q > SMEM_MAX:
        raise ValueError(f"16 query rows of {code_bytes}-byte codes do not "
                         f"fit in shared memory")
    return nt, 8 * nt, stride, 8 * nt * per_q


def pq_plan(b: int, m: int, ksub: int):
    """Kernel D's launch (``csrc/pq_pack_score.cu``): (bq, smem), the
    queries a block keeps LUTs for. 8-bit: a power of two ≤ 8 whose
    [M][256][bq] LUT fits, no larger than the batch needs; 4-bit: 16 or
    32, each query's [M][16] LUT row padded by 8 bf16."""
    if ksub == 256:
        per_q = m * 256 * 2
        if per_q > SMEM_MAX:
            raise ValueError(f"one query's LUT ({per_q} bytes) does not fit "
                             f"in shared memory")
        bq = 1
        while bq < 8 and bq < b and 2 * bq * per_q <= SMEM_MAX:
            bq *= 2
        return bq, bq * per_q
    per_q = (m * 16 + 8) * 2
    bq = 32 if b > 16 and 32 * per_q <= SMEM_MAX else 16
    if bq * per_q > SMEM_MAX:
        raise ValueError(f"16 queries' LUTs ({16 * per_q} bytes) do not fit "
                         f"in shared memory")
    return bq, bq * per_q


# --------------------------------------------------------------- kernel C
def pack_score_plain(q_bf, codes, blk, *, sq4: bool):
    """q_bf [B, D] bf16, codes [N_pad, Dc] int8 (SQ4: Dc = D/2 packed
    bytes, high nibble = first half of the dims), blk [budget] int32 →
    raw scores [B, budget*32] f32 (one fp32 product: a bf16 × code
    product is exact in fp32)."""
    tile = codes[_table_rows(blk)]
    if sq4:
        v = tile.to(torch.int32) & 0xFF
        tile = torch.cat([v >> 4, v & 0xF], dim=1)
    return q_bf.to(torch.float32) @ tile.to(torch.float32).T


def pack_score(q_bf, codes, blk, *, sq4: bool, impl: str = "auto",
               out=None):
    """Kernel C. impl "auto": the kernel for CUDA tensors, the plain twin
    for CPU tensors; "cuda": the kernel (CPU tensors raise); "plain": the
    twin. On the card, columns of all-junk tiles (first entry == pad_blk)
    are left unwritten: the caller masks them. out: an optional [B,
    budget*32] fp32 buffer for the kernel to write into. Launches on the
    current stream without synchronising."""
    impl = _impl(impl, q_bf)
    if impl == "plain":
        return _into(out, pack_score_plain(q_bf, codes, blk, sq4=sq4))
    _check_cuda(q_bf, codes, blk)
    if q_bf.dim() != 2 or q_bf.dtype != torch.bfloat16:
        raise ValueError(f"q must be bf16 [B, D], got {q_bf.dtype} "
                         f"{tuple(q_bf.shape)}")
    if codes.dtype != torch.int8:
        raise ValueError(f"codes must be int8, got {codes.dtype}")
    b, d = q_bf.shape
    _check_table(codes, blk, b)
    if codes.shape[1] != (d // 2 if sq4 else d) or (sq4 and d % 2):
        raise ValueError(f"{'SQ4' if sq4 else 'SQ8'} codes of "
                         f"{codes.shape[1]} bytes do not match dim {d}")
    if codes.shape[1] % 4:
        raise ValueError(f"code rows of {codes.shape[1]} bytes: kernel C "
                         f"reads whole 4-byte words")
    if not (q_bf.is_contiguous() and codes.is_contiguous()
            and blk.is_contiguous()):
        raise ValueError("q, codes and blk must be contiguous")
    check_aligned(q_bf.data_ptr(), 8, "q")
    check_aligned(codes.data_ptr(), 4, "codes")
    vec = load_width(codes.shape[1], codes.data_ptr(), (8, 4))
    nt = scan_plan(b, codes.shape[1], sq4=sq4)[0]
    out = _out_buffer(out, b, blk)
    with torch.cuda.device(q_bf.device):
        stream = torch.cuda.current_stream(q_bf.device).cuda_stream
        IVF_PACK_SCORE.launch(q_bf.data_ptr(), codes.data_ptr(),
                              blk.data_ptr(), out.data_ptr(), b, d,
                              codes.shape[1], int(sq4), blk.numel(),
                              codes.shape[0], nt, vec, stream)
    return out


# --------------------------------------------------------------- kernel D
def pq_pack_score_plain(lut_bf, codes, blk, *, row_chunk: int = 4096):
    """lut_bf [B, M, ksub] bf16 (natural layout), codes [N_pad, Mc] uint8
    (ksub 16: M/2 nibble-packed bytes, byte i = subspace 2i low | 2i+1
    high), blk [budget] int32 → raw scores [B, budget*32] f32: a gather
    from the LUT and a sum over m, ``row_chunk`` rows at a time."""
    b, m, ksub = lut_bf.shape
    lut = lut_bf.to(torch.float32)
    rows = _table_rows(blk)
    out = torch.empty((b, rows.numel()), dtype=torch.float32,
                      device=lut.device)
    for i0 in range(0, rows.numel(), row_chunk):
        c = codes[rows[i0:i0 + row_chunk]].long()
        if ksub == 16:
            c = torch.stack([c & 0xF, c >> 4], dim=-1).reshape(c.shape[0], m)
        idx = c.T[None].expand(b, m, c.shape[0])
        out[:, i0:i0 + c.shape[0]] = torch.gather(lut, 2, idx).sum(1)
    return out


def pq_pack_score(lut_bf, codes, blk, *, impl: str = "auto", out=None):
    """Kernel D. impl and out as for ``pack_score``. On the card, columns
    of the tiles from the first all-junk one on are left unwritten: the
    caller masks them. Launches on the current stream without
    synchronising."""
    impl = _impl(impl, lut_bf)
    if impl == "plain":
        return _into(out, pq_pack_score_plain(lut_bf, codes, blk))
    _check_cuda(lut_bf, codes, blk)
    if lut_bf.dim() != 3 or lut_bf.dtype != torch.bfloat16:
        raise ValueError(f"lut must be bf16 [B, M, ksub], got "
                         f"{lut_bf.dtype} {tuple(lut_bf.shape)}")
    if codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8, got {codes.dtype}")
    b, m, ksub = lut_bf.shape
    _check_table(codes, blk, b)
    if ksub not in (16, 256) or codes.shape[1] != (m // 2 if ksub == 16
                                                   else m):
        raise ValueError(f"codes of {codes.shape[1]} bytes do not match "
                         f"M={m} x ksub={ksub}")
    if not (lut_bf.is_contiguous() and codes.is_contiguous()
            and blk.is_contiguous()):
        raise ValueError("lut, codes and blk must be contiguous")
    check_aligned(lut_bf.data_ptr(), 16, "lut")
    vec = load_width(codes.shape[1], codes.data_ptr(), (16, 4, 1))
    bq = pq_plan(b, m, ksub)[0]
    out = _out_buffer(out, b, blk)
    with torch.cuda.device(lut_bf.device):
        stream = torch.cuda.current_stream(lut_bf.device).cuda_stream
        PQ_PACK_SCORE.launch(lut_bf.data_ptr(), codes.data_ptr(),
                             blk.data_ptr(), out.data_ptr(), b, m, ksub,
                             codes.shape[1], blk.numel(), codes.shape[0], bq,
                             vec, stream)
    return out


# ------------------------------------------------------------ the scans
def _topk2(s, k: int):
    """Exact two-stage top-k over wide score rows, ties to the lower index:
    per 2048-column segment, then over the segments' winners (kept in
    column order, so the tie rule holds across segments)."""
    b, c = s.shape
    seg = 2048
    if c <= 2 * seg or c % seg:
        return _top_k(s, min(k, c))
    nseg = c // seg
    kk = min(k, seg)
    v1, p1 = _top_k(s.reshape(b, nseg, seg), kk)
    idx1 = (p1 + torch.arange(nseg, device=s.device)[None, :, None] * seg) \
        .reshape(b, nseg * kk)
    v, p = _top_k(v1.reshape(b, nseg * kk), min(k, nseg * kk))
    return v, torch.gather(idx1, 1, p)


def pack_budget_table(list_offsets: np.ndarray, cap: int) -> np.ndarray:
    """Descending cumulative block counts: the budget for U unique lists is
    table[min(U, nlist) - 1], the exact worst case (the U longest lists,
    with their up-to-one alignment block)."""
    offs = np.asarray(list_offsets, np.int64)
    lens = np.minimum(np.diff(offs), cap)
    nblk = (offs[:-1] + lens + RB - 1) // RB - offs[:-1] // RB
    nblk = np.sort(nblk)[::-1]
    return np.cumsum(nblk)


def probe(q_raw, centroids, nprobe: int, nlist_valid=None):
    """Max-inner-product probe: bf16 operands, fp32 sums, the nprobe best
    lists per query (ties to the lower list id). → [B, nprobe] int64.
    nlist_valid: centroid rows at or past it are padding (a mesh shard
    padded to the largest nlist) and never probed (ref ivf_pack.py:213-215)."""
    c_scores = _bf16(q_raw) @ _bf16(centroids).T
    if nlist_valid is not None:
        col = torch.arange(centroids.shape[0], device=c_scores.device)
        c_scores = c_scores.masked_fill(col >= nlist_valid, NEG_INF)
    return _top_k(c_scores, nprobe)[1]


def block_table(probe_ids, list_offsets, *, nlist: int, cap: int,
                pad_blk: int, budget: int):
    """The batch's 32-row block table, built on the device.

    probe_ids [B, P]; list_offsets [nlist + 1] int64. Returns (blk
    [budget] int32, total: the device scalar count of real entries).
    Slots past ``total`` name ``pad_blk``."""
    dev = probe_ids.device
    flat = torch.sort(probe_ids.reshape(-1)).values
    keep = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      flat[1:] != flat[:-1]])
    uniq = torch.sort(torch.where(keep, flat, nlist)).values  # [U]
    u_n = uniq.numel()
    valid = uniq < nlist
    lic = uniq.clamp(max=nlist - 1)
    offs = list_offsets[lic]
    lens = torch.where(valid, (list_offsets[lic + 1] - offs).clamp(max=cap),
                       0)
    b0 = offs // RB
    e = (offs + lens + RB - 1) // RB  # exclusive end block, non-decreasing
    start = torch.maximum(b0, torch.cat([e.new_zeros(1), e[:-1]]))
    bc = torch.where(valid, (e - start).clamp(min=0), 0)
    cum = torch.cat([bc.new_zeros(1), torch.cumsum(bc, 0)])
    total = cum[u_n]
    j = torch.arange(budget, device=dev)
    u_of = (torch.searchsorted(cum, j, right=True) - 1).clamp(0, u_n - 1)
    blk = torch.where(j < total, start[u_of] + (j - cum[u_of]), pad_blk)
    return blk.to(torch.int32), total


def _probe_table(q_raw, centroids, list_offsets, nlist_valid, *,
                 nprobe: int, cap: int, pad_blk: int, budget: int):
    """The probe and the batch's block table (``block_table``'s result).
    While tracing is on it also counts, as deferred device sums,
    ``index.ivf.lists_unique``, the batch's distinct probed lists, and
    ``index.ivf.rows_own``, each query row's rows in its own probed lists
    (``min(len, cap)`` a list): the rows it needs scored. The probe's ids
    are a view of its whole [B, nlist] sort, freed on return."""
    with profiling.span("index.ivf.probe"):
        probe_ids = probe(q_raw, centroids, nprobe, nlist_valid)
    if profiling.active():
        flat = torch.sort(probe_ids.reshape(-1)).values
        profiling.count("index.ivf.lists_unique",
                        (flat[1:] != flat[:-1]).sum() + 1)
        lens = list_offsets[probe_ids + 1] - list_offsets[probe_ids]
        profiling.count("index.ivf.rows_own", lens.clamp(max=cap).sum())
    with profiling.span("index.ivf.block_table"):
        return block_table(probe_ids, list_offsets,
                           nlist=centroids.shape[0], cap=cap,
                           pad_blk=pad_blk, budget=budget)


def _count_scored(valid, rows: int):
    """While tracing is on, ``index.ivf.rows_scored``: query rows × valid
    packed columns, as a deferred device sum."""
    if profiling.active():
        profiling.count("index.ivf.rows_scored", valid.sum() * rows)


def _valid_rows(blk, total, n_real: int):
    """(src, valid) per packed column: the sorted row each names, and
    whether it is a real row of a real table slot."""
    src = _table_rows(blk)
    col = torch.arange(src.numel(), device=blk.device)
    return src, ((col // RB) < total) & (src < n_real)


def packed_union_scan(q_raw, centroids, list_offsets, codes, row_perm,
                      offset, scale, nlist_valid=None, q_score=None, *,
                      top_k: int, nprobe: int, cap: int, budget: int,
                      n_real: int, sq4: bool = False):
    """SQ8 / SQ4 IVF search over exact-length list reads (kernel C).

    nlist_valid (optional): centroid rows at or past it are padding and are
    never probed (``probe``). q_raw [B, D] f32 probes; q_score (optional)
    are the scoring-space
    queries when they differ (trained per-dim SQ4: q / scale_vec, with
    ``offset`` the matching [D] bias vector and ``scale`` 1.0). codes
    [N_pad, Dc] int8 sorted by list; budget: the guard block budget (a
    multiple of TPB). Returns (vals [B, K] f32, gids [B, K] int32), K =
    min(top_k, budget*32)."""
    if q_score is None:
        q_score = q_raw
    blk, total = _probe_table(q_raw, centroids, list_offsets, nlist_valid,
                              nprobe=nprobe, cap=cap,
                              pad_blk=codes.shape[0] // RB - 1,
                              budget=budget)
    with profiling.span("index.ivf.scan"):
        raw = pack_score(q_score.to(torch.bfloat16).contiguous(), codes,
                         blk, sq4=sq4)
    with profiling.span("index.ivf.select"):
        qsum = (q_score * offset).sum(-1)  # offset may be a [D] vector
        src, valid = _valid_rows(blk, total, n_real)
        s = torch.where(valid[None, :], raw / scale + qsum[:, None],
                        torch.full_like(raw, NEG_INF))
        vals, pos = _topk2(s, min(top_k, s.shape[1]))
        gids = row_perm[src[pos].clamp(0, row_perm.shape[0] - 1)]
    _count_scored(valid, q_raw.shape[0])
    return vals, gids


def refine_int8(q_raw, vals, gids, refine_codes, offset: float, scale: float,
                top_k: int):
    """Exact int8 re-ranking of candidates in the unrotated space: bf16(q)
    against bf16(store code) in fp32, then the affine contract. Candidates
    already masked (≤ NEG_INF/2) stay masked."""
    cand = refine_codes[gids.long().clamp(0, refine_codes.shape[0] - 1)]
    s = torch.einsum("bd,bcd->bc", _bf16(q_raw), cand.to(torch.float32))
    s = s / scale + (q_raw.sum(-1) * offset)[:, None]
    s = torch.where(vals > NEG_INF / 2, s, torch.full_like(s, NEG_INF))
    v, pos = _top_k(s, min(top_k, s.shape[1]))
    return v, torch.gather(gids, 1, pos)


def packed_pq_scan(q_raw, q_rot, centroids, list_offsets, codes, row_perm,
                   pq_books, refine_codes, offset, scale, nlist_valid=None,
                   *, top_k: int, nprobe: int, cap: int, budget: int,
                   n_real: int, scan_k: int, pq_residual: bool = False):
    """PQ / OPQ IVF search (kernel D): probe → block table → ADC scores →
    the residual ``q·c`` of each row's own list → exact top-scan_k →
    optional int8 refine. q_rot: the queries in code space (OPQ: q @ R).
    nlist_valid: as in ``packed_union_scan``.
    Returns (vals [B, K] f32, gids [B, K] int32)."""
    nlist = centroids.shape[0]
    blk, total = _probe_table(q_raw, centroids, list_offsets, nlist_valid,
                              nprobe=nprobe, cap=cap,
                              pad_blk=codes.shape[0] // RB - 1,
                              budget=budget)
    with profiling.span("index.ivf.scan"):
        lut = pq_lut(pq_books, q_rot).to(torch.bfloat16).contiguous()
        raw = pq_pack_score(lut, codes, blk)
    with profiling.span("index.ivf.select"):
        src, valid = _valid_rows(blk, total, n_real)
        s = raw
        if pq_residual:
            # each row's OWN list: edge rows of a boundary block belong to
            # the neighbouring list, whose centroid is their residual base
            cs32 = q_raw @ centroids.T
            rlist = (torch.searchsorted(list_offsets, src, right=True) - 1) \
                .clamp(0, nlist - 1)
            s = s + cs32[:, rlist]
        s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
        vals, pos = _topk2(s, min(scan_k, s.shape[1]))
        gids = row_perm[src[pos].clamp(0, row_perm.shape[0] - 1)]
    _count_scored(valid, q_raw.shape[0])
    if refine_codes is not None:
        profiling.count("index.ivf.candidates_refined", gids.numel())
        with profiling.span("index.ivf.refine"):
            return refine_int8(q_raw, vals, gids, refine_codes, offset,
                               scale, top_k)
    k = min(top_k, vals.shape[1])
    return vals[:, :k], gids[:, :k]
