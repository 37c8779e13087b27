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
also count their work (``_probe_table``, ``_count_scored``, and
``index.ivf.kernel_tiles``, the tiles whose lists the fused select's merge
reads).

Kernels, each with its plain twin in this module:

- C, ``pack_score`` (``csrc/ivf_pack_score.cu``): raw SQ8 / SQ4 scores
  ``bf16(q) · code`` over the rows a block table names;
- D, ``pq_pack_score`` (``csrc/pq_pack_score.cu``): PQ / OPQ ADC scores
  ``Σ_m LUT[b, m, code[row, m]]`` from a natural-layout [B, M, ksub] LUT;
- D with the select fused, ``pq_scan_topk`` (the same library's 8-bit
  path, ``pq_scan8_topk``): the scores finished in the kernel (residual
  base, mask) and only each tile's exact top-k written; ``merge_pq_tiles``
  merges the tiles. Its twin is ``pq_pack_score_topk_plain`` (D's twin,
  then ``pq_select``), and ``pq_fused_route`` says which route a scan
  takes: the fused one on the card for 8-bit codes and k <= 64, else D's
  scores and ``pq_select``.

A wrapper takes its plain twin for CPU tensors only; a CUDA tensor goes
through the kernel or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

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
# kernel D's 8-bit path with the select fused (its own launch count)
PQ_SCAN_TOPK = CudaKernel(
    "pq_pack_score.cu", "dph_pq_scan_topk",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p])

PQ_K_MAX = 64  # the fused select's largest k: two list slots a lane

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


def pq_topk_plan(b: int, m: int, k: int, n_sm: int):
    """The fused select's launch (``pq_scan8_topk``): (bq, smem, groups,
    tiles). bq as ``pq_plan``'s 8-bit rule, each query's [M][256] LUT now
    beside its k-slot list, k-th pair and lock; one tile (block) of
    ``tiles`` per SM and query group, so the grid is one wave."""
    per_q = m * 256 * 2 + 8 * k + 12
    if per_q > SMEM_MAX:
        raise ValueError(f"one query's LUT and top-{k} list ({per_q} bytes) "
                         f"do not fit in shared memory")
    bq = 1
    while bq < 8 and bq < b and 2 * bq * per_q <= SMEM_MAX:
        bq *= 2
    groups = -(-b // bq)
    return bq, bq * per_q, groups, max(1, n_sm // groups)


def pq_fused_route(device, ksub: int, k: int) -> bool:
    """Whether a PQ scan's select runs inside kernel D
    (``pq_scan_topk``): a CUDA device, 8-bit codes (the 4-bit path's scores
    sit in ``mma`` fragments) and 1 <= k <= ``PQ_K_MAX``. Otherwise D's
    scores and ``pq_select`` (the plain twin's on CPU tensors)."""
    return (torch.device(device).type == "cuda" and ksub == 256
            and 1 <= k <= PQ_K_MAX)


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


# ------------------------------------------------ kernel D's fused select
def row_lists(list_offsets, n_rows: int, nlist: int):
    """Each sorted code row's list, [n_rows] int32: the residual base's
    list of a row, edge rows of a boundary block included (rows past the
    last list fall to it). An index with residual PQ codes builds it once,
    where it uploads its codes."""
    rows = torch.arange(n_rows, device=list_offsets.device)
    return (torch.searchsorted(list_offsets, rows, right=True) - 1) \
        .clamp(0, nlist - 1).to(torch.int32)


def _valid_count(blk, total, n_real: int):
    """The batch's valid packed columns (a device count): real slots' rows
    below n_real. Real slots name increasing blocks, so these columns are
    exactly the first ones, [0, count)."""
    real = torch.arange(blk.numel(), device=blk.device) < total
    rows = (n_real - blk.long() * RB).clamp(0, RB)
    return torch.where(real, rows, 0).sum()


def pq_select(raw, blk, total, *, n_real: int, k: int, cs32=None,
              row_list=None):
    """The select after D's scores: raw [B, budget*32] → each row's
    residual base ``cs32[:, list]`` when cs32 is given (its own list,
    ``row_list``'s), NEG_INF at invalid columns, the exact top-k → (vals
    [B, k], packed columns [B, k] int64), ties to the lower column."""
    src, valid = _valid_rows(blk, total, n_real)
    s = raw
    if cs32 is not None:
        # each row's OWN list: edge rows of a boundary block belong to
        # the neighbouring list, whose centroid is their residual base
        s = s + cs32[:, row_list[src].long()]
    s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
    return _topk2(s, k)


def pq_pack_score_topk_plain(lut_bf, codes, blk, total, *, n_real: int,
                             k: int, cs32=None, row_list=None):
    """The fused select's plain twin: D's plain twin, then ``pq_select``.
    k <= budget*32."""
    return pq_select(pq_pack_score_plain(lut_bf, codes, blk), blk, total,
                     n_real=n_real, k=k, cs32=cs32, row_list=row_list)


def pq_scan_topk(lut_bf, codes, blk, total, *, n_real: int, k: int,
                 cs32=None, row_list=None):
    """Kernel D's 8-bit path with the select fused (``pq_scan8_topk``):
    each tile's exact top-k of the scores ``pq_select`` ranks, the residual
    base added and invalid columns dropped in the kernel.

    lut_bf [B, M, 256] bf16, codes [N_pad, M] uint8 and blk as for
    ``pq_pack_score``; total: the device count of blk's real slots
    (``block_table``'s); cs32 (optional) [B, nlist] fp32 residual bases,
    row_list [N_pad] int32 each row's list (``row_lists``). → (scores [B,
    tiles·k] fp32, packed columns [B, tiles·k] int32, tiles): tile j's k best
    at j·k .. j·k + k - 1, best first, ties to the lower column, empty slots
    -inf and -1; tiles follow the columns in order, so one stable top-k over
    them (``merge_pq_tiles``) keeps the lower column on ties. CUDA tensors
    only; launches on the current stream without synchronising."""
    if lut_bf.dim() != 3 or lut_bf.dtype != torch.bfloat16 \
            or lut_bf.shape[2] != 256:
        raise ValueError(f"lut must be bf16 [B, M, 256], got {lut_bf.dtype} "
                         f"{tuple(lut_bf.shape)}")
    b, m, _ = lut_bf.shape
    if codes.dtype != torch.uint8 or codes.dim() != 2 or codes.shape[1] != m:
        raise ValueError(f"codes must be uint8 [N_pad, {m}], got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    _check_table(codes, blk, b)
    if total.dtype != torch.int64 or total.numel() != 1:
        raise ValueError(f"total must be one int64, got {total.dtype} "
                         f"{tuple(total.shape)}")
    if not 1 <= k <= PQ_K_MAX:
        raise ValueError(f"k={k} outside 1..{PQ_K_MAX}")
    if (cs32 is None) != (row_list is None):
        raise ValueError("cs32 and row_list go together")
    base = rl = None
    if cs32 is not None:
        if cs32.dtype != torch.float32 or cs32.dim() != 2 \
                or cs32.shape[0] != b or not cs32.is_contiguous():
            raise ValueError(f"cs32 must be contiguous fp32 [{b}, nlist], "
                             f"got {cs32.dtype} {tuple(cs32.shape)}")
        if row_list.dtype != torch.int32 or not row_list.is_contiguous() \
                or tuple(row_list.shape) != (codes.shape[0],):
            raise ValueError(f"row_list must be contiguous int32 "
                             f"[{codes.shape[0]}], got {row_list.dtype} "
                             f"{tuple(row_list.shape)}")
        base, rl = cs32.data_ptr(), row_list.data_ptr()
    if not (lut_bf.is_contiguous() and codes.is_contiguous()
            and blk.is_contiguous()):
        raise ValueError("lut, codes and blk must be contiguous")
    _check_cuda(lut_bf, codes, blk, total,
                *(() if cs32 is None else (cs32, row_list)))
    check_aligned(lut_bf.data_ptr(), 16, "lut")
    vec = load_width(m, codes.data_ptr(), (16, 4, 1))
    bq, _, _, tiles = pq_topk_plan(b, m, k, _sm_count(codes.device))
    vals = torch.empty((b, tiles * k), dtype=torch.float32,
                       device=codes.device)
    cols = torch.empty((b, tiles * k), dtype=torch.int32,
                       device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        PQ_SCAN_TOPK.launch(
            lut_bf.data_ptr(), codes.data_ptr(), blk.data_ptr(),
            total.data_ptr(), base, rl, vals.data_ptr(), cols.data_ptr(), b,
            m, blk.numel(), codes.shape[0], n_real,
            0 if cs32 is None else cs32.shape[1], k, tiles, bq, vec, stream)
    return vals, cols, tiles


def merge_pq_tiles(vals, cols, n_valid, k: int):
    """``pq_scan_topk``'s tile lists → (vals [B, k], packed columns [B, k]
    int64), as ``pq_select`` gives them: one stable top-k over the lists,
    then, where fewer than k columns are valid (n_valid: ``_valid_count``),
    the first invalid columns at NEG_INF in column order, as the twin's
    masked sort leaves them."""
    b = vals.shape[0]
    fill = n_valid + torch.arange(k, device=vals.device)
    v, pos = _top_k(torch.cat([vals, vals.new_full((b, k), NEG_INF)], 1), k)
    return v, torch.gather(torch.cat([cols.long(), fill.expand(b, k)], 1), 1,
                           pos)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _count_scored(n_valid, rows: int):
    """While tracing is on, ``index.ivf.rows_scored``: query rows × valid
    packed columns (a device count), as a deferred device product."""
    if profiling.active():
        profiling.count("index.ivf.rows_scored", n_valid * rows)


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
    _count_scored(valid.sum(), q_raw.shape[0])
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
                   n_real: int, scan_k: int, pq_residual: bool = False,
                   row_list=None):
    """PQ / OPQ IVF search (kernel D): probe → block table → ADC scores →
    the residual ``q·c`` of each row's own list → exact top-scan_k →
    optional int8 refine. q_rot: the queries in code space (OPQ: q @ R).
    nlist_valid: as in ``packed_union_scan``. row_list: ``row_lists`` of
    the codes, which the residual base reads (needed with pq_residual).
    Where ``pq_fused_route`` says so, the select runs in D's epilogue
    (``pq_scan_topk``, then ``merge_pq_tiles``; counter
    ``index.ivf.kernel_tiles``). Returns (vals [B, K] f32, gids [B, K]
    int32)."""
    if pq_residual and row_list is None:
        raise ValueError("residual PQ codes need their row_list")
    blk, total = _probe_table(q_raw, centroids, list_offsets, nlist_valid,
                              nprobe=nprobe, cap=cap,
                              pad_blk=codes.shape[0] // RB - 1,
                              budget=budget)
    k = min(scan_k, blk.numel() * RB)
    fused = pq_fused_route(codes.device, pq_books.shape[1], k)
    with profiling.span("index.ivf.scan"):
        lut = pq_lut(pq_books, q_rot).to(torch.bfloat16).contiguous()
        cs32 = q_raw @ centroids.T if pq_residual else None
        if fused:
            lists = pq_scan_topk(lut, codes, blk, total, n_real=n_real, k=k,
                                 cs32=cs32,
                                 row_list=row_list if pq_residual else None)
        else:
            raw = pq_pack_score(lut, codes, blk)
    with profiling.span("index.ivf.select"):
        n_valid = _valid_count(blk, total, n_real)
        if fused:
            vals, cols = merge_pq_tiles(*lists[:2], n_valid, k)
            profiling.count("index.ivf.kernel_tiles", lists[2])
        else:
            vals, cols = pq_select(raw, blk, total, n_real=n_real, k=k,
                                   cs32=cs32, row_list=row_list)
        src = blk.long()[cols // RB] * RB + cols % RB
        gids = row_perm[src.clamp(0, row_perm.shape[0] - 1)]
    _count_scored(n_valid, q_raw.shape[0])
    if refine_codes is not None:
        profiling.count("index.ivf.candidates_refined", gids.numel())
        with profiling.span("index.ivf.refine"):
            return refine_int8(q_raw, vals, gids, refine_codes, offset,
                               scale, top_k)
    k = min(top_k, vals.shape[1])
    return vals[:, :k], gids[:, :k]
