"""IVF index with SQ8 / SQ4 / PQ / OPQ lists: build, save, load, search.

The counterpart of ``densephrases_tpu/index/ivf.py`` (FAISS's IVF
train/add/search).

Build, on ``device``:
- coarse centroids by flat Lloyd k-means (``ops/kmeans.py``), the corpus
  assigned by L2, then oversized lists split (ε-scaled centroid copies and
  one Lloyd refinement a round) and force-partitioned, within
  ``nlist_growth_cap``. At ``num_clusters ≥ two_level_clusters`` (the
  reference's 2^20 lists) the centroids come from two-level k-means, the
  corpus is assigned hierarchically (on the device while its int8 codes
  fit ``DPH_ASSIGN_DEVICE_BYTES``, default 9e9, else streamed in blocks),
  and the split children are re-sorted under their parents each round;
- ``coarse_cache``, a directory, keeps the trained coarse quantizer
  (``centroids.npy``, ``assign.npy``, ``stage_s.json``, then
  ``coarse.done``) and the two-level k-means before its assignment
  (``km_*.npy``, ``kmeans.done``): plain npy and JSON, so either package
  builds from the other's cache, and several fine quantizations of one
  corpus share one coarse phase;
- fine quantization: SQ8 reuses the store's int8 codes; SQ4 re-quantizes
  them to packed int4 with per-dim trained ranges; PQ / OPQ train
  codebooks (and a rotation) on the residuals ``x − c[assign]`` and encode
  the corpus streamed through the device;
- rows sorted by list, so each inverted list is one contiguous row range;
  the code matrix is zero-padded to a multiple of 32 rows with at least one
  all-zero trailing block; ``row_perm`` maps sorted rows to global ids.

Search: batches of ``prefer_union_batch`` rows or more, and every SQ4 / PQ
search, take the union scan over exact-length list reads
(``ops/ivf_pack.py``: kernel C for SQ8 / SQ4, kernel D for PQ / OPQ, with
an exact int8 refine of the PQ candidates). Smaller SQ8 batches take the
per-probe scan ``_probe_score``, which masks each query to its own probed
lists; the two routes differ by design, as in the reference.

A PQ / OPQ index may keep its int8 refine matrix on the host instead
(``load(refine_mode="host")``): the scan on the device widens to
``top_k · refine_factor`` candidates and ``_host_refine`` re-ranks them in
numpy over a memmap gather, so no D-bytes-a-row matrix reaches the device.

Saves are the reference's format (npy files and ``ivf.pkl``); either
package loads the other's. The pickle names the reference's classes, so
loading maps exactly those two names to the port's copies (and imports no
jax), and saving writes the reference's names without importing them.
``build_host_save`` writes an SQ8 save directory for a corpus larger than
the device, the sorted codes streamed memmap to memmap, for
``index/tiered.py:TieredIVF``. A legacy save whose code rows are not a
multiple of 32 is padded on the device as it uploads; the reference's
grouped XLA fallback scans are not ported.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from densephrases_tpu_torch.ops.ivf_pack import (
    NEG_INF,
    RB,
    TPB,
    _top_k,
    pack_budget_table,
    packed_pq_scan,
    packed_union_scan,
    probe,
    row_lists,
)
from densephrases_tpu_torch.ops.kmeans import (
    _bf16,
    accumulate_blocks,
    assign_blocks,
    assign_blocks_hier,
    assign_corpus_hier,
    assign_hier_streamed,
    kmeans,
    kmeans_two_level,
    sort_children,
)
from densephrases_tpu_torch.ops.opq import train_opq
from densephrases_tpu_torch.ops.pq import PQCodebook, pack_nibbles, pq_encode, train_pq
from densephrases_tpu_torch.ops.quant import (
    DEFAULT_OFFSET,
    DEFAULT_SCALE,
    INT4_OFFSET,
    INT4_SCALE,
    float_to_int4,
    train_int4_ranges,
)
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_FQ_PQ_RE = re.compile(r"^(OPQ|PQ)(\d+)(?:x(\d+))?$")


def parse_pq_quant(fq: str):
    """Parse a PQ/OPQ fine_quant spec → (kind, M, nbits) or None.
    "OPQ96" = 96 subspaces × 8 bits; "OPQ192x4" = 192 subspaces × 4 bits
    (the same bytes a code, stored nibble-packed)."""
    mt = _FQ_PQ_RE.match(fq)
    if not mt:
        return None
    return mt.group(1), int(mt.group(2)), int(mt.group(3) or 8)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class IVFConfig:
    """The reference's ``IVFConfig``: the same fields and defaults, and it
    pickles under the reference's class path."""

    num_clusters: int = 1024
    fine_quant: str = "SQ8"  # SQ8 | SQ4 | PQ<m>[x4] | OPQ<m>[x4]
    kmeans_iters: int = 10
    pq_iters: int = 6
    opq_iters: int = 4
    sample_ratio: float = 1.0  # train on a subsample
    norm_th: float = 999.0  # drop large-norm rows from the training sample
    seed: int = 0
    # PQ candidates are re-ranked with exact int8 scores: scan
    # top_k * refine_factor PQ candidates, rescore them, keep top_k
    refine_factor: int = 4
    # hard ceiling on a list's scan length (longer lists are truncated)
    max_list_scan: int = 8192
    # batches of this many rows or more take the union scan
    prefer_union_batch: int = 4
    # lists longer than balance_factor * mean are split at build time
    balance_factor: float = 4.0
    # actual nlist <= nlist_growth_cap * num_clusters (None: unbounded)
    nlist_growth_cap: Optional[float] = 1.1
    # at num_clusters >= this, two-level k-means and hierarchical
    # assignment train the coarse quantizer
    two_level_clusters: int = 8192
    # parents probed during hierarchical assignment (two-level only)
    assign_probe: int = 8
    # SQ4: train per-dim int4 ranges instead of the fixed global affine
    sq4_train_ranges: bool = True
    # PQ/OPQ codes encode the residual to the assigned coarse centroid;
    # old pickled configs lack the field and load as False
    pq_residual: bool = True
    # explicit (offset[D], scale[D]) int4 contract, overriding training
    int4_ranges: Optional[tuple] = None


# ---------------------------------------------------------------- pickle
_REF_CLASSES = {
    ("densephrases_tpu.index.ivf", "IVFConfig"): IVFConfig,
    ("densephrases_tpu.ops.pq", "PQCodebook"): PQCodebook,
}
_REF_NAMES = {cls: name for name, cls in _REF_CLASSES.items()}


class _RefUnpickler(pickle.Unpickler):
    """Loads a reference-written ``ivf.pkl`` without importing jax: the
    reference's two classes map to the port's copies, numpy's own globals
    load as usual, and any other global is refused."""

    def find_class(self, module, name):
        cls = _REF_CLASSES.get((module, name))
        if cls is not None:
            return cls
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"ivf.pkl names {module}.{name}; only the reference's IVFConfig "
            f"and PQCodebook and numpy's globals are loaded")


class _RefPickler(pickle._Pickler):
    """Writes the port's two classes under the reference's module paths,
    without importing the reference (the stock pickler imports a class's
    module to check it)."""

    def save_global(self, obj, name=None):
        ref = _REF_NAMES.get(obj)
        if ref is None:
            return super().save_global(obj, name)
        module, qualname = ref  # protocol 4 or later: save() uses it
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


# ----------------------------------------------------------------- build
def _split_centroid(c: np.ndarray, n_extra: int, eps: float = 1e-2):
    """n_extra ε-scaled copies c·(1 ± jε) of centroid c (a geometric split:
    members partition by their projection on c)."""
    j = np.arange(1, n_extra + 1, dtype=np.float32)
    sgn = np.where(j % 2 == 0, 1.0, -1.0)
    f = 1.0 + sgn * eps * np.ceil(j / 2)
    return c[None, :] * f[:, None]


def _force_partition(centroids: np.ndarray, assign: np.ndarray, cap: float,
                     l1_cents: Optional[np.ndarray] = None,
                     budget: Optional[int] = None, *, device):
    """Deterministic backstop for lists that splitting cannot break: the
    member rows of any list longer than ``cap`` are cut into cap-sized
    parts under duplicated centroids, longest list first, within
    ``budget`` added centroids (a list may be cut only partly when the
    budget runs out). Must be the last balance step. With ``l1_cents``
    (the two-level quantizer) the centroids are then re-sorted under their
    nearest parent on ``device`` and ``assign`` follows them.
    Returns (centroids, parent offsets or None, assign)."""
    k = centroids.shape[0]
    counts = np.bincount(assign, minlength=k)
    cap_i = max(int(cap), 1)
    over = np.nonzero(counts > cap_i)[0]
    over = over[np.argsort(-counts[over], kind="stable")]
    if budget is not None and budget <= 0 and len(over) > 0:
        logger.info("force_partition: nlist budget exhausted; %d lists "
                    "remain over cap %d (max %d)", len(over), cap_i,
                    int(counts[over[0]]))
    elif len(over) > 0:
        order = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order], np.arange(k + 1))
        assign = assign.copy()
        new_cents = [centroids]
        next_id = k
        remaining = budget if budget is not None else np.inf
        for li in over:
            mem = order[bounds[li]:bounds[li + 1]]
            for p0 in range(cap_i, len(mem), cap_i):
                if remaining <= 0:
                    break
                assign[mem[p0:p0 + cap_i]] = next_id
                new_cents.append(centroids[li][None, :])
                next_id += 1
                remaining -= 1
        centroids = np.concatenate(new_cents).astype(np.float32)
    if l1_cents is None:
        return centroids, None, assign
    centroids, parent_offs, order_c = sort_children(centroids, l1_cents,
                                                    device=device)
    inv = np.empty(len(order_c), np.int64)
    inv[order_c] = np.arange(len(order_c))
    return centroids, parent_offs, inv[assign].astype(np.int32)


def _eps_split_plan(counts: np.ndarray, oversized: np.ndarray, cap: float,
                    budget: Optional[float]):
    """Budget-aware split allocation: oversized lists longest first, each
    claiming ceil(count/cap) - 1 extra centroids, while the total claim
    fits the budget. Returns (list_ids, n_extras)."""
    oversized = oversized[np.argsort(-counts[oversized], kind="stable")]
    need = np.ceil(counts[oversized] / cap).astype(np.int64) - 1
    if budget is None:
        return oversized, need
    take = np.cumsum(need) <= budget
    return oversized[take], need[take]


def _balance_lists(x: np.ndarray, centroids: np.ndarray, assign: np.ndarray,
                   balance_factor: float = 4.0, rounds: int = 3,
                   offset: float = 0.0, scale: float = 1.0,
                   growth_cap: Optional[float] = None, verbose: bool = False,
                   *, device):
    """Split lists longer than balance_factor × mean (the cap is fixed from
    the initial k): ε-scaled centroid copies, then one Lloyd refinement and
    a reassignment a round, within growth_cap × the initial count."""
    k0 = centroids.shape[0]
    cap = balance_factor * max(len(x) / k0, 1.0)
    budget_total = (None if growth_cap is None
                    else max(int(np.ceil(growth_cap * k0)) - k0, 0))
    prev_over = np.inf
    for _ in range(rounds):
        k = centroids.shape[0]
        counts = np.bincount(assign, minlength=k)
        oversized = np.nonzero(counts > cap)[0]
        if len(oversized) == 0 or len(oversized) >= prev_over:
            break  # done, or splitting is not helping
        prev_over = len(oversized)
        budget = None if budget_total is None else budget_total - (k - k0)
        split_ids, extras = _eps_split_plan(counts, oversized, cap, budget)
        if len(split_ids) == 0:
            break  # growth budget spent; force partition handles the rest
        new_cents = [centroids]
        for li, n_extra in zip(split_ids, extras):
            new_cents.append(_split_centroid(centroids[li], int(n_extra)))
        centroids = np.concatenate(new_cents, axis=0).astype(np.float32)
        sums, cnt, _ = accumulate_blocks(x, centroids, chunk=2048,
                                         offset=offset, scale=scale,
                                         device=device)
        nz = cnt > 0
        centroids[nz] = sums[nz] / cnt[nz, None]
        assign = assign_blocks(x, centroids, chunk=2048, offset=offset,
                               scale=scale, device=device)
        if verbose:
            logger.info("balance round: k %d→%d, max list %d", k,
                        centroids.shape[0],
                        int(np.bincount(assign,
                                        minlength=centroids.shape[0]).max()))
    return centroids, assign


def _balance_lists_hier(x: np.ndarray, centroids: np.ndarray,
                        l1_cents: np.ndarray, assign: np.ndarray,
                        balance_factor: float = 4.0, rounds: int = 3,
                        seed: int = 0, probe: int = 8, verbose: bool = False,
                        offset: float = 0.0, scale: float = 1.0,
                        assign_fn=None, growth_cap: Optional[float] = None,
                        parent_offs: Optional[np.ndarray] = None, *,
                        device):
    """List splitting for the two-level quantizer: ε-scaled copies of the
    oversized lists' centroids, every child re-sorted under its nearest
    parent, and the corpus reassigned hierarchically (``assign_fn(l1,
    centroids, parent offsets)``, else ``assign_blocks_hier`` over x), within
    growth_cap × the initial count. With ``parent_offs`` given, a round that
    cannot gain (no oversized list, no fewer than the last round, or no
    budget) stops before its reassignment. Returns (sorted centroids,
    l1_cents, parent offsets, assign)."""
    k0 = centroids.shape[0]
    cap = balance_factor * max(len(x) / k0, 1.0)
    budget_total = (None if growth_cap is None
                    else max(int(np.ceil(growth_cap * k0)) - k0, 0))
    prev_over = np.inf
    for _ in range(rounds):
        k = centroids.shape[0]
        counts = np.bincount(assign, minlength=k)
        oversized = np.nonzero(counts > cap)[0]
        no_gain = len(oversized) == 0 or len(oversized) >= prev_over
        if no_gain and parent_offs is not None:
            break
        prev_over = min(prev_over, len(oversized))
        budget = None if budget_total is None else budget_total - (k - k0)
        split_ids, extras = _eps_split_plan(counts, oversized, cap, budget)
        if len(split_ids) == 0 and parent_offs is not None:
            break  # growth budget spent; force partition handles the rest
        new_cents = [centroids]
        for li, n_extra in zip(split_ids, extras):
            new_cents.append(_split_centroid(centroids[li], int(n_extra)))
        centroids = np.concatenate(new_cents, axis=0).astype(np.float32)
        centroids, parent_offs, _ = sort_children(centroids, l1_cents,
                                                  device=device)
        if assign_fn is not None:
            assign = assign_fn(l1_cents, centroids, parent_offs)
        else:
            assign = assign_blocks_hier(x, l1_cents, centroids, parent_offs,
                                        probe=probe, offset=offset,
                                        scale=scale, device=device)
        if verbose:
            logger.info("hier balance round: k %d→%d, max list %d", k,
                        centroids.shape[0],
                        int(np.bincount(assign,
                                        minlength=centroids.shape[0]).max()))
    return centroids, l1_cents, parent_offs, assign


def _sq4_encode_stream(codes_int8: np.ndarray, offset: float, scale: float,
                       int4_offset=INT4_OFFSET, int4_scale=INT4_SCALE,
                       chunk: int = 1 << 18, *, device) -> np.ndarray:
    """Streamed int8 → packed-int4 re-quantization (SQ4): blocks dequantize
    and re-quantize on the device and come back packed. Returns the packed
    bytes viewed as int8, as the reference stores them."""
    n, d = codes_int8.shape
    assert d % 2 == 0, "int4 packing needs an even feature dim"
    out = np.empty((n, d // 2), np.uint8)
    quant_in = codes_int8.dtype == np.int8
    i4_off = (torch.as_tensor(np.asarray(int4_offset, np.float32),
                              device=device)
              if np.ndim(int4_offset) else float(int4_offset))
    i4_sc = (torch.as_tensor(np.asarray(int4_scale, np.float32),
                             device=device)
             if np.ndim(int4_scale) else float(int4_scale))
    for s in range(0, n, chunk):
        blk = torch.from_numpy(np.array(codes_int8[s:s + chunk])) \
            .to(device)
        f = (blk.to(torch.float32) / scale + offset if quant_in
             else blk.to(torch.float32))
        out[s:s + chunk] = float_to_int4(f, i4_off, i4_sc).cpu().numpy()
    return out.view(np.int8)


def _upload(arr, dtype, device, rows: Optional[int] = None):
    """A host array (a memmap streams slice by slice) → a device tensor of
    ``rows`` rows (default: the array's), the rows past the array zero."""
    n = arr.shape[0]
    out = torch.empty((n if rows is None else rows,) + tuple(arr.shape[1:]),
                      dtype=dtype, device=device)
    step = 1 << 20
    for i0 in range(0, n, step):
        i1 = min(i0 + step, n)
        out[i0:i1].copy_(torch.from_numpy(np.array(arr[i0:i1])))
    out[n:].zero_()
    return out


# ---------------------------------------------------------------- search
def _probe_score(q_raw, centroids, list_offsets, codes, row_perm, offset,
                 scale, *, top_k: int, nprobe: int, cap: int):
    """Per-probe SQ8 scan (the few-query route): each query scores only the
    lists it probed, cap rows a list masked to the list's length, and keeps
    a running top-k merged across probes in probe order. Returns
    (vals [B, top_k] f32, gids [B, top_k] int32)."""
    b, d = q_raw.shape
    probe_ids = probe(q_raw, centroids, nprobe)  # [B, P]
    qsum = (q_raw * offset).sum(-1)
    q_bf = _bf16(q_raw)
    col = torch.arange(cap, device=q_raw.device)
    best_s = torch.full((b, top_k), NEG_INF, device=q_raw.device)
    best_i = torch.zeros((b, top_k), dtype=torch.long, device=q_raw.device)
    group = max(1, (1 << 25) // max(b * cap * d, 1))  # probes a step
    for p0 in range(0, nprobe, group):
        lists = probe_ids[:, p0:p0 + group]  # [B, g]
        offs = list_offsets[lists]
        lens = list_offsets[lists + 1] - offs
        rows = offs[..., None] + col  # [B, g, cap]
        cand = codes[rows.clamp(max=codes.shape[0] - 1)].to(torch.float32)
        s = torch.einsum("bd,bgcd->bgc", q_bf, cand) / scale \
            + qsum[:, None, None]
        s = torch.where(col < lens[..., None], s, torch.full_like(s, NEG_INF))
        cat_s = torch.cat([best_s, s.reshape(b, -1)], 1)
        cat_i = torch.cat([best_i, rows.reshape(b, -1)], 1)
        best_s, pos = _top_k(cat_s, top_k)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, row_perm[best_i.clamp(0, row_perm.shape[0] - 1)]


class IVFIndex:
    """Approximate MIPS index on one device. Same ``search`` API as
    ``FlatIndex``."""

    def __init__(self, cfg: IVFConfig, centroids, row_perm, list_offsets,
                 codes, rotation=None, pq: Optional[PQCodebook] = None,
                 offset: float = DEFAULT_OFFSET, scale: float = DEFAULT_SCALE,
                 n_total: int = 0, refine_codes=None,
                 int4_offset=INT4_OFFSET, int4_scale=INT4_SCALE,
                 refine_host=None, *, device="cuda"):
        """Host (numpy) arrays, uploaded to ``device``. codes: [N_pad, C]
        sorted by list, int8 (SQ8, SQ4 packed) or uint8 (PQ).
        refine_host: the original-order int8 matrix [N, D] as a host array
        (a memmap), for the host refine tier of a PQ index that has no
        ``refine_codes``; it is never uploaded."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sq4 = cfg.fine_quant == "SQ4"
        # the scans address whole 32-row blocks: a legacy save with another
        # row count is padded with zero rows on the device as it uploads
        # (never on the host: a memmap would be read whole into memory)
        n_rows = _round_up(codes.shape[0], RB)
        if n_rows != codes.shape[0]:
            row_perm = np.concatenate(
                [row_perm, np.zeros(n_rows - codes.shape[0],
                                    np.asarray(row_perm).dtype)])
        # scalar: the fixed legacy int4 contract; [D] vectors: trained ranges
        self.int4_vector = np.ndim(int4_offset) > 0
        if self.int4_vector:
            self.int4_offset = torch.as_tensor(
                np.asarray(int4_offset, np.float32), device=self.device)
            self.int4_scale = torch.as_tensor(
                np.asarray(int4_scale, np.float32), device=self.device)
        else:
            self.int4_offset = float(int4_offset)
            self.int4_scale = float(int4_scale)
        self.centroids = torch.as_tensor(np.asarray(centroids, np.float32),
                                         device=self.device)
        # int32 ids on the device, as in the reference (x64 off there)
        self.row_perm = torch.as_tensor(np.asarray(row_perm).astype(np.int32),
                                        device=self.device)
        offs_np = np.asarray(list_offsets).astype(np.int64)
        self.list_offsets = torch.as_tensor(offs_np, device=self.device)
        self.codes = _upload(codes, torch.uint8 if codes.dtype == np.uint8
                             else torch.int8, self.device, rows=n_rows)
        self.rotation = (None if rotation is None else torch.as_tensor(
            np.asarray(rotation, np.float32), device=self.device))
        self.pq = pq
        self.pq_books = (None if pq is None else torch.as_tensor(
            np.asarray(pq.codebooks, np.float32), device=self.device))
        self.offset = float(offset)
        self.scale = float(scale)
        self.n_total = n_total
        self.refine_codes = (None if refine_codes is None
                             else _upload(refine_codes, torch.int8,
                                          self.device))
        self.refine_host = refine_host
        # __dict__.get, not getattr: a legacy pickled cfg lacks the instance
        # attribute and must not inherit the class default (True)
        self.pq_residual = (pq is not None
                            and bool(cfg.__dict__.get("pq_residual", False)))
        # each code row's list, whose centroid is its residual base
        self.row_list = (row_lists(self.list_offsets, self.codes.shape[0],
                                   self.centroids.shape[0])
                         if self.pq_residual else None)
        # host references, so save() writes from host memory; padded codes
        # are written from the device
        self._host_arrays = ({"refine": refine_codes}
                             if isinstance(refine_codes, np.ndarray) else {})
        if isinstance(codes, np.ndarray) and len(codes) == n_rows:
            self._host_arrays["codes"] = codes
        lens = np.diff(offs_np)
        self.cap = int(_round_up(max(int(lens.max()), 8), 8))
        if self.cap > cfg.max_list_scan:
            logger.warning("IVF list skew: longest list %d > max_list_scan "
                           "%d; oversized lists will be scan-truncated",
                           self.cap, cfg.max_list_scan)
            self.cap = cfg.max_list_scan
        self.n_real = int(offs_np[-1])
        self._pack_table = pack_budget_table(offs_np, self.cap)

    @property
    def nlist(self) -> int:
        return int(self.centroids.shape[0])

    # ------------------------------------------------------------- build
    @staticmethod
    def build(codes_int8: np.ndarray, cfg: IVFConfig,
              offset: float = DEFAULT_OFFSET, scale: float = DEFAULT_SCALE,
              verbose: bool = False, coarse_cache: Optional[str] = None, *,
              device="cuda", stage_s: Optional[dict] = None) -> "IVFIndex":
        """codes_int8: the store's int8 vectors [N, D]. coarse_cache: a
        directory that keeps the trained coarse quantizer (see the module
        docstring); a finished one is read instead of training. stage_s,
        when given, receives the wall seconds of each stage (sample,
        kmeans, assign, balance: the build's, also on a cache hit; fine)."""
        device = resolve_device(device)
        centroids, assign, sample_cache = IVFIndex.build_coarse(
            codes_int8, cfg, offset, scale, verbose, coarse_cache,
            stage_s=stage_s, device=device)
        t0 = time.perf_counter()
        index = IVFIndex._finish_build(
            codes_int8, cfg, centroids, assign, offset, scale, verbose,
            sample_cache=sample_cache, device=device)
        if stage_s is not None:
            stage_s["fine_s"] = round(time.perf_counter() - t0, 3)
        return index

    @staticmethod
    def build_coarse(codes_int8: np.ndarray, cfg: IVFConfig,
                     offset: float = DEFAULT_OFFSET,
                     scale: float = DEFAULT_SCALE, verbose: bool = False,
                     coarse_cache: Optional[str] = None, *,
                     stage_s: Optional[dict] = None, device):
        """Coarse quantizer: train, assign the corpus, balance. Returns
        (centroids, assign, sample_cache), sample_cache being the training
        sample tuple of ``_train_sample``, or None when ``coarse_cache``
        held a finished quantizer (whose stage seconds then fill
        ``stage_s``)."""
        def mark(key, t0):
            if stage_s is not None:
                stage_s[key] = round(time.perf_counter() - t0, 3)
            return time.perf_counter()

        def cached(name):
            return os.path.join(coarse_cache, name)

        n = codes_int8.shape[0]
        if coarse_cache is not None and os.path.exists(cached("coarse.done")):
            centroids = np.load(cached("centroids.npy"))
            assign = np.load(cached("assign.npy"))
            assert assign.shape[0] == n, "coarse cache is for another corpus"
            if stage_s is not None and os.path.exists(cached("stage_s.json")):
                with open(cached("stage_s.json")) as f:
                    stage_s.update(json.load(f))
            return centroids, assign, None

        t0 = time.perf_counter()
        sample, s_off, s_scale, s_sel = IVFIndex._train_sample(
            codes_int8, cfg, offset, scale, device=device)
        t0 = mark("sample_s", t0)
        l1_cents = None
        if cfg.num_clusters >= cfg.two_level_clusters:
            centroids, l1_cents, parent_offs = IVFIndex._two_level_kmeans(
                sample, cfg, s_off, s_scale, verbose, coarse_cache,
                device=device)
            t0 = mark("kmeans_s", t0)
            assign_fn = IVFIndex._hier_assigner(codes_int8, cfg, offset,
                                                scale, device=device)
            assign = assign_fn(l1_cents, centroids, parent_offs)
            t0 = mark("assign_s", t0)
            k_req = centroids.shape[0]
            centroids, _, _, assign = _balance_lists_hier(
                codes_int8, centroids, l1_cents, assign,
                balance_factor=cfg.balance_factor, rounds=3, seed=cfg.seed,
                probe=cfg.assign_probe, verbose=verbose, offset=offset,
                scale=scale, assign_fn=assign_fn,
                growth_cap=cfg.nlist_growth_cap, parent_offs=parent_offs,
                device=device)
            del assign_fn  # and with it the corpus on the device
        else:
            centroids, _ = kmeans(
                sample, cfg.num_clusters, iters=cfg.kmeans_iters,
                seed=cfg.seed, verbose=verbose,
                chunk=min(4096, _round_up(max(len(sample) // 8, 256), 256)),
                offset=s_off, scale=s_scale, device=device)
            t0 = mark("kmeans_s", t0)
            assign = assign_blocks(codes_int8, centroids, chunk=2048,
                                   offset=offset, scale=scale, device=device)
            t0 = mark("assign_s", t0)
            k_req = centroids.shape[0]
            centroids, assign = _balance_lists(
                codes_int8, centroids, assign,
                balance_factor=cfg.balance_factor, rounds=3, offset=offset,
                scale=scale, growth_cap=cfg.nlist_growth_cap,
                verbose=verbose, device=device)
        # the backstop for lists splitting could not break, within what is
        # left of the growth budget
        fp_budget = (None if cfg.nlist_growth_cap is None else max(
            int(np.ceil(cfg.nlist_growth_cap * k_req)) - centroids.shape[0],
            0))
        centroids, _, assign = _force_partition(
            centroids, assign,
            cfg.balance_factor * max(n / centroids.shape[0], 1.0),
            l1_cents=l1_cents, budget=fp_budget, device=device)
        IVFIndex._log_growth(k_req, centroids.shape[0], assign)
        mark("balance_s", t0)

        if coarse_cache is not None:
            os.makedirs(coarse_cache, exist_ok=True)
            np.save(cached("centroids.npy"), np.asarray(centroids))
            np.save(cached("assign.npy"), np.asarray(assign))
            if stage_s:
                with open(cached("stage_s.json"), "w") as f:
                    json.dump(stage_s, f)
            with open(cached("coarse.done"), "w") as f:
                f.write("ok\n")
        return centroids, assign, (sample, s_off, s_scale, s_sel)

    @staticmethod
    def _two_level_kmeans(sample, cfg: IVFConfig, s_off, s_scale,
                          verbose: bool, coarse_cache: Optional[str], *,
                          device):
        """``kmeans_two_level`` on the sample, read from and kept in the
        coarse cache's ``kmeans.done`` checkpoint when there is a cache.
        Returns (centroids sorted by parent, l1 centroids, parent
        offsets)."""
        names = ("km_centroids.npy", "km_l1.npy", "km_offs.npy")
        done = (None if coarse_cache is None
                else os.path.join(coarse_cache, "kmeans.done"))
        if done is not None and os.path.exists(done):
            return tuple(np.load(os.path.join(coarse_cache, f))
                         for f in names)
        out = kmeans_two_level(sample, cfg.num_clusters,
                               iters=cfg.kmeans_iters, seed=cfg.seed,
                               verbose=verbose, offset=s_off, scale=s_scale,
                               device=device)
        if done is not None:
            os.makedirs(coarse_cache, exist_ok=True)
            for f, arr in zip(names, out):
                np.save(os.path.join(coarse_cache, f), np.asarray(arr))
            with open(done, "w") as f:
                f.write("ok\n")
        return out

    @staticmethod
    def _hier_assigner(codes_int8, cfg: IVFConfig, offset: float,
                       scale: float, *, device):
        """The corpus's hierarchical assignment as ``fn(l1, centroids,
        parent offsets)``: the corpus uploaded once while its int8 codes
        fit ``DPH_ASSIGN_DEVICE_BYTES`` (default 9e9, the reference's),
        else streamed block by block through the same grouped assignment
        at every call."""
        budget = int(float(os.environ.get("DPH_ASSIGN_DEVICE_BYTES", 9e9)))
        if codes_int8.nbytes <= budget:
            codes_dev = _upload(codes_int8, torch.int8, device)
            return lambda l1, cents, offs: assign_corpus_hier(
                codes_dev, l1, cents, offs, probe=cfg.assign_probe,
                offset=offset, scale=scale)
        return lambda l1, cents, offs: assign_hier_streamed(
            codes_int8, l1, cents, offs, probe=cfg.assign_probe,
            offset=offset, scale=scale, device=device)

    @staticmethod
    def _log_growth(k_req: int, k_act: int, assign: np.ndarray):
        """Requested against actual nlist, and the list lengths."""
        counts = np.bincount(assign, minlength=k_act)
        logger.info("nlist requested %d -> actual %d (+%.1f%%); list mean "
                    "%.1f max %d", k_req, k_act,
                    100.0 * (k_act - k_req) / max(k_req, 1),
                    float(counts.mean()), int(counts.max()))

    @staticmethod
    def build_host_save(codes_int8, cfg: IVFConfig, out_dir: str,
                        offset: float = DEFAULT_OFFSET,
                        scale: float = DEFAULT_SCALE,
                        coarse_cache: Optional[str] = None,
                        verbose: bool = False, chunk_rows: int = 1 << 20, *,
                        device="cuda", stage_s: Optional[dict] = None) -> str:
        """Build an SQ8 index for a corpus larger than the device and write
        its save directory directly: the coarse quantizer on ``device``,
        then the sorted codes streamed memmap → memmap in ``chunk_rows``
        blocks, so no corpus-sized array exists on the device or a second
        time on the host. ``index/tiered.py:TieredIVF`` serves the result.

        As in the reference, the coarse quantizer is trained with the
        default int8 affine whatever ``offset`` and ``scale`` say (a fault
        of the reference for a store with another affine; the saved
        ``ivf.pkl`` carries the given pair). stage_s: as in ``build``."""
        assert cfg.fine_quant == "SQ8", \
            "host-save build is the beyond-HBM SQ8 path (see TieredIVF)"
        device = resolve_device(device)
        n, d = codes_int8.shape
        centroids, assign, _ = IVFIndex.build_coarse(
            codes_int8, cfg, verbose=verbose, coarse_cache=coarse_cache,
            stage_s=stage_s, device=device)
        order = np.argsort(assign, kind="stable")
        list_offsets = np.searchsorted(
            assign[order], np.arange(centroids.shape[0] + 1)).astype(np.int32)
        lens = np.diff(list_offsets)
        cap = int(_round_up(max(int(lens.max()), 8), 8))
        pad = _round_up(cap, RB) + (-(n + _round_up(cap, RB))) % RB
        os.makedirs(out_dir, exist_ok=True)
        mm = np.lib.format.open_memmap(
            os.path.join(out_dir, "codes.npy"), mode="w+", dtype=np.int8,
            shape=(n + pad, d))
        for b0 in range(0, n, chunk_rows):
            b1 = min(b0 + chunk_rows, n)
            mm[b0:b1] = codes_int8[order[b0:b1]]
        mm[n:] = 0
        mm.flush()
        del mm
        np.save(os.path.join(out_dir, "centroids.npy"),
                np.asarray(centroids, np.float32))
        np.save(os.path.join(out_dir, "row_perm.npy"), np.concatenate(
            [order, np.zeros(pad, order.dtype)]).astype(np.int64))
        np.save(os.path.join(out_dir, "list_offsets.npy"), list_offsets)
        extra = {"cfg": cfg, "rotation": None, "pq": None,
                 "offset": float(offset), "scale": float(scale),
                 "n_total": int(n), "int4_offset": INT4_OFFSET,
                 "int4_scale": INT4_SCALE}
        with open(os.path.join(out_dir, "ivf.pkl"), "wb") as f:
            _RefPickler(f, protocol=pickle.DEFAULT_PROTOCOL).dump(extra)
        return out_dir

    @staticmethod
    def _train_sample(codes_int8: np.ndarray, cfg: IVFConfig, offset: float,
                      scale: float, *, device):
        """Training subsample, deterministic in cfg.seed; it stays int8 and
        the k-means stack reads it through the affine contract. Returns
        (sample, offset, scale, selected rows)."""
        n = codes_int8.shape[0]
        rng = np.random.default_rng(cfg.seed)
        if cfg.sample_ratio < 1.0:
            take = max(int(n * cfg.sample_ratio),
                       min(n, cfg.num_clusters * 4))
            sel = np.sort(rng.choice(n, size=min(take, n), replace=False))
        else:
            sel = np.arange(n)
        sample = np.ascontiguousarray(codes_int8[sel])
        s_quant = sample.dtype == np.int8
        s_off, s_scale = (offset, scale) if s_quant else (0.0, 1.0)
        if cfg.norm_th < 999.0:
            sv = torch.from_numpy(sample).to(device).to(torch.float32)
            norms = torch.sqrt(((sv / s_scale + s_off) ** 2).sum(1)) \
                .cpu().numpy()
            kept = norms < cfg.norm_th
            if int(kept.sum()) >= cfg.num_clusters:
                sample, sel = sample[kept], sel[kept]
        return sample, s_off, s_scale, sel

    @staticmethod
    def _finish_build(codes_int8: np.ndarray, cfg: IVFConfig,
                      centroids: np.ndarray, assign: np.ndarray,
                      offset: float, scale: float, verbose: bool = False,
                      sample_cache=None, *, device) -> "IVFIndex":
        """Fine quantization and the sorted list layout, given a trained
        coarse quantizer."""
        n = codes_int8.shape[0]
        rotation, pq = None, None
        i4_off, i4_sc = INT4_OFFSET, INT4_SCALE
        fq = cfg.fine_quant
        pq_spec = parse_pq_quant(fq)
        resid = bool(cfg.__dict__.get("pq_residual", False)) and (
            pq_spec is not None)
        r_cents = np.asarray(centroids, np.float32) if resid else None

        def sample():
            return sample_cache or IVFIndex._train_sample(
                codes_int8, cfg, offset, scale, device=device)

        if pq_spec is not None:
            kind, m, nbits = pq_spec
            smp, s_off, s_scale, sel = sample()
            sub_ids = assign[sel] if resid else None
            if kind == "OPQ":
                opq = train_opq(smp, m, nbits=nbits, niter=cfg.opq_iters,
                                pq_iters=cfg.pq_iters, seed=cfg.seed,
                                verbose=verbose, offset=s_off, scale=s_scale,
                                sub_cents=r_cents, sub_ids=sub_ids,
                                device=device)
                rotation, pq = opq.rotation, opq.pq
            else:
                pq = train_pq(smp, m, nbits=nbits, iters=cfg.pq_iters,
                              seed=cfg.seed, offset=s_off, scale=s_scale,
                              sub_cents=r_cents, sub_ids=sub_ids,
                              device=device)
            fine_codes = pq_encode(pq, codes_int8, offset=offset, scale=scale,
                                   rotation=rotation, cents=r_cents,
                                   assign=assign if resid else None,
                                   device=device)
            if nbits == 4:
                fine_codes = pack_nibbles(fine_codes)
        elif fq == "SQ8":
            fine_codes = codes_int8
        elif fq == "SQ4":
            if getattr(cfg, "int4_ranges", None) is not None:
                i4_off, i4_sc = cfg.int4_ranges
            elif getattr(cfg, "sq4_train_ranges", True):
                # quantiles on a bounded subsample of the training sample
                smp, s_off, s_scale, _ = sample()
                sub = np.ascontiguousarray(
                    smp[:: max(len(smp) // 131072, 1)])
                sub_f = (sub.astype(np.float32) / s_scale + s_off
                         if sub.dtype == np.int8 else sub.astype(np.float32))
                i4_off, i4_sc = train_int4_ranges(sub_f)
            fine_codes = _sq4_encode_stream(codes_int8, offset=offset,
                                            scale=scale, int4_offset=i4_off,
                                            int4_scale=i4_sc, device=device)
        else:
            raise ValueError(f"unknown fine_quant {fq}")

        # sort rows by list: each inverted list is a contiguous row range
        order = np.argsort(assign, kind="stable")
        list_offsets = np.searchsorted(
            assign[order], np.arange(centroids.shape[0] + 1)).astype(np.int32)
        sorted_codes = fine_codes[order]
        # cap extra rows, and a total that is a multiple of the 32-row block
        lens = np.diff(list_offsets)
        cap = int(_round_up(max(int(lens.max()), 8), 8))
        pad = _round_up(cap, RB) + (-(n + _round_up(cap, RB))) % RB
        sorted_codes = np.concatenate(
            [sorted_codes, np.zeros((pad,) + sorted_codes.shape[1:],
                                    sorted_codes.dtype)])
        row_perm = np.concatenate([order, np.zeros(pad, order.dtype)]) \
            .astype(np.int64)
        refine = codes_int8 if (pq is not None and cfg.refine_factor > 1) \
            else None
        return IVFIndex(cfg, centroids, row_perm, list_offsets, sorted_codes,
                        rotation=rotation, pq=pq, offset=offset, scale=scale,
                        n_total=n, refine_codes=refine, int4_offset=i4_off,
                        int4_scale=i4_sc, device=device)

    # ------------------------------------------------------------ search
    def _scan_contract(self, queries):
        """(q_score, offset, scale) for the union scan. SQ8 and the scalar
        SQ4 contract: the queries and the scalar affine. Trained per-dim
        SQ4: the per-dim scale folds into the queries (q / scale_vec) and
        the bias into a vector offset (scale_vec · lo_vec), with scale 1."""
        if not self.sq4:
            return queries, self.offset, self.scale
        if not self.int4_vector:
            return queries, self.int4_offset, self.int4_scale
        return (queries / self.int4_scale,
                self.int4_scale * self.int4_offset, 1.0)

    def _pack_budget(self, b: int, nprobe: int) -> int:
        """The guard block budget for a batch of b rows at nprobe: the
        block count of the U = b·nprobe longest lists, rounded up to 64
        blocks (the two-stage top-k's 2048-column segment). The port
        launches this tier alone: the reference's smaller tiers need a
        device→host read of the batch's block total to choose, and the
        kernels' all-junk tiles cost almost nothing."""
        u_cap = min(b * nprobe, self.nlist)
        return _round_up(max(int(self._pack_table[u_cap - 1]), TPB), 64)

    def search_union(self, queries, top_k: int = 10, nprobe: int = 64,
                     as_numpy: bool = True):
        """The batch's union scan over exact-length list reads. Returns
        (scores [B, K], gids [B, K] int32), numpy if as_numpy."""
        if (self.pq_books is None or self.refine_codes is not None
                or self.refine_host is None):
            return self._union_scan(queries, top_k, nprobe, as_numpy)
        # host refine tier: a widened scan on the device, then the exact
        # int8 re-rank in numpy (ref ivf.py:1389-1406)
        wide_k = min(top_k * max(self.cfg.refine_factor, 1),
                     max(self.n_total, 1))
        vals, ids = self._union_scan(queries, wide_k, nprobe, as_numpy=True)
        q_np = torch.as_tensor(queries, dtype=torch.float32).cpu().numpy()
        vals, ids = self._host_refine(q_np, vals, ids, top_k)
        if not as_numpy:
            return (torch.as_tensor(vals, device=self.device),
                    torch.as_tensor(ids, device=self.device))
        return vals, ids

    def _union_scan(self, queries, top_k: int, nprobe: int, as_numpy: bool):
        """The union scan on the device (kernel C or D, and the device
        refine of a PQ index that has one)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        nprobe = min(nprobe, self.nlist)
        budget = self._pack_budget(int(q.shape[0]), nprobe)
        if self.pq_books is None:
            q_score, off, sc = self._scan_contract(q)
            vals, ids = packed_union_scan(
                q, self.centroids, self.list_offsets, self.codes,
                self.row_perm, off, sc, q_score=q_score, top_k=top_k,
                nprobe=nprobe, cap=self.cap, budget=budget,
                n_real=self.n_real, sq4=self.sq4)
        else:
            n = max(self.n_total, 1)
            scan_k = (min(top_k * self.cfg.refine_factor, n)
                      if self.refine_codes is not None else min(top_k, n))
            q_rot = q if self.rotation is None else q @ self.rotation
            vals, ids = packed_pq_scan(
                q, q_rot, self.centroids, self.list_offsets, self.codes,
                self.row_perm, self.pq_books, self.refine_codes, self.offset,
                self.scale, top_k=top_k, nprobe=nprobe, cap=self.cap,
                budget=budget, n_real=self.n_real, scan_k=scan_k,
                pq_residual=self.pq_residual, row_list=self.row_list)
        return self._finish(vals, ids, top_k, as_numpy)

    def search(self, queries, top_k: int = 10, nprobe: int = 64,
               as_numpy: bool = True):
        """queries [B, D] f32 → (scores [B, K], global ids [B, K] int32);
        as_numpy=False keeps the results on the device. SQ4, PQ and batches
        of prefer_union_batch rows or more take the union scan."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if (self.sq4 or self.pq_books is not None or q.shape[0]
                >= getattr(self.cfg, "prefer_union_batch", 4)):
            return self.search_union(q, top_k=top_k, nprobe=nprobe,
                                     as_numpy=as_numpy)
        k = min(top_k, self.n_total)
        vals, ids = _probe_score(
            q, self.centroids, self.list_offsets, self.codes, self.row_perm,
            self.offset, self.scale, top_k=k,
            nprobe=min(nprobe, self.nlist), cap=self.cap)
        return self._finish(vals, ids, top_k, as_numpy)

    def _host_refine(self, q: np.ndarray, vals: np.ndarray,
                     gids: np.ndarray, top_k: int):
        """Exact int8 re-rank of PQ candidates against the host-memmapped
        original-order matrix. Host code, as in the reference
        (ivf.py:1544-1564)."""
        rh = self.refine_host
        n = rh.shape[0]
        g = np.clip(np.asarray(gids, np.int64), 0, n - 1)
        rows = np.asarray(rh[g.reshape(-1)], np.float32).reshape(
            g.shape + (rh.shape[1],))
        qsum = q.sum(-1) * self.offset
        s = (np.einsum("bkd,bd->bk", rows, q, optimize=True) / self.scale
             + qsum[:, None])
        s = np.where(np.asarray(vals) > NEG_INF / 2, s, NEG_INF)
        k = min(top_k, s.shape[1])
        sel = np.argpartition(-s, k - 1, axis=1)[:, :k]
        sv = np.take_along_axis(s, sel, axis=1)
        order = np.argsort(-sv, axis=1)
        sel = np.take_along_axis(sel, order, axis=1)
        return (np.take_along_axis(s, sel, axis=1),
                np.take_along_axis(np.asarray(gids), sel, axis=1))

    @staticmethod
    def _finish(vals, ids, top_k: int, as_numpy: bool):
        """Pad to top_k columns (a corpus smaller than top_k)."""
        if vals.shape[1] < top_k:
            pad = top_k - vals.shape[1]
            vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                                  NEG_INF)], 1)
            ids = torch.cat([ids, ids.new_zeros((ids.shape[0], pad))], 1)
        if as_numpy:
            return vals.cpu().numpy(), ids.cpu().numpy()
        return vals, ids

    # ---------------------------------------------------------------- io
    def save(self, path: str):
        """Write the reference's save format: npy files and ``ivf.pkl``."""
        os.makedirs(path, exist_ok=True)
        host = self._host_arrays
        np.save(os.path.join(path, "centroids.npy"),
                self.centroids.cpu().numpy())
        np.save(os.path.join(path, "row_perm.npy"),
                self.row_perm.cpu().numpy().astype(np.int64))
        np.save(os.path.join(path, "list_offsets.npy"),
                self.list_offsets.cpu().numpy().astype(np.int32))
        np.save(os.path.join(path, "codes.npy"),
                host["codes"] if "codes" in host
                else self.codes.cpu().numpy())
        if self.refine_codes is not None:
            np.save(os.path.join(path, "refine_codes.npy"),
                    host["refine"] if "refine" in host
                    else self.refine_codes.cpu().numpy())
        self._host_arrays = {}

        def host_val(v):
            return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

        extra = {"cfg": self.cfg,
                 "rotation": host_val(self.rotation), "pq": self.pq,
                 "offset": self.offset, "scale": self.scale,
                 "n_total": self.n_total,
                 "int4_offset": host_val(self.int4_offset),
                 "int4_scale": host_val(self.int4_scale)}
        with open(os.path.join(path, "ivf.pkl"), "wb") as f:
            _RefPickler(f, protocol=pickle.DEFAULT_PROTOCOL).dump(extra)

    @staticmethod
    def load(path: str, drop_refine: bool = False,
             refine_mode: str = "device", *,
             device="cuda") -> "IVFIndex":
        """Load a save directory (either package's). refine_mode:
        "device" uploads the int8 refine matrix; "none" (or drop_refine)
        drops it, and ``MIPS`` then serves a PQ index in decode mode;
        "host" keeps it a host memmap for the host refine tier."""
        if drop_refine:
            refine_mode = "none"
        if refine_mode not in ("device", "none", "host"):
            raise ValueError(f"unknown refine_mode {refine_mode!r}")
        with open(os.path.join(path, "ivf.pkl"), "rb") as f:
            extra = _RefUnpickler(f).load()
        refine_path = os.path.join(path, "refine_codes.npy")
        have = os.path.exists(refine_path)
        refine = (np.load(refine_path, mmap_mode="r")
                  if have and refine_mode == "device" else None)
        refine_host = (np.load(refine_path, mmap_mode="r")
                       if have and refine_mode == "host" else None)
        return IVFIndex(
            extra["cfg"],
            np.load(os.path.join(path, "centroids.npy")),
            np.load(os.path.join(path, "row_perm.npy")),
            np.load(os.path.join(path, "list_offsets.npy")),
            np.load(os.path.join(path, "codes.npy"), mmap_mode="r"),
            rotation=extra["rotation"], pq=extra["pq"],
            offset=extra["offset"], scale=extra["scale"],
            n_total=extra["n_total"], refine_codes=refine,
            int4_offset=extra.get("int4_offset", INT4_OFFSET),
            int4_scale=extra.get("int4_scale", INT4_SCALE),
            refine_host=refine_host, device=device)
