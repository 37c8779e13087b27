"""Sharded IVF: one sub-index per device, fan-out and a top-k merge.

The counterpart of ``densephrases_tpu/index/sharded.py``. The corpus rows
are split evenly across devices, each holds a complete IVF sub-index (its
own centroids, lists and codes), and the per-shard top-k are merged.
Global ids are ``shard_base + local id``, the flat store's contiguity, so
the span rescore is unchanged.

- ``ShardedIVF``: the host-merged variant. One process, a list of devices
  (a device may repeat), no collective: it searches each sub-index in turn
  and merges on the host.
- ``MeshShardedIVF``: the collective variant, one rank a device
  (``parallel.Mesh``). Each rank holds only its own sub-index, padded by
  the reference's rules to the mesh's largest nlist (pad centroids are
  zero rows that the probe masks with ``nlist_valid``, pad lists are empty)
  and to its largest row count, runs its local search, and the ranks'
  ``[B, K]`` candidates are all-gathered and merged, so every rank returns
  the same result. The reference runs the local search through its grouped
  XLA scans (``_probe_score`` / ``_union_scan``); the port runs it through
  ``packed_union_scan`` / ``packed_pq_scan`` (kernels C and D) at every
  batch size (ROADMAP Queue 3).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
from densephrases_tpu_torch.ops.ivf_pack import (
    NEG_INF,
    TPB,
    pack_budget_table,
    packed_pq_scan,
    packed_union_scan,
    row_lists,
)
from densephrases_tpu_torch.ops.quant import DEFAULT_OFFSET, DEFAULT_SCALE
from densephrases_tpu_torch.ops.topk import topk_merge
from densephrases_tpu_torch.parallel import Mesh, all_gather
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _all_cards() -> list:
    """Every CUDA device (the reference's ``jax.devices()``); raises
    without a GPU."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class ShardedIVF:
    """Row-partitioned IVF over several devices, searched from one process,
    with ``IVFIndex``'s search API."""

    def __init__(self, sub_indexes: List[IVFIndex], shard_bases: List[int],
                 devices: Optional[Sequence] = None):
        if len(sub_indexes) != len(shard_bases):
            raise ValueError(f"{len(sub_indexes)} sub-indexes for "
                             f"{len(shard_bases)} bases")
        self.subs = sub_indexes
        self.bases = shard_bases
        self.devices = list(devices) if devices is not None else None
        self.n_total = sum(s.n_total for s in sub_indexes)

    @staticmethod
    def build(codes: np.ndarray, cfg: IVFConfig,
              devices: Optional[Sequence] = None,
              offset: float = DEFAULT_OFFSET, scale: float = DEFAULT_SCALE,
              verbose: bool = False) -> "ShardedIVF":
        """Split the rows evenly and build one sub-index on each device
        (None: every CUDA device). Each sub-index's config is the
        reference's (sharded.py:64-71) field for field: the fields it does
        not name (``two_level_clusters``, ``prefer_union_batch``,
        ``int4_ranges``, ``sq4_train_ranges``, ...) take their defaults."""
        devices = list(devices) if devices is not None else _all_cards()
        s = len(devices)
        n = codes.shape[0]
        per = (n + s - 1) // s
        subs, bases = [], []
        sub_clusters = max(cfg.num_clusters // s, 1)
        for i, dev in enumerate(devices):
            lo, hi = i * per, min((i + 1) * per, n)
            if lo >= hi:
                break
            sub_cfg = IVFConfig(
                num_clusters=min(sub_clusters, max((hi - lo) // 4, 1)),
                fine_quant=cfg.fine_quant, kmeans_iters=cfg.kmeans_iters,
                pq_iters=cfg.pq_iters, opq_iters=cfg.opq_iters,
                sample_ratio=cfg.sample_ratio, seed=cfg.seed + i,
                refine_factor=cfg.refine_factor,
                max_list_scan=cfg.max_list_scan,
                balance_factor=cfg.balance_factor)
            sub = IVFIndex.build(codes[lo:hi], sub_cfg, offset=offset,
                                 scale=scale, verbose=verbose, device=dev)
            subs.append(sub)
            bases.append(lo)
            logger.info("shard %d on %s: rows [%d, %d), nlist=%d",
                        i, dev, lo, hi, sub.nlist)
        return ShardedIVF(subs, bases, devices)

    def search(self, queries, top_k: int = 10, nprobe: int = 64,
               as_numpy: bool = True):
        """Search every shard (each on its own device), merge on the host.
        Returns (scores [B, top_k], global ids [B, top_k] int32), numpy or,
        with as_numpy=False, CPU tensors."""
        q = torch.as_tensor(np.asarray(queries, np.float32))
        vals, ids = [], []
        for sub, base in zip(self.subs, self.bases):
            v, i = sub.search(q, top_k=top_k, nprobe=nprobe, as_numpy=False)
            vals.append(v.cpu())
            ids.append(i.cpu().to(torch.int32) + base)
        m_vals, m_ids = topk_merge(torch.stack(vals, 1), torch.stack(ids, 1),
                                   top_k)
        if as_numpy:
            return m_vals.numpy(), m_ids.numpy()
        return m_vals, m_ids


class MeshShardedIVF:
    """The collective sharded IVF: each rank searches its own sub-index and
    the candidates are all-gathered and merged (one SPMD program)."""

    def __init__(self, sub_index: IVFIndex, shard_bases: List[int],
                 mesh: Mesh, axis: str = "shard"):
        """sub_index: THIS rank's shard (the reference passes every shard
        to its single controller). shard_bases: every shard's first global
        row, an equal partition (the last shard may be short). Every rank
        calls this together: the padding sizes, the nprobe clamp and
        n_total come from collectives."""
        s = mesh.shape[axis]
        if len(shard_bases) != s:
            raise ValueError(f"{len(shard_bases)} bases for {s} shards")
        if len(set(int(b) for b in np.diff(shard_bases))) > 1:
            raise ValueError("shards must be an equal row partition (the "
                             "last may be short)")
        sub = sub_index
        self.mesh, self.axis = mesh, axis
        self.device = mesh.device
        self.cfg = sub.cfg
        self.offset, self.scale = sub.offset, sub.scale
        self.sq4 = bool(sub.sq4)
        self.int4_vector = sub.int4_vector
        self.int4_offset, self.int4_scale = sub.int4_offset, sub.int4_scale
        self.pq_residual = bool(sub.pq_residual)
        self.n_real = sub.n_real
        self.shard_rows = (shard_bases[1] - shard_bases[0] if s > 1
                           else sub.n_total)
        self.base = mesh.rank * self.shard_rows
        nlist = sub.nlist
        flags = [sub.pq_books is not None, sub.rotation is not None,
                 sub.refine_codes is not None, self.pq_residual, self.sq4]
        self._check_agree(flags, ("mixed fine_quant shards", "mixed rotation",
                                  "mixed refine", "mixed residual/full-"
                                  "vector PQ shards", "mixed SQ4/SQ8 shards"))
        if self.sq4:
            self._check_int4_affine()
        rows_need = sub.n_real + sub.cap
        refine_rows = (0 if sub.refine_codes is None
                       else sub.refine_codes.shape[0])
        mx = self._reduce([nlist, rows_need, sub.codes.shape[0], sub.cap,
                           refine_rows], "max")
        nlist_max, rows_need, codes_rows, self.cap, refine_rows = mx
        self.nlist_valid_min = self._reduce([nlist], "min")[0]
        self.n_total = self._reduce([sub.n_total], "sum")[0]
        rows_max = _round_up(max(rows_need, codes_rows), 32)

        def pad(t, rows, value=0):
            if t.shape[0] >= rows:
                return t
            fill = t.new_full((rows - t.shape[0],) + tuple(t.shape[1:]), value)
            return torch.cat([t, fill])

        # pad centroids with zero rows (masked out of the probe by
        # nlist_valid); pad list_offsets by repeating the total (pad lists
        # are empty); codes and row_perm to the mesh's largest row count
        self.nlist_valid = nlist
        self.centroids = pad(sub.centroids, nlist_max)
        self.list_offsets = pad(sub.list_offsets, nlist_max + 1,
                                int(sub.list_offsets[-1]))
        self.codes = pad(sub.codes, rows_max)
        self.row_perm = pad(sub.row_perm, rows_max)
        self.rotation, self.pq_books = sub.rotation, sub.pq_books
        self.pq = sub.pq  # the host codebook object (None for SQ)
        self.refine_codes = (None if sub.refine_codes is None
                             else pad(sub.refine_codes, refine_rows))
        self.row_list = (row_lists(self.list_offsets, self.codes.shape[0],
                                   self.centroids.shape[0])
                         if self.pq_residual else None)
        # the guard block budgets of this shard's own lists
        self._pack_table = pack_budget_table(
            sub.list_offsets.cpu().numpy(), self.cap)

    # ------------------------------------------------------- collectives
    def _reduce(self, values, how: str) -> list:
        """Elementwise max / min / sum of small int lists over the ranks."""
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        g = all_gather(t[None], self.mesh)
        red = {"max": g.amax(0), "min": g.amin(0), "sum": g.sum(0)}[how]
        return [int(v) for v in red.cpu()]

    def _check_agree(self, flags, messages):
        """Every rank holds the same kind of shard; a mismatch raises on
        every rank (no rank is left waiting in a later collective)."""
        g = all_gather(torch.tensor([flags], dtype=torch.int64,
                                    device=self.device), self.mesh)
        same = (g == g[:1]).all(0).cpu().tolist()
        for ok, msg in zip(same, messages):
            if not ok:
                raise ValueError(msg)

    def _check_int4_affine(self):
        """SQ4 shards share one int4 affine (the merge compares scores
        across shards)."""
        off = torch.as_tensor(self.int4_offset, dtype=torch.float32,
                              device=self.device).reshape(-1)
        sc = torch.as_tensor(self.int4_scale, dtype=torch.float32,
                             device=self.device).reshape(-1)
        g = all_gather(torch.cat([off, sc])[None], self.mesh)
        if not bool((g == g[:1]).all()):
            raise ValueError("shards disagree on the int4 affine")

    # ------------------------------------------------------------- build
    @staticmethod
    def build(codes: np.ndarray, cfg: IVFConfig, mesh: Mesh,
              axis: str = "shard", offset: float = DEFAULT_OFFSET,
              scale: float = DEFAULT_SCALE,
              verbose: bool = False) -> "MeshShardedIVF":
        """Every rank passes the same codes (e.g. a memmap) and builds only
        its own shard on ``mesh.device``, with the reference's sub-config
        (sharded.py:181-193) and, for SQ4, one int4 contract trained on a
        global subsample (``_shared_int4_ranges``)."""
        s = int(mesh.shape[axis])
        n = codes.shape[0]
        per = (n + s - 1) // s
        if (s - 1) * per >= n:
            raise ValueError(f"more shards ({s}) than rows ({n})")
        ranges = MeshShardedIVF._shared_int4_ranges(codes, cfg, offset, scale)
        i = mesh.rank
        sub_cfg = IVFConfig(
            num_clusters=max(cfg.num_clusters // s, 1),
            fine_quant=cfg.fine_quant, kmeans_iters=cfg.kmeans_iters,
            pq_iters=cfg.pq_iters, opq_iters=cfg.opq_iters,
            sample_ratio=cfg.sample_ratio, seed=cfg.seed + i,
            refine_factor=cfg.refine_factor,
            max_list_scan=cfg.max_list_scan,
            balance_factor=cfg.balance_factor,
            two_level_clusters=cfg.two_level_clusters,
            assign_probe=cfg.assign_probe,
            prefer_union_batch=cfg.prefer_union_batch,
            int4_ranges=ranges, sq4_train_ranges=cfg.sq4_train_ranges)
        sub = IVFIndex.build(codes[i * per:min((i + 1) * per, n)], sub_cfg,
                             offset=offset, scale=scale, verbose=verbose,
                             device=mesh.device)
        return MeshShardedIVF(sub, [j * per for j in range(s)], mesh,
                              axis=axis)

    @staticmethod
    def _shared_int4_ranges(codes, cfg, offset, scale):
        """Sharded SQ4 builds share ONE trained int4 contract, trained once
        on a global subsample (host numpy, so every rank gets the same)."""
        if cfg.fine_quant != "SQ4":
            return getattr(cfg, "int4_ranges", None)
        if getattr(cfg, "int4_ranges", None) is not None:
            return cfg.int4_ranges
        if not getattr(cfg, "sq4_train_ranges", True):
            return None
        from densephrases_tpu_torch.ops.quant import train_int4_ranges

        sub = np.ascontiguousarray(codes[:: max(len(codes) // 131072, 1)])
        sub_f = (sub.astype(np.float32) / scale + offset
                 if sub.dtype == np.int8 else sub.astype(np.float32))
        return train_int4_ranges(sub_f)

    # ------------------------------------------------------------ search
    def _local(self, q, k: int, nprobe: int):
        """This rank's candidates through kernel C (SQ8 / SQ4) or D (PQ /
        OPQ), with the reference's k and scan_k over the GLOBAL n_total."""
        u_cap = min(q.shape[0] * nprobe, self.nlist_valid)
        budget = _round_up(max(int(self._pack_table[u_cap - 1]), TPB), 64)
        common = dict(nprobe=nprobe, cap=self.cap, budget=budget,
                      n_real=self.n_real)
        if self.pq_books is None:
            if self.sq4 and self.int4_vector:
                # the trained per-dim contract: the scale vector folds into
                # the queries and the bias into a vector offset
                q_score = q / self.int4_scale
                off, sc = self.int4_scale * self.int4_offset, 1.0
            elif self.sq4:
                q_score, off, sc = q, self.int4_offset, self.int4_scale
            else:
                q_score, off, sc = q, self.offset, self.scale
            return packed_union_scan(
                q, self.centroids, self.list_offsets, self.codes,
                self.row_perm, off, sc, self.nlist_valid, q_score=q_score,
                top_k=k, sq4=self.sq4, **common)
        n = max(self.n_total, 1)
        scan_k = (min(k * self.cfg.refine_factor, n)
                  if self.refine_codes is not None else min(k, n))
        q_rot = q if self.rotation is None else q @ self.rotation
        return packed_pq_scan(
            q, q_rot, self.centroids, self.list_offsets, self.codes,
            self.row_perm, self.pq_books, self.refine_codes, self.offset,
            self.scale, self.nlist_valid, top_k=k, scan_k=scan_k,
            pq_residual=self.pq_residual, row_list=self.row_list,
            **common)

    def search(self, queries, top_k: int = 10, nprobe: int = 64,
               as_numpy: bool = True):
        """One collective search; every rank passes the same queries and
        gets the same merged (scores [B, top_k], global ids int32)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        nprobe = min(nprobe, self.nlist_valid_min)
        k = min(top_k, self.n_total)
        vals, ids = self._local(q, k, nprobe)
        if vals.shape[1] < k:  # a scan narrower than k: equal gather shapes
            pad = k - vals.shape[1]
            vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                                  NEG_INF)], 1)
            ids = torch.cat([ids, ids.new_zeros((ids.shape[0], pad))], 1)
        gids = ids.to(torch.int32) + self.base
        all_vals = all_gather(vals[None], self.mesh)  # [S, B, K]
        all_ids = all_gather(gids[None], self.mesh)
        vals, ids = topk_merge(all_vals.transpose(0, 1),
                               all_ids.transpose(0, 1), k)
        if k < top_k:
            pad = top_k - k
            vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                                  NEG_INF)], 1)
            ids = torch.cat([ids, ids.new_zeros((ids.shape[0], pad))], 1)
        if as_numpy:
            return vals.cpu().numpy(), ids.cpu().numpy()
        return vals, ids
