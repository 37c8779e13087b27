"""Host-tiered exact and IVF MIPS: serve a corpus larger than the device.

The counterpart of ``densephrases_tpu/index/tiered.py`` (the reference's
on-disk FAISS inverted lists):

- ``TieredFlatIndex``: the first rows of the int8 corpus, as many whole
  scan chunks as ``hbm_budget_bytes`` allows, live on the device and are
  scanned by the flat scan (``index/flat.py:_scan_topk``); the rest stays
  in the host memmap and streams to the device in ``block_rows`` blocks,
  each scored for the whole query batch, bf16(q) · int8 in fp32, its
  top-k kept. The candidates of every tier merge with ``topk_merge``.
- ``TieredIVF``: only the coarse centroids live on the device. A batch is
  probed there; each unique probed list is one contiguous row range of the
  sorted codes memmap (``madvise(WILLNEED)`` asks for all of them first);
  the ranges are packed into fixed ``block_rows`` blocks (the last one's
  rows past its fill masked, as the reference's ``-1`` pad rows) that
  stream to the device and are scored for the whole batch (SQ8, or SQ4
  nibbles unpacked high nibble first); the blocks' top-k come back to the
  host and merge exactly there.

Union semantics: every query of a batch scores the union of the lists the
batch probed, a superset of its own, as the in-device union scan does.
A query's results therefore depend on the rest of its batch.

Streaming (on a CUDA device): each block is read from the memmap into a
pinned host buffer and copied to the device with ``non_blocking`` on a side
stream, while the default stream scores the block before it. One CUDA
event per buffer says its copy is done (the scoring waits on it) and one
that its scoring is done (the next copy into it waits on that), so the host
never waits for a block's scoring. The reference's rotating pool of host
buffers guarded by ``block_until_ready`` becomes these pinned buffers and
events. On the CPU the blocks are scored in turn.

PQ lists are refused, as in the reference: the tiered path serves raw-code
lists, and PQ codes fit the device at these scales.
"""

from __future__ import annotations

import logging
import mmap
import os
import time

import numpy as np
import torch

from densephrases_tpu_torch.index.flat import _round_up, _scan_topk
from densephrases_tpu_torch.index.ivf import _RefUnpickler, _upload
from densephrases_tpu_torch.ops.ivf_pack import _topk2, probe
from densephrases_tpu_torch.ops.kmeans import _bf16
from densephrases_tpu_torch.ops.quant import (
    DEFAULT_OFFSET,
    DEFAULT_SCALE,
    INT4_OFFSET,
    INT4_SCALE,
)
from densephrases_tpu_torch.ops.topk import topk_merge
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

NEG_INF = -1e30


def _pinned(n: int, rows: int, cols: int, device: torch.device):
    """n zeroed int8 host buffers, page-locked when they feed a CUDA
    device (kept by the index across searches: pinning is slow)."""
    return [torch.zeros((rows, cols), dtype=torch.int8,
                        pin_memory=device.type == "cuda") for _ in range(n)]


class _BlockStream:
    """One search's int8 blocks from host buffers to the device, one device
    buffer per host buffer. ``host()`` returns the next host buffer, free
    to fill; ``send(fill)`` copies its first ``fill`` rows to the device and
    returns the device block, which the caller scores on the current
    stream and then releases with ``scored()``. The device buffers are
    freed with this object."""

    def __init__(self, host_bufs, device: torch.device):
        self.host_bufs = host_bufs
        self.device = device
        self.cuda = device.type == "cuda"
        self.dev_bufs = [torch.empty(h.shape, dtype=torch.int8, device=device)
                         for h in host_bufs]
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event() for _ in host_bufs]
            self.done = [torch.cuda.Event() for _ in host_bufs]
        self.sent = 0  # blocks handed over so far

    def host(self) -> np.ndarray:
        i = self.sent % len(self.host_bufs)
        if self.cuda and self.sent >= len(self.host_bufs):
            self.copied[i].synchronize()  # its last copy has left it
        return self.host_bufs[i].numpy()

    def send(self, fill: int) -> torch.Tensor:
        i = self.sent % len(self.host_bufs)
        self.sent += 1
        dev, host = self.dev_bufs[i], self.host_bufs[i]
        if not self.cuda:
            dev[:fill].copy_(host[:fill])
            return dev
        with torch.cuda.stream(self.copy_stream):
            # the device buffer is free once the block before in it is scored
            self.copy_stream.wait_event(self.done[i])
            dev[:fill].copy_(host[:fill], non_blocking=True)
            self.copied[i].record(self.copy_stream)
        torch.cuda.current_stream(self.device).wait_event(self.copied[i])
        return dev

    def scored(self):
        """The block last sent is scored (its device buffer may be reused)."""
        if self.cuda:
            i = (self.sent - 1) % len(self.host_bufs)
            self.done[i].record(torch.cuda.current_stream(self.device))


class TieredFlatIndex:
    """Exact MIPS over an int8 corpus split between the device and a host
    memmap.

    codes: [N, D] int8, typically ``PhraseStore.load(path, mmap=True).vecs``.
    hbm_budget_bytes: the resident tier's size cap (device bytes).
    block_rows: rows a host → device block of the overflow tier."""

    def __init__(self, codes, offset: float = DEFAULT_OFFSET,
                 scale: float = DEFAULT_SCALE, *,
                 hbm_budget_bytes: int = 8 << 30, block_rows: int = 1 << 20,
                 chunk: int = 4096, device="cuda"):
        assert codes.dtype == np.int8
        self.device = resolve_device(device)
        self.n_total, self.dim = codes.shape
        self.offset = float(offset)
        self.scale = float(scale)
        self.quant = "int8"

        max_resident = max(int(hbm_budget_bytes // self.dim), 0)
        self.chunk = chunk = min(chunk,
                                 max(8, _round_up(max(self.n_total, 1), 8)))
        n_resident = min(self.n_total, max_resident) // chunk * chunk
        if n_resident == 0 and 0 < self.n_total <= max_resident:
            n_resident = self.n_total
        self.n_resident = n_resident
        self.block_rows = int(block_rows)
        self.codes = None  # the resident tier, zero-padded to whole chunks
        if n_resident > 0:
            self.codes = _upload(codes[:n_resident], torch.int8, self.device,
                                 rows=_round_up(n_resident, chunk))
        self._overflow = codes  # the memmap: slices page in on demand
        self._host_bufs = None
        logger.info("tiered index: %d rows resident (%.2f GB), %d rows "
                    "host-tier", n_resident, n_resident * self.dim / 2**30,
                    self.n_total - n_resident)

    def search(self, queries, top_k: int = 10, nprobe: int = 0,
               as_numpy: bool = True):
        """queries: [B, D] → (scores [B, K], global row ids [B, K] int32).
        nprobe is accepted and ignored (exact scan)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        k = min(top_k, max(self.n_total, 1))
        cand_vals, cand_ids = [], []
        if self.n_resident > 0:
            vals, ids = _scan_topk(q, self.codes, self.n_resident,
                                   self.offset, self.scale,
                                   top_k=min(k, self.n_resident),
                                   chunk=self.chunk)
            cand_vals.append(vals)
            cand_ids.append(ids)
        br = self.block_rows
        if self.n_resident < self.n_total:
            if self._host_bufs is None:  # blocks of whole scan chunks
                self._host_bufs = _pinned(2, _round_up(br, self.chunk),
                                          self.dim, self.device)
            stream = _BlockStream(self._host_bufs, self.device)
        for lo in range(self.n_resident, self.n_total, br):
            n_valid = min(br, self.n_total - lo)
            stream.host()[:n_valid] = self._overflow[lo:lo + n_valid]
            block = stream.send(n_valid)[:_round_up(n_valid, self.chunk)]
            vals, ids = _scan_topk(q, block, n_valid, self.offset, self.scale,
                                   top_k=min(k, br), chunk=self.chunk)
            stream.scored()
            cand_vals.append(vals)
            cand_ids.append(ids + lo)
        vals, ids = topk_merge(torch.cat(cand_vals, 1)[:, None, :],
                               torch.cat(cand_ids, 1)[:, None, :], k)
        if k < top_k:
            pad = top_k - k
            vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                                  NEG_INF)], 1)
            ids = torch.cat([ids, ids.new_zeros((ids.shape[0], pad))], 1)
        if as_numpy:
            return vals.cpu().numpy(), ids.cpu().numpy()
        return vals, ids

    def gather_rows_host(self, gids: np.ndarray) -> np.ndarray:
        """int8 rows of arbitrary global ids (a host memmap gather), for the
        tiered span rescore."""
        return np.asarray(self._overflow[np.clip(gids, 0, self.n_total - 1)])


class TieredIVF:
    """IVF whose inverted lists live in host memory (a memmap of the sorted
    codes); only the coarse centroids are on ``device``. Raw-code lists:
    SQ8, or SQ4 packed nibbles scored with the int4 contract (a scalar
    pair, or per-dim trained ranges). See the module docstring for the
    search and its union semantics."""

    def __init__(self, centroids, list_offsets, codes_sorted, row_perm,
                 offset: float = DEFAULT_OFFSET, scale: float = DEFAULT_SCALE,
                 block_rows: int = 1 << 18, sq4: bool = False,
                 int4_offset=None, int4_scale=None, *, device="cuda"):
        self.device = resolve_device(device)
        self.centroids = torch.as_tensor(np.asarray(centroids, np.float32),
                                         device=self.device)
        self.list_offsets = np.asarray(list_offsets)  # host: drives the IO
        self._codes = codes_sorted  # [N_pad, D] int8, or [N_pad, D/2] SQ4
        self._row_perm = np.asarray(row_perm)
        self.offset = float(offset)
        self.scale = float(scale)
        self.sq4 = bool(sq4)
        i4o = INT4_OFFSET if int4_offset is None else int4_offset
        i4s = INT4_SCALE if int4_scale is None else int4_scale
        # scalar: the fixed legacy contract; [D] vectors: trained ranges
        self.int4_vector = np.ndim(i4o) > 0
        self.int4_offset = (np.asarray(i4o, np.float32) if self.int4_vector
                            else float(i4o))
        self.int4_scale = (np.asarray(i4s, np.float32) if self.int4_vector
                           else float(i4s))
        self.block_rows = int(block_rows)
        self.nlist = int(self.list_offsets.shape[0] - 1)
        self.n_total = int(self.list_offsets[-1])
        # original-order vectors for the rescore (usually the store's
        # memmap); without them, rows come through the inverse permutation
        self.store_vecs = None
        self._inv_perm = None
        self._host_bufs = None
        self.last_profile = None

    @staticmethod
    def load(path: str, block_rows: int = 1 << 18, *,
             device="cuda") -> "TieredIVF":
        """Open a saved IVF directory (either package's) with its codes
        memory-mapped."""
        with open(os.path.join(path, "ivf.pkl"), "rb") as f:
            extra = _RefUnpickler(f).load()
        assert extra["pq"] is None, \
            "TieredIVF serves raw-code (SQ8/SQ4) lists, not PQ (see doc)"
        return TieredIVF(
            np.load(os.path.join(path, "centroids.npy")),
            np.load(os.path.join(path, "list_offsets.npy")),
            np.load(os.path.join(path, "codes.npy"), mmap_mode="r"),
            np.load(os.path.join(path, "row_perm.npy")),
            offset=extra["offset"], scale=extra["scale"],
            block_rows=block_rows,
            sq4=getattr(extra["cfg"], "fine_quant", "SQ8") == "SQ4",
            int4_offset=extra.get("int4_offset"),
            int4_scale=extra.get("int4_scale"), device=device)

    @staticmethod
    def from_index(ivf, block_rows: int = 1 << 18, *,
                   device="cuda") -> "TieredIVF":
        """Wrap an ``IVFIndex`` (host copies of its arrays)."""
        assert ivf.pq is None, \
            "TieredIVF serves raw-code (SQ8/SQ4) lists, not PQ (see doc)"

        def host(v):
            return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

        return TieredIVF(host(ivf.centroids), host(ivf.list_offsets),
                         host(ivf.codes), host(ivf.row_perm),
                         offset=ivf.offset, scale=ivf.scale,
                         block_rows=block_rows, sq4=ivf.sq4,
                         int4_offset=host(ivf.int4_offset),
                         int4_scale=host(ivf.int4_scale), device=device)

    def gather_rows_host(self, gids: np.ndarray) -> np.ndarray:
        """int8 rows in the store's affine for original global ids (the
        tiered rescore's hook)."""
        gids = np.clip(gids, 0, self.n_total - 1)
        if self.store_vecs is not None:
            return np.asarray(self.store_vecs[gids])
        if self._inv_perm is None:
            inv = np.empty(self.n_total, np.int64)
            inv[self._row_perm[:self.n_total]] = np.arange(self.n_total)
            self._inv_perm = inv
        rows = np.asarray(self._codes[self._inv_perm[gids]])
        if self.sq4:
            # unpack the nibbles and re-express the int4 codes as int8
            # codes of the store's affine
            v = rows.astype(np.int32) & 0xFF
            i4 = np.concatenate([v >> 4, v & 0xF], axis=-1)
            f = i4.astype(np.float32) / self.int4_scale + self.int4_offset
            rows = np.clip(np.round((f - self.offset) * self.scale),
                           -128, 127).astype(np.int8)
        return rows

    def _advise_ranges(self, starts, ends) -> None:
        """madvise(WILLNEED) every probed byte range up front, so the
        kernel queues the reads together instead of one cold read at a
        time."""
        mm = getattr(self._codes, "_mmap", None)
        if mm is None:
            return
        try:
            page = mmap.PAGESIZE
            base = self._codes.offset
            rb = self._codes.shape[1] * self._codes.dtype.itemsize
            for s0, e0 in zip(starts, ends):
                lo = (base + int(s0) * rb) // page * page
                hi = base + int(e0) * rb
                mm.madvise(mmap.MADV_WILLNEED, lo, hi - lo)
        except (AttributeError, ValueError, OSError):
            pass  # advice only

    def _score_block(self, qbf, qsum, block, n_valid: int, sc: float, k: int):
        """One streamed block for the whole batch: bf16(q) · code in fp32,
        the affine, rows past ``n_valid`` masked, its top-k (ties to the
        lower row)."""
        codes = block
        if self.sq4:  # the high nibble holds the first half of the dims
            v = block.view(torch.uint8)
            codes = torch.cat([v >> 4, v & 0xF], dim=1)
        s = (qbf @ codes.to(torch.float32).T) / sc + qsum[:, None]
        col = torch.arange(s.shape[1], device=s.device)
        s = s.masked_fill(col >= n_valid, NEG_INF)
        return _topk2(s, min(k, s.shape[1]))

    def search(self, queries, top_k: int = 10, nprobe: int = 64,
               as_numpy: bool = True):
        """queries [B, D] → (scores [B, K], global ids [B, K] of the save's
        ``row_perm`` type); device tensors with as_numpy=False.
        ``last_profile`` receives the stage seconds when
        ``DPH_TIERED_PROFILE=1``."""
        prof = os.environ.get("DPH_TIERED_PROFILE") == "1"
        tp0 = time.perf_counter()
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        b = q.shape[0]
        nprobe = min(nprobe, self.nlist)
        k = min(top_k, max(self.n_total, 1))

        probe_np = probe(q, self.centroids, nprobe).cpu().numpy()
        t_probe = time.perf_counter() - tp0

        offs = self.list_offsets
        uniq = np.unique(probe_np.reshape(-1))
        starts, ends = offs[uniq], offs[uniq + 1]
        lens = ends - starts
        self._advise_ranges(starts, ends)

        if self.sq4 and self.int4_vector:
            # trained per-dim contract: 1/scale folds into the queries,
            # scale · lo into qsum, and the block scale is 1
            i4s = torch.as_tensor(self.int4_scale, device=self.device)
            i4o = torch.as_tensor(self.int4_offset, device=self.device)
            q_sc = q / i4s
            qsum = (q_sc * (i4s * i4o)).sum(-1)
            qbf = _bf16(q_sc)
            sc = 1.0
        else:
            off, sc = ((self.int4_offset, self.int4_scale) if self.sq4
                       else (self.offset, self.scale))
            qsum = q.sum(-1) * off
            qbf = _bf16(q)

        br = self.block_rows
        if self._host_bufs is None:
            self._host_bufs = _pinned(4, br, self._codes.shape[1], self.device)
        stream = _BlockStream(self._host_bufs, self.device)
        dev_vals, dev_ids, blk_rows_l = [], [], []
        blk_rows = np.empty((br,), np.int64)
        io_s = h2d_s = 0.0
        fill = 0
        buf = None

        def flush(fill):
            nonlocal h2d_s
            t0 = time.perf_counter()
            block = stream.send(fill)
            h2d_s += time.perf_counter() - t0
            vals, ids = self._score_block(qbf, qsum, block, fill, sc,
                                          min(k, br))
            stream.scored()
            dev_vals.append(vals)
            dev_ids.append(ids)
            blk_rows_l.append(blk_rows.copy())

        for s0, ln in zip(starts, lens):
            done = 0
            while done < ln:
                if fill == 0:
                    buf = stream.host()
                take = min(int(ln - done), br - fill)
                t0 = time.perf_counter()
                buf[fill:fill + take] = self._codes[s0 + done:s0 + done + take]
                io_s += time.perf_counter() - t0
                blk_rows[fill:fill + take] = np.arange(s0 + done,
                                                       s0 + done + take)
                fill += take
                done += take
                if fill == br:
                    flush(fill)
                    fill = 0
        if fill:
            flush(fill)

        if not dev_vals:  # every probed list is empty
            vals = np.full((b, top_k), NEG_INF, np.float32)
            gids = np.zeros((b, top_k), np.int64)
        else:
            t0 = time.perf_counter()
            all_vals = torch.cat(dev_vals, 1).cpu().numpy()
            nb = len(dev_ids)
            ids = torch.cat(dev_ids, 1).cpu().numpy().reshape(b, nb, -1)
            fetch_s = time.perf_counter() - t0
            # each block's local top-k rows → sorted-row ids
            all_rows = np.stack(blk_rows_l)[
                np.arange(nb)[None, :, None], np.clip(ids, 0, br - 1)
            ].reshape(b, -1)
            if prof:
                self.last_profile = {
                    "probe_s": round(t_probe, 3), "io_s": round(io_s, 3),
                    "h2d_s": round(h2d_s, 3), "fetch_s": round(fetch_s, 3),
                    "blocks": len(dev_vals), "rows": int(lens.sum()),
                    "uniq_lists": int(len(uniq)),
                    "total_s": round(time.perf_counter() - tp0, 3)}
            # the exact merge on the host (blocks × k candidates a query)
            order = np.argsort(-all_vals, axis=1)[:, :k]
            vals = np.take_along_axis(all_vals, order, axis=1)
            rows = np.take_along_axis(all_rows, order, axis=1)
            gids = self._row_perm[np.clip(rows, 0, len(self._row_perm) - 1)]
            if k < top_k:
                pad = top_k - k
                vals = np.concatenate(
                    [vals, np.full((b, pad), NEG_INF, np.float32)], 1)
                gids = np.concatenate([gids, np.zeros((b, pad), gids.dtype)],
                                      1)
        if as_numpy:
            return vals, gids
        return (torch.as_tensor(vals, device=self.device),
                torch.as_tensor(gids, device=self.device))
