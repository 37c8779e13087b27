"""Flat (exact) MIPS over the int8 phrase store, on one device or a mesh.

The counterpart of the single-device paths of
``densephrases_tpu/index/flat.py``:

- the corpus is uploaded once, zero-padded to a whole number of chunks;
  an int8 index shares its buffer with the span rescore stage (``MIPS``);
- scoring dequantizes inside the product:
  ``q · (c/scale + offset) = (q · c)/scale + offset·Σq``. The queries are
  rounded to bf16 for the product, while ``Σq`` comes from the fp32
  queries, as in the reference (flat.py:120-121). The product of bf16
  queries and int8 codes is exact in fp32 and accumulates in fp32, the
  role of the reference's ``preferred_element_type=f32``;
- a loop over corpus chunks keeps a per-chunk top-k, then one exact merge;
- ``quant="int4"`` re-quantizes the vectors to the int4 contract
  (``ops/quant.py``) on the device, slice by slice, and keeps two nibbles a
  byte, the high nibble holding the first half of the dims: half the
  device bytes of int8. Its scan unpacks each chunk before the product.

The reference takes ``approx_max_k`` per chunk on the TPU; the port takes an
exact ``torch.topk``, which equals the reference on CPU (where
``approx_max_k`` is exact).

With a ``mesh`` (``parallel.Mesh``: one rank a device), rank r keeps rows
``[r*shard_rows, (r+1)*shard_rows)`` on its card, padded to whole chunks,
scans them, and the ranks' ``[B, K]`` candidates (global ids = local +
``r*shard_rows``) are all-gathered and merged (``ops/topk.topk_merge``), so
every rank returns the same result: the reference's ``shard_map`` path
(flat.py:262-293). A rank may instead be handed its preassembled block
(``parallel/multihost.flat_from_process_shards``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from densephrases_tpu_torch.ops.quant import (
    DEFAULT_OFFSET,
    DEFAULT_SCALE,
    INT4_OFFSET,
    INT4_SCALE,
    float_to_int4,
    int8_to_float,
)
from densephrases_tpu_torch.ops.topk import topk_merge
from densephrases_tpu_torch.parallel import all_gather
from densephrases_tpu_torch.utils.device import resolve_device

NEG_INF = -1e30  # pad-row score (flat.py:33)
SLICE_ROWS = 1 << 20  # rows a host→device copy


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _chunked_topk(queries, codes, n_valid: int, offset: float, scale: float,
                  unpack, *, top_k: int, chunk: int):
    """The scan both quantizations share: per chunk, ``unpack`` gives the
    fp32 codes [chunk, D] that the bf16-rounded queries multiply; exact
    top-k per chunk, exact merge. A chunk that does not divide the row
    count leaves a short last chunk, so every row is scored once."""
    qsum = queries.sum(-1) * offset  # [B] rank-1 dequant correction
    qbf = queries.to(torch.bfloat16).to(torch.float32)
    col = torch.arange(chunk, device=codes.device, dtype=torch.int32)
    vals, ids = [], []
    for i0 in range(0, codes.shape[0], chunk):
        block = unpack(codes[i0:i0 + chunk])
        rows = block.shape[0]
        s = (qbf @ block.T) / scale + qsum[:, None]
        s = s.masked_fill(i0 + col[:rows] >= n_valid, NEG_INF)
        v, pos = torch.topk(s, min(top_k, rows), dim=-1)
        vals.append(v)
        ids.append(pos.to(torch.int32) + i0)
    all_vals, all_ids = torch.cat(vals, 1), torch.cat(ids, 1)
    v, pos = torch.topk(all_vals, top_k, dim=-1)
    return v, torch.gather(all_ids, 1, pos)


def _scan_topk(queries, codes, n_valid: int, offset: float, scale: float,
               *, top_k: int, chunk: int):
    """MIPS over a padded int8 corpus. queries: [B, D] fp32. codes: [R, D]
    int8 with R % chunk == 0; rows >= n_valid are padding and score
    NEG_INF. Returns (scores [B, top_k] fp32, ids [B, top_k] int32)."""
    return _chunked_topk(queries, codes, n_valid, offset, scale,
                         lambda c: c.to(torch.float32), top_k=top_k,
                         chunk=chunk)


def _unpack_int4(c):
    """[rows, D/2] packed bytes → [rows, D] fp32 nibble values, the high
    nibble first (``ops/quant.float_to_int4``'s layout)."""
    c = c.to(torch.int32)
    return torch.cat([c >> 4, c & 0x0F], dim=1).to(torch.float32)


def _scan_topk_int4(queries, packed, n_valid: int, offset: float,
                    scale: float, *, top_k: int, chunk: int):
    """MIPS over int4-packed codes [R, D/2] with the int4 (offset, scale)
    contract (ref flat.py:66-99): the same scan as ``_scan_topk``, each
    chunk unpacked before its product."""
    return _chunked_topk(queries, packed, n_valid, offset, scale,
                         _unpack_int4, top_k=top_k, chunk=chunk)


class FlatIndex:
    """Exact MIPS over int8 (or re-quantized int4) codes, on one device or
    sharded over a mesh's ranks."""

    def __init__(self, codes, offset: float = DEFAULT_OFFSET,
                 scale: float = DEFAULT_SCALE, mesh=None,
                 shard_axis: str = "shard", chunk: int = 4096,
                 quant: str = "int8", int4_offset: Optional[float] = None,
                 int4_scale: Optional[float] = None,
                 n_total: Optional[int] = None, *, device="cuda"):
        """codes: [N, D] int8 numpy array or tensor (a memmap streams
        slice by slice, never copied whole on the host). The parameters are the
        reference's, in its order. mesh: a ``parallel.Mesh``; each rank
        passes the same codes and keeps its own rows on ``mesh.device``
        (``device`` is then unused). With a mesh, codes may instead be this
        rank's PREASSEMBLED block [1, shard_rows // chunk, chunk, D] (a
        tensor or array; ``flat_from_process_shards``), and ``n_total``,
        the global row count, is required; the reference takes the whole
        stacked global array there. Without a mesh ``n_total`` must equal
        N when given. quant: "int8", or "int4" with the int4 contract
        (``int4_offset``, ``int4_scale``; None: the fixed defaults),
        single-device only as in the reference."""
        if codes.dtype not in (np.int8, torch.int8):
            raise ValueError(f"codes must be int8, got {codes.dtype}")
        if quant not in ("int8", "int4"):
            raise ValueError(f"quant must be 'int8' or 'int4', got {quant!r}")
        self.quant = quant
        self.offset = float(offset)
        self.scale = float(scale)
        self.mesh = mesh
        self.shard_axis = shard_axis
        if mesh is not None:
            if quant != "int8":
                raise ValueError("the int4 flat index is single-device")
            self.device = mesh.device
            self._init_mesh(codes, chunk, n_total)
            return
        if n_total is not None and int(n_total) != codes.shape[0]:
            raise ValueError(f"n_total {n_total} != {codes.shape[0]} rows")
        self.device = resolve_device(device)
        self.n_total, self.dim = codes.shape
        self.chunk = min(chunk, max(512, _round_up(self.n_total or 1, 8)))
        self.shard_rows = _round_up(max(self.n_total, 1), self.chunk)
        if quant == "int4":
            if self.dim % 2:
                raise ValueError("int4 packing needs an even feature dim")
            self.int4_offset = float(INT4_OFFSET if int4_offset is None
                                     else int4_offset)
            self.int4_scale = float(INT4_SCALE if int4_scale is None
                                    else int4_scale)
        width = self.dim // 2 if quant == "int4" else self.dim
        self.codes = torch.zeros(
            (self.shard_rows, width),
            dtype=torch.uint8 if quant == "int4" else torch.int8,
            device=self.device)
        self._upload(codes, 0, self.n_total)

    def _upload(self, codes, lo: int, hi: int):
        """Copy rows [lo, hi) of the codes (a host array, or a tensor on
        any device) into ``self.codes[0:hi-lo]``."""
        for i0 in range(lo, hi, SLICE_ROWS):
            rows = codes[i0:min(i0 + SLICE_ROWS, hi)]
            if not isinstance(rows, torch.Tensor):
                # a writable copy of one slice: stores load read-only
                rows = torch.from_numpy(np.array(rows))
            if self.quant == "int4":  # re-quantized on the device
                rows = float_to_int4(
                    int8_to_float(rows.to(self.device), self.offset,
                                  self.scale),
                    self.int4_offset, self.int4_scale)
            self.codes[i0 - lo:i0 - lo + rows.shape[0]].copy_(rows)

    def _init_mesh(self, codes, chunk: int, n_total: Optional[int]):
        """This rank's rows, in the reference's stacked layout (the same
        chunk and shard_rows arithmetic, so global ids agree)."""
        n_dev = self.mesh.shape[self.shard_axis]
        if codes.ndim == 4:  # a preassembled block of this rank's rows
            if n_total is None:
                raise ValueError("preassembled codes need n_total")
            if codes.shape[0] != 1 or codes.shape[2] % 8:
                raise ValueError(f"preassembled block {tuple(codes.shape)} "
                                 "is not [1, chunks, chunk, D]")
            self.n_total, self.dim = int(n_total), int(codes.shape[3])
            self.chunk = int(codes.shape[2])
            self.shard_rows = int(codes.shape[1] * codes.shape[2])
            self.codes = torch.as_tensor(codes, device=self.device).reshape(
                self.shard_rows, self.dim)
            return
        if n_total is not None and int(n_total) != codes.shape[0]:
            raise ValueError(f"n_total {n_total} != {codes.shape[0]} rows")
        self.n_total, self.dim = codes.shape
        self.chunk = min(chunk, max(512, _round_up(
            self.n_total // max(n_dev, 1) or 1, 8)))
        self.shard_rows = _round_up(
            max(self.n_total // n_dev + (self.n_total % n_dev > 0), 1),
            self.chunk)
        self.codes = torch.zeros((self.shard_rows, self.dim),
                                 dtype=torch.int8, device=self.device)
        lo = min(self.mesh.rank * self.shard_rows, self.n_total)
        self._upload(codes, lo, min(lo + self.shard_rows, self.n_total))

    def _mesh_search(self, queries, k: int, chunk: int):
        """Per-rank scan, then the all-gather and merge of the candidates."""
        base = self.mesh.rank * self.shard_rows
        n_valid = min(max(self.n_total - base, 0), self.shard_rows)
        vals, ids = _scan_topk(queries, self.codes, n_valid, self.offset,
                               self.scale, top_k=k, chunk=chunk)
        # int32 global ids below 2^31 rows, as in the reference
        gids = ids.to(torch.int32 if self.n_total < 2**31 else torch.int64)
        gids = gids + base
        all_vals = all_gather(vals[None], self.mesh)  # [S, B, K]
        all_ids = all_gather(gids[None], self.mesh)
        return topk_merge(all_vals.transpose(0, 1), all_ids.transpose(0, 1), k)

    def search(self, queries, top_k: int = 10, nprobe: int = 0,
               as_numpy: bool = True, *, chunk: Optional[int] = None):
        """queries: [B, D] → (scores [B, K] fp32, ids [B, K] int32).
        nprobe is accepted and ignored, as in the reference, so ``MIPS``
        passes it to either index type. as_numpy=False keeps the results
        on the device. chunk: the rows of each scanned chunk (None: the
        index's); each chunk's top-k is exact, so the ids do not depend on
        it. With a mesh every rank passes the same queries and gets the
        same merged result."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        k = min(top_k, self.n_total)
        chunk = chunk or self.chunk
        if self.mesh is not None:
            vals, ids = self._mesh_search(queries, k, chunk)
        elif self.quant == "int4":
            vals, ids = _scan_topk_int4(
                queries, self.codes, self.n_total, self.int4_offset,
                self.int4_scale, top_k=k, chunk=chunk)
        else:
            vals, ids = _scan_topk(queries, self.codes, self.n_total,
                                   self.offset, self.scale, top_k=k,
                                   chunk=chunk)
        if k < top_k:  # pad to the requested k for fixed downstream shapes
            pad = top_k - k
            vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                                  NEG_INF)], -1)
            ids = torch.cat([ids, ids.new_zeros((ids.shape[0], pad))], -1)
        if as_numpy:
            return vals.cpu().numpy(), ids.cpu().numpy()
        return vals, ids
