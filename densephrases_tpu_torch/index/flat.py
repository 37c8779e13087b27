"""Flat (exact) MIPS over the int8 phrase store, on one device.

The counterpart of the single-device int8 path of
``densephrases_tpu/index/flat.py``:

- the int8 corpus is uploaded once, zero-padded to a whole number of
  chunks, and shared with the span rescore stage (``MIPS``);
- scoring dequantizes inside the product:
  ``q · (c/scale + offset) = (q · c)/scale + offset·Σq``. The queries are
  rounded to bf16 for the product, while ``Σq`` comes from the fp32
  queries, as in the reference (flat.py:120-121). The product of bf16
  queries and int8 codes is exact in fp32 and accumulates in fp32, the
  role of the reference's ``preferred_element_type=f32``;
- a loop over corpus chunks keeps a per-chunk top-k, then one exact merge.

The reference takes ``approx_max_k`` per chunk on the TPU; the port takes an
exact ``torch.topk``, which equals the reference on CPU (where
``approx_max_k`` is exact). The mesh-sharded and int4 paths are not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from densephrases_tpu_torch.ops.quant import DEFAULT_OFFSET, DEFAULT_SCALE
from densephrases_tpu_torch.utils.device import resolve_device

NEG_INF = -1e30  # pad-row score (flat.py:33)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _scan_topk(queries, codes, n_valid: int, offset: float, scale: float,
               *, top_k: int, chunk: int):
    """MIPS over a padded corpus: chunked product, exact top-k per chunk,
    exact merge.

    queries: [B, D] fp32. codes: [R, D] int8 with R % chunk == 0; rows
    >= n_valid are padding and score NEG_INF.
    Returns (scores [B, top_k] fp32, ids [B, top_k] int32 row ids)."""
    qsum = queries.sum(-1) * offset  # [B] rank-1 dequant correction
    qbf = queries.to(torch.bfloat16).to(torch.float32)
    col = torch.arange(chunk, device=codes.device, dtype=torch.int32)
    k = min(top_k, chunk)
    vals, ids = [], []
    for i0 in range(0, codes.shape[0], chunk):
        c = codes[i0:i0 + chunk].to(torch.float32)
        s = (qbf @ c.T) / scale + qsum[:, None]  # [B, chunk]
        s = s.masked_fill(i0 + col >= n_valid, NEG_INF)
        v, pos = torch.topk(s, k, dim=-1)
        vals.append(v)
        ids.append(pos.to(torch.int32) + i0)
    all_vals, all_ids = torch.cat(vals, 1), torch.cat(ids, 1)
    v, pos = torch.topk(all_vals, top_k, dim=-1)
    return v, torch.gather(all_ids, 1, pos)


class FlatIndex:
    """Exact MIPS over int8 codes held on one device."""

    def __init__(self, codes, offset: float = DEFAULT_OFFSET,
                 scale: float = DEFAULT_SCALE, chunk: int = 4096,
                 device="cuda"):
        """codes: [N, D] int8 numpy array (a memmap streams slice by slice,
        never copied whole on the host)."""
        if codes.dtype != np.int8:
            raise ValueError(f"codes must be int8, got {codes.dtype}")
        self.device = resolve_device(device)
        self.quant = "int8"
        self.n_total, self.dim = codes.shape
        self.offset = float(offset)
        self.scale = float(scale)
        self.chunk = min(chunk, max(512, _round_up(self.n_total or 1, 8)))
        self.shard_rows = _round_up(max(self.n_total, 1), self.chunk)
        self.codes = torch.zeros((self.shard_rows, self.dim), dtype=torch.int8,
                                 device=self.device)
        slice_rows = 1 << 20
        for i0 in range(0, self.n_total, slice_rows):
            # a writable copy of one slice: stores load read-only
            rows = np.array(codes[i0:i0 + slice_rows])
            self.codes[i0:i0 + rows.shape[0]].copy_(torch.from_numpy(rows))

    def search(self, queries, top_k: int = 10, nprobe: int = 0,
               as_numpy: bool = True):
        """queries: [B, D] → (scores [B, K] fp32, ids [B, K] int32).
        nprobe is accepted and ignored, as in the reference, so ``MIPS``
        passes it to either index type. as_numpy=False keeps the results
        on the device."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        k = min(top_k, self.n_total)
        vals, ids = _scan_topk(queries, self.codes, self.n_total, self.offset,
                               self.scale, top_k=k, chunk=self.chunk)
        if k < top_k:  # pad to the requested k for fixed downstream shapes
            pad = top_k - k
            vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                                  NEG_INF)], -1)
            ids = torch.cat([ids, ids.new_zeros((ids.shape[0], pad))], -1)
        if as_numpy:
            return vals.cpu().numpy(), ids.cpu().numpy()
        return vals, ids
