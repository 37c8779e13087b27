"""Lloyd k-means: the coarse-quantizer trainer.

The counterpart of the flat-Lloyd half of ``densephrases_tpu/ops/kmeans.py``:

- assignment: argmin ||x - c||² = argmin (||c||² - 2 x·c), one
  [chunk, k] product per data chunk;
- update: centroid sums as ``onehot(assign)ᵀ @ x``, another product;
- empty clusters are re-seeded from random data rows on the host.

Rounding follows the reference at the same points, on every device: x and
the centroids go to bf16 for the distance products, which accumulate in
fp32, while ``‖c‖²`` stays fp32; the Lloyd sums are ``onehot(assign)ᵀ @
bf16(x)`` in fp32. int8 inputs are assigned against transformed centroids
``c' = (c - offset)·scale`` (L2 assignment is affine-equivariant) and the
sums are moved back to the dequantized space on the host.

The corpus lives on the host and streams through ``device`` in blocks.
A block's last chunk is ragged instead of zero-padded, so no pad rows are
counted and no count fix-up is needed. The two-level and hierarchical
k-means of the reference are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_BLOCK = 262_144  # host rows uploaded at a time


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to fp32 (the reference's bf16 matmul inputs;
    the product of two bf16 values is exact in fp32)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _assign_and_accumulate(x, centroids, *, chunk: int):
    """One Lloyd iteration body over device rows x [n, D] (fp32, or int8
    against transformed centroids). Returns (sums [k, D], counts [k], cost)
    in the space of x."""
    k = centroids.shape[0]
    c = centroids.to(torch.float32)
    c_sq = (c ** 2).sum(1)
    cbf = _bf16(c)
    sums = torch.zeros_like(c)
    counts = torch.zeros(k, dtype=torch.float32, device=c.device)
    cost = torch.zeros((), dtype=torch.float32, device=c.device)
    for i0 in range(0, x.shape[0], chunk):
        xb = _bf16(x[i0:i0 + chunk].to(torch.float32))
        dist = c_sq[None, :] - 2.0 * (xb @ cbf.T)
        assign = torch.argmin(dist, dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
        sums += onehot.T @ xb
        counts += onehot.sum(0)
        cost += dist.gather(1, assign[:, None]).sum()
    return sums, counts, cost


def kmeans_assign(x, centroids, *, chunk: int = 4096) -> torch.Tensor:
    """Assign device rows x [n, D] to their nearest centroid (L2).
    Returns int32 [n] on x's device."""
    c = centroids.to(torch.float32)
    c_sq = (c ** 2).sum(1)
    cbf = _bf16(c)
    out = []
    for i0 in range(0, x.shape[0], chunk):
        xb = _bf16(x[i0:i0 + chunk].to(torch.float32))
        out.append(torch.argmin(c_sq[None, :] - 2.0 * (xb @ cbf.T), dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    return torch.cat(out).to(torch.int32)


def _effective(centroids: np.ndarray, quant: bool, offset: float,
               scale: float) -> np.ndarray:
    """Centroids in the space of the raw rows: c' = (c - offset)·scale for
    int8 codes, c itself for float rows."""
    if quant:
        return ((centroids - offset) * scale).astype(np.float32)
    return np.asarray(centroids, np.float32)


def accumulate_blocks(x: np.ndarray, centroids: np.ndarray,
                      chunk: int = 4096, block: int = _BLOCK,
                      offset: float = 0.0, scale: float = 1.0,
                      *, device):
    """Streamed Lloyd accumulation over host rows (f32, or int8 with the
    (offset, scale) dequant contract). Returns (sums [k, D], counts [k],
    cost) as numpy, in the DEQUANTIZED space."""
    k, d = centroids.shape[0], x.shape[1]
    quant = x.dtype == np.int8
    c_dev = torch.from_numpy(_effective(centroids, quant, offset, scale)) \
        .to(device)
    sums = np.zeros((k, d), np.float32)
    counts = np.zeros((k,), np.float32)
    cost = 0.0
    for b0 in range(0, x.shape[0], block):
        xb = torch.from_numpy(np.array(x[b0:b0 + block])) \
            .to(device)
        s, c, co = _assign_and_accumulate(xb, c_dev, chunk=chunk)
        sums += s.cpu().numpy()
        counts += c.cpu().numpy()
        cost += float(co)
    if quant:
        sums = sums / scale + offset * counts[:, None]
    return sums, counts, cost


def assign_blocks(x: np.ndarray, centroids: np.ndarray,
                  chunk: int = 4096, block: int = _BLOCK,
                  offset: float = 0.0, scale: float = 1.0,
                  *, device) -> np.ndarray:
    """Streamed nearest-centroid assignment of host rows (f32, or int8
    shipped raw). Returns int32 [N] (numpy)."""
    quant = x.dtype == np.int8
    c_dev = torch.from_numpy(_effective(centroids, quant, offset, scale)) \
        .to(device)
    out = np.empty(x.shape[0], np.int32)
    for b0 in range(0, x.shape[0], block):
        xb = torch.from_numpy(np.array(x[b0:b0 + block])) \
            .to(device)
        out[b0:b0 + len(xb)] = kmeans_assign(xb, c_dev, chunk=chunk) \
            .cpu().numpy()
    return out


def kmeans(x: np.ndarray, k: int, iters: int = 10, seed: int = 0,
           chunk: int = 4096, verbose: bool = False, rounded: bool = False,
           offset: float = 0.0, scale: float = 1.0, *,
           device) -> Tuple[np.ndarray, np.ndarray]:
    """Train k centroids on host rows x (f32, or raw int8 codes with the
    (offset, scale) contract). Returns (centroids [k, D] f32 in the
    dequantized space, assignments [N] int32). The init and the empty-
    cluster reseeds draw from ``default_rng(seed)`` in the reference's
    order, so both packages start from the same rows.

    rounded: the reference's power-of-two resampling, which spares its
    compiler a program per data length; not ported, and True raises."""
    if rounded:
        raise NotImplementedError(
            "kmeans(rounded=True), the power-of-two resampling, is not ported")
    n = x.shape[0]
    assert n >= k, f"need at least k={k} points, got {n}"
    quant = x.dtype == np.int8

    def deq(rows):
        return (rows.astype(np.float32) / scale + offset if quant
                else np.asarray(rows, np.float32))

    rng = np.random.default_rng(seed)
    centroids = deq(x[rng.choice(n, size=k, replace=False)])
    for it in range(iters):
        sums, counts, cost = accumulate_blocks(
            x, centroids, chunk=chunk, offset=offset, scale=scale,
            device=device)
        nonempty = counts > 0
        centroids[nonempty] = sums[nonempty] / counts[nonempty, None]
        n_empty = int((~nonempty).sum())
        if n_empty:
            centroids[~nonempty] = deq(
                x[rng.choice(n, size=n_empty, replace=False)])
        if verbose:
            logger.info("kmeans iter %d: cost=%.1f empty=%d", it, cost,
                        n_empty)
    assigns = assign_blocks(x, centroids, chunk=chunk, offset=offset,
                            scale=scale, device=device)
    return centroids, assigns


def _batched_lloyd_stream(X, C0, *, iters: int, row_chunk: int):
    """G independent Lloyd runs over device rows, streamed over row chunks
    so the [G, n, K] distance tensor never exists for the whole n.
    X [G, N, D] f32, C0 [G, K, D] f32 → [G, K, D]. Empty clusters keep
    their previous centroid (the PQ codebook trainer's rule)."""
    g, n, _ = X.shape
    k = C0.shape[1]
    C = C0.to(torch.float32)
    for _ in range(iters):
        c_sq = (C ** 2).sum(-1)  # [G, K]
        c_bf = _bf16(C)
        sums = torch.zeros_like(C)
        counts = torch.zeros((g, k), dtype=torch.float32, device=C.device)
        for i0 in range(0, n, row_chunk):
            xb = _bf16(X[:, i0:i0 + row_chunk])
            dots = torch.einsum("gnd,gkd->gnk", xb, c_bf)
            a = torch.argmin(c_sq[:, None, :] - 2.0 * dots, dim=-1)
            oh = torch.nn.functional.one_hot(a, k).to(torch.float32)
            sums += torch.einsum("gnk,gnd->gkd", oh, xb)
            counts += oh.sum(1)
        new_c = sums / counts.clamp(min=1.0)[..., None]
        C = torch.where(counts[..., None] > 0, new_c, C)
    return C
