"""OPQ: a learned rotation that lowers the PQ reconstruction error.

The counterpart of ``densephrases_tpu/ops/opq.py`` (FAISS's ``OPQMatrix``;
applied at serve time as ``q · R``). Alternating optimization:

  1. Y = X R; fit PQ on Y → reconstruction Ŷ
  2. R ← the Procrustes solution: SVD(Xᵀ Ŷ) = U Σ Vᵀ → R = U Vᵀ

The sample is uploaded once and every O(N·D) quantity stays on the device;
only the [D, D] cross matrix comes to the host for the SVD. The random
numbers come from ``default_rng`` seeded as in the reference: the QR init
from ``seed``, iteration ``it``'s PQ fit from ``seed + 1000·it`` and the
final fit from ``seed + 999``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from densephrases_tpu_torch.ops.pq import (
    PQCodebook,
    _resample_pad,
    _train_pq_device,
    _training_rows,
)

logger = logging.getLogger(__name__)


@dataclass
class OPQ:
    rotation: np.ndarray  # [D, D] orthogonal
    pq: PQCodebook

    def apply(self, x: np.ndarray) -> np.ndarray:
        return x @ self.rotation


def _opq_cross(xd, y, books, *, row_chunk: int):
    """Streamed Xᵀ Ŷ and the reconstruction error. xd, y [N, D] f32 device
    rows (original, rotated); books [M, K, dsub]. Returns (xty [D, D] f32,
    squared error sum)."""
    n, d = y.shape
    m, _, s = books.shape
    c_sq = (books ** 2).sum(-1)
    xty = torch.zeros((d, d), dtype=torch.float32, device=y.device)
    err = torch.zeros((), dtype=torch.float32, device=y.device)
    msel = torch.arange(m, device=y.device)[None, :]
    for i0 in range(0, n, row_chunk):
        yc, xc = y[i0:i0 + row_chunk], xd[i0:i0 + row_chunk]
        dots = torch.einsum("cms,mks->cmk", yc.reshape(-1, m, s), books)
        a = torch.argmin(c_sq[None] - 2.0 * dots, dim=-1)  # [rc, M]
        yh = books[msel, a].reshape(-1, d)  # the reconstruction, gathered
        xty += xc.T @ yh
        err += ((yc - yh) ** 2).sum()
    return xty, err


def train_opq(x: np.ndarray, m: int, nbits: int = 8, niter: int = 10,
              pq_iters: int = 6, seed: int = 0, verbose: bool = False,
              offset: float = 0.0, scale: float = 1.0, row_chunk: int = 4096,
              sub_cents: np.ndarray = None, sub_ids: np.ndarray = None,
              *, device) -> OPQ:
    """Train the rotation and codebooks on host rows x (f32, or raw int8
    with the (offset, scale) contract). sub_cents / sub_ids: train on
    residuals x − c[assign] (IVF by_residual)."""
    assert nbits in (4, 8), f"nbits must be 4 or 8, got {nbits}"
    ksub = 1 << nbits
    n, d = x.shape
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    r = q.astype(np.float32)
    rc = min(row_chunk, max(256, n))
    x, sub_ids = _resample_pad(x, sub_ids, n, rc, rng)
    xd = _training_rows(x, offset, scale, sub_cents, sub_ids, device)
    n_eff = xd.shape[0]

    for it in range(niter):
        y = xd @ torch.from_numpy(r).to(device)
        books = _train_pq_device(y, m, ksub, pq_iters,
                                 np.random.default_rng(seed + 1000 * it),
                                 row_chunk=rc)
        xty, err = _opq_cross(xd, y, books, row_chunk=rc)
        # Procrustes on the host: R = U Vᵀ of XᵀŶ ([D, D], negligible)
        u, _, vt = np.linalg.svd(xty.cpu().numpy(), full_matrices=False)
        r_new = (u @ vt).astype(np.float32)
        if verbose:
            logger.info("opq iter %d: recon_mse=%.5f dR=%.5f", it,
                        float(err) / (n_eff * d),
                        float(np.abs(r_new - r).max()))
        r = r_new

    # final PQ fit on the converged rotation
    y = xd @ torch.from_numpy(r).to(device)
    books = _train_pq_device(y, m, ksub, pq_iters,
                             np.random.default_rng(seed + 999), row_chunk=rc)
    return OPQ(rotation=r, pq=PQCodebook(books.cpu().numpy()))
