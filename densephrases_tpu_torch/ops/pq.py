"""Product quantization: codebook training, encode/decode and query LUTs.

The counterpart of ``densephrases_tpu/ops/pq.py`` (FAISS's PQ, M subspaces
of ``ksub`` centroids each, one code per subspace). The ADC scan that reads
the LUTs is kernel D (``ops/ivf_pack.py``, ``csrc/pq_pack_score.cu``): on
Hopper a LUT lookup is a shared-memory gather, so the reference's one-hot
helpers (``codes_to_onehot``, ``pq_scores_scan``) are not ported.

The reference's products take bf16 inputs on the TPU and f32 elsewhere
(``_mm_dtype``); the port takes f32, which is what its CPU tests hold it to.
``pq_lut`` rounds both operands to bf16 everywhere, as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from densephrases_tpu_torch.ops.kmeans import _batched_lloyd_stream, _bf16

_ROW_CHUNK = 4096  # rows per device step in the stream loops


@dataclass
class PQCodebook:
    """codebooks: [M, ksub, dsub] float32. Pickles under the reference's
    class path (``index/ivf.py`` save and load)."""

    codebooks: np.ndarray

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def _dequant(x, offset: float, scale: float):
    """int8 codes → f32 rows (the same ops for f32 rows with (0, 1))."""
    return x.to(torch.float32) / scale + offset


def _pq_assign_stream(y, books, *, row_chunk: int = _ROW_CHUNK):
    """y [N, D] device rows → PQ codes [N, M] uint8: per row chunk one
    batched product and an argmin over (||c||² − 2y·c)."""
    n, _ = y.shape
    m, _, s = books.shape
    c_sq = (books ** 2).sum(-1)  # [M, K]
    out = []
    for i0 in range(0, n, row_chunk):
        q = y[i0:i0 + row_chunk].reshape(-1, m, s)
        dots = torch.einsum("cms,mks->cmk", q, books)
        out.append(torch.argmin(c_sq[None] - 2.0 * dots, dim=-1)
                   .to(torch.uint8))
    return torch.cat(out) if out else torch.zeros((0, m), dtype=torch.uint8,
                                                  device=y.device)


def _encode_chunk(xb, books, offset, scale, *, rotation=None, cents=None,
                  ids=None, row_chunk: int = _ROW_CHUNK):
    """One streamed encode block: dequant, minus each row's coarse centroid
    (residual), rotate, PQ-assign."""
    y = _dequant(xb, offset, scale)
    if cents is not None:
        y = y - cents[ids.long()]
    if rotation is not None:
        y = y @ rotation
    return _pq_assign_stream(y, books, row_chunk=row_chunk)


def _train_pq_device(y, m: int, ksub: int, iters: int, rng,
                     row_chunk: int = _ROW_CHUNK):
    """PQ codebook fit on device rows y [N, D] f32. Returns device books
    [M, ksub, dsub]."""
    n, d = y.shape
    dsub = d // m
    X = y.reshape(n, m, dsub).permute(1, 0, 2).contiguous()  # [M, N, dsub]
    idx = torch.from_numpy(rng.choice(n, size=min(ksub, n), replace=False)) \
        .to(y.device)
    C0 = X[:, idx]
    if C0.shape[1] < ksub:  # tiny corpora: repeat rows
        reps = -(-ksub // C0.shape[1])
        C0 = C0.repeat(1, reps, 1)[:, :ksub]
    return _batched_lloyd_stream(X, C0, iters=iters, row_chunk=row_chunk)


def _resample_pad(x, sub_ids, n: int, rc: int, rng):
    """Pad the sample to a multiple of the row chunk with resampled rows
    (double weight, harmless for a quantizer), drawing from ``rng`` as the
    reference does."""
    pad = (-n) % rc
    if pad:
        pad_sel = rng.integers(0, n, pad)
        x = np.concatenate([x, x[pad_sel]])
        if sub_ids is not None:
            sub_ids = np.concatenate([sub_ids, sub_ids[pad_sel]])
    return x, sub_ids


def _training_rows(x, offset, scale, sub_cents, sub_ids, device):
    """Upload the (int8 or f32) sample once, dequantize on the device and
    subtract each row's coarse centroid when training on residuals."""
    y = _dequant(torch.from_numpy(np.ascontiguousarray(x)).to(device),
                 offset, scale)
    if sub_ids is not None:
        cents = torch.as_tensor(np.asarray(sub_cents, np.float32),
                                device=device)
        y = y - cents[torch.from_numpy(sub_ids.astype(np.int64)).to(device)]
    return y


def train_pq(x: np.ndarray, m: int, nbits: int = 8, iters: int = 10,
             seed: int = 0, offset: float = 0.0, scale: float = 1.0,
             row_chunk: int = _ROW_CHUNK, sub_cents: np.ndarray = None,
             sub_ids: np.ndarray = None, *, device) -> PQCodebook:
    """Train M per-subspace codebooks of 2**nbits centroids on host rows x
    (f32, or raw int8 with the (offset, scale) contract). sub_cents /
    sub_ids: train on residuals x − c[assign] (IVF by_residual)."""
    n, d = x.shape
    assert d % m == 0, f"dim {d} not divisible by M={m}"
    assert nbits in (4, 8), f"nbits must be 4 or 8, got {nbits}"
    rng = np.random.default_rng(seed)
    rc = min(row_chunk, max(256, n))
    x, sub_ids = _resample_pad(x, sub_ids, n, rc, rng)
    y = _training_rows(x, offset, scale, sub_cents, sub_ids, device)
    books = _train_pq_device(y, m, 1 << nbits, iters, rng, row_chunk=rc)
    return PQCodebook(books.cpu().numpy())


def pq_encode(pq: PQCodebook, x: np.ndarray, offset: float = 0.0,
              scale: float = 1.0, rotation: np.ndarray = None,
              block: int = 1 << 19, row_chunk: int = _ROW_CHUNK,
              cents: np.ndarray = None, assign: np.ndarray = None,
              *, device) -> np.ndarray:
    """Encode host rows → uint8 codes [N, M], streamed through the device
    in ``block``-row chunks. rotation [D, D]: applied after dequant (OPQ).
    cents/assign: encode residuals x − c[assign], before the rotation."""
    n = x.shape[0]
    books = torch.from_numpy(np.asarray(pq.codebooks, np.float32)).to(device)
    rot = (None if rotation is None else
           torch.from_numpy(np.asarray(rotation, np.float32)).to(device))
    cents_dev = (None if assign is None else
                 torch.from_numpy(np.asarray(cents, np.float32)).to(device))
    out = np.empty((n, pq.m), np.uint8)
    rc = min(row_chunk, max(256, n))
    for b0 in range(0, n, block):
        xb = torch.from_numpy(np.array(x[b0:b0 + block])) \
            .to(device)
        ids = (None if assign is None else
               torch.from_numpy(np.asarray(assign[b0:b0 + len(xb)]))
               .to(device))
        out[b0:b0 + len(xb)] = _encode_chunk(
            xb, books, offset, scale, rotation=rot, cents=cents_dev, ids=ids,
            row_chunk=rc).cpu().numpy()
    return out


def pack_nibbles(codes: np.ndarray) -> np.ndarray:
    """4-bit codes [N, M] (values < 16, M even) → packed bytes [N, M//2].
    Byte i = subspace 2i (low nibble) | subspace 2i+1 << 4 (high nibble)."""
    n, m = codes.shape
    assert m % 2 == 0, f"M={m} must be even to pack nibbles"
    assert codes.dtype == np.uint8
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """Packed bytes [N, B] → 4-bit codes [N, 2B] (pack_nibbles inverse)."""
    lo = packed & 0x0F
    hi = packed >> 4
    return np.stack([lo, hi], axis=-1).reshape(packed.shape[0], -1)


def unpack_nibbles_dev(packed: torch.Tensor, m: int) -> torch.Tensor:
    """``unpack_nibbles`` on a device tensor: [..., >= M/2] uint8 → [..., M]
    int32 in subspace order (low nibble first); bytes past M/2 are
    ignored."""
    v = packed[..., :m // 2].to(torch.int32)
    return torch.stack([v & 0x0F, v >> 4], dim=-1).reshape(
        v.shape[:-1] + (m,))


def pq_decode(pq: PQCodebook, codes: np.ndarray) -> np.ndarray:
    """Decode codes → approximate vectors [N, D] (host, offline use)."""
    n, m = codes.shape
    out = np.zeros((n, pq.dim), np.float32)
    dsub = pq.dsub
    for mi in range(m):
        out[:, mi * dsub:(mi + 1) * dsub] = pq.codebooks[mi][codes[:, mi]]
    return out


def pq_lut(codebooks, queries):
    """Per-query inner-product tables LUT[b, m, k] = q[b, sub m] · C[m, k]
    from bf16-rounded operands, accumulated in fp32.
    codebooks [M, K, dsub], queries [B, D] → [B, M, K] f32."""
    b = queries.shape[0]
    m, _, dsub = codebooks.shape
    q = _bf16(queries.to(torch.float32)).reshape(b, m, dsub)
    return torch.einsum("bms,mks->bmk", q, _bf16(codebooks.to(torch.float32)))
