"""Vector quantization contract for the phrase store, as torch and numpy ops.

The counterpart of ``densephrases_tpu/ops/quant.py``, with the same
constants: ``code = round(clip((x - offset) * scale, -128, 127))`` and
``x ≈ code / scale + offset`` for int8; int4 packs two 4-bit codes per byte,
the high nibble holding the first half of the feature dim. Each function
takes a numpy array or a torch tensor and returns the same kind. Rounding is
half to even in both (``np.round``, ``torch.round``), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

# Fixed storage contract (ref: options.py:144-145 --dense_offset/--dense_scale).
DEFAULT_OFFSET = -2.0
DEFAULT_SCALE = 20.0

# int4 contract (ref: embed_utils.py:152-165).
INT4_OFFSET = -3.5
INT4_SCALE = 2.3


def float_to_int8(x, offset: float = DEFAULT_OFFSET,
                  scale: float = DEFAULT_SCALE):
    """Quantize float vectors to int8 codes."""
    if isinstance(x, torch.Tensor):
        return torch.round(((x - offset) * scale).clamp(-128, 127)).to(torch.int8)
    out = np.clip((x - offset) * scale, -128, 127)
    return np.round(out).astype(np.int8)


def int8_to_float(code, offset: float = DEFAULT_OFFSET,
                  scale: float = DEFAULT_SCALE):
    """Dequantize int8 codes to float32."""
    if isinstance(code, torch.Tensor):
        return code.to(torch.float32) / scale + offset
    return code.astype(np.float32) / scale + offset


def float_to_int4(x, offset: float = INT4_OFFSET, scale: float = INT4_SCALE):
    """Quantize to packed int4: two 4-bit codes per uint8 byte. code[i]
    (high nibble) pairs with code[i + D/2] (low nibble); D must be even."""
    hd = x.shape[-1] // 2
    if isinstance(x, torch.Tensor):
        out = torch.round(((x - offset) * scale).clamp(0, 15)).to(torch.uint8)
        return out[..., :hd] * 16 + out[..., hd:]
    out = np.round(np.clip((x - offset) * scale, 0, 15)).astype(np.uint8)
    return (out[..., :hd] * 16 + out[..., hd:]).astype(np.uint8)


def int4_to_float(code, offset=INT4_OFFSET, scale=INT4_SCALE):
    """Unpack and dequantize packed int4 codes. offset/scale may be scalars
    or per-dim [D] vectors."""
    if isinstance(code, torch.Tensor):
        unmerged = torch.cat((code // 16, code % 16), dim=-1)
        return unmerged.to(torch.float32) / scale + offset
    unmerged = np.concatenate((code // 16, code % 16), axis=-1)
    return unmerged.astype(np.float32) / scale + offset


def train_int4_ranges(sample_f32: np.ndarray, q_lo: float = 0.005,
                      q_hi: float = 0.995):
    """Per-dimension trained int4 affine (FAISS QT_4bit trains vmin/vdiff per
    dim the same way). Host numpy, as in the reference.

    Returns (offset [D], scale [D]) f32 such that
    ``code = clip(round((x - offset) * scale), 0, 15)`` covers the
    [q_lo, q_hi] quantile range of each dimension."""
    lo = np.quantile(sample_f32, q_lo, axis=0).astype(np.float32)
    hi = np.quantile(sample_f32, q_hi, axis=0).astype(np.float32)
    span = np.maximum(hi - lo, 1e-6)
    return lo, (15.0 / span).astype(np.float32)
