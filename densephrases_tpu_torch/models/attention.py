"""Attention for the BERT towers.

Two implementations of bidirectional multi-head attention with a padding
mask, the counterparts of ``densephrases_tpu/models/attention.py``:

- ``attention_plain``: plain torch (einsum, fp32 softmax), rounded at the
  same points as the reference's ``attention_xla``. CPU tensors use it, and
  the tests and ``chip_smoke.py`` hold the kernel against it.
- ``attention_cuda``: the hand-written CUDA kernel ``csrc/attention_fwd.cu``
  (the port of the Pallas ``_fused_attn_kernel``). It runs at every sequence
  length: the reference's ``PALLAS_MIN_SEQ`` was a TPU crossover.

``attention(..., impl="auto")`` picks by the tensor's device: the kernel for
CUDA tensors, the plain version for CPU tensors. There is no fallback: a
CUDA tensor goes through the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from densephrases_tpu_torch.utils.cuda_build import CudaKernel

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instances

ATTENTION_FWD = CudaKernel(
    "attention_fwd.cu", "dph_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def attention_plain(q, k, v, mask):
    """q, k, v: [B, H, L, D]; mask: [B, L] (1 = keep) → [B, H, L, D]."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / (d ** 0.5)
    bias = (1.0 - mask[:, None, None, :].to(torch.float32)) * NEG_INF
    scores = scores.to(torch.float32) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def attention_cuda(q, k, v, mask):
    """The CUDA kernel. q, k, v: [B, H, L, D] contiguous CUDA tensors of one
    dtype (float32 or bfloat16), D in ``HEAD_DIMS``; mask: [B, L].
    Launches on the current stream and does not synchronise."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda and mask.is_cuda):
        raise ValueError("attention_cuda needs CUDA tensors")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, L, D] shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, h, l, d = q.shape
    if mask.shape != (b, l):
        raise ValueError(f"mask must be [{b}, {l}], got {tuple(mask.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16: "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if not (k.device == q.device == v.device == mask.device):
        raise ValueError("q, k, v and mask must be on one device")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    maskf = mask.to(torch.float32).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ATTENTION_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             maskf.data_ptr(), out.data_ptr(), b, h, l, d,
                             int(q.dtype == torch.bfloat16), stream)
    return out


def attention(q, k, v, mask, impl: str = "auto"):
    """Dispatch: 'auto' (the kernel for CUDA tensors, the plain version for
    CPU tensors) | 'cuda' | 'plain'."""
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "plain"
    if impl == "cuda":
        return attention_cuda(q, k, v, mask)
    if impl == "plain":
        return attention_plain(q, k, v, mask)
    raise ValueError(f"unknown attention impl {impl!r}")
