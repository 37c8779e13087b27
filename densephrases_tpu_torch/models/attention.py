"""Attention for the BERT towers.

Two implementations of bidirectional multi-head attention with a padding
mask, the counterparts of ``densephrases_tpu/models/attention.py``:

- ``attention_plain``: plain torch (einsum, fp32 softmax), rounded at the
  same points as the reference's ``attention_xla``. CPU tensors use it, and
  the tests and ``chip_smoke.py`` hold the kernel against it.
- ``attention_cuda``: the hand-written CUDA kernel ``csrc/attention_fwd.cu``
  (the port of the Pallas ``_fused_attn_kernel``). It runs at every sequence
  length: the reference's ``PALLAS_MIN_SEQ`` was a TPU crossover.

The backward has the same pair: ``attention_bwd_plain`` runs the Pallas
``_fused_attn_bwd_kernel``'s formula in plain torch, and
``attention_cuda_bwd`` launches ``csrc/attention_bwd.cu``. ``AttentionCuda``
is the ``torch.autograd.Function`` that joins the two kernels, as the
reference's custom VJP joins its two Pallas kernels.

``attention(..., impl="auto")`` picks by the tensor's device: the kernels
(through ``AttentionCuda``) for CUDA tensors, the plain version under torch
autograd for CPU tensors. There is no fallback: a CUDA tensor goes through
the kernels or the call raises.
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
ATTENTION_BWD = CudaKernel(
    "attention_bwd.cu", "dph_attention_bwd",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def attention_plain(q, k, v, mask):
    """q, k, v: [B, H, L, D]; mask: [B, L] (1 = keep) → [B, H, L, D]."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / (d ** 0.5)
    bias = (1.0 - mask[:, None, None, :].to(torch.float32)) * NEG_INF
    scores = scores.to(torch.float32) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def attention_bwd_plain(q, k, v, mask, g):
    """The Pallas ``_fused_attn_bwd_kernel``'s formula in plain torch:
    upcast to fp32, recompute P from (q, k, v, mask), then
    dv = Pᵀg, dS = P∘(gvᵀ − rowsum(gvᵀ∘P))/√d, dq = dS k, dk = dSᵀ q, each
    cast to q's dtype. q, k, v, g: [B, H, L, D]; mask: [B, L]."""
    dtype = q.dtype
    q, k, v, g = (t.to(torch.float32) for t in (q, k, v, g))
    inv_sqrt_d = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * inv_sqrt_d
    scores = scores + ((1.0 - mask.to(torch.float32)) * NEG_INF)[:, None, None, :]
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * inv_sqrt_d
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _check_cuda_inputs(name, mask, *xs):
    """Raise unless xs are [B, H, L, D] contiguous CUDA tensors of one dtype
    (float32 or bfloat16, D in ``HEAD_DIMS``) and mask is [B, L], all on one
    device."""
    if not all(x.is_cuda for x in (*xs, mask)):
        raise ValueError(f"{name} needs CUDA tensors")
    shape = xs[0].shape
    if xs[0].dim() != 4 or any(x.shape != shape for x in xs):
        raise ValueError(f"{name}: inputs must share one [B, H, L, D] shape: "
                         f"{[tuple(x.shape) for x in xs]}")
    b, h, l, d = shape
    if mask.shape != (b, l):
        raise ValueError(f"mask must be [{b}, {l}], got {tuple(mask.shape)}")
    if xs[0].dtype not in (torch.float32, torch.bfloat16) \
            or any(x.dtype != xs[0].dtype for x in xs):
        raise ValueError(f"{name}: inputs must all be float32 or bfloat16: "
                         f"{[x.dtype for x in xs]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(x.device != mask.device for x in xs):
        raise ValueError(f"{name}: inputs and mask must be on one device")


def attention_cuda(q, k, v, mask):
    """The CUDA kernel. q, k, v: [B, H, L, D] contiguous CUDA tensors of one
    dtype (float32 or bfloat16), D in ``HEAD_DIMS``; mask: [B, L].
    Launches on the current stream and does not synchronise."""
    _check_cuda_inputs("attention_cuda", mask, q, k, v)
    b, h, l, d = q.shape
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


def attention_cuda_bwd(q, k, v, mask, g):
    """The CUDA backward kernel: (dq, dk, dv) in q's dtype. Takes what
    ``attention_cuda`` takes, plus the output gradient g of q's shape and
    dtype. Launches on the current stream and does not synchronise."""
    _check_cuda_inputs("attention_cuda_bwd", mask, q, k, v, g)
    b, h, l, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    maskf = mask.to(torch.float32).contiguous()
    # per query row: the row max, 1 / the row sum and g . o (pass 1 → pass 2)
    stats = torch.empty(b * h * l * 3, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ATTENTION_BWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             maskf.data_ptr(), g.data_ptr(), dq.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                             b, h, l, d, int(q.dtype == torch.bfloat16), stream)
    return dq, dk, dv


def attention_function(forward, backward):
    """A ``torch.autograd.Function`` from a forward ``(q, k, v, mask) → out``
    and a backward ``(q, k, v, mask, g) → (dq, dk, dv)``. It saves only
    (q, k, v, mask): the backward recomputes P, as the reference's custom
    VJP does (attention.py:158-173). ``AttentionCuda`` is the kernels' pair;
    the tests build one from the plain pair."""

    class _Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask):
            ctx.save_for_backward(q, k, v, mask)
            return forward(q, k, v, mask)

        @staticmethod
        def backward(ctx, g):
            q, k, v, mask = ctx.saved_tensors
            dq, dk, dv = backward(q, k, v, mask, g.contiguous())
            return dq, dk, dv, None

    return _Attention


AttentionCuda = attention_function(attention_cuda, attention_cuda_bwd)


def attention(q, k, v, mask, impl: str = "auto"):
    """Dispatch: 'auto' (the kernels for CUDA tensors, the plain version for
    CPU tensors) | 'cuda' | 'plain'. Both are differentiable: 'cuda' through
    ``AttentionCuda``, 'plain' through torch autograd."""
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "plain"
    if impl == "cuda":
        return AttentionCuda.apply(q, k, v, mask)
    if impl == "plain":
        return attention_plain(q, k, v, mask)
    raise ValueError(f"unknown attention impl {impl!r}")
