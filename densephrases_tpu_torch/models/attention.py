"""Attention for the BERT towers.

Two implementations of bidirectional multi-head attention with a padding
mask, the counterparts of ``densephrases_tpu/models/attention.py``:

- ``attention_plain``: plain torch (einsum, fp32 softmax), rounded at the
  same points as the reference's ``attention_xla``. CPU tensors use it, and
  the tests and ``chip_smoke.py`` hold the kernel against it.
- ``attention_cuda``: the hand-written CUDA kernel ``csrc/attention_fwd.cu``
  (the port of the Pallas ``_fused_attn_kernel``). It runs at every sequence
  length: the reference's ``PALLAS_MIN_SEQ`` was a TPU crossover. Asked
  for it, it also returns the row logsumexp for the backward;
  ``attention_lse_plain`` is that output's plain twin.

The backward has the same pair: ``attention_bwd_plain`` runs the Pallas
``_fused_attn_bwd_kernel``'s formula in plain torch from (q, k, v, mask, g),
and ``attention_cuda_bwd`` launches ``csrc/attention_bwd.cu``, which also
takes the forward's output and logsumexp and so never recomputes the
softmax statistics. ``AttentionCuda`` is the ``torch.autograd.Function``
that joins the two kernels, as the reference's custom VJP joins its two
Pallas kernels; it saves (q, k, v, mask, out, lse).

``attention(..., impl="auto")`` picks by the tensor's device: the kernels
for CUDA tensors (through ``AttentionCuda`` when a gradient is needed, the
forward kernel alone otherwise), the plain version under torch autograd for
CPU tensors. There is no fallback: a CUDA tensor goes through the kernels
or the call raises.

Each function takes ``window``: None is full attention, as above; an int w
restricts each query i to the keys j with |i - j| <= w (ModernBERT's local
layers: w = local_attention / 2). On the card a window launches A's banded
instance, ``csrc/attention_band.cu``, which streams only the key tiles that
meet a block's band; ``attention_plain`` with a window is its twin. The band
serves only: it has no logsumexp output and no backward, and a call that
would need either raises.

While tracing is on (``utils/profiling.py``), ``attention`` counts its
launches and the query-key pairs it scores, by kind: ``towers.attn_*_global``
and ``towers.attn_*_band``, from the shapes on the host.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from densephrases_tpu_torch.utils import profiling
from densephrases_tpu_torch.utils.cuda_build import CudaKernel

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instances

# (q, k, v, mask, out, lse or NULL), (batch, heads, seq, head_dim, is_bf16),
# stream
ATTENTION_FWD = CudaKernel(
    "attention_fwd.cu", "dph_attention_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# (q, k, v, mask, g, out, lse, dq, dk, dv, delta scratch), (batch, heads,
# seq, head_dim, is_bf16), stream
ATTENTION_BWD = CudaKernel(
    "attention_bwd.cu", "dph_attention_bwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# (q, k, v, mask, out), (batch, heads, seq, head_dim, window), stream
ATTENTION_BAND = CudaKernel(
    "attention_band.cu", "dph_attention_band",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
BAND_BLOCK = 64  # query rows a block of the banded plain twin scores
# the most scores the full plain twin holds at once (1 GiB in fp32): a
# longer call (ModernBERT's 8,192 tokens on the CPU) scores its query rows
# in blocks; every shorter call is one block
PLAIN_SCORES_MAX = 1 << 28


def attention_plain(q, k, v, mask, window=None):
    """q, k, v: [B, H, L, D]; mask: [B, L] (1 = keep) → [B, H, L, D].
    With ``window`` w, each query i attends to the keys |i - j| <= w only:
    blocks of ``BAND_BLOCK`` query rows score the keys their band meets,
    with -inf off the band, at the rounding points of the full version."""
    if window is not None:
        return _band_plain(q, k, v, mask, window)
    b, h, lq = q.shape[:3]
    rows = max(PLAIN_SCORES_MAX // max(b * h * k.shape[2], 1), 1)
    if lq > rows:
        return torch.cat([attention_plain(q[:, :, i:i + rows], k, v, mask)
                          for i in range(0, lq, rows)], 2)
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / (d ** 0.5)
    bias = (1.0 - mask[:, None, None, :].to(torch.float32)) * NEG_INF
    scores = scores.to(torch.float32) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _band_plain(q, k, v, mask, window: int):
    d, l = q.shape[-1], q.shape[2]
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    bias = (1.0 - mask[:, None, None, :].to(torch.float32)) * NEG_INF
    pos = torch.arange(l, device=q.device)
    out = torch.empty_like(q)
    for i0 in range(0, l, BAND_BLOCK):
        i1 = min(i0 + BAND_BLOCK, l)
        j0, j1 = max(i0 - window, 0), min(i1 + window, l)
        scores = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i0:i1],
                              k[:, :, j0:j1]) / (d ** 0.5)
        scores = scores.to(torch.float32) + bias[..., j0:j1]
        off = (pos[i0:i1, None] - pos[None, j0:j1]).abs() > window
        scores = scores.masked_fill(off, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out[:, :, i0:i1] = torch.einsum("bhqk,bhkd->bhqd", probs,
                                        v[:, :, j0:j1])
    return out


def band_pairs(l: int, window: Optional[int]) -> int:
    """Query-key pairs a [.., L, ..] head scores: L² for full attention,
    sum over i of |{j : |i - j| <= w}| with a window w."""
    if window is None or window >= l - 1:
        return l * l
    w = window
    # each row has 2w + 1 keys, less those past either end
    return l * (2 * w + 1) - w * (w + 1)


def attention_lse_plain(q, k, mask):
    """The forward kernel's logsumexp output in plain torch: fp32 [B, H, L],
    the logsumexp over keys of the fp32 masked scores, less the row's mask
    offset. The offset is -1e9 for a batch row whose every key is masked
    and 0 otherwise: fp32 cannot hold -1e9 + log L (its ulp there is 64), so
    the kernels store the logsumexp of the shifted scores, whose softmax is
    the same (csrc/attention_tiles.cuh: mask_offset)."""
    inv_sqrt_d = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * inv_sqrt_d
    scores = scores + ((1.0 - mask.to(torch.float32)) * NEG_INF)[:, None, None, :]
    return torch.logsumexp(scores - mask_offset(mask)[:, None, None, None], -1)


def mask_offset(mask):
    """[B] fp32: -1e9 where every key of the batch row is masked, else 0."""
    return torch.where((mask != 0).any(-1), 0.0, NEG_INF).to(torch.float32)


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


def attention_cuda(q, k, v, mask, return_lse: bool = False, window=None):
    """The CUDA kernel. q, k, v: [B, H, L, D] contiguous CUDA tensors of one
    dtype (float32 or bfloat16), D in ``HEAD_DIMS``; mask: [B, L]. Returns
    out, or (out, lse) with ``return_lse`` (lse as ``attention_lse_plain``
    gives it; otherwise the kernel writes none). With ``window`` (bf16
    only, no lse) it launches the banded instance. Launches on the current
    stream and does not synchronise."""
    _check_cuda_inputs("attention_cuda", mask, q, k, v)
    if window is not None:
        if return_lse:
            raise ValueError("the banded attention has no logsumexp output "
                             "(it serves only; there is no band backward)")
        return _attention_band_cuda(q, k, v, mask, window)
    b, h, l, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, l), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel():
        maskf = mask.to(torch.float32).contiguous()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            ATTENTION_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 maskf.data_ptr(), out.data_ptr(),
                                 lse.data_ptr() if return_lse else None,
                                 b, h, l, d, int(q.dtype == torch.bfloat16),
                                 stream)
    return (out, lse) if return_lse else out


def _attention_band_cuda(q, k, v, mask, window: int):
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the banded attention takes bfloat16, got {q.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    b, h, l, d = q.shape
    out = torch.empty_like(q)
    if q.numel():
        maskf = mask.to(torch.float32).contiguous()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            ATTENTION_BAND.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  maskf.data_ptr(), out.data_ptr(), b, h, l,
                                  d, min(int(window), l), stream)
    return out


def attention_cuda_bwd(q, k, v, mask, g, out, lse):
    """The CUDA backward kernel: (dq, dk, dv) in q's dtype. Takes what
    ``attention_cuda`` takes, the output gradient g and the forward's out
    (both of q's shape and dtype) and its fp32 [B, H, L] lse. Launches on
    the current stream and does not synchronise."""
    _check_cuda_inputs("attention_cuda_bwd", mask, q, k, v, g, out)
    b, h, l, d = q.shape
    if lse.shape != (b, h, l) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous fp32 [{b}, {h}, {l}] "
                         f"tensor on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    maskf = mask.to(torch.float32).contiguous()
    # delta = g . out per query row: written by pass 1, read by pass 2
    delta = torch.empty(b * h * l, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ATTENTION_BWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             maskf.data_ptr(), g.data_ptr(), out.data_ptr(),
                             lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                             dv.data_ptr(), delta.data_ptr(),
                             b, h, l, d, int(q.dtype == torch.bfloat16), stream)
    return dq, dk, dv


def attention_function(forward, backward):
    """A ``torch.autograd.Function`` from a forward ``(q, k, v, mask) →
    (out, lse)`` and a backward ``(q, k, v, mask, g, out, lse) → (dq, dk,
    dv)``. It saves (q, k, v, mask, out, lse), so the backward rebuilds P
    from the logsumexp without a second softmax sweep; the reference's
    custom VJP saves only (q, k, v, mask) and recomputes P
    (attention.py:158-173). Under remat the recomputed forward saves the
    same. ``AttentionCuda`` is the kernels' pair; the tests build one from
    the plain twins."""

    class _Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask):
            out, lse = forward(q, k, v, mask)
            ctx.save_for_backward(q, k, v, mask, out, lse)
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, mask, out, lse = ctx.saved_tensors
            dq, dk, dv = backward(q, k, v, mask, g.contiguous(), out, lse)
            return dq, dk, dv, None

    return _Attention


AttentionCuda = attention_function(
    lambda q, k, v, mask: attention_cuda(q, k, v, mask, return_lse=True),
    attention_cuda_bwd)


def attention(q, k, v, mask, impl: str = "auto", window=None):
    """Dispatch: 'auto' (the kernels for CUDA tensors, the plain version for
    CPU tensors) | 'cuda' | 'plain'. Both are differentiable: 'cuda' through
    ``AttentionCuda``, 'plain' through torch autograd. Where no gradient is
    asked for (grad mode off, or no input needs one), 'cuda' launches the
    forward kernel alone, which then writes no logsumexp. ``window``: None
    for full attention, else the band's half-width; the band serves only,
    so a call with a window that needs a gradient raises."""
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "plain"
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if window is not None and grad:
        raise ValueError("the banded attention serves only: it has no "
                         "backward")
    if profiling.active():
        kind = "global" if window is None else "band"
        b, h, l = q.shape[:3]
        profiling.count(f"towers.attn_launches_{kind}", 1)
        profiling.count(f"towers.attn_pairs_{kind}",
                        b * h * band_pairs(l, window))
    if impl == "cuda":
        if grad:
            return AttentionCuda.apply(q, k, v, mask)
        return attention_cuda(q, k, v, mask, window=window)
    return attention_plain(q, k, v, mask, window=window)
