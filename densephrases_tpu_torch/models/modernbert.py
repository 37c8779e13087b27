"""ModernBERT tower as a torch ``nn.Module``, for serving.

ModernBERT (Warner et al., 2024, arXiv:2412.13663; the published config of
``answerdotai/ModernBERT-large``) as a DensePhrases query tower beside the
BERT one (``models/bert.py``). The JAX package has no such encoder, so this
module is held against the benchmark's plain float32 reference
(``portbench/reference/modernbert.py``) and not against JAX. Per forward:

- ``x = LN_emb(tok_emb[ids])``: no position or token-type embeddings
  (``token_type_ids`` are taken and ignored);
- each layer, pre-norm: ``x += Wo · attn(RoPE(q), RoPE(k), v)`` over
  ``attn_norm(x)`` (the identity in layer 0), q, k, v the three thirds of
  one fused ``Wqkv``; then ``x += Wo_mlp · (gelu_erf(a) ⊙ g)`` with
  ``[a; g] = Wi · mlp_norm(x)`` (GeGLU);
- layer i is global when ``i % global_attn_every_n_layers == 0``: full
  attention (kernel A) with RoPE at ``global_rope_theta``; else local:
  each query sees the keys within ``local_attention // 2`` positions (A's
  banded instance) with RoPE at ``local_rope_theta``;
- ``final_norm`` after the last layer. The query vector is the [CLS] row.

No biases anywhere and layer norms without bias, as published
(``attention_bias``, ``mlp_bias`` and ``norm_bias`` false). Weights are kept
in the published layout (Linear weights [out, in], products by
``F.linear``), so the checkpoint map (``models/hf_import.py``) only renames.

Compute in ``compute_dtype`` (bf16) with the norms, RoPE, GELU and softmax
in fp32, as the BERT towers do; the residual stream is kept in the compute
dtype. RoPE is the rotate-half form over the head's dims; its cos / sin
tables are built once per (theta, L, head dim, device), in float64 and
stored in fp32 (``towers.rope`` spans the build).

The towers serve only: a forward with dropout or remat raises (the band has
no backward, and the dump and training of ModernBERT towers are not here).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from densephrases_tpu_torch.models.attention import attention
from densephrases_tpu_torch.models.bert import _param
from densephrases_tpu_torch.utils import profiling


@dataclass(frozen=True)
class ModernBertConfig:
    """The published keys of ``answerdotai/ModernBERT-large``'s config.json
    that shape the tower, with its values as defaults."""

    vocab_size: int = 50368
    hidden_size: int = 1024
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    intermediate_size: int = 2624
    max_position_embeddings: int = 8192
    global_attn_every_n_layers: int = 3
    local_attention: int = 128
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    hidden_activation: str = "gelu"
    attention_bias: bool = False
    mlp_bias: bool = False
    norm_bias: bool = False
    initializer_range: float = 0.02

    def __post_init__(self):
        if self.attention_bias or self.mlp_bias or self.norm_bias:
            raise ValueError("the port's ModernBERT has no biases (the "
                             "published attention_bias, mlp_bias and "
                             "norm_bias are false)")
        if self.hidden_activation != "gelu":
            raise ValueError(f"hidden_activation {self.hidden_activation!r}: "
                             "only the published erf 'gelu' is implemented")
        if self.local_attention % 2:
            raise ValueError("local_attention must be even (a window of "
                             "local_attention / 2 each side)")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def window(self) -> int:
        """The local layers' half-width: |i - j| <= window."""
        return self.local_attention // 2

    def is_global(self, layer: int) -> bool:
        return layer % self.global_attn_every_n_layers == 0

    def rope_theta(self, layer: int) -> float:
        return (self.global_rope_theta if self.is_global(layer)
                else self.local_rope_theta)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "ModernBertConfig":
        """A tiny config for tests: two periods of the layer pattern."""
        return ModernBertConfig(
            vocab_size=vocab_size, hidden_size=64, num_hidden_layers=6,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=256, local_attention=16)


_ROPE: dict = {}  # (theta, L, head dim, device) → (cos, sin) fp32 [L, D]


def rope_tables(theta: float, l: int, head_dim: int, device):
    """cos and sin [L, head_dim] fp32 of the rotate-half RoPE: position p,
    frequency theta^(-2i / head_dim) for i < head_dim / 2, repeated over
    both halves. Built once per (theta, L, head_dim, device)."""
    device = torch.device(device)
    key = (float(theta), int(l), int(head_dim), device)
    got = _ROPE.get(key)
    if got is None:
        with profiling.span("towers.rope", theta=float(theta), length=int(l)):
            inv = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float64)
                            / head_dim)
            ang = torch.arange(l, dtype=torch.float64)[:, None] * inv[None]
            ang = torch.cat([ang, ang], -1)
            got = (ang.cos().to(device, torch.float32),
                   ang.sin().to(device, torch.float32))
        _ROPE[key] = got
    return got


def apply_rope(x, cos, sin):
    """x [B, L, H, D] → RoPE'd in fp32, returned in x's dtype as
    [B, H, L, D] contiguous (the attention kernels' layout)."""
    xf = x.to(torch.float32)
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], -1)
    out = xf * cos[:, None] + rot * sin[:, None]
    return out.to(x.dtype).transpose(1, 2).contiguous()


def _norm(x, weight, eps):
    """LayerNorm without bias, in fp32, returned in x's dtype."""
    return F.layer_norm(x.to(torch.float32), x.shape[-1:],
                        weight.to(torch.float32), None, eps).to(x.dtype)


class ModernBertLayer(nn.Module):
    """One layer. Parameters: ``attn_norm`` (absent in layer 0, whose
    attention norm is the identity), ``wqkv`` [3H, H], ``wo`` [H, H],
    ``mlp_norm`` [H], ``wi`` [2F, H], ``mlp_wo`` [H, F]."""

    def __init__(self, config: ModernBertConfig, index: int):
        super().__init__()
        h, f = config.hidden_size, config.intermediate_size
        self.index = index
        self.attn_norm = _param(h) if index > 0 else None
        self.wqkv = _param(3 * h, h)
        self.wo = _param(h, h)
        self.mlp_norm = _param(h)
        self.wi = _param(2 * f, h)
        self.mlp_wo = _param(h, f)

    def forward(self, x, mask, config: ModernBertConfig, attn_impl: str,
                compute_dtype: torch.dtype):
        b, l, h = x.shape
        nh, hd = config.num_attention_heads, config.head_dim
        eps = config.norm_eps
        y = x if self.attn_norm is None else _norm(x, self.attn_norm, eps)
        qkv = F.linear(y, self.wqkv.to(compute_dtype)).view(b, l, 3, nh, hd)
        cos, sin = rope_tables(config.rope_theta(self.index), l, hd, x.device)
        q = apply_rope(qkv[:, :, 0], cos, sin)
        k = apply_rope(qkv[:, :, 1], cos, sin)
        v = qkv[:, :, 2].transpose(1, 2).contiguous()
        window = None if config.is_global(self.index) else config.window
        ctx = attention(q, k, v, mask, impl=attn_impl, window=window)
        ctx = ctx.transpose(1, 2).reshape(b, l, h)
        x = x + F.linear(ctx, self.wo.to(compute_dtype))
        a, g = F.linear(_norm(x, self.mlp_norm, eps),
                        self.wi.to(compute_dtype)).chunk(2, -1)
        act = F.gelu(a.to(torch.float32)).mul_(g).to(compute_dtype)
        return x + F.linear(act, self.mlp_wo.to(compute_dtype))


class ModernBertModel(nn.Module):
    """Token embeddings + their norm + ``num_hidden_layers`` layers + the
    final norm. Parameters: ``tok_emb`` [V, H], ``emb_norm`` [H],
    ``layers``, ``final_norm`` [H]."""

    def __init__(self, config: ModernBertConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.tok_emb = _param(config.vocab_size, h)
        self.emb_norm = _param(h)
        self.layers = nn.ModuleList(
            ModernBertLayer(config, i) for i in range(config.num_hidden_layers))
        self.final_norm = _param(h)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """N(0, initializer_range) matrices and embeddings, unit norm
        scales, drawn on the CPU from ``generator``."""
        ir = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1].endswith("norm"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * ir)
        return self

    def forward(self, input_ids, attention_mask,
                token_type_ids: Optional[torch.Tensor] = None, *,
                attn_impl: str = "auto",
                compute_dtype: torch.dtype = torch.bfloat16,
                dropout=None, remat: str = "none"):
        """input_ids, attention_mask (1 = real token): [B, L] on the
        module's device; ``token_type_ids`` is ignored. Returns the final
        norm's output [B, L, H] in fp32. ``dropout`` and ``remat`` are
        accepted for the BERT tower's call and must be off."""
        cfg = self.config
        if dropout is not None or remat != "none":
            raise ValueError("ModernBERT towers serve only: no dropout or "
                             "remat (the banded attention has no backward)")
        b, l = input_ids.shape
        if l > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {l} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        x = self.tok_emb[input_ids.long()].to(compute_dtype)
        x = _norm(x, self.emb_norm, cfg.norm_eps)
        mask = attention_mask.to(torch.float32)
        for layer in self.layers:
            x = layer(x, mask, cfg, attn_impl, compute_dtype)
        return F.layer_norm(x.to(torch.float32), x.shape[-1:],
                            self.final_norm.to(torch.float32), None,
                            cfg.norm_eps)
