"""BERT tower as a torch ``nn.Module``, for inference and training.

The counterpart of ``densephrases_tpu/models/bert.py``, rounded at the same
points so that bf16 parity holds:

- weights are stored ``[in, out]`` as in the reference (``x @ w``, the
  reference's ``einsum("bld,dh->blh")``), not in ``nn.Linear``'s layout, so
  the weight bridge (``models/from_jax.py``) copies them unchanged;
- each weight and bias is cast to the compute dtype at its use, the product
  and the bias add each round to the compute dtype;
- layer norm runs in fp32 and returns the input's dtype;
- GELU is erf in fp32 (``hidden_act="gelu"``) or tanh in the compute dtype
  (``"gelu_tanh"``);
- attention goes through ``models/attention.py`` (the CUDA kernel for CUDA
  tensors).

The reference's stacked layer axis becomes an ``nn.ModuleList``. For
training, ``BertModel.forward`` takes a dropout generator and a remat mode:

- dropout is the reference's ``_dropout`` (bert.py:112-131): inverted
  dropout from uint8 threshold masks, after the embedding layer norm and
  after the attention-out and FFN-out projections. There is no dropout on
  the attention probabilities, as in the reference;
- remat "full" recomputes each layer in the backward
  (``torch.utils.checkpoint``), "none" keeps its activations.
  ``torch.utils.checkpoint`` restores the global RNG state only, not an
  explicit generator, so each layer's dropout seed is drawn from the step's
  generator before the layer runs (as the reference splits ``layer_rngs``
  before its scan, bert.py:189) and the layer builds its bits from that
  seed: a recomputed layer draws the same masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from densephrases_tpu_torch.models.attention import attention


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    pad_token_id: int = 0
    hidden_act: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(vocab_size: int = 512) -> "BertConfig":
        """A tiny config for tests and draft runs."""
        return BertConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            max_position_embeddings=128,
        )


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


def _layer_norm(x, scale, bias, eps):
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def dropout_threshold(rate: float) -> int:
    """The reference's uint8 threshold: round(rate * 256) clamped to
    [1, 255], so tiny rates still drop ~1/256 and rates near 1 keep some."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in (0, 1): {rate}")
    return min(max(int(round(rate * 256)), 1), 255)


def dropout_from_bits(x, rate: float, bits):
    """Inverted dropout from uint8 bits of x's shape (bert.py:112-131): keep
    where bits >= thr, scaled by 1 / keep_p in x's dtype, keep_p =
    (256 - thr) / 256, computed as the reference does."""
    thr = dropout_threshold(rate)
    scale = torch.tensor(1.0 / ((256 - thr) / 256.0), dtype=x.dtype,
                         device=x.device)
    return torch.where(bits >= thr, x * scale, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def draw_seed(generator: torch.Generator) -> int:
    """A 63-bit seed from a (CPU) generator."""
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))


def dropout_bits(shape, seed: int, device) -> torch.Tensor:
    """Uniform uint8 bits of ``shape`` on ``device``, from a generator on that
    device seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                         device=device, generator=gen)


# Weight matrices drawn from N(0, initializer_range); the rest are biases
# (zeros) and layer-norm scales (ones).
_LAYER_MATRICES = ("q_w", "k_w", "v_w", "attn_out_w", "ffn_in_w", "ffn_out_w")


class BertLayer(nn.Module):
    """One transformer layer; parameter names follow the reference's keys."""

    def __init__(self, config: BertConfig):
        super().__init__()
        h, f = config.hidden_size, config.intermediate_size
        for name in ("q", "k", "v", "attn_out"):
            setattr(self, f"{name}_w", _param(h, h))
            setattr(self, f"{name}_b", _param(h))
        self.attn_ln_scale, self.attn_ln_bias = _param(h), _param(h)
        self.ffn_in_w, self.ffn_in_b = _param(h, f), _param(f)
        self.ffn_out_w, self.ffn_out_b = _param(f, h), _param(h)
        self.ffn_ln_scale, self.ffn_ln_bias = _param(h), _param(h)

    def forward(self, x, mask, config: BertConfig, attn_impl: str,
                compute_dtype: torch.dtype, dropout_seed=None):
        """dropout_seed: None for no dropout; else the seed of this layer's
        two masks (attention-out, then FFN-out), or the two masks' uint8
        bits themselves as a [2, B, L, H] tensor."""
        b, l, _ = x.shape
        rate = config.hidden_dropout_prob
        if torch.is_tensor(dropout_seed):
            bits = dropout_seed
        elif dropout_seed is not None:
            bits = dropout_bits((2, b, l, config.hidden_size), dropout_seed,
                                x.device)
        nh, hd = config.num_attention_heads, config.head_dim
        eps = config.layer_norm_eps

        def dense(inp, w, bias):
            return inp @ w.to(compute_dtype) + bias.to(compute_dtype)

        def heads(t):
            return t.view(b, l, nh, hd).transpose(1, 2).contiguous()

        q = heads(dense(x, self.q_w, self.q_b))
        k = heads(dense(x, self.k_w, self.k_b))
        v = heads(dense(x, self.v_w, self.v_b))
        ctx = attention(q, k, v, mask, impl=attn_impl)
        ctx = ctx.transpose(1, 2).reshape(b, l, nh * hd)
        attn_out = dense(ctx, self.attn_out_w, self.attn_out_b)
        if dropout_seed is not None:
            attn_out = dropout_from_bits(attn_out, rate, bits[0])
        attn_out = _layer_norm(x + attn_out, self.attn_ln_scale,
                               self.attn_ln_bias, eps)

        ffn = dense(attn_out, self.ffn_in_w, self.ffn_in_b)
        if config.hidden_act == "gelu_tanh":
            ffn = F.gelu(ffn, approximate="tanh")
        else:
            ffn = F.gelu(ffn.to(torch.float32)).to(compute_dtype)
        ffn = dense(ffn, self.ffn_out_w, self.ffn_out_b)
        if dropout_seed is not None:
            ffn = dropout_from_bits(ffn, rate, bits[1])
        return _layer_norm(attn_out + ffn, self.ffn_ln_scale,
                           self.ffn_ln_bias, eps)


class BertModel(nn.Module):
    """Embeddings + layer norm + ``num_hidden_layers`` layers."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        # the reference's embed/{word,pos,type} (``type`` would shadow
        # nn.Module.type, hence the suffix)
        self.word_emb = _param(config.vocab_size, h)
        self.pos_emb = _param(config.max_position_embeddings, h)
        self.type_emb = _param(config.type_vocab_size, h)
        self.ln_scale, self.ln_bias = _param(h), _param(h)
        self.layers = nn.ModuleList(
            BertLayer(config) for _ in range(config.num_hidden_layers))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """N(0, initializer_range) matrices, zero biases, unit LN scales,
        drawn on the CPU from ``generator`` so the draw does not depend on
        the device."""
        ir = self.config.initializer_range

        def normal(p):
            p.copy_(torch.randn(p.shape, generator=generator) * ir)

        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("ln_scale"):
                p.fill_(1.0)
            elif leaf in _LAYER_MATRICES or leaf.endswith("_emb"):
                normal(p)
            else:
                p.zero_()
        return self

    def forward(self, input_ids, attention_mask,
                token_type_ids: Optional[torch.Tensor] = None, *,
                attn_impl: str = "auto",
                compute_dtype: torch.dtype = torch.bfloat16,
                dropout=None, remat: str = "none"):
        """input_ids, attention_mask (1 = real token), token_type_ids:
        [B, L] on the module's device. Returns the sequence output
        [B, L, H] in fp32.

        dropout: None (or ``hidden_dropout_prob`` 0) for the deterministic
        forward; else a CPU generator that this call draws its seeds from,
        one for the embedding dropout and then one per layer; or the masks'
        uint8 bits themselves, a pair (embedding bits [B, L, H], layer bits
        [num_hidden_layers, 2, B, L, H]), as the reference draws them from
        its key splits (the tests feed those).
        remat: "full" recomputes each layer in the backward, "none" does
        not; "dots" (keep the products, recompute the rest) is not ported."""
        cfg = self.config
        if remat not in ("full", "none"):
            if remat == "dots":
                raise NotImplementedError("remat='dots' is not ported")
            raise ValueError(f"unknown remat mode {remat!r}")
        b, l = input_ids.shape
        if l > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {l} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(l, device=input_ids.device)
        x = (self.word_emb[input_ids] + self.pos_emb[positions][None]
             + self.type_emb[token_type_ids.long()])
        x = _layer_norm(x, self.ln_scale, self.ln_bias, cfg.layer_norm_eps)
        seeds = [None] * len(self.layers)
        if dropout is not None and cfg.hidden_dropout_prob > 0:
            if isinstance(dropout, torch.Generator):
                emb_bits = dropout_bits(x.shape, draw_seed(dropout), x.device)
                seeds = [draw_seed(dropout) for _ in self.layers]
            else:
                emb_bits, layer_bits = dropout
                seeds = list(layer_bits.unbind(0))
            x = dropout_from_bits(x, cfg.hidden_dropout_prob, emb_bits)
        x = x.to(compute_dtype)
        mask = attention_mask.to(torch.float32)
        recompute = remat == "full" and torch.is_grad_enabled()
        for layer, seed in zip(self.layers, seeds):
            if recompute:
                x = checkpoint(layer, x, mask, cfg, attn_impl, compute_dtype,
                               seed, use_reentrant=False)
            else:
                x = layer(x, mask, cfg, attn_impl, compute_dtype, seed)
        return x.to(torch.float32)
