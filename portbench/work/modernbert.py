"""Operations and bytes of ModernBERT towers and of kernel A's banded
instance: the yardstick of ``attn_band_roofline`` and of the ModernBERT
cell's ``step_mfu``. Counted from the published widths, band-aware: a local
layer's attention scores only the keys within the window.
"""

from __future__ import annotations


def band_keys(l: int, w: int) -> int:
    """Keys scored over all L queries of a head: sum over i of
    |{j : |i - j| <= w, 0 <= j < L}| (L² when the band covers the row)."""
    if w >= l - 1:
        return l * l
    return l * (2 * w + 1) - w * (w + 1)


def attention_band(b: int, h: int, l: int, d: int, w: int, esize: int = 2):
    """Kernel A's banded instance on [b, h, l, d] with half-width w: (ops,
    bytes). 4·b·h·d operations a scored pair (QKᵀ and PV); q, k, v and the
    output once each, and the fp32 [b, l] mask."""
    return 4 * b * h * d * band_keys(l, w), 4 * b * h * l * d * esize + 4 * b * l


def layer_kinds(model: dict):
    """(global layers, local layers) of the configuration."""
    n, every = model["num_hidden_layers"], model["global_attn_every_n_layers"]
    glob = sum(1 for i in range(n) if i % every == 0)
    return glob, n - glob


def tower_flops(model: dict, b: int, l: int) -> int:
    """Multiply-adds ×2 of one tower's forward over [b, l] tokens: per layer
    the fused q, k, v and the output projection (4·h²) and GeGLU's Wi (h ×
    2f) and Wo (f × h), 3·h·f; attention's two products, 2·h a scored pair,
    over L² pairs in a global layer and the band's pairs in a local one."""
    h, f = model["hidden_size"], model["intermediate_size"]
    glob, local = layer_kinds(model)
    dense = model["num_hidden_layers"] * b * l * 2 * (4 * h * h + 3 * h * f)
    w = model["local_attention"] // 2
    attn = 4 * b * h * (glob * l * l + local * band_keys(l, w))
    return dense + attn
