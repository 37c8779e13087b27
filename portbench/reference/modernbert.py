"""A ModernBERT query tower in plain float32 PyTorch, from the published HF
key names (``model.`` level, Linear weights [out, in], no biases) under a
DensePhrases tower prefix. It imports nothing of the port.

Per query, following the published equations (Warner et al., 2024,
arXiv:2412.13663; ``answerdotai/ModernBERT-large``'s config.json):

    x = LN_emb(tok_emb[ids])
    each layer i:  y = x if i == 0 else LN_attn(x)
                   q, k, v = thirds of y Wqkvᵀ;  q, k rotated by RoPE at
                   theta = global_rope_theta if i % global_attn_every_n_layers
                   == 0 else local_rope_theta (rotate-half, over the head)
                   s = q kᵀ / sqrt(d); in a local layer s_ij = -inf where
                   |i - j| > local_attention / 2;  x += softmax(s) v Woᵀ
                   [a; g] = LN_mlp(x) Wiᵀ;  x += (gelu_erf(a) ⊙ g) Wo_mlpᵀ
    LN_final(x)[0], the [CLS] row

LayerNorms have no bias, eps ``norm_eps``. The band is a mask on the full
score matrix. Each batch row is taken alone, cut to its real tokens (the
padding adds nothing to a real query's attention, whose padded keys the
port weighs by exp(-1e9) = 0), and each head alone, so that a query of
8,192 tokens fits: one [L, L] float32 score matrix at a time. The RoPE
tables are computed in float64 and used in float32.

``rnd`` rounds every value the tower stores (the control computes the
towers in fp8 with it), as ``reference/bert.py``'s does.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.bert import PRECISIONS, identity  # noqa: F401


def _ln(x, w, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w


def _rope(theta: float, n: int, d: int, device):
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None]
    ang = torch.cat([ang, ang], -1)
    return (ang.cos().to(device, torch.float32),
            ang.sin().to(device, torch.float32))


def _rotate(x, cos, sin):
    """x [n, heads, d]: x cos + rotate_half(x) sin."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos[:, None] + rot * sin[:, None]


def query(sd: dict, prefix: str, model: dict, ids, rnd=identity):
    """One query's real token ids [n] → its [H] float32 [CLS] state."""
    g = lambda k: rnd(sd[prefix + k].to(torch.float32))  # noqa: E731
    eps = model["norm_eps"]
    h, nh = model["hidden_size"], model["num_attention_heads"]
    hd = h // nh
    n = ids.shape[0]
    w = model["local_attention"] // 2

    def lin(x, key):
        return rnd(rnd(x) @ g(key).T)

    def ln(x, key):
        return rnd(_ln(x, g(key), eps))

    x = rnd(g("model.embeddings.tok_embeddings.weight")[ids.long()])
    x = ln(x, "model.embeddings.norm.weight")
    pos = torch.arange(n, device=ids.device)
    off_band = (pos[:, None] - pos[None, :]).abs() > w
    for i in range(model["num_hidden_layers"]):
        p = f"model.layers.{i}."
        is_global = i % model["global_attn_every_n_layers"] == 0
        theta = model["global_rope_theta" if is_global else "local_rope_theta"]
        y = x if i == 0 else ln(x, p + "attn_norm.weight")
        q, k, v = lin(y, p + "attn.Wqkv.weight").view(n, 3, nh, hd).unbind(1)
        cos, sin = _rope(theta, n, hd, x.device)
        q, k = rnd(_rotate(q, cos, sin)), rnd(_rotate(k, cos, sin))
        ctx = torch.empty(n, nh, hd, device=x.device)
        for head in range(nh):
            s = rnd(q[:, head] @ k[:, head].T / math.sqrt(hd))
            if not is_global:
                s = s.masked_fill(off_band, float("-inf"))
            ctx[:, head] = rnd(rnd(torch.softmax(s, -1)) @ v[:, head])
            del s
        x = rnd(x + lin(ctx.reshape(n, h), p + "attn.Wo.weight"))
        a, gate = lin(ln(x, p + "mlp_norm.weight"),
                      p + "mlp.Wi.weight").chunk(2, -1)
        act = rnd(rnd(torch.nn.functional.gelu(a)) * gate)
        x = rnd(x + lin(act, p + "mlp.Wo.weight"))
    return ln(x[:1], "model.final_norm.weight")[0]


def encode(sd: dict, model: dict, ids, mask, rnd=identity):
    """Both query towers over [B, L] ids and mask (1 = real; real tokens
    first), one query at a time → (q_start [B, H], q_end [B, H])."""
    outs = ([], [])
    lengths = mask.to(torch.int64).sum(-1).tolist()
    for r, n in enumerate(lengths):
        for out, prefix in zip(outs, ("query_start_encoder.",
                                      "query_end_encoder.")):
            out.append(query(sd, prefix, model, ids[r, :n], rnd))
    return torch.stack(outs[0]), torch.stack(outs[1])
