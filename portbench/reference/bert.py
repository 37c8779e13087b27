"""A BERT query tower in plain float32 PyTorch, from the DensePhrases
state dict (HF ``BertModel`` keys, Linear weights [out, in]).

embeddings (word + position + token type 0) → layer norm → per layer:
self-attention with a -1e9 bias on padded keys, the output projection, a
residual layer norm, the erf GELU feed-forward and a residual layer norm.
The query vector is the last hidden state of [CLS].

``rnd`` rounds every value the tower stores (the control computes the
towers in fp8 with it); the default leaves them in float32.
"""

from __future__ import annotations

import math

import torch

NEG = -1e9


def identity(t):
    return t


def fp8(t):
    """float8 e4m3 with one scale a tensor (its absolute maximum maps to
    448, the format's largest value), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


PRECISIONS = {"fp32": identity, "fp8": fp8}


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def tower(sd: dict, prefix: str, model: dict, ids, mask, rnd=identity):
    """[B, L] token ids and mask (1 = real) → [B, H] float32 [CLS] states.
    ``rnd`` rounds every value the computation stores: the weights, each
    product's operands and result, each sum, layer norm, softmax and GELU
    output."""
    g = lambda k: rnd(sd[prefix + k].to(torch.float32))  # noqa: E731
    eps = model["layer_norm_eps"]
    nh = model["num_attention_heads"]
    b, l = ids.shape
    h = model["hidden_size"]
    hd = h // nh

    def lin(x, key):
        return rnd(rnd(x) @ g(key + ".weight").T + g(key + ".bias"))

    def ln(x, key):
        return rnd(_ln(x, g(key + ".weight"), g(key + ".bias"), eps))

    x = rnd(g("embeddings.word_embeddings.weight")[ids.long()]
            + g("embeddings.position_embeddings.weight")[:l][None]
            + g("embeddings.token_type_embeddings.weight")[0])
    x = ln(x, "embeddings.LayerNorm")
    bias = (1.0 - mask.to(torch.float32))[:, None, None, :] * NEG
    for i in range(model["num_hidden_layers"]):
        p = f"encoder.layer.{i}."

        def heads(t):
            return t.view(b, l, nh, hd).transpose(1, 2)

        q = heads(lin(x, p + "attention.self.query"))
        k = heads(lin(x, p + "attention.self.key"))
        v = heads(lin(x, p + "attention.self.value"))
        s = rnd(q @ k.transpose(-1, -2) / math.sqrt(hd)) + bias
        ctx = rnd(rnd(torch.softmax(s, -1)) @ v)
        ctx = ctx.transpose(1, 2).reshape(b, l, h)
        x = ln(rnd(x + lin(ctx, p + "attention.output.dense")),
               p + "attention.output.LayerNorm")
        f = rnd(torch.nn.functional.gelu(lin(x, p + "intermediate.dense")))
        x = ln(rnd(x + lin(f, p + "output.dense")), p + "output.LayerNorm")
    return x[:, 0]


def encode(sd: dict, model: dict, ids, mask, rnd=identity, rows: int = 32):
    """Both query towers over [B, L] ids, ``rows`` queries at a time →
    (q_start [B, H], q_end [B, H])."""
    outs = ([], [])
    for r0 in range(0, ids.shape[0], rows):
        for out, prefix in zip(outs, ("query_start_encoder.",
                                      "query_end_encoder.")):
            out.append(tower(sd, prefix, model, ids[r0:r0 + rows],
                             mask[r0:r0 + rows], rnd))
    return torch.cat(outs[0]), torch.cat(outs[1])
