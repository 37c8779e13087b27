"""The ModernBERT query towers' weights a run makes from ``--seed``: the
published HF key names (``ModernBertForMaskedLM``'s ``model.`` level, Linear
weights [out, in], no biases) under the DensePhrases tower prefixes, drawn
on the device in the type they are served in, one normal draw a tower, as
``inputs.make_weights`` draws the BERT towers'. Both the port and the
reference get these same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.inputs import TOWERS, generator

# (published key, shape as names, kind): "w" draws N(0, std), "ln_w"
# 1 + N(0, ln_std), the stds from the configuration's "weights"
EMBED_LEAVES = (
    ("model.embeddings.tok_embeddings.weight", ("v", "h"), "w"),
    ("model.embeddings.norm.weight", ("h",), "ln_w"),
)
LAYER_LEAVES = (
    ("attn_norm.weight", ("h",), "ln_w"),
    ("attn.Wqkv.weight", ("3h", "h"), "w"),
    ("attn.Wo.weight", ("h", "h"), "w"),
    ("mlp_norm.weight", ("h",), "ln_w"),
    ("mlp.Wi.weight", ("2f", "h"), "w"),
    ("mlp.Wo.weight", ("h", "f"), "w"),
)
FINAL_LEAVES = (("model.final_norm.weight", ("h",), "ln_w"),)


def tower_leaves(model: dict, prefix: str):
    """[(key, shape, kind)] of one ModernBERT tower; layer 0 has no
    ``attn_norm`` (its attention norm is the identity)."""
    h, f = model["hidden_size"], model["intermediate_size"]
    dims = {"h": h, "3h": 3 * h, "f": f, "2f": 2 * f, "v": model["vocab_size"]}
    out = [(prefix + k, tuple(dims[d] for d in s), kind)
           for k, s, kind in EMBED_LEAVES]
    for i in range(model["num_hidden_layers"]):
        out += [(f"{prefix}model.layers.{i}.{k}", tuple(dims[d] for d in s),
                 kind)
                for k, s, kind in LAYER_LEAVES
                if not (i == 0 and k == "attn_norm.weight")]
    out += [(prefix + k, tuple(dims[d] for d in s), kind)
            for k, s, kind in FINAL_LEAVES]
    return out


def make_weights(model: dict, weights: dict, seed: int, device,
                 dtype=torch.bfloat16) -> dict:
    """The two query towers' state dict, drawn on ``device`` (``weights``:
    {"std", "ln_std"}). Returns {key: tensor}, views of one buffer a
    tower."""
    sd = {}
    for t, prefix in enumerate(TOWERS):
        leaves = sorted(tower_leaves(model, prefix),
                        key=lambda x: ("w", "ln_w").index(x[2]))
        sizes = [int(np.prod(s)) for _, s, _ in leaves]
        buf = torch.randn(sum(sizes), dtype=dtype, device=device,
                          generator=generator(seed, "weights", device, t))
        n_w = sum(n for (_, _, kind), n in zip(leaves, sizes) if kind == "w")
        buf[:n_w].mul_(weights["std"])
        buf[n_w:].mul_(weights["ln_std"]).add_(1.0)
        at = 0
        for (key, shape, _), n in zip(leaves, sizes):
            sd[key] = buf[at:at + n].view(shape)
            at += n
    return sd
