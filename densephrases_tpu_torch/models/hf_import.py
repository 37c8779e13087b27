"""HuggingFace BERT / DensePhrases checkpoint import.

The counterpart of ``densephrases_tpu/models/hf_import.py`` (ref
single_utils.py:36-118): a torch ``state_dict`` of a HF ``BertModel``, or
of the reference's released DensePhrases encoder (three towers + the
filter head), mapped onto the reference's params tree as numpy arrays:
each Linear weight transposed from torch's [out, in] to [in, out], the
per-layer tensors stacked on a leading layer axis. ``cli.common.
load_encoder`` turns that tree into ``EncoderParams`` with
``models/from_jax.encoder_from_jax``.

``state_dict_from_encoder`` goes the other way (the port's modules → a
state dict under the reference's key names), which the tests and
``chip_smoke.py`` use to write ``pytorch_model.bin`` files.

ModernBERT towers, which the JAX package lacks, map straight onto the
port's modules: ``modernbert_encoder_from_state_dict`` takes the published
HF names under each DensePhrases tower prefix, and
``modernbert_state_dict_from_encoder`` writes them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from densephrases_tpu_torch.models.bert import BertConfig

# HF BertModel key → the reference's layer leaf, and whether the tensor is
# a Linear weight ([out, in] in torch)
LAYER_KEYS = {
    "q_w": ("attention.self.query.weight", True),
    "q_b": ("attention.self.query.bias", False),
    "k_w": ("attention.self.key.weight", True),
    "k_b": ("attention.self.key.bias", False),
    "v_w": ("attention.self.value.weight", True),
    "v_b": ("attention.self.value.bias", False),
    "attn_out_w": ("attention.output.dense.weight", True),
    "attn_out_b": ("attention.output.dense.bias", False),
    "attn_ln_scale": ("attention.output.LayerNorm.weight", False),
    "attn_ln_bias": ("attention.output.LayerNorm.bias", False),
    "ffn_in_w": ("intermediate.dense.weight", True),
    "ffn_in_b": ("intermediate.dense.bias", False),
    "ffn_out_w": ("output.dense.weight", True),
    "ffn_out_b": ("output.dense.bias", False),
    "ffn_ln_scale": ("output.LayerNorm.weight", False),
    "ffn_ln_bias": ("output.LayerNorm.bias", False),
}
EMBED_KEYS = {
    "word": "embeddings.word_embeddings.weight",
    "pos": "embeddings.position_embeddings.weight",
    "type": "embeddings.token_type_embeddings.weight",
    "ln_scale": "embeddings.LayerNorm.weight",
    "ln_bias": "embeddings.LayerNorm.bias",
}

# key prefixes of the reference's released encoder checkpoints, the current
# spelling first (ref: single_utils.py:43-47 backward_compat)
TOWER_PREFIXES = {
    "phrase": ("phrase_encoder.", "bert_start."),
    "query_start": ("query_start_encoder.", "bert_q_start."),
    "query_end": ("query_end_encoder.", "bert_q_end."),
}


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t)


def bert_params_from_state_dict(sd: Dict[str, object], config: BertConfig,
                                prefix: str = ""):
    """A HF ``BertModel`` state_dict → the reference's tower tree (fp32
    numpy). ``prefix`` e.g. 'bert.'."""
    g = lambda k: _to_np(sd[prefix + k])
    n = config.num_hidden_layers
    embed = {k: g(key).astype(np.float32) for k, key in EMBED_KEYS.items()}
    layers = {}
    for leaf, (key, transpose) in LAYER_KEYS.items():
        mats = [g(f"encoder.layer.{i}.{key}") for i in range(n)]
        layers[leaf] = np.stack([m.T if transpose else m for m in mats]
                                ).astype(np.float32)
    return {"embed": embed, "layers": layers}


def _tower_prefix(sd, tower: str) -> str:
    """The prefix of ``tower``'s weights in ``sd``: the first spelling in
    ``TOWER_PREFIXES`` that occurs, with a ``bert.`` level when present."""
    prefixes = TOWER_PREFIXES[tower]
    for p in prefixes:
        if any(k.startswith(p) for k in sd):
            return p + "bert." if any(k.startswith(p + "bert.") for k in sd) \
                else p
    raise KeyError(f"no weights for tower {tower} (tried {prefixes})")


def encoder_params_from_state_dict(sd: Dict[str, object], config: BertConfig):
    """A DensePhrases encoder state_dict → the reference's 3-tower tree."""
    params = {tower: bert_params_from_state_dict(sd, config,
                                                 _tower_prefix(sd, tower))
              for tower in TOWER_PREFIXES}
    params["filter"] = {
        "w": _to_np(sd["filter_linear.weight"]).T.astype(np.float32),
        "b": _to_np(sd["filter_linear.bias"]).astype(np.float32),
    }
    return params


def load_encoder_from_torch(path: str, config: BertConfig):
    """A torch .bin / .pt checkpoint file → the reference's params tree.
    Read with ``weights_only=True``: tensors and plain containers only."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return encoder_params_from_state_dict(sd, config)


def state_dict_from_encoder(params, spelling: int = 0,
                            bert_level: bool = False) -> Dict[str, torch.Tensor]:
    """``EncoderParams`` → a DensePhrases encoder state_dict under the
    reference's key names: ``spelling`` picks the prefix of each tower in
    ``TOWER_PREFIXES`` (0 current, 1 old), ``bert_level`` nests each tower
    under ``bert.``. Linear weights are stored [out, in], as torch does."""
    sd: Dict[str, torch.Tensor] = {}
    cpu = lambda t: t.detach().to("cpu", torch.float32).clone()
    for tower, prefixes in TOWER_PREFIXES.items():
        model = getattr(params, tower)
        p = prefixes[spelling] + ("bert." if bert_level else "")
        for leaf, key in EMBED_KEYS.items():
            attr = {"word": "word_emb", "pos": "pos_emb",
                    "type": "type_emb"}.get(leaf, leaf)
            sd[p + key] = cpu(getattr(model, attr))
        for i, layer in enumerate(model.layers):
            for leaf, (key, transpose) in LAYER_KEYS.items():
                t = cpu(getattr(layer, leaf))
                sd[f"{p}encoder.layer.{i}.{key}"] = \
                    t.T.contiguous() if transpose else t
    sd["filter_linear.weight"] = cpu(params.filter.w).T.contiguous()
    sd["filter_linear.bias"] = cpu(params.filter.b)
    return sd


# ------------------------------------------------------------- ModernBERT
# A HF ModernBERT checkpoint (``ModernBertForMaskedLM``'s ``model.`` level)
# under each DensePhrases tower prefix. The port keeps the published layout
# (Linear weights [out, in]), so the map only renames: the port's leaf →
# the published key. Layer 0 has no ``attn_norm`` (its attention norm is
# the identity).
MODERNBERT_EMBED_KEYS = {
    "tok_emb": "model.embeddings.tok_embeddings.weight",
    "emb_norm": "model.embeddings.norm.weight",
    "final_norm": "model.final_norm.weight",
}
MODERNBERT_LAYER_KEYS = {
    "attn_norm": "attn_norm.weight",
    "wqkv": "attn.Wqkv.weight",
    "wo": "attn.Wo.weight",
    "mlp_norm": "mlp_norm.weight",
    "wi": "mlp.Wi.weight",
    "mlp_wo": "mlp.Wo.weight",
}


def modernbert_keys(config) -> Dict[str, str]:
    """The port's parameter name in a ``ModernBertModel`` → its published
    key (without a tower prefix)."""
    keys = dict(MODERNBERT_EMBED_KEYS)
    for i in range(config.num_hidden_layers):
        for leaf, key in MODERNBERT_LAYER_KEYS.items():
            if leaf == "attn_norm" and i == 0:
                continue
            keys[f"layers.{i}.{leaf}"] = f"model.layers.{i}.{key}"
    return keys


def modernbert_encoder_from_state_dict(sd: Dict[str, torch.Tensor], config,
                                       towers=tuple(TOWER_PREFIXES)):
    """``EncoderParams`` of ModernBERT towers holding the state dict's own
    tensors (no copy), keyed by the published names under each tower's
    current DensePhrases prefix (``query_start_encoder.model.layers.0.``
    ...). The towers not in ``towers``, and the filter head where
    ``filter_linear.*`` is absent, are zeros of the state dict's type and
    device. The parameters need no gradient."""
    from densephrases_tpu_torch.models.encoder import EncoderParams

    with torch.device("meta"):
        params = EncoderParams(config)
    first = next(iter(sd.values()))

    def put(module, name, t):
        module._parameters[name] = torch.nn.Parameter(t, requires_grad=False)

    names = modernbert_keys(config)
    for tower in towers:
        prefix = TOWER_PREFIXES[tower][0]
        model = getattr(params, tower)
        for name, key in names.items():
            mod_name, _, leaf = name.rpartition(".")
            module = model.get_submodule(mod_name) if mod_name else model
            t = sd[prefix + key]
            if t.shape != module._parameters[leaf].shape:
                raise ValueError(f"{prefix + key}: shape {tuple(t.shape)}, "
                                 f"the config wants "
                                 f"{tuple(module._parameters[leaf].shape)}")
            put(module, leaf, t)
    if "filter_linear.weight" in sd:
        put(params.filter, "w", sd["filter_linear.weight"].T)
        put(params.filter, "b", sd["filter_linear.bias"])
    rest = [(mod, name, p.shape) for mod in params.modules()
            for name, p in mod.named_parameters(recurse=False)
            if p.is_meta]
    zeros = torch.zeros(sum(int(np.prod(s)) for _, _, s in rest),
                        dtype=first.dtype, device=first.device)
    at = 0
    for mod, name, shape in rest:
        n = int(np.prod(shape))
        put(mod, name, zeros[at:at + n].view(shape))
        at += n
    return params


def modernbert_state_dict_from_encoder(params) -> Dict[str, torch.Tensor]:
    """ModernBERT ``EncoderParams`` → a state dict under the published
    names and the current DensePhrases prefixes, fp32 on the CPU."""
    sd: Dict[str, torch.Tensor] = {}
    cpu = lambda t: t.detach().to("cpu", torch.float32).clone()  # noqa: E731
    names = modernbert_keys(params.config)
    for tower, prefixes in TOWER_PREFIXES.items():
        own = dict(getattr(params, tower).named_parameters())
        for name, key in names.items():
            sd[prefixes[0] + key] = cpu(own[name])
    sd["filter_linear.weight"] = cpu(params.filter.w).T.contiguous()
    sd["filter_linear.bias"] = cpu(params.filter.b)
    return sd
