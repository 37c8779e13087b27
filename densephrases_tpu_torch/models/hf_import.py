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
