"""Weight bridge: the JAX package's parameter tree → the port's modules.

Input is the reference's params pytree with every leaf already turned into
a numpy array (``jax.tree.map(np.asarray, params)``), so this module needs
no jax. The tree's layout:

- ``embed/{word,pos,type,ln_scale,ln_bias}`` → ``BertModel.{word_emb,
  pos_emb, type_emb, ln_scale, ln_bias}``;
- ``layers/<name>`` stacked on a leading [num_layers] axis → unstacked
  into ``BertModel.layers[i].<name>``;
- ``filter/{w,b}`` → ``EncoderParams.filter.{w,b}``.

Weight matrices stay ``[in, out]``: the port multiplies ``x @ w`` as the
reference does, so nothing is transposed.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from densephrases_tpu_torch.models.bert import BertConfig, BertModel
from densephrases_tpu_torch.models.encoder import TOWERS, EncoderParams
from densephrases_tpu_torch.utils.device import resolve_device

_EMBED = {"word": "word_emb", "pos": "pos_emb", "type": "type_emb",
          "ln_scale": "ln_scale", "ln_bias": "ln_bias"}


def _tensor(arr) -> torch.Tensor:
    """A torch copy of one leaf (jax hands out read-only buffers)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: exact through fp32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _copy(param: torch.nn.Parameter, arr, where: str):
    t = _tensor(arr)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)} != "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.data = t


def _load_bert(model: BertModel, tree: Mapping, where: str):
    for key, attr in _EMBED.items():
        _copy(getattr(model, attr), tree["embed"][key], f"{where}/embed/{key}")
    layers = tree["layers"]
    for name, stacked in layers.items():
        if np.asarray(stacked).shape[0] != len(model.layers):
            raise ValueError(f"{where}/layers/{name}: {stacked.shape[0]} "
                             f"layers, config has {len(model.layers)}")
        for i, layer in enumerate(model.layers):
            _copy(getattr(layer, name), stacked[i], f"{where}/layers/{name}")


def encoder_from_jax(tree: Mapping, config: BertConfig, device="cpu",
                     dtype: Optional[torch.dtype] = None) -> EncoderParams:
    """``init_encoder_params``-style tree (``phrase``, ``query_start``,
    ``query_end``, ``filter``) → ``EncoderParams``. Teacher entries
    (``cross``, ``qa_outputs``) are training-only and not bridged. ``dtype``
    None keeps the tree's dtype."""
    params = EncoderParams(config)
    for name in TOWERS:
        _load_bert(getattr(params, name), tree[name], name)
    _copy(params.filter.w, tree["filter"]["w"], "filter/w")
    _copy(params.filter.b, tree["filter"]["b"], "filter/b")
    return params.to(device=resolve_device(device), dtype=dtype)
