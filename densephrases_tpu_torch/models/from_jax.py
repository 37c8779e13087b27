"""Weight bridge between the JAX package's parameter tree and the port's
modules, both ways.

Input is the reference's params pytree with every leaf already turned into
a numpy array (``jax.tree.map(np.asarray, params)``), so this module needs
no jax. The tree's layout:

- ``embed/{word,pos,type,ln_scale,ln_bias}`` → ``BertModel.{word_emb,
  pos_emb, type_emb, ln_scale, ln_bias}``;
- ``layers/<name>`` stacked on a leading [num_layers] axis → unstacked
  into ``BertModel.layers[i].<name>``;
- ``filter/{w,b}`` → ``EncoderParams.filter.{w,b}``;
- with a teacher, ``cross`` (a tower) and ``qa_outputs/{w,b}``.

Weight matrices stay ``[in, out]``: the port multiplies ``x @ w`` as the
reference does, so nothing is transposed. ``encoder_to_jax`` goes back: the
port's modules → a numpy tree in the reference's layout with the layers
re-stacked, so that tests compare gradients and updated parameters in the
reference's own layout. ``reference_path`` names a port parameter by its
path in that tree.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from densephrases_tpu_torch.models.bert import BertConfig, BertModel
from densephrases_tpu_torch.models.encoder import TEACHER, TOWERS, EncoderParams
from densephrases_tpu_torch.utils.device import resolve_device

_EMBED = {"word": "word_emb", "pos": "pos_emb", "type": "type_emb",
          "ln_scale": "ln_scale", "ln_bias": "ln_bias"}
_EMBED_BACK = {v: k for k, v in _EMBED.items()}


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


def encoder_from_jax(tree: Mapping, config: BertConfig, device="cuda",
                     dtype: Optional[torch.dtype] = None) -> EncoderParams:
    """``init_encoder_params``-style tree (``phrase``, ``query_start``,
    ``query_end``, ``filter``, and ``cross`` + ``qa_outputs`` when the tree
    has a teacher) → ``EncoderParams``. ``dtype`` None keeps the tree's
    dtype."""
    with_teacher = all(k in tree for k in TEACHER)
    params = EncoderParams(config, with_teacher=with_teacher)
    towers = TOWERS + (("cross",) if with_teacher else ())
    for name in towers:
        _load_bert(getattr(params, name), tree[name], name)
    for head in ("filter", "qa_outputs") if with_teacher else ("filter",):
        for leaf in ("w", "b"):
            _copy(getattr(getattr(params, head), leaf), tree[head][leaf],
                  f"{head}/{leaf}")
    return params.to(device=resolve_device(device), dtype=dtype)


def reference_path(name: str) -> str:
    """A port parameter name → its path in the reference's tree:
    ``phrase.word_emb`` → ``phrase/embed/word``, ``phrase.layers.3.q_w`` →
    ``phrase/layers/q_w`` (the stacked leaf), ``filter.w`` → ``filter/w``."""
    parts = name.split(".")
    if len(parts) == 2 and parts[1] in _EMBED_BACK:
        return f"{parts[0]}/embed/{_EMBED_BACK[parts[1]]}"
    if len(parts) == 4 and parts[1] == "layers":
        return f"{parts[0]}/layers/{parts[3]}"
    return "/".join(parts)


def named_to_jax(named) -> dict:
    """(port name, tensor) pairs → a nested dict of numpy arrays in the
    reference's layout, layers re-stacked on a leading axis (in the order
    given). bf16 becomes fp32."""
    leaves: dict = {}
    for name, t in named:
        leaves.setdefault(reference_path(name), []).append(
            t.detach().to("cpu", torch.float32).numpy())
    tree: dict = {}
    for path, arrs in leaves.items():
        *where, leaf = path.split("/")
        node = tree
        for key in where:
            node = node.setdefault(key, {})
        node[leaf] = np.stack(arrs) if "/layers/" in f"/{path}" else arrs[0]
    return tree


def encoder_to_jax(params: torch.nn.Module) -> dict:
    """The port's modules (``EncoderParams``, or any module whose parameters
    follow its names) → the reference's params tree, as numpy arrays."""
    return named_to_jax(params.named_parameters())
