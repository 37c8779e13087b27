"""Checkpoint / resume in torch's format.

The counterpart of ``densephrases_tpu/utils/checkpoint.py``, with its
``path/step_N`` layout: one ``state.pt`` per step directory holding the
whole ``TrainState`` (params, optimizer moments and count, step, pre-batch
ring) or bare params, so resume is exact, the pre-batch ring included.
Tensors are saved from the host and restored onto the template's device.
The reference's orbax saves are not read here: this package never imports
jax or orbax. ``restore_checkpoint`` recognises one and raises an error that
names ``convert_jax_checkpoint.py`` (at the repository root), which turns a
JAX ``save_encoder`` directory into this format where jax is installed.

Under data-parallel training (a process group of several ranks) rank 0
alone writes, with its own pre-batch ring, and every rank waits at a
barrier until the file is in place; every rank restores.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from densephrases_tpu_torch.parallel import rank_and_size

STATE_FILE = "state.pt"
# files an orbax save leaves in its step directory (OCDBT or not)
ORBAX_MARKERS = ("manifest.ocdbt", "_CHECKPOINT_METADATA")
CONVERTER = "convert_jax_checkpoint.py"


def _host(tree):
    """Tensors of a nested dict/list → detached CPU copies."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, state: Any, step: Optional[int] = None) -> str:
    """Save a ``TrainState``, or bare params (a module or its state dict),
    to ``path/step_N``."""
    path = os.path.abspath(path)
    step = int(step if step is not None else getattr(state, "step", 0))
    target = os.path.join(path, f"step_{step}")
    rank, size = rank_and_size()
    if rank == 0:
        _write(target, state)
    if size > 1:
        dist.barrier()
    return target


def _write(target: str, state: Any):
    os.makedirs(target, exist_ok=True)
    if isinstance(state, torch.nn.Module):
        blob = {"params": _host(state.state_dict())}
    elif isinstance(state, dict):
        blob = {"params": _host(state)}
    else:
        blob = {"params": _host(state.params.state_dict()),
                "opt_state": _host(state.opt_state), "step": int(state.step),
                "pre_batch": _host(state.pre_batch)}
    tmp = os.path.join(target, f".{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(target, STATE_FILE))


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(path, f"step_{max(steps)}")


def restore_checkpoint(path: str, template: Any) -> Any:
    """Restore the checkpoint at ``path/step_N`` (or the latest under
    ``path``) into ``template``: a params module, which is loaded in place
    and returned, or a ``TrainState``, whose params are loaded in place and
    which is returned with the saved optimizer state, step and ring."""
    target = path if os.path.basename(path).startswith("step_") \
        else latest_checkpoint(path)
    if target is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    if not os.path.exists(os.path.join(target, STATE_FILE)) and any(
            os.path.exists(os.path.join(target, m)) for m in ORBAX_MARKERS):
        raise ValueError(
            f"{target} is an orbax checkpoint written by the JAX package, "
            f"which this package cannot read; convert its save directory "
            f"where jax is installed: python {CONVERTER} --kind "
            f"encoder|cross <jax_save_dir> <out_dir>")
    blob = torch.load(os.path.join(target, STATE_FILE), map_location="cpu",
                      weights_only=True)
    module = template if isinstance(template, torch.nn.Module) \
        else template.params
    module.load_state_dict(blob["params"])
    if isinstance(template, torch.nn.Module):
        return template
    device = next(module.parameters()).device
    return type(template)(params=module,
                          opt_state=_to(blob["opt_state"], device),
                          step=blob["step"],
                          pre_batch=_to(blob["pre_batch"], device))
