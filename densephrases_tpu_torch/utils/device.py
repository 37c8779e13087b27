"""Device selection without silent fallback."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """Return ``torch.device(device)``, a bare "cuda" made explicit as the
    current device (so devices compare equal); raise if it names CUDA and
    there is no usable GPU (never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but "
                               "torch.cuda.is_available() is false")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
