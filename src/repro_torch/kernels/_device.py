"""Device plumbing shared by the kernel wrappers: input checks, the card's
SM count read once per device, and the device switch for a launch."""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

_SMS: Dict[int, int] = {}  # device index -> streaming multiprocessors


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device (the kernels size their
    grids by it)."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _on_device(device: torch.device):
    """Make ``device`` current for a launch, entering no context when it
    already is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, ids on {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
