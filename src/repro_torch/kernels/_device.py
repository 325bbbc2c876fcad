"""Device plumbing shared by the kernel wrappers: input checks, the card's
SM count read once per device, the device switch and the stream for a
launch."""
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


def _stream(device: torch.device) -> int:
    """The current stream of ``device`` as the kernels take it: the raw
    handle, read without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a contiguous layout, copied only when it has none."""
    return x if x.is_contiguous() else x.contiguous()


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, ids on {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
