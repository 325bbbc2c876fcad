"""The hand-written CUDA segment-max kernel and its wrapper.

Replaces the TPU kernel ``segment_max_pallas`` (``repro/kernels/segreduce.py:92``,
body ``_make_segmax_kernel`` at ``:42``): a one-hot compare-select over a
sequential grid there, a scatter with a float atomic max here
(``csrc/segreduce.cu`` says why and what bounds it).  The plain version of
the same contract is :func:`repro_torch.kernels.ref.ref_segment_max`.

:func:`segment_max_cuda` takes CUDA tensors only and raises on anything
else; the dispatch between kernel and plain version lives in
:mod:`repro_torch.kernels.ops`.  ``LAUNCHES`` counts the wrapper's kernel
launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .histogram import _check

__all__ = ["LAUNCHES", "segment_max_cuda"]

LAUNCHES = 0


def _bind() -> ctypes.CDLL:
    fn = build.load("segreduce").segment_max_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int32, ctypes.c_longlong, ctypes.c_int,
                       p, p, ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def segment_max_cuda(
    vals: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    *,
    init: Optional[torch.Tensor] = None,
    gate_ids: Optional[torch.Tensor] = None,
    gate_value=None,
    valid_mask: Optional[torch.Tensor] = None,
    retire=float("-inf"),
) -> torch.Tensor:
    """Per-segment float32 max on the card: the contract of
    ``ref_segment_max``.

    ``seg_ids`` (and ``gate_ids``) are int32 ``(n,)``; ``vals`` ``(n,)`` are
    cast to float32; ``init`` and the bool ``valid_mask`` are
    ``(num_segments,)``.  Launches on the current stream and does not
    synchronize.
    """
    global LAUNCHES
    if not seg_ids.is_cuda:
        raise ValueError(
            f"segment_max_cuda runs on CUDA tensors, got seg_ids on "
            f"{seg_ids.device}; the plain version for the CPU is "
            "kernels.ref.ref_segment_max")
    if not 0 <= num_segments < 2 ** 31:
        raise ValueError(f"num_segments {num_segments} outside [0, 2^31)")
    device = seg_ids.device
    n = seg_ids.shape[0]
    _check("seg_ids", seg_ids, torch.int32, (n,), device)
    _check("vals", vals, vals.dtype, (n,), device)
    seg_ids = seg_ids.contiguous()
    vals = vals.to(torch.float32).contiguous()
    if gate_ids is not None:
        _check("gate_ids", gate_ids, torch.int32, (n,), device)
        gate_ids = gate_ids.contiguous()
        gate_value = int(gate_value)
        if not -2 ** 31 <= gate_value < 2 ** 31:
            raise ValueError(f"gate_value {gate_value} is not an int32")
    if valid_mask is not None:
        _check("valid_mask", valid_mask, torch.bool, (num_segments,), device)
        valid_mask = valid_mask.contiguous()
    if init is not None:
        _check("init", init, init.dtype, (num_segments,), device)
        out = init.to(torch.float32, copy=True).contiguous()
    else:
        out = torch.full((num_segments,), float("-inf"), dtype=torch.float32,
                         device=device)
    if n == 0 and valid_mask is None:
        return out

    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(device):
        err = _bind()(
            ptr(seg_ids), ptr(vals), ptr(gate_ids),
            0 if gate_ids is None else gate_value, n, num_segments, ptr(out),
            ptr(valid_mask), float(retire),
            torch.cuda.get_device_properties(device).multi_processor_count,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"segment-max kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
