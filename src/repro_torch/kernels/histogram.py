"""The hand-written CUDA histogram kernel and its wrapper.

Replaces the TPU kernel ``histogram_pallas`` (``repro/kernels/histogram.py:108``,
body ``_make_hist_kernel`` at ``:47``): a one-hot matmul there, a privatised
shared-memory histogram with atomics here (``csrc/histogram.cu`` says why
and what bounds it).  The plain version of the same contract is
:func:`repro_torch.kernels.ref.ref_histogram`.

:func:`histogram_cuda` takes CUDA tensors only and raises on anything else;
the dispatch between kernel and plain version lives in
:mod:`repro_torch.kernels.ops`.  ``LAUNCHES`` counts the wrapper's kernel
launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from ._device import _check, _on_device, _sm_count

__all__ = ["LAUNCHES", "histogram_cuda"]

LAUNCHES = 0

_ACC_DTYPES = (torch.float32, torch.int32)


def _bind() -> ctypes.CDLL:
    lib = build.load("histogram")
    fn = lib.histogram_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, ctypes.c_int32, ctypes.c_longlong,
                       ctypes.c_int, p, p, ctypes.c_double, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def histogram_cuda(
    ids: torch.Tensor,
    num_bins: int,
    weights: Optional[torch.Tensor] = None,
    *,
    init: Optional[torch.Tensor] = None,
    gate_ids: Optional[torch.Tensor] = None,
    gate_value=None,
    valid_mask: Optional[torch.Tensor] = None,
    retire=0.0,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Weighted histogram on the card: the contract of ``ref_histogram``.

    ``ids`` (and ``gate_ids``) are int32 ``(n,)``; ``weights`` ``(n,)`` are
    cast to the accumulator; ``init`` and the bool ``valid_mask`` are
    ``(num_bins,)``.  Sums accumulate in ``out_dtype``: float32 (default) or
    int32.  Launches on the current stream and does not synchronize.
    """
    global LAUNCHES
    if not ids.is_cuda:
        raise ValueError(
            f"histogram_cuda runs on CUDA tensors, got ids on {ids.device}; "
            "the plain version for the CPU is kernels.ref.ref_histogram")
    acc = torch.float32 if out_dtype is None else out_dtype
    if acc not in _ACC_DTYPES:
        raise ValueError(f"accumulator must be float32 or int32, got {acc}")
    if not 0 <= num_bins < 2 ** 31:
        raise ValueError(f"num_bins {num_bins} outside [0, 2^31)")
    device = ids.device
    n = ids.shape[0]
    _check("ids", ids, torch.int32, (n,), device)
    ids = ids.contiguous()
    if weights is not None:
        _check("weights", weights, weights.dtype, (n,), device)
        weights = weights.to(acc).contiguous()
    if gate_ids is not None:
        _check("gate_ids", gate_ids, torch.int32, (n,), device)
        gate_ids = gate_ids.contiguous()
        gate_value = int(gate_value)
        if not -2 ** 31 <= gate_value < 2 ** 31:
            raise ValueError(f"gate_value {gate_value} is not an int32")
    if valid_mask is not None:
        _check("valid_mask", valid_mask, torch.bool, (num_bins,), device)
        valid_mask = valid_mask.contiguous()
    if init is not None:
        _check("init", init, init.dtype, (num_bins,), device)
        out = init.to(acc, copy=True).contiguous()
    else:
        out = torch.zeros(num_bins, dtype=acc, device=device)
    if n == 0 and valid_mask is None:
        return out

    ptr = lambda t: None if t is None else t.data_ptr()
    with _on_device(device):
        err = _bind()(
            int(acc == torch.int32), ptr(ids), ptr(weights), ptr(gate_ids),
            0 if gate_ids is None else gate_value, n, num_bins, ptr(out),
            ptr(valid_mask), float(retire), _sm_count(device),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
