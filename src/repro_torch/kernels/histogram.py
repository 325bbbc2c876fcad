"""The hand-written CUDA histogram kernel and its wrapper.

Replaces the TPU kernel ``histogram_pallas`` (``repro/kernels/histogram.py:108``,
body ``_make_hist_kernel`` at ``:47``): a one-hot matmul there, one
cooperative launch here, either with private copies of the bins in shared
memory summed in a fixed order (few bins) or with a seed and a scatter of
warp-merged atomics (many bins); ``csrc/histogram.cu`` says how and what
bounds it, and :func:`plan_histogram` picks the path and the grid.  The
plain version of the same contract is
:func:`repro_torch.kernels.ref.ref_histogram`, and
:func:`repro_torch.kernels.ref.ref_histogram_blocked` mirrors the kernel's
decomposition.

:func:`histogram_cuda` takes CUDA tensors only and raises on anything else;
the dispatch between kernel and plain version lives in
:mod:`repro_torch.kernels.ops`.  ``LAUNCHES`` counts the wrapper's kernel
launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import build
from ._device import _check, _dense, _on_device, _sm_count, _stream

__all__ = ["LAUNCHES", "HistogramPlan", "histogram_cuda", "plan_histogram"]

LAUNCHES = 0

# accumulators, and the types weights and init are read in (any other is
# cast to the accumulator first)
_KINDS = {torch.float32: 0, torch.int32: 1}
THREADS = 1024                # threads a block (kThreads)
ROWS_IN_FLIGHT = 4            # rows a thread loads at once (kRowsInFlight)
PRIVATE_BIN_BYTES = 48 * 1024  # the largest private copy of the bins (kPrivateBytes)
# rows a thread takes at least on the private path, so that a block's
# copy of the bins (zeroed, stored, summed) is paid for by its rows
PRIVATE_ROWS_PER_THREAD = 16

_FN = None
_RESIDENT: Dict[int, Tuple[int, int]] = {}  # device index -> co-resident blocks


class HistogramPlan(NamedTuple):
    private: bool  # private copies of the bins in shared memory, else scatter
    blocks: int    # the cooperative launch's blocks


def plan_histogram(n: int, num_bins: int, private_blocks: int,
                   scatter_blocks: int) -> HistogramPlan:
    """The kernel's path and grid for ``n`` rows into ``num_bins`` bins,
    given each path's co-resident blocks: private copies when the bins fit
    ``PRIVATE_BIN_BYTES`` and there are at least as many rows as bins
    (fewer rows do not pay for a copy per block), with a block per
    ``PRIVATE_ROWS_PER_THREAD`` rows a thread; else the scatter, with a
    block per ``ROWS_IN_FLIGHT`` rows or bins a thread."""
    if num_bins * 4 <= PRIVATE_BIN_BYTES and n >= num_bins:
        per_block = THREADS * PRIVATE_ROWS_PER_THREAD
        return HistogramPlan(True, max(1, min(private_blocks, -(-n // per_block))))
    per_block = THREADS * ROWS_IN_FLIGHT
    return HistogramPlan(
        False, max(1, min(scatter_blocks, -(-max(n, num_bins) // per_block))))


def _bind(device: torch.device):
    """The launch entry point, bound once per process, and the co-resident
    blocks of each path on ``device``, found once per device; the device
    must be current."""
    global _FN
    if _FN is None:
        lib = build.load("histogram")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.histogram_setup.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i),
                                        ctypes.POINTER(i)]
        lib.histogram_setup.restype = i
        fn = lib.histogram_launch
        fn.argtypes = [i, i, i, i, i, p, p, p, ctypes.c_int32, ctypes.c_longlong, i,
                       p, p, ctypes.c_double, p, p, p]
        fn.restype = i
        _FN = (lib.histogram_setup, fn)
    setup, fn = _FN
    got = _RESIDENT.get(device.index)
    if got is None:
        priv, scat, nbytes = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = setup(_sm_count(device), ctypes.byref(priv), ctypes.byref(scat),
                    ctypes.byref(nbytes))
        if err != 0:
            raise RuntimeError(f"histogram kernel setup failed: cudaError {err}")
        if nbytes.value != PRIVATE_BIN_BYTES:
            raise RuntimeError(f"histogram.cu's private copy holds {nbytes.value} "
                               f"bytes, the wrapper plans {PRIVATE_BIN_BYTES}")
        got = _RESIDENT[device.index] = (priv.value, scat.value)
    return fn, got


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

    ``ids`` (and ``gate_ids``) are int32 ``(n,)``; ``weights`` ``(n,)`` and
    ``init`` ``(num_bins,)`` are read as float32 or int32 (any other type is
    cast to the accumulator first); the bool ``valid_mask`` is
    ``(num_bins,)``.  Sums accumulate in ``out_dtype``: float32 (default)
    or int32.  With rows, or a mask, a call is one launch, which writes
    every bin of the result; with neither it launches nothing but a copy
    of ``init`` or a zero fill.  Launches on the current stream and does
    not synchronize.
    """
    global LAUNCHES
    if not ids.is_cuda:
        raise ValueError(
            f"histogram_cuda runs on CUDA tensors, got ids on {ids.device}; "
            "the plain version for the CPU is kernels.ref.ref_histogram")
    acc = torch.float32 if out_dtype is None else out_dtype
    if acc not in _KINDS:
        raise ValueError(f"accumulator must be float32 or int32, got {acc}")
    if not 0 <= num_bins < 2 ** 31:
        raise ValueError(f"num_bins {num_bins} outside [0, 2^31)")
    device = ids.device
    n = ids.shape[0]
    _check("ids", ids, torch.int32, (n,), device)
    ids = _dense(ids)
    if weights is not None:
        _check("weights", weights, weights.dtype, (n,), device)
        weights = _dense(weights if weights.dtype in _KINDS else weights.to(acc))
    if gate_ids is not None:
        _check("gate_ids", gate_ids, torch.int32, (n,), device)
        gate_ids = _dense(gate_ids)
        gate_value = int(gate_value)
        if not -2 ** 31 <= gate_value < 2 ** 31:
            raise ValueError(f"gate_value {gate_value} is not an int32")
    if valid_mask is not None:
        _check("valid_mask", valid_mask, torch.bool, (num_bins,), device)
        valid_mask = _dense(valid_mask)
    if init is not None:
        _check("init", init, init.dtype, (num_bins,), device)
        init = _dense(init if init.dtype in _KINDS else init.to(acc))
    if n == 0 and valid_mask is None:
        if init is not None:
            return init.to(acc, copy=True)
        return torch.zeros(num_bins, dtype=acc, device=device)
    out = torch.empty(num_bins, dtype=acc, device=device)
    if num_bins == 0:
        return out

    ptr = lambda t: None if t is None else t.data_ptr()
    kind = lambda t: 0 if t is None else _KINDS[t.dtype]
    with _on_device(device):
        launch, resident = _bind(device)
        plan = plan_histogram(n, num_bins, *resident)
        scratch = (torch.empty((plan.blocks, num_bins), dtype=acc, device=device)
                   if plan.private else None)
        err = launch(
            _KINDS[acc], kind(weights), kind(init), int(plan.private), plan.blocks,
            ptr(ids), ptr(weights), ptr(gate_ids),
            0 if gate_ids is None else gate_value, n, num_bins, ptr(init),
            ptr(valid_mask), float(retire), ptr(out), ptr(scratch), _stream(device),
        )
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
