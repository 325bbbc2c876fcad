"""The hand-written CUDA segment-sum kernel and its wrapper.

Replaces the TPU kernel ``segment_matmul_pallas``
(``repro/kernels/segment_matmul.py:45``, body ``_seg_mm_kernel`` at ``:25``):
a one-hot matmul on the MXU there, a scatter of feature rows with float
atomics here (``csrc/segment_matmul.cu`` says why and what bounds it).  The
plain version of the same contract is
:func:`repro_torch.kernels.ref.ref_segment_matmul`.

:func:`segment_matmul_cuda` takes CUDA tensors only and raises on anything
else; the dispatch between kernel and plain version lives in
:mod:`repro_torch.kernels.ops`.  ``LAUNCHES`` counts the wrapper's kernel
launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .histogram import _check

__all__ = ["LAUNCHES", "segment_matmul_cuda"]

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind() -> ctypes.CDLL:
    fn = build.load("segment_matmul").segment_matmul_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def segment_matmul_cuda(
    x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``out[s, :] = sum_{i: seg_ids[i]==s} x[i, :]`` on the card: the
    contract of ``ref_segment_matmul``.

    ``x`` is ``(n, d)`` float32, bfloat16 or float16 (made row-contiguous if
    it is not), ``seg_ids`` int32 ``(n,)``; ids outside ``[0,
    num_segments)`` are dropped.  Returns float32 ``(num_segments, d)``.
    Launches on the current stream and does not synchronize.
    """
    global LAUNCHES
    if not seg_ids.is_cuda:
        raise ValueError(
            f"segment_matmul_cuda runs on CUDA tensors, got seg_ids on "
            f"{seg_ids.device}; the plain version for the CPU is "
            "kernels.ref.ref_segment_matmul")
    if not 0 <= num_segments < 2 ** 31:
        raise ValueError(f"num_segments {num_segments} outside [0, 2^31)")
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"segment-sum kernel takes float32, bfloat16 or "
                         f"float16 rows, got {x.dtype}")
    n, d = x.shape
    if d >= 2 ** 31:
        raise ValueError(f"feature size {d} beyond int32")
    device = seg_ids.device
    _check("seg_ids", seg_ids, torch.int32, (n,), device)
    _check("x", x, x.dtype, (n, d), device)
    x, seg_ids = x.contiguous(), seg_ids.contiguous()
    out = torch.zeros(num_segments, d, dtype=torch.float32, device=device)
    if out.numel() == 0 or n == 0:
        return out
    with torch.cuda.device(device):
        err = _bind()(
            _DTYPES[x.dtype], x.data_ptr(), seg_ids.data_ptr(), n, d,
            num_segments, out.data_ptr(),
            torch.cuda.get_device_properties(device).multi_processor_count,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"segment-sum kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
