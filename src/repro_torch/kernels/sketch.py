"""The hand-written CUDA Count-Min kernel, and the HyperLogLog fold as a
wrapper over the segment-max kernel.

``cms_update_cuda`` replaces the TPU kernel ``cms_update_pallas``
(``repro/kernels/sketch.py:69``, body ``_cms_kernel`` at ``:48``): a one-hot
compare-select over a sequential grid there, an atomic-max scatter per
depth row here (``csrc/sketch.cu`` says why and what bounds it).  Its plain
version is :func:`repro_torch.kernels.ref.ref_cms_update`.

``hll_update_cuda`` answers ``hll_update_pallas``
(``repro/kernels/sketch.py:130``), which holds no kernel of its own: an HLL
register fold is a segmented max with the running registers as ``init``,
so it calls :func:`repro_torch.kernels.segreduce.segment_max_cuda`, whose
``LAUNCHES`` counts it; ``HLL_LAUNCHES`` here counts the folds among them.

Both take CUDA tensors only and raise on anything else; the dispatch lives
in :mod:`repro_torch.kernels.ops`.  ``LAUNCHES`` counts the CMS wrapper's
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from ._device import _check, _on_device, _sm_count
from .segreduce import segment_max_cuda

__all__ = ["LAUNCHES", "HLL_LAUNCHES", "cms_update_cuda", "hll_update_cuda"]

LAUNCHES = 0
HLL_LAUNCHES = 0

_CELL_DTYPES = (torch.float32, torch.int32)


def _bind() -> ctypes.CDLL:
    fn = build.load("sketch").cms_update_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def cms_update_cuda(
    counts: torch.Tensor,
    col_ids: torch.Tensor,
    proposals: torch.Tensor,
) -> torch.Tensor:
    """Conservative-update Count-Min fold on the card: the contract of
    ``ref_cms_update``.

    ``counts`` is ``(depth, width)`` int32 or float32, ``col_ids`` int32
    ``(depth, n)``, ``proposals`` ``(n,)`` (cast to the cell type).  Returns
    a new ``(depth, width)`` tensor; with no proposals, a copy of
    ``counts``.  Launches on the current stream and does not synchronize.
    """
    global LAUNCHES
    if not counts.is_cuda:
        raise ValueError(
            f"cms_update_cuda runs on CUDA tensors, got counts on "
            f"{counts.device}; the plain version for the CPU is "
            "kernels.ref.ref_cms_update")
    if counts.dtype not in _CELL_DTYPES or counts.dim() != 2:
        raise ValueError(f"counts must be a 2-d float32 or int32 tensor, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    device = counts.device
    depth, width = counts.shape
    n = col_ids.shape[-1] if col_ids.dim() == 2 else -1
    _check("col_ids", col_ids, torch.int32, (depth, n), device)
    _check("proposals", proposals, proposals.dtype, (n,), device)
    out = counts.clone(memory_format=torch.contiguous_format)
    if n == 0 or depth == 0 or width == 0:
        return out
    col_ids = col_ids.contiguous()
    proposals = proposals.to(counts.dtype).contiguous()
    with _on_device(device):
        err = _bind()(
            int(counts.dtype == torch.int32), col_ids.data_ptr(),
            proposals.data_ptr(), depth, n, width, out.data_ptr(),
            _sm_count(device), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"Count-Min kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def hll_update_cuda(
    registers: torch.Tensor,
    reg_ids: torch.Tensor,
    rhos: torch.Tensor,
) -> torch.Tensor:
    """HyperLogLog register fold on the card: ``reg[j] = max(reg[j], max rho
    over j)``, the segment-max kernel with ``init=registers``."""
    global HLL_LAUNCHES
    out = segment_max_cuda(rhos, reg_ids, registers.shape[0], init=registers)
    if reg_ids.shape[0]:  # segment_max_cuda launches nothing for no rows
        HLL_LAUNCHES += 1
    return out
