"""The hand-written CUDA Count-Min kernel, and the HyperLogLog fold as a
wrapper over the segment-max kernel.

``cms_update_cuda`` replaces the TPU kernel ``cms_update_pallas``
(``repro/kernels/sketch.py:69``, body ``_cms_kernel`` at ``:48``): a one-hot
compare-select over a sequential grid there, one launch here that reads
the running cells and writes the new ones, either a thread-block cluster
per depth row with the row's cells in shared memory or a cooperative seed
and atomic scatter (``csrc/sketch.cu`` says how and what bounds it;
:func:`cms_path` picks).  Its plain version is
:func:`repro_torch.kernels.ref.ref_cms_update`, and
:func:`repro_torch.kernels.ref.ref_cms_update_clustered` mirrors the
cluster path.

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
from typing import Dict, Optional, Tuple

import torch

from . import build
from ._device import _check, _dense, _on_device, _sm_count, _stream
from .segreduce import segment_max_cuda

__all__ = ["LAUNCHES", "HLL_LAUNCHES", "cms_path", "cms_update_cuda",
           "hll_update_cuda"]

LAUNCHES = 0
HLL_LAUNCHES = 0

_CELL_DTYPES = (torch.float32, torch.int32)
_PATHS = ("cluster", "cooperative")

_FN = None
_SETUP: Dict[int, Tuple[int, int]] = {}  # device -> (cluster bytes, co-resident blocks)


def cms_path(width: int, cluster_bytes: int) -> str:
    """The kernel path for rows of ``width`` cells: the cluster while a
    row's cells fit ``cluster_bytes`` of shared memory, else cooperative."""
    return "cluster" if width * 4 <= cluster_bytes else "cooperative"


def _bind(device: torch.device):
    """The launch entry point, bound once per process, and the cluster
    path's shared memory and the cooperative path's co-resident blocks on
    ``device``, found once per device; the device must be current."""
    global _FN
    if _FN is None:
        lib = build.load("sketch")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cms_update_setup.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.cms_update_setup.restype = i
        fn = lib.cms_update_launch
        fn.argtypes = [i, i, p, p, p, i, ctypes.c_longlong, i, p, i, p]
        fn.restype = i
        _FN = (lib.cms_update_setup, fn)
    setup, fn = _FN
    got = _SETUP.get(device.index)
    if got is None:
        nbytes, blocks = ctypes.c_int(), ctypes.c_int()
        err = setup(_sm_count(device), ctypes.byref(nbytes), ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"Count-Min kernel setup failed: cudaError {err}")
        got = _SETUP[device.index] = (nbytes.value, blocks.value)
    return fn, got


def cms_update_cuda(
    counts: torch.Tensor,
    col_ids: torch.Tensor,
    proposals: torch.Tensor,
    *,
    path: Optional[str] = None,
) -> torch.Tensor:
    """Conservative-update Count-Min fold on the card: the contract of
    ``ref_cms_update``.

    ``counts`` is ``(depth, width)`` int32 or float32, ``col_ids`` int32
    ``(depth, n)``, ``proposals`` ``(n,)`` (cast to the cell type unless it
    has it).  Returns a new ``(depth, width)`` tensor, written whole by one
    launch; with no proposals, a copy of ``counts``.  ``path`` forces the
    ``"cluster"`` or the ``"cooperative"`` path (for timing; the default is
    :func:`cms_path`'s).  Launches on the current stream and does not
    synchronize.
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
    if path is not None and path not in _PATHS:
        raise ValueError(f"path must be one of {_PATHS}, got {path!r}")
    device = counts.device
    depth, width = counts.shape
    n = col_ids.shape[-1] if col_ids.dim() == 2 else -1
    _check("col_ids", col_ids, torch.int32, (depth, n), device)
    _check("proposals", proposals, proposals.dtype, (n,), device)
    if n == 0 or depth == 0 or width == 0:
        return counts.clone(memory_format=torch.contiguous_format)
    counts, col_ids = _dense(counts), _dense(col_ids)
    if proposals.dtype != counts.dtype:
        proposals = proposals.to(counts.dtype)
    proposals = _dense(proposals)
    out = torch.empty((depth, width), dtype=counts.dtype, device=device)
    with _on_device(device):
        launch, (cluster_bytes, blocks) = _bind(device)
        path = cms_path(width, cluster_bytes) if path is None else path
        if path == "cluster" and width * 4 > cluster_bytes:
            raise ValueError(f"a row of {width} cells does not fit the cluster "
                             f"path's {cluster_bytes} bytes of shared memory")
        err = launch(
            int(counts.dtype == torch.int32), int(path == "cluster"),
            col_ids.data_ptr(), proposals.data_ptr(), counts.data_ptr(), depth, n,
            width, out.data_ptr(), blocks, _stream(device),
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
