"""The hand-written CUDA segment-max kernel and its wrapper.

Replaces the TPU kernel ``segment_max_pallas`` (``repro/kernels/segreduce.py:92``,
body ``_make_segmax_kernel`` at ``:42``): a one-hot compare-select over a
sequential grid there, one cooperative launch here that seeds the segments
and then scatters with a float atomic max (``csrc/segreduce.cu`` says how
and what bounds it).  The plain version of the same contract is
:func:`repro_torch.kernels.ref.ref_segment_max`, and
:func:`repro_torch.kernels.ref.ref_segment_max_blocked` mirrors the
kernel's seed and fold.

:func:`segment_max_cuda` takes CUDA tensors only and raises on anything
else; the dispatch between kernel and plain version lives in
:mod:`repro_torch.kernels.ops`.  ``LAUNCHES`` counts the wrapper's kernel
launches, so a run can show that its main path went through the kernel.

The feature-wise max of ``(n, d)`` rows into ``(num_segments, d)``
(:func:`segment_max_features_cuda`, a GNN's max aggregation) is the same
1-D kernel over the flattened ids ``seg_id * d + feature``: ``n * d``
values into ``num_segments * d`` segments.  A max is exact in floating
point, so this is bit-equal to the plain ``scatter_reduce_``
(:func:`repro_torch.kernels.ref.ref_segment_max_features`).  Under
autograd it runs as the forward of :class:`SegmentMax`, whose backward
(:func:`segment_max_backward`) splits each segment's gradient evenly among
the rows that tie for its max, in the plain autograd's operations, so the
two gradients are bit-equal.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import build
from ._device import _check, _on_device, _sm_count

__all__ = ["LAUNCHES", "segment_max_cuda", "flat_segment_ids",
           "segment_max_features_cuda",
           "segment_max_backward", "SegmentMax"]

LAUNCHES = 0

# values and init in their own type; any other is cast to float32 first
_KINDS = {torch.float32: 0, torch.int32: 1}
_BLOCKS: Dict[int, int] = {}  # device index -> co-resident cooperative blocks


def _bind():
    lib = build.load("segreduce")
    fn = lib.segment_max_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segment_max_setup.argtypes = [i, ctypes.POINTER(i)]
        lib.segment_max_setup.restype = i
        fn.argtypes = [i, i, p, p, p, ctypes.c_int32, ctypes.c_longlong, i, p, p,
                       ctypes.c_float, p, i, p]
        fn.restype = i
    return lib, fn


def _setup(lib, device: torch.device) -> int:
    """The cooperative kernel's co-resident blocks on ``device``, found once;
    the device must be current."""
    got = _BLOCKS.get(device.index)
    if got is None:
        blocks = ctypes.c_int()
        err = lib.segment_max_setup(_sm_count(device), ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"segment-max kernel setup failed: cudaError {err}")
        got = _BLOCKS[device.index] = blocks.value
    return got


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

    ``seg_ids`` (and ``gate_ids``) are int32 ``(n,)``; ``vals`` ``(n,)`` and
    ``init`` ``(num_segments,)`` are read as float32 or int32 (any other type
    is cast to float32 first); the bool ``valid_mask`` is
    ``(num_segments,)``.  With rows, or a mask, a call is one launch,
    which writes every element of the float32 result; with neither, it
    launches nothing.  Launches on the current stream and does not
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
    if vals.dtype not in _KINDS:
        vals = vals.to(torch.float32)
    vals = vals.contiguous()
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
        if init.dtype not in _KINDS:
            init = init.to(torch.float32)
        init = init.contiguous()
    if n == 0 and valid_mask is None:
        if init is not None:
            return init.to(torch.float32, copy=True)
        return torch.full((num_segments,), float("-inf"), dtype=torch.float32,
                          device=device)
    out = torch.empty(num_segments, dtype=torch.float32, device=device)
    if num_segments == 0:
        return out

    ptr = lambda t: None if t is None else t.data_ptr()
    lib, launch = _bind()
    with _on_device(device):
        blocks = _setup(lib, device)
        err = launch(
            _KINDS[vals.dtype],
            0 if init is None else _KINDS[init.dtype], ptr(seg_ids), ptr(vals),
            ptr(gate_ids), 0 if gate_ids is None else gate_value, n, num_segments,
            ptr(init), ptr(valid_mask), float(retire), ptr(out), blocks,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"segment-max kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def flat_segment_ids(seg_ids: torch.Tensor, num_segments: int,
                     d: int) -> torch.Tensor:
    """The ids of ``(n, d)`` rows' elements, flattened: ``seg_id * d +
    feature`` where ``seg_id`` lies in ``[0, num_segments)``, else -1 (a
    dropped row's elements stay dropped).  int32 ``(n * d,)``, row-major as
    ``x.reshape(-1)``."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    base = torch.where(ok, seg_ids, 0).to(torch.int32)[:, None] * d
    return torch.where(ok[:, None], base + torch.arange(
        d, dtype=torch.int32, device=seg_ids.device), -1).reshape(-1)


def segment_max_features_cuda(x: torch.Tensor, seg_ids: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """Feature-wise segment max on the card, the contract of
    ``ref_segment_max_features``: ``x`` ``(n, d)``, ``seg_ids`` int32 ``(n,)``,
    ids outside ``[0, num_segments)`` dropped; float32 ``(num_segments, d)``,
    empty segments ``-inf``.  One launch of the segment-max kernel over the
    flattened ids (a dropped row's are -1); ``num_segments * d`` must be
    below 2^31."""
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    n, d = x.shape
    if not 0 <= num_segments * d < 2 ** 31:
        raise ValueError(f"{num_segments} segments x {d} features beyond the "
                         "kernel's int32 segment ids")
    _check("seg_ids", seg_ids, torch.int32, (n,), seg_ids.device)
    return segment_max_cuda(x.reshape(-1), flat_segment_ids(seg_ids, num_segments, d),
                            num_segments * d).view(num_segments, d)


def segment_max_backward(grad: torch.Tensor, x: torch.Tensor,
                         seg_ids: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The feature-wise segment max's gradient with respect to its rows,
    float32 ``(n, d)``, from the forward's rows ``x``, ids and result
    ``out``: each row that equals its segment's max takes the segment's
    gradient over the count of such rows, an empty segment counting one;
    every other row, and a dropped one, 0.  These are plain
    ``scatter_reduce_(amax)``'s backward operations (``value``,
    ``N_to_distribute``, ``grad / N``, ``(src == value) * ...``), the
    dropped rows' spill row a NaN max that no row equals.  Any device; no
    host sync."""
    s = out.shape[0]
    spill = torch.where((seg_ids >= 0) & (seg_ids < s), seg_ids, s)
    value = F.pad(out, (0, 0, 0, 1), value=float("nan")).index_select(0, spill)
    src_is_max = x == value
    counts = F.pad((out == float("-inf")).to(out.dtype), (0, 0, 0, 1),
                   value=1.0).index_add_(0, spill, src_is_max.to(out.dtype))
    return src_is_max * (F.pad(grad, (0, 0, 0, 1)) / counts).index_select(0, spill)


class SegmentMax(torch.autograd.Function):
    """``segment_max_features_cuda`` forward, :func:`segment_max_backward`
    backward: ``SegmentMax.apply(x, seg_ids, num_segments)``."""

    @staticmethod
    def forward(ctx, x, seg_ids, num_segments):
        out = segment_max_features_cuda(x, seg_ids, num_segments)
        ctx.save_for_backward(x, seg_ids, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, seg_ids, out = ctx.saved_tensors
        return segment_max_backward(g, x, seg_ids, out).to(x.dtype), None, None
