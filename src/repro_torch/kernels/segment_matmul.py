"""The hand-written CUDA segment-sum kernel and its wrapper.

Replaces the TPU kernel ``segment_matmul_pallas``
(``repro/kernels/segment_matmul.py:45``, body ``_seg_mm_kernel`` at ``:25``):
a one-hot matmul on the MXU whose output tile stays in VMEM there; one
block per (segment tile x feature tile) at a time here, which sorts its
rows by segment in shared memory and sums each segment in registers
(``csrc/segment_matmul.cu`` says how and what bounds it).  A block finds
its tile's rows either by reading every id (direct) or, where that would
read the ids many times over, from a sort of the rows by tile that the
same launch makes first (partitioned).  :func:`plan_segment_sum` picks the
tile and the way.  The plain version of the same contract is
:func:`repro_torch.kernels.ref.ref_segment_matmul`, and
:func:`repro_torch.kernels.ref.ref_segment_matmul_tiled` mirrors the
kernel's decomposition.

:func:`segment_matmul_cuda` takes CUDA tensors only and raises on anything
else; the dispatch between kernel and plain version lives in
:mod:`repro_torch.kernels.ops`.  ``LAUNCHES`` counts the wrapper's kernel
launches, so a run can show that its main path went through the kernel.

Under autograd the kernel runs as the forward of :class:`SegmentSum`,
whose backward is :func:`segment_sum_backward`: each row takes its
segment's gradient, a dropped row 0.  That is the gather the plain
version's autograd (``index_add_``'s) computes, so the two gradients are
bit-equal; it saves the ids and nothing of the rows.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import build
from ._device import _check, _on_device, _sm_count

__all__ = ["LAUNCHES", "PARTITION_IDS", "SegmentSumPlan", "plan_segment_sum",
           "segment_matmul_cuda", "segment_sum_backward", "SegmentSum"]

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The source's limits: tiles of up to 256 segments (the TPU kernel's tile)
# by 128 features (4 for each of a warp's 32 lanes), and at most 16,384
# ids a round (ranks and segments packed in 31 bits).
MAX_TILE_SEGMENTS = 256
MAX_TILE_FEATURES = 128
MAX_ROUND_IDS = 16384
# Direct blocks each read all n ids, an SM's blocks one after another: the
# partitioned launch (the ids read twice in all, a row list of 8 bytes a
# row written and read, three grid barriers) serves once n times the tiles
# an SM takes exceeds this.  Measured on an H100 at 4,096 segments of 64
# features (PERF.md, section 6): direct 0.0135 against 0.0162 device ms at
# 2^15 rows, 0.0238 against 0.0183 at 2^16.
PARTITION_IDS = 1 << 15
_PARTS: Dict[int, int] = {}  # device index -> co-resident blocks, after setup


class SegmentSumPlan(NamedTuple):
    """A launch of the segment-sum kernel: tiles of ``ts`` segments x ``tf``
    features; a tile's rows read ``cap`` at a time; ``parts`` blocks that
    sort the rows by tile first, or 0 for one block per tile that reads
    every id."""
    ts: int
    tf: int
    cap: int
    parts: int


def plan_segment_sum(n: int, d: int, num_segments: int, num_sms: int,
                     partition: Optional[bool] = None) -> SegmentSumPlan:
    """The kernel's plan for ``n`` rows of ``d`` features into
    ``num_segments``: ``tf`` is ``d`` up to 128, ``ts`` the power of two
    that gives about one tile per SM (up to 256 segments, and at least
    one), ``cap`` all the ids up to 16,384; partitioned by ``num_sms``
    blocks when ``n`` times the tiles an SM takes exceeds
    ``PARTITION_IDS`` (``partition`` forces the one way or the other).
    full_graph_sm (10,752 rows, S 2,816, d 1,433) gets 256 x 128 tiles,
    11 x 12 = 132 direct blocks, the last feature tile 25 wide; molecule
    (8,192 rows, S 4,096, d 64) 32 x 64, 128 direct blocks; minibatch_lg
    (168,960 rows, S 170,496, d 602) and ogb_products (61,865,984 rows,
    S 2,449,920, d 100) 256 x 128 tiles, partitioned.
    """
    tf = max(1, min(d, MAX_TILE_FEATURES))
    tiles_f = -(-d // tf)
    want = -(-max(num_segments, 1) * tiles_f // num_sms)
    ts = 1
    while ts < want and ts < MAX_TILE_SEGMENTS:
        ts *= 2
    ts = min(ts, max(num_segments, 1))
    waves = -(-(-(-max(num_segments, 1) // ts) * tiles_f) // num_sms)
    if partition is None:
        partition = n * waves > PARTITION_IDS
    return SegmentSumPlan(ts, tf, max(1, min(n, MAX_ROUND_IDS)),
                          num_sms if partition and n > 0 else 0)


def _bind():
    lib = build.load("segment_matmul")
    fn = lib.segment_matmul_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [i, p, p, ctypes.c_longlong, i, i, i, i, i, i, p, p, p]
        fn.restype = i
        lib.segment_matmul_setup.argtypes = [i, ctypes.POINTER(i)]
        lib.segment_matmul_setup.restype = i
    return lib, fn


def _setup(lib, device: torch.device) -> int:
    """Once per device (which must be current): the kernel's shared-memory
    opt-in; returns the blocks a partitioned launch may take."""
    got = _PARTS.get(device.index)
    if got is None:
        parts = ctypes.c_int()
        err = lib.segment_matmul_setup(_sm_count(device), ctypes.byref(parts))
        if err != 0:
            raise RuntimeError(f"segment-sum kernel setup failed: cudaError {err}")
        got = _PARTS[device.index] = parts.value
    return got


def segment_matmul_cuda(
    x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int, *,
    partition: Optional[bool] = None,
) -> torch.Tensor:
    """``out[s, :] = sum_{i: seg_ids[i]==s} x[i, :]`` on the card: the
    contract of ``ref_segment_matmul``.

    ``x`` is ``(n, d)`` float32, bfloat16 or float16 (made row-contiguous if
    it is not), ``seg_ids`` int32 ``(n,)``; ids outside ``[0,
    num_segments)`` are dropped.  Returns float32 ``(num_segments, d)``,
    every element written by the one launch.  ``partition`` forces the
    direct (False) or the partitioned (True) launch, to time one against
    the other; by default :func:`plan_segment_sum` picks.  Launches on the
    current stream and does not synchronize.
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
    if d >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"x of shape {(n, d)} beyond int32 rows or features")
    device = seg_ids.device
    _check("seg_ids", seg_ids, torch.int32, (n,), device)
    _check("x", x, x.dtype, (n, d), device)
    if n == 0 or num_segments == 0 or d == 0:
        return torch.zeros(num_segments, d, dtype=torch.float32, device=device)
    x, seg_ids = x.contiguous(), seg_ids.contiguous()
    out = torch.empty(num_segments, d, dtype=torch.float32, device=device)
    plan = plan_segment_sum(n, d, num_segments, _sm_count(device), partition)
    lib, launch = _bind()
    with _on_device(device):
        parts = min(plan.parts, _setup(lib, device))
        scratch = None
        if parts:
            tiles = -(-num_segments // plan.ts)
            scratch = torch.empty(2 * n + tiles * (parts + 2) + 1,
                                  dtype=torch.int32, device=device)
        err = launch(_DTYPES[x.dtype], x.data_ptr(), seg_ids.data_ptr(), n, d,
                     num_segments, plan.ts, plan.tf, plan.cap, parts,
                     None if scratch is None else scratch.data_ptr(), out.data_ptr(),
                     torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment-sum kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def segment_sum_backward(grad: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """The segment sum's gradient with respect to its rows, float32 ``(n,
    d)``: row i takes ``grad[seg_ids[i]]``, a row whose id lies outside
    ``[0, num_segments)`` takes 0 (a zero row appended to ``grad`` is its
    spill).  Any device; no host sync."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    return F.pad(grad, (0, 0, 0, 1)).index_select(
        0, torch.where(ok, seg_ids, num_segments))


class SegmentSum(torch.autograd.Function):
    """``segment_matmul_cuda`` forward, :func:`segment_sum_backward`
    backward: ``SegmentSum.apply(x, seg_ids, num_segments)``."""

    @staticmethod
    def forward(ctx, x, seg_ids, num_segments):
        ctx.save_for_backward(seg_ids)
        ctx.attrs = (num_segments, x.dtype)
        return segment_matmul_cuda(x, seg_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        num_segments, dtype = ctx.attrs
        (seg_ids,) = ctx.saved_tensors
        return (segment_sum_backward(g, seg_ids, num_segments).to(dtype),
                None, None)
