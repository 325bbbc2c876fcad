"""Public kernel entry points with backend dispatch — the port of
``repro/kernels/ops.py`` (the histogram, segment-max, sketch, segment-sum
and attention families).

``backend`` picks the implementation:

  * ``"auto"``  — the CUDA kernel for a CUDA tensor, the plain version for a
                  CPU tensor: decided by the tensor's device and nothing else;
  * ``"torch"`` — the plain PyTorch version on any device (the A/B baseline,
                  the reference's ``"xla"``);
  * ``"cuda"``  — the CUDA kernel; raises on a CPU tensor.

The reference's ``"auto"`` adds a size heuristic (Pallas only up to 4,096
bins) that would keep the default run's 8,192 flat activity bins, and the
vxm's ``2 * capacity`` vertex slots, off the kernels; the port has none,
and no fallback: a kernel that fails to build or launch raises.  The same
holds for :func:`segment_reduce`: the reference keeps its one-hot matmul to
``_MATMUL_SEGMENT_LIMIT`` segments because that kernel's work grows with
the segment count.  The CUDA kernel does no one-hot work; its blocks find
their tiles' rows either by reading every id, which costs n ids a tile and
serves only small n, or from a sort of the rows by tile made in the same
launch, whose cost does not grow with the tiles;
``segment_matmul.plan_segment_sum`` picks by n and the tiles, so it serves
every size.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import FlashAttention, flash_attention_cuda
from .histogram import histogram_cuda
from .segment_matmul import SegmentSum, segment_matmul_cuda
from .segreduce import SegmentMax, segment_max_cuda, segment_max_features_cuda
from .sketch import cms_update_cuda, hll_update_cuda

__all__ = ["histogram", "windowed_histogram", "segmented_reduce",
           "cms_update", "hll_update", "segment_reduce", "attention"]

_BACKENDS = ("auto", "torch", "cuda")


def _use_kernel(backend: str, x: torch.Tensor) -> bool:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{_BACKENDS}")
    return backend == "cuda" or (backend == "auto" and x.is_cuda)


def _records(*xs: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``xs``."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def histogram(
    ids: torch.Tensor,
    num_bins: int,
    weights: Optional[torch.Tensor] = None,
    *,
    init: Optional[torch.Tensor] = None,
    gate_ids: Optional[torch.Tensor] = None,
    gate_value=None,
    valid_mask: Optional[torch.Tensor] = None,
    retire: float = 0.0,
    backend: str = "auto",
) -> torch.Tensor:
    """Weighted float32 histogram with the fused epilogues: ``init`` seeds
    the sum, ``gate_ids``/``gate_value`` drop rows, ``valid_mask`` +
    ``retire`` overwrite masked-out bins last."""
    impl = histogram_cuda if _use_kernel(backend, ids) else ref.ref_histogram
    return impl(ids, num_bins, weights, init=init, gate_ids=gate_ids,
                gate_value=gate_value, valid_mask=valid_mask, retire=retire)


def windowed_histogram(
    win: torch.Tensor,
    ids: torch.Tensor,
    n_windows: int,
    num_bins: int,
    weights: Optional[torch.Tensor] = None,
    *,
    init: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Per-window histograms in ONE kernel launch over the flattened bin
    space ``win * num_bins + id``.  Rows with ``win`` or ``ids`` out of
    range are dropped; ``init`` has shape ``(n_windows, num_bins)``.
    Returns float32 of shape ``(n_windows, num_bins)``."""
    ok = (win >= 0) & (win < n_windows) & (ids >= 0) & (ids < num_bins)
    flat_ids = torch.where(
        ok, win.to(torch.int32) * num_bins + ids.to(torch.int32), -1
    ).to(torch.int32)
    flat_init = None if init is None else init.reshape(n_windows * num_bins)
    flat = histogram(flat_ids, n_windows * num_bins, weights, init=flat_init,
                     backend=backend)
    return flat.reshape(n_windows, num_bins)


def segmented_reduce(
    vals: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    *,
    op: str = "sum",
    init: Optional[torch.Tensor] = None,
    gate_ids: Optional[torch.Tensor] = None,
    gate_value=None,
    valid_mask: Optional[torch.Tensor] = None,
    retire=None,
    out_dtype: Optional[torch.dtype] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """1-D segmented reduction under the plus or max monoid.

    ``op="sum"`` is the histogram kernel with ``vals`` as weights
    (``ref.ref_histogram`` its plain version): empty segments are 0,
    ``retire`` defaults to 0, and ``out_dtype`` (float32 by default, or
    int32) is the accumulator on both paths, so int32 sums are exact at any
    count.  ``op="max"`` is the segment-max kernel (``ref.ref_segment_max``):
    float32, empty segments ``-inf``, ``retire`` defaults to ``-inf``, and
    ``out_dtype`` raises, as in the reference (``-inf`` has no integer
    image).  ``init`` folds a running accumulator in; ``gate_ids`` /
    ``gate_value`` drop rows; ``valid_mask`` + ``retire`` overwrite
    masked-out segments last.
    """
    kw = dict(init=init, gate_ids=gate_ids, gate_value=gate_value,
              valid_mask=valid_mask)
    if op == "max":
        if out_dtype is not None:
            raise ValueError("out_dtype is only supported for op='sum' (the "
                             "max identity -inf has no integer image)")
        impl = (segment_max_cuda if _use_kernel(backend, seg_ids)
                else ref.ref_segment_max)
        return impl(vals, seg_ids, num_segments,
                    retire=float("-inf") if retire is None else retire, **kw)
    if op != "sum":
        raise ValueError(f"unknown segmented-reduce op {op!r}")
    impl = histogram_cuda if _use_kernel(backend, seg_ids) else ref.ref_histogram
    return impl(seg_ids, num_segments, vals, retire=0 if retire is None else retire,
                out_dtype=out_dtype, **kw)


def cms_update(
    counts: torch.Tensor,
    col_ids: torch.Tensor,
    proposals: torch.Tensor,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """Conservative-update Count-Min fold: the cell-wise max of the running
    ``(depth, width)`` counts and the scatter-max of ``proposals`` through
    each depth row's hashed ``col_ids`` (``-1`` = masked), in one launch."""
    impl = cms_update_cuda if _use_kernel(backend, counts) else ref.ref_cms_update
    return impl(counts, col_ids, proposals)


def hll_update(
    registers: torch.Tensor,
    reg_ids: torch.Tensor,
    rhos: torch.Tensor,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """HyperLogLog register fold: the segment max with the running
    registers as ``init`` (the segment-max kernel on the card)."""
    impl = hll_update_cuda if _use_kernel(backend, reg_ids) else ref.ref_hll_update
    return impl(registers, reg_ids, rhos)


def segment_reduce(
    x: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    *,
    op: str = "sum",
    backend: str = "auto",
) -> torch.Tensor:
    """Feature aggregation (GNN message passing) of ``(n, d)`` rows into
    ``(num_segments, d)``: ``op="sum"`` gives ``out[s, :] = sum_{i:
    seg_ids[i]==s} x[i, :]`` (empty segments 0; the segment-sum kernel,
    ``ref.ref_segment_matmul`` its plain version), ``op="max"`` the
    feature-wise max (empty segments ``-inf``; the segment-max kernel over
    flattened ids, ``ref.ref_segment_max_features``).  Ids outside ``[0,
    num_segments)`` are dropped; the result is float32 on both paths, as
    the TPU kernel returns it.  Where autograd records, the kernel runs as
    the forward of ``SegmentSum`` or ``SegmentMax``, whose backward gives
    plain autograd's gradient bit for bit; the plain versions are
    differentiable as they are."""
    if op == "sum":
        plain, kernel, function = (ref.ref_segment_matmul, segment_matmul_cuda,
                                   SegmentSum)
    elif op == "max":
        plain, kernel, function = (ref.ref_segment_max_features,
                                   segment_max_features_cuda, SegmentMax)
    else:
        raise ValueError(f"unknown segment-reduce op {op!r}")
    if not _use_kernel(backend, seg_ids):
        return plain(x, seg_ids, num_segments)
    if _records(x):
        return function.apply(x, seg_ids, num_segments)
    return kernel(x, seg_ids, num_segments)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """(Grouped-query) attention, q ``(B, Hq, Lq, D)`` against k, v ``(B,
    Hkv, Lkv, D)``, the ends of the two ranges aligned; ``causal`` and
    ``window`` (keys in ``(pos - window, pos]``) mask; float32 softmax, q's
    type out.  The kernel reads strided views (a cut of a KV cache) in
    place.  Where autograd records (grad enabled and an operand requiring
    it) the kernel runs as the forward of ``FlashAttention``, whose
    backward is the plain version's autograd, as the reference's
    ``custom_vjp``; the plain version is differentiable as it is."""
    if not _use_kernel(backend, q):
        return ref.ref_attention(q, k, v, causal=causal, window=window, scale=scale)
    if _records(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
