"""Public kernel entry points with backend dispatch — the port of
``repro/kernels/ops.py`` (histogram family).

``backend`` picks the implementation:

  * ``"auto"``  — the CUDA kernel for a CUDA tensor, the plain version for a
                  CPU tensor: decided by the tensor's device and nothing else;
  * ``"torch"`` — the plain PyTorch version on any device (the A/B baseline,
                  the reference's ``"xla"``);
  * ``"cuda"``  — the CUDA kernel; raises on a CPU tensor.

The reference's ``"auto"`` adds a size heuristic (Pallas only up to 4,096
bins) that would keep the default run's 8,192 flat activity bins off the
kernel; the port has none, and no fallback: a kernel that fails to build or
launch raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .histogram import histogram_cuda

__all__ = ["histogram", "windowed_histogram", "segmented_reduce"]

_BACKENDS = ("auto", "torch", "cuda")


def _use_kernel(backend: str, x: torch.Tensor) -> bool:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{_BACKENDS}")
    return backend == "cuda" or (backend == "auto" and x.is_cuda)


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
    """1-D segmented sum: the histogram kernel with ``vals`` as weights, and
    ``ref.ref_histogram`` with them as its plain version.

    Empty segments are 0; ``retire`` defaults to 0; ``out_dtype`` (float32
    by default, or int32) is the accumulator on both paths, so int32 sums
    are exact at any count.  ``op="max"`` needs the segment-max kernel,
    which is not ported yet (ROADMAP.md queue 2 item 2).
    """
    if op != "sum":
        raise NotImplementedError(
            f"segmented_reduce(op={op!r}) is not ported yet: the max monoid "
            "comes with the segment-max kernel (ROADMAP.md queue 2 item 2)")
    impl = histogram_cuda if _use_kernel(backend, seg_ids) else ref.ref_histogram
    return impl(seg_ids, num_segments, vals, init=init, gate_ids=gate_ids,
                gate_value=gate_value, valid_mask=valid_mask,
                retire=0 if retire is None else retire, out_dtype=out_dtype)
