"""Plain PyTorch versions of the port's kernels — the counterpart of
``repro/kernels/ref.py``.

Each ``ref_*`` function states the kernel's contract in stock tensor ops.
It is what a kernel wrapper runs for a tensor on the CPU (the tests) and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ref_histogram"]


def ref_histogram(
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
    """Weighted histogram: ``out[b] = init[b] + sum_{i: ids[i]==b} w[i]``.

    The contract of ``repro/kernels/ref.py:35-127`` (histogram and
    ``segmented_reduce(op="sum")``): ids outside ``[0, num_bins)`` are
    dropped; with ``gate_ids``, rows with ``gate_ids[i] != gate_value`` are
    dropped too; ``init`` seeds the sum; bins where ``valid_mask`` is False
    take ``retire`` last, after the ``init`` fold.  Sums accumulate in
    ``out_dtype`` (float32 by default; int32 sums are exact at any count).
    """
    acc = torch.float32 if out_dtype is None else out_dtype
    w = (torch.ones(ids.shape, dtype=acc, device=ids.device)
         if weights is None else weights.to(acc))
    ok = (ids >= 0) & (ids < num_bins)
    if gate_ids is not None:
        ok = ok & (gate_ids == gate_value)
    out = torch.zeros(num_bins + 1, dtype=acc, device=ids.device).index_add_(
        0, torch.where(ok, ids, num_bins), torch.where(ok, w, 0))[:num_bins]
    if init is not None:
        out = init.to(acc) + out
    if valid_mask is not None:
        out = out.masked_fill(~valid_mask, retire)
    return out

