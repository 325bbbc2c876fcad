"""Sort-once query planning — the port of ``repro/core/plan.py``.

One lexicographic (src, dst) sort exposes group structure at two
granularities at once: adjacent inequality on (src, dst) segments the
distinct links, and src groups are prefixes of the same order, so
per-source aggregates, fan-out and distinct sources come from the same
sorted stream with zero further sorts.  A ``SortedEdges`` value is that
stream plus both segmentations; the derivations reproduce the exact
``GroupResult``/``UniqueResult`` buffers of the reference.

The reference holds its three-sort budget by counting sorts in compiled
HLO (``count_hlo_sorts``).  PyTorch runs eagerly and has no HLO, so the
port counts the sort-family ATen calls that actually run
(:class:`SortCounter`, a ``TorchDispatchMode``).  ``torch.unique`` sorts
too (it is counted), which is why the plan path never calls it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .ops import (
    GroupResult,
    UniqueResult,
    _count,
    _iota,
    _scatter_firsts,
    groupby_aggregate,
    multi_key_sort,
    segment_ids_from_sorted,
    segment_sum,
)
from .table import Table

__all__ = [
    "SortedEdges",
    "sorted_edges",
    "plan_for_table",
    "link_groups",
    "lead_groups",
    "lead_fanout",
    "unique_lead",
    "unique_concat",
    "SortCounter",
]


@dataclasses.dataclass(frozen=True)
class SortedEdges:
    """One packed lex sort of an edge table, with both segmentations.

    ``key0``/``key1`` are the sorted leading/trailing endpoints (live prefix
    of ``n_valid`` rows), ``w`` the per-row weights and ``row`` the original
    row index of each sorted row.  ``seg``/``first``/``n_links`` segment the
    stream at (key0, key1) granularity, ``k0_seg``/``k0_first``/``n_k0`` at
    key0 granularity; padding rows carry segment id == capacity.
    """

    key0: torch.Tensor
    key1: torch.Tensor
    w: torch.Tensor
    row: torch.Tensor
    n_valid: torch.Tensor  # 0-d int32
    seg: torch.Tensor
    first: torch.Tensor
    n_links: torch.Tensor  # 0-d int32
    k0_seg: torch.Tensor
    k0_first: torch.Tensor
    n_k0: torch.Tensor  # 0-d int32

    @property
    def capacity(self) -> int:
        return self.key0.shape[0]

    def valid_rows(self) -> torch.Tensor:
        return _iota(self.capacity, self.key0.device) < self.n_valid

    def link_to_k0(self) -> torch.Tensor:
        """(capacity + 1,) map link id -> key0 group id (capacity for pad)."""
        cap = self.capacity
        dst = torch.where(self.first.bool(), self.seg, cap).long()
        out = torch.full((cap + 1,), cap, dtype=torch.int32,
                         device=self.key0.device)
        return out.scatter_(0, dst, self.k0_seg)


def sorted_edges(
    key0: torch.Tensor,
    key1: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    n_valid=None,
    valid_mask: Optional[torch.Tensor] = None,
) -> SortedEdges:
    """Build the plan: ONE packed (key0, key1) sort, both segmentations."""
    cap = key0.shape[0]
    device = key0.device
    if weights is None:
        weights = torch.ones(cap, dtype=torch.int32, device=device)
    if valid_mask is not None:
        n_valid = valid_mask.sum(dtype=torch.int32)
    else:
        n_valid = _count(n_valid, cap, device)
    (s0, s1), (sw, srow) = multi_key_sort(
        [key0, key1], [weights, _iota(cap, device)],
        n_valid=None if valid_mask is not None else n_valid,
        valid_mask=valid_mask,
    )
    seg, first, n_links = segment_ids_from_sorted([s0, s1], n_valid)
    k0_seg, k0_first, n_k0 = segment_ids_from_sorted([s0], n_valid)
    return SortedEdges(
        key0=s0, key1=s1, w=sw, row=srow, n_valid=n_valid,
        seg=seg, first=first, n_links=n_links,
        k0_seg=k0_seg, k0_first=k0_first, n_k0=n_k0,
    )


def plan_for_table(t: Table, lead: str = "src", trail: str = "dst") -> SortedEdges:
    """Plan over a packet table (weights = ``n_packets`` when present)."""
    w = t["n_packets"] if "n_packets" in t else None
    return sorted_edges(t[lead], t[trail], weights=w, n_valid=t.n_valid)


def _segsum(values: torch.Tensor, seg: torch.Tensor, cap: int) -> torch.Tensor:
    return segment_sum(values, seg, cap + 1)[:cap]


def link_groups(plan: SortedEdges, packets_name: str = "packets") -> GroupResult:
    """The traffic matrix A_t: ``groupby([key0, key1]).agg(count, sum(w))``."""
    cap = plan.capacity
    valid = plan.valid_rows()
    keys = (
        _scatter_firsts(plan.key0, plan.seg, plan.first, cap),
        _scatter_firsts(plan.key1, plan.seg, plan.first, cap),
    )
    aggs = {
        "count": _segsum(valid.to(torch.int32), plan.seg, cap),
        packets_name: _segsum(torch.where(valid, plan.w, 0), plan.seg, cap),
    }
    return GroupResult(keys=keys, aggs=aggs, n_groups=plan.n_links)


def lead_groups(plan: SortedEdges, packets_name: str = "packets") -> GroupResult:
    """``groupby([key0]).agg(count, sum(w))`` — zero additional sorts."""
    cap = plan.capacity
    valid = plan.valid_rows()
    keys = (_scatter_firsts(plan.key0, plan.k0_seg, plan.k0_first, cap),)
    aggs = {
        "count": _segsum(valid.to(torch.int32), plan.k0_seg, cap),
        packets_name: _segsum(torch.where(valid, plan.w, 0), plan.k0_seg, cap),
    }
    return GroupResult(keys=keys, aggs=aggs, n_groups=plan.n_k0)


def lead_fanout(plan: SortedEdges) -> GroupResult:
    """Distinct key1 per key0 (fan-out / fan-in): link-first flags summed
    into their key0 group — zero sorts."""
    cap = plan.capacity
    keys = (_scatter_firsts(plan.key0, plan.k0_seg, plan.k0_first, cap),)
    counts = _segsum(plan.first, plan.k0_seg, cap)
    return GroupResult(keys=keys, aggs={"count": counts}, n_groups=plan.n_k0)


def unique_lead(plan: SortedEdges) -> UniqueResult:
    """``unique(key0)`` with row multiplicities — zero additional sorts."""
    cap = plan.capacity
    valid = plan.valid_rows()
    return UniqueResult(
        values=_scatter_firsts(plan.key0, plan.k0_seg, plan.k0_first, cap),
        counts=_segsum(valid.to(torch.int32), plan.k0_seg, cap),
        weight_sums=None,
        n_unique=plan.n_k0,
    )


def unique_concat(
    a: torch.Tensor,
    b: torch.Tensor,
    n_valid,
    positions: Optional[torch.Tensor] = None,
    count_name: Optional[str] = "count",
) -> GroupResult:
    """Distinct values of ``concat(a, b)`` — ONE packed half-domain sort.

    ``a`` and ``b`` share a live prefix of ``n_valid`` rows; the two live
    blocks are compacted against each other with a gather so the (2*cap,)
    concat sorts with a plain prefix-validity key.  ``positions`` (laid out
    like the concat: a-rows then b-rows) adds a ``first_pos`` min aggregate,
    the streaming dictionary's first-appearance rule.
    """
    cap = a.shape[0]
    n_valid = _count(n_valid, cap, a.device)
    both = torch.cat([a, b])
    idx = _iota(2 * cap, a.device)
    shifted = torch.where(idx < n_valid, idx, idx - n_valid + cap)
    sel = torch.where(idx < 2 * n_valid, shifted, 0)
    values = None
    if positions is not None:
        values = {"first_pos": (positions[sel], "min")}
    return groupby_aggregate([both[sel]], values, n_valid=2 * n_valid,
                             count_name=count_name)


# ATen ops that sort (or hide a sort): each call counts once.
_SORT_OPS = frozenset({
    "sort", "argsort", "msort", "topk", "kthvalue", "median", "nanmedian",
    "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "unique_dim_consecutive",
})


class SortCounter(TorchDispatchMode):
    """Counts sort-family ATen calls with at least ``min_rows`` elements.

    ``with SortCounter() as c: analyze(...)`` then ``c.n`` — the port's
    counterpart of ``count_hlo_sorts``: what ran, not what was compiled.
    """

    def __init__(self, min_rows: int = 0):
        super().__init__()
        self.min_rows = min_rows
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in _SORT_OPS:
            if args and args[0].numel() >= self.min_rows:
                self.n += 1
        return func(*args, **(kwargs or {}))
