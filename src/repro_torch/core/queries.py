"""The Graph Challenge queries (paper Table III) — the port of the plan-path
subset of ``repro/core/queries.py``.

All queries run on a packet table with ``src``, ``dst`` and optionally
``n_packets`` columns.  The traffic matrix ``A_t`` is the group-by of that
table on (src, dst) with packet sums.  The CSR formulation of the reference
(``queries.py:325-390``) waits for the port of ``core/sparse.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..kernels.ops import segmented_reduce
from .ops import (
    GroupResult,
    UniqueResult,
    _iota,
    argmax_top_k,
    clamp_k,
    groupby_aggregate,
    masked_max,
)
from .plan import (
    SortedEdges,
    lead_fanout,
    lead_groups,
    link_groups,
    plan_for_table,
    unique_concat,
)
from .sparse import CsrMatrix, csr_from_plan
from .table import Table

__all__ = [
    "TopLinks",
    "top_links_from_plan",
    "table_plans",
    "table_csrs",
    "scalar_queries_from_plans",
    "packet_weights",
    "traffic_matrix",
    "valid_packets",
    "unique_ips",
    "QueryResults",
]


def packet_weights(t: Table) -> torch.Tensor:
    """Per-row packet multiplicity (1 if the table is one-row-per-packet)."""
    if "n_packets" in t:
        return t["n_packets"]
    return torch.ones(t.capacity, dtype=torch.int32, device=t.device)


def traffic_matrix(t: Table) -> GroupResult:
    """A_t(i,j) — ``df.groupby(['src','dst']).value_counts()``: group keys
    (src, dst) and agg ``packets`` = link packet counts."""
    return groupby_aggregate(
        [t["src"], t["dst"]],
        {"packets": (packet_weights(t), "sum")},
        n_valid=t.n_valid,
    )


def valid_packets(t: Table) -> torch.Tensor:
    """sum_i sum_j A_t(i,j)  ==  1^T A_t 1  ==  df['n_packets'].sum()."""
    return torch.where(t.valid_mask(), packet_weights(t), 0).sum(
        dtype=torch.int32)


def unique_ips(t: Table) -> UniqueResult:
    """Distinct IPs across both endpoints (the anonymization domain): one
    packed concat sort, the third and last sort of the plan."""
    g = unique_concat(t["src"], t["dst"], t.n_valid)
    return UniqueResult(
        values=g.keys[0], counts=g.aggs["count"], weight_sums=None,
        n_unique=g.n_groups,
    )


@dataclasses.dataclass(frozen=True)
class TopLinks:
    """The k heaviest (src, dst) links; slots past ``n_valid`` are padding."""

    src: torch.Tensor
    dst: torch.Tensor
    packets: torch.Tensor
    n_valid: torch.Tensor  # 0-d int32 == min(k, unique_links)


def top_links_from_plan(
    plan: SortedEdges, k: int, links: Optional[GroupResult] = None,
    *, fused: bool = False, backend: str = "auto",
) -> TopLinks:
    """The k heaviest links off a shared plan, sort-free (``argmax_top_k``).

    Ties break toward the lexicographically smallest (src, dst): group keys
    are emitted sorted and argmax takes the first maximum.

    ``fused=True`` takes the per-link packet sums from the histogram
    kernel's ``valid_mask``/``retire`` epilogue (dead slots already retired
    to the int32 min) and the plan's known live count in place of the mask
    recount.  Bit-identical to the unfused path.
    """
    g = link_groups(plan) if links is None else links
    k = clamp_k(k, plan.capacity)
    if fused:
        cap = plan.capacity
        imin = torch.iinfo(torch.int32).min
        pk_buf = segmented_reduce(
            plan.w, plan.seg, cap + 1, op="sum",
            valid_mask=_iota(cap + 1, plan.w.device) < plan.n_links,
            retire=imin, out_dtype=torch.int32, backend=backend,
        )[:cap]
        pk, idx, n_live = argmax_top_k(pk_buf, k, n_valid=plan.n_links)
    else:
        pk, idx, n_live = argmax_top_k(g.aggs["packets"], k, g.mask())
    keep = _iota(k, plan.w.device) < n_live
    idx = idx.long()
    return TopLinks(
        src=torch.where(keep, g.keys[0][idx], 0),
        dst=torch.where(keep, g.keys[1][idx], 0),
        packets=torch.where(keep, pk, 0),
        n_valid=n_live,
    )


@dataclasses.dataclass(frozen=True)
class QueryResults:
    """Scalar results of the challenge suite (0-d tensors)."""

    valid_packets: torch.Tensor
    unique_links: torch.Tensor
    max_link_packets: torch.Tensor
    n_unique_sources: torch.Tensor
    n_unique_destinations: torch.Tensor
    n_unique_ips: torch.Tensor
    max_source_packets: torch.Tensor
    max_source_fanout: torch.Tensor
    max_destination_packets: torch.Tensor
    max_destination_fanin: torch.Tensor

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dataclasses.asdict(self)


def table_plans(t: Table) -> Tuple[SortedEdges, SortedEdges]:
    """The (src-leading, dst-leading) plan pair the whole suite shares."""
    return plan_for_table(t, "src", "dst"), plan_for_table(t, "dst", "src")


def table_csrs(
    t: Table, plans: Optional[Tuple[SortedEdges, SortedEdges]] = None
) -> Tuple[CsrMatrix, CsrMatrix]:
    """(A_t, A_t^T) as CSRs off the shared plan pair — zero extra sorts."""
    plan_src, plan_dst = table_plans(t) if plans is None else plans
    return csr_from_plan(plan_src), csr_from_plan(plan_dst)


def scalar_queries_from_plans(
    t: Table,
    plan_src: SortedEdges,
    plan_dst: SortedEdges,
    ips: Optional[UniqueResult] = None,
    *,
    links: Optional[GroupResult] = None,
    per_src: Optional[GroupResult] = None,
    per_dst: Optional[GroupResult] = None,
    fanout: Optional[GroupResult] = None,
    fanin: Optional[GroupResult] = None,
) -> QueryResults:
    """All ten Table III scalars off the shared plans: zero sorts beyond the
    plans (+ the concat sort of ``unique_ips`` when ``ips`` is not given).
    Callers that already derived the group results pass them in, so the
    eager port does not repeat the segment reductions."""
    links = link_groups(plan_src) if links is None else links
    per_src = lead_groups(plan_src) if per_src is None else per_src
    per_dst = lead_groups(plan_dst) if per_dst is None else per_dst
    fanout = lead_fanout(plan_src) if fanout is None else fanout
    fanin = lead_fanout(plan_dst) if fanin is None else fanin
    if ips is None:
        ips = unique_ips(t)
    return QueryResults(
        valid_packets=valid_packets(t),
        unique_links=links.n_groups,
        max_link_packets=masked_max(links.aggs["packets"], links.mask()),
        n_unique_sources=per_src.n_groups,
        n_unique_destinations=per_dst.n_groups,
        n_unique_ips=ips.n_unique,
        max_source_packets=masked_max(per_src.aggs["packets"], per_src.mask()),
        max_source_fanout=masked_max(fanout.aggs["count"], fanout.mask()),
        max_destination_packets=masked_max(per_dst.aggs["packets"], per_dst.mask()),
        max_destination_fanin=masked_max(fanin.aggs["count"], fanin.mask()),
    )
