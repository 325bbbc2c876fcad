"""The Graph Challenge queries (paper Table III) — the port of
``repro/core/queries.py``.

All queries run on a packet table with ``src``, ``dst`` and optionally
``n_packets`` columns.  The traffic matrix ``A_t`` is the group-by of that
table on (src, dst) with packet sums.  Each Table III row has its per-query
function (destination-side queries are the ``src``/``dst`` swap); the suite
runs three ways, with bit-identical scalars:

  * off the sort-once plan (:func:`run_all_queries`, three sorts);
  * in the GraphBLAS matrix language over the plan's CSR pair
    (:func:`run_all_queries_csr`, the same three sorts);
  * pre-plan, one group-by sort per query family
    (:func:`run_all_queries_naive`, the A/B baseline).

The detection queries (:func:`top_k_drift`, :func:`new_talker_rate` and its
exact and sketch tiers) consume only key lists and cardinalities, so either
tier can answer them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels.ops import segmented_reduce
from .ops import (
    GroupResult,
    UniqueResult,
    _count,
    _iota,
    argmax_top_k,
    clamp_k,
    groupby_aggregate,
    isin,
    masked_max,
    semi_join,
    top_k,
    unique,
)
from .plan import (
    SortedEdges,
    lead_fanout,
    lead_groups,
    link_groups,
    plan_for_table,
    unique_concat,
)
from .sparse import CsrMatrix, csr_from_plan, degrees, reduce_rows
from .table import Table

__all__ = [
    "TopLinks",
    "top_links",
    "top_links_from_plan",
    "table_plans",
    "table_csrs",
    "traffic_matrix_csr",
    "scalar_queries_from_csrs",
    "run_all_queries_csr",
    "scalar_queries_from_plans",
    "packet_weights",
    "traffic_matrix",
    "valid_packets",
    "unique_links",
    "link_packets",
    "max_link_packets",
    "unique_sources",
    "unique_destinations",
    "unique_ips",
    "packets_per_source",
    "max_source_packets",
    "source_fanout",
    "max_source_fanout",
    "packets_per_destination",
    "max_destination_packets",
    "destination_fanin",
    "max_destination_fanin",
    "QueryResults",
    "run_all_queries",
    "run_all_queries_naive",
    "NaiveGroups",
    "naive_groups",
    "top_k_drift",
    "top_links_drift",
    "new_talker_rate",
    "new_talker_rate_exact",
    "new_talker_rate_sketch",
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


# --- whole-matrix queries ----------------------------------------------------

def valid_packets(t: Table) -> torch.Tensor:
    """sum_i sum_j A_t(i,j)  ==  1^T A_t 1  ==  df['n_packets'].sum()."""
    return torch.where(t.valid_mask(), packet_weights(t), 0).sum(
        dtype=torch.int32)


def unique_links(t: Table) -> torch.Tensor:
    """|A_t|_0  ==  df[['src','dst']].drop_duplicates().size."""
    return traffic_matrix(t).n_groups


def link_packets(t: Table) -> GroupResult:
    """A_t(i,j) as an explicit (src, dst, packets) edge list."""
    return traffic_matrix(t)


def max_link_packets(t: Table) -> torch.Tensor:
    """max_ij A_t(i,j)."""
    g = traffic_matrix(t)
    return masked_max(g.aggs["packets"], g.mask())


# --- source-side queries ------------------------------------------------------

def unique_sources(t: Table) -> UniqueResult:
    """|1^T A_t|_0 support  ==  df['src'].unique()."""
    return unique(t["src"], n_valid=t.n_valid)


def unique_destinations(t: Table) -> UniqueResult:
    return unique(t["dst"], n_valid=t.n_valid)


def unique_ips(t: Table) -> UniqueResult:
    """Distinct IPs across both endpoints (the anonymization domain): one
    packed concat sort, the third and last sort of the plan."""
    g = unique_concat(t["src"], t["dst"], t.n_valid)
    return UniqueResult(
        values=g.keys[0], counts=g.aggs["count"], weight_sums=None,
        n_unique=g.n_groups,
    )


def packets_per_source(t: Table) -> GroupResult:
    """A_t 1  ==  df.groupby('src') packet sums."""
    return groupby_aggregate(
        [t["src"]], {"packets": (packet_weights(t), "sum")}, n_valid=t.n_valid)


def max_source_packets(t: Table) -> torch.Tensor:
    """max(A_t 1)."""
    g = packets_per_source(t)
    return masked_max(g.aggs["packets"], g.mask())


def source_fanout(t: Table) -> GroupResult:
    """|A_t|_0 1 — distinct destinations per source: the link table
    grouped by src and counted."""
    links = traffic_matrix(t)
    return groupby_aggregate([links.keys[0]], None, n_valid=links.n_groups)


def max_source_fanout(t: Table) -> torch.Tensor:
    """max(|A_t|_0 1)."""
    g = source_fanout(t)
    return masked_max(g.aggs["count"], g.mask())


# --- heavy-hitter links --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopLinks:
    """The k heaviest (src, dst) links; slots past ``n_valid`` are padding."""

    src: torch.Tensor
    dst: torch.Tensor
    packets: torch.Tensor
    n_valid: torch.Tensor  # 0-d int32 == min(k, unique_links)


def _top_links_of(g: GroupResult, pk: torch.Tensor, idx: torch.Tensor,
                  n_live: torch.Tensor) -> TopLinks:
    keep = _iota(pk.shape[0], pk.device) < n_live
    idx = idx.long()
    return TopLinks(
        src=torch.where(keep, g.keys[0][idx], 0),
        dst=torch.where(keep, g.keys[1][idx], 0),
        packets=torch.where(keep, pk, 0),
        n_valid=n_live,
    )


def top_links(t: Table, k: int, links: Optional[GroupResult] = None) -> TopLinks:
    """``df.groupby(['src','dst']).size().nlargest(k)`` — heaviest links,
    by one stable descending sort of the link packet sums.  Ties break
    toward the lexicographically smallest (src, dst).  ``links`` is the
    traffic matrix when the caller already holds it."""
    g = traffic_matrix(t) if links is None else links
    pk, idx, n_live = top_k(g.aggs["packets"], clamp_k(k, t.capacity), g.mask())
    return _top_links_of(g, pk, idx, n_live)


def top_links_from_plan(
    plan: SortedEdges, k: int, links: Optional[GroupResult] = None,
    *, fused: bool = False, backend: str = "auto",
) -> TopLinks:
    """:func:`top_links` off a shared plan, sort-free (``argmax_top_k``).

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
    return _top_links_of(g, pk, idx, n_live)


# --- destination-side mirrors -------------------------------------------------

def _swapped(t: Table) -> Table:
    cols = dict(t.columns)
    cols["src"], cols["dst"] = cols["dst"], cols["src"]
    return Table(columns=cols, n_valid=t.n_valid)


def packets_per_destination(t: Table) -> GroupResult:
    return packets_per_source(_swapped(t))


def max_destination_packets(t: Table) -> torch.Tensor:
    return max_source_packets(_swapped(t))


def destination_fanin(t: Table) -> GroupResult:
    return source_fanout(_swapped(t))


def max_destination_fanin(t: Table) -> torch.Tensor:
    return max_source_fanout(_swapped(t))


# --- the full challenge query suite -------------------------------------------

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


# --- the matrix-language (GraphBLAS-lite CSR) formulation ---------------------

def traffic_matrix_csr(t: Table, plan: Optional[SortedEdges] = None) -> CsrMatrix:
    """A_t as a static-shape CSR (rows = src, cols = dst, vals = packets):
    one packed sort, none when ``plan`` is shared."""
    return csr_from_plan(plan_for_table(t) if plan is None else plan)


def table_csrs(
    t: Table, plans: Optional[Tuple[SortedEdges, SortedEdges]] = None
) -> Tuple[CsrMatrix, CsrMatrix]:
    """(A_t, A_t^T) as CSRs off the shared plan pair — zero extra sorts."""
    plan_src, plan_dst = table_plans(t) if plans is None else plans
    return csr_from_plan(plan_src), csr_from_plan(plan_dst)


def scalar_queries_from_csrs(
    t: Table,
    csr_src: CsrMatrix,
    csr_dst: CsrMatrix,
    ips: Optional[UniqueResult] = None,
) -> QueryResults:
    """All ten Table III scalars in matrix language over the CSR pair —
    1^T A 1, |A|_0, max(A), A·1, |A|_0·1 and the transpose mirrors as CSR
    reductions, no sort beyond the plans (and ``unique_ips``'s when ``ips``
    is not given)."""
    if ips is None:
        ips = unique_ips(t)
    out_pk = reduce_rows(csr_src, "plus")       # A·1
    in_pk = reduce_rows(csr_dst, "plus")        # 1^T·A (transpose rows)
    fanout = degrees(csr_src)                   # |A|_0·1
    fanin = degrees(csr_dst)                    # 1^T·|A|_0
    src_mask = csr_src.row_mask()
    dst_mask = csr_dst.row_mask()
    return QueryResults(
        valid_packets=torch.where(csr_src.entry_mask(), csr_src.vals, 0).sum(
            dtype=torch.int32),                 # 1^T A 1
        unique_links=csr_src.nnz,               # |A|_0
        max_link_packets=masked_max(csr_src.vals, csr_src.entry_mask()),
        n_unique_sources=csr_src.n_rows,        # |A 1|_0 support
        n_unique_destinations=csr_dst.n_rows,
        n_unique_ips=ips.n_unique,
        max_source_packets=masked_max(out_pk, src_mask),
        max_source_fanout=masked_max(fanout, src_mask),
        max_destination_packets=masked_max(in_pk, dst_mask),
        max_destination_fanin=masked_max(fanin, dst_mask),
    )


def run_all_queries_csr(
    t: Table, plans: Optional[Tuple[SortedEdges, SortedEdges]] = None
) -> QueryResults:
    """:func:`run_all_queries` through the CSR matrix language: the same
    three sorts, bit-identical scalars."""
    csr_src, csr_dst = table_csrs(t, plans)
    return scalar_queries_from_csrs(t, csr_src, csr_dst)


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
    return _scalars(t, links, per_src, per_dst, fanout, fanin,
                    unique_ips(t) if ips is None else ips)


def _scalars(t: Table, links: GroupResult, per_src: GroupResult,
             per_dst: GroupResult, fanout: GroupResult, fanin: GroupResult,
             ips: UniqueResult) -> QueryResults:
    """The ten scalars from the group results, however they were sorted."""
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


def run_all_queries(
    t: Table, plans: Optional[Tuple[SortedEdges, SortedEdges]] = None
) -> QueryResults:
    """Every scalar challenge statistic off one src-leading and one
    dst-leading packed sort plus the concat sort of ``unique_ips``; pass
    ``plans`` to share the pair with other consumers."""
    plan_src, plan_dst = table_plans(t) if plans is None else plans
    return scalar_queries_from_plans(t, plan_src, plan_dst)


class NaiveGroups(NamedTuple):
    """The pre-plan group-bys of the scalar suite, one sort each."""

    links: GroupResult
    per_src: GroupResult
    per_dst: GroupResult
    fanout: GroupResult
    fanin: GroupResult


def naive_groups(t: Table) -> NaiveGroups:
    """The traffic matrix, per-source and per-destination packet sums, and
    fan-out and fan-in (the link table grouped by each endpoint): five
    independent group-by sorts, each computed once.  Under ``jit`` the
    reference's naive path leaves XLA to dedupe the group-bys that several
    of its queries repeat; the eager port computes each once and passes it
    on, which is what that dedup leaves."""
    links = traffic_matrix(t)
    return NaiveGroups(
        links=links,
        per_src=packets_per_source(t),
        per_dst=packets_per_destination(t),
        fanout=groupby_aggregate([links.keys[0]], None, n_valid=links.n_groups),
        fanin=groupby_aggregate([links.keys[1]], None, n_valid=links.n_groups),
    )


def run_all_queries_naive(t: Table,
                          groups: Optional[NaiveGroups] = None) -> QueryResults:
    """Pre-plan implementation, the A/B baseline of :func:`run_all_queries`:
    one independent group-by sort per query family (the five of
    :func:`naive_groups`, or none when ``groups`` is given, and the concat
    sort of ``unique_ips``); bit-identical results."""
    g = naive_groups(t) if groups is None else groups
    return _scalars(t, *g, unique_ips(t))


# --- detection queries (tier-agnostic) ----------------------------------------
#
# Each detector consumes only summaries — key lists and cardinalities — so
# the same function answers on the exact tier (TopLinks / UniqueResult) and
# on the sketch tier (space-saving tables / HyperLogLog registers,
# core.sketch), with that tier's error bounds.

def top_k_drift(
    prev_keys: Sequence[torch.Tensor],
    prev_n,
    cur_keys: Sequence[torch.Tensor],
    cur_n,
) -> torch.Tensor:
    """Fraction of the current top-k keys absent from the previous top-k
    (multi-column keys allowed): float32 in [0, 1], 0 when the current set
    is empty."""
    device = cur_keys[0].device
    cur_n = _count(cur_n, 0, device)
    member = semi_join(cur_keys, prev_keys, cur_n, prev_n)
    live = _iota(cur_keys[0].shape[0], device) < cur_n
    n_new = (live & ~member).sum(dtype=torch.int32)
    return n_new.to(torch.float32) / torch.clamp(cur_n, min=1).to(torch.float32)


def top_links_drift(prev: TopLinks, cur: TopLinks) -> torch.Tensor:
    """:func:`top_k_drift` over two heavy-link reports (either tier)."""
    return top_k_drift([prev.src, prev.dst], prev.n_valid,
                       [cur.src, cur.dst], cur.n_valid)


def new_talker_rate(prev_card, union_card, cur_card) -> torch.Tensor:
    """Share of this window's distinct sources never seen before,
    ``(|prev ∪ cur| - |prev|) / |cur|`` in float32, clipped to [0, 1]."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    rate = (f32(union_card) - f32(prev_card)) / torch.clamp(f32(cur_card), min=1.0)
    return torch.clamp(rate, 0.0, 1.0)


def new_talker_rate_exact(prev: UniqueResult, cur: UniqueResult) -> torch.Tensor:
    """Exact-tier new-talker rate: this window's distinct sources probed
    against the previous window's (one binary search per key)."""
    member = isin(cur.values, prev.values, prev.n_unique, cur.n_unique)
    live = cur.mask()
    n_new = (live & ~member).sum(dtype=torch.int32)
    return n_new.to(torch.float32) / torch.clamp(
        cur.n_unique.to(torch.float32), min=1.0)


def new_talker_rate_sketch(prev_registers: torch.Tensor,
                           cur_registers: torch.Tensor) -> torch.Tensor:
    """Sketch-tier new-talker rate from two HyperLogLog register banks: the
    union is their element-wise max, so the rate is three cardinalities of
    fixed-size state."""
    from .sketch import hll_cardinality

    return new_talker_rate(
        hll_cardinality(prev_registers),
        hll_cardinality(torch.maximum(prev_registers, cur_registers)),
        hll_cardinality(cur_registers))
