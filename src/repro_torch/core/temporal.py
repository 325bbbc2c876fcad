"""Multi-temporal windowed queries — the port of ``repro/core/temporal.py``.

Window w's links are the plan's links restricted to the rows that fall in
w, so every per-window statistic derives from the two already-sorted plans
with zero additional sorts.  Two such formulations, bit-identical:

  * **CSR path (default)** — masking the sorted stream to window w and
    segment-reducing gives A_w's entry values on the shared CSR skeleton.
    The reference walks the windows with ``lax.scan``; the port walks them
    with a Python loop that reuses O(capacity) buffers per window, so peak
    memory is O(nnz), independent of ``n_windows``.
  * **dense-grid path** (``method="grid"``, the pre-CSR A/B baseline) —
    four ``(n_windows + 1, capacity + 1)`` int32 grids a plan side, each
    built by one accumulating ``index_put_``; one pass, O(n_windows x
    capacity) peak memory.

Both equal the pre-plan :func:`windowed_queries_naive` (its (win, ...)-
leading group-bys take six sorts: the three-key one sorts in two passes).
Every sum is an integer sum, exact in any order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.ops import segmented_reduce
from .ops import _segment_extreme, groupby_aggregate, segment_sum
from .plan import SortedEdges, sorted_edges
from .table import Table

__all__ = [
    "window_ids",
    "windowed_queries",
    "windowed_queries_naive",
    "windowed_suite_from_plans",
]


def window_ids(ts: torch.Tensor, window_len: int, t0=None) -> torch.Tensor:
    """Map timestamps to consecutive window indices (t0 defaults to min ts)."""
    t0 = ts.min() if t0 is None else t0
    return torch.div(ts - t0, window_len, rounding_mode="floor").to(torch.int32)


def _side_stats_csr(
    plan: SortedEdges, win: torch.Tensor, n_windows: int,
    fused: bool = False, backend: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Per-window stats of one plan side off per-window CSR segments.

    ``fused=True`` folds the per-window slice select into the histogram
    kernel's gate epilogue: the window id rides as the gate value, so each
    window costs one kernel launch per reduction and no masked copies.
    Bit-identical to the unfused path: a row is gated out exactly when the
    unfused path would add a zero (``s_win == w`` implies validity, since
    invalid rows carry ``s_win == n_windows``), and the window total is
    re-derived as ``sum(link_pk)``, the same int32 additions reassociated.
    """
    cap = plan.capacity
    valid = plan.valid_rows()
    s_win = torch.where(
        valid, torch.clamp(win[plan.row.long()], 0, n_windows - 1), n_windows
    ).to(torch.int32)
    ones = valid.to(torch.int32)
    w_live = torch.where(valid, plan.w, 0)
    link2row = plan.link_to_k0()[:cap]

    def gated_sum(vals, seg, w):
        return segmented_reduce(
            vals, seg, cap + 1, op="sum", gate_ids=s_win, gate_value=w,
            out_dtype=torch.int32, backend=backend,
        )[:cap]

    stats = []
    for w in range(n_windows):
        if fused:
            link_cnt = gated_sum(ones, plan.seg, w)
            link_pk = gated_sum(w_live, plan.seg, w)
            row_cnt = gated_sum(ones, plan.k0_seg, w)
            row_pk = gated_sum(w_live, plan.k0_seg, w)
            pk_total = link_pk.sum(dtype=torch.int32)
        else:
            in_w = s_win == w
            rows_w = torch.where(in_w, ones, 0)
            pk_w = torch.where(in_w, w_live, 0)
            link_cnt = segment_sum(rows_w, plan.seg, cap + 1)[:cap]
            link_pk = segment_sum(pk_w, plan.seg, cap + 1)[:cap]
            row_cnt = segment_sum(rows_w, plan.k0_seg, cap + 1)[:cap]
            row_pk = segment_sum(pk_w, plan.k0_seg, cap + 1)[:cap]
            pk_total = pk_w.sum(dtype=torch.int32)
        present = link_cnt > 0
        # |A_w|_0·1 — degrees of the per-window pattern, reduced over rows
        fan = segment_sum(present.to(torch.int32), link2row, cap + 1)[:cap]
        stats.append(torch.stack([
            present.sum(dtype=torch.int32),          # |A_w|_0
            link_pk.max(),                           # max(A_w)
            (row_cnt > 0).sum(dtype=torch.int32),    # |A_w 1|_0 support
            row_pk.max(),                            # max(A_w 1)
            fan.max(),                               # max(|A_w|_0 1)
            pk_total,                                # 1^T A_w 1
        ]))
    cols = torch.stack(stats, dim=1)
    names = ("unique_links", "max_link_packets", "n_unique", "max_packets",
             "max_fanout", "valid_packets")
    return dict(zip(names, cols))


def _side_stats_grid(plan: SortedEdges, win: torch.Tensor,
                     n_windows: int) -> Dict[str, torch.Tensor]:
    """Per-window stats of one plan side via dense scatter grids: the
    (window, link) and (window, key0-group) row counts and packet sums,
    each one accumulating ``index_put_`` over the flattened index
    ``s_win * (capacity + 1) + segment``, then the per-window fan-out of
    the links present in each window.  ``win`` is the per-original-row
    window id; the plan's ``row`` payload routes it to sorted rows."""
    cap = plan.capacity
    device = plan.key0.device
    valid = plan.valid_rows()
    s_win = torch.where(
        valid, torch.clamp(win[plan.row.long()], 0, n_windows - 1), n_windows
    ).to(torch.int64)
    ones = valid.to(torch.int32)
    w_live = torch.where(valid, plan.w, 0)

    def grid(seg, vals):
        flat = torch.zeros((n_windows + 1) * (cap + 1), dtype=torch.int32,
                           device=device)
        flat.index_put_((s_win * (cap + 1) + seg.to(torch.int64),), vals,
                        accumulate=True)
        return flat.view(n_windows + 1, cap + 1)[:n_windows, :cap]

    link_rows = grid(plan.seg, ones)
    link_pk = grid(plan.seg, w_live)
    k0_rows = grid(plan.k0_seg, ones)
    k0_pk = grid(plan.k0_seg, w_live)
    present = link_rows > 0
    # distinct key1 per (window, key0): the links present in w, bucketed by
    # the link -> key0-group map
    fan = torch.zeros(n_windows, cap + 1, dtype=torch.int32, device=device)
    fan.index_add_(1, plan.link_to_k0()[:cap], present.to(torch.int32))
    return {
        "unique_links": present.sum(dim=1, dtype=torch.int32),
        "max_link_packets": link_pk.amax(dim=1),
        "n_unique": (k0_rows > 0).sum(dim=1, dtype=torch.int32),
        "max_packets": k0_pk.amax(dim=1),
        "max_fanout": fan[:, :cap].amax(dim=1),
        "valid_packets": segment_sum(w_live, s_win, n_windows + 1)[:n_windows],
    }


def windowed_suite_from_plans(
    plan_src: SortedEdges,
    plan_dst: SortedEdges,
    win: torch.Tensor,
    n_windows: int,
    method: str = "csr",
    fused: bool = False,
    backend: str = "auto",
) -> Dict[str, torch.Tensor]:
    """All scalar challenge statistics per window, off the shared plan pair.

    ``method="csr"`` (default) walks per-window CSR segments, O(nnz) peak
    memory; ``method="grid"`` is the dense-scatter A/B baseline, O(n_windows
    x capacity) peak memory, bit-identical results.  ``fused=True`` (CSR
    only) routes the per-window reductions through the histogram kernel's
    gate epilogue.
    """
    if method not in ("csr", "grid"):
        raise ValueError(f"unknown windowed method {method!r}")
    if fused and method != "csr":
        raise ValueError("fused windowed suite requires method='csr'")
    if method == "csr":
        s = _side_stats_csr(plan_src, win, n_windows, fused, backend)
        d = _side_stats_csr(plan_dst, win, n_windows, fused, backend)
    else:
        s = _side_stats_grid(plan_src, win, n_windows)
        d = _side_stats_grid(plan_dst, win, n_windows)
    return {
        "valid_packets": s["valid_packets"],
        "unique_links": s["unique_links"],
        "max_link_packets": s["max_link_packets"],
        "n_unique_sources": s["n_unique"],
        "n_unique_destinations": d["n_unique"],
        "max_source_packets": s["max_packets"],
        "max_source_fanout": s["max_fanout"],
        "max_destination_packets": d["max_packets"],
        "max_destination_fanin": d["max_fanout"],
    }


def windowed_queries(
    t: Table,
    window_len: int,
    n_windows: int,
    ts_col: str = "ts",
    t0=None,
    plans: Optional[Tuple[SortedEdges, SortedEdges]] = None,
    method: str = "csr",
    fused: bool = False,
    backend: str = "auto",
) -> Dict[str, torch.Tensor]:
    """All scalar challenge statistics per time window.

    Args mirror the reference: ``window_len`` in ts units, ``n_windows``
    static (extra windows are empty), ``t0`` the window origin (min ts by
    default; pass ``t0=0`` when ``ts_col`` already holds window ids),
    ``plans`` a pre-built plan pair so the suite costs zero extra sorts,
    ``method`` ``"csr"`` or ``"grid"`` (:func:`windowed_suite_from_plans`),
    ``fused`` the kernel gate epilogue, ``backend`` the kernel dispatch
    (``"auto"``/``"torch"``/``"cuda"``).

    Returns a dict of (n_windows,) int32 tensors: valid_packets,
    unique_links, max_link_packets, n_unique_sources,
    n_unique_destinations, max_source_packets, max_source_fanout,
    max_destination_packets, max_destination_fanin.
    """
    win = torch.clamp(window_ids(t[ts_col], window_len, t0=t0), 0, n_windows - 1)
    if plans is None:
        w = t["n_packets"] if "n_packets" in t else None
        plans = (
            sorted_edges(t["src"], t["dst"], weights=w, n_valid=t.n_valid),
            sorted_edges(t["dst"], t["src"], weights=w, n_valid=t.n_valid),
        )
    return windowed_suite_from_plans(
        plans[0], plans[1], win, n_windows, method=method, fused=fused,
        backend=backend,
    )


# ---------------------------------------------------------------------------
# pre-plan path: one (win, ...)-leading group-by sort per statistic family
# (the A/B baseline; results bit-identical to the plan path)
# ---------------------------------------------------------------------------

def _per_window_max(values: torch.Tensor, win_of_group: torch.Tensor,
                    mask: torch.Tensor, n_windows: int) -> torch.Tensor:
    """Max of a per-group statistic within each window; windows with no
    contributing group report 0 (the statistics are non-negative)."""
    seg = torch.where(mask, win_of_group, n_windows)
    vals = torch.where(mask, values, 0)
    return torch.clamp(_segment_extreme(
        vals, seg, n_windows + 1, "amax", torch.iinfo(vals.dtype).min
    )[:n_windows], min=0)


def windowed_queries_naive(
    t: Table,
    window_len: int,
    n_windows: int,
    ts_col: str = "ts",
    t0=None,
) -> Dict[str, torch.Tensor]:
    """Pre-plan windowed suite: five (win, ...)-leading group-bys, six sorts
    (the (win, src, dst) one takes two passes)."""
    w = (t["n_packets"] if "n_packets" in t
         else torch.ones(t.capacity, dtype=torch.int32, device=t.device))
    win = torch.clamp(window_ids(t[ts_col], window_len, t0=t0), 0, n_windows - 1)
    valid = t.valid_mask()
    win_seg = torch.where(valid, win, n_windows)

    def per_window_count(mask, keys):
        return segment_sum(mask.to(torch.int32), torch.where(mask, keys, n_windows),
                           n_windows + 1)[:n_windows]

    out: Dict[str, torch.Tensor] = {"valid_packets": segment_sum(
        torch.where(valid, w, 0), win_seg, n_windows + 1)[:n_windows]}

    # links: group by (window, src, dst) once; everything link-ish follows
    links = groupby_aggregate([win, t["src"], t["dst"]], {"packets": (w, "sum")},
                              n_valid=t.n_valid)
    lmask, lwin = links.mask(), links.keys[0]
    out["unique_links"] = per_window_count(lmask, lwin)
    out["max_link_packets"] = _per_window_max(links.aggs["packets"], lwin, lmask,
                                              n_windows)
    for side, col, col_idx in (("source", "src", 1), ("destination", "dst", 2)):
        # per-(window, endpoint) packet sums and distinct counts
        ep = groupby_aggregate([win, t[col]], {"packets": (w, "sum")},
                               n_valid=t.n_valid)
        m = ep.mask()
        out[f"n_unique_{side}s"] = per_window_count(m, ep.keys[0])
        out[f"max_{side}_packets"] = _per_window_max(ep.aggs["packets"],
                                                     ep.keys[0], m, n_windows)
        # fan-out / fan-in: distinct peers per (window, endpoint) over links
        fan = groupby_aggregate([lwin, links.keys[col_idx]], None,
                                n_valid=links.n_groups)
        fname = "max_source_fanout" if side == "source" else "max_destination_fanin"
        out[fname] = _per_window_max(fan.aggs["count"], fan.keys[0], fan.mask(),
                                     n_windows)
    return out
