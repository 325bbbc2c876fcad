"""Multi-temporal windowed queries — the port of the CSR path of
``repro/core/temporal.py``.

Window w's links are the plan's links restricted to the rows that fall in
w, so every per-window statistic derives from the two already-sorted plans
with zero additional sorts: masking the sorted stream to window w and
segment-reducing gives A_w's entry values on the shared CSR skeleton.  The
reference walks the windows with ``lax.scan``; the port walks them with a
Python loop that reuses O(capacity) buffers per window, so peak memory is
O(nnz), independent of ``n_windows``.

The dense-grid path (``method="grid"``) and the pre-plan naive path are not
ported yet (ROADMAP.md queue 1 item 3).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.ops import segmented_reduce
from .ops import segment_sum
from .plan import SortedEdges, sorted_edges
from .table import Table

__all__ = ["window_ids", "windowed_queries", "windowed_suite_from_plans"]


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


def windowed_suite_from_plans(
    plan_src: SortedEdges,
    plan_dst: SortedEdges,
    win: torch.Tensor,
    n_windows: int,
    method: str = "csr",
    fused: bool = False,
    backend: str = "auto",
) -> Dict[str, torch.Tensor]:
    """All scalar challenge statistics per window, off the shared plan pair
    (``method="csr"``; ``fused=True`` routes the per-window reductions
    through the histogram kernel's gate epilogue)."""
    if method != "csr":
        raise NotImplementedError(
            f"windowed method {method!r} is not ported yet "
            "(ROADMAP.md queue 1 item 3); use method='csr'")
    s = _side_stats_csr(plan_src, win, n_windows, fused, backend)
    d = _side_stats_csr(plan_dst, win, n_windows, fused, backend)
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
