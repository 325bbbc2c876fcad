"""End-to-end Anonymized Network Sensing pipeline — the port of
``repro/challenge/pipeline.py``.

The challenge is measured as one workload, timed as phases of a single run:

  read       host I/O — generate-or-reuse a synthetic RMAT capture, store it
             columnar (plq) or row-major (pcaplite), read it back;
  build      window ids, the transfer to the device and the (src, dst)
             group-by that materializes the traffic matrix A_t;
  anonymize  unique -> permutation -> gather over the IP domain;
  analyze    every Table III query off the sort-once plan (three sorts), the
             CSR windowed suite, top-k heaviest links, cross-window IP
             overlap, and the per-window activity histogram in one launch of
             the CUDA histogram kernel (kernels/ops.windowed_histogram);
             with ``algorithms=True`` also BFS, connected components,
             PageRank and triangle counts over the anonymized traffic graph
             (core/algorithms, through the segment-max and histogram
             kernels), still in three sorts.

PyTorch launches asynchronously, so every phase span ends with
``torch.cuda.synchronize()`` on the card — the counterpart of the
reference's ``block_until_ready`` — or the walls would time launches, not
work.  The warm pass (``ChallengeConfig.warm``) runs every phase once before
the timed pass; it builds the CUDA kernel and warms the allocator, and its
wall is reported as ``compile_s``.

``fused=True`` also times build's device part, anonymize and analyze as one
program (``fused_s``), the counterpart of the reference's one jitted,
donated program: on the card one CUDA graph of the three
(:func:`fused_program`).  ``analyze(use_plan=False)`` and
``windowed_method="grid"`` are the A/B baselines of the sort-once plan and
of the CSR windowed suite.  ``distributed=True`` is not ported yet
(ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import table_from_numpy
from ..core.algorithms import AlgorithmResults, graph_algorithms
from ..core.anonymize import anonymize
from ..core.ops import (GroupResult, UniqueResult, factorize, groupby_aggregate,
                        mix32, semi_join, unique)
from ..core.plan import (SortedEdges, lead_fanout, lead_groups, link_groups,
                         unique_lead)
from ..core.queries import (
    QueryResults,
    TopLinks,
    naive_groups,
    packet_weights,
    run_all_queries_naive,
    scalar_queries_from_plans,
    table_csrs,
    table_plans,
    top_links,
    top_links_from_plan,
    traffic_matrix,
    unique_ips,
)
from ..core.table import Table, resolve_device
from ..core.temporal import windowed_queries, windowed_queries_naive
from ..data import pcaplite
from ..data.plq import read_plq, write_plq
from ..data.rmat import synthetic_packets
from ..kernels.ops import histogram, windowed_histogram
from ..obs import span as obs_span

__all__ = [
    "ChallengeConfig",
    "ChallengePhaseTimings",
    "ChallengeResults",
    "ChallengeRun",
    "algorithm_pass",
    "analyze",
    "build_columns",
    "cross_window_ip_overlap",
    "cross_window_ip_overlap_naive",
    "fused_program",
    "read_phase",
    "run_challenge",
    "timings_from_spans",
    "window_column",
]

PHASES = ("read", "build", "anonymize", "analyze")


@dataclasses.dataclass(frozen=True)
class ChallengeConfig:
    """One end-to-end challenge run.

    ``scale`` plays the Graph500 role: 2**scale packets over 2**scale RMAT
    vertices.  ``n_packets`` overrides the packet count independently of the
    vertex scale.  ``device`` is where the table lives and the compute
    phases run: ``"cuda"`` by default, ``"cpu"`` only when asked for.
    """

    scale: int = 14
    n_packets: Optional[int] = None
    capacity: Optional[int] = None       # static table rows (>= n_packets)
    n_windows: int = 8                   # temporal windows (static)
    ip_bins: int = 1024                  # hashed per-window activity bins
    top_k: int = 10                      # heaviest links to report
    method: str = "shuffle"              # 'shuffle' | 'hash' (core/anonymize)
    rounds: int = 1
    warm: bool = True                    # run every phase once before timing
    seed: int = 0
    fmt: str = "plq"                     # 'plq' | 'pcaplite'
    backend: str = "auto"                # histogram dispatch: auto|torch|cuda
    fused: bool = False                  # also time the one-program path
    fused_epilogue: bool = False         # kernel epilogues in analyze
    algorithms: bool = False             # BFS/CC/PageRank/triangles pass
    bfs_source: int = 0                  # BFS source (anonymized vertex id)
    workdir: Optional[str] = None        # capture cache dir (tmp if None)
    device: str = "cuda"

    def __post_init__(self):
        if self.packets < 1:
            raise ValueError("need at least 1 packet (the static-shape engine "
                             "has no zero-capacity buffers)")
        for field in ("n_windows", "ip_bins", "top_k"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1")

    @property
    def packets(self) -> int:
        return self.n_packets if self.n_packets is not None else 1 << self.scale

    @property
    def table_capacity(self) -> int:
        cap = self.capacity if self.capacity is not None else self.packets
        if cap < self.packets:
            raise ValueError(f"capacity {cap} < n_packets {self.packets}")
        return cap

    def capture_path(self, workdir: str) -> str:
        name = f"capture_s{self.scale}_n{self.packets}_seed{self.seed}.{self.fmt}"
        return os.path.join(workdir, name)


@dataclasses.dataclass
class ChallengePhaseTimings:
    """Per-phase wall seconds + derived throughput (paper-table shape)."""

    n_packets: int
    read_s: float
    build_s: float
    anonymize_s: float
    analyze_s: float
    fused_s: Optional[float] = None      # one-program build+anonymize+analyze
    compile_s: Optional[float] = None    # warm pass, excluded from the walls

    @property
    def total_s(self) -> float:
        return self.read_s + self.build_s + self.anonymize_s + self.analyze_s

    def packets_per_s(self, phase: str = "total") -> float:
        s = self.total_s if phase == "total" else getattr(self, f"{phase}_s")
        return self.n_packets / s if s and s > 0 else float("inf")

    def as_dict(self) -> Dict[str, float]:
        d = {f"{p}_s": getattr(self, f"{p}_s") for p in PHASES}
        d["total_s"] = self.total_s
        if self.fused_s is not None:
            d["fused_s"] = self.fused_s
        if self.compile_s is not None:
            d["compile_s"] = self.compile_s
        return d

    def format_table(self) -> str:
        rows = [f"{'phase':12s}{'seconds':>12s}{'packets/sec':>16s}"]
        for p in PHASES:
            s = getattr(self, f"{p}_s")
            rows.append(f"{p:12s}{s:12.4f}{self.n_packets / max(s, 1e-12):16,.0f}")
        rows.append(
            f"{'total':12s}{self.total_s:12.4f}"
            f"{self.n_packets / max(self.total_s, 1e-12):16,.0f}"
        )
        if self.fused_s is not None:
            rows.append(
                f"{'fused(b+a+a)':12s}{self.fused_s:12.4f}"
                f"{self.n_packets / max(self.fused_s, 1e-12):16,.0f}"
            )
        if self.compile_s is not None:
            rows.append(f"{'(warm pass)':12s}{self.compile_s:12.4f}"
                        f"{'excluded above':>16s}")
        return "\n".join(rows)


def timings_from_spans(records) -> ChallengePhaseTimings:
    """Rebuild :class:`ChallengePhaseTimings` from exported span records:
    the LAST completed ``challenge`` span group, bit-identical to the
    ``ChallengeRun.timings`` of that run (both read the same durations)."""
    group: Dict[str, dict] = {}
    last: Optional[Dict[str, dict]] = None
    for rec in records:
        if rec.get("kind") != "span":
            continue
        if rec.get("parent") == "challenge":
            group[rec["name"]] = rec
        elif rec.get("name") == "challenge" and rec.get("parent") is None:
            last = {**group, "challenge": rec}
            group = {}
    if last is None:
        raise ValueError("no completed 'challenge' span group in records")
    missing = [p for p in ("read", "build_host", "build_device",
                           "anonymize", "analyze") if p not in last]
    if missing:
        raise ValueError(f"challenge span group incomplete: missing {missing}")
    dur = lambda name: last[name]["duration_s"]
    return ChallengePhaseTimings(
        n_packets=int(last["challenge"]["attrs"]["n_packets"]),
        read_s=dur("read"),
        build_s=dur("build_host") + dur("build_device"),
        anonymize_s=dur("anonymize"),
        analyze_s=dur("analyze"),
        fused_s=dur("fused") if "fused" in last else None,
        compile_s=dur("compile") if "compile" in last else None,
    )


@dataclasses.dataclass(frozen=True)
class ChallengeResults:
    """Everything the analyze phase produces, tail-padded static buffers.

    The ten Table III scalars in ``scalars`` plus the vector forms ``links``
    (Q3), ``unique_sources``/``unique_destinations`` (Q5/Q10 values),
    ``per_source``/``per_destination`` (Q6/Q11) and
    ``source_fanout``/``destination_fanin`` (Q8/Q13); beyond Table III the
    per-window statistics, the per-window activity histogram, the
    cross-window IP overlap and the k heaviest links.  ``algorithms`` is
    the optional graph-algorithm pass (``analyze(algorithms=True)``), None
    without it.
    """

    scalars: QueryResults
    links: GroupResult
    per_source: GroupResult
    per_destination: GroupResult
    source_fanout: GroupResult
    destination_fanin: GroupResult
    unique_sources: UniqueResult
    unique_destinations: UniqueResult
    top: TopLinks
    windowed: Dict[str, torch.Tensor]
    window_activity: torch.Tensor      # (n_windows, ip_bins) float32
    window_ip_overlap: torch.Tensor    # (n_windows,) int32
    algorithms: Optional[AlgorithmResults] = None


@dataclasses.dataclass
class ChallengeRun:
    """A finished run: device results, timings, the host capture columns and
    the anonymized table the analyze phase ran on; ``anon_columns`` (with
    ``config.algorithms``) holds its live ``src``/``dst`` on the host, the
    edge list the graph oracles replay; ``fused_results`` (with
    ``config.fused``) what the one-program path computed, equal to
    ``results``."""

    results: ChallengeResults
    timings: ChallengePhaseTimings
    capture: Dict[str, np.ndarray]
    config: ChallengeConfig
    anon_table: Table
    anon_columns: Optional[Dict[str, np.ndarray]] = None
    fused_results: Optional[ChallengeResults] = None


def read_phase(cfg: ChallengeConfig, workdir: str) -> Dict[str, np.ndarray]:
    """Generate-or-reuse the capture file; return host columns.  Re-reading
    an existing file is the paper's "cached" path."""
    path = cfg.capture_path(workdir)
    if not os.path.exists(path):
        cols = synthetic_packets(cfg.packets, scale=cfg.scale, seed=cfg.seed)
        if cfg.fmt == "plq":
            write_plq(path, cols)
        elif cfg.fmt == "pcaplite":
            pcaplite.write_pcaplite(path, cols)
        else:
            raise ValueError(f"unknown capture format {cfg.fmt!r}")
    if cfg.fmt == "plq":
        return read_plq(path, ["ts", "src", "dst"])
    return {k: v for k, v in pcaplite.parse_fast(path).items()
            if k in ("ts", "src", "dst")}


def window_column(ts: np.ndarray, n_windows: int) -> np.ndarray:
    """Host-side temporal window ids covering the capture's full ts range
    (int64 on the host: capture timestamps overflow int32)."""
    ts = np.asarray(ts).astype(np.int64)
    t0 = ts.min() if len(ts) else 0
    span = (ts.max() - t0 + 1) if len(ts) else 1
    wlen = -(-int(span) // n_windows)  # ceil
    return np.minimum((ts - t0) // wlen, n_windows - 1).astype(np.int32)


def build_columns(
    cols: Dict[str, np.ndarray], cfg: ChallengeConfig
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(src, dst, win) padded to static capacity, + live-row count."""
    n = len(cols["src"])
    cap = max(cfg.table_capacity, n)
    pad = lambda a, fill: np.concatenate(
        [a.astype(np.int32), np.full(cap - n, fill, np.int32)]
    )
    win = window_column(cols["ts"], cfg.n_windows)
    # win padding is 0 (not -1): windowed_queries clips; analyze masks rows
    return pad(cols["src"], 0), pad(cols["dst"], 0), pad(win, 0), n


def cross_window_ip_overlap(
    t: Table, n_windows: int, ips: Optional[UniqueResult] = None,
    method: str = "scan",
) -> torch.Tensor:
    """overlap[w] = |distinct IPs active in window w AND window w-1|.

    Every endpoint's rank in the sorted distinct-IP domain (``unique_ips``,
    the plan's shared concat sort) is a binary search, so per-window
    activity is a presence vector over IP ranks and adjacent-window AND +
    popcount answers the question with zero further sorts.
    ``method="scan"`` (default) loops over the windows keeping ONE window's
    presence vector live (O(ip_capacity) memory); ``method="grid"`` sets
    the whole ``(n_windows + 1, ip_capacity + 1)`` presence grid at once,
    the dense A/B baseline, bit-identical.  Rows with a window id out of
    range are dropped; overlap[0] == 0.
    """
    if method not in ("scan", "grid"):
        raise ValueError(f"unknown overlap method {method!r}")
    if ips is None:
        ips = unique_ips(t)
    ip_cap = ips.values.shape[0]
    in_range = t.valid_mask() & (t["win"] >= 0) & (t["win"] < n_windows)
    win = torch.where(in_range, t["win"], n_windows)
    r_src = torch.clamp(factorize(t["src"], ips.values), max=ip_cap).long()
    r_dst = torch.clamp(factorize(t["dst"], ips.values), max=ip_cap).long()
    if method == "grid":
        grid = torch.zeros((n_windows + 1) * (ip_cap + 1), dtype=torch.bool,
                           device=t.device)
        row = win.long() * (ip_cap + 1)
        grid.index_fill_(0, row + r_src, True)
        grid.index_fill_(0, row + r_dst, True)
        live = grid.view(n_windows + 1, ip_cap + 1)[:n_windows, :ip_cap]
        overlap = (live[1:] & live[:-1]).sum(dim=1, dtype=torch.int32)
        return torch.cat([torch.zeros(1, dtype=torch.int32, device=t.device),
                          overlap])
    prev = torch.zeros(ip_cap, dtype=torch.bool, device=t.device)
    overlap = []
    for w in range(n_windows):
        cur = torch.zeros(ip_cap + 1, dtype=torch.bool, device=t.device)
        # index_fill_, not cur[idx] = True: the setitem copies its scalar
        # from the host, which synchronizes
        cur.index_fill_(0, torch.where(win == w, r_src, ip_cap), True)
        cur.index_fill_(0, torch.where(win == w, r_dst, ip_cap), True)
        cur = cur[:ip_cap]
        overlap.append((prev & cur).sum(dtype=torch.int32))
        prev = cur
    return torch.stack(overlap)


def cross_window_ip_overlap_naive(t: Table, n_windows: int,
                                  backend: str = "auto") -> torch.Tensor:
    """Pre-plan overlap, the A/B baseline: the distinct (window, ip) pairs
    of both endpoints (one group-by sort), a semi-join of (w, ip) against
    (w' + 1, ip) that sorts them again (two passes: the side flag is a
    third key), and one histogram launch counting the members per window
    (ids of non-members -1, no weights).  Window ids >= n_windows are
    dropped by the histogram, as the plan path drops them."""
    valid = t.valid_mask()
    wip = groupby_aggregate(
        [torch.cat([t["win"], t["win"]]), torch.cat([t["src"], t["dst"]])],
        None, valid_mask=torch.cat([valid, valid]))
    member = semi_join(
        [wip.keys[0], wip.keys[1]], [wip.keys[0] + 1, wip.keys[1]],
        left_n_valid=wip.n_groups, right_n_valid=wip.n_groups)
    counts = histogram(torch.where(member, wip.keys[0], -1), n_windows,
                       backend=backend)
    return counts.to(torch.int32)


def _window_activity(t: Table, n_windows: int, ip_bins: int,
                     backend: str) -> torch.Tensor:
    """Per-window source-activity histogram: every window in ONE launch of
    the histogram kernel (hashed ip -> bin sketch, exact per bin)."""
    valid = t.valid_mask()
    act_ids = torch.where(
        valid, (mix32(t["src"]) % ip_bins).to(torch.int32), -1
    )
    weights = torch.where(valid, packet_weights(t), 0).to(torch.float32)
    return windowed_histogram(t["win"], act_ids, n_windows, ip_bins,
                              weights=weights, backend=backend)


def analyze(
    t: Table,
    *,
    n_windows: int,
    ip_bins: int,
    k: int,
    backend: str = "auto",
    use_plan: bool = True,
    windowed_method: str = "csr",
    fused_epilogue: bool = False,
    algorithms: bool = False,
    bfs_source: int = 0,
    device="cuda",
    window_activity: Optional[torch.Tensor] = None,
    plans: Optional[Tuple[SortedEdges, SortedEdges]] = None,
) -> ChallengeResults:
    """Every challenge statistic off THREE sorts: the packed src-leading
    (src, dst) sort, the mirrored dst-leading sort and the half-domain
    concat sort of ``unique_ips`` (held by ``core.plan.SortCounter`` in the
    tests).  ``t`` must already be on ``device``; ``plans`` is its plan
    pair when the caller already built it (then one sort runs here).

    ``windowed_method="grid"`` runs the windowed suite and the
    cross-window overlap on dense grids, the A/B baseline of the CSR path
    (O(n_windows x capacity) memory against O(nnz)).  ``use_plan=False``
    runs the pre-plan formulation, one group-by sort per query family
    (18 sorts here), the A/B baseline of the sort-once plan.  Every path
    returns bit-identical results.

    ``fused_epilogue=True`` routes the windowed suite's per-window select and
    the top-k pre-mask through the histogram kernel's gate and
    valid-mask/retire epilogues; bit-identical to the unfused path.

    ``algorithms=True`` adds BFS levels from ``bfs_source``, connected
    components, PageRank and triangle counts over the anonymized traffic
    graph, off the zero-sort CSR pair of the two plans (components uses the
    dst-keyed CSR as its transpose): still three sorts.  The static vertex
    domain is ``2 * capacity`` (anonymized ids are below the number of
    distinct IPs, which both endpoints of every row bound).

    ``window_activity`` is reported in place of the per-window activity
    histogram, which is then not computed: the streaming engine passes the
    activity it accumulated over its batches.
    """
    device = resolve_device(device)
    if t.device != device:
        raise ValueError(f"table is on {t.device}, analyze was asked to run "
                         f"on {device}")
    if window_activity is None:
        window_activity = _window_activity(t, n_windows, ip_bins, backend)
    if not use_plan:
        if algorithms:
            raise ValueError(
                "algorithms=True requires the plan path (use_plan=True): "
                "the pass is defined off the plan's zero-sort CSR pair")
        if fused_epilogue:
            raise ValueError(
                "fused_epilogue=True requires the plan path (use_plan=True):"
                " the epilogues fuse into the plan's shared reductions")
        return _analyze_naive(t, n_windows=n_windows, k=k, backend=backend,
                              window_activity=window_activity)
    if plans is None:
        plans = table_plans(t)
    plan_src, plan_dst = plans
    ips = unique_ips(t)
    links = link_groups(plan_src)
    per_src = lead_groups(plan_src)
    per_dst = lead_groups(plan_dst)
    fanout = lead_fanout(plan_src)
    fanin = lead_fanout(plan_dst)
    return ChallengeResults(
        algorithms=(algorithm_pass(t, plans, ips.n_unique, bfs_source, backend)
                    if algorithms else None),
        scalars=scalar_queries_from_plans(
            t, plan_src, plan_dst, ips, links=links, per_src=per_src,
            per_dst=per_dst, fanout=fanout, fanin=fanin,
        ),
        links=links,
        per_source=per_src,
        per_destination=per_dst,
        source_fanout=fanout,
        destination_fanin=fanin,
        unique_sources=unique_lead(plan_src),
        unique_destinations=unique_lead(plan_dst),
        top=top_links_from_plan(
            plan_src, k, links, fused=fused_epilogue, backend=backend
        ),
        windowed=windowed_queries(t, 1, n_windows, ts_col="win", t0=0,
                                  plans=plans, method=windowed_method,
                                  fused=fused_epilogue, backend=backend),
        window_activity=window_activity,
        window_ip_overlap=cross_window_ip_overlap(
            t, n_windows, ips=ips,
            method="scan" if windowed_method == "csr" else "grid"),
    )


def algorithm_pass(t: Table, plans: Tuple[SortedEdges, SortedEdges], n_live,
                   bfs_source: int = 0, backend: str = "auto") -> AlgorithmResults:
    """BFS, components, PageRank and triangles over the zero-sort CSR pair
    of ``t``'s plans, on the vertex domain ``[0, 2 * capacity)`` with
    ``n_live`` live vertices (the distinct IPs): ``analyze(algorithms=True)``'s
    pass.  It reads the host after every step, so the one-program path
    runs it after its graph (:func:`run_challenge`)."""
    csr_src, csr_dst = table_csrs(t, plans)
    return graph_algorithms(csr_src, csr_dst, 2 * t.capacity, n_live=n_live,
                            source=bfs_source, backend=backend)


def _analyze_naive(t: Table, *, n_windows: int, k: int, backend: str,
                   window_activity: torch.Tensor) -> ChallengeResults:
    """Pre-plan analyze: one group-by sort per query family.  Under ``jit``
    the reference leaves XLA's CSE to dedupe the group-bys its query
    functions repeat; the eager port computes each distinct group-by once
    (``queries.naive_groups``) and hands it to the scalar suite and the
    top-k, which is what that dedup leaves.  18 sorts: the five groups,
    ``unique_ips``, the two ``unique``s, the top-k, six in the windowed
    suite and three in the overlap."""
    g = naive_groups(t)
    return ChallengeResults(
        scalars=run_all_queries_naive(t, g),
        links=g.links,
        per_source=g.per_src,
        per_destination=g.per_dst,
        source_fanout=g.fanout,
        destination_fanin=g.fanin,
        unique_sources=unique(t["src"], n_valid=t.n_valid),
        unique_destinations=unique(t["dst"], n_valid=t.n_valid),
        top=top_links(t, k, g.links),
        windowed=windowed_queries_naive(t, 1, n_windows, ts_col="win", t0=0),
        window_activity=window_activity,
        window_ip_overlap=cross_window_ip_overlap_naive(t, n_windows, backend),
    )


def _block(device: torch.device) -> None:
    """Wait for the device: a phase wall must time work, not launches."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_challenge(cfg: ChallengeConfig) -> ChallengeRun:
    """Run read -> build -> anonymize -> analyze, timing each phase."""
    device = resolve_device(cfg.device)
    workdir = cfg.workdir or tempfile.mkdtemp(prefix="netsense_challenge_")
    os.makedirs(workdir, exist_ok=True)
    kw = dict(n_windows=cfg.n_windows, ip_bins=cfg.ip_bins, k=cfg.top_k,
              backend=cfg.backend, fused_epilogue=cfg.fused_epilogue,
              algorithms=cfg.algorithms, bfs_source=cfg.bfs_source,
              device=device)

    def build_fn(s, d, wn, nv):
        # one table, built once: A_t groups the same table analyze reads
        table = table_from_numpy({"src": s, "dst": d, "win": wn}, nv, device)
        return table, traffic_matrix(table)

    def anon_fn(table):
        # a fresh generator per call: the warm and timed passes draw the
        # same permutation, as the reference reuses one PRNG key
        gen = (torch.Generator(device=device).manual_seed(cfg.seed)
               if cfg.method == "shuffle" else None)
        return anonymize(table, gen, method=cfg.method, rounds=cfg.rounds)

    with obs_span("challenge", scale=cfg.scale, n_packets=cfg.packets,
                  fmt=cfg.fmt, fused=cfg.fused, warm=cfg.warm,
                  device=str(device)) as sp_chal:
        with obs_span("read") as sp_read:
            capture = read_phase(cfg, workdir)

        with obs_span("build_host") as sp_build_host:
            src, dst, win, n = build_columns(capture, cfg)
        sp_chal.attrs["n_packets"] = n  # live rows, not the configured count

        sp_compile = None
        if cfg.warm:
            with obs_span("compile") as sp_compile:
                wt, _ = build_fn(src, dst, win, n)
                analyze(anon_fn(wt).table, **kw)
                _block(device)

        with obs_span("build_device") as sp_build_dev:
            table, _links = build_fn(src, dst, win, n)
            _block(device)

        with obs_span("anonymize") as sp_anon:
            anon = anon_fn(table)
            _block(device)

        with obs_span("analyze") as sp_analyze:
            results = analyze(anon.table, **kw)
            _block(device)

        timings = ChallengePhaseTimings(
            n_packets=n,
            read_s=sp_read.duration_s,
            build_s=sp_build_host.duration_s + sp_build_dev.duration_s,
            anonymize_s=sp_anon.duration_s,
            analyze_s=sp_analyze.duration_s,
            compile_s=sp_compile.duration_s if sp_compile is not None else None,
        )

        fused_results = None
        if cfg.fused:
            timings.fused_s, fused_results = _time_fused(
                cfg, (src, dst, win), n, kw, device)

    anon_columns = None
    if cfg.algorithms:
        anon_columns = {c: anon.table[c][:n].cpu().numpy().astype(np.int64)
                        for c in ("src", "dst")}
    return ChallengeRun(results=results, timings=timings, capture=capture,
                        config=cfg, anon_table=anon.table,
                        anon_columns=anon_columns, fused_results=fused_results)


@contextlib.contextmanager
def _no_host_sync():
    """Make any synchronizing CUDA call raise (``set_sync_debug_mode``)."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def fused_program(cfg: ChallengeConfig, columns: Tuple[np.ndarray, ...], n: int,
                  device, **analyze_kw):
    """Build's device part (the table and the ``A_t`` group-by), anonymize
    and ``analyze(**analyze_kw)`` as one program over host columns
    ``(src, dst, win)`` with ``n`` live rows.  Returns ``run(host)``, which
    runs it on CPU tensors of the columns' shapes (pinned, on the card) and
    returns the anonymized table, its plan pair and the results, to be read
    after a synchronize.

    On the card the program is ONE ``torch.cuda.CUDAGraph``, the
    counterpart of the reference's one jitted, donated program.  The graph
    reads static device buffers, which ``run`` fills by ``non_blocking``
    copies before it replays.  Before the capture the eager program runs
    once with every host sync an error (it also binds and sets up the
    kernels, outside the capture); the capture runs under the same rule,
    and one that fails raises.  The shuffle's generator is registered with
    the graph and reseeded before each replay, so every replay draws the
    eager run's permutation.  The replay is warmed once here.  The
    algorithm pass reads the host after every step and stays out of
    ``analyze_kw``: run :func:`algorithm_pass` on the output.

    On the CPU no graph exists: ``run`` runs the three phases back to back.
    """
    if analyze_kw.get("algorithms"):
        raise ValueError("the one program holds no algorithm pass; run "
                         "algorithm_pass on its output")
    device = resolve_device(device)
    gen = torch.Generator(device=device) if cfg.method == "shuffle" else None

    def reseed():
        if gen is not None:
            gen.manual_seed(cfg.seed)

    def program(cols):
        table = Table(columns=dict(zip(("src", "dst", "win"), cols)),
                      n_valid=torch.full((), n, dtype=torch.int32, device=device))
        traffic_matrix(table)  # build's A_t group-by
        t = anonymize(table, gen, method=cfg.method, rounds=cfg.rounds).table
        plans = table_plans(t)
        return t, plans, analyze(t, plans=plans, device=device, **analyze_kw)

    if device.type != "cuda":
        def run_eager(host):
            reseed()
            return program([h.to(device) for h in host])
        return run_eager

    pinned = [torch.from_numpy(a).pin_memory() for a in columns]
    static = [torch.empty(a.shape, dtype=a.dtype, device=device) for a in pinned]

    def upload(host):
        for d, h in zip(static, host):
            d.copy_(h, non_blocking=True)

    upload(pinned)
    reseed()
    torch.cuda.synchronize(device)
    with _no_host_sync():
        program(static)
    graph = torch.cuda.CUDAGraph()
    if gen is not None:
        graph.register_generator_state(gen)
    reseed()
    # captured on a side stream, as torch.cuda.graph does, with the sync
    # check on from the capture's begin to its end
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), _no_host_sync():
        graph.capture_begin()
        try:
            out = program(static)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)

    def run_graph(host):
        upload(host)
        reseed()
        graph.replay()  # the closure keeps the graph, and its pool, alive
        return out

    run_graph(pinned)
    torch.cuda.synchronize(device)
    return run_graph


def _time_fused(cfg: ChallengeConfig, columns: Tuple[np.ndarray, ...], n: int,
                kw: dict, device: torch.device
                ) -> Tuple[float, ChallengeResults]:
    """The ``fused`` span: :func:`fused_program` built and warmed outside
    it, then, timed, the copies of fresh copies of the columns, one run
    (on the card a replay), the algorithm pass on its output when asked
    for, and a synchronize.  Returns the span's seconds and the results,
    equal to the phases'."""
    analyze_kw = {k: v for k, v in kw.items()
                  if k not in ("algorithms", "bfs_source", "device")}
    run = fused_program(cfg, columns, n, device, **analyze_kw)
    fresh = [torch.from_numpy(np.copy(a)) for a in columns]
    if device.type == "cuda":
        fresh = [h.pin_memory() for h in fresh]
    with obs_span("fused") as sp:
        t, plans, res = run(fresh)
        if kw["algorithms"]:
            res = dataclasses.replace(res, algorithms=algorithm_pass(
                t, plans, res.scalars.n_unique_ips, kw["bfs_source"],
                kw["backend"]))
        _block(device)
    return sp.duration_s, res
