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

Not ported yet: ``fused=True`` (one program for the compute phases) and
``distributed=True`` (ROADMAP.md queue 1 items 4 and 10).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import table_from_numpy
from ..core.algorithms import AlgorithmResults, graph_algorithms
from ..core.anonymize import anonymize
from ..core.ops import GroupResult, UniqueResult, factorize, mix32
from ..core.plan import lead_fanout, lead_groups, link_groups, unique_lead
from ..core.queries import (
    QueryResults,
    TopLinks,
    packet_weights,
    scalar_queries_from_plans,
    table_csrs,
    table_plans,
    top_links_from_plan,
    traffic_matrix,
    unique_ips,
)
from ..core.table import Table, resolve_device
from ..core.temporal import windowed_queries
from ..data import pcaplite
from ..data.plq import read_plq, write_plq
from ..data.rmat import synthetic_packets
from ..kernels.ops import windowed_histogram
from ..obs import span as obs_span

__all__ = [
    "ChallengeConfig",
    "ChallengePhaseTimings",
    "ChallengeResults",
    "ChallengeRun",
    "analyze",
    "build_columns",
    "cross_window_ip_overlap",
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
    compile_s: Optional[float] = None    # warm pass, excluded from the walls

    @property
    def total_s(self) -> float:
        return self.read_s + self.build_s + self.anonymize_s + self.analyze_s

    def format_table(self) -> str:
        rows = [f"{'phase':12s}{'seconds':>12s}{'packets/sec':>16s}"]
        for p in PHASES:
            s = getattr(self, f"{p}_s")
            rows.append(f"{p:12s}{s:12.4f}{self.n_packets / max(s, 1e-12):16,.0f}")
        rows.append(
            f"{'total':12s}{self.total_s:12.4f}"
            f"{self.n_packets / max(self.total_s, 1e-12):16,.0f}"
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
    edge list the graph oracles replay."""

    results: ChallengeResults
    timings: ChallengePhaseTimings
    capture: Dict[str, np.ndarray]
    config: ChallengeConfig
    anon_table: Table
    anon_columns: Optional[Dict[str, np.ndarray]] = None


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
    popcount answers the question with zero further sorts.  The loop keeps
    ONE window's presence vector live (O(ip_capacity) memory).  Rows with a
    window id out of range are dropped; overlap[0] == 0.  The dense
    ``method="grid"`` baseline is not ported yet (ROADMAP.md queue 1 item 4).
    """
    if method != "scan":
        raise NotImplementedError(
            f"overlap method {method!r} is not ported yet (ROADMAP.md queue 1 "
            "item 4); use method='scan'")
    if ips is None:
        ips = unique_ips(t)
    ip_cap = ips.values.shape[0]
    in_range = t.valid_mask() & (t["win"] >= 0) & (t["win"] < n_windows)
    win = torch.where(in_range, t["win"], n_windows)
    r_src = torch.clamp(factorize(t["src"], ips.values), max=ip_cap).long()
    r_dst = torch.clamp(factorize(t["dst"], ips.values), max=ip_cap).long()
    prev = torch.zeros(ip_cap, dtype=torch.bool, device=t.device)
    overlap = []
    for w in range(n_windows):
        cur = torch.zeros(ip_cap + 1, dtype=torch.bool, device=t.device)
        cur[torch.where(win == w, r_src, ip_cap)] = True
        cur[torch.where(win == w, r_dst, ip_cap)] = True
        cur = cur[:ip_cap]
        overlap.append((prev & cur).sum(dtype=torch.int32))
        prev = cur
    return torch.stack(overlap)


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
    windowed_method: str = "csr",
    fused_epilogue: bool = False,
    algorithms: bool = False,
    bfs_source: int = 0,
    device="cuda",
    window_activity: Optional[torch.Tensor] = None,
) -> ChallengeResults:
    """Every challenge statistic off THREE sorts: the packed src-leading
    (src, dst) sort, the mirrored dst-leading sort and the half-domain
    concat sort of ``unique_ips`` (held by ``core.plan.SortCounter`` in the
    tests).  ``t`` must already be on ``device``.

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
    plans = table_plans(t)
    plan_src, plan_dst = plans
    ips = unique_ips(t)
    links = link_groups(plan_src)
    per_src = lead_groups(plan_src)
    per_dst = lead_groups(plan_dst)
    fanout = lead_fanout(plan_src)
    fanin = lead_fanout(plan_dst)
    algo = None
    if algorithms:
        csr_src, csr_dst = table_csrs(t, plans)
        algo = graph_algorithms(csr_src, csr_dst, 2 * t.capacity,
                                n_live=ips.n_unique, source=bfs_source,
                                backend=backend)
    return ChallengeResults(
        algorithms=algo,
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
        window_activity=(_window_activity(t, n_windows, ip_bins, backend)
                         if window_activity is None else window_activity),
        window_ip_overlap=cross_window_ip_overlap(t, n_windows, ips=ips),
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
                  fmt=cfg.fmt, warm=cfg.warm, device=str(device)) as sp_chal:
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

    anon_columns = None
    if cfg.algorithms:
        anon_columns = {c: anon.table[c][:n].cpu().numpy().astype(np.int64)
                        for c in ("src", "dst")}
    return ChallengeRun(results=results, timings=timings, capture=capture,
                        config=cfg, anon_table=anon.table,
                        anon_columns=anon_columns)
