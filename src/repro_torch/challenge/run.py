"""CLI for the port's end-to-end challenge: ``python -m repro_torch.challenge.run``.

Prints the per-phase timing table, all 14 Table III query results, the
per-window statistics, cross-window IP overlap and the k heaviest links, and
(unless ``--no-verify``) checks every scalar against the sequential NumPy
oracle — the same report and check as ``python -m repro.challenge.run``.
``--algorithms`` adds BFS, connected components, PageRank and triangle
counts over the anonymized traffic graph, checked against their NumPy
oracles; ``--tier sketch|both`` adds the bounded-memory sketch tier, each
estimate checked against its configured error bound.  ``--fused`` also
times build, anonymize and analyze as one program, on the card one CUDA
graph (the ``fused(b+a+a)`` row; with ``--algorithms`` the graph holds
``analyze`` without the algorithm pass, which runs after the replay inside
the same timed span).  Runs on the card by default; ``--device cpu`` runs
the plain versions.

    PYTHONPATH=src python -m repro_torch.challenge.run --scale 20
    PYTHONPATH=src python -m repro_torch.challenge.run --algorithms --tier both
    PYTHONPATH=src python -m repro_torch.challenge.run --scale 18 --fused
    PYTHONPATH=src python -m repro_torch.challenge.run --scale 9 --windows 2 --device cpu

``--distributed`` and ``--autotune`` are refused with exit status 2 and the
ROADMAP.md item that ports their paths.
"""
from __future__ import annotations

import argparse
import sys
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..core.ref import (
    ref_bfs,
    ref_cc,
    ref_pagerank,
    ref_run_all_queries,
    ref_triangles,
)
from ..core.sketch import (
    SketchConfig,
    SketchSnapshot,
    init_sketch,
    snapshot_sketch,
    update_sketch,
)
from ..core.table import resolve_device
from .pipeline import ChallengeConfig, ChallengeRun, run_challenge

# flag -> (is it set?, the ROADMAP.md item that ports its path)
_UNPORTED = {
    "--distributed": (lambda a: a.distributed, "queue 1 item 10"),
    "--autotune": (lambda a: a.autotune, "queue 1 item 9"),
}


def format_queries(r) -> str:
    """The 14 Table III queries, in paper order."""
    s = r.scalars

    def group_head(g, agg: str, k: int = 3) -> str:
        n = int(g.n_groups)
        m = min(n, k)
        keys = " ".join(
            "(" + ",".join(str(int(kk[i])) for kk in g.keys) + ")"
            for i in range(m)
        )
        vals = " ".join(str(int(g.aggs[agg][i])) for i in range(m))
        return f"<vector: n={n:,}  head {keys} -> {vals}>"

    rows = [
        ("1  valid packets", int(s.valid_packets)),
        ("2  unique links", int(s.unique_links)),
        ("3  link packet counts", group_head(r.links, "packets")),
        ("4  max link packets", int(s.max_link_packets)),
        ("5  unique sources", int(s.n_unique_sources)),
        ("6  packets per source", group_head(r.per_source, "packets")),
        ("7  max source packets", int(s.max_source_packets)),
        ("8  source fan-out", group_head(r.source_fanout, "count")),
        ("9  max source fan-out", int(s.max_source_fanout)),
        ("10 unique destinations", int(s.n_unique_destinations)),
        ("11 packets per destination", group_head(r.per_destination, "packets")),
        ("12 max destination packets", int(s.max_destination_packets)),
        ("13 destination fan-in", group_head(r.destination_fanin, "count")),
        ("14 max destination fan-in", int(s.max_destination_fanin)),
    ]
    width = max(len(n) for n, _ in rows) + 2
    out = [f"{'query (Table III)':{width}s}result"]
    for name, val in rows:
        out.append(f"{name:{width}s}{val:,}" if isinstance(val, int)
                   else f"{name:{width}s}{val}")
    out.append(f"{'   (unique IPs)':{width}s}{int(s.n_unique_ips):,}")
    return "\n".join(out)


def format_extras(r, nw: int) -> str:
    """Per-window statistics + heaviest links."""
    out = ["", f"per-window statistics ({nw} windows):"]
    keys = ("valid_packets", "unique_links", "n_unique_sources",
            "max_source_fanout")
    out.append(f"{'window':>8s}" + "".join(f"{k:>18s}" for k in keys)
               + f"{'ip_overlap(w-1)':>18s}")
    for wi in range(nw):
        vals = "".join(f"{int(r.windowed[k][wi]):18,}" for k in keys)
        out.append(f"{wi:8d}{vals}{int(r.window_ip_overlap[wi]):18,}")
    act = r.window_activity.cpu().numpy()
    out.append(
        f"activity histogram: {act.shape[0]} windows x {act.shape[1]} bins "
        f"in one kernel launch; busiest bin = {act.max():,.0f} packets"
    )
    k = int(r.top.n_valid)
    out.append(f"\ntop-{k} heaviest links (anonymized ids):")
    out.append(f"{'src':>10s}{'dst':>10s}{'packets':>10s}")
    for i in range(k):
        out.append(f"{int(r.top.src[i]):10d}{int(r.top.dst[i]):10d}"
                   f"{int(r.top.packets[i]):10,}")
    return "\n".join(out)


def format_algorithms(r) -> str:
    """Summary of the iterative-algorithm pass (``analyze --algorithms``)."""
    a = r.algorithms
    n = int(r.scalars.n_unique_ips)
    levels = a.bfs.levels[:n].cpu().numpy()
    reached = levels[levels >= 0]
    out = ["", f"graph algorithms over the anonymized traffic graph "
              f"({n:,} vertices):"]
    out.append(
        f"  bfs        reached {int(a.bfs.n_reached):,} vertices, "
        f"max level {int(reached.max()) if reached.size else -1}, "
        f"{int(a.bfs.iterations)} iters, converged={bool(a.bfs.converged)}"
    )
    out.append(
        f"  components {int(a.components.n_components):,} weakly connected, "
        f"{int(a.components.iterations)} iters, "
        f"converged={bool(a.components.converged)}"
    )
    ranks = a.pagerank.ranks[:n].cpu().numpy()
    top = np.argsort(ranks)[::-1][:3]
    head = " ".join(f"{v}:{ranks[v]:.5f}" for v in top)
    out.append(
        f"  pagerank   residual {float(a.pagerank.residual):.2e} after "
        f"{int(a.pagerank.iterations)} iters, "
        f"converged={bool(a.pagerank.converged)}, top {head}"
    )
    out.append(
        f"  triangles  {int(a.triangles.total):,} closed directed wedges "
        f"(A ⊙ A·A mass)"
    )
    return "\n".join(out)


def verify_algorithms(run: ChallengeRun) -> int:
    """Replay all four algorithms with the NumPy oracles on the anonymized
    edge list; return the number of disagreeing result families."""
    a = run.results.algorithms
    src, dst = run.anon_columns["src"], run.anon_columns["dst"]
    n = int(run.results.scalars.n_unique_ips)
    host = lambda t: t.cpu().numpy()
    bad = 0

    levels = host(a.bfs.levels)
    want = ref_bfs(src, dst, n, run.config.bfs_source)
    if not (np.array_equal(levels[:n], want) and np.all(levels[n:] == -1)):
        print("MISMATCH bfs levels vs oracle", file=sys.stderr)
        bad += 1

    labels = host(a.components.labels)
    want = ref_cc(src, dst, n)
    if not (np.array_equal(labels[:n], want) and np.all(labels[n:] == -1)
            and int(a.components.n_components) == len(np.unique(want))):
        print("MISMATCH component labels vs oracle", file=sys.stderr)
        bad += 1

    ranks = host(a.pagerank.ranks)
    want, _, _ = ref_pagerank(src, dst, np.ones(len(src)), n)
    l1 = np.abs(ranks[:n] - want).sum()
    if not (l1 < 1e-6 and np.all(ranks[n:] == 0.0)):
        print(f"MISMATCH pagerank vs oracle: L1={l1:.3e}", file=sys.stderr)
        bad += 1

    per_node = host(a.triangles.per_node)
    want, total = ref_triangles(src, dst, n)
    if not (np.array_equal(per_node[:n], want.astype(np.float32))
            and int(a.triangles.total) == total):
        print("MISMATCH triangle counts vs oracle", file=sys.stderr)
        bad += 1
    return bad


# --- the approximate (sketch) tier --------------------------------------------

def run_sketch_tier(
    capture: Mapping[str, np.ndarray],
    cfg: SketchConfig,
    *,
    batch_capacity: int = 1 << 15,
    backend: str = "auto",
    top_k: int = 10,
    device="cuda",
) -> SketchSnapshot:
    """Fold the whole capture through the bounded-memory sketch tier
    (:mod:`repro_torch.core.sketch`) in fixed-capacity micro-batches, the
    last one padded.  The capture goes to ``device`` in one copy; each
    micro-batch is a view of it."""
    device = resolve_device(device)
    n = len(capture["src"])
    padded = -(-n // batch_capacity) * batch_capacity
    cols = [torch.from_numpy(np.pad(np.asarray(capture[c]).astype(np.int32),
                                    (0, padded - n))).to(device)
            for c in ("src", "dst")]
    state = init_sketch(cfg, device)
    for off in range(0, n, batch_capacity):
        state = update_sketch(state, cols[0][off:off + batch_capacity],
                              cols[1][off:off + batch_capacity],
                              min(batch_capacity, n - off), backend=backend)
    return snapshot_sketch(state, k=top_k)


def format_sketch(snap: SketchSnapshot) -> str:
    """Sketch-tier report: estimates with their configured error bounds."""
    b = snap.bounds
    out = [
        "",
        f"sketch tier (bounded memory, overflow={snap.overflow} by "
        "construction):",
        f"  valid packets            {snap.n_packets:,} (exact counter)",
        f"  unique sources           ~{snap.unique_sources:,.0f}  "
        f"(HLL, rel tol {b['hll_rel_tolerance']:.3f})",
        f"  unique destinations      ~{snap.unique_destinations:,.0f}",
        f"  unique links             ~{snap.unique_links:,.0f}",
        f"  max link packets         ~{snap.max_link_packets:,.0f}  "
        f"(+{b['cms_epsilon_n']:,.1f} / -{b['heavy_link_offset']:,.0f})",
        f"  max source packets       ~{snap.max_source_packets:,.0f}  "
        f"(+{b['cms_epsilon_n']:,.1f} / -{b['heavy_src_offset']:,.0f})",
    ]
    k = min(snap.n_top_talkers, 5)
    if k:
        head = "  ".join(
            f"{int(snap.top_talker_src[i])}:{int(snap.top_talker_packets[i])}"
            for i in range(k)
        )
        out.append(f"  top talkers (est <= true + offset)   {head}")
    k = min(snap.n_top_links, 5)
    if k:
        head = "  ".join(
            f"({int(snap.top_link_src[i])},{int(snap.top_link_dst[i])}):"
            f"{int(snap.top_link_packets[i])}"
            for i in range(k)
        )
        out.append(f"  top links                            {head}")
    return "\n".join(out)


def verify_sketch(snap: SketchSnapshot, exact: Mapping[str, int]) -> int:
    """Check every sketch estimate against its configured theoretical bound
    given the exact answers; return the number of violations.

    ``exact`` maps the scalar names (``valid_packets``, ``unique_links``,
    ``n_unique_sources``, ``n_unique_destinations``, ``max_link_packets``,
    ``max_source_packets``) to the exact-tier values.  Bounds checked:
    HLL relative error within tolerance; maxima within
    ``[-heavy offset, +CMS εN]``; the packet counter bit-exact.
    """
    b = snap.bounds
    bad = 0

    def fail(msg: str) -> None:
        nonlocal bad
        print(f"SKETCH BOUND VIOLATION: {msg}", file=sys.stderr)
        bad += 1

    if snap.n_packets != int(exact["valid_packets"]):
        fail(f"valid_packets {snap.n_packets} != {exact['valid_packets']}")
    tol = b["hll_rel_tolerance"]
    for name, est in [
        ("n_unique_sources", snap.unique_sources),
        ("n_unique_destinations", snap.unique_destinations),
        ("unique_links", snap.unique_links),
    ]:
        want = int(exact[name])
        rel = abs(est - want) / max(want, 1)
        if rel > tol:
            fail(f"{name} est {est:.0f} vs exact {want}: rel {rel:.4f} > "
                 f"tol {tol:.4f}")
    for name, est, off_key in [
        ("max_link_packets", snap.max_link_packets, "heavy_link_offset"),
        ("max_source_packets", snap.max_source_packets, "heavy_src_offset"),
    ]:
        want = int(exact[name])
        lo = want - b[off_key]
        hi = want + b["cms_epsilon_n"]
        if not lo <= est <= hi:
            fail(f"{name} est {est:.0f} outside [{lo:.1f}, {hi:.1f}] "
                 f"(exact {want})")
    return bad


def verify_scalars(run: ChallengeRun, ref: Optional[dict] = None) -> int:
    """Compare every scalar to the NumPy oracle; return mismatch count.
    ``ref`` is a precomputed ``ref_run_all_queries`` of the same capture."""
    if ref is None:
        cap = run.capture
        ref = ref_run_all_queries(cap["src"].astype(np.int64),
                                  cap["dst"].astype(np.int64))
    bad = 0
    for k, v in ref.items():
        got = int(getattr(run.results.scalars, k))
        if got != v:
            print(f"MISMATCH {k}: pipeline={got} oracle={v}", file=sys.stderr)
            bad += 1
    return bad


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.challenge.run",
        description="End-to-end Anonymized Network Sensing Graph Challenge "
                    "(PyTorch/CUDA port)",
    )
    ap.add_argument("--scale", type=int, default=14,
                    help="2^scale packets over 2^scale RMAT vertices")
    ap.add_argument("--n-packets", type=int, default=None,
                    help="override packet count (default 2^scale)")
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--ip-bins", type=int, default=1024)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--method", default="shuffle", choices=["shuffle", "hash"])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--format", default="plq", choices=["plq", "pcaplite"])
    ap.add_argument("--backend", default="auto", choices=["auto", "torch", "cuda"],
                    help="histogram dispatch: auto = the CUDA kernel on the "
                         "card, the plain version on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="where the table lives and the compute phases run")
    ap.add_argument("--fused", action="store_true",
                    help="also time build+anonymize+analyze as one program "
                         "(one CUDA graph on the card)")
    ap.add_argument("--fused-epilogue", action="store_true",
                    help="route the analyze windowed/top-k scatter chains "
                         "through the histogram kernel's epilogues "
                         "(bit-identical)")
    ap.add_argument("--algorithms", action="store_true",
                    help="run BFS/CC/PageRank/triangles over the anonymized "
                         "traffic graph (oracle-checked under --verify)")
    ap.add_argument("--bfs-source", type=int, default=0,
                    help="BFS source vertex (anonymized id, default 0)")
    ap.add_argument("--tier", default="exact",
                    choices=["exact", "sketch", "both"],
                    help="also run the bounded-memory sketch tier beside "
                         "the exact pipeline (sketch/both; under --verify "
                         "every estimate is gated against its error bound)")
    ap.add_argument("--sketch-depth", type=int, default=4,
                    help="Count-Min depth (rows)")
    ap.add_argument("--sketch-width", type=int, default=4096,
                    help="Count-Min width (cells per row)")
    ap.add_argument("--hll-p", type=int, default=12,
                    help="HyperLogLog precision: 2^p registers")
    ap.add_argument("--heavy-capacity", type=int, default=64,
                    help="space-saving heavy-hitter counters")
    ap.add_argument("--workdir", default=None,
                    help="capture cache dir (tmp if unset)")
    ap.add_argument("--no-verify", dest="verify", action="store_false",
                    help="skip the NumPy-oracle scalar check")
    # the reference's flags whose paths are not ported: refused below
    ap.add_argument("--distributed", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--autotune", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    for flag, (is_set, item) in _UNPORTED.items():
        if is_set(args):
            ap.error(f"{flag} is not ported to PyTorch yet (ROADMAP.md {item})")
    try:
        cfg = ChallengeConfig(
            scale=args.scale, n_packets=args.n_packets, n_windows=args.windows,
            ip_bins=args.ip_bins, top_k=args.top_k, method=args.method,
            rounds=args.rounds, seed=args.seed, fmt=args.format,
            backend=args.backend, fused=args.fused,
            fused_epilogue=args.fused_epilogue,
            algorithms=args.algorithms, bfs_source=args.bfs_source,
            workdir=args.workdir, device=args.device,
        )
        sketch_cfg = None
        if args.tier != "exact":
            sketch_cfg = SketchConfig(
                cms_depth=args.sketch_depth, cms_width=args.sketch_width,
                hll_p=args.hll_p, heavy_capacity=args.heavy_capacity,
                seed=args.seed,
            )
    except ValueError as e:
        ap.error(str(e))
    print(f"anonymized network sensing challenge: {cfg.packets:,} packets, "
          f"{cfg.n_windows} windows, fmt={cfg.fmt}, method={cfg.method}, "
          f"device={cfg.device}")
    run = run_challenge(cfg)

    print("\n" + run.timings.format_table())
    print()
    print(format_queries(run.results))
    print(format_extras(run.results, run.config.n_windows))
    if args.algorithms:
        print(format_algorithms(run.results))

    sketch_snap = None
    if sketch_cfg is not None:
        # the batch pipeline always computes the exact tier (it is the
        # challenge); sketch/both adds the approximate tier beside it
        sketch_snap = run_sketch_tier(run.capture, sketch_cfg,
                                      backend=args.backend, top_k=args.top_k,
                                      device=args.device)
        print(format_sketch(sketch_snap))

    if args.verify:
        bad = verify_scalars(run)
        if args.algorithms:
            bad += verify_algorithms(run)
        if sketch_snap is not None:
            s = run.results.scalars
            bad += verify_sketch(sketch_snap, {
                k: int(getattr(s, k)) for k in (
                    "valid_packets", "unique_links", "n_unique_sources",
                    "n_unique_destinations", "max_link_packets",
                    "max_source_packets")})
        if bad:
            print(f"\n{bad} result(s) disagree with the oracle", file=sys.stderr)
            return 1
        print("\nall scalar queries match the NumPy oracle ✓")
        if args.algorithms:
            print("all four graph algorithms match their NumPy oracles ✓")
        if sketch_snap is not None:
            print("all sketch estimates within their configured bounds ✓")
    return 0


if __name__ == "__main__":
    sys.exit(main())
