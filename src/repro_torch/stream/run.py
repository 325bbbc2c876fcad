"""CLI for the port's streaming engine: ``python -m repro_torch.stream.run``.

Generates (or reuses) a synthetic capture, stores it as a plq file whose
row groups ARE the micro-batches, streams it through ``StreamEngine`` with
background prefetch and pinned, overlapped transfers, prints per-batch
timings and the full query report, and checks every scalar against the
sequential NumPy oracle (and, with ``--tier sketch|both``, every sketch
estimate against its bound) — the report and check of
``python -m repro.stream.run``.  Runs on the card by default; ``--device
cpu`` runs the plain kernel versions.

    PYTHONPATH=src python -m repro_torch.stream.run --scale 16 --batches 8
    PYTHONPATH=src python -m repro_torch.stream.run --scale 10 --batches 3 \\
        --device cpu --tier both

Exit status: 0 when everything matches; 1 on a state overflow (exact
results unreliable) or a mismatch; 2 on a usage error, ``--distributed``
included (not ported yet, ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np

from ..challenge.pipeline import window_column
from ..challenge.run import format_extras, format_queries, format_sketch, verify_sketch
from ..core.ref import ref_run_all_queries
from ..core.sketch import SketchConfig
from ..data.plq import read_plq, write_plq
from ..data.rmat import synthetic_packets
from ..data.scenarios import scenario_packets
from .engine import StreamBatchTimings, StreamConfig, StreamEngine, steady_state, stream_plq


def prepare_capture(workdir: str, n_packets: int, scale: int, seed: int,
                    batch: int, scenario: str = "rmat") -> str:
    """Generate-or-reuse a plq capture cut into ``batch``-row groups:
    ``rmat`` background traffic (:func:`repro_torch.data.rmat.synthetic_packets`)
    or one of the scenarios of :mod:`repro_torch.data.scenarios`."""
    path = os.path.join(
        workdir, f"stream_{scenario}_s{scale}_n{n_packets}_seed{seed}_b{batch}.plq")
    if not os.path.exists(path):
        if scenario == "rmat":
            cols = synthetic_packets(n_packets, scale=scale, seed=seed)
        else:
            cols = scenario_packets(scenario, n_packets, scale=scale, seed=seed)
        write_plq(path, cols, row_group_size=batch)
    return path


def format_timings(timings: Sequence[StreamBatchTimings]) -> str:
    rows = [f"{'batch':>6s}{'packets':>10s}{'prep_s':>10s}{'xfer_s':>10s}"
            f"{'update_s':>10s}{'total_s':>10s}"]
    for i, t in enumerate(timings):
        tag = "  (first batch)" if t.compile else ""
        rows.append(f"{i:6d}{t.n_packets:10,}{t.prep_s:10.4f}"
                    f"{t.transfer_s:10.4f}{t.update_s:10.4f}"
                    f"{t.total_s:10.4f}{tag}")
    ss = steady_state(timings)
    rows.append(
        f"steady state ({int(ss['batches'])} batches, first excluded): "
        f"{ss['batch_s']:.4f}s/batch, {ss['packets_per_s']:,.0f} packets/s")
    return "\n".join(rows)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.stream.run",
        description="Streaming incremental Anonymized Network Sensing engine "
                    "(PyTorch/CUDA port)",
    )
    ap.add_argument("--scale", type=int, default=14,
                    help="2^scale packets over 2^scale RMAT vertices")
    ap.add_argument("--n-packets", type=int, default=None,
                    help="override packet count (default 2^scale)")
    ap.add_argument("--batches", type=int, default=4,
                    help="number of micro-batches the capture is cut into")
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--ip-bins", type=int, default=1024)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--link-capacity", type=int, default=None,
                    help="distinct (window,src,dst) budget "
                         "(default n_packets: always exact)")
    ap.add_argument("--ip-capacity", type=int, default=None,
                    help="anonymization dictionary budget "
                         "(default 2*link_capacity: always exact)")
    ap.add_argument("--backend", default="auto", choices=["auto", "torch", "cuda"],
                    help="kernel dispatch: auto = the CUDA kernels on the "
                         "card, the plain versions on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="where the stream state lives and the folds run")
    ap.add_argument("--tier", default="exact", choices=["exact", "sketch", "both"],
                    help="analytics substrate per batch: the exact CSR "
                         "state, the bounded-memory sketch tier "
                         "(never overflows; answers carry error bounds), "
                         "or both side by side")
    ap.add_argument("--sketch-depth", type=int, default=4,
                    help="Count-Min depth (rows)")
    ap.add_argument("--sketch-width", type=int, default=4096,
                    help="Count-Min width (cells per row)")
    ap.add_argument("--hll-p", type=int, default=12,
                    help="HyperLogLog precision: 2^p registers")
    ap.add_argument("--heavy-capacity", type=int, default=64,
                    help="space-saving heavy-hitter counters")
    ap.add_argument("--scenario", default="rmat",
                    choices=["rmat", "ddos", "portscan", "beacon", "diurnal"],
                    help="traffic generator (adversarial scenarios of "
                         "repro_torch.data.scenarios beyond the rmat "
                         "background)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="capture cache dir (tmp if unset)")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="K",
                    help="print the scalar suite after every K batches "
                         "(queries are answerable at any point)")
    ap.add_argument("--time-phases", action="store_true",
                    help="wait for the card after each phase for per-phase "
                         "walls (no transfer/compute overlap)")
    ap.add_argument("--no-verify", dest="verify", action="store_false",
                    help="skip the NumPy-oracle scalar check")
    # the reference's flag whose path is not ported: refused below
    ap.add_argument("--distributed", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.distributed:
        ap.error("--distributed is not ported to PyTorch yet "
                 "(ROADMAP.md queue 1 item 10)")
    n = args.n_packets if args.n_packets is not None else 1 << args.scale
    if args.batches < 1 or n < 1:
        ap.error("need >= 1 batch and >= 1 packet")
    batch = -(-n // args.batches)  # ceil
    try:
        cfg = StreamConfig(
            batch_capacity=batch,
            link_capacity=n if args.link_capacity is None else args.link_capacity,
            ip_capacity=args.ip_capacity,
            n_windows=args.windows, ip_bins=args.ip_bins, top_k=args.top_k,
            backend=args.backend, tier=args.tier, device=args.device,
            sketch=SketchConfig(
                cms_depth=args.sketch_depth, cms_width=args.sketch_width,
                hll_p=args.hll_p, heavy_capacity=args.heavy_capacity,
                seed=args.seed,
            ) if args.tier != "exact" else None,
        )
    except ValueError as e:
        ap.error(str(e))
    workdir = args.workdir or tempfile.mkdtemp(prefix="netsense_stream_")
    os.makedirs(workdir, exist_ok=True)
    print(f"streaming challenge: {n:,} packets in {args.batches} "
          f"micro-batches of <= {batch:,}, {args.windows} windows, "
          f"link_capacity={cfg.link_capacity:,}, tier={cfg.tier}, "
          f"scenario={args.scenario}, device={cfg.device}")

    path = prepare_capture(workdir, n, args.scale, args.seed, batch,
                           scenario=args.scenario)
    win_full = window_column(read_plq(path, ["ts"])["ts"], args.windows)

    engine = StreamEngine(cfg)

    def on_batch(i: int, eng: StreamEngine) -> None:
        if args.snapshot_every and (i + 1) % args.snapshot_every == 0:
            snap = eng.snapshot()
            if snap.results is not None:
                s = snap.results.scalars
                print(f"[batch {i}] packets={snap.n_packets:,} "
                      f"links={int(s.unique_links):,} ips={snap.n_ips:,} "
                      f"max_fanout={int(s.max_source_fanout):,}", flush=True)
            else:
                sk = snap.sketch
                print(f"[batch {i}] packets={snap.n_packets:,} "
                      f"links~{sk.unique_links:,.0f} "
                      f"sources~{sk.unique_sources:,.0f} (sketch)", flush=True)

    timings = stream_plq(engine, path, win_full,
                         time_phases=args.time_phases, on_batch=on_batch)
    print("\n" + format_timings(timings))

    snap = engine.snapshot()
    if snap.results is not None:
        print()
        print(format_queries(snap.results))
        print(format_extras(snap.results, args.windows))
        print(f"\nstate: {snap.n_links:,} accumulated links, {snap.n_ips:,} "
              f"dictionary entries, {snap.n_batches} batches, "
              f"overflow={snap.overflow}")
    if snap.sketch is not None:
        print(format_sketch(snap.sketch))

    if snap.results is not None and snap.overflow:
        print(f"state overflow: {snap.overflow} dropped entries — exact "
              "results are unreliable (dropped links undercount, dropped "
              "dictionary entries alias ids); raise --link-capacity/"
              "--ip-capacity, or stream with --tier sketch (bounded error "
              "instead of bounded exactness)", file=sys.stderr)
        return 1
    if args.verify:
        cols = read_plq(path, ["src", "dst"])
        ref = ref_run_all_queries(cols["src"].astype(np.int64),
                                  cols["dst"].astype(np.int64))
        bad = 0
        if snap.results is not None:
            for k, v in ref.items():
                got = int(getattr(snap.results.scalars, k))
                if got != v:
                    print(f"MISMATCH {k}: stream={got} oracle={v}",
                          file=sys.stderr)
                    bad += 1
        if snap.sketch is not None:
            bad += verify_sketch(snap.sketch, ref)
        if bad:
            print(f"\n{bad} result(s) disagree with the oracle", file=sys.stderr)
            return 1
        if snap.results is not None:
            print("\nall scalar queries match the NumPy oracle ✓")
        if snap.sketch is not None:
            print("all sketch estimates within their configured bounds ✓")
    return 0


if __name__ == "__main__":
    sys.exit(main())
