"""The streaming engine as a supervised service — the port of
``repro/launch/serve.py``: ``python -m repro_torch.launch.serve``.

Packet micro-batches (plq row groups) flow through the resilient ingest
path — seeded chaos (``--chaos`` / per-fault rates), bounded retries with
exponential backoff, dead-letter quarantine — into the stream engine, with
durable watermarked checkpoints (``--checkpoint-dir``), so a crash restores
the newest complete checkpoint and replays only the uncommitted suffix, bit
for bit.  ``--crash-at-batch`` arms one simulated process death;
``--verify`` re-runs the capture uninterrupted and fault-free and exits
non-zero unless the 14 scalar queries agree exactly.  Graceful degradation
(``--degrade-to-both`` / ``--degrade-to-sketch``) sheds the exact tier
forward to the bounded-memory sketch tier under capacity pressure, recorded
in the snapshot's health ledger.

Runs on the card by default (``--device cuda``, the kernels through
``--backend auto``); ``--device cpu`` runs the plain kernel versions.  The
first fold of each life carries the kernels' load and is left out of the
steady-state numbers.  ``--distributed`` is not ported yet (ROADMAP.md
queue 1 item 10) and exits 2.

    PYTHONPATH=src python -m repro_torch.launch.serve --n-packets 1000000 \
        --batch-size 65536 --snapshot-every 4

    # chaos smoke: faults + one crash/restore, gated on exactness
    PYTHONPATH=src python -m repro_torch.launch.serve --scale 10 \
        --n-packets 4096 --batch-size 512 --chaos --crash-at-batch 4 \
        --checkpoint-dir /tmp/ckpt --verify --device cpu

Exit status: 0 when everything holds; 1 on a state overflow, a lost batch
or a failed ``--verify``; 2 on a usage error (``--distributed`` included)
or ``--verify`` without an exact tier.
"""
import argparse
import dataclasses
import json
import os
import signal
import sys
import tempfile
import time

# the run context's keys that every --metrics-out record carries
RECORD_CONTEXT = ("git_sha", "torch_version", "cuda_version", "device")


def _health_line(h) -> str:
    return (f"dup={h.duplicates_dropped} reord={h.reordered_buffered} "
            f"quar={h.quarantined} retries={h.io_retries} "
            f"spikes={h.latency_spikes} lost={h.lost_batches} "
            f"replayed={h.batches_replayed} crashes={h.crashes_recovered} "
            f"ckpts={h.checkpoints_committed}"
            + (f" degraded->{h.degraded_to}@{h.degraded_at_batch}"
               if h.degraded_to else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Fault-tolerant streaming analytics service over "
                    "packet micro-batches (PyTorch/CUDA port)",
    )
    ap.add_argument("--n-packets", type=int, default=1 << 20)
    ap.add_argument("--scale", type=int, default=18,
                    help="RMAT vertex scale of the synthetic capture")
    ap.add_argument("--scenario", default="rmat",
                    help="traffic generator (rmat or an adversarial "
                         "scenario of repro_torch.data.scenarios)")
    ap.add_argument("--batch-size", type=int, default=1 << 16,
                    help="micro-batch rows (= plq row-group size)")
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--ip-bins", type=int, default=1024)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--link-capacity", type=int, default=None,
                    help="distinct (window,src,dst) state budget "
                         "(default n_packets: always exact)")
    ap.add_argument("--ip-capacity", type=int, default=None,
                    help="anonymization dictionary budget "
                         "(default 2*link_capacity: always exact)")
    ap.add_argument("--tier", default="exact",
                    choices=["exact", "sketch", "both"],
                    help="analytics substrate(s) each batch folds into")
    ap.add_argument("--backend", default="auto", choices=["auto", "torch", "cuda"],
                    help="kernel dispatch: auto = the CUDA kernels on the "
                         "card, the plain versions on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="where the stream state lives and the folds run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="K",
                    help="serve the scalar suite after every K batches")
    # the reference's flag whose path is not ported: refused below
    ap.add_argument("--distributed", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None)

    g = ap.add_argument_group("durability (stream/recovery.py)")
    g.add_argument("--checkpoint-dir", default=None,
                   help="watermarked atomic checkpoints; restart restores "
                        "the newest complete one and replays the suffix")
    g.add_argument("--checkpoint-every", type=int, default=1, metavar="K",
                   help="commit every K folded batches (default 1)")
    g.add_argument("--keep", type=int, default=3,
                   help="checkpoint retention (older steps are GCed)")
    g.add_argument("--max-restarts", type=int, default=3)

    g = ap.add_argument_group("chaos injection (data/faults.py)")
    g.add_argument("--chaos", action="store_true",
                   help="enable the default fault cocktail (transient IO + "
                        "torn reads + duplicates + reorders)")
    g.add_argument("--fault-seed", type=int, default=0)
    g.add_argument("--transient-io-rate", type=float, default=None)
    g.add_argument("--corrupt-rate", type=float, default=None)
    g.add_argument("--duplicate-rate", type=float, default=None)
    g.add_argument("--reorder-rate", type=float, default=None)
    g.add_argument("--latency-rate", type=float, default=None)
    g.add_argument("--latency-s", type=float, default=0.002)
    g.add_argument("--crash-at-batch", type=int, default=None,
                   help="arm one simulated process death after folding "
                        "this batch (before its checkpoint commits)")
    g.add_argument("--quarantine-dir", default=None,
                   help="persist dead-lettered batch copies + jsonl index")

    g = ap.add_argument_group("graceful degradation")
    g.add_argument("--degrade-to-both", type=float, default=None,
                   metavar="P", help="capacity pressure that brings the "
                                     "sketch tier up beside the exact one")
    g.add_argument("--degrade-to-sketch", type=float, default=None,
                   metavar="P", help="pressure that freezes the exact tier")

    g = ap.add_argument_group("observability (repro_torch.obs)")
    g.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="stream every span/counter record to PATH as JSONL "
                        "(live, line-buffered) and append the final metric "
                        "registry; a Prometheus text dump lands at "
                        "PATH + '.prom' on exit")

    ap.add_argument("--verify", action="store_true",
                    help="re-run uninterrupted/fault-free and require the "
                         "14-query snapshots to match exactly (chaos gate)")
    args = ap.parse_args(argv)
    if args.distributed:
        ap.error("--distributed is not ported to PyTorch yet "
                 "(ROADMAP.md queue 1 item 10)")
    return _run_with_telemetry(args, ap)


def _run_with_telemetry(args, ap) -> int:
    """Install the obs sinks around :func:`_serve`, always flush on exit.

    The tracer's per-record sink streams span/counter records to
    ``--metrics-out`` as they close (header line first, so every record
    inherits the run's git sha, torch and CUDA versions and device); SIGUSR1
    dumps the live registry as Prometheus text to stderr at any point, and the
    ``finally`` block writes the same dump to ``PATH + '.prom'`` plus the
    final metric records into the JSONL — even when the run fails.
    """
    from ..obs import get_registry, reset_registry, reset_tracer
    from ..obs.trace import SCHEMA_VERSION, run_context

    reset_registry()
    metrics_file = None
    sink = None
    if args.metrics_out:
        ctx = run_context()
        metrics_file = open(args.metrics_out, "w", buffering=1)
        metrics_file.write(json.dumps(
            {"schema_version": SCHEMA_VERSION, "kind": "run",
             "t_wall": time.time(), **ctx}, sort_keys=True) + "\n")

        def sink(rec):
            metrics_file.write(json.dumps(
                {**rec, **{k: ctx[k] for k in RECORD_CONTEXT}},
                sort_keys=True) + "\n")

    reset_tracer(sink=sink)

    def _dump_prom(signum=None, frame=None):
        sys.stderr.write(get_registry().to_prometheus())
        sys.stderr.flush()

    if hasattr(signal, "SIGUSR1"):
        try:
            signal.signal(signal.SIGUSR1, _dump_prom)
        except ValueError:
            pass  # not the main thread (embedded use): no signal hook

    try:
        return _serve(args, ap)
    finally:
        reg = get_registry()
        if metrics_file is not None:
            for rec in reg.to_jsonl_records():
                metrics_file.write(json.dumps(rec, sort_keys=True) + "\n")
            metrics_file.close()
            with open(args.metrics_out + ".prom", "w") as f:
                f.write(reg.to_prometheus())
        fold = reg.get("serve_fold_seconds")
        if fold is not None and fold.count:
            print(f"[serve] batch latency: p50={fold.quantile(0.5)*1e3:.2f}ms "
                  f"p99={fold.quantile(0.99)*1e3:.2f}ms "
                  f"over {fold.count} steady folds"
                  + (f" (telemetry -> {args.metrics_out})"
                     if args.metrics_out else ""), flush=True)


def _serve(args, ap) -> int:
    from ..challenge.pipeline import window_column
    from ..obs import get_registry
    from ..obs import span as obs_span
    from ..data.faults import FaultConfig
    from ..data.plq import read_plq
    from ..stream.engine import StreamConfig, StreamEngine, steady_state, stream_plq
    from ..stream.recovery import DegradePolicy, run_service
    from ..stream.run import format_timings, prepare_capture

    workdir = args.workdir or tempfile.mkdtemp(prefix="netsense_serve_")
    os.makedirs(workdir, exist_ok=True)
    n = args.n_packets
    batch = min(args.batch_size, n)

    # ---- ingest setup (generate once, reuse) ----
    t0 = time.perf_counter()
    path = prepare_capture(workdir, n, args.scale, args.seed, batch,
                           scenario=args.scenario)
    t_cap = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts = read_plq(path, ["ts"])["ts"]
    win_full = window_column(ts, args.windows)
    t_meta = time.perf_counter() - t0
    n_batches = -(-n // batch)
    print(f"[serve] capture ready: {n:,} packets in {n_batches} row groups "
          f"of <= {batch:,} ({t_cap:.2f}s), window metadata {t_meta:.3f}s",
          flush=True)

    try:
        cfg = StreamConfig(
            batch_capacity=batch,
            link_capacity=n if args.link_capacity is None
            else args.link_capacity,
            ip_capacity=args.ip_capacity,
            n_windows=args.windows, ip_bins=args.ip_bins, top_k=args.top_k,
            backend=args.backend, tier=args.tier, device=args.device,
        )
    except ValueError as e:
        ap.error(str(e))

    # ---- fault + degradation policy ----
    rates = {
        "transient_io_rate": args.transient_io_rate,
        "corrupt_rate": args.corrupt_rate,
        "duplicate_rate": args.duplicate_rate,
        "reorder_rate": args.reorder_rate,
        "latency_rate": args.latency_rate,
    }
    if args.chaos:
        defaults = {"transient_io_rate": 0.25, "corrupt_rate": 0.25,
                    "duplicate_rate": 0.2, "reorder_rate": 0.2,
                    "latency_rate": 0.0}
        rates = {k: defaults[k] if v is None else v for k, v in rates.items()}
    else:
        rates = {k: 0.0 if v is None else v for k, v in rates.items()}
    faults = None
    if any(v > 0 for v in rates.values()) or args.crash_at_batch is not None:
        faults = FaultConfig(seed=args.fault_seed, latency_s=args.latency_s,
                             crash_at_batch=args.crash_at_batch, **rates)
    degrade = None
    if args.degrade_to_both is not None or args.degrade_to_sketch is not None:
        both = args.degrade_to_both
        sk = args.degrade_to_sketch
        degrade = DegradePolicy(to_both=both if both is not None else
                                (sk if sk is not None else 0.85),
                                to_sketch=sk if sk is not None else 1.0)

    def on_batch(i, eng):
        if args.snapshot_every and (i + 1) % args.snapshot_every == 0:
            t0 = time.perf_counter()
            snap = eng.snapshot()
            dt = time.perf_counter() - t0
            # reliability facts come from the metrics registry, which
            # snapshot() just refreshed — the one source every surface
            # (this log line, --metrics-out, the Prometheus dump) shares
            reg = get_registry()
            rel = (f"reliable={int(reg.gauge('stream_reliable').value)} "
                   f"overflow={int(reg.gauge('stream_overflow').value)} "
                   f"quar={int(reg.gauge('ingest_quarantined').value)}")
            if snap.results is not None:
                s = snap.results.scalars
                print(f"[serve] snapshot@batch {i}: "
                      f"packets={snap.n_packets:,} "
                      f"links={int(s.unique_links):,} ips={snap.n_ips:,} "
                      f"tier={snap.tier} {rel} ({dt:.3f}s)", flush=True)
            else:
                sk = snap.sketch
                print(f"[serve] snapshot@batch {i}: "
                      f"packets={snap.n_packets:,} "
                      f"links~{int(sk.unique_links):,} tier={snap.tier} "
                      f"{rel} ({dt:.3f}s)", flush=True)

    # ---- supervised stream phase ----
    with obs_span("serve_stream", n_packets=n, batch=batch,
                  tier=args.tier) as sp_stream:
        report = run_service(
            cfg, path, win_full,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            keep=args.keep,
            faults=faults,
            degrade=degrade,
            quarantine_dir=args.quarantine_dir,
            max_restarts=args.max_restarts,
            on_batch=on_batch,
        )
    wall = sp_stream.duration_s
    timings = report.timings
    print("\n" + format_timings(timings), flush=True)
    ss = steady_state(timings)
    print(f"[serve] end-to-end stream wall {wall:.3f}s "
          f"({n / wall:,.0f} packets/s incl. compile; steady state "
          f"{ss['packets_per_s']:,.0f} packets/s)", flush=True)
    if report.restarts or report.checkpoint_walls:
        cw = sum(report.checkpoint_walls)
        rw = sum(report.restore_walls)
        print(f"[serve] durability: {len(report.checkpoint_walls)} commits "
              f"({cw:.3f}s), {report.restarts} restarts "
              f"({rw:.3f}s restore, {report.replay_wall_s:.3f}s replay), "
              f"watermark {report.watermark}/{report.n_groups}", flush=True)
    print(f"[serve] health: {_health_line(report.health)}", flush=True)

    # ---- query phase ----
    with obs_span("serve_query") as sp_q:
        snap = report.snapshot()
    t_q = sp_q.duration_s
    if snap.results is not None:
        d = {k: int(v)
             for k, v in sorted(snap.results.scalars.as_dict().items())}
        print(f"[serve] results (local scalar suite, {t_q:.3f}s):", d,
              flush=True)
        print(f"[serve] state: {snap.n_links:,} links, {snap.n_ips:,} "
              f"dictionary entries, overflow={snap.overflow}, "
              f"tier={snap.tier}", flush=True)
    else:
        print(f"[serve] results (sketch tier, {t_q:.3f}s): "
              f"packets={snap.sketch.n_packets:,} "
              f"links~{int(snap.sketch.unique_links):,}", flush=True)

    rc = 0
    if snap.overflow:
        print(f"[serve] WARNING: state overflow={snap.overflow} — results "
              "are unreliable (dropped links undercount, dropped dictionary "
              "entries alias ids); raise --link-capacity/--ip-capacity "
              "or set a --degrade-to-sketch threshold",
              file=sys.stderr)
        rc = 1
    if snap.health is not None and snap.health.lost_batches:
        print(f"[serve] WARNING: {snap.health.lost_batches} batches lost "
              "past the retry budget (quarantined, counted, excluded) — "
              "results are not exact", file=sys.stderr)
        rc = 1

    # ---- verification gate (chaos smoke) ----
    if args.verify:
        if not cfg.exact_enabled:
            print("[serve] --verify requires an exact tier", file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        oracle = StreamEngine(dataclasses.replace(cfg, tier="exact"))
        stream_plq(oracle, path, win_full)
        want = oracle.snapshot().results.scalars.as_dict()
        got = snap.results.scalars.as_dict()
        bad = {k: (int(got[k]), int(v)) for k, v in want.items()
               if int(got[k]) != int(v)}
        dt = time.perf_counter() - t0
        if bad:
            print(f"[serve] VERIFY FAILED ({dt:.3f}s): recovered snapshot "
                  f"diverges from uninterrupted run: {bad}", file=sys.stderr)
            return 1
        print(f"[serve] verify OK ({dt:.3f}s): all "
              f"{len(want)} scalar queries bit-identical to the "
              "uninterrupted fault-free run", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
