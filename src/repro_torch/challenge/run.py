"""CLI for the port's end-to-end challenge: ``python -m repro_torch.challenge.run``.

Prints the per-phase timing table, all 14 Table III query results, the
per-window statistics, cross-window IP overlap and the k heaviest links, and
(unless ``--no-verify``) checks every scalar against the sequential NumPy
oracle — the same report and check as ``python -m repro.challenge.run``.
Runs on the card by default; ``--device cpu`` runs the plain versions.

    PYTHONPATH=src python -m repro_torch.challenge.run --scale 20
    PYTHONPATH=src python -m repro_torch.challenge.run --scale 9 --windows 2 --device cpu

Flags of the reference whose paths are not ported yet are refused with exit
status 2 and the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from ..core.ref import ref_run_all_queries
from .pipeline import ChallengeConfig, ChallengeRun, run_challenge

# flag -> (is it set?, the ROADMAP.md item that ports its path)
_UNPORTED = {
    "--fused": (lambda a: a.fused, "queue 1 item 4 (the one-program path)"),
    "--distributed": (lambda a: a.distributed, "queue 1 item 10"),
    "--algorithms": (lambda a: a.algorithms,
                     "queue 1 item 5 with queue 2 item 2 (segment-max)"),
    "--tier": (lambda a: a.tier != "exact",
               "queue 1 item 6 with queue 2 item 3 (Count-Min kernel)"),
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
    ap.add_argument("--fused-epilogue", action="store_true",
                    help="route the analyze windowed/top-k scatter chains "
                         "through the histogram kernel's epilogues "
                         "(bit-identical)")
    ap.add_argument("--workdir", default=None,
                    help="capture cache dir (tmp if unset)")
    ap.add_argument("--no-verify", dest="verify", action="store_false",
                    help="skip the NumPy-oracle scalar check")
    # the reference's flags whose paths are not ported: refused below
    ap.add_argument("--fused", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--distributed", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--algorithms", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tier", default="exact", choices=["exact", "sketch", "both"],
                    help=argparse.SUPPRESS)
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
            backend=args.backend, fused_epilogue=args.fused_epilogue,
            workdir=args.workdir, device=args.device,
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

    if args.verify:
        bad = verify_scalars(run)
        if bad:
            print(f"\n{bad} result(s) disagree with the oracle", file=sys.stderr)
            return 1
        print("\nall scalar queries match the NumPy oracle ✓")
    return 0


if __name__ == "__main__":
    sys.exit(main())
