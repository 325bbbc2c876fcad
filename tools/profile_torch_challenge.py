#!/usr/bin/env python3
"""Where the time of the port's device phases goes, on one NVIDIA card.

Builds the challenge table at ``--scale`` (``method="hash"``), then for the
build, anonymize and analyze phases (analyze with and without the fused
epilogue) measures the host wall of ``--reps`` calls, each ending in
``torch.cuda.synchronize()``, and traces one more call with
``torch.profiler``: the device's busy time (the union of its kernel and
copy intervals), its idle share of the traced wall, and the kernels that
take the most device time.  One JSON line per phase; needs a card.

    python3 tools/profile_torch_challenge.py --scale 24
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    busy, cur_start, cur_end = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy


def profile_phase(name, fn, reps, top):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in dev:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           cnt + 1)
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in dev]) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "phase": name,
        "wall_ms_median": statistics.median(walls),
        "wall_ms": walls,
        "traced_wall_ms": traced_ms,
        "device_events": len(dev),
        "device_busy_ms": busy_ms if dev else "not measured",
        "idle_share_of_traced_wall": 1 - busy_ms / traced_ms if dev else "not measured",
        "top_device_ms": [{"name": k[:90], "ms": v[0], "count": v[1]}
                          for k, v in ranked],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_challenge: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.challenge.pipeline import (ChallengeConfig, analyze,
                                                build_columns, read_phase)
    from repro_torch.convert import table_from_numpy
    from repro_torch.core.anonymize import anonymize
    from repro_torch.core.queries import traffic_matrix

    dev = torch.device("cuda", 0)
    cfg = ChallengeConfig(scale=args.scale, method="hash", device=str(dev))
    with tempfile.TemporaryDirectory(prefix="profile_torch_") as workdir:
        src, dst, win, n = build_columns(read_phase(cfg, workdir), cfg)
    cols = {"src": src, "dst": dst, "win": win}
    table = table_from_numpy(cols, n, dev)
    anon = anonymize(table, method="hash").table
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "torch": torch.__version__, "scale": args.scale,
                      "packets": n}))
    phases = [
        ("build_device", lambda: traffic_matrix(table_from_numpy(cols, n, dev))),
        ("anonymize", lambda: anonymize(table, method="hash")),
    ]
    for fused in (False, True):
        kw = dict(n_windows=cfg.n_windows, ip_bins=cfg.ip_bins, k=cfg.top_k,
                  fused_epilogue=fused, device=dev)
        phases.append((f"analyze{'_fused' if fused else ''}",
                       lambda kw=kw: analyze(anon, **kw)))
    for name, fn in phases:
        print(json.dumps(profile_phase(name, fn, args.reps, args.top)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
