#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Card and build: print the card's name and power limit, build the CUDA
   source ``src/repro_torch/kernels/csrc/histogram.cu``.
2. Kernels against their plain versions on the card, at the main path's
   shapes: the histogram kernel on 2^24 rows into 8,192 float bins and as a
   gated int32 sum into 2^24 + 1 segments (bit-equal, and timed beside the
   plain version, ``torch.bincount`` and the bytes bound), plus the
   ``init``/``valid_mask``/``retire`` epilogue, ``n == 0``, out-of-range
   ids and random float weights (to a stated tolerance).
3. The main path: ``run_challenge`` at scale 24 with ``method="hash"``,
   once with the defaults and once with ``fused_epilogue=True``, each
   checked against the NumPy oracle, the two checked identical, and the
   kernel's launch count checked against the count the code implies.
4. The CLI, ``python -m repro_torch.challenge.run``, with its defaults
   (the card, shuffle anonymization) at scale 20: exit 0 and the oracle line.

Then it prints one JSON line of kernel records, the card line again, and as
its last line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout (no ``src/repro_torch``), it exits non-zero before
printing any result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SCALE = 24                  # 2^24 packets; the full challenge capture is 2^30
N_WINDOWS, IP_BINS = 8, 1024
# The bound of each timed shape is its bytes (each input read once, each
# output written once) over the H100 SXM's memory rate; its operations, one
# add per row, would take n / 67e12 s at the float32 peak, some 160x less.
HBM_BYTES_PER_S = 3.35e12
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernel() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build("histogram")
    log(f"built histogram.cu in {time.perf_counter() - t0:.1f} s")
    log(f"--- {lib.name}: nvcc -Xptxas -v\n"
        + lib.with_suffix(".log").read_text().strip())


def time_ms(fn) -> float:
    """Mean device time of one call, by CUDA events over REPS calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def check_kernels(dev):
    """Phase 2: the histogram kernel against its plain version on the card.

    Returns (max_abs_err, timed shape records)."""
    import torch
    from repro_torch.kernels.ops import histogram, segmented_reduce

    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=g,
                                           device=dev, dtype=torch.int32)
    n = 1 << SCALE
    max_err = 0.0
    shapes = []

    def same(name, got, want):
        if not torch.equal(got, want):
            diff = (got.double() - want.double()).abs().max().item()
            raise AssertionError(f"{name}: kernel != plain (max |diff| {diff})")
        log(f"  {name}: bit-equal")

    # (a) the default path's activity histogram: 2^24 rows, 8,192 flat bins,
    # integer-valued float weights (exact in any summation order)
    bins_a = N_WINDOWS * IP_BINS
    ids = rand(0, bins_a, n)
    w = rand(0, 4, n).float()
    kern = lambda: histogram(ids, bins_a, w, backend="cuda")
    plain = lambda: histogram(ids, bins_a, w, backend="torch")
    same(f"(a) 2^{SCALE} rows -> {bins_a} float bins", kern(), plain())
    ids_long = ids.long()
    shapes.append({
        "case": f"a: ids int32 (2^{SCALE},), weights float32, {bins_a} bins",
        "ms": time_ms(kern), "plain_ms": time_ms(plain),
        "library_ms": time_ms(lambda: torch.bincount(ids_long, w, minlength=bins_a)),
        "bound_ms": (8 * n + 4 * bins_a) / HBM_BYTES_PER_S * 1e3,
    })

    # (b) the fused path's gated int32 sum into capacity + 1 segments: sorted
    # segment ids (a plan's segmentation), window ids as the gate
    segs = n + 1
    seg = torch.sort(rand(0, segs, n))[0]
    gate = rand(0, N_WINDOWS + 1, n)
    wi = rand(0, 3, n)
    kw = dict(op="sum", gate_ids=gate, gate_value=3, out_dtype=torch.int32)
    kern = lambda: segmented_reduce(wi, seg, segs, backend="cuda", **kw)
    plain = lambda: segmented_reduce(wi, seg, segs, backend="torch", **kw)
    same(f"(b) gated int32 sum, 2^{SCALE} rows -> 2^{SCALE}+1 segments",
         kern(), plain())
    seg_long, gated_w = seg.long(), torch.where(gate == 3, wi, 0).float()
    shapes.append({
        "case": f"b: seg int32 (2^{SCALE},), gate int32, weights int32, "
                f"2^{SCALE}+1 segments",
        "ms": time_ms(kern), "plain_ms": time_ms(plain),
        "library_ms": time_ms(lambda: torch.bincount(seg_long, gated_w,
                                                      minlength=segs)),
        "bound_ms": (12 * n + 4 * segs) / HBM_BYTES_PER_S * 1e3,
    })

    # (c) init + valid_mask/retire, both accumulators, shared and global paths
    for nb, acc, retire in ((bins_a, None, -1.5),
                            ((1 << 16) + 1, torch.int32, -2 ** 31)):
        m = 1 << 20
        ids_c, w_c = rand(0, nb, m), rand(0, 5, m)
        init = rand(-3, 3, nb)
        mask = rand(0, 2, nb).bool()
        kw = dict(init=init, valid_mask=mask, retire=retire, out_dtype=acc)
        same(f"(c) init + valid_mask/retire, {nb} bins, acc {acc or torch.float32}",
             segmented_reduce(w_c, ids_c, nb, backend="cuda", **kw),
             segmented_reduce(w_c, ids_c, nb, backend="torch", **kw))

    # (d) no rows: the output is init (then retired), or zeros
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    init = rand(0, 9, 64).float()
    mask = rand(0, 2, 64).bool()
    for kw in (dict(), dict(init=init), dict(init=init, valid_mask=mask, retire=7.0)):
        same(f"(d) n == 0 with {sorted(kw)}",
             histogram(empty, 64, backend="cuda", **kw),
             histogram(empty, 64, backend="torch", **kw))

    # (e) out-of-range and negative ids are dropped, on both kernel paths
    for nb in (1000, 20000):
        ids_e = rand(-100, nb + 100, 1 << 20)
        same(f"(e) ids in [-100, {nb}+100) -> {nb} bins",
             histogram(ids_e, nb, backend="cuda"),
             histogram(ids_e, nb, backend="torch"))

    # (f) random float weights: atomics add in no fixed order.  Tolerance:
    # a sum of k terms in any order is within (k-1) * 2^-24 * sum|w| of any
    # other order, so |kernel - plain| <= 2 * k_max * 2^-24 * sum|w| per bin
    w_f = torch.randn(n, generator=g, device=dev)
    got = histogram(ids, bins_a, w_f, backend="cuda").double()
    want = histogram(ids, bins_a, w_f, backend="torch").double()
    k_max = torch.bincount(ids_long, minlength=bins_a).max().item()
    abs_sum = torch.zeros(bins_a, dtype=torch.float64, device=dev).index_add_(
        0, ids_long, w_f.abs().double())
    err = (got - want).abs()
    tol = 2 * k_max * 2.0 ** -24 * abs_sum
    if not bool((err <= tol).all()):
        raise AssertionError(f"(f) random float weights: max |diff| "
                             f"{err.max().item()} beyond tolerance")
    max_err = max(max_err, err.max().item())
    log(f"  (f) random float weights: max |diff| {err.max().item():.3g} "
        f"(tolerance 2 * {k_max} * 2^-24 * sum|w| per bin)")
    return max_err, shapes


def main_path(dev, workdir: str):
    """Phase 3: the port's challenge run at scale 24, default and fused,
    sharing one capture in ``workdir``."""
    import numpy as np
    import torch
    from repro_torch.challenge.pipeline import (ChallengeConfig, _window_activity,
                                                run_challenge)
    from repro_torch.challenge.run import format_queries, verify_scalars
    from repro_torch.convert import results_to_numpy
    from repro_torch.core.ref import ref_run_all_queries
    from repro_torch.kernels import histogram as hist_kernel

    runs, launches = {}, {}
    for name, fused in (("default", False), ("fused_epilogue", True)):
        cfg = ChallengeConfig(scale=SCALE, method="hash", fused_epilogue=fused,
                              n_windows=N_WINDOWS, ip_bins=IP_BINS,
                              workdir=workdir, device=str(dev))
        hist_kernel.LAUNCHES = 0
        run = run_challenge(cfg)
        launches[name] = hist_kernel.LAUNCHES
        # per analyze call: the activity histogram, plus with the fused
        # epilogue 4 gated sums per window per plan side and the top-k sum;
        # the warm pass runs analyze a second time
        per_analyze = 1 + (2 * N_WINDOWS * 4 + 1 if fused else 0)
        want = per_analyze * (2 if cfg.warm else 1)
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} histogram kernel "
                                 f"launches, the code implies {want}")
        log(f"\n[{name}] {launches[name]} histogram kernel launches "
            f"(= {want}); phase walls:")
        log(run.timings.format_table())
        runs[name] = run

    cap = runs["default"].capture
    t0 = time.perf_counter()
    ref = ref_run_all_queries(cap["src"].astype(np.int64),
                              cap["dst"].astype(np.int64))
    log(f"\nNumPy oracle in {time.perf_counter() - t0:.1f} s")
    for name, run in runs.items():
        if verify_scalars(run, ref):
            raise AssertionError(f"{name}: scalars disagree with the NumPy oracle")
        log(f"[{name}] all scalar queries match the NumPy oracle")
    log(format_queries(runs["default"].results))

    a = results_to_numpy(runs["default"].results)
    b = results_to_numpy(runs["fused_epilogue"].results)
    diff = [k for k in a if not np.array_equal(a[k], b[k])]
    if a.keys() != b.keys() or diff:
        raise AssertionError(f"default and fused runs differ in {diff}")
    log(f"default and fused_epilogue results identical ({len(a)} arrays)")

    res, table = runs["default"].results, runs["default"].anon_table
    plain = _window_activity(table, N_WINDOWS, IP_BINS, backend="torch")
    if not torch.equal(res.window_activity, plain):
        raise AssertionError("window activity: kernel != plain on the main path")
    per_window = res.window_activity.sum(dim=1).to(torch.int32)
    if not torch.equal(per_window, res.windowed["valid_packets"]):
        raise AssertionError("window activity does not sum to per-window packets")
    if not bool(torch.isfinite(res.window_activity).all()):
        raise AssertionError("window activity is not finite")
    log("window activity: kernel == plain version, rows sum to per-window packets")
    return launches


def cli_defaults() -> None:
    """Phase 4: the CLI as a user calls it, with its defaults (the card,
    ``device="cuda"``, shuffle anonymization), at scale 20."""
    from repro_torch.challenge.run import main

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as workdir:
        rc = main(["--scale", "20", "--workdir", workdir])
    if rc != 0:
        raise AssertionError(f"python -m repro_torch.challenge.run exited {rc}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.obs import run_context

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"context: {json.dumps(run_context())}")

    log("\n== phase 1: build")
    build_kernel()

    log("\n== phase 2: histogram kernel against its plain version")
    max_err, shapes = check_kernels(dev)
    for s in shapes:
        log("  " + json.dumps(s))

    log(f"\n== phase 3: main path, run_challenge at scale {SCALE}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches = main_path(dev, workdir)

    log("\n== phase 4: the CLI with its defaults, scale 20")
    cli_defaults()

    head = shapes[0]
    record = {
        "name": "histogram",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/histogram.cu",
        "replaces": "src/repro/kernels/histogram.py:108",
        "launches": sum(launches.values()),
        "launches_by_run": launches,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "shapes": shapes,
    }
    if not all(math.isfinite(record[k]) for k in ("ms", "plain_ms", "bound_ms")):
        raise AssertionError("non-finite timing")
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
