#!/usr/bin/env python3
"""Time the port's histogram and Count-Min kernels on one card at the main
path's shapes: by CUDA events, on the device alone and on the host alone.

    python3 tools/time_histogram_cms.py [--src DIR] [--cases a,a-rmat,b,n,o,j,j-f32]

``--src`` imports ``repro_torch`` from another checkout's ``src`` (for
example an unpacked parent commit), so two versions of the kernels can be
timed in one call on one card.  The timers are ``chip_smoke.py``'s:
``time_ms`` (CUDA events around 20 calls), ``device_time_ms`` (the same
calls queued behind a sleep kernel, the host's work left out) and
``host_time_ms`` (``time.perf_counter_ns`` around the calls queued behind
the sleep: the wrapper's host work alone).  The shapes are phase 2's:
(a) 2^24 int32 ids into 8,192 float32 bins, (a-rmat) the same with the
activity ids of an RMAT capture (``chip_smoke.rmat_activity_ids``), (b)
a gated int32 sum of 2^24 sorted ids into 2^24 + 1 segments, (n) 2^20
float32 values into 2^21 slots with ``valid_mask``, (o) 2^20 int32 counts,
sorted with -1 padding, into 2^21 int32 segments, (j) Count-Min, int32
(4, 4,096) cells and 2^15 proposals, and (j-f32) its float32 twin.
Values are integer-valued, so every result is held bit-equal to the plain
version.  Where the Count-Min wrapper takes ``path``, both paths are
timed.  Each shape also times its library yardstick, with its spill index
inside the call.  One JSON line a shape, then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the timers; puts this checkout's src on the path)

CASES = ("a", "a-rmat", "b", "n", "o", "j", "j-f32")


def hist_case(dev, name, g):
    """(kernel call, plain call, {library name: call}, bound ms) of a
    histogram shape."""
    import torch
    from repro_torch.kernels.ops import histogram, segmented_reduce

    rand = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=g, device=dev,
                                           dtype=torch.int32)
    spill = lambda ids, bins, ok=None: torch.where(
        (ids >= 0) & (ids < bins) if ok is None else ok, ids, bins).long()
    n, m = 1 << chip_smoke.SCALE, 1 << chip_smoke.ALGO_SCALE
    rate = chip_smoke.HBM_BYTES_PER_S
    if name in ("a", "a-rmat"):
        bins = chip_smoke.N_WINDOWS * chip_smoke.IP_BINS
        ids = rand(0, bins, n) if name == "a" else chip_smoke.rmat_activity_ids(dev)
        w = rand(0, 4, n).float()
        return (lambda: histogram(ids, bins, w, backend="cuda"),
                lambda: histogram(ids, bins, w, backend="torch"),
                {"bincount": lambda: torch.bincount(ids.long(), w, minlength=bins),
                 "index_add_": lambda: torch.zeros(bins + 1, device=dev).index_add_(
                     0, spill(ids, bins), w)[:bins]},
                (8 * n + 4 * bins) / rate * 1e3)
    if name == "b":
        segs = n + 1
        seg = torch.sort(rand(0, segs, n))[0]
        gate = rand(0, chip_smoke.N_WINDOWS + 1, n)
        w = rand(0, 3, n)
        kw = dict(op="sum", gate_ids=gate, gate_value=3, out_dtype=torch.int32)
        return (lambda: segmented_reduce(w, seg, segs, backend="cuda", **kw),
                lambda: segmented_reduce(w, seg, segs, backend="torch", **kw),
                {"index_add_": lambda: torch.zeros(
                    segs + 1, dtype=torch.int32, device=dev).index_add_(
                    0, spill(seg, segs, gate == 3), w)[:segs]},
                (12 * n + 4 * segs) / rate * 1e3)
    segs = 2 * m
    if name == "n":
        vals = rand(0, 8, m).float()
        seg = torch.where(rand(0, 8, m) == 0, -1, rand(0, segs, m))
        live = rand(0, 4, segs) != 0
        kw = dict(op="sum", valid_mask=live, retire=0.0)
        return (lambda: segmented_reduce(vals, seg, segs, backend="cuda", **kw),
                lambda: segmented_reduce(vals, seg, segs, backend="torch", **kw),
                {"index_add_": lambda: torch.zeros(segs + 1, device=dev).index_add_(
                    0, spill(seg, segs), vals)[:segs].masked_fill(~live, 0.0)},
                (8 * m + 5 * segs) / rate * 1e3)
    live_e = m - m // 8
    counts = rand(0, 40, m)
    seg = torch.cat([torch.sort(rand(0, segs, live_e))[0],
                     torch.full((m - live_e,), -1, dtype=torch.int32, device=dev)])
    kw = dict(op="sum", out_dtype=torch.int32)
    return (lambda: segmented_reduce(counts, seg, segs, backend="cuda", **kw),
            lambda: segmented_reduce(counts, seg, segs, backend="torch", **kw),
            {"index_add_": lambda: torch.zeros(
                segs + 1, dtype=torch.int32, device=dev).index_add_(
                0, spill(seg, segs), counts)[:segs]},
            (8 * m + 4 * segs) / rate * 1e3)


def cms_case(dev, name, g):
    """(calls by path, plain call, {library name: call}, bound ms) of a
    Count-Min shape."""
    import torch
    from repro_torch.kernels import sketch
    from repro_torch.kernels.ops import cms_update

    rand = lambda lo, hi, *shape: torch.randint(lo, hi, shape, generator=g,
                                                device=dev, dtype=torch.int32)
    depth, width, n = 4, 4096, chip_smoke.SKETCH_BATCH
    counts = rand(0, 1 << 26, depth, width)
    cols = torch.where(rand(0, 4, 1, n) == 0, -1, rand(0, width, depth, n))
    props = rand(0, 1 << 27, n)
    if name == "j-f32":
        counts, props = counts.float(), props.float()
    rows = torch.arange(depth, device=dev)[:, None] * width

    def library():
        flat = torch.where(cols >= 0, rows + cols, depth * width).long().reshape(-1)
        cells = torch.cat([counts.reshape(-1), counts.new_zeros(1)])
        return cells.scatter_reduce_(0, flat, props.expand(depth, n).reshape(-1),
                                     "amax")[:-1].view(depth, width)

    calls = {"kernel": lambda: cms_update(counts, cols, props, backend="cuda")}
    if "path" in inspect.signature(sketch.cms_update_cuda).parameters:
        for path in ("cluster", "cooperative"):
            calls[path] = (lambda p: lambda: sketch.cms_update_cuda(
                counts, cols, props, path=p))(path)
    return (calls, lambda: cms_update(counts, cols, props, backend="torch"),
            {"scatter_reduce_": library},
            (4 * depth * n + 4 * n + 8 * depth * width) / chip_smoke.HBM_BYTES_PER_S * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="import repro_torch from this src directory")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--no-library", action="store_true",
                    help="time the kernels alone, not their library yardsticks")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("time_histogram_cms: torch sees no CUDA device", file=sys.stderr)
        return 1
    import repro_torch

    dev = torch.device("cuda", 0)
    print(json.dumps({"repro_torch": os.path.dirname(repro_torch.__file__)}), flush=True)
    g = torch.Generator(device=dev).manual_seed(3)
    for name in filter(None, args.cases.split(",")):
        if name.startswith("j"):
            calls, plain, library, bound = cms_case(dev, name, g)
        else:
            kern, plain, library, bound = hist_case(dev, name, g)
            calls = {"kernel": kern}
        want = plain()
        rec = {"case": name, "bound_ms": bound}
        for way, call in calls.items():
            if not torch.equal(call(), want):
                raise AssertionError(f"{name}, {way}: kernel != plain")
            rec[f"{way}_ms"] = chip_smoke.time_ms(call)
            rec[f"{way}_device_ms"] = chip_smoke.device_time_ms(call)
            rec[f"{way}_host_ms"] = chip_smoke.host_time_ms(call)
            rec[f"{way}_kernels_per_call"] = len(chip_smoke.device_ops(call))
        for lib, call in ({} if args.no_library else library).items():
            rec[f"{lib}_ms"] = chip_smoke.time_ms(call)
            rec[f"{lib}_device_ms"] = chip_smoke.device_time_ms(call, may_sync=True)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
