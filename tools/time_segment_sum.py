#!/usr/bin/env python3
"""Time the port's segment-sum kernel on one card at the GNN regimes and
across the planner's direct/partitioned crossover.

    python3 tools/time_segment_sum.py [--src DIR] [--regimes a,b] [--crossover] [--hubs]

``--src`` imports ``repro_torch`` from another checkout's ``src`` (for
example an unpacked parent commit), so two versions of the kernel can be
timed in one call on one card; the timers are ``chip_smoke.py``'s
(``time_ms``: CUDA events around 20 calls; ``device_time_ms``: the same
calls queued behind a sleep kernel, the host's work left out).  Each
regime of ``configs/common_gnn.py`` (molecule at a hidden width of 64,
full_graph_sm, minibatch_lg, ogb_products: edges x features into the node
capacity, random receivers over the real nodes, padding edges at the
capacity) gets integer-valued float32 rows; the kernel's result is held
bit-equal to ``index_add_``'s, which is timed beside it with its spill
index inside the call.  Where the wrapper takes ``partition``, the direct
and the partitioned launch are timed too (the direct one only where its
blocks read at most 2^31 ids in all).  ``--crossover`` adds 2^15 to
2^19 rows into 4,096 segments of 64 features, both ways; ``--hubs`` the
molecule regime and 2^18 rows x 64 features into 4,096 segments with half
the rows on one segment, and ogb_products with 17,481 rows on one node
(ogbn-products' largest degree) besides its random receivers.  One JSON
line a shape, then the card's name and power limit.
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

# (edges, real edges, features, node capacity, real nodes)
REGIMES = {
    "molecule": (8192, 8192, 64, 4096, 3840),
    "full_graph_sm": (10752, 10556, 1433, 2816, 2708),
    "minibatch_lg": (168960, 168960, 602, 170496, 169984),
    "ogb_products": (61865984, 61859140, 100, 2449920, 2449029),
}


def time_shape(dev, case, n, real, d, segs, nodes, g, hub=0):
    import torch
    from repro_torch.kernels import segment_matmul as k

    recv = torch.randint(0, nodes, (n,), generator=g, device=dev, dtype=torch.int32)
    recv[real:] = segs
    if hub:  # the first `hub` real rows, evenly spread, to one node
        recv[torch.arange(hub, device=dev) * (real // hub)] = nodes // 2
    x = torch.randint(-8, 9, (n, d), generator=g, device=dev, dtype=torch.float32)
    library = lambda: torch.zeros(segs + 1, d, device=dev).index_add_(
        0, torch.where(recv < segs, recv, segs).long(), x)[:segs]
    want = library()
    rec = {"case": case, "n": n, "d": d, "segments": segs, "hub_rows": hub,
           "bound_ms": (4 * n * d + 4 * n + 4 * segs * d)
           / chip_smoke.HBM_BYTES_PER_S * 1e3}
    ways = {"kernel": {}}
    if "partition" in inspect.signature(k.segment_matmul_cuda).parameters:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rec["plan"] = k.plan_segment_sum(n, d, segs, sms)._asdict()
        ways["partitioned"] = {"partition": True}
        tiles = -(-segs // rec["plan"]["ts"]) * -(-d // rec["plan"]["tf"])
        if n * tiles <= 1 << 31:  # else every direct block reads ids for seconds
            ways["direct"] = {"partition": False}
    for way, kw in ways.items():
        call = lambda: k.segment_matmul_cuda(x, recv, segs, **kw)
        if not torch.equal(call(), want):
            raise AssertionError(f"{case}, {way}: differs from index_add_")
        rec[f"{way}_ms"] = chip_smoke.time_ms(call)
        rec[f"{way}_device_ms"] = chip_smoke.device_time_ms(call)
    rec["library_ms"] = chip_smoke.time_ms(library)
    rec["library_device_ms"] = chip_smoke.device_time_ms(library, may_sync=True)
    print(json.dumps(rec), flush=True)
    del x, recv, want
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="import repro_torch from this src directory")
    ap.add_argument("--regimes", default=",".join(REGIMES))
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--hubs", action="store_true")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("time_segment_sum: torch sees no CUDA device", file=sys.stderr)
        return 1
    import repro_torch

    dev = torch.device("cuda", 0)
    print(json.dumps({"repro_torch": os.path.dirname(repro_torch.__file__)}))
    g = torch.Generator(device=dev).manual_seed(7)
    for name in filter(None, args.regimes.split(",")):
        time_shape(dev, name, *REGIMES[name], g)
    if args.crossover:
        for log_n in range(15, 20):
            n = 1 << log_n
            time_shape(dev, f"crossover 2^{log_n}", n, n, 64, 4096, 4096, g)
    if args.hubs:
        time_shape(dev, "molecule, hub of 4,096", *REGIMES["molecule"], g, hub=4096)
        time_shape(dev, "2^18 rows, hub of 2^17", 1 << 18, 1 << 18, 64, 4096, 4096, g,
                   hub=1 << 17)
        time_shape(dev, "ogb_products, hub of 17,481", *REGIMES["ogb_products"], g,
                   hub=17481)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
