#!/usr/bin/env python3
"""Where the time of the port's device phases goes, on one NVIDIA card.

Builds the challenge table at ``--scale`` (``method="hash"``), then for
each phase named in ``--phases`` measures the host wall of ``--reps`` calls,
each ending in ``torch.cuda.synchronize()``, and traces one more call with
``torch.profiler``: the device's busy time (the union of its kernel and
copy intervals), its idle share of the traced wall, and the kernels that
take the most device time.  One JSON line per phase; needs a card.

Phases: ``build_device``, ``anonymize``, ``analyze`` and ``analyze_fused``
(the default set); ``analyze_naive`` and ``analyze_grid``, the A/B
baselines (``use_plan=False``, ``windowed_method="grid"``);
``fused_replay``, one run of the ``--fused`` path's CUDA graph (the pinned
copies of the columns and a replay of build's device part, anonymize and
analyze); ``bfs`` (from the heaviest link's source),
``components``, ``pagerank`` and ``triangles`` over the anonymized
table's CSR pair, as ``analyze(algorithms=True)`` runs them;
``sketch_batch``, one ``update_sketch`` of the capture's first 2^15 rows;
``stream_ingest``, the streaming engine's ``stream_plq`` of the capture's
first 8 row groups of 2^18 rows (a plq file) into one exact-tier engine
with ``link_capacity`` the capture's packets, the same engine each call;
and, on random inputs of ``chip_smoke.py``'s shapes (no table is built for
them), 20 back-to-back calls of one kernel wrapper or of the one PyTorch
call that computes the same function: ``segmax_vxm`` (2^20 float32 values
into 2^21 segments with ``valid_mask``), ``hll_fold`` (2^15 rows into 4,096
registers with ``init``) and ``cms_fold`` (int32 (4, 4096) cells, 2^15
proposals), each with a ``_library`` twin (``scatter_reduce_``, ``amax``),
``hist_activity`` (2^24 int32 ids into 8,192 float32 bins, the activity
histogram's shape) and ``hist_gated`` (a gated int32 sum of 2^24 sorted
ids into 2^24 + 1 segments, the fused epilogue's), each with a twin
(``index_add_``),
``segment_reduce`` (full_graph_sm's 10,752 x 1,433 float32 messages
into 2,816 segments, the kernel's direct launch) and ``segment_reduce_lg``
(minibatch_lg's 168,960 x 602 into 170,496, its partitioned launch), each
with a twin (``index_add_``); every twin builds its
indices, casts, fills and masks inside the call, as the wrappers do.  Their
device events split each wrapper's device time from its host work, and
their records count the device kernels of one call (``kernels_per_call``:
one for each of the port's wrappers).

LM serving, granite-8b at full width with ``--layers`` layers (default all
36), bf16, weights drawn on the card, four requests: ``lm_prefill`` (2,048
prompt tokens each into a 2,080-slot cache) and ``lm_decode`` (8 decode
steps from position 2,048).  Their records add the device time of the
attention kernel (its prefill path in ``lm_prefill``, its split-kv decode
path and combine in ``lm_decode``), of the matrix products and of the rest.

MoE serving, mixtral-8x7b at full width cut to ``chip_smoke.py``'s 8
layers, bf16, weights drawn on the card, two requests: ``moe_prefill``
(6,144 prompt tokens each, past the 4,096-key window, into a 6,176-slot
cache) and ``moe_decode`` (8 decode steps from position 6,144).  Their
records add the device time of the attention kernel, of the segment-sum
kernel (the combine), of the expert SwiGLUs' products, of the dispatch
(the router, its sort, the group-by's argsort and scans, the buffers'
scatters and gathers), of the other matrix products and of the rest; a
kernel counts under the experts, the combine or the dispatch when the
profiler's CPU range around those calls (added here, not in the port)
launched it.

LM training, ``lm_train``: one ``Trainer`` step of minicpm-2b at full size
(40 layers, bf16, remat, weights drawn on the card) on 4 x 2,048 tokens of
``lm_batches``, AdamW as the reference launcher sets it.  Its record adds
the device time of the attention kernel's forward (twice a layer: remat),
of the plain attention's backward (``FlashAttention.backward``: the plain
version recomputed and differentiated), of the optimizer
(``adamw_update``), of the other matrix products and of the rest; a kernel
counts under the backward or the optimizer when the profiler's CPU range
around those calls (added here, not in the port) launched it.

MoE training, ``moe_train``: one step of mixtral-8x7b's train_4k cell at
full width cut to ``chip_smoke.py``'s 3 layers, 4 x 2,048 tokens, remat
"nothing", the reference's LM AdamW (the model and its state built when the
phase comes, and freed after it).  Its record adds the device time of the
attention kernel (forward, and again under remat), of the plain attention's
backward, of the segment-sum kernel (the combine, forward and recomputed)
and of its backward (``SegmentSum.backward``, a gather), of the expert
SwiGLUs' forward products (recomputed too; their backward products count
under the matrix products), of the dispatch, of AdamW and of the rest.
xDeepFM training, ``xdeepfm_train``: one step of its train_batch cell at
the published size (65,536 rows): the CIN's products (``_cin_rows``, its
forward and its recompute; the backward's products under the matrix
products), the gathers (``_lookup``) and their gradient (autograd's
``index_add_``, by kernel name), AdamW over the 1.68 GB of tables and the
rest.

GNN training, ``gnn_<config>_<shape>``: one training step of
``configs/<config>`` (schnet, pna, egnn, graphsage_reddit) at its published
widths on ``chip_smoke.py``'s phase-12 graph of ``<shape>`` (molecule,
full_graph_sm, minibatch_lg; ``gnn_graphsage_reddit_ogb_products`` too),
the state advancing from call to call.  Its record adds the device time of
the segment-sum and segment-max kernels, of the matrix products and of the
rest.  ``gnn_graphsage_reddit_ogb_products`` needs
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` in the environment
(``chip_smoke.py``'s ``OGB_ALLOC_CONF`` says why).

    python3 tools/profile_torch_challenge.py --scale 24
    python3 tools/profile_torch_challenge.py --phases analyze analyze_naive analyze_grid fused_replay
    python3 tools/profile_torch_challenge.py --scale 20 --phases bfs components pagerank triangles
    python3 tools/profile_torch_challenge.py --phases stream_ingest
    python3 tools/profile_torch_challenge.py --phases hll_fold hll_fold_library
    python3 tools/profile_torch_challenge.py --phases hist_activity hist_gated cms_fold
    python3 tools/profile_torch_challenge.py --phases lm_prefill lm_decode --layers 36
    python3 tools/profile_torch_challenge.py --phases lm_train --reps 3
    python3 tools/profile_torch_challenge.py --phases moe_prefill moe_decode
    python3 tools/profile_torch_challenge.py --phases gnn_pna_molecule gnn_pna_minibatch_lg
    python3 tools/profile_torch_challenge.py --phases moe_train xdeepfm_train --reps 1
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


def profile_phase(name, fn, reps, top, calls=None):
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
        # a session after the first may drop the device events that come
        # right after its start: a marker kernel, and a pause, first
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.2)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and "spin_kernel" not in e.name and e.name not in RANGES]
    by_name = {}
    for e in dev:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           cnt + 1)
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in dev]) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    families = {}
    for k, (ms, _) in by_name.items():
        fam = _family(k)
        families[fam] = families.get(fam, 0.0) + ms
    ranged = _ranged_kernel_ms(prof.events())
    for fam, ms in ranged.items():  # move them out of their name's family
        for k, k_ms in ms.items():
            families[_family(k)] -= k_ms
            families[fam] = families.get(fam, 0.0) + k_ms
    rec = {
        "phase": name,
        "wall_ms_median": statistics.median(walls),
        "wall_ms": walls,
        "traced_wall_ms": traced_ms,
        "device_events": len(dev),
        "device_busy_ms": busy_ms if dev else "not measured",
        "idle_share_of_traced_wall": 1 - busy_ms / traced_ms if dev else "not measured",
        "top_device_ms": [{"name": k[:90], "ms": v[0], "count": v[1]}
                          for k, v in ranked],
        "device_ms_by_family": families,
    }
    if calls:  # a kernel phase: CALLS calls of one wrapper or library call
        rec["kernels_per_call"] = {k[:90]: cnt / calls
                                   for k, (_, cnt) in by_name.items()}
        rec["device_events_per_call"] = len(dev) / calls
    return rec


# profiler ranges whose kernels form a family of their own (lm_train,
# moe_*; the innermost range counts); the profiler also shows each range on
# the device's timeline, under its name, which is no device work
RANGES = {"plain_attention_backward": "plain attention backward",
          "adamw_update": "optimizer",
          "moe_dispatch": "MoE dispatch",
          "moe_experts": "expert matmuls",
          "moe_combine": "segment-sum kernel",
          "segment_sum_backward": "segment-sum backward (gather)",
          "cin_products": "CIN products (forward, recompute)",
          "gathers": "gathers"}


def _ranged_kernel_ms(events) -> dict:
    """Device ms of the kernels that a CPU op inside one of ``RANGES``
    launched, by family and kernel name: the innermost range's family."""
    out = {}
    for e in events:
        if not getattr(e, "kernels", None):
            continue
        parent = e
        while parent is not None and parent.name not in RANGES:
            parent = parent.cpu_parent
        if parent is None:
            continue
        fam = out.setdefault(RANGES[parent.name], {})
        for k in e.kernels:
            fam[k.name] = fam.get(k.name, 0.0) + k.duration / 1e3
    return out


def _family(kernel_name: str) -> str:
    """The port's own kernels by name; cuBLAS's matrix products (``gemm``,
    ``nvjet``, ``cutlass``, ``xmma``); everything else."""
    name = kernel_name.lower()
    for fam, keys in (("attention kernel", ("fa_prefill", "fa_decode", "fa_fwd")),
                      ("segment-sum kernel", ("segment_sum_tiles",)),
                      ("segment-max kernel", ("segmax_",)),
                      ("histogram kernel", ("hist_private", "hist_scatter")),
                      ("Count-Min kernel", ("cms_cluster", "cms_cooperative")),
                      ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
                      ("index_add (gathers' gradient)", ("indexfunc",))):
        if any(key in name for key in keys):
            return fam
    return "other"


TABLE_PHASES = ("build_device", "anonymize", "analyze", "analyze_fused",
                "analyze_naive", "analyze_grid", "fused_replay", "bfs",
                "components", "pagerank", "triangles", "sketch_batch",
                "stream_ingest")
KERNEL_PHASES = tuple(f"{k}{s}" for k in ("segmax_vxm", "hll_fold", "cms_fold",
                                           "hist_activity", "hist_gated",
                                           "segment_reduce", "segment_reduce_lg")
                      for s in ("", "_library"))
LM_PHASES = ("lm_prefill", "lm_decode")
MOE_PHASES = ("moe_prefill", "moe_decode")
TRAIN_PHASES = ("lm_train",)
# built when their turn comes and freed after it: each holds most of the card
LAZY_PHASES = ("moe_train", "xdeepfm_train")
GNN_PHASES = tuple(f"gnn_{c}_{s}" for s in ("molecule", "full_graph_sm", "minibatch_lg")
                   for c in ("schnet", "pna", "egnn", "graphsage_reddit")
                   ) + ("gnn_graphsage_reddit_ogb_products",)
PHASES = (TABLE_PHASES + KERNEL_PHASES + LM_PHASES + MOE_PHASES + TRAIN_PHASES
          + GNN_PHASES + LAZY_PHASES)
CALLS = 20  # back-to-back calls per kernel phase
LM_BATCH, LM_PROMPT, LM_SLOTS, LM_STEPS = 4, 2048, 2080, 8
MOE_LAYERS, MOE_BATCH, MOE_PROMPT, MOE_SLOTS = 8, 2, 6144, 6176  # chip_smoke's
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
STREAM_BATCH, STREAM_BATCHES = 1 << 18, 8  # stream_ingest: row groups a call


def kernel_phases(dev):
    """The kernel phases: each runs CALLS calls of a wrapper (``backend=
    "cuda"``) or of its library twin on inputs pre-masked for it."""
    import torch
    from repro_torch.kernels.ops import (cms_update, histogram, hll_update,
                                         segment_reduce, segmented_reduce)

    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda lo, hi, *shape: torch.randint(lo, hi, shape, generator=g,
                                                device=dev, dtype=torch.int32)
    ninf = float("-inf")
    n, segs = 1 << 20, 2 << 20
    vals = torch.randn(n, generator=g, device=dev)
    seg = torch.where(rand(0, 8, n) == 0, -1, rand(0, segs, n))
    mask = rand(0, 4, segs) != 0
    m, rows = 4096, 1 << 15
    regs = rand(0, 20, m).float()
    reg_ids = torch.where(rand(0, 16, rows) == 0, -1, rand(0, m, rows))
    rhos = rand(1, 22, rows)
    depth = 4
    counts = rand(0, 1 << 26, depth, m)
    cols = torch.where(rand(0, 4, 1, rows) == 0, -1, rand(0, m, depth, rows))
    props = rand(0, 1 << 27, rows)
    row0 = torch.arange(depth, device=dev)[:, None] * m
    # the activity histogram (2^24 ids into 8 windows x 1,024 bins) and the
    # fused epilogue's gated sum (2^24 sorted ids into 2^24 + 1 segments,
    # window ids as the gate)
    big, bins = 1 << 24, 8192
    act = rand(0, bins, big)
    ones = torch.ones(big, device=dev)
    segs_b = big + 1
    seg_b = torch.sort(rand(0, segs_b, big))[0]
    gate_b = rand(0, 9, big)
    w_b = rand(0, 3, big)
    # full_graph_sm: 10,752 edges (196 padding, at the capacity) x 1,433
    # features into 2,816 node slots
    edges, feats, nodes = 10752, 1433, 2816
    recv = rand(0, 2708, edges)
    recv[10556:] = nodes
    msgs = torch.randn(edges, feats, generator=g, device=dev)
    # minibatch_lg: 168,960 edges x 602 features into 170,496 node slots
    lg_edges, lg_feats, lg_nodes = 168960, 602, 170496
    lg_recv = rand(0, 169984, lg_edges)
    lg_msgs = torch.randn(lg_edges, lg_feats, generator=g, device=dev)
    one = {
        "segmax_vxm": lambda: segmented_reduce(
            vals, seg, segs, op="max", valid_mask=mask, retire=ninf,
            backend="cuda"),
        # the library twins compute what the wrappers compute, as
        # chip_smoke.py's yardsticks do: spill and flat indices, casts, fills,
        # masks and the copy of the registers or cells inside the call
        "segmax_vxm_library": lambda: torch.full(
            (segs + 1,), ninf, device=dev).scatter_reduce_(
            0, torch.where(seg >= 0, seg, segs).long(), vals, "amax"
        )[:segs].masked_fill(~mask, ninf),
        "hll_fold": lambda: hll_update(regs, reg_ids, rhos, backend="cuda"),
        "hll_fold_library": lambda: torch.cat(
            [regs, regs.new_full((1,), ninf)]).scatter_reduce_(
            0, torch.where(reg_ids >= 0, reg_ids, m).long(), rhos.float(),
            "amax")[:m],
        "cms_fold": lambda: cms_update(counts, cols, props, backend="cuda"),
        "cms_fold_library": lambda: torch.cat(
            [counts.reshape(-1), counts.new_zeros(1)]).scatter_reduce_(
            0, torch.where(cols >= 0, row0 + cols, depth * m).long().reshape(-1),
            props.expand(depth, rows).reshape(-1), "amax")[:-1].view(depth, m),
        "hist_activity": lambda: histogram(act, bins, ones, backend="cuda"),
        "hist_activity_library": lambda: torch.zeros(bins + 1, device=dev).index_add_(
            0, torch.where((act >= 0) & (act < bins), act, bins).long(), ones)[:bins],
        "hist_gated": lambda: segmented_reduce(
            w_b, seg_b, segs_b, gate_ids=gate_b, gate_value=3,
            out_dtype=torch.int32, backend="cuda"),
        "hist_gated_library": lambda: torch.zeros(
            segs_b + 1, dtype=torch.int32, device=dev).index_add_(
            0, torch.where(gate_b == 3, seg_b, segs_b).long(), w_b)[:segs_b],
        "segment_reduce": lambda: segment_reduce(msgs, recv, nodes, backend="cuda"),
        "segment_reduce_library": lambda: torch.zeros(
            nodes + 1, feats, device=dev).index_add_(
            0, torch.where(recv < nodes, recv, nodes).long(), msgs)[:nodes],
        "segment_reduce_lg": lambda: segment_reduce(lg_msgs, lg_recv, lg_nodes,
                                                    backend="cuda"),
        "segment_reduce_lg_library": lambda: torch.zeros(
            lg_nodes + 1, lg_feats, device=dev).index_add_(
            0, torch.where(lg_recv < lg_nodes, lg_recv, lg_nodes).long(),
            lg_msgs)[:lg_nodes],
    }

    def repeat(fn):
        def calls():
            for _ in range(CALLS):
                fn()
        return calls
    return {k: repeat(fn) for k, fn in one.items()}


def table_phases(args, dev):
    """The phases over the challenge table at ``--scale``."""
    import torch
    from repro_torch.challenge.pipeline import (ChallengeConfig, analyze,
                                                build_columns, fused_program,
                                                read_phase)
    from repro_torch.convert import table_from_numpy
    from repro_torch.core import algorithms as alg
    from repro_torch.core.anonymize import anonymize
    from repro_torch.core.queries import (table_csrs, top_links_from_plan,
                                          traffic_matrix, unique_ips)
    from repro_torch.core.plan import plan_for_table
    from repro_torch.core.sketch import SketchConfig, init_sketch, update_sketch

    cfg = ChallengeConfig(scale=args.scale, method="hash", device=str(dev))
    with tempfile.TemporaryDirectory(prefix="profile_torch_") as workdir:
        src, dst, win, n = build_columns(read_phase(cfg, workdir), cfg)
    cols = {"src": src, "dst": dst, "win": win}
    table = table_from_numpy(cols, n, dev)
    anon = anonymize(table, method="hash").table
    print(json.dumps({"packets": n}))
    kw = dict(n_windows=cfg.n_windows, ip_bins=cfg.ip_bins, k=cfg.top_k,
              device=dev)
    phases = {
        "build_device": lambda: traffic_matrix(table_from_numpy(cols, n, dev)),
        "anonymize": lambda: anonymize(table, method="hash"),
        "analyze": lambda: analyze(anon, **kw),
        "analyze_fused": lambda: analyze(anon, fused_epilogue=True, **kw),
        "analyze_naive": lambda: analyze(anon, use_plan=False, **kw),
        "analyze_grid": lambda: analyze(anon, windowed_method="grid", **kw),
    }
    if "fused_replay" in args.phases:
        run = fused_program(cfg, (src, dst, win), n, dev, n_windows=cfg.n_windows,
                            ip_bins=cfg.ip_bins, k=cfg.top_k)
        host = [torch.from_numpy(c.copy()).pin_memory() for c in (src, dst, win)]
        phases["fused_replay"] = lambda: run(host)
    if {"bfs", "components", "pagerank", "triangles"} & set(args.phases):
        csr_src, csr_dst = table_csrs(anon)
        nv, n_live = 2 * anon.capacity, unique_ips(anon).n_unique
        source = int(top_links_from_plan(plan_for_table(anon), 1).src[0])
        phases.update({
            "bfs": lambda: alg.bfs_levels(csr_src, source, nv, n_live=n_live),
            "components": lambda: alg.connected_components(
                csr_src, nv, csr_t=csr_dst, n_live=n_live),
            "pagerank": lambda: alg.pagerank(csr_src, nv, n_live=n_live),
            "triangles": lambda: alg.triangle_counts(csr_src, nv),
        })
    if "sketch_batch" in args.phases:
        state = init_sketch(SketchConfig(), dev)
        m = min(n, 1 << 15)
        batch = [torch.from_numpy(c[:1 << 15].copy()).to(dev) for c in (src, dst)]
        phases["sketch_batch"] = lambda: update_sketch(state, *batch, m)
    if "stream_ingest" in args.phases:
        from repro_torch.data.plq import write_plq
        from repro_torch.stream import StreamConfig, StreamEngine, stream_plq

        rows = STREAM_BATCH * STREAM_BATCHES
        keep = tempfile.TemporaryDirectory(prefix="profile_torch_stream_")
        path = os.path.join(keep.name, "stream.plq")
        write_plq(path, {"src": src[:rows], "dst": dst[:rows]},
                  row_group_size=STREAM_BATCH)
        engine = StreamEngine(StreamConfig(batch_capacity=STREAM_BATCH,
                                           link_capacity=n, device=str(dev)))
        # the lambda names ``keep`` so that the directory lives as long as it
        phases["stream_ingest"] = lambda: (keep, stream_plq(engine, path, win[:rows]))
    return phases


def lm_phases(args, dev):
    """granite-8b serving at ``--layers`` layers: a prefill of four 2,048-
    token prompts, and 8 decode steps from position 2,048 (the cache's
    position set back before each call)."""
    import dataclasses

    import torch
    from repro_torch.configs import granite_8b
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(granite_8b.full_config(), n_layers=args.layers,
                              kernel_backend="cuda")
    model = Transformer(cfg, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                           device=dev)
    cache = model.init_kv_cache(LM_BATCH, LM_SLOTS)
    logits, _ = model.prefill(tokens, cache)
    first = logits.argmax(-1)

    def decode():
        cache["pos"] = LM_PROMPT
        nxt = first
        for _ in range(LM_STEPS):
            logits, _ = model.decode_step(nxt, cache)
            nxt = logits.argmax(-1)

    print(json.dumps({"model": cfg.name, "layers": cfg.n_layers,
                      "batch": LM_BATCH, "prompt": LM_PROMPT,
                      "decode_steps_per_call": LM_STEPS}))
    return {"lm_prefill": lambda: model.prefill(tokens, cache),
            "lm_decode": decode}


def moe_phases(dev):
    """mixtral-8x7b serving at MOE_LAYERS layers: a prefill of two 6,144-
    token prompts, and 8 decode steps from position 6,144 (the cache's
    position set back before each call); the MoE layer's dispatch, expert
    SwiGLUs and combine run inside profiler ranges named as in
    ``RANGES``."""
    import dataclasses

    import torch
    from repro_torch.configs import mixtral_8x7b
    from repro_torch.models import moe
    from repro_torch.models.transformer import Transformer

    def ranged(name, fn):
        def call(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return call

    moe.moe_apply_grouped = ranged("moe_dispatch", moe.moe_apply_grouped)
    moe._experts = ranged("moe_experts", moe._experts)
    moe.segment_reduce = ranged("moe_combine", moe.segment_reduce)
    cfg = dataclasses.replace(mixtral_8x7b.full_config(), n_layers=MOE_LAYERS,
                              kernel_backend="cuda")
    model = Transformer(cfg, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (MOE_BATCH, MOE_PROMPT), generator=g,
                           device=dev)
    cache = model.init_kv_cache(MOE_BATCH, MOE_SLOTS)
    logits, _ = model.prefill(tokens, cache)
    first = logits.argmax(-1)

    def decode():
        cache["pos"] = MOE_PROMPT
        nxt = first
        for _ in range(LM_STEPS):
            logits, _ = model.decode_step(nxt, cache)
            nxt = logits.argmax(-1)

    print(json.dumps({"model": cfg.name, "layers": cfg.n_layers,
                      "batch": MOE_BATCH, "prompt": MOE_PROMPT,
                      "decode_steps_per_call": LM_STEPS}))
    return {"moe_prefill": lambda: model.prefill(tokens, cache),
            "moe_decode": decode}


def train_phases(dev):
    """minicpm-2b training at full size: each call is one ``Trainer`` step
    (``run`` for one step, no log), the state advancing from call to call;
    the plain attention's backward and ``adamw_update`` run inside profiler
    ranges named as in ``RANGES``."""
    import dataclasses

    import torch
    from repro_torch.configs import minicpm_2b
    from repro_torch.convert import transformer_param_tree
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.models.transformer import Transformer, loss_fn
    from repro_torch.train import AdamWConfig, Trainer
    from repro_torch.train import loop

    backward, update = FlashAttention.backward, loop.adamw_update

    def ranged_backward(ctx, g):
        with torch.profiler.record_function("plain_attention_backward"):
            return backward(ctx, g)

    def ranged_update(*args):
        with torch.profiler.record_function("adamw_update"):
            return update(*args)

    FlashAttention.backward = staticmethod(ranged_backward)
    loop.adamw_update = ranged_update
    cfg = dataclasses.replace(minicpm_2b.full_config(), kernel_backend="cuda")
    model = Transformer(cfg, device=dev, seed=0)
    trainer = Trainer(lambda p, b: loss_fn(model, b["tokens"], b["labels"]),
                      AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100,
                                  schedule="wsd"))
    state = trainer.init_state(transformer_param_tree(model))
    batches = lm_batches(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0)
    print(json.dumps({"model": cfg.name, "layers": cfg.n_layers,
                      "params": cfg.n_params, "batch": TRAIN_BATCH,
                      "seq": TRAIN_SEQ, "remat": cfg.remat_policy}))
    return {"lm_train": lambda: trainer.run(state, batches, 1, log_every=0)}


def _ranged(name, fn):
    import torch

    def call(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return call


def moe_train_phase(dev):
    """One step a call of mixtral-8x7b's train_4k cell cut to
    ``chip_smoke.MOE_TRAIN_LAYERS``, on one batch of ``lm_batches`` staged
    on the card; the state advances from call to call."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke
    from repro_torch.configs import common
    from repro_torch.convert import transformer_param_tree
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.kernels import flash_attention, segment_matmul
    from repro_torch.models import moe
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import adamw_init

    flash_attention.FlashAttention.backward = staticmethod(_ranged(
        "plain_attention_backward", flash_attention.FlashAttention.backward))
    segment_matmul.SegmentSum.backward = staticmethod(_ranged(
        "segment_sum_backward", segment_matmul.SegmentSum.backward))
    common.adamw_update = _ranged("adamw_update", common.adamw_update)
    moe.moe_apply_grouped = _ranged("moe_dispatch", moe.moe_apply_grouped)
    moe._experts = _ranged("moe_experts", moe._experts)
    moe.segment_reduce = _ranged("moe_combine", moe.segment_reduce)
    cell = chip_smoke._moe_train_cell("full_config", chip_smoke.MOE_TRAIN_LAYERS)
    cfg = cell.abstract_args[0].cfg
    model = Transformer(cfg, device=dev, seed=0)
    opt = adamw_init(transformer_param_tree(model))
    b = next(lm_batches(chip_smoke.MOE_TRAIN_BATCH, chip_smoke.MOE_TRAIN_SEQ,
                        cfg.vocab, seed=0))
    tokens, labels = (torch.from_numpy(b[k]).to(dev) for k in ("tokens", "labels"))
    print(json.dumps({"model": cfg.name, "layers": cfg.n_layers,
                      "params": cfg.n_params, "batch": chip_smoke.MOE_TRAIN_BATCH,
                      "seq": chip_smoke.MOE_TRAIN_SEQ, "remat": cfg.remat_policy}))
    return lambda: cell.step_fn(model, opt, tokens, labels)


def xdeepfm_train_phase(dev):
    """One step a call of xDeepFM's train_batch cell at the published size,
    on one batch of ``recsys_batches`` staged on the card."""
    import torch
    from repro_torch.configs import SINGLE_POD, common, get_spec, xdeepfm
    from repro_torch.data.pipeline import recsys_batches
    from repro_torch.models import recsys
    from repro_torch.train import adamw_init

    common.adamw_update = _ranged("adamw_update", common.adamw_update)
    recsys._cin_rows = _ranged("cin_products", recsys._cin_rows)
    recsys._lookup = _ranged("gathers", recsys._lookup)
    cell = get_spec("xdeepfm").build_cell("train_batch", SINGLE_POD)
    cfg, rows = xdeepfm.CFG, cell.abstract_args[2].shape[0]
    params = recsys.xdeepfm_init(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw_init(params)
    b = next(recsys_batches(rows, cfg.n_sparse, cfg.field_vocabs(), seed=0))
    ids, labels = (torch.from_numpy(b[k]).to(dev) for k in ("sparse_ids", "labels"))
    print(json.dumps({"model": cfg.name, "rows": rows}))
    return lambda: cell.step_fn(params, opt, ids, labels)


def gnn_phases(names, dev):
    """One training step a call of each named ``gnn_<config>_<shape>``, on
    the graph ``chip_smoke.py``'s phase 12 draws (the sampler over the
    reddit-sized base graph for minibatch_lg, drawn once)."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke
    from repro_torch.configs.common_gnn import GNN_SHAPES, init_train_state

    minibatch = (chip_smoke.reddit_minibatch(chip_smoke.SEED)
                 if any(n.endswith("minibatch_lg") for n in names) else None)
    out = {}
    for name in names:
        config, shape = next((c, name[len(f"gnn_{c}_"):]) for c in
                             ("graphsage_reddit", "schnet", "pna", "egnn")
                             if name.startswith(f"gnn_{c}_"))
        if shape == "ogb_products":
            graph, batch = chip_smoke.ogb_products_graph(dev)
        else:
            graph, batch, _, _ = chip_smoke.gnn_graph(config, shape, dev,
                                                      chip_smoke.SEED + 1, minibatch)
        spec = chip_smoke._gnn_modules(config).SPEC
        state = init_train_state(spec.init_fn(
            torch.Generator(device=dev).manual_seed(chip_smoke.SEED),
            spec.make_cfg(GNN_SHAPES[shape])))
        step = spec.step_fn(shape)
        out[name] = (lambda step=step, state=state, graph=graph, batch=batch:
                     step(state.params, state.opt, graph, *batch))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=PHASES[:4])
    ap.add_argument("--layers", type=int, default=36,
                    help="granite-8b's depth in the lm_ phases")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_challenge: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "torch": torch.__version__, "scale": args.scale}))
    phases = kernel_phases(dev) if set(KERNEL_PHASES) & set(args.phases) else {}
    if set(TABLE_PHASES) & set(args.phases):
        phases.update(table_phases(args, dev))
    if set(LM_PHASES) & set(args.phases):
        phases.update(lm_phases(args, dev))
    if set(MOE_PHASES) & set(args.phases):
        phases.update(moe_phases(dev))
    if set(TRAIN_PHASES) & set(args.phases):
        phases.update(train_phases(dev))
    gnn = [n for n in args.phases if n in GNN_PHASES]
    if gnn:
        phases.update(gnn_phases(gnn, dev))
    lazy = {"moe_train": moe_train_phase, "xdeepfm_train": xdeepfm_train_phase}
    for name in args.phases:
        calls = CALLS if name in KERNEL_PHASES else None
        fn = lazy[name](dev) if name in lazy else phases[name]
        print(json.dumps(profile_phase(name, fn, args.reps, args.top, calls)),
              flush=True)
        if name in lazy:
            del fn
            import gc
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
