#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Card and build: print the card's name and power limit, build the five
   CUDA sources under ``src/repro_torch/kernels/csrc/`` in parallel (one
   ``nvcc`` each) and print each ``-Xptxas -v`` report.
2. Kernels against their plain versions on the card, at the main path's
   shapes, each shape timed by events, on the device alone (the host's
   work left out) and on the host alone (the wrapper's work), its device
   kernels a call counted by ``torch.profiler``, beside the plain version,
   one PyTorch call that computes the same function from the same inputs
   (its index casts, spill slots, fills and masks inside the timed call;
   checked bit-equal where the sums are exact) and the bytes bound:
   * histogram: 2^24 rows into 8,192 float bins, uniform (a) and the
     activity ids of an RMAT capture (a-rmat, hot bins), and a gated int32
     sum into 2^24 + 1 segments (b) (bit-equal; ``bincount`` and
     ``index_add_`` beside each), the ``init``/``valid_mask``/``retire``
     epilogue, ``n == 0``, out-of-range ids and random float weights (to a
     stated tolerance); PageRank's plus-times vxm, 2^20 float32 products
     into 2^21 vertex slots with ``valid_mask``/``retire`` (to the same
     tolerance), the triangle census's int32 roll-up of 2^20 counts
     into 2^21 segments (bit-equal), and the streaming engine's activity
     fold (s), 2^18 ids into 8,192 float bins with ``init`` (bit-equal,
     ``index_add_`` onto ``init`` beside it), and the naive overlap's
     member count (v), 2^25 ids (non-members -1) into 8 bins with no
     weights (bit-equal, ``bincount`` and ``index_add_`` beside it);
   * segment max: the vxm's 2^20 values into 2^21 vertex slots with
     ``valid_mask``/``retire=-inf``, the HyperLogLog fold's 2^15 rows into
     4,096 registers with ``init``, the same at the stream's 2^18 rows
     (h-s) and at the degrade backfill's 2^23 (h-b), and the gate, ``n == 0``, out-of-range ids, ±inf, -0.0 and
     random floats: all bit-equal;
   * Count-Min: int32 (4, 4096) cells with 2^15 proposals and counts past
     2^24 (both kernel paths, cluster and cooperative, timed), 2^18
     proposals (j-s, the stream's micro-batch), 2^23 weighted proposals
     (j-b, the degrade backfill's), float32
     cells (both paths), all proposals masked, ``n == 0``, rows of 100,000
     cells (the cooperative path): all bit-equal.
3. The main path at scale 24: ``run_challenge`` with ``method="hash"``, with
   the defaults and with ``fused_epilogue=True``, each checked against the
   NumPy oracle, the two checked identical, the histogram kernel's launches
   checked against the count the code implies; then the sketch tier over
   the same capture (``run_sketch_tier``: 512 micro-batches of 2^15 rows),
   every estimate within its bound, 2 Count-Min and 3 segment-max launches
   per batch.
4. The graph-algorithm pass at scale 20: ``run_challenge(algorithms=True)``
   checked against the NumPy oracles and the launch counts the code
   implies, BFS again from the heaviest link's source (at least 3 levels),
   and each algorithm timed on its own.  Scale 20, not 24: the triangle
   census scans the live rows in blocks (about n_rows / 63 steps over every
   entry), and the NumPy oracles walk the edges in Python.
5. The CLI, ``python -m repro_torch.challenge.run --algorithms --tier both``,
   with its other defaults (the card, shuffle anonymization) at scale 18:
   exit 0, all three oracle lines and every kernel launched.
6. The attention and segment-sum kernels against their plain versions,
   each shape timed beside the plain version, one PyTorch call that
   computes the same function (``scaled_dot_product_attention``,
   ``index_add_``) and the bound (operations over the bf16 tensor-core peak
   or bytes over the memory rate, the larger):
   * attention, each output row within 2^-7 relative L2 of the plain
     version's in bfloat16, each case naming the kernel path the dispatch
     rule gave it (prefill, decode or f32): (p) granite prefill, B 4, 32/8
     heads, L 2,048, D 128, causal; (d) granite decode, one query against
     cuts of a 2,080-slot cache (a strided view); (c4) and (c5) chunks of 4
     and 5 queries against that cache, the two sides of the dispatch
     boundary (16 and 20 packed rows); (d32k) one query against 32,767 of
     32,768 slots, granite's decode_32k cache length; (m) minicpm prefill,
     36 heads MHA, D 64; (w) a 4,096 sliding window over L 8,192; (a7)
     arctic prefill, B 2, 56/8 heads (a GQA group of 7), L 2,048, and
     (a7-d) its decode against a 2,080-slot cache cut (7 packed rows; a
     chunk of 2 queries, 14 rows, checked too); (w-d) mixtral decode
     against 6,145 and 6,176 of 6,176 slots under its 4,096 window; beside
     (p), (d), (d32k), (w), (a7), (a7-d) and (w-d), two planted faults that
     the check must reject (the newest key dropped, the output scaled by
     0.98); then edge cases
     in float32 (to 1e-4) and bfloat16 (lq < lkv, lengths off the tiles and
     on them, non-causal, decode at lkv 1, below one chunk and under a
     narrow window, 16 rows of a group of 8, lq > lkv).  Each shape is timed
     also on the device alone (the host's work left out), and at (d), (c4),
     (d32k), (a7-d) and (w-d) with the prefill path forced beside the
     decode path;
   * segment sum at the GNN regimes of ``configs/common_gnn.py``: molecule
     (8,192 edges x 64 features into 4,096 segments) and full_graph_sm
     (10,752 x 1,433 into 2,816, 196 padding edges at the capacity), which
     the kernel's planner launches direct, and minibatch_lg (168,960 x 602
     into 170,496) and ogb_products (61,865,984 x 100 into 2,449,920),
     which it partitions: integer-valued floats bit-equal, random floats
     within a reordering tolerance (not at ogb_products, whose float64
     copies would not fit the card), each regime timed by events and on
     the device alone beside ``index_add_`` with its spill index inside
     the call, and molecule again with half its rows on one node (a hub);
     then ``ops.segment_reduce`` as a GNN aggregation calls it
     (``backend="auto"``), once per regime of the first two: the entry
     point's own run.
7. LM serving at full size: granite-8b, 36 layers, d_model 4,096, bf16,
   weights drawn on the card from ``SEED``; four requests of 2,048 random
   tokens prefilled into a 2,080-slot cache, then 32 greedy decode steps,
   through the attention kernel (once to warm up, once counted and timed),
   then on the same weights and tokens through the plain attention; last-
   token logits compared at every step by relative L2 error (limit
   0.025), greedy tokens wherever the plain logits' top-2 margin exceeds
   twice the gap; 36 x 33 attention launches; then a control, the kernel
   path with the newest key left out of each decode step's attention,
   which the limit must reject at every step.
8. The streaming engine (``repro_torch.stream``) over phase 3's capture:
   its arrays written as a plq of 64 row groups of 2^18 rows and read back
   equal, so phase 3's NumPy oracle is reused. ``stream_plq`` into an
   exact-tier engine (``link_capacity`` 2^24, ``ip_capacity`` 2^25, 8
   windows, 1,024 bins), then ``snapshot()``: the scalars against the
   oracle, overflow 0, the accumulated activity bit-equal to the plain
   windowed histogram of the whole capture, one histogram launch a batch
   (its ``init`` epilogue) and none in the snapshot; the steady-state
   packets/s and seconds a batch, the snapshot wall and
   ``max_memory_allocated``. ``--time-phases`` over the first 8 batches
   (prep, transfer and update a batch). Both tiers over the capture: every
   sketch estimate within its bound, 1 histogram, 2 Count-Min and 3
   segment-max launches a batch, and the host syncs of batches 1-63
   counted with ``torch.cuda.set_sync_debug_mode("warn")``, by line. Two
   engines fed batches 0-31 and 32-63, merged through ``merge_from``
   (sketch included): scalars, bounds, and activity bit-equal to the
   exact run's. At scale 20, 16 batches through ``update_state`` and
   ``update_state_naive``, every leaf identical after every batch, each
   timed; then ``algorithms()`` against the NumPy oracles on the link
   table in the stable-id domain, with its launch counts. The CLI
   ``python -m repro_torch.stream.run --scale 18 --batches 8 --tier both``
   (exit 0, both oracle lines) and with ``--link-capacity 1000`` (exit 1).

9. The A/B baselines and the rest of the query surface on phase 3's
   anonymized table: ``analyze(use_plan=False)`` and
   ``analyze(windowed_method="grid")`` bit-equal to the plan path, each with
   its sorts counted (3, 18, 3), its histogram launches (1, 2, 1), its peak
   memory above the table and its wall (median of 3); then
   ``run_challenge(fused=True)`` at scale 24, one CUDA graph of build's
   device part, anonymize and analyze: the replay bit-equal to the phases,
   the launches of one replay counted at its capture, which ran under
   ``set_sync_debug_mode("error")``, and ``fused_s`` beside the eager
   phases' sum; ``run_all_queries``, ``run_all_queries_csr``,
   ``run_all_queries_naive`` and the per-query functions against the
   oracle; ``connected_components(csr_t=None)`` at scale 20 equal to it
   with the dst-keyed CSR, its segment-max launches counted; and the CLI
   with ``--fused`` (shuffle) at scale 18: exit 0, the ``fused(b+a+a)`` row
   and the oracle line.
10. The fault-tolerant service (``repro_torch.stream.recovery``) over phase
   3's capture in phase 8's geometry, both tiers: ``run_service`` with a
   commit every 16 batches and no faults (scalars against the oracle, every
   sketch estimate within its bound, 1 histogram, 2 Count-Min and 3
   segment-max launches a fold; fold p50/p99, each commit's wall beside one
   save's device-to-host copies, packets/s, ``max_memory_allocated``, the
   checkpoints' bytes and the free disk); the same under the serve CLI's
   ``--chaos`` cocktail with a crash after batch 40 (every exact and sketch
   leaf bit-equal to the fault-free run's, 9 batches replayed, no host sync
   in a fold but those after a commit or the restore, counted with
   ``set_sync_debug_mode("warn")``, and the restored life holding no more
   memory between folds than the first: the restore and replay walls);
   degradation at 2^23 links of capacity (exact -> both -> sketch before
   any overflow, the sketch holding every packet and within its bounds, the
   backfill's launches counted and its wall timed); a crash after the switch
   at scale 20 (restored degraded, bit-equal to the uninterrupted degraded
   run); and ``python -m repro_torch.launch.serve --chaos --crash-at-batch 4
   --verify --metrics-out`` at scale 18 (exit 0, its lines and files) and
   with ``--distributed`` (exit 2).

11. LM training on the card: (a) the attention ``autograd.Function``
   (``kernels/flash_attention.py::FlashAttention``: the kernel's forward,
   the plain version's autograd backward) against plain autograd at
   minicpm-2b's training shape (B 4, 36 heads, L 2,048, D 64, causal,
   bf16) and granite-8b's GQA (32/8 heads, D 128): each output row within
   2^-7 relative L2, dq, dk and dv bit-equal for the same upstream
   gradient, the backward timed beside plain autograd's and SDPA's; (b)
   minicpm-2b at full size (40 layers, bf16, remat "nothing", weights drawn
   on the card from ``SEED``), 8 steps of 4 x 2,048 tokens from
   ``lm_batches`` through ``Trainer.run`` with the reference launcher's
   AdamW, the attention through the kernel (80 launches a step): step
   walls on the device's timeline, tokens/s, MFU, peak memory, the losses,
   and the host syncs of the steps that do not log counted with
   ``set_sync_debug_mode("warn")``; then 3 steps from the same weights and
   batches through the plain attention, each loss within
   ``TRAIN_LOSS_TOL`` of the kernel run's, and 3 with a planted fault (each
   query's own key dropped) that must exceed it at every step; (c) the
   depth cut to 2 layers (4.05 GB of leaves): a checkpoint every 4 steps,
   the trainer dropped at step 6, a new one with other weights resumed
   (step 4, every leaf bit-equal to the one saved, bf16 included) and run
   to 8 on ``lm_batches(start_step=4)``, its losses within the limit of an
   uninterrupted run's, the commit and restore walls; (d) ``python -m
   repro_torch.launch.train --arch minicpm-2b --d-head 64 --steps 20
   --ckpt-dir D`` twice, through its ``main``: exit 0, 40 attention
   launches, and the second resumes at step 20.

12. GNN training on the card: (a) the segment sum and the feature-wise
   segment max under autograd (``ops.segment_reduce``: the ``SegmentSum``
   and ``SegmentMax`` Functions, kernel forwards, plain backwards) against
   plain autograd at the molecule, minibatch_lg and ogb_products widths
   (sums within the order bound, integer-valued ones at ogb_products bit-
   equal; maxima bit-equal, ties planted; the rows' gradients bit-equal
   for the same upstream gradient), forward + backward timed by events
   beside plain autograd's and ``index_add``'s or ``scatter_reduce``'s;
   (b) SchNet, PNA, EGNN and GraphSAGE at ``make_cfg``'s published widths
   with the reference's AdamW, on molecule (128 graphs of 30 nodes and 64
   edges), full_graph_sm (cora's 2,708 nodes and 10,556 edges, padded) and
   minibatch_lg (the port's sampler over a base graph of reddit's 232,965
   nodes, 114,615,892 edges and 602 features, drawn from ``SEED``, 1,024
   seeds, fanouts 15 and 10), graphs drawn on the card: 8 steps through the
   kernels (step walls on the device's timeline, edges/s, peak memory,
   launches a step against the count the code implies, host syncs of
   steps 2-8 counted with ``set_sync_debug_mode("warn")``), 3 from the same
   weights and graph through the plain path (outputs and losses within
   ``GNN_OUT_RTOL``/``GNN_LOSS_RTOL``) and 3 with a planted fault (each real
   edge's receiver moved to the next node: beyond the limit at every
   step); (c) graphsage-reddit at ogb_products (61,859,140 live edges), 3
   steps through the kernel's partitioned launch, in a child process whose
   allocator grows its segments (``OGB_ALLOC_CONF``): peak memory, step
   walls, edges/s; (d) each GNN config's ``smoke()`` on the card.

13. MoE serving at full width, weights drawn on the card from ``SEED``:
   (a) mixtral-8x7b cut to 8 of its 32 layers (23.7 GB), two requests of
   6,144 random tokens (past its 4,096-key window; capacity 3,848 an
   expert) prefilled, then 32 greedy decode steps (capacity 8), through
   the attention kernel and the segment-sum kernel (the combine), once
   recorded to warm up, once counted and timed (one launch of each kernel
   a layer a call; the decode steps' host syncs counted with
   ``set_sync_debug_mode("warn")``: 0); then through the plain path freely
   (the share of (token, layer) top-2 picks on which the two paths agree,
   the free logits error, printed) and routed as the kernel path routed
   (the last-token logits within ``MOE_SERVE_TOL`` relative L2 at every
   call), and a control that adds every live combine row to the next token
   (beyond the limit at every call); dropped rows, prefill s and tokens/s,
   decode ms a step and tokens/s, peak memory; then the same prefill with
   ``optimized_config()``'s batched dispatch (capacity factor 1.0) against
   its own plain path and control; (b) arctic-480b cut to 2 of its 35
   layers (55.4 GB: 128 experts and the dense residual; a GQA group of 7),
   2 x 2,048 tokens (capacity 88), the same runs and checks; (c) the
   segment-sum kernel at the combine's shapes (two live bf16 rows a token,
   the other slots dropped: 30,784 x 4,096 into 12,288, 11,264 x 7,168
   into 4,096, 64 x 4,096 and 1,024 x 7,168 into 2): float32 sums bit-equal
   to the plain version's, cast to bf16 compared with ``index_add_`` in
   bf16 (bit-equal or not, reported), each timed by events and on the
   device alone beside ``index_add_`` and the bound.

14. xDeepFM serving at its published size (39 tables, 38,190,000 rows x (10
   + 1) float32, 1.68 GB, drawn on the card; ids from ``recsys_batches``):
   ``serve_p99`` (512 rows), ``serve_bulk`` (262,144 rows, the CIN in
   chunks of 2^15) and ``retrieval_cand`` (one query against 2^20
   candidates), each through the port's serve step (one gathered row a
   field, as the reference's ``jnp.take``: no kernel launch) and through
   the reference's own formulation written out plainly
   (``_xdeepfm_plain``: ``F.embedding``, the CIN as its two einsums),
   within ``XDEEPFM_TOL`` relative L2, with a control (one field's ids
   shifted by one) beyond it, rows/s and peak memory; then
   ``embedding_bag`` at 65,536 bags of 39 uniform ids in the 10,000,000-row
   table, in the sum, mean and weighted modes, once counted (4 launches of
   the segment-sum kernel, the mean's count of ids its own), each within
   the reordering bound of the plain version and timed beside
   ``F.embedding_bag`` (or ``index_add_``) and the bound, and the
   segment-sum kernel alone on its gathered rows.

15. MoE and xDeepFM training through the registry's train cells
   (``repro_torch.configs``), weights drawn on the card from ``SEED``:
   (a) mixtral-8x7b at full width, its train_4k cell built by the port's
   ``lm_spec`` with the depth cut to 3 of 32 layers (55.5 GB of bf16
   weights and gradients and float32 moments; 4 layers would hold 72.7 GB
   before AdamW's temporaries and any activation), 4 x 2,048 tokens a step
   (cut from the cell's 256 x 4,096), the global dispatch, remat
   "nothing", the reference's LM AdamW: 6 steps through the attention and
   segment-sum kernels (per step: the wall on the device's timeline,
   tokens/s, MFU over the active parameters, peak memory, dropped rows,
   the auxiliary loss, and each kernel's launches, twice a layer: the
   forward and its recompute; host syncs of steps 2-6 counted with
   ``set_sync_debug_mode("warn")``: 0), 3 steps from the same weights and
   batches through the plain path (each loss within
   ``MOE_TRAIN_LOSS_TOL``) and 3 with every combine row moved to the next
   token (beyond it after the first update), then one step of
   ``optimized_config()``'s batched dispatch (capacity factor 1.0); (b)
   ``SegmentSum`` forward + backward at the combine's training shape
   (20,544 bf16 rows x 4,096 into 8,192 tokens), the sums and the rows'
   gradients bit-equal to plain autograd's, timed by events and on the
   device alone beside plain autograd, ``index_add`` in bf16 under
   autograd and its bytes bound; (c) xDeepFM's train_batch cell
   (``get_spec("xdeepfm").build_cell("train_batch", SINGLE_POD)``) at the
   published size, uncut: 65,536 rows a step of ``recsys_batches``, 5
   steps (rows/s, walls, peak, the idle share of a traced step, 0 host
   syncs in steps 2-5, then one step keeping the CIN's products for its
   peak, no kernel launch: the lookups are gathers and
   their gradient autograd's ``index_add_``, as the reference's
   ``jnp.take``); at 4,096 rows the loss and every gradient leaf against
   the reference's order written out plainly (``XDEEPFM_TRAIN_TOL``), the
   CIN's recompute bit-equal to keeping its products, and the labels
   flipped (beyond the limit); (d) ``python -m repro_torch.launch.train
   --arch mixtral-8x7b --d-head 64 --steps 20`` through its ``main``:
   exit 0, 40 launches of each kernel.

Then it prints one JSON line of kernel records, whose launch counts are
those of the main path's runs (phases 3, 4 and 5, without the algorithms
timed on their own; the segment-sum entry point's run of phase 6; phase
7's counted run; phase 8's, 9's and 10's runs, phase 11's (b) kernel
run, (c) runs and (d) CLI runs, phase 12's kernel runs of (b), (c)
and (d), phase 13's counted runs, phase 14's counted serve calls and
phase 15's kernel runs of (a) and its CLI run of (d), each under its own
name),
the card line
again, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout (no ``src/repro_torch``), it exits non-zero before printing any
result.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SCALE = 24                  # 2^24 packets; the full challenge capture is 2^30
ALGO_SCALE = 20             # the graph-algorithm pass (docstring, phase 4)
CLI_SCALE = 18
N_WINDOWS, IP_BINS = 8, 1024
SKETCH_BATCH = 1 << 15      # run_sketch_tier's micro-batch
STREAM_BATCH = 1 << 18      # the streaming engine's micro-batch (phase 8)
STREAM_PHASE_BATCHES = 8    # batches timed phase by phase (--time-phases)
STREAM_AB_BATCHES = 16      # the A/B of the two link paths at ALGO_SCALE
# the fault-tolerant service (phase 10): the degradation run's link_capacity,
# which is also the row count of the degrade backfill's sketch fold (phase 2)
SERVE_DEGRADE_LINKS = 1 << 23
# what torch.cuda.set_sync_debug_mode("warn") says at a synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"
SOURCES = ("histogram", "segreduce", "sketch", "flash_attention", "segment_matmul")
# The bound of each timed shape is the larger of its bytes (each input the
# function needs read once, each output written once: rows whose id is out
# of range and keys outside every query's window are not needed) over the
# H100 SXM's memory rate and its operations over the peak for their type.  For the histogram, segment max,
# Count-Min and segment sum, one add or compare per row or element would
# take n / 67e12 s at the float32 peak, far less than the bytes; attention's
# products count at the dense bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
REPS = 20
SEED = 0
# Phase 6 holds every row of an attention output (one query of one head of
# one request) by its relative L2 error against the plain version's row: at
# the main path's shapes the outputs are small (|o| about 0.03 at lkv 2,049),
# so a limit on |diff| must scale with the row, not with 1 + |o|.  In
# bfloat16, sound runs reach 0.0052 (P and the output round at 2^-8) and
# planted faults 0.021 and more (the newest key left out of every row; the
# output scaled by ATTN_FAULT_SCALE); the controls run beside each main
# shape and must be rejected.  Float32 runs reach 7e-7.
ATTN_ROW_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}
ATTN_FAULT_SCALE = 0.98
# LM serving (phase 7): four requests, 2,048-token prompts, 32 decode steps
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 32
# Relative L2 error of the kernel path's logits against the plain path's, at
# each of the 33 calls.  The kernel rounds P to bf16 before P V, where the
# plain version keeps float32; through 36 layers of random weights that gives
# 0.0199-0.0214 on an H100, flat over the decode steps.  A control with the
# newest key left out of every decode step's attention gives 0.029-0.079 at
# the decode steps (PERF.md, section 6); the limit lies between the two, and
# the control must exceed it at every step.  Finer faults are phase 6's to
# catch: random weights carry a one-key fault to the logits weakly.
SERVE_TOL = 0.025


def log(msg: str) -> None:
    print(msg, flush=True)


_PHASE_STARTS = {}


def _phase(n: int, title: str) -> None:
    """Logs phase ``n``'s header and notes when it began."""
    _PHASE_STARTS[n] = time.perf_counter()
    log(f"\n== phase {n}: {title}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    """Build every CUDA source at once, one nvcc process each."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(build.build, SOURCES))
    log(f"built {', '.join(s + '.cu' for s in SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        log(f"--- {lib.name}: nvcc -Xptxas -v\n"
            + lib.with_suffix(".log").read_text().strip())


def reset_launches() -> None:
    from repro_torch.kernels.launches import reset_launches

    reset_launches()


def read_launches() -> dict:
    from repro_torch.kernels.launches import read_launches

    return read_launches()


# the kernels a phase of the challenge never launches
NO_LM_OR_GNN = {"flash_attention": 0, "segment_matmul": 0}


def time_ms(fn) -> float:
    """Mean time of one call, by CUDA events around REPS calls in a row: the
    device's time, or the host's where the host queues calls more slowly
    than the device runs them (``device_time_ms`` leaves the host out)."""
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


def device_time_ms(fn, may_sync: bool = False):
    """Mean device time of one call, by CUDA events over REPS calls queued
    behind a sleep kernel: the device starts them only after the host has
    queued them all, so the host's work per call (the wrapper's checks and
    launches) is left out.  Checked: the host must finish queueing before
    the device reaches the start event, else the sleep is lengthened.  A
    call that waits for the device (``torch.bincount`` reads its ids' max
    on the host) never gets ahead: with ``may_sync`` it gives None, "not
    measured", where any other call raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for cycles in (10 ** 7, 10 ** 8, 10 ** 9):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / REPS
    if may_sync:
        return None
    raise AssertionError("the host did not get ahead of the device")


def host_time_ms(fn) -> float:
    """Mean host time of one call: ``time.perf_counter_ns`` around REPS
    calls queued behind a sleep kernel, so that no call waits for the
    device: the wrapper's checks, allocations and launch alone.  Checked
    as in ``device_time_ms``: the device must not reach the calls before
    the host has queued them all."""
    import torch

    fn()
    torch.cuda.synchronize()
    marker = torch.cuda.Event()
    for cycles in (10 ** 8, 10 ** 9):
        torch.cuda._sleep(cycles)
        marker.record()
        t0 = time.perf_counter_ns()
        for _ in range(REPS):
            fn()
        host = (time.perf_counter_ns() - t0) / REPS / 1e6
        ahead = not marker.query()
        torch.cuda.synchronize()
        if ahead:
            return host
    raise AssertionError("the host did not get ahead of the device")


def device_ops(fn) -> list:
    """Names of the device operations (kernels, copies, fills) of one call
    of ``fn`` after a warm-up call, from ``torch.profiler``: the longest
    list over three sessions.  A session after the first in a process
    may drop device events that come right after its start, never add
    any; each session launches a marker kernel and pauses first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    longest = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                 and "spin_kernel" not in e.name]
        longest = max(longest, names, key=len)
    return longest


def timings(kern, plain, library) -> dict:
    """A kernel call's event, device-only and host-only times beside its
    plain version's and its library yardstick's (``library`` builds
    whatever index, cast or fill the kernel's function needs inside the
    call)."""
    return {"ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library), "device_ms": device_time_ms(kern),
            "host_ms": host_time_ms(kern),
            "library_device_ms": device_time_ms(library, may_sync=True),
            "kernels_per_call": len(device_ops(kern))}


def yardstick(name, library) -> dict:
    """A second library call's times, by events and on the device alone."""
    return {f"{name}_ms": time_ms(library),
            f"{name}_device_ms": device_time_ms(library, may_sync=True)}


def rmat_activity_ids(dev):
    """The main path's activity-histogram ids on an RMAT capture made by
    the port's ``data/rmat.py`` at SCALE: rows in capture order, cut into
    N_WINDOWS equal windows, sources hashed to IP_BINS bins as
    ``pipeline._window_activity`` hashes them (``mix32(src) % ip_bins``).
    RMAT's hub sources make hot bins, which uniform ids hide."""
    import torch
    from repro_torch.core.ops import mix32
    from repro_torch.data.rmat import rmat_edges

    n = 1 << SCALE
    src, _ = rmat_edges(SCALE, n, seed=SEED)
    src = torch.from_numpy(src.astype("int64")).to(dev)
    win = torch.arange(n, device=dev) * N_WINDOWS // n
    return (win * IP_BINS + mix32(src) % IP_BINS).to(torch.int32)


def same(name, got, want):
    """Bit-equal (``torch.equal``: -0.0 == 0.0), or raise."""
    import torch

    if got.dtype != want.dtype or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().nan_to_num().max().item()
        raise AssertionError(f"{name}: kernel != plain (max |diff| {diff})")
    log(f"  {name}: bit-equal")


def check_histogram(dev):
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

    # (a) the default path's activity histogram: 2^24 rows, 8,192 flat bins,
    # integer-valued float weights (exact in any summation order)
    bins_a = N_WINDOWS * IP_BINS
    ids = rand(0, bins_a, n)
    w = rand(0, 4, n).float()
    kern = lambda: histogram(ids, bins_a, w, backend="cuda")
    plain = lambda: histogram(ids, bins_a, w, backend="torch")
    same(f"(a) 2^{SCALE} rows -> {bins_a} float bins", kern(), plain())
    # each library yardstick computes the kernel's function from the
    # kernel's inputs: its index casts, spill slots and masks are timed too;
    # bincount reads its ids' maximum on the host, so index_add_ stands
    # beside it with a device time
    spill = lambda i, bins, ok: torch.where(ok, i, bins).long()
    add_a = lambda i: torch.zeros(bins_a + 1, device=dev).index_add_(
        0, spill(i, bins_a, (i >= 0) & (i < bins_a)), w)[:bins_a]
    same("(a) index_add_ computes the same bins", add_a(ids), plain())
    shapes.append({
        "case": f"a: ids int32 (2^{SCALE},), weights float32, {bins_a} bins",
        **timings(kern, plain,
                  lambda: torch.bincount(ids.long(), w, minlength=bins_a)),
        **yardstick("index_add", lambda: add_a(ids)),
        "bound_ms": (8 * n + 4 * bins_a) / HBM_BYTES_PER_S * 1e3,
    })

    # (a-rmat) the same call on the activity ids of an RMAT capture: hot bins
    rmat_ids = rmat_activity_ids(dev)
    kern = lambda: histogram(rmat_ids, bins_a, w, backend="cuda")
    plain = lambda: histogram(rmat_ids, bins_a, w, backend="torch")
    same(f"(a-rmat) 2^{SCALE} RMAT activity ids -> {bins_a} float bins",
         kern(), plain())
    hot = torch.bincount(rmat_ids.long(), minlength=bins_a)
    shapes.append({
        "case": f"a-rmat: RMAT activity ids int32 (2^{SCALE},), weights float32, "
                f"{bins_a} bins",
        **timings(kern, plain,
                  lambda: torch.bincount(rmat_ids.long(), w, minlength=bins_a)),
        **yardstick("index_add", lambda: add_a(rmat_ids)),
        "bound_ms": (8 * n + 4 * bins_a) / HBM_BYTES_PER_S * 1e3,
        "hottest_bin_rows": int(hot.max()), "mean_bin_rows": n / bins_a,
    })
    del rmat_ids, hot

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
    add_b = lambda: torch.zeros(segs + 1, dtype=torch.int32, device=dev).index_add_(
        0, spill(seg, segs, gate == 3), wi)[:segs]
    same("(b) index_add_ computes the same sums", add_b(), plain())
    shapes.append({
        "case": f"b: seg int32 (2^{SCALE},), gate int32, weights int32, "
                f"2^{SCALE}+1 segments",
        **timings(kern, plain, lambda: torch.bincount(
            seg.long(), torch.where(gate == 3, wi, 0).float(), minlength=segs)),
        **yardstick("index_add", add_b),
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
    k_max = torch.bincount(ids.long(), minlength=bins_a).max().item()
    abs_sum = torch.zeros(bins_a, dtype=torch.float64, device=dev).index_add_(
        0, ids.long(), w_f.abs().double())
    err = (got - want).abs()
    tol = 2 * k_max * 2.0 ** -24 * abs_sum
    if not bool((err <= tol).all()):
        raise AssertionError(f"(f) random float weights: max |diff| "
                             f"{err.max().item()} beyond tolerance")
    max_err = max(max_err, err.max().item())
    log(f"  (f) random float weights: max |diff| {err.max().item():.3g} "
        f"(tolerance 2 * {k_max} * 2^-24 * sum|w| per bin)")

    # (n) PageRank's plus-times vxm at scale 20: 2^20 non-integer float32
    # products into the 2^21 vertex slots, -1 marking a dropped entry, the
    # slots of dead vertices retired to 0; the tolerance of (f)
    m, segs = 1 << ALGO_SCALE, 2 << ALGO_SCALE
    prod = torch.rand(m, generator=g, device=dev) * rand(1, 5, m)
    seg = torch.where(rand(0, 8, m) == 0, -1, rand(0, segs, m))
    live = rand(0, 4, segs) != 0
    kw = dict(op="sum", valid_mask=live, retire=0.0)
    kern = lambda: segmented_reduce(prod, seg, segs, backend="cuda", **kw)
    plain = lambda: segmented_reduce(prod, seg, segs, backend="torch", **kw)
    got, want = kern().double(), plain().double()
    spill = torch.where(seg >= 0, seg, segs).long()
    k_max = torch.bincount(spill, minlength=segs + 1)[:segs].max().item()
    abs_sum = torch.zeros(segs + 1, dtype=torch.float64, device=dev).index_add_(
        0, spill, prod.double())[:segs]
    err = (got - want).abs()
    if not bool((err <= 2 * k_max * 2.0 ** -24 * abs_sum).all()):
        raise AssertionError(f"(n) PageRank vxm: max |diff| {err.max().item()} "
                             "beyond tolerance")
    max_err = max(max_err, err.max().item())
    log(f"  (n) PageRank vxm: 2^{ALGO_SCALE} float32 products -> "
        f"2^{ALGO_SCALE + 1} segments, valid_mask/retire: max |diff| "
        f"{err.max().item():.3g} (tolerance 2 * {k_max} * 2^-24 * sum|w| per bin)")
    shapes.append({
        "case": f"n: vals float32 (2^{ALGO_SCALE},), seg int32, "
                f"2^{ALGO_SCALE + 1} segments, valid_mask",
        **timings(kern, plain, lambda: torch.zeros(segs + 1, device=dev)
                  .index_add_(0, torch.where(seg >= 0, seg, segs).long(),
                              prod)[:segs].masked_fill(~live, 0.0)),
        "bound_ms": (8 * m + 4 * segs + segs) / HBM_BYTES_PER_S * 1e3,
    })

    # (o) the triangle census's per-node roll-up at scale 20: int32 wedge
    # counts of 2^20 entries, grouped by source row, padding entries -1, into
    # 2^21 int32 segments: bit-equal
    live_e = m - m // 8
    counts = rand(0, 40, m)
    seg = torch.cat([torch.sort(rand(0, segs, live_e))[0],
                     torch.full((m - live_e,), -1, dtype=torch.int32, device=dev)])
    kw = dict(op="sum", out_dtype=torch.int32)
    kern = lambda: segmented_reduce(counts, seg, segs, backend="cuda", **kw)
    plain = lambda: segmented_reduce(counts, seg, segs, backend="torch", **kw)
    same(f"(o) triangle roll-up: 2^{ALGO_SCALE} int32 counts -> "
         f"2^{ALGO_SCALE + 1} int32 segments, ids -1", kern(), plain())
    library = lambda: torch.zeros(segs + 1, dtype=torch.int32, device=dev
                                  ).index_add_(0, torch.where(seg >= 0, seg, segs)
                                               .long(), counts)[:segs]
    same("(o) the library yardstick computes the same sums", library(), plain())
    shapes.append({
        "case": f"o: counts int32 (2^{ALGO_SCALE},), seg int32, "
                f"2^{ALGO_SCALE + 1} int32 segments",
        **timings(kern, plain, library),
        "bound_ms": (8 * m + 4 * segs) / HBM_BYTES_PER_S * 1e3,
    })

    # (s) the streaming engine's activity fold (phase 8): a micro-batch of
    # STREAM_BATCH activity ids into the 8,192 flat bins, weights 1.0 on the
    # live rows (the padding's ids are -1), folded into the running
    # histogram through init: bit-equal
    k = STREAM_BATCH
    ids_s = torch.where(torch.arange(k, device=dev) < k - k // 16,
                        rand(0, bins_a, k), -1)
    w_s = (ids_s >= 0).float()
    init = rand(0, 1 << 20, bins_a).float()
    kern = lambda: histogram(ids_s, bins_a, w_s, init=init, backend="cuda")
    plain = lambda: histogram(ids_s, bins_a, w_s, init=init, backend="torch")
    same(f"(s) stream activity fold: 2^18 ids -> {bins_a} float bins with init",
         kern(), plain())
    add_s = lambda: torch.cat([init, init.new_zeros(1)]).index_add_(
        0, torch.where((ids_s >= 0) & (ids_s < bins_a), ids_s, bins_a).long(),
        w_s)[:bins_a]
    same("(s) index_add_ onto init computes the same bins", add_s(), plain())
    shapes.append({
        "case": f"s: ids int32 (2^18,), weights float32, init float32, {bins_a} bins",
        **timings(kern, plain, add_s),
        "bound_ms": (8 * k + 8 * bins_a) / HBM_BYTES_PER_S * 1e3,
    })

    # (v) the naive overlap's member count (phase 9): the window ids of 2 x
    # 2^24 (window, ip) pairs, non-members -1, into N_WINDOWS bins with no
    # weights; counts of 1.0 are exact in float32 below 2^24: bit-equal
    m = 2 * n
    ids_v = torch.where(rand(0, 5, m) < 3, rand(0, N_WINDOWS, m), -1)
    kern = lambda: histogram(ids_v, N_WINDOWS, backend="cuda")
    plain = lambda: histogram(ids_v, N_WINDOWS, backend="torch")
    same(f"(v) naive overlap count: 2^{SCALE + 1} ids (-1 non-members) -> "
         f"{N_WINDOWS} bins, no weights", kern(), plain())
    ones_v = torch.ones(1, device=dev).expand(m)  # index_add_'s weights, no copy
    spill_v = lambda: torch.where(ids_v >= 0, ids_v, N_WINDOWS).long()
    add_v = lambda: torch.zeros(N_WINDOWS + 1, device=dev).index_add_(
        0, spill_v(), ones_v)[:N_WINDOWS]
    same("(v) index_add_ computes the same bins", add_v(), plain())
    shapes.append({
        "case": f"v: ids int32 (2^{SCALE + 1},), no weights, {N_WINDOWS} bins",
        **timings(kern, plain, lambda: torch.bincount(
            spill_v(), minlength=N_WINDOWS + 1)[:N_WINDOWS].float()),
        **yardstick("index_add", add_v),
        "bound_ms": (4 * m + 4 * N_WINDOWS) / HBM_BYTES_PER_S * 1e3,
    })
    return max_err, shapes


def _floats(g, n, dev):
    """Normal floats with ±inf, -0.0 and 0.0 mixed in (one in ten)."""
    import torch

    v = torch.randn(n, generator=g, device=dev)
    special = torch.tensor([float("inf"), float("-inf"), -0.0, 0.0], device=dev)
    pick = torch.randint(0, 10, (n,), generator=g, device=dev) == 0
    return torch.where(
        pick, special[torch.randint(0, 4, (n,), generator=g, device=dev)], v)


def check_segment_max(dev):
    """Phase 2: the segment-max kernel against its plain version, bit-equal
    (max is exact in any order).  Returns (max_abs_err, timed shapes)."""
    import torch
    from repro_torch.kernels.ops import hll_update, segmented_reduce

    g = torch.Generator(device=dev).manual_seed(1)
    rand = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=g,
                                           device=dev, dtype=torch.int32)
    shapes = []

    def timed(case, kern, plain, library, n, segs, extra_bytes):
        shapes.append({
            "case": case, **timings(kern, plain, library),
            "bound_ms": (8 * n + 4 * segs + extra_bytes) / HBM_BYTES_PER_S * 1e3,
        })

    # (g) the vxm of BFS and components at scale 20: 2^20 entries (negated
    # distances or labels, inf where the frontier is off) into the 2^21
    # vertex slots, masked-out slots retired to -inf; -1 marks a dropped entry
    n, segs = 1 << ALGO_SCALE, 2 << ALGO_SCALE
    vals = _floats(g, n, dev)
    seg = torch.where(rand(0, 8, n) == 0, -1, rand(0, segs, n))
    mask = rand(0, 4, segs) != 0
    kw = dict(op="max", valid_mask=mask, retire=float("-inf"))
    kern = lambda: segmented_reduce(vals, seg, segs, backend="cuda", **kw)
    plain = lambda: segmented_reduce(vals, seg, segs, backend="torch", **kw)
    same(f"(g) vxm: 2^{ALGO_SCALE} values -> 2^{ALGO_SCALE + 1} segments, "
         "valid_mask/retire", kern(), plain())
    # the library call computes what the wrapper computes: the spill index,
    # the -inf fill and the retired segments are inside the timed call
    library = lambda: torch.full((segs + 1,), float("-inf"), device=dev
                                 ).scatter_reduce_(
        0, torch.where(seg >= 0, seg, segs).long(), vals, "amax"
    )[:segs].masked_fill(~mask, float("-inf"))
    same("(g) the library yardstick computes the same maxima", library(), plain())
    timed(f"g: vals float32 (2^{ALGO_SCALE},), seg int32, 2^{ALGO_SCALE + 1} "
          "segments, valid_mask", kern, plain, library, n, segs, segs)
    # what the fold costs beyond the seed and the grid barrier: the same
    # call with no rows (the seed of the 2^21 slots alone)
    shapes[-1]["no_rows_device_ms"] = device_time_ms(
        lambda: segmented_reduce(vals[:0], seg[:0], segs, backend="cuda", **kw))

    # (h) the HyperLogLog fold: 2^15 rows into 4,096 registers with init
    m = 4096
    regs = rand(0, 20, m).float()
    reg_ids = torch.where(rand(0, 16, SKETCH_BATCH) == 0, -1, rand(0, m, SKETCH_BATCH))
    rhos = rand(1, 22, SKETCH_BATCH)
    kern = lambda: hll_update(regs, reg_ids, rhos, backend="cuda")
    plain = lambda: hll_update(regs, reg_ids, rhos, backend="torch")
    same("(h) HLL fold: 2^15 rows -> 4,096 registers with init", kern(), plain())
    # the library call computes what the wrapper computes: the spill index,
    # the cast and the copy of the registers are inside the timed call
    library = lambda: torch.cat([regs, regs.new_full((1,), float("-inf"))]
                                ).scatter_reduce_(
        0, torch.where(reg_ids >= 0, reg_ids, m).long(), rhos.float(), "amax")[:m]
    same("(h) the library yardstick computes the same registers", library(),
         plain())
    timed("h: rho int32 (2^15,), reg ids int32, 4,096 registers, init",
          kern, plain, library, SKETCH_BATCH, m, 4 * m)
    # (h-s) the same fold at the streaming engine's micro-batch (phase 8)
    reg_ids_s = torch.where(rand(0, 16, STREAM_BATCH) == 0, -1,
                            rand(0, m, STREAM_BATCH))
    rhos_s = rand(1, 22, STREAM_BATCH)
    kern = lambda: hll_update(regs, reg_ids_s, rhos_s, backend="cuda")
    plain = lambda: hll_update(regs, reg_ids_s, rhos_s, backend="torch")
    same("(h-s) HLL fold: 2^18 rows -> 4,096 registers with init", kern(), plain())
    library = lambda: torch.cat([regs, regs.new_full((1,), float("-inf"))]
                                ).scatter_reduce_(
        0, torch.where(reg_ids_s >= 0, reg_ids_s, m).long(), rhos_s.float(),
        "amax")[:m]
    same("(h-s) the library yardstick computes the same registers", library(),
         plain())
    timed("h-s: rho int32 (2^18,), reg ids int32, 4,096 registers, init",
          kern, plain, library, STREAM_BATCH, m, 4 * m)
    # (h-b) the degrade backfill's fold (phase 10): one weighted update_sketch
    # over the whole link table, SERVE_DEGRADE_LINKS rows of which the live
    # prefix (about half at the switch) carries register ids, the rest -1
    k = SERVE_DEGRADE_LINKS
    reg_ids_b = torch.where(torch.arange(k, device=dev) < k // 2,
                            rand(0, m, k), -1)
    rhos_b = rand(1, 22, k)
    kern = lambda: hll_update(regs, reg_ids_b, rhos_b, backend="cuda")
    plain = lambda: hll_update(regs, reg_ids_b, rhos_b, backend="torch")
    same("(h-b) HLL fold: 2^23 rows -> 4,096 registers with init", kern(), plain())
    library = lambda: torch.cat([regs, regs.new_full((1,), float("-inf"))]
                                ).scatter_reduce_(
        0, torch.where(reg_ids_b >= 0, reg_ids_b, m).long(), rhos_b.float(),
        "amax")[:m]
    same("(h-b) the library yardstick computes the same registers", library(),
         plain())
    timed("h-b: rho int32 (2^23,), reg ids int32, 4,096 registers, init",
          kern, plain, library, k, m, 4 * m)

    # (i) the epilogues, no rows, out-of-range ids
    for nseg in (1000, 4096, 20000):
        k = 1 << 18
        ids = rand(-100, nseg + 100, k)
        v = _floats(g, k, dev)
        cases = {
            "plain": {},
            "gate": dict(gate_ids=rand(0, 3, k), gate_value=1),
            "init + valid_mask/retire": dict(init=_floats(g, nseg, dev),
                                             valid_mask=rand(0, 2, nseg).bool(),
                                             retire=-2.5),
        }
        for name, kw in cases.items():
            same(f"(i) {nseg} segments, ids in [-100, {nseg}+100), {name}",
                 segmented_reduce(v, ids, nseg, op="max", backend="cuda", **kw),
                 segmented_reduce(v, ids, nseg, op="max", backend="torch", **kw))
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    init = _floats(g, 64, dev)
    mask = rand(0, 2, 64).bool()
    for kw in (dict(), dict(init=init), dict(init=init, valid_mask=mask, retire=7.0)):
        same(f"(i) n == 0 with {sorted(kw)}",
             segmented_reduce(empty.float(), empty, 64, op="max", backend="cuda", **kw),
             segmented_reduce(empty.float(), empty, 64, op="max", backend="torch", **kw))
    return 0.0, shapes


def check_cms(dev):
    """Phase 2: the Count-Min kernel against its plain version, bit-equal.
    Returns (max_abs_err, timed shapes)."""
    import torch
    from repro_torch.kernels.ops import cms_update
    from repro_torch.kernels.sketch import cms_update_cuda

    g = torch.Generator(device=dev).manual_seed(2)
    rand = lambda lo, hi, *shape: torch.randint(lo, hi, shape, generator=g,
                                                device=dev, dtype=torch.int32)
    depth, width, n = 4, 4096, SKETCH_BATCH
    shapes = []
    # (j) the sketch tier's shape: int32 cells, counts past 2^24, a quarter
    # of the proposals masked (-1) as padding and empty groups are
    counts = rand(0, 1 << 26, depth, width)
    cols = torch.where(rand(0, 4, 1, n) == 0, -1, rand(0, width, depth, n))
    props = rand(0, 1 << 27, n)
    kern = lambda: cms_update(counts, cols, props, backend="cuda")
    plain = lambda: cms_update(counts, cols, props, backend="torch")
    same("(j) int32 (4, 4096) cells, 2^15 proposals, counts past 2^24",
         kern(), plain())
    # the library call computes what the wrapper computes, inside the timed
    # call: flat cell ids (masked proposals to a spill cell, no host sync),
    # the proposals broadcast over the rows, a copy of the cells
    rows = torch.arange(depth, device=dev)[:, None] * width

    def library():
        flat = torch.where(cols >= 0, rows + cols, depth * width).long().reshape(-1)
        cells = torch.cat([counts.reshape(-1), counts.new_zeros(1)])
        return cells.scatter_reduce_(0, flat, props.expand(depth, n).reshape(-1),
                                     "amax")[:-1].view(depth, width)

    same("(j) the library yardstick computes the same cells", library(), plain())
    # both of the kernel's paths: the default (the cluster) and the other
    paths = {}
    for path in ("cluster", "cooperative"):
        call = (lambda p: lambda: cms_update_cuda(counts, cols, props, path=p))(path)
        same(f"(j) {path} path", call(), plain())
        paths.update({f"{path}_ms": time_ms(call),
                      f"{path}_device_ms": device_time_ms(call)})
    shapes.append({
        "case": "j: cells int32 (4, 4096), col ids int32 (4, 2^15), "
                "proposals int32 (2^15,)",
        **timings(kern, plain, library), **paths,
        "bound_ms": (4 * depth * n + 4 * n + 8 * depth * width)
        / HBM_BYTES_PER_S * 1e3,
    })
    # (j-s) the streaming engine's micro-batch (phase 8): 2^18 proposals,
    # the link groups past the batch's distinct links masked
    k = STREAM_BATCH
    cols_s = torch.where(torch.arange(k, device=dev)[None, :] < k // 2,
                         rand(0, width, depth, k), -1)
    props_s = rand(0, 1 << 27, k)
    kern_s = lambda: cms_update(counts, cols_s, props_s, backend="cuda")
    plain_s = lambda: cms_update(counts, cols_s, props_s, backend="torch")
    same("(j-s) int32 (4, 4096) cells, 2^18 proposals", kern_s(), plain_s())

    def library_s():
        flat = torch.where(cols_s >= 0, rows + cols_s, depth * width).long().reshape(-1)
        cells = torch.cat([counts.reshape(-1), counts.new_zeros(1)])
        return cells.scatter_reduce_(0, flat, props_s.expand(depth, k).reshape(-1),
                                     "amax")[:-1].view(depth, width)

    same("(j-s) the library yardstick computes the same cells", library_s(),
         plain_s())
    shapes.append({
        "case": "j-s: cells int32 (4, 4096), col ids int32 (4, 2^18), "
                "proposals int32 (2^18,)",
        **timings(kern_s, plain_s, library_s),
        "bound_ms": (4 * depth * k + 4 * k + 8 * depth * width)
        / HBM_BYTES_PER_S * 1e3,
    })
    # (j-b) the degrade backfill's fold (phase 10): SERVE_DEGRADE_LINKS
    # weighted proposals (est + a link's packets), the live prefix about half
    k = SERVE_DEGRADE_LINKS
    cols_b = torch.where(torch.arange(k, device=dev)[None, :] < k // 2,
                         rand(0, width, depth, k), -1)
    props_b = rand(0, 1 << 27, k)
    kern_b = lambda: cms_update(counts, cols_b, props_b, backend="cuda")
    plain_b = lambda: cms_update(counts, cols_b, props_b, backend="torch")
    same("(j-b) int32 (4, 4096) cells, 2^23 weighted proposals", kern_b(),
         plain_b())

    def library_b():
        flat = torch.where(cols_b >= 0, rows + cols_b, depth * width).long().reshape(-1)
        cells = torch.cat([counts.reshape(-1), counts.new_zeros(1)])
        return cells.scatter_reduce_(0, flat, props_b.expand(depth, k).reshape(-1),
                                     "amax")[:-1].view(depth, width)

    same("(j-b) the library yardstick computes the same cells", library_b(),
         plain_b())
    shapes.append({
        "case": "j-b: cells int32 (4, 4096), col ids int32 (4, 2^23), "
                "proposals int32 (2^23,)",
        **timings(kern_b, plain_b, library_b),
        "bound_ms": (4 * depth * k + 4 * k + 8 * depth * width)
        / HBM_BYTES_PER_S * 1e3,
    })
    # (k) float32 cells, both paths; (l) every proposal masked; (m) no
    # proposals; (j-wide) rows wider than the cluster path takes (the
    # cooperative path)
    fcounts = _floats(g, depth * width, dev).reshape(depth, width)
    fprops = _floats(g, n, dev)
    for path in ("cluster", "cooperative"):
        same(f"(k) float32 cells, {path} path",
             cms_update_cuda(fcounts, cols, fprops, path=path),
             cms_update(fcounts, cols, fprops, backend="torch"))
    masked = torch.full_like(cols, -1)
    same("(l) all proposals masked", cms_update(counts, masked, props, backend="cuda"),
         counts)
    none = torch.empty((depth, 0), dtype=torch.int32, device=dev)
    same("(m) n == 0", cms_update(counts, none, props[:0], backend="cuda"), counts)
    wide = rand(0, 1 << 26, depth, 100_000)
    wcols = rand(-1, 100_003, depth, n)
    same("(j-wide) rows of 100,000 cells (the cooperative path)",
         cms_update(wide, wcols, props, backend="cuda"),
         cms_update(wide, wcols, props, backend="torch"))
    return 0.0, shapes


def main_path(dev, workdir: str):
    """Phase 3: the port's challenge run at scale 24, default and fused,
    sharing one capture in ``workdir``; then the sketch tier over it."""
    import numpy as np
    import torch
    from repro_torch.challenge.pipeline import (ChallengeConfig, _window_activity,
                                                run_challenge)
    from repro_torch.challenge.run import (format_queries, format_sketch,
                                           run_sketch_tier, verify_scalars,
                                           verify_sketch)
    from repro_torch.convert import results_to_numpy
    from repro_torch.core.ref import ref_run_all_queries
    from repro_torch.core.sketch import SketchConfig

    runs, launches = {}, {}
    for name, fused in (("default", False), ("fused_epilogue", True)):
        cfg = ChallengeConfig(scale=SCALE, method="hash", fused_epilogue=fused,
                              n_windows=N_WINDOWS, ip_bins=IP_BINS,
                              workdir=workdir, device=str(dev))
        reset_launches()
        run = run_challenge(cfg)
        launches[name] = read_launches()
        # per analyze call: the activity histogram, plus with the fused
        # epilogue 4 gated sums per window per plan side and the top-k sum;
        # the warm pass runs analyze a second time
        per_analyze = 1 + (2 * N_WINDOWS * 4 + 1 if fused else 0)
        want = {"histogram": per_analyze * (2 if cfg.warm else 1),
                "segment_max": 0, "cms_update": 0, "hll_update": 0,
                **NO_LM_OR_GNN}
        if launches[name] != want:
            raise AssertionError(f"{name}: kernel launches {launches[name]}, "
                                 f"the code implies {want}")
        log(f"\n[{name}] kernel launches {launches[name]}; phase walls:")
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

    # the sketch tier over the same capture, in micro-batches of 2^15 rows
    batches = -(-len(cap["src"]) // SKETCH_BATCH)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    snap = run_sketch_tier(cap, SketchConfig(), device=str(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["sketch_tier"] = read_launches()
    want = {"histogram": 0, "segment_max": 3 * batches, "cms_update": 2 * batches,
            "hll_update": 3 * batches, **NO_LM_OR_GNN}
    if launches["sketch_tier"] != want:
        raise AssertionError(f"sketch tier: kernel launches "
                             f"{launches['sketch_tier']}, the code implies {want}")
    log(f"\n[sketch tier] {batches} batches of 2^15 rows in {wall:.4f} s "
        f"({len(cap['src']) / wall:,.0f} packets/s); kernel launches "
        f"{launches['sketch_tier']}")
    log(format_sketch(snap))
    if snap.n_batches != batches or verify_sketch(snap, ref):
        raise AssertionError("sketch tier: an estimate is outside its bound")
    log("[sketch tier] all sketch estimates within their configured bounds")
    # what phase 9 needs of the default run, on the host: phases 4-8 run
    # with no device memory of phase 3's left
    table3 = {"columns": {c: v.cpu().numpy() for c, v in table.columns.items()},
              "n_valid": int(table.n_valid), "results": a}
    return launches, wall, cap, ref, table3


def algorithm_pass(dev, workdir: str):
    """Phase 4: ``run_challenge(algorithms=True)`` at scale 20 against the
    NumPy oracles, the launch counts, BFS from a busy source and each
    algorithm timed on its own.  Returns (the run's launches, the timing
    runs' launches, per-algorithm ms)."""
    import torch
    from repro_torch.challenge.pipeline import ChallengeConfig, run_challenge
    from repro_torch.challenge.run import format_algorithms, verify_algorithms
    from repro_torch.core import algorithms as alg
    from repro_torch.core.queries import table_csrs
    from repro_torch.core.ref import ref_bfs

    cfg = ChallengeConfig(scale=ALGO_SCALE, method="hash", algorithms=True,
                          n_windows=N_WINDOWS, ip_bins=IP_BINS,
                          workdir=workdir, device=str(dev))
    reset_launches()
    run = run_challenge(cfg)
    got = read_launches()
    a = run.results.algorithms
    log(run.timings.format_table())
    log(format_algorithms(run.results))
    bfs_it, cc_it, pr_it = (int(a.bfs.iterations), int(a.components.iterations),
                            int(a.pagerank.iterations))
    # per analyze: one segment-max launch per BFS step and two per
    # components step; one histogram launch for the activity histogram, one
    # per PageRank step and one for the triangles' per-node roll-up.  The
    # warm pass runs analyze a second time; its PageRank may take one step
    # more or less, since float atomics sum in no fixed order (BFS and
    # components are exact, so their counts are not allowed to move)
    want_max = 2 * (bfs_it + 2 * cc_it)
    warm_pr = got["histogram"] - 2 * 2 - pr_it
    if (got["segment_max"] != want_max or abs(warm_pr - pr_it) > 1
            or got["cms_update"] != 0 or got["hll_update"] != 0
            or any(got[k] for k in NO_LM_OR_GNN)):
        raise AssertionError(f"algorithm pass: kernel launches {got}, the code "
                             f"implies segment_max {want_max} and histogram "
                             f"4 + {pr_it} + ({pr_it} +- 1)")
    log(f"[algorithms] kernel launches {got} (segment max = 2 x ({bfs_it} + 2 x "
        f"{cc_it}); histogram = 2 x 2 + {pr_it} + {warm_pr})")
    t0 = time.perf_counter()
    if verify_algorithms(run):
        raise AssertionError("algorithm pass disagrees with the NumPy oracles")
    log(f"[algorithms] all four match their NumPy oracles "
        f"(oracles {time.perf_counter() - t0:.1f} s)")

    # BFS again from the heaviest link's source, which has out-edges
    csr_src, csr_dst = table_csrs(run.anon_table)
    nv = 2 * run.anon_table.capacity
    n_live = int(run.results.scalars.n_unique_ips)
    source = int(run.results.top.src[0])
    src, dst = run.anon_columns["src"], run.anon_columns["dst"]
    times, counts = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        counts[name] = read_launches()
        return out

    bfs = timed("bfs", lambda: alg.bfs_levels(csr_src, source, nv, n_live=n_live))
    want = ref_bfs(src, dst, n_live, source)
    levels = bfs.levels.cpu().numpy()
    if not ((levels[:n_live] == want).all() and (levels[n_live:] == -1).all()):
        raise AssertionError(f"bfs from {source}: levels disagree with ref_bfs")
    if int(bfs.iterations) < 3:
        raise AssertionError(f"bfs from {source}: only {int(bfs.iterations)} steps")
    log(f"[algorithms] bfs from {source} (the heaviest link's source): "
        f"{int(bfs.n_reached):,} reached, {int(bfs.iterations)} steps, "
        "matches ref_bfs")
    cc = timed("components", lambda: alg.connected_components(
        csr_src, nv, csr_t=csr_dst, n_live=n_live))
    pr = timed("pagerank", lambda: alg.pagerank(csr_src, nv, n_live=n_live))
    tri = timed("triangles", lambda: alg.triangle_counts(csr_src, nv))
    if int(tri.total) != int(a.triangles.total) or int(cc.n_components) != int(
            a.components.n_components):
        raise AssertionError("algorithms alone disagree with the pass")
    want = {"bfs": {"histogram": 0, "segment_max": int(bfs.iterations)},
            "components": {"histogram": 0, "segment_max": 2 * int(cc.iterations)},
            "pagerank": {"histogram": int(pr.iterations), "segment_max": 0},
            "triangles": {"histogram": 1, "segment_max": 0}}
    for name, w in want.items():
        if counts[name] != {**w, "cms_update": 0, "hll_update": 0, **NO_LM_OR_GNN}:
            raise AssertionError(f"{name} alone: launches {counts[name]}, the "
                                 f"code implies {w}")
    log(f"[algorithms] alone, ms (synchronized before and after): "
        f"{json.dumps(times)}; launches {json.dumps(counts)}")
    return got, counts, times


def cli_algorithms_and_sketch() -> dict:
    """Phase 5: the CLI as a user calls it, with ``--algorithms --tier
    both`` and its other defaults (the card, shuffle anonymization), at
    scale 18: exit 0, all three oracle lines, every kernel launched.
    Returns the run's launches."""
    from repro_torch.challenge.run import main

    out = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as workdir:
        reset_launches()
        with contextlib.redirect_stdout(out):
            rc = main(["--scale", str(CLI_SCALE), "--algorithms", "--tier",
                       "both", "--workdir", workdir])
        launches = read_launches()
    text = out.getvalue()
    log(text)
    if rc != 0:
        raise AssertionError(f"python -m repro_torch.challenge.run exited {rc}")
    for line in ("all scalar queries match the NumPy oracle",
                 "all four graph algorithms match their NumPy oracles",
                 "all sketch estimates within their configured bounds"):
        if line not in text:
            raise AssertionError(f"the CLI did not print {line!r}")
    if not all(launches[k] for k in launches if k not in NO_LM_OR_GNN):
        raise AssertionError(f"the CLI launched no kernel of {launches}")
    log(f"[cli] kernel launches {launches}")
    return launches


def stream_engine(dev, capture, ref):
    """Phase 8: the streaming engine (``repro_torch.stream``) over phase 3's
    scale-24 capture in micro-batches of STREAM_BATCH rows, exact, with
    per-phase walls, with both tiers and merged from two halves; the A/B of
    the two link paths and the algorithms at scale 20; the CLI.  ``capture``
    and ``ref`` are phase 3's capture and its NumPy oracle, reused once the
    plq written here reads back equal to the capture.  Returns the runs'
    launches and a summary of the numbers."""
    import dataclasses
    import warnings

    import numpy as np
    import torch
    from repro_torch.challenge.pipeline import window_column
    from repro_torch.challenge.run import verify_sketch
    from repro_torch.convert import tensor_leaves
    from repro_torch.core.ops import mix32
    from repro_torch.core.ref import ref_bfs, ref_cc, ref_pagerank, ref_triangles
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.data.plq import read_plq, write_plq
    from repro_torch.data.rmat import synthetic_packets
    from repro_torch.kernels.ops import windowed_histogram
    from repro_torch.stream import (StreamConfig, StreamEngine, init_state,
                                    link_table, steady_state, stream_plq,
                                    update_state, update_state_naive)
    from repro_torch.stream.run import main as stream_main

    n = len(capture["src"])
    batches = -(-n // STREAM_BATCH)
    win = window_column(capture["ts"], N_WINDOWS)
    launches, summary = {}, {"batches": batches, "batch_rows": STREAM_BATCH}
    cfg = StreamConfig(batch_capacity=STREAM_BATCH, link_capacity=n,
                       n_windows=N_WINDOWS, ip_bins=IP_BINS, device=str(dev))
    both = dataclasses.replace(cfg, tier="both", sketch=SketchConfig())
    off = {"histogram": 0, "segment_max": 0, "cms_update": 0, "hll_update": 0,
           **NO_LM_OR_GNN}

    def check_launches(name, **want):
        launches[name] = read_launches()
        if launches[name] != {**off, **want}:
            raise AssertionError(f"{name}: kernel launches {launches[name]}, "
                                 f"the code implies {want}")
        log(f"[{name}] kernel launches {launches[name]}")

    def check_scalars(name, snap):
        bad = {k: (int(getattr(snap.results.scalars, k)), v) for k, v in ref.items()
               if int(getattr(snap.results.scalars, k)) != v}
        if bad or snap.overflow != 0:
            raise AssertionError(f"{name}: overflow {snap.overflow}, scalars "
                                 f"(stream, oracle) disagree: {bad}")
        log(f"[{name}] all {len(ref)} scalars match the NumPy oracle, overflow 0")

    def write(path, rows, names):
        write_plq(path, {k: capture[k][rows] for k in names},
                  row_group_size=STREAM_BATCH)
        return path

    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as workdir:
        path = write(os.path.join(workdir, "capture.plq"), slice(None),
                     ("ts", "src", "dst"))
        back = read_plq(path, ["ts", "src", "dst"])
        if not all(np.array_equal(back[k], capture[k]) for k in back):
            raise AssertionError("the stream's plq does not read back as phase "
                                 "3's capture")
        log(f"{n:,} packets of phase 3's capture in {batches} row groups of "
            f"{STREAM_BATCH:,} (read back equal: phase 3's oracle reused)")

        # 1. the exact tier, overlapped, then a snapshot
        eng = StreamEngine(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        timings = stream_plq(eng, path, win)
        stream_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        snap = eng.snapshot()
        snap_s = time.perf_counter() - t0
        # one activity fold a batch; the snapshot launches none (analyze is
        # handed the accumulated activity)
        check_launches("stream_exact", histogram=batches)
        check_scalars("stream_exact", snap)
        ss = steady_state(timings)
        summary["exact"] = {
            "stream_s": stream_s, "steady_batch_s": ss["batch_s"],
            "steady_packets_per_s": ss["packets_per_s"],
            "first_batch_s": timings[0].total_s, "snapshot_s": snap_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "n_links": snap.n_links, "n_ips": snap.n_ips}
        log(f"[stream_exact] steady state {ss['packets_per_s']:,.0f} packets/s, "
            f"{ss['batch_s']:.4f} s a batch (first batch {timings[0].total_s:.3f} "
            f"s); {stream_s:.3f} s for the stream, snapshot {snap_s:.3f} s; "
            f"{snap.n_links:,} links, {snap.n_ips:,} IPs; max_memory_allocated "
            f"{summary['exact']['max_memory_allocated'] / 2 ** 30:.2f} GiB")
        src = torch.from_numpy(capture["src"].astype(np.int64)).to(dev)
        plain = windowed_histogram(
            torch.from_numpy(win).to(dev), (mix32(src) % IP_BINS).to(torch.int32),
            N_WINDOWS, IP_BINS, weights=torch.ones(n, device=dev), backend="torch")
        if not torch.equal(eng.state.activity, plain):
            raise AssertionError("stream_exact: the accumulated activity differs "
                                 "from the plain histogram of the capture")
        log("[stream_exact] accumulated activity == the plain windowed "
            "histogram of the whole capture, bit for bit")
        activity = eng.state.activity.clone()
        del eng, snap, src, plain

        # 2. per-phase walls over the first STREAM_PHASE_BATCHES batches
        m = STREAM_PHASE_BATCHES * STREAM_BATCH
        part = write(os.path.join(workdir, "first.plq"), slice(0, m), ("src", "dst"))
        eng = StreamEngine(cfg)
        ss = steady_state(stream_plq(eng, part, win[:m], time_phases=True))
        summary["time_phases"] = {k: ss[k] for k in
                                  ("prep_s", "transfer_s", "update_s", "batch_s")}
        log(f"[stream --time-phases] {STREAM_PHASE_BATCHES} batches, steady "
            f"state a batch: prep {ss['prep_s']:.5f} s, transfer "
            f"{ss['transfer_s']:.5f} s, update {ss['update_s']:.5f} s")
        del eng

        # 3. both tiers, counting the host syncs of the steady-state batches;
        # first a control: one sync the count must see
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                torch.ones(1, device=dev).item()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if not any(SYNC_WARNING in str(w.message) for w in caught):
            raise AssertionError("the host-sync count misses a .item()")
        eng = StreamEngine(both)

        def sync_window(i, _):
            if i == 0:
                torch.cuda.set_sync_debug_mode("warn")
            if i == batches - 1:
                torch.cuda.set_sync_debug_mode("default")

        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                timings = stream_plq(eng, path, win, on_batch=sync_window)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        snap = eng.snapshot()
        check_launches("stream_both", histogram=batches, cms_update=2 * batches,
                       segment_max=3 * batches, hll_update=3 * batches)
        check_scalars("stream_both", snap)
        if verify_sketch(snap.sketch, ref):
            raise AssertionError("stream_both: a sketch estimate is outside its bound")
        syncs = _sync_sites(caught)
        ss = steady_state(timings)
        summary["both"] = {"steady_batch_s": ss["batch_s"],
                           "steady_packets_per_s": ss["packets_per_s"],
                           "host_syncs": sum(syncs.values()),
                           "host_syncs_per_batch": sum(syncs.values()) / (batches - 1),
                           "sync_sites": syncs}
        log(f"[stream_both] every sketch estimate within its bound; steady state "
            f"{ss['packets_per_s']:,.0f} packets/s, {ss['batch_s']:.4f} s a "
            f"batch; host syncs over batches 1-{batches - 1}: "
            f"{sum(syncs.values())} {json.dumps(syncs)}")
        del eng, snap

        # 4. two engines, one half each, merged
        half = batches // 2 * STREAM_BATCH
        reset_launches()
        shards = []
        for name, rows in (("a", slice(0, half)), ("b", slice(half, n))):
            shard = StreamEngine(both)
            stream_plq(shard, write(os.path.join(workdir, f"half_{name}.plq"),
                                    rows, ("src", "dst")), win[rows])
            shards.append(shard)
        shards[0].merge_from(shards[1].state, shards[1].sketch_state)
        snap = shards[0].snapshot()
        check_launches("stream_merge", histogram=batches, cms_update=2 * batches,
                       segment_max=3 * batches, hll_update=3 * batches)
        check_scalars("stream_merge", snap)
        if verify_sketch(snap.sketch, ref) or snap.n_batches != batches:
            raise AssertionError("stream_merge: the merged sketch is outside its "
                                 "bounds or lost batches")
        if not torch.equal(shards[0].state.activity, activity):
            raise AssertionError("stream_merge: merged activity != step 1's")
        log(f"[stream_merge] batches 0-{batches // 2 - 1} and {batches // 2}-"
            f"{batches - 1} merged: scalars, sketch bounds and activity (== step "
            "1's, bit for bit) hold")
        del shards, snap

    # 5. the two link paths side by side, then the algorithms, at scale 20
    n20 = 1 << ALGO_SCALE
    rows20 = n20 // STREAM_AB_BATCHES
    cols = synthetic_packets(n20, scale=ALGO_SCALE, seed=SEED)
    dcols = [torch.from_numpy(np.ascontiguousarray(c, np.int32)).to(dev)
             for c in (cols["src"], cols["dst"], window_column(cols["ts"], N_WINDOWS))]
    cfg20 = dataclasses.replace(cfg, batch_capacity=rows20, link_capacity=n20)
    fast = naive = init_state(n20, cfg20.ips, N_WINDOWS, IP_BINS, dev)
    walls = {"update_state": [], "update_state_naive": []}
    reset_launches()
    for i in range(STREAM_AB_BATCHES):
        batch = [c[i * rows20:(i + 1) * rows20] for c in dcols]
        for name, fn in (("update_state", update_state),
                         ("update_state_naive", update_state_naive)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(fast if name == "update_state" else naive, *batch, rows20)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            if name == "update_state":
                fast = out
            else:
                naive = out
        pairs = list(zip(tensor_leaves(fast), tensor_leaves(naive)))
        diff = [k for (k, a), (_, b) in pairs if not torch.equal(a, b)]
        if diff or len(pairs) != 14:
            raise AssertionError(f"batch {i}: update_state and update_state_naive "
                                 f"differ in {diff}")
    check_launches("stream_ab", histogram=2 * STREAM_AB_BATCHES)
    summary["ab_s_per_batch"] = {k: sum(v[1:]) / (len(v) - 1) for k, v in walls.items()}
    log(f"[stream_ab] scale {ALGO_SCALE}, {STREAM_AB_BATCHES} batches of "
        f"{rows20:,}: every leaf identical after every batch; s a batch (first "
        f"excluded, synchronized): {json.dumps(summary['ab_s_per_batch'])}")
    eng = StreamEngine(cfg20)
    eng.load(fast)
    del fast, naive
    reset_launches()
    t0 = time.perf_counter()
    alg = eng.algorithms(source=0)
    summary["algorithms_s"] = time.perf_counter() - t0
    bfs_it, cc_it, pr_it = (int(alg.bfs.iterations), int(alg.components.iterations),
                            int(alg.pagerank.iterations))
    check_launches("stream_algorithms", segment_max=bfs_it + 2 * cc_it,
                   histogram=pr_it + 1)
    t = link_table(eng.state)
    n_links, n_live = int(t.n_valid), int(eng.state.n_ips)
    s, d, w = (t[c][:n_links].cpu().numpy().astype(np.int64)
               for c in ("src", "dst", "n_packets"))
    host = lambda x: x.cpu().numpy()
    levels, labels = host(alg.bfs.levels), host(alg.components.labels)
    ranks, per_node = host(alg.pagerank.ranks), host(alg.triangles.per_node)
    want_pr, _, _ = ref_pagerank(s, d, w, n_live)
    want_tri, total = ref_triangles(s, d, n_live)
    want_cc = ref_cc(s, d, n_live)
    checks = {
        "bfs": np.array_equal(levels[:n_live], ref_bfs(s, d, n_live, 0))
        and bool((levels[n_live:] == -1).all()),
        "components": np.array_equal(labels[:n_live], want_cc)
        and bool((labels[n_live:] == -1).all())
        and int(alg.components.n_components) == len(np.unique(want_cc)),
        "pagerank": float(np.abs(ranks[:n_live] - want_pr).sum()) < 1e-6
        and bool((ranks[n_live:] == 0).all()),
        "triangles": np.array_equal(per_node[:n_live], want_tri.astype(np.float32))
        and int(alg.triangles.total) == total,
    }
    if not all(checks.values()):
        raise AssertionError(f"stream algorithms vs the NumPy oracles: {checks}")
    log(f"[stream_algorithms] {n_links:,} links, {n_live:,} vertices: bfs "
        f"({bfs_it} steps), components, pagerank ({pr_it} steps, L1 < 1e-6) and "
        f"triangles ({total:,}) match the oracles; {summary['algorithms_s']:.3f} s")
    del eng, alg, dcols

    # 6. the CLI
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_cli_") as workdir:
        argv = ["--scale", str(CLI_SCALE), "--batches", "8", "--workdir", workdir]
        out = io.StringIO()
        reset_launches()
        with contextlib.redirect_stdout(out):
            rc = stream_main(argv + ["--tier", "both"])
        log(out.getvalue())
        if rc != 0 or any(line not in out.getvalue() for line in (
                "all scalar queries match the NumPy oracle",
                "all sketch estimates within their configured bounds")):
            raise AssertionError(f"python -m repro_torch.stream.run exited {rc} "
                                 "or left out an oracle line")
        check_launches("stream_cli", histogram=8, cms_update=16, segment_max=24,
                       hll_update=24)
        err = io.StringIO()
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            rc = stream_main(argv + ["--link-capacity", "1000"])
        if rc != 1 or "state overflow" not in err.getvalue():
            raise AssertionError(f"the stream CLI with 1,000 links of capacity "
                                 f"exited {rc}, not 1 on overflow")
        check_launches("stream_cli_overflow", histogram=8)
        log("[stream_cli] exit 0 with both oracle lines; exit 1 on overflow")
    return launches, summary


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def fault_tolerant_service(dev, capture, ref, card: str):
    """Phase 10: the fault-tolerant service (``repro_torch.stream.recovery``)
    over phase 3's capture in phase 8's geometry: a fault-free reference run
    with commits every 16 batches, the chaos cocktail with a crash after
    batch 40 (bit-equal to the reference run, host syncs counted fold by
    fold), degradation to the sketch tier at 2^23 links, a crash after the
    switch at scale 20, and the serve CLI.  Returns the runs' launches and
    a summary of the numbers."""
    import dataclasses
    import shutil
    import warnings

    import numpy as np
    import torch
    from repro_torch.challenge.pipeline import window_column
    from repro_torch.challenge.run import verify_sketch
    from repro_torch.core.sketch import SketchConfig, init_sketch, update_sketch
    from repro_torch.data.faults import FaultConfig, RetryPolicy
    from repro_torch.data.plq import write_plq
    from repro_torch.data.rmat import synthetic_packets
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.obs import reset_registry
    from repro_torch.stream import DegradePolicy, StreamConfig, run_service
    from repro_torch.train.checkpoint import tree_flatten

    n = len(capture["src"])
    batches = n // STREAM_BATCH
    win = window_column(capture["ts"], N_WINDOWS)
    every, crash_at = 16, 40
    cfg = StreamConfig(batch_capacity=STREAM_BATCH, link_capacity=n,
                       n_windows=N_WINDOWS, ip_bins=IP_BINS, tier="both",
                       sketch=SketchConfig(), device=str(dev))
    off = {"histogram": 0, "segment_max": 0, "cms_update": 0, "hll_update": 0,
           **NO_LM_OR_GNN}
    launches, summary = {}, {"card": card, "batches": batches,
                             "checkpoint_every": every}

    def check_launches(name, folds, sketch_folds, backfills=0):
        launches[name] = read_launches()
        sk = sketch_folds + backfills
        want = {**off, "histogram": folds, "cms_update": 2 * sk,
                "segment_max": 3 * sk, "hll_update": 3 * sk}
        if launches[name] != want:
            raise AssertionError(f"{name}: kernel launches {launches[name]}, "
                                 f"the code implies {want}")
        log(f"[{name}] kernel launches {launches[name]}")

    def check_answers(name, snap, exact=True):
        if exact:
            bad = {k: (int(getattr(snap.results.scalars, k)), v)
                   for k, v in ref.items()
                   if int(getattr(snap.results.scalars, k)) != v}
            if bad or snap.overflow != 0:
                raise AssertionError(f"{name}: overflow {snap.overflow}, scalars "
                                     f"(service, oracle) disagree: {bad}")
        if verify_sketch(snap.sketch, ref):
            raise AssertionError(f"{name}: a sketch estimate is outside its bound")
        log(f"[{name}] " + ("all scalars match the NumPy oracle, overflow 0; "
                            if exact else "") + "every sketch estimate within its bound")

    def host_leaves(engine):
        tree = {"exact": engine.state, "sketch": engine.sketch_state}
        return [x.cpu().numpy() for x in tree_flatten(tree)[0]]

    def fold_stats(timings):
        steady = np.array([t.total_s for t in timings if not t.compile])
        return {"p50_s": float(np.percentile(steady, 50)),
                "p99_s": float(np.percentile(steady, 99)),
                "steady_packets_per_s": float(
                    sum(t.n_packets for t in timings if not t.compile) / steady.sum())}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as workdir:
        path = os.path.join(workdir, "capture.plq")
        write_plq(path, {k: capture[k] for k in ("src", "dst")},
                  row_group_size=STREAM_BATCH)

        # 1. the reference run: no faults, a commit every 16 batches
        ck = os.path.join(workdir, "ck_reference")
        reset_registry()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        rep = run_service(cfg, path, win, checkpoint_dir=ck,
                          checkpoint_every=every, keep=2)
        wall = time.perf_counter() - t0
        check_launches("serve_reference", batches, batches)
        peak = torch.cuda.max_memory_allocated()
        check_answers("serve_reference", rep.snapshot())
        peak_snap = torch.cuda.max_memory_allocated()  # phase 8's includes one
        want = host_leaves(rep.engine)
        tree = {"exact": rep.engine.state, "sketch": rep.engine.sketch_state}
        copies = []
        for _ in range(3):  # one save's device-to-host copies, on their own
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _ = [x.detach().cpu() for x in tree_flatten(tree)[0]]
            copies.append(time.perf_counter() - t1)
        state_bytes = sum(a.nbytes for a in want)
        disk = {"checkpoint_bytes": _dir_bytes(ck),
                "free_bytes": shutil.disk_usage(workdir).free}
        summary["reference"] = {
            "wall_s": wall, "packets_per_s": n / wall, **fold_stats(rep.timings),
            "commit_walls_s": rep.checkpoint_walls,
            "d2h_copy_s": sorted(copies)[1], "state_bytes": state_bytes,
            "max_memory_allocated": peak,
            "max_memory_allocated_with_snapshot": peak_snap, **disk}
        r = summary["reference"]
        log(f"[serve_reference] {card}: {batches} folds, {len(rep.checkpoint_walls)} "
            f"commits; fold p50 {r['p50_s']:.4f} s p99 {r['p99_s']:.4f} s (phase "
            f"8: 0.0281 s a batch); {r['packets_per_s']:,.0f} packets/s with the "
            f"commits, {r['steady_packets_per_s']:,.0f} steady (phase 8 both "
            f"tiers: 8,222,038); commit walls {json.dumps(rep.checkpoint_walls)} "
            f"s, of which one save's {state_bytes / 2 ** 20:.1f} MiB of "
            f"device-to-host copies take {r['d2h_copy_s']:.4f} s, the rest np.save "
            f"+ fsync; max_memory_allocated {peak / 2 ** 30:.2f} GiB, "
            f"{peak_snap / 2 ** 30:.2f} with the snapshot (phase 8's exact run "
            f"and snapshot: 4.20); checkpoints {disk['checkpoint_bytes'] / 1e9:.3f} GB on disk "
            f"(keep=2), {disk['free_bytes'] / 1e9:.1f} GB free")
        del rep, tree
        shutil.rmtree(ck)

        # 2. the chaos cocktail and a crash after batch 40: bit-equal to step
        # 1, and no host sync in a fold but the commits' and the restore's
        ck = os.path.join(workdir, "ck_chaos")
        quarantine = os.path.join(workdir, "quarantine")
        faults = FaultConfig(seed=11, transient_io_rate=0.25, corrupt_rate=0.25,
                             duplicate_rate=0.2, reorder_rate=0.2,
                             crash_at_batch=crash_at)
        marks = []  # (seq, syncs so far, bytes allocated) after each fold

        def on_batch(seq, _):
            if not marks:
                torch.cuda.set_sync_debug_mode("warn")
            syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
            marks.append((seq, syncs, torch.cuda.memory_allocated()))

        reset_registry()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            try:
                rep = run_service(cfg, path, win, checkpoint_dir=ck,
                                  checkpoint_every=every, keep=2, faults=faults,
                                  retry=RetryPolicy(base_backoff_s=0.0),
                                  quarantine_dir=quarantine, on_batch=on_batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            wall = time.perf_counter() - t0
        replayed = crash_at + 1 - crash_at // every * every
        check_launches("serve_chaos", batches + replayed, batches + replayed)
        h = rep.health
        if (h.crashes_recovered, h.batches_replayed, h.lost_batches) != (1, replayed, 0) \
                or h.faults_seen == 0 or rep.restarts != 1 \
                or not os.path.exists(os.path.join(quarantine, "quarantine.jsonl")):
            raise AssertionError(f"serve_chaos: restarts {rep.restarts}, health "
                                 f"{h.as_dict()}, quarantine trail missing?")
        peak = torch.cuda.max_memory_allocated()
        got = host_leaves(rep.engine)
        diff = [i for i, (a, b) in enumerate(zip(got, want))
                if a.dtype != b.dtype or not np.array_equal(a, b)]
        if diff or len(got) != 28:
            raise AssertionError(f"serve_chaos: leaves {diff} differ from the "
                                 "fault-free run's")
        check_answers("serve_chaos", rep.snapshot())
        # syncs between two folds' marks belong to the later fold, or to a
        # commit between them, or (after the crash's fold) to the restore
        per_fold, commit_or_restore = [], []
        for i in range(1, len(marks)):
            prev = marks[i - 1][0]
            (commit_or_restore if i - 1 == crash_at or (prev + 1) % every == 0
             else per_fold).append(marks[i][1] - marks[i - 1][1])
        life1 = [mem for _, _, mem in marks[:crash_at + 1]]
        life2 = [mem for _, _, mem in marks[crash_at + 1:]]
        if any(per_fold):
            raise AssertionError(f"serve_chaos: host syncs in non-commit folds: "
                                 f"{per_fold}")
        if max(life2) > max(life1) + (64 << 20):
            raise AssertionError(f"serve_chaos: the restored life holds "
                                 f"{max(life2)} bytes against {max(life1)}: "
                                 "the dead engine's state outlived the crash")
        summary["chaos"] = {
            "wall_s": wall, "packets_per_s": n / wall, **fold_stats(rep.timings),
            "commit_walls_s": rep.checkpoint_walls,
            "restore_walls_s": rep.restore_walls, "replay_wall_s": rep.replay_wall_s,
            "health": h.as_dict(), "faults_seen": h.faults_seen,
            "non_commit_folds": len(per_fold), "host_syncs_non_commit": sum(per_fold),
            "host_syncs_commit_or_restore": commit_or_restore,
            "max_memory_allocated": peak,
            "allocated_between_folds_life1": max(life1),
            "allocated_between_folds_life2": max(life2)}
        c = summary["chaos"]
        log(f"[serve_chaos] {card}: the cocktail ({h.faults_seen} fault events: "
            f"{json.dumps(h.as_dict())}) and a crash after batch {crash_at}: "
            f"restored at watermark {crash_at // every * every}, {replayed} batches "
            f"replayed, every exact and sketch leaf bit-equal to the fault-free "
            f"run; host syncs: 0 over {len(per_fold)} non-commit folds, "
            f"{commit_or_restore} after the commits and the restore; restore "
            f"{json.dumps(rep.restore_walls)} s, replay {rep.replay_wall_s:.4f} s; "
            f"fold p50 {c['p50_s']:.4f} s p99 {c['p99_s']:.4f} s; "
            f"{c['packets_per_s']:,.0f} packets/s; max_memory_allocated "
            f"{peak / 2 ** 30:.2f} GiB, between folds {max(life1) / 2 ** 30:.3f} "
            f"GiB before the crash and {max(life2) / 2 ** 30:.3f} after")
        del rep, got, want
        shutil.rmtree(ck)

        # 3. degradation at scale 24: 2^23 links of capacity, both switches
        # before the capture ends, the exact tier frozen before any overflow
        dcfg = dataclasses.replace(cfg, tier="exact", link_capacity=SERVE_DEGRADE_LINKS)
        policy = DegradePolicy(to_both=0.5,
                               to_sketch=1 - STREAM_BATCH / SERVE_DEGRADE_LINKS)
        tiers = []
        reset_registry()
        reset_launches()
        t0 = time.perf_counter()
        rep = run_service(dcfg, path, win, degrade=policy,
                          on_batch=lambda seq, eng: tiers.append(eng.cfg.tier))
        wall = time.perf_counter() - t0
        # the first switch backfills the sketch; the fold that reaches
        # "sketch" is the exact tier's last
        to_both = next(i for i, t in enumerate(tiers) if t != "exact")
        to_sketch = tiers.index("sketch")
        check_launches("serve_degrade", to_sketch + 1, batches - 1 - to_both,
                       backfills=1)
        st = rep.engine.state
        live = int(st.n_links)
        snap = rep.snapshot()
        if snap.tier != "sketch" or int(st.overflow) != 0 \
                or snap.sketch.n_packets != n:
            raise AssertionError(f"serve_degrade: tier {snap.tier}, overflow "
                                 f"{int(st.overflow)}, sketch packets "
                                 f"{snap.sketch.n_packets}")
        check_answers("serve_degrade", snap, exact=False)
        # the backfill's own wall on the frozen table (launches not counted)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            update_sketch(init_sketch(cfg.sketch_config, dev), st.src, st.dst,
                          st.n_links, weights=st.packets)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        summary["degrade"] = {
            "wall_s": wall, "to_both_after_batch": to_both,
            "to_sketch_after_batch": to_sketch, "live_links_frozen": live,
            "backfill_s": sorted(walls)[1], **fold_stats(rep.timings)}
        log(f"[serve_degrade] {card}: link_capacity {SERVE_DEGRADE_LINKS:,}: "
            f"exact -> both after batch {to_both}, -> sketch after batch "
            f"{to_sketch} ({live:,} live links frozen, overflow 0); the sketch "
            f"holds all {n:,} packets; backfill (one weighted update_sketch over "
            f"{SERVE_DEGRADE_LINKS:,} rows) {summary['degrade']['backfill_s']:.4f} "
            f"s; service wall {wall:.3f} s")
        del rep, st, snap

    # 4. a crash after the switch, at scale 20: the restored service comes
    # back degraded and ends bit-equal to the uninterrupted degraded run
    n20 = 1 << ALGO_SCALE
    groups20, cap20 = 16, n20 // 2
    rows20 = n20 // groups20
    cols = synthetic_packets(n20, scale=ALGO_SCALE, seed=SEED)
    win20 = window_column(cols["ts"], N_WINDOWS)
    cfg20 = StreamConfig(batch_capacity=rows20, link_capacity=cap20,
                         n_windows=N_WINDOWS, ip_bins=IP_BINS, device=str(dev))
    policy20 = DegradePolicy(to_both=0.3, to_sketch=1 - rows20 / cap20)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve20_") as workdir:
        path20 = os.path.join(workdir, "capture.plq")
        write_plq(path20, cols, row_group_size=rows20)
        reset_launches()
        plain = run_service(cfg20, path20, win20, degrade=policy20)
        crash20 = groups20 - 2
        rep = run_service(cfg20, path20, win20, degrade=policy20,
                          checkpoint_dir=os.path.join(workdir, "ck"),
                          checkpoint_every=4, faults=FaultConfig(crash_at_batch=crash20))
        launches["serve_degrade_crash"] = read_launches()
        hp, hr = plain.health, rep.health
        if hp.degraded_to != "sketch" or hp.degraded_at_batch > crash20 // 4 * 4:
            raise AssertionError(f"scale {ALGO_SCALE}: the switch came at "
                                 f"{hp.degraded_at_batch}, after the restored step")
        if (rep.engine.cfg.tier, hr.degraded_at_batch, hr.crashes_recovered) != \
                ("sketch", hp.degraded_at_batch, 1):
            raise AssertionError(f"scale {ALGO_SCALE}: restored tier "
                                 f"{rep.engine.cfg.tier}, health {hr.as_dict()}")
        a, b = host_leaves(rep.engine), host_leaves(plain.engine)
        if any(not np.array_equal(x, y) for x, y in zip(a, b)) or len(a) != 28:
            raise AssertionError(f"scale {ALGO_SCALE}: the crashed degraded run "
                                 "differs from the uninterrupted one")
        log(f"[serve_degrade_crash] scale {ALGO_SCALE}, {groups20} batches, "
            f"{cap20:,} links: degraded to sketch at batch "
            f"{hp.degraded_at_batch}, crash after batch {crash20}, restored "
            f"degraded; every leaf bit-equal to the uninterrupted degraded run; "
            f"launches {json.dumps(launches['serve_degrade_crash'])}")
        del plain, rep

    # 5. the CLI
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_cli_") as workdir:
        metrics = os.path.join(workdir, "m.jsonl")
        argv = ["--scale", str(CLI_SCALE), "--n-packets", str(1 << CLI_SCALE + 2),
                "--batch-size", str(1 << CLI_SCALE - 2), "--tier", "both", "--chaos",
                "--fault-seed", "11", "--crash-at-batch", "4",
                "--checkpoint-dir", os.path.join(workdir, "ck"),
                "--quarantine-dir", os.path.join(workdir, "q"),
                "--metrics-out", metrics, "--verify", "--workdir", workdir,
                "--device", str(dev)]
        out = io.StringIO()
        reset_launches()
        with contextlib.redirect_stdout(out):
            rc = serve_main(argv)
        log(out.getvalue())
        lines = ("[serve] verify OK", "[serve] health:", "crashes=1",
                 "[serve] batch latency:")
        if rc != 0 or any(x not in out.getvalue() for x in lines) \
                or not os.path.exists(metrics) or not os.path.exists(metrics + ".prom"):
            raise AssertionError(f"python -m repro_torch.launch.serve exited {rc}, "
                                 "left out a line or wrote no metrics")
        # 16 folds and the one replayed (a commit after every batch), then
        # --verify's uninterrupted exact run
        check_launches("serve_cli", 17 + 16, 17)
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            try:
                serve_main(argv + ["--distributed"])
                rc = 0
            except SystemExit as e:
                rc = e.code
        if rc != 2 or "item 10" not in err.getvalue():
            raise AssertionError(f"the serve CLI with --distributed exited {rc}")
        log("[serve_cli] exit 0 with the verify OK, health (crashes=1) and batch "
            "latency lines, metrics JSONL and .prom written; --distributed exits 2")
    reset_registry()
    return launches, summary


def _median_wall(fn) -> float:
    """Median of 3 synchronized walls of ``fn()``, seconds."""
    import torch

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[1]


@contextlib.contextmanager
def capture_counts(out: dict):
    """Record the kernel launches made between a ``CUDAGraph``'s capture
    begin and end (the launches one replay repeats) and the sync debug mode
    at its end."""
    import torch

    graph = torch.cuda.CUDAGraph
    begin, end = graph.capture_begin, graph.capture_end

    def capture_begin(self, *a, **k):
        out["before"] = read_launches()
        return begin(self, *a, **k)

    def capture_end(self):
        after = read_launches()
        out["per_replay"] = {k: v - out["before"][k] for k, v in after.items()}
        out["sync_debug_mode"] = torch.cuda.get_sync_debug_mode()
        return end(self)

    graph.capture_begin, graph.capture_end = capture_begin, capture_end
    try:
        yield out
    finally:
        graph.capture_begin, graph.capture_end = begin, end


def ab_baselines_and_fused(dev, workdir: str, table3, ref):
    """Phase 9: the rest of the query surface and the A/B baselines on
    phase 3's anonymized scale-24 table (``table3``: its columns, live
    count and default results on the host; ``ref`` its oracle):
    ``analyze(use_plan=False)`` and ``windowed_method="grid"`` against the
    plan path, then ``run_challenge(fused=True)`` (one CUDA graph), the
    suite entry points and per-query functions against the oracle,
    ``connected_components(csr_t=None)`` at scale 20 and the CLI with
    ``--fused`` at scale 18.  Returns (launches by run, summary)."""
    import numpy as np
    import torch
    from repro_torch.challenge.pipeline import (ChallengeConfig, analyze,
                                                build_columns, read_phase,
                                                run_challenge)
    from repro_torch.challenge.run import main
    from repro_torch.convert import results_to_numpy, table_from_numpy
    from repro_torch.core import queries as q
    from repro_torch.core.algorithms import connected_components
    from repro_torch.core.anonymize import anonymize
    from repro_torch.core.plan import SortCounter
    from repro_torch.obs import get_tracer

    table = table_from_numpy(table3["columns"], table3["n_valid"], dev)
    plan_np = table3["results"]
    kw = dict(n_windows=N_WINDOWS, ip_bins=IP_BINS, k=ChallengeConfig().top_k,
              device=dev)
    off = {"histogram": 0, "segment_max": 0, "cms_update": 0, "hll_update": 0,
           **NO_LM_OR_GNN}
    launches, summary = {}, {}

    def check_launches(name, **want):
        got = read_launches()
        if got != {**off, **want}:
            raise AssertionError(f"{name}: kernel launches {got}, the code "
                                 f"implies {want}")
        launches[name] = got

    def equal_results(name, res, want_np):
        got = results_to_numpy(res)
        diff = [k for k in want_np if not np.array_equal(got.get(k), want_np[k])]
        if got.keys() != want_np.keys() or diff:
            raise AssertionError(f"{name}: results differ in {diff}")

    # 1. the plan path again, and its A/B baselines: each bit-equal to
    # phase 3's default run,
    # its sorts counted, its histogram launches, peak memory above what is
    # allocated before the call, and its wall (median of 3)
    sorts_want = {"plan": 3, "naive": 18, "grid": 3}
    hist_want = {"plan": 1, "naive": 2, "grid": 1}
    for name, opts in (("plan", {}), ("naive", {"use_plan": False}),
                       ("grid", {"windowed_method": "grid"})):
        with SortCounter() as counter:
            analyze(table, **kw, **opts)
        if counter.n != sorts_want[name]:
            raise AssertionError(f"analyze[{name}]: {counter.n} sorts, the code "
                                 f"implies {sorts_want[name]}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        res = analyze(table, **kw, **opts)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        check_launches(f"ab_{name}", histogram=hist_want[name])
        equal_results(f"analyze[{name}]", res, plan_np)
        del res
        wall = _median_wall(lambda: analyze(table, **kw, **opts))
        summary[f"analyze_{name}"] = {"wall_s": wall, "sorts": counter.n,
                                      "peak_bytes_above": peak}
        log(f"[analyze {name}] bit-equal to phase 3's; {counter.n} sorts; "
            f"{hist_want[name]} histogram launches; {wall:.4f} s (median of 3); "
            f"peak {peak / 2 ** 30:.3f} GiB above the table")

    # 2. the one-program path: run_challenge(fused=True), one CUDA graph
    get_tracer().clear()
    cfg = ChallengeConfig(scale=SCALE, method="hash", fused=True,
                          n_windows=N_WINDOWS, ip_bins=IP_BINS, workdir=workdir,
                          device=str(dev))
    graph_counts = {}
    reset_launches()
    with capture_counts(graph_counts):
        run = run_challenge(cfg)
    # the warm pass, the timed analyze, the eager program, the capture
    check_launches("fused", histogram=4)
    if graph_counts["per_replay"] != {**off, "histogram": 1}:
        raise AssertionError(f"fused: the capture launched "
                             f"{graph_counts['per_replay']}, not one histogram")
    if graph_counts["sync_debug_mode"] != 2:
        raise AssertionError("fused: the capture ran without the sync check")
    equal_results("fused replay", run.fused_results, results_to_numpy(run.results))
    if verify_scalars_of(run.fused_results, ref):
        raise AssertionError("fused replay: scalars disagree with the oracle")
    spans = {r["name"]: r["duration_s"] for r in get_tracer().records()
             if r.get("kind") == "span" and r.get("parent") == "challenge"}
    eager = spans["build_device"] + spans["anonymize"] + spans["analyze"]
    summary["fused"] = {"fused_s": run.timings.fused_s, "eager_sum_s": eager,
                        "build_device_s": spans["build_device"],
                        "anonymize_s": spans["anonymize"],
                        "analyze_s": spans["analyze"],
                        "per_replay": graph_counts["per_replay"]}
    log(run.timings.format_table())
    log(f"[fused] replay bit-equal to the phases, scalars match the oracle; "
        f"fused_s {run.timings.fused_s:.4f} against build_device + anonymize + "
        f"analyze {eager:.4f} s; per replay {graph_counts['per_replay']}; "
        "captured under set_sync_debug_mode('error')")
    del run

    # 3. the query surface on the anonymized table against the oracle
    checks = {name: getattr(q, name)(table).as_dict() for name in (
        "run_all_queries", "run_all_queries_csr", "run_all_queries_naive")}
    checks["per_query"] = {
        "valid_packets": q.valid_packets(table),
        "unique_links": q.unique_links(table),
        "max_link_packets": q.max_link_packets(table),
        "n_unique_sources": q.unique_sources(table).n_unique,
        "n_unique_destinations": q.unique_destinations(table).n_unique,
        "n_unique_ips": q.unique_ips(table).n_unique,
        "max_source_packets": q.max_source_packets(table),
        "max_source_fanout": q.max_source_fanout(table),
        "max_destination_packets": q.max_destination_packets(table),
        "max_destination_fanin": q.max_destination_fanin(table),
    }
    for name, got in checks.items():
        bad = {k: (int(got[k]), v) for k, v in ref.items() if int(got[k]) != v}
        if bad or got.keys() != ref.keys():
            raise AssertionError(f"{name}: (port, oracle) disagree: {bad}")
    log(f"[queries] {', '.join(checks)} equal the NumPy oracle")

    # 4. components with the transpose sorted from the CSR, at scale 20
    acfg = ChallengeConfig(scale=ALGO_SCALE, workdir=workdir, device=str(dev))
    src, dst, win, n = build_columns(read_phase(acfg, workdir), acfg)
    t20 = anonymize(table_from_numpy({"src": src, "dst": dst, "win": win}, n, dev),
                    method="hash").table
    csr_src, csr_dst = q.table_csrs(t20)
    nv, n_live = 2 * t20.capacity, q.unique_ips(t20).n_unique
    reset_launches()
    cc = connected_components(csr_src, nv, n_live=n_live)
    check_launches("components_no_transpose",
                   segment_max=2 * int(cc.iterations))
    given = connected_components(csr_src, nv, csr_t=csr_dst, n_live=n_live)
    if not (torch.equal(cc.labels, given.labels)
            and int(cc.n_components) == int(given.n_components)):
        raise AssertionError("components(csr_t=None) != components(csr_t=csr_dst)")
    log(f"[components] csr_t=None equals csr_t=csr_dst: {int(cc.n_components):,} "
        f"components in {int(cc.iterations)} steps, "
        f"{launches['components_no_transpose']['segment_max']} segment-max launches")
    del t20, csr_src, csr_dst, cc, given

    # 5. the CLI with --fused (shuffle, the default) at scale 18
    out = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fused_cli_") as cli_dir:
        reset_launches()
        with contextlib.redirect_stdout(out):
            rc = main(["--scale", str(CLI_SCALE), "--fused", "--workdir", cli_dir])
        check_launches("cli_fused", histogram=4)
    text = out.getvalue()
    log(text)
    if rc != 0 or "fused(b+a+a)" not in text or (
            "all scalar queries match the NumPy oracle" not in text):
        raise AssertionError(f"the CLI with --fused exited {rc} or left out the "
                             "fused row or the oracle line")
    log("[cli --fused] exit 0, the fused(b+a+a) row and the oracle line")
    return launches, summary


def verify_scalars_of(results, ref) -> int:
    """Scalars of ``results`` that disagree with the oracle ``ref``."""
    return sum(int(getattr(results.scalars, k)) != v for k, v in ref.items())


def _visible_keys(lq, lkv, causal, window):
    """Keys summed over rows that a query sees, under end alignment: the
    work attention needs on these inputs."""
    total = 0
    for i in range(lq):
        pos = i + lkv - lq
        hi = min(lkv, pos + 1) if causal else lkv
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def _key_span(lq, lkv, window):
    """Keys that some query sees, under end alignment: from the first
    query's oldest visible key to the newest key, which the last query
    sees, causal or not."""
    return lkv - (max(0, lkv - lq - window + 1) if window else 0)


def _attention_bound(q, k, v, causal, window):
    """(ms, "operations" or "bytes"): 4 * D flops per query-key pair (QK^T
    and PV) at the bf16 tensor-core peak, against q and o moved once and
    the k, v rows that some query sees (:func:`_key_span`: a window leaves
    the older keys unread) read once, at the memory rate."""
    b, hq, lq, d = q.shape
    lkv = k.shape[2]
    flops = 4 * b * hq * d * _visible_keys(lq, lkv, causal, window)
    span = _key_span(lq, lkv, window)
    nbytes = (2 * q.numel() + (k.numel() + v.numel()) // lkv * span) * q.element_size()
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _row_error(got, want):
    """Relative L2 error of each output row (one query of one head of one
    request): ``||got - want|| / (||want|| + 1e-6)``; a row that sees no
    key is 0 on both sides, so its error is 0 unless the kernel's is not."""
    diff = (got.float() - want.float()).norm(dim=-1)
    return diff / (want.float().norm(dim=-1) + 1e-6)


def check_attention(dev):
    """Phase 6: the attention kernel against its plain version on the card.
    Returns (max_abs_err, timed shape records)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_path, flash_attention_cuda
    from repro_torch.kernels.ops import attention

    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda dtype, *shape: torch.randn(*shape, generator=g, device=dev).to(dtype)
    bf16, f32 = torch.bfloat16, torch.float32
    max_err = 0.0
    shapes = []
    failed = []

    def compare(name, q, k, v, causal, window=None):
        nonlocal max_err
        got = attention(q, k, v, causal=causal, window=window, backend="cuda")
        want = attention(q, k, v, causal=causal, window=window, backend="torch")
        rows = _row_error(got, want)
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_ROW_RTOL[str(q.dtype).removeprefix("torch.")]
        log(f"  {name} [{attention_path(q, k)}]: max row relative L2 "
            f"{rows.max().item():.4g} (limit {tol:.4g}), max |diff| {err:.3g}")
        if got.dtype != want.dtype or not bool(torch.isfinite(got).all()) or not (
                rows.max().item() <= tol):
            failed.append(name)
        max_err = max(max_err, err)
        return want

    def control(name, q, k, v, causal, window, want):
        """Planted faults the check must reject: the kernel with the newest
        key left out of every row (keys cut by one, the window narrowed by
        one: end alignment keeps each row's older keys), and the kernel's
        output scaled by ATTN_FAULT_SCALE."""
        tol = ATTN_ROW_RTOL[str(q.dtype).removeprefix("torch.")]
        faults = {
            "newest key dropped": attention(
                q, k[:, :, :-1], v[:, :, :-1], causal=causal,
                window=None if window is None else window - 1, backend="cuda"),
            f"output x {ATTN_FAULT_SCALE}": ATTN_FAULT_SCALE * attention(
                q, k, v, causal=causal, window=window, backend="cuda"),
        }
        for fault, got in faults.items():
            rows = _row_error(got, want)
            log(f"  control {name}, {fault}: max row relative L2 "
                f"{rows.max().item():.4g}, {(rows > tol).float().mean().item():.3%} "
                f"of rows over the limit")
            if not rows.max().item() > tol:
                failed.append(f"control {name}, {fault}: not rejected")

    def timed(case, q, k, v, causal, window=None, forced=None):
        """Time the kernel on the path the rule picks (and, with ``forced``,
        on that other path too), the plain version and the library call."""
        b, hq, lq, d = q.shape
        if window is None:
            library = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal and lq > 1, enable_gqa=True)
        else:  # no window argument: a boolean mask of the band
            pos = torch.arange(lq, device=dev)[:, None] + (k.shape[2] - lq)
            kpos = torch.arange(k.shape[2], device=dev)[None, :]
            band = (kpos <= pos) & (pos - kpos < window)
            library = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True)
        bound, by = _attention_bound(q, k, v, causal, window)
        kern = lambda: attention(q, k, v, causal=causal, window=window, backend="cuda")
        rec = {
            "case": case, "path": attention_path(q, k), "ms": time_ms(kern),
            "plain_ms": time_ms(lambda: attention(q, k, v, causal=causal,
                                                  window=window, backend="torch")),
            "library_ms": time_ms(library), "bound_ms": bound, "bound_by": by,
            "device_ms": device_time_ms(kern),
            "library_device_ms": device_time_ms(library),
        }
        if forced is not None:
            other = lambda: flash_attention_cuda(q, k, v, causal=causal,
                                                 window=window, path=forced)
            rec[f"{forced}_path_ms"] = time_ms(other)
            rec[f"{forced}_path_device_ms"] = device_time_ms(other)
        shapes.append(rec)

    # (p) granite prefill: 4 x 2,048 tokens, 32 query heads on 8 kv heads
    q, k, v = rnd(bf16, 4, 32, 2048, 128), rnd(bf16, 4, 8, 2048, 128), rnd(bf16, 4, 8, 2048, 128)
    want = compare("(p) granite prefill, B 4, 32/8 heads, L 2048, D 128, causal",
                   q, k, v, True)
    control("(p)", q, k, v, True, None, want)
    timed("p: bf16 q (4, 32, 2048, 128), k/v (4, 8, 2048, 128), causal", q, k, v, True)

    # (d) granite decode: one query per request against the written cut of a
    # 2,080-slot cache (2,048 prompt slots + 32 steps), at the first step,
    # the 31st (a strided view) and the last
    cache = rnd(bf16, 2, 4, 8, 2080, 128)
    q1 = rnd(bf16, 4, 1, 32, 128).transpose(1, 2)  # the model's layout
    for n in (2049, 2079, 2080):
        want = compare(f"(d) granite decode, lq 1, lkv {n} of 2,080 slots",
                       q1, cache[0][:, :, :n], cache[1][:, :, :n], True)
        control(f"(d) lkv {n}", q1, cache[0][:, :, :n], cache[1][:, :, :n], True,
                None, want)
    timed("d: bf16 q (4, 32, 1, 128), k/v views (4, 8, 2079, 128) of a 2,080-slot "
          "cache", q1, cache[0][:, :, :2079], cache[1][:, :, :2079], True,
          forced="prefill")

    # the dispatch boundary: a chunk of 4 queries (4 x 4 = 16 packed rows,
    # decode) and of 5 (20 rows, prefill) against the same cache cut, each
    # row within the limit; at 4 the prefill path is timed beside decode
    for lq in (4, 5):
        qc = rnd(bf16, 4, lq, 32, 128).transpose(1, 2)
        compare(f"(c{lq}) chunk of {lq} queries, lkv 2,079 of 2,080 slots", qc,
                cache[0][:, :, :2079], cache[1][:, :, :2079], True)
        timed(f"c{lq}: bf16 q (4, 32, {lq}, 128), k/v views (4, 8, 2079, 128) of a "
              "2,080-slot cache", qc, cache[0][:, :, :2079], cache[1][:, :, :2079],
              True, forced="prefill" if lq == 4 else None)
    del cache

    # (d32k) granite's decode_32k cache length: one query per request against
    # 32,767 of 32,768 slots (537 MB of K and V)
    cache = rnd(bf16, 2, 4, 8, 32768, 128)
    k32, v32 = cache[0][:, :, :32767], cache[1][:, :, :32767]
    want = compare("(d32k) granite decode, lq 1, lkv 32,767 of 32,768 slots",
                   q1, k32, v32, True)
    control("(d32k)", q1, k32, v32, True, None, want)
    timed("d32k: bf16 q (4, 32, 1, 128), k/v views (4, 8, 32767, 128) of a "
          "32,768-slot cache", q1, k32, v32, True, forced="prefill")
    del cache, k32, v32, want

    # (m) minicpm prefill: 36 heads MHA, head size 64
    q, k, v = (rnd(bf16, 4, 36, 2048, 64) for _ in range(3))
    compare("(m) minicpm prefill, B 4, 36 heads MHA, L 2048, D 64, causal", q, k, v, True)
    timed("m: bf16 q/k/v (4, 36, 2048, 64), causal", q, k, v, True)
    del q, k, v

    # (w) mixtral's 4,096 sliding window over 8,192 tokens
    q, k, v = rnd(bf16, 1, 32, 8192, 128), rnd(bf16, 1, 8, 8192, 128), rnd(bf16, 1, 8, 8192, 128)
    want = compare("(w) window 4096, B 1, 32/8 heads, L 8192, D 128, causal",
                   q, k, v, True, 4096)
    control("(w)", q, k, v, True, 4096, want)
    del want
    timed("w: bf16 q (1, 32, 8192, 128), k/v (1, 8, 8192, 128), causal, window 4096",
          q, k, v, True, 4096)
    del q, k, v

    # (a7) arctic-480b prefill (phase 13): 2 x 2,048 tokens, 56 query heads
    # on 8 kv heads, a GQA group of 7
    q, k, v = rnd(bf16, 2, 56, 2048, 128), rnd(bf16, 2, 8, 2048, 128), rnd(bf16, 2, 8, 2048, 128)
    want = compare("(a7) arctic prefill, B 2, 56/8 heads (group 7), L 2048, D 128, "
                   "causal", q, k, v, True)
    control("(a7)", q, k, v, True, None, want)
    timed("a7: bf16 q (2, 56, 2048, 128), k/v (2, 8, 2048, 128), causal", q, k, v, True)
    del q, k, v, want
    # (a7-d) arctic decode: the group's 7 heads packed in one decode tile
    # against a cut of a 2,080-slot cache; a chunk of 2 queries, 14 rows
    cache = rnd(bf16, 2, 2, 8, 2080, 128)
    kc, vc = cache[0][:, :, :2070], cache[1][:, :, :2070]
    q1 = rnd(bf16, 2, 1, 56, 128).transpose(1, 2)
    want = compare("(a7-d) arctic decode, lq 1, group 7, lkv 2,070 of 2,080 slots",
                   q1, kc, vc, True)
    control("(a7-d)", q1, kc, vc, True, None, want)
    timed("a7-d: bf16 q (2, 56, 1, 128), k/v views (2, 8, 2070, 128) of a 2,080-slot "
          "cache", q1, kc, vc, True, forced="prefill")
    compare("(a7-c2) arctic, a chunk of 2 queries (14 packed rows), lkv 2,070",
            rnd(bf16, 2, 2, 56, 128).transpose(1, 2), kc, vc, True)
    del cache, kc, vc, want
    # (w-d) mixtral decode past its window (phase 13): one query against
    # 6,145 and 6,176 of 6,176 slots, window 4,096: the decode path cuts the
    # band (pos - 4096, pos] of the cache
    cache = rnd(bf16, 2, 2, 8, 6176, 128)
    q1 = rnd(bf16, 2, 1, 32, 128).transpose(1, 2)
    for n in (6145, 6176):
        want = compare(f"(w-d) mixtral decode, window 4096, lkv {n} of 6,176 slots",
                       q1, cache[0][:, :, :n], cache[1][:, :, :n], True, 4096)
        control(f"(w-d) lkv {n}", q1, cache[0][:, :, :n], cache[1][:, :, :n], True,
                4096, want)
    timed("w-d: bf16 q (2, 32, 1, 128), k/v views (2, 8, 6175, 128) of a 6,176-slot "
          "cache, window 4096", q1, cache[0][:, :, :6175], cache[1][:, :, :6175], True,
          4096, forced="prefill")
    del cache, want
    torch.cuda.empty_cache()

    # edge cases, float32 (the CUDA-core kernel) and bfloat16 (the prefill
    # and decode paths): chunked prefill lq < lkv, lengths off and on the
    # tiles, a non-causal pass, decode (lkv 1, below one chunk, a window far
    # narrower than the cache, 16 packed rows), lq > lkv (leading rows see
    # no key: 0)
    edges = [
        ("lq 100 < lkv 300", (2, 8, 2, 100, 300, 128), True, None),
        ("L 200 (off the tiles)", (1, 4, 4, 200, 200, 64), True, None),
        ("L 64 and 128 (whole tiles)", (1, 4, 2, 64, 128, 128), True, None),
        ("L 128, non-causal", (2, 4, 2, 128, 128, 128), False, None),
        ("L 257, non-causal, window 100", (1, 4, 1, 257, 257, 64), False, 100),
        ("decode, lkv 77", (3, 8, 2, 1, 77, 128), True, None),
        ("lq 70 > lkv 40", (1, 2, 2, 70, 40, 64), True, None),
        ("D 32, window 1", (1, 2, 2, 96, 96, 32), True, 1),
        ("decode, lkv 1", (2, 8, 2, 1, 1, 128), True, None),
        ("decode, lkv 40", (2, 8, 1, 1, 40, 64), True, None),
        ("decode, lq 3, window 5 over lkv 2079", (1, 4, 1, 3, 2079, 128), True, 5),
        ("16 rows of group 8, D 32", (1, 16, 2, 2, 500, 32), True, None),
        ("decode tile, lq 6 > lkv 4", (1, 2, 2, 6, 4, 64), True, None),
    ]
    for dtype in (f32, bf16):
        for name, (b, hq, hkv, lq, lkv, d), causal, window in edges:
            compare(f"({'f32' if dtype == f32 else 'bf16'}) {name}",
                    rnd(dtype, b, hq, lq, d), rnd(dtype, b, hkv, lkv, d),
                    rnd(dtype, b, hkv, lkv, d), causal, window)
    if failed:
        raise AssertionError("attention: " + "; ".join(failed))
    return max_err, shapes


# GNN regimes of configs/common_gnn.py: (edges, real edges, features,
# segments = node capacity, real nodes)
GNN_REGIMES = {
    "molecule": (8192, 8192, 64, 4096, 3840),
    "full_graph_sm": (10752, 10556, 1433, 2816, 2708),
    "minibatch_lg": (168960, 168960, 602, 170496, 169984),
    "ogb_products": (61865984, 61859140, 100, 2449920, 2449029),
}
# the regimes a GNN aggregation runs through the entry point (the others
# are held to the plain version and timed: the kernel's partitioned launch)
AGGREGATION_REGIMES = ("molecule", "full_graph_sm")
# regimes whose random-float check (float64 copies of the messages) would
# not fit the card beside them
INTEGER_ONLY = ("ogb_products",)


def _gnn_inputs(g, dev, regime, features=True):
    """Random receivers (seeded) over the real nodes, the padding edges
    pointing at the capacity (dropped), and random senders' features
    (None without ``features``)."""
    import torch

    n, real, d, segs, nodes = GNN_REGIMES[regime]
    recv = torch.randint(0, nodes, (n,), generator=g, device=dev, dtype=torch.int32)
    recv[real:] = segs
    if not features:
        return None, None, recv, segs
    feats = torch.randn(nodes, d, generator=g, device=dev)
    send = torch.randint(0, nodes, (n,), generator=g, device=dev)
    return feats, send, recv, segs


def _within_order_bound(name, got, want, x, recv, segs):
    """|kernel - plain| of a segment sum of the rows ``x`` (ids >= 0) within
    the reordering tolerance: a sum of k terms in any order is within (k-1)
    2^-24 sum|x| of any other order, so |kernel - plain| <= 2 k_max 2^-24
    sum|x| a segment (ROADMAP queue 3 item 4), in float64.  Returns (the
    largest |diff|, k_max)."""
    import torch

    spill = torch.where(recv < segs, recv, segs).long()
    k_max = torch.bincount(spill, minlength=segs + 1)[:segs].max().item()
    abs_sum = torch.zeros(segs + 1, x.shape[1], dtype=torch.float64, device=x.device
                          ).index_add_(0, spill, x.detach().abs().double())[:segs]
    err = (got.double() - want.double()).abs()
    if not bool((err <= 2 * k_max * 2.0 ** -24 * abs_sum).all()):
        raise AssertionError(f"{name}: max |diff| {err.max().item()} beyond the "
                             "order bound")
    return err.max().item(), k_max


def check_segment_sum(dev):
    """Phase 6: the segment-sum kernel against its plain version at the GNN
    regimes.  Returns (max_abs_err, timed shape records)."""
    import torch
    from repro_torch.kernels.ops import segment_reduce
    from repro_torch.kernels.segment_matmul import plan_segment_sum

    g = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err = 0.0
    shapes = []
    one = torch.zeros(1, device=dev)
    launch_ms = device_time_ms(lambda: one.add_(1))  # a launch's own cost
    for regime in GNN_REGIMES:
        n, real, d, segs, _ = GNN_REGIMES[regime]
        plan = plan_segment_sum(n, d, segs, sms)
        way = "partitioned" if plan.parts else "direct"
        # integer-valued messages: float sums exact in any order
        ints = torch.randint(-8, 9, (n, d), generator=g, device=dev,
                             dtype=torch.float32)
        _, _, recv, _ = _gnn_inputs(g, dev, regime, features=False)
        same(f"({regime}) {n} x {d} integer-valued -> {segs} segments, {way}",
             segment_reduce(ints, recv, segs, backend="cuda"),
             segment_reduce(ints, recv, segs, backend="torch"))
        msgs = ints
        if regime not in INTEGER_ONLY:
            del ints
            # random messages, gathered as a GNN layer gathers them, within
            # the order bound
            feats, send, recv, segs = _gnn_inputs(g, dev, regime)
            msgs = feats[send]
            err, k_max = _within_order_bound(
                f"({regime}) random floats",
                segment_reduce(msgs, recv, segs, backend="cuda"),
                segment_reduce(msgs, recv, segs, backend="torch"), msgs, recv, segs)
            max_err = max(max_err, err)
            log(f"  ({regime}) random float messages: max |diff| "
                f"{err:.3g} (tolerance 2 * {k_max} * 2^-24 * sum|x|)")
        kern = lambda: segment_reduce(msgs, recv, segs, backend="cuda")
        plain = lambda: segment_reduce(msgs, recv, segs, backend="torch")
        kind = "random" if regime not in INTEGER_ONLY else "integer-valued"
        shapes.append({
            "case": f"{regime}: x float32 ({n}, {d}) {kind}, seg int32, {segs} "
                    f"segments, {way}",
            **timings(kern, plain, lambda: torch.zeros(segs + 1, d, device=dev)
                      .index_add_(0, torch.where(recv < segs, recv, segs).long(),
                                  msgs)[:segs]),
            "one_element_add_device_ms": launch_ms,
            # the real edges' rows (the padding's are dropped), every id
            "bound_ms": (4 * real * d + 4 * n + 4 * segs * d) / HBM_BYTES_PER_S * 1e3,
        })
        del msgs, recv
        torch.cuda.empty_cache()
    # a hub: half of molecule's rows on one node, which the kernel sums in
    # equal runs of rows across a block's warps
    n, real, d, segs, nodes = GNN_REGIMES["molecule"]
    _, _, recv, _ = _gnn_inputs(g, dev, "molecule", features=False)
    recv[::2] = nodes // 2
    ints = torch.randint(-8, 9, (n, d), generator=g, device=dev, dtype=torch.float32)
    kern = lambda: segment_reduce(ints, recv, segs, backend="cuda")
    plain = lambda: segment_reduce(ints, recv, segs, backend="torch")
    same(f"(molecule, hub) {n // 2} of {n} rows on one node", kern(), plain())
    shapes.append({
        "case": f"molecule with a hub: x float32 ({n}, {d}) integer-valued, "
                f"{n // 2} rows on one of {segs} segments",
        **timings(kern, plain, lambda: torch.zeros(segs + 1, d, device=dev)
                  .index_add_(0, torch.where(recv < segs, recv, segs).long(),
                              ints)[:segs]),
        "bound_ms": (4 * n * d + 4 * n + 4 * segs * d) / HBM_BYTES_PER_S * 1e3,
    })
    return max_err, shapes


def segment_reduce_path(dev) -> dict:
    """Phase 6: ``ops.segment_reduce`` as a GNN layer's aggregation calls
    it, ``backend="auto"``, once per regime: the entry point's own run.
    Returns its launches."""
    import torch
    from repro_torch.kernels.ops import segment_reduce

    g = torch.Generator(device=dev).manual_seed(5)
    inputs = {r: _gnn_inputs(g, dev, r) for r in AGGREGATION_REGIMES}
    torch.cuda.synchronize()
    reset_launches()
    out = {r: segment_reduce(feats[send], recv, segs)
           for r, (feats, send, recv, segs) in inputs.items()}
    torch.cuda.synchronize()
    launches = read_launches()
    for r, agg in out.items():
        segs, d = GNN_REGIMES[r][3], GNN_REGIMES[r][2]
        if agg.shape != (segs, d) or not bool(torch.isfinite(agg).all()):
            raise AssertionError(f"segment_reduce ({r}): bad aggregate")
        if bool(agg[GNN_REGIMES[r][4]:].any()):
            raise AssertionError(f"segment_reduce ({r}): padding nodes received")
    if launches != {**{k: 0 for k in launches},
                    "segment_matmul": len(AGGREGATION_REGIMES)}:
        raise AssertionError(f"segment_reduce: launches {launches}")
    log(f"[segment_reduce] one GNN aggregation per regime: launches {launches}")
    return launches


def _sync_sites(caught) -> dict:
    """Host syncs among recorded warnings, by source line."""
    syncs = {}
    for w in caught:
        if SYNC_WARNING in str(w.message):
            site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            syncs[site] = syncs.get(site, 0) + 1
    return syncs


def _greedy_run(model, tokens, cache, forced=None, syncs=None):
    """Prefill then SERVE_STEPS greedy decode steps; ``forced`` replaces the
    model's own tokens.  With ``syncs`` (a dict), the decode steps run
    under ``set_sync_debug_mode("warn")`` and their host syncs are counted
    into it by source line.  Returns (logits per call, tokens fed, prefill
    s, decode s), synchronized."""
    import warnings

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, fed = [logits.float()], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if syncs is not None:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(SERVE_STEPS):
                nxt = logits.argmax(-1) if forced is None else forced[i]
                fed.append(nxt)
                logits, cache = model.decode_step(nxt, cache)
                out.append(logits.float())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if syncs is not None:
        syncs.update(_sync_sites(caught))
    return torch.stack(out), torch.stack(fed), t1 - t0, time.perf_counter() - t1


@contextlib.contextmanager
def _newest_key_dropped():
    """Phase 7's planted fault: every decode step's attention leaves out the
    newest key, the one the step has just written into the cache."""
    from repro_torch.models import transformer

    attention = transformer.attention

    def faulty(q, k, v, **kw):
        if q.shape[2] == 1:
            k, v = k[:, :, :-1], v[:, :, :-1]
        return attention(q, k, v, **kw)

    transformer.attention = faulty
    try:
        yield
    finally:
        transformer.attention = attention


def serve_granite(dev):
    """Phase 7: granite-8b at full size through the attention kernel, then
    through the plain attention on the same weights and tokens.  Returns
    (the counted run's launches, summary)."""
    import dataclasses

    import torch
    from repro_torch.configs import granite_8b
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(granite_8b.full_config(), kernel_backend="cuda")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev, seed=SEED)
    plain_model = Transformer(dataclasses.replace(cfg, kernel_backend="torch"),
                              weights=dict(model.named_parameters()))
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_params:,} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                           device=dev)
    slots = SERVE_PROMPT + SERVE_STEPS
    cache = model.init_kv_cache(SERVE_BATCH, slots)
    _greedy_run(model, tokens, cache)  # warm-up: cuBLAS picks its kernels
    cache = model.init_kv_cache(SERVE_BATCH, slots)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    logits, fed, prefill_s, decode_s = _greedy_run(model, tokens, cache)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {**{k: 0 for k in launches},
            "flash_attention": cfg.n_layers * (1 + SERVE_STEPS)}
    if launches != want:
        raise AssertionError(f"serving: launches {launches}, the code implies {want}")
    del cache
    plain, _, plain_prefill_s, plain_decode_s = _greedy_run(
        plain_model, tokens, plain_model.init_kv_cache(SERVE_BATCH, slots), fed)
    if not bool(torch.isfinite(logits).all()) or logits.shape != (
            1 + SERVE_STEPS, SERVE_BATCH, cfg.vocab):
        raise AssertionError(f"serving: logits {tuple(logits.shape)} not finite")
    # the control: the kernel path with the planted fault, the same tokens
    with _newest_key_dropped():
        faulty, _, _, _ = _greedy_run(
            model, tokens, model.init_kv_cache(SERVE_BATCH, slots), fed)
    rel = ((logits - plain).norm(dim=-1) / plain.norm(dim=-1))  # (call, request)
    ctrl = ((faulty - plain).norm(dim=-1) / plain.norm(dim=-1)).amax(dim=1)
    gap = (logits - plain).abs().amax(dim=-1)
    top2 = plain.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * gap
    agree = logits.argmax(-1) == plain.argmax(-1)
    summary = {
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
        "decode_ms_per_step": decode_s / SERVE_STEPS * 1e3,
        "decode_tokens_per_s": SERVE_BATCH * SERVE_STEPS / decode_s,
        "plain_prefill_s": plain_prefill_s,
        "plain_decode_ms_per_step": plain_decode_s / SERVE_STEPS * 1e3,
        "max_memory_allocated_bytes": peak,
        "kv_cache_bytes": 2 * cfg.n_layers * SERVE_BATCH * cfg.n_kv_heads * slots
        * cfg.head_dim * 2,
        "logits_rel_l2_max": rel.max().item(),
        "logits_rel_l2_prefill": rel[0].max().item(),
        "logits_rel_l2_by_step": [round(x, 6) for x in rel.amax(dim=1).tolist()],
        "control_rel_l2_by_step": [round(x, 6) for x in ctrl.tolist()],
        "greedy_decided": int(decided.sum()), "greedy_agree": int(agree.sum()),
        "greedy_total": int(agree.numel()),
        "launches": launches,
    }
    log("[serve] " + json.dumps(summary))
    if rel.max().item() > SERVE_TOL:
        raise AssertionError(f"serving: logits relative L2 error "
                             f"{rel.max().item()} above {SERVE_TOL}")
    if not ctrl[1:].min().item() > SERVE_TOL:
        raise AssertionError(f"serving: the control (newest key dropped) is within "
                             f"{SERVE_TOL} at a decode step")
    if not bool(agree[decided].all()):
        raise AssertionError("serving: a greedy token differs where the plain "
                             "logits' margin exceeds twice the gap")
    return launches, summary


# LM training (phase 11): minicpm-2b at its published size, 4 x 2,048 tokens
# a step, the reference launcher's AdamW (lr 3e-4, 20 warmup steps, WSD over
# 100 steps)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PLAIN_STEPS = 4, 2048, 8, 3
TRAIN_OPT = dict(lr=3e-4, warmup_steps=20, total_steps=100, schedule="wsd")
TRAIN_RESUME_LAYERS, TRAIN_CKPT_EVERY, TRAIN_CRASH_AT = 2, 4, 6
# |loss - the plain path's loss| at each of the first TRAIN_PLAIN_STEPS steps
# from the same weights and batches.  The kernel rounds P to bf16 before P V
# where the plain version keeps float32, and the steps after the first start
# from weights that differ by those rounding errors' updates: on an H100,
# 5.1e-4, 9.2e-5 and 7.8e-4 at losses about 10-12.  A control, each query's
# own key left out of its attention through the kernel, gives 3.7e-3, 0.033
# and 0.040 (PERF.md, section 6); the limit lies between the two, and
# the control must exceed it at every step.
TRAIN_LOSS_TOL = 2e-3


def _bits(x):
    """A tensor as its bits, for bit-equality of bfloat16 (NaN, -0.0)."""
    import torch

    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def check_attention_training(dev) -> dict:
    """Phase 11 (a): the attention ``autograd.Function`` (kernel forward,
    the plain version's autograd backward) against plain autograd at
    minicpm-2b's training shape and granite-8b's GQA: each output row within
    ATTN_ROW_RTOL, dq, dk, dv bit-equal for the same upstream gradient (the
    same plain backward on the same inputs); the backward timed by events
    and on the device alone beside plain autograd's and SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.kernels.ref import ref_attention

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    out = {}
    for case, (hq, hkv, d) in (("minicpm", (36, 36, 64)), ("granite", (32, 8, 128))):
        shape = lambda h: (TRAIN_BATCH, h, TRAIN_SEQ, d)  # noqa: E731
        q, k, v = (torch.randn(shape(h), generator=g, device=dev,
                               dtype=torch.bfloat16).requires_grad_()
                   for h in (hq, hkv, hkv))
        up = torch.randn(shape(hq), generator=g, device=dev, dtype=torch.bfloat16)
        fn = FlashAttention.apply(q, k, v, True, None, None)
        plain = ref_attention(q, k, v)
        err = _row_error(fn, plain).max().item()
        got = torch.autograd.grad(fn, (q, k, v), up, retain_graph=True)
        want = torch.autograd.grad(plain, (q, k, v), up, retain_graph=True)
        equal = [torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want)]
        sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=hq != hkv)
        backward = lambda o: lambda: torch.autograd.grad(  # noqa: E731
            o, (q, k, v), up, retain_graph=True)
        flops = 8 * TRAIN_BATCH * hq * d * _visible_keys(TRAIN_SEQ, TRAIN_SEQ,
                                                         True, None)
        nbytes = (3 * q.numel() + 3 * k.numel() + 3 * v.numel()) * 2
        rec = {"row_rel_l2_max": err, "grads_bit_equal": equal,
               "bwd_ms": time_ms(backward(fn)),
               "bwd_device_ms": device_time_ms(backward(fn)),
               "plain_bwd_ms": time_ms(backward(plain)),
               "sdpa_bwd_ms": time_ms(backward(sdpa)),
               "sdpa_bwd_device_ms": device_time_ms(backward(sdpa)),
               "bwd_bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
               "bwd_bound_by": ("operations" if flops / BF16_FLOPS
                                > nbytes / HBM_BYTES_PER_S else "bytes")}
        out[case] = rec
        log(f"[train (a)] {case} B {TRAIN_BATCH} Hq {hq} Hkv {hkv} L {TRAIN_SEQ} "
            f"D {d}: " + json.dumps(rec))
        if not err <= ATTN_ROW_RTOL["bfloat16"]:
            raise AssertionError(f"train (a) {case}: forward row error {err}")
        if not all(equal):
            raise AssertionError(f"train (a) {case}: dq, dk, dv bit-equal {equal}")
        del q, k, v, up, fn, plain, sdpa, got, want
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _own_key_dropped():
    """Phase 11's planted fault: every query's attention leaves out its own
    key (the kv range cut by its newest key, ends aligned), kernel path."""
    from repro_torch.models import transformer

    attention = transformer.attention

    def faulty(q, k, v, **kw):
        return attention(q, k[:, :, :-1], v[:, :, :-1], **kw)

    transformer.attention = faulty
    try:
        yield
    finally:
        transformer.attention = attention


def _trainer(cfg, dev, seed, **kw):
    """minicpm-2b's model drawn on the card from ``seed``, a ``Trainer``
    over ``loss_fn`` with the reference launcher's AdamW, its initial state,
    and the list its losses go to (device tensors, read after a run)."""
    from repro_torch.convert import transformer_param_tree
    from repro_torch.models.transformer import Transformer, loss_fn
    from repro_torch.train import AdamWConfig, Trainer

    model = Transformer(cfg, device=dev, seed=seed)
    losses = []

    def loss(params, batch):
        out = loss_fn(model, batch["tokens"], batch["labels"])
        losses.append(out[0].detach())
        return out

    trainer = Trainer(loss, AdamWConfig(**TRAIN_OPT), **kw)
    return trainer, trainer.init_state(transformer_param_tree(model)), losses


def _train_run(trainer, state, vocab, n_steps, start=0, sync_steps=()):
    """``Trainer.run`` to step ``n_steps`` on ``Prefetcher(lm_batches(...,
    start_step=start))``, logging the first and last steps; an event
    recorded at each step's start, ``set_sync_debug_mode("warn")`` through
    the steps in ``sync_steps`` (counted from the run's first).  Returns
    (each step's device-timeline wall in ms, the wall of the whole run in
    s, host syncs by source line)."""
    import warnings

    import torch
    from repro_torch.data.pipeline import Prefetcher, lm_batches

    events = []

    def feed(batches):
        for i, batch in enumerate(batches):
            torch.cuda.set_sync_debug_mode("warn" if i in sync_steps else "default")
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            yield batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, Prefetcher(lm_batches(
            TRAIN_BATCH, TRAIN_SEQ, vocab, seed=0, start_step=start)) as batches:
        warnings.simplefilter("always")
        try:
            trainer.run(state, feed(batches), n_steps, log_every=n_steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = _sync_sites(caught)
    walls = [a.elapsed_time(b) for a, b in zip(events, events[1:] + [end])]
    return walls, wall, syncs


def _step_flops(cfg, n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ) -> float:
    """6 N D for ``n_params`` parameters (a MoE model's active ones), plus
    attention's products: QK^T and PV over the keys a causal query sees,
    forward and twice that backward."""
    attn = 3 * 4 * batch * cfg.n_heads * cfg.head_dim * _visible_keys(
        seq, seq, True, cfg.sliding_window) * cfg.n_layers
    return 6 * n_params * batch * seq + attn


def train_minicpm(dev, workdir: str):
    """Phase 11: LM training on the card.  (a) the attention Function
    against plain autograd; (b) minicpm-2b at full size, TRAIN_STEPS steps
    through ``Trainer.run`` with the attention kernel, then
    TRAIN_PLAIN_STEPS from the same weights and batches through the plain
    attention (each loss within TRAIN_LOSS_TOL) and as many with a planted
    fault (beyond it at every step); (c) the depth cut to
    TRAIN_RESUME_LAYERS: a checkpoint every TRAIN_CKPT_EVERY steps, the
    trainer dropped at TRAIN_CRASH_AT, a new one resumed and run to
    TRAIN_STEPS, every restored leaf bit-equal to the saved one and its
    losses within TRAIN_LOSS_TOL of an uninterrupted run's; (d) the CLI
    twice on one checkpoint directory.  Returns (launches by run, summary)."""
    import dataclasses

    import torch
    from repro_torch.configs import minicpm_2b

    summary = {"attention_function": check_attention_training(dev)}
    cfg = dataclasses.replace(minicpm_2b.full_config(), kernel_backend="cuda")
    launches = {}

    # (b) the kernel run: host syncs counted in the steps that do not log
    trainer, state, losses = _trainer(cfg, dev, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    walls, wall, syncs = _train_run(trainer, state, cfg.vocab, TRAIN_STEPS,
                                    sync_steps=range(1, TRAIN_STEPS - 1))
    launches["train"] = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    kernel = [x.item() for x in losses]
    del trainer, state, losses
    torch.cuda.empty_cache()
    step_ms = sorted(walls[1:])[len(walls[1:]) // 2]
    flops = _step_flops(cfg, cfg.n_params)
    b = {"n_params": cfg.n_params, "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
         "first_step_ms": walls[0], "step_ms_median_2_to_8": step_ms,
         "step_ms": walls, "run_s": wall,
         "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
         "flops_per_step": flops, "mfu": flops / (step_ms * 1e-3) / BF16_FLOPS,
         "max_memory_allocated_bytes": peak,
         "attention_launches_per_step": launches["train"]["flash_attention"]
         / TRAIN_STEPS,
         "host_syncs_in_non_log_steps": syncs, "losses": kernel}
    log("[train (b)] " + json.dumps(b))
    summary["minicpm_2b"] = b
    want = {**{k: 0 for k in launches["train"]},
            "flash_attention": 2 * cfg.n_layers * TRAIN_STEPS}  # remat: twice
    if launches["train"] != want:
        raise AssertionError(f"train: launches {launches['train']}, the code "
                             f"implies {want}")
    if not all(math.isfinite(x) for x in kernel):
        raise AssertionError(f"train: losses {kernel}")

    # (b) the same weights and batches through the plain attention, then the
    # kernel path with a planted fault
    runs = {}
    for name, run_cfg, fault in (
            ("plain", dataclasses.replace(cfg, kernel_backend="torch"), None),
            ("control", cfg, _own_key_dropped)):
        trainer, state, losses = _trainer(run_cfg, dev, SEED)
        with fault() if fault else contextlib.nullcontext():
            _train_run(trainer, state, cfg.vocab, TRAIN_PLAIN_STEPS)
        runs[name] = [x.item() for x in losses]
        del trainer, state, losses
        torch.cuda.empty_cache()
    sound = [abs(a - p) for a, p in zip(kernel, runs["plain"])]
    control = [abs(a - p) for a, p in zip(runs["control"], runs["plain"])]
    summary["loss_vs_plain"] = {"plain_losses": runs["plain"], "kernel_minus_plain":
                                sound, "control_minus_plain": control,
                                "limit": TRAIN_LOSS_TOL}
    log("[train (b)] " + json.dumps(summary["loss_vs_plain"]))
    if max(sound) > TRAIN_LOSS_TOL:
        raise AssertionError(f"train: kernel losses {sound} from the plain path's, "
                             f"above {TRAIN_LOSS_TOL}")
    if not min(control) > TRAIN_LOSS_TOL:
        raise AssertionError(f"train: the control (own key dropped) is within "
                             f"{TRAIN_LOSS_TOL} of the plain path: {control}")

    summary["resume"], launches["train_resume"] = _train_resume(
        dev, dataclasses.replace(cfg, n_layers=TRAIN_RESUME_LAYERS), workdir)
    summary["cli"], launches["train_cli"] = _train_cli(workdir)
    return launches, summary


def _train_resume(dev, cfg, workdir: str):
    """Phase 11 (c): checkpoint, crash and resume at full width and cut
    depth.  Returns (summary, launches)."""
    import torch
    from repro_torch.train import tree_flatten

    reset_launches()
    trainer, state, losses = _trainer(cfg, dev, SEED)
    _train_run(trainer, state, cfg.vocab, TRAIN_STEPS)
    straight = [x.item() for x in losses]
    del trainer, state, losses
    torch.cuda.empty_cache()

    ckpt = os.path.join(workdir, "train_ckpt")
    saved, restored, walls = {}, {}, {"commit_s": [], "restore_s": []}

    def timed(method, key, after):
        def run(state, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = method(state, *args)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
            after(out, state, *args)
            return out
        return run

    def keep(_, state, step):  # the leaves of each committed step, on the host
        saved[step] = [_bits(x.detach().to("cpu", copy=True))
                       for x in tree_flatten(state.tree())[0]]

    def check(out, _):  # the restored leaves against the saved ones
        state, step = out
        restored["step"] = step
        restored["equal"] = step in saved and all(
            torch.equal(_bits(x.detach()).cpu(), want) for x, want in
            zip(tree_flatten(state.tree())[0], saved[step]))

    trainer, state, _ = _trainer(cfg, dev, SEED, ckpt_dir=ckpt,
                                 ckpt_every=TRAIN_CKPT_EVERY)
    trainer.checkpoint = timed(trainer.checkpoint, "commit_s", keep)
    _train_run(trainer, state, cfg.vocab, TRAIN_CRASH_AT)
    del trainer, state  # the crash: nothing of the first life is kept
    torch.cuda.empty_cache()

    trainer, state, losses = _trainer(cfg, dev, SEED + 1, ckpt_dir=ckpt,
                                      ckpt_every=TRAIN_CKPT_EVERY)
    trainer.maybe_resume = timed(trainer.maybe_resume, "restore_s", check)
    trainer.checkpoint = timed(trainer.checkpoint, "commit_s",
                               lambda *_: None)
    start = TRAIN_CKPT_EVERY * (TRAIN_CRASH_AT // TRAIN_CKPT_EVERY)
    _train_run(trainer, state, cfg.vocab, TRAIN_STEPS, start=start)
    resumed = [x.item() for x in losses]
    launches = read_launches()
    del trainer, state, losses
    torch.cuda.empty_cache()
    leaf_bytes = sum(x.numel() * x.element_size() for x in saved[start])
    out = {"n_layers": cfg.n_layers, "leaf_bytes": leaf_bytes,
           "restored_step": restored.get("step"),
           "leaves_bit_equal": restored.get("equal"), **walls,
           "straight_losses": straight, "resumed_losses": resumed,
           "resumed_minus_straight": [abs(a - b) for a, b in
                                      zip(resumed, straight[start:])]}
    log("[train (c)] " + json.dumps(out))
    if restored.get("step") != start or not restored.get("equal"):
        raise AssertionError(f"train (c): restored step {restored.get('step')}, "
                             f"leaves bit-equal {restored.get('equal')}")
    if len(resumed) != TRAIN_STEPS - start or max(
            out["resumed_minus_straight"]) > TRAIN_LOSS_TOL:
        raise AssertionError(f"train (c): resumed losses {resumed} against "
                             f"{straight[start:]}")
    want = {**{k: 0 for k in launches}, "flash_attention": 2 * cfg.n_layers * (
        TRAIN_STEPS + TRAIN_CRASH_AT + TRAIN_STEPS - start)}
    if launches != want:
        raise AssertionError(f"train (c): launches {launches}, the code implies "
                             f"{want}")
    return out, launches


def _train_cli(workdir: str):
    """Phase 11 (d): ``python -m repro_torch.launch.train --arch minicpm-2b
    --d-head 64 --steps 20 --ckpt-dir D`` twice, as a user calls it (heads
    of 64: the smoke config's 8 are not a size the kernel takes): the first
    run trains 20 steps through the attention kernel, the second resumes
    at step 20.  Returns (summary, the launches of both runs)."""
    from repro_torch.launch.train import main, smoke_config

    argv = ["--arch", "minicpm-2b", "--d-head", "64", "--steps", "20",
            "--ckpt-dir", os.path.join(workdir, "train_cli")]
    out, total = {}, None
    for run in ("first", "again"):
        text = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = main(argv)
        launches = read_launches()
        total = launches if total is None else {
            k: total[k] + v for k, v in launches.items()}
        lines = [l for l in text.getvalue().splitlines() if l.startswith("[train]")]
        out[run] = {"rc": rc, "s": time.perf_counter() - t0, "lines": lines,
                    "launches": launches}
        log(f"[train (d)] {run}: rc {rc} in {out[run]['s']:.1f} s, launches "
            f"{launches}\n  " + "\n  ".join(lines))
        if rc != 0:
            raise AssertionError(f"train CLI ({run}) exit {rc}")
    if not any("done: final loss" in l for l in out["first"]["lines"]) or not any(
            "resumed at step 20 of 20" in l for l in out["again"]["lines"]):
        raise AssertionError(f"train CLI: {out}")
    # the smoke config has no remat: one launch a layer a step
    want = {**{k: 0 for k in total},
            "flash_attention": 20 * smoke_config("minicpm-2b").n_layers}
    if total != want:
        raise AssertionError(f"train CLI: launches {total}, the code implies {want}")
    return out, total


# GNN training (phase 12): the four GNNs at the published widths of
# configs/{schnet,pna,egnn,graphsage_reddit}.make_cfg, the reference's AdamW
# (common_gnn.GNN_OPT), on three shapes of configs/common_gnn.GNN_SHAPES,
# then graphsage-reddit at ogb_products
GNN_CONFIGS = ("schnet", "pna", "egnn", "graphsage_reddit")
GNN_TRAIN_SHAPES = ("molecule", "full_graph_sm", "minibatch_lg")
GNN_STEPS, GNN_CHECK_STEPS, GNN_OGB_STEPS = 8, 3, 3
GNN_GRAD_CHUNK = 1 << 24  # rows a plain autograd check takes at a time
# molecule: 128 graphs of 30 nodes and 64 edges; full_graph_sm's live part
MOLECULE_NODES, MOLECULE_EDGES = 30, 64
CORA_NODES, CORA_EDGES = 2708, 10556
# minibatch_lg's base graph: reddit as GraphSAGE's loaders ship it (232,965
# nodes, 114,615,892 edges, 602 features, 41 classes), drawn from SEED: in-
# edges in CSR order (exponential degrees), uniform senders; 1,024 seeds,
# fanouts 15 and 10 (GNN_SHAPES["minibatch_lg"]["raw"])
REDDIT_NODES, REDDIT_EDGES, REDDIT_FEATS = 232_965, 114_615_892, 602
MINIBATCH_SEEDS, MINIBATCH_FANOUTS = 1024, (15, 10)
# The kernel path's outputs (relative L2 over the output tensor) and losses
# (relative) at each of the first GNN_CHECK_STEPS steps against the plain
# path's, from the same weights and graph.  The kernels sum each segment in
# another order than index_add_ (float32, within 2 k 2^-24 sum|x| a sum of
# k terms, about 1e-7 relative); PNA's std aggregator amplifies that (its
# backward scales the difference 2 (m - mean) by up to 158), and the
# warm-up's lr (1e-5 at the first step) moves a weight by up to 2 lr where
# rounding flips a gradient's sign.  On an H100 the two paths stay within
# 1.6e-6 (outputs) and 2.8e-6 (losses) of each other; a planted fault, each
# real edge's receiver moved to the next node, moves the outputs by 7.3e-4
# (SchNet at minibatch_lg) and the losses by 2.8e-4 (GraphSAGE at
# minibatch_lg: the cross-entropy of 41 random labels) at the least
# (PERF.md, section 6).  The limit lies between the two; the fault must
# exceed it on the outputs and on the losses at every step, but for
# GraphSAGE at molecule, whose loss is 0 at any weights (one class).
GNN_OUT_RTOL = GNN_LOSS_RTOL = 1e-4


def _segment_function_inputs(g, dev, op, regime):
    """Phase 12 (a)'s rows for ``op`` at ``regime``: receivers as phase 6
    draws them; sums: random floats, or integer-valued where the float64
    copies of the order check would not fit (ogb_products); max: values on
    a grid of 1/4 so that maxima tie, PNA's 75 features (8 at
    ogb_products, where no arch takes a max)."""
    import torch

    n, _, d, segs, _ = GNN_REGIMES[regime]
    _, _, recv, _ = _gnn_inputs(g, dev, regime, features=False)
    if op == "max":
        d = 8 if regime == "ogb_products" else 75
        x = torch.randn(n, d, generator=g, device=dev).mul_(4).round_().div_(4)
    elif regime in INTEGER_ONLY:
        x = torch.randint(-8, 9, (n, d), generator=g, device=dev, dtype=torch.float32)
    else:
        x = torch.randn(n, d, generator=g, device=dev)
    return x.requires_grad_(), recv, segs


def check_segment_functions(dev) -> dict:
    """Phase 12 (a): ``SegmentSum`` and ``SegmentMax`` (``ops.segment_reduce``
    under autograd on the card) against plain autograd at the molecule,
    minibatch_lg and ogb_products widths: sums within the order bound
    (integer-valued ones bit-equal), maxima bit-equal, the rows' gradients
    bit-equal for the same upstream gradient, planted ties included;
    forward + backward timed by events beside plain autograd and one
    library call's autograd (``index_add`` or ``scatter_reduce`` onto a
    spill row).  Returns the records by case."""
    import torch
    from repro_torch.kernels.ops import segment_reduce

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    out = {}
    for op in ("sum", "max"):
        for regime in ("molecule", "minibatch_lg", "ogb_products"):
            torch.cuda.empty_cache()
            x, recv, segs = _segment_function_inputs(g, dev, op, regime)
            n, d = x.shape
            name = f"{op} {regime} ({n}, {d}) -> {segs}"
            want_fn = "SegmentSumBackward" if op == "sum" else "SegmentMaxBackward"
            up = torch.randn(segs, d, generator=g, device=dev)
            got = segment_reduce(x, recv, segs, op=op, backend="cuda")
            if type(got.grad_fn).__name__ != want_fn:
                raise AssertionError(f"{name}: grad_fn {got.grad_fn}, not {want_fn}")
            got_grad = torch.autograd.grad(got, x, up)[0]
            got = got.detach()
            with torch.no_grad():
                want = segment_reduce(x, recv, segs, op=op, backend="torch")
            if op == "max" or regime in INTEGER_ONLY:
                same(f"{name} forward", got, want)
                err = 0.0
            else:
                err, _ = _within_order_bound(name, got, want, x, recv, segs)
            del want
            # a sum's plain autograd over chunks of rows (a row's gradient
            # depends on its own id and the upstream gradient alone): it
            # keeps a copy of its rows, which beside x and the kernel's
            # gradient would not fit at ogb_products.  A max's row gradient
            # depends on the ties in its whole segment: one chunk
            chunk = GNN_GRAD_CHUNK if op == "sum" else n
            for r0 in range(0, n, chunk):
                rows = x[r0:r0 + chunk].detach().requires_grad_()
                plain = segment_reduce(rows, recv[r0:r0 + chunk], segs, op=op,
                                       backend="torch")
                if not torch.equal(got_grad[r0:r0 + chunk],
                                   torch.autograd.grad(plain, rows, up)[0]):
                    raise AssertionError(f"{name}: rows' gradient != plain autograd's "
                                         f"(rows {r0} on)")
                del rows, plain
            log(f"  {name} rows' gradient: bit-equal")
            rec = {"case": name, "forward_max_abs_err": err,
                   "ties": None}
            if op == "max":  # (segment, feature) pairs whose max ties
                flat = torch.where(recv < segs, recv, segs).long()[:, None] * d \
                    + torch.arange(d, device=dev)
                hit = (x.detach() == torch.nn.functional.pad(
                    got, (0, 0, 0, 1), value=float("nan")).reshape(-1)[flat]).reshape(-1)
                counts = torch.bincount(flat.reshape(-1)[hit], minlength=(segs + 1) * d)
                rec["ties"] = int((counts > 1).sum().item())
                del flat, hit, counts
            del got, got_grad
            torch.cuda.empty_cache()
            spill = torch.where(recv < segs, recv, segs).long()
            if op == "sum":
                library = lambda: torch.zeros(segs + 1, d, device=dev).index_add(  # noqa: E731
                    0, spill, x)[:segs]
            else:
                idx = spill[:, None].expand(-1, d)
                library = lambda: torch.full(  # noqa: E731
                    (segs + 1, d), float("-inf"), device=dev).scatter_reduce(
                    0, idx, x, reduce="amax")[:segs]
            fwd_bwd = lambda f: lambda: torch.autograd.grad(f(), x, up)  # noqa: E731
            kern = fwd_bwd(lambda: segment_reduce(x, recv, segs, op=op, backend="cuda"))
            # forward: the real edges' rows and every id read, the sums
            # written; backward: every id and the upstream gradient read,
            # every row's gradient written (a max also reads the real rows
            # and its output)
            real = GNN_REGIMES[regime][1]
            nbytes = (4 * real * d + 4 * n * d + 2 * 4 * n + 2 * 4 * segs * d
                      + (4 * real * d + 4 * segs * d if op == "max" else 0))
            rec.update({
                "fwd_bwd_ms": time_ms(kern),
                "fwd_bwd_device_ms": device_time_ms(kern),
                "plain_fwd_bwd_ms": time_ms(fwd_bwd(
                    lambda: segment_reduce(x, recv, segs, op=op, backend="torch"))),
                "library_fwd_bwd_ms": time_ms(fwd_bwd(library)),
                "fwd_bwd_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            })
            out[f"{op}_{regime}"] = rec
            log("[gnn (a)] " + json.dumps(rec))
            del x, recv, up, spill, library, kern
            torch.cuda.empty_cache()
    return out


def _gnn_modules(config):
    import importlib

    return importlib.import_module(f"repro_torch.configs.{config}")


def gnn_launches_per_step(cfg, pooled: bool) -> dict:
    """The kernel launches of one forward (and so of one training step: the
    backwards launch no kernel) as ``models/gnn.py`` implies them: a
    ``segment_sum`` one segment-sum launch, a ``segment_mean`` two (the sum
    and the count), a ``segment_max`` or ``segment_min`` one segment-max
    launch; ``pooled`` where the graph has ``graph_ids``."""
    from repro_torch.models import gnn as G

    sums = maxes = 0
    if isinstance(cfg, G.GraphSAGEConfig):  # every config here aggregates by mean
        sums = 2 * cfg.n_layers
    elif isinstance(cfg, G.PNAConfig):  # degree; per layer the mean, then each
        per = 2 + sum({"std": 2}.get(a, 0) for a in cfg.aggregators)
        maxes = cfg.n_layers * sum(a in ("max", "min") for a in cfg.aggregators)
        sums = 1 + cfg.n_layers * per + (2 if pooled else 0)
    elif isinstance(cfg, G.SchNetConfig):
        sums = cfg.n_interactions + (1 if pooled else 0)
    elif isinstance(cfg, G.EGNNConfig):  # the coordinates' mean, the messages' sum
        sums = 3 * cfg.n_layers + (2 if pooled else 0)
    return {"segment_matmul": sums, "segment_max": maxes}


def reddit_minibatch(seed: int) -> dict:
    """minibatch_lg through the port's sampler: reddit's base graph drawn
    from ``seed`` (REDDIT_*), ``build_csr`` over its 114.6 M edges (timed),
    ``sample_subgraph`` of MINIBATCH_SEEDS seeds with MINIBATCH_FANOUTS.
    Returns the sampler's arrays and the walls."""
    import numpy as np
    from repro_torch.data.sampler import build_csr, sample_subgraph

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    cuts = np.sort(rng.integers(0, REDDIT_EDGES + 1, REDDIT_NODES - 1))
    deg = np.diff(np.concatenate([[0], cuts, [REDDIT_EDGES]]))
    receivers = np.repeat(np.arange(REDDIT_NODES, dtype=np.int64), deg)
    senders = rng.integers(0, REDDIT_NODES, REDDIT_EDGES, dtype=np.int64)
    feats = rng.standard_normal((REDDIT_NODES, REDDIT_FEATS), dtype=np.float32)
    labels = rng.integers(0, 41, REDDIT_NODES)
    t1 = time.perf_counter()
    csr = build_csr(senders, receivers, REDDIT_NODES)
    t2 = time.perf_counter()
    del senders, receivers
    seeds = rng.choice(REDDIT_NODES, MINIBATCH_SEEDS, replace=False)
    sub = sample_subgraph(csr, seeds, MINIBATCH_FANOUTS, feats, labels, seed=seed)
    t3 = time.perf_counter()
    sub["walls_s"] = {"draw": t1 - t0, "build_csr": t2 - t1, "sample": t3 - t2}
    return sub


def gnn_graph(config, shape, dev, seed, minibatch=None):
    """Phase 12's graph of ``shape`` for ``config`` on the card, drawn from
    ``seed``, and its batch: ``(graph, batch, live_edges)``.  molecule:
    128 graphs of 30 nodes and 64 edges (the edge capacity), the 256
    padding nodes zero with graph id 128 (dropped by the pooling);
    full_graph_sm: cora's 2,708 nodes and 10,556 edges, padding edges at
    the node capacity; minibatch_lg: the sampler's subgraph (``minibatch``),
    its node rows padded from 169,984 to the shape's 170,496 with zero rows
    that no edge touches (the sampler's padding edges moved to the
    capacity).  SchNet's nodes are atom types 1-9, SchNet's and EGNN's
    positions standard normal; node classification takes every node row as
    a seed (the reference's cell for shapes without ``n_seeds``), random
    labels; graph regression targets of 1 + 0.1 times standard normal
    noise: away from the initial outputs (about 0.1 to 20 in size), so that
    no loss starts near 0, where a relative difference of losses is
    ill-conditioned, and narrow, so that the loss reads the outputs
    (targets of unit spread would bury a fault's move in their own)."""
    import torch
    from repro_torch.configs.common_gnn import GNN_SHAPES
    from repro_torch.models.gnn import Graph

    mod = _gnn_modules(config)
    info = GNN_SHAPES[shape]
    n, e, n_graphs = info["n_nodes"], info["n_edges"], info["n_graphs"]
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = dict(device=dev, dtype=torch.int32)
    graph_ids = None
    seeds = labels = None
    if shape == "minibatch_lg":
        cap = minibatch["nodes"].shape[0]
        s = torch.from_numpy(minibatch["senders"]).to(dev)
        r = torch.from_numpy(minibatch["receivers"]).to(dev)
        live = int((minibatch["senders"] < cap).sum())
        s = torch.where(s < cap, s, n)
        r = torch.where(r < cap, r, n)
        real = int(minibatch["n_local"])
        feats = torch.zeros(n, info["d_feat"], device=dev)
        feats[:cap] = torch.from_numpy(minibatch["nodes"]).to(dev)
        seeds = torch.from_numpy(minibatch["seed_local"]).to(dev)
        labels = torch.from_numpy(minibatch["labels"].astype("int32")).to(dev)
    else:
        if shape == "molecule":
            real = n_graphs * MOLECULE_NODES
            base = torch.arange(n_graphs, **i32).repeat_interleave(MOLECULE_EDGES) \
                * MOLECULE_NODES
            s = base + torch.randint(0, MOLECULE_NODES, (e,), generator=g, **i32)
            r = base + torch.randint(0, MOLECULE_NODES, (e,), generator=g, **i32)
            graph_ids = torch.clamp(torch.arange(n, **i32) // MOLECULE_NODES,
                                    max=n_graphs)
            live = e
        else:
            real, live = CORA_NODES, CORA_EDGES
            s = torch.full((e,), n, **i32)
            r = torch.full((e,), n, **i32)
            s[:live] = torch.randint(0, real, (live,), generator=g, **i32)
            r[:live] = torch.randint(0, real, (live,), generator=g, **i32)
        feats = torch.randn(n, info["d_feat"], generator=g, device=dev)
        feats[real:] = 0
    positions = None
    if config == "schnet":
        nodes = torch.randint(1, 10, (n, 1), generator=g, **i32)
        nodes[real:] = 0
    else:
        nodes = feats
    if config in ("schnet", "egnn"):
        positions = torch.randn(n, 3, generator=g, device=dev)
    graph = Graph(nodes=nodes, senders=s, receivers=r, positions=positions,
                  graph_ids=graph_ids, n_graphs=n_graphs)
    if mod.SPEC.loss_kind == "node_class":
        if seeds is None:
            seeds = torch.arange(n, **i32)
            labels = torch.randint(0, info["n_classes"], (n,), generator=g, **i32)
        batch = (seeds, labels)
    else:
        batch = (torch.randn(n_graphs, 1, generator=g, device=dev).mul_(0.1).add_(1),)
    return graph, batch, live, real


def _gnn_run(config, shape, graph, batch, dev, steps, backend, sync_steps=()):
    """``steps`` training steps of ``config``'s cell at ``shape`` from the
    weights drawn from SEED on the card, through ``backend``: an event at
    each step's start, ``set_sync_debug_mode("warn")`` through the steps in
    ``sync_steps``.  Returns (each step's device-timeline ms, losses,
    the first GNN_CHECK_STEPS steps' outputs, host syncs by source line)."""
    import warnings

    import torch
    from repro_torch.configs.common_gnn import GNN_SHAPES, gnn_train_step, init_train_state

    spec = _gnn_modules(config).SPEC
    cfg = spec.make_cfg(GNN_SHAPES[shape])
    state = init_train_state(spec.init_fn(
        torch.Generator(device=dev).manual_seed(SEED), cfg))
    outputs = []

    def apply(params, cfg, graph, backend):
        out = spec.apply_fn(params, cfg, graph, backend=backend)
        if len(outputs) < GNN_CHECK_STEPS:
            outputs.append((out[0] if isinstance(out, tuple) else out).detach())
        return out

    step = gnn_train_step(apply, cfg, spec.loss_kind, backend=backend)
    events, losses = [], []
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            for i in range(steps):
                torch.cuda.set_sync_debug_mode("warn" if i in sync_steps else "default")
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                _, _, metrics = step(state.params, state.opt, graph, *batch)
                losses.append(metrics["loss"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    syncs = _sync_sites(caught)
    walls = [a.elapsed_time(b) for a, b in zip(events, events[1:] + [end])]
    return walls, [x.item() for x in losses], outputs, syncs


def _moved_receivers(graph, real):
    """The planted fault: each real edge's receiver moved to the next real
    node (padding edges stay at the capacity)."""
    import dataclasses

    import torch

    r = graph.receivers
    return dataclasses.replace(graph, receivers=torch.where(
        r < real, (r + 1) % real, r))


def _rel_l2(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def train_gnn_cell(config, shape, dev, minibatch=None):
    """Phase 12 (b) for one arch and shape: GNN_STEPS steps through the
    kernels (the device-timeline walls, edges/s, peak memory, launches a
    step against ``gnn_launches_per_step``, host syncs of steps 2 to
    GNN_STEPS), then GNN_CHECK_STEPS through the plain path from the same
    weights and graph (outputs and losses within GNN_OUT_RTOL and
    GNN_LOSS_RTOL) and as many with the planted fault (beyond the limit at
    every step).  Returns (launches, record)."""
    import torch
    from repro_torch.configs.common_gnn import GNN_SHAPES

    spec = _gnn_modules(config).SPEC
    cfg = spec.make_cfg(GNN_SHAPES[shape])
    graph, batch, live, real = gnn_graph(config, shape, dev, SEED + 1, minibatch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    walls, losses, outs, syncs = _gnn_run(config, shape, graph, batch, dev, GNN_STEPS,
                                          "auto", sync_steps=range(1, GNN_STEPS))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = gnn_launches_per_step(cfg, graph.graph_ids is not None)
    want = {**{k: 0 for k in launches},
            **{k: v * GNN_STEPS for k, v in per_step.items()}}
    _, plain_losses, plain_outs, _ = _gnn_run(config, shape, graph, batch, dev,
                                              GNN_CHECK_STEPS, "torch")
    _, fault_losses, fault_outs, _ = _gnn_run(
        config, shape, _moved_receivers(graph, real), batch, dev, GNN_CHECK_STEPS, "auto")
    step_ms = sorted(walls[1:])[len(walls[1:]) // 2]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    rec = {
        "config": config, "shape": shape, "live_edges": live, "real_nodes": real,
        "first_step_ms": walls[0], "step_ms_median_2_to_8": step_ms, "step_ms": walls,
        "edges_per_s": live / step_ms * 1e3, "max_memory_allocated_bytes": peak,
        "launches_per_step": per_step, "host_syncs_steps_2_to_8": syncs,
        "losses": losses, "plain_losses": plain_losses, "fault_losses": fault_losses,
        "loss_rel_diff": [rel(a, b) for a, b in zip(losses, plain_losses)],
        "out_rel_l2": [_rel_l2(a, b) for a, b in zip(outs, plain_outs)],
        "fault_loss_rel_diff": [rel(a, b) for a, b in zip(fault_losses, plain_losses)],
        "fault_out_rel_l2": [_rel_l2(a, b) for a, b in zip(fault_outs, plain_outs)],
    }
    log("[gnn (b)] " + json.dumps(rec))
    if launches != want:
        raise AssertionError(f"gnn {config} {shape}: launches {launches}, the code "
                             f"implies {want}")
    if not all(math.isfinite(x) for x in losses + plain_losses):
        raise AssertionError(f"gnn {config} {shape}: losses {losses}")
    if max(rec["out_rel_l2"]) > GNN_OUT_RTOL or max(rec["loss_rel_diff"]) > GNN_LOSS_RTOL:
        raise AssertionError(f"gnn {config} {shape}: kernel path beyond the limit of "
                             f"the plain path's")
    loss_reads_outputs = not (config == "graphsage_reddit" and shape == "molecule")
    if not min(rec["fault_out_rel_l2"]) > GNN_OUT_RTOL or (
            loss_reads_outputs and not min(rec["fault_loss_rel_diff"]) > GNN_LOSS_RTOL):
        raise AssertionError(f"gnn {config} {shape}: the planted fault is within the "
                             "limit")
    return launches, rec


def ogb_products_graph(dev):
    """graphsage-reddit's graph at ogb_products on the card, drawn from
    SEED + 2: 2,449,029 of 2,449,920 nodes and 61,859,140 of 61,865,984
    edges live (uniform endpoints), padding edges at the capacity, 100
    standard normal features, every node row a seed with one of 47 random
    labels (the reference's cell).  Returns (graph, batch)."""
    import torch
    from repro_torch.configs.common_gnn import GNN_SHAPES
    from repro_torch.models.gnn import Graph

    e, live, _, n, real = GNN_REGIMES["ogb_products"]
    info = GNN_SHAPES["ogb_products"]
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    i32 = dict(device=dev, dtype=torch.int32)
    s = torch.full((e,), n, **i32)
    r = torch.full((e,), n, **i32)
    s[:live] = torch.randint(0, real, (live,), generator=g, **i32)
    r[:live] = torch.randint(0, real, (live,), generator=g, **i32)
    feats = torch.randn(n, info["d_feat"], generator=g, device=dev)
    feats[real:] = 0
    return Graph(nodes=feats, senders=s, receivers=r), (
        torch.arange(n, **i32),
        torch.randint(0, info["n_classes"], (n,), generator=g, **i32))


def train_graphsage_ogb(dev):
    """Phase 12 (c): graphsage-reddit at ogb_products (``ogb_products_graph``),
    GNN_OGB_STEPS steps through the kernel's partitioned launch: peak
    memory, step walls, edges/s, launches.  Returns (launches, record)."""
    import torch
    from repro_torch.configs.common_gnn import GNN_SHAPES

    live = GNN_REGIMES["ogb_products"][1]
    info = GNN_SHAPES["ogb_products"]
    graph, batch = ogb_products_graph(dev)
    cfg = _gnn_modules("graphsage_reddit").make_cfg(info)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    walls, losses, _, syncs = _gnn_run("graphsage_reddit", "ogb_products", graph, batch,
                                       dev, GNN_OGB_STEPS, "auto",
                                       sync_steps=range(1, GNN_OGB_STEPS))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = gnn_launches_per_step(cfg, False)
    step_ms = sorted(walls[1:])[len(walls[1:]) // 2]
    rec = {"live_edges": live, "first_step_ms": walls[0], "step_ms": walls,
           "step_ms_median_2_to_3": step_ms, "edges_per_s": live / step_ms * 1e3,
           "graph_bytes": base, "max_memory_allocated_bytes": peak,
           "launches_per_step": per_step, "host_syncs_steps_2_to_3": syncs,
           "losses": losses}
    log("[gnn (c)] graphsage-reddit at ogb_products: " + json.dumps(rec))
    want = {**{k: 0 for k in launches},
            **{k: v * GNN_OGB_STEPS for k, v in per_step.items()}}
    if launches != want:
        raise AssertionError(f"gnn ogb_products: launches {launches}, the code "
                             f"implies {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"gnn ogb_products: losses {losses}")
    return launches, rec


# graphsage-reddit at ogb_products gathers (E, 100) and then (E, 128) float32
# messages, 23.05 and 29.50 GiB, each step: with fixed segments the caching
# allocator splits the larger block for a smaller request of the next step
# and finds no room for the larger one; segments that grow in place do not
# fragment so.  Phase 12 (c) runs in a child process with this setting.
OGB_ALLOC_CONF = "expandable_segments:True"


def graphsage_ogb_in_child() -> tuple:
    """Phase 12 (c) in a child process (``chip_smoke.py --gnn-ogb``) with
    ``PYTORCH_CUDA_ALLOC_CONF=OGB_ALLOC_CONF``: its lines, then (launches,
    record) from its last line."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--gnn-ogb"],
        env=dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=OGB_ALLOC_CONF),
        capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if out.returncode != 0:
        raise AssertionError(f"gnn ogb_products child: exit {out.returncode}\n"
                             + out.stderr[-4000:])
    got = json.loads(lines[-1])
    return got["launches"], got["record"]


def gnn_ogb_child() -> int:
    """The child's side of ``graphsage_ogb_in_child``."""
    import torch

    launches, rec = train_graphsage_ogb(torch.device("cuda", 0))
    rec["alloc_conf"] = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    print(json.dumps({"launches": launches, "record": rec}))
    return 0


def gnn_smokes(dev):
    """Phase 12 (d): each GNN config's ``smoke()`` on the card, its launches
    against the code's count (the smoke configs of configs/*.py)."""
    from repro_torch.models import gnn as G

    smoke_cfgs = {  # what each smoke() builds, and whether its graph pools
        "schnet": (G.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=20), True),
        "pna": (G.PNAConfig(n_layers=2, d_hidden=16, d_in=8), True),
        "egnn": (G.EGNNConfig(n_layers=2, d_hidden=16, d_in=8), True),
        "graphsage_reddit": (G.GraphSAGEConfig(d_in=8, n_classes=5, d_hidden=16), False),
    }
    out, total = {}, None
    reset_launches()
    for config in GNN_CONFIGS:
        before = read_launches()
        out[config] = _gnn_modules(config).smoke()
        after = read_launches()
        got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want = {k: v for k, v in gnn_launches_per_step(*smoke_cfgs[config]).items() if v}
        if got != want:
            raise AssertionError(f"gnn smoke {config}: launches {got}, want {want}")
        log(f"[gnn (d)] {config}.smoke(): {out[config]}, launches {got}")
    return read_launches(), out


def train_gnns(dev):
    """Phase 12: (a) the Functions against plain autograd; (b) the four
    archs at three shapes; (c) graphsage-reddit at ogb_products; (d) the
    smokes.  Returns (launches by run, summary)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory held at the phase's start: "
        f"{torch.cuda.memory_allocated(dev):,} B")
    summary = {"functions": check_segment_functions(dev)}
    launches = {}
    t0 = time.perf_counter()
    minibatch = reddit_minibatch(SEED)
    summary["minibatch_lg_sampler"] = {
        "walls_s": minibatch.pop("walls_s"), "n_local": int(minibatch["n_local"]),
        "live_edges": int((minibatch["senders"] < minibatch["nodes"].shape[0]).sum())}
    log(f"[gnn] minibatch_lg sampled from reddit's {REDDIT_NODES:,} nodes and "
        f"{REDDIT_EDGES:,} edges in {time.perf_counter() - t0:.1f} s: "
        + json.dumps(summary["minibatch_lg_sampler"]))
    cells = []
    for shape in GNN_TRAIN_SHAPES:
        for config in GNN_CONFIGS:
            launches[f"gnn_{config}_{shape}"], rec = train_gnn_cell(
                config, shape, dev, minibatch)
            cells.append(rec)
            torch.cuda.empty_cache()
    summary["cells"] = cells
    del minibatch
    launches["gnn_ogb_products"], summary["ogb_products"] = graphsage_ogb_in_child()
    torch.cuda.empty_cache()
    launches["gnn_smoke"], summary["smoke"] = gnn_smokes(dev)
    return launches, summary


# MoE serving (phase 13): two requests a model, prefill, then SERVE_STEPS
# greedy decode steps.  mixtral-8x7b at full width cut to 8 of its 32 layers
# (23.7 GB of bf16 weights; 32 would be 93 GB, and the plain path's float32
# attention buffers, 29 GB a layer at 6,144 tokens, must fit beside them),
# prompts of 6,144 tokens, past its 4,096-key window; arctic-480b at full
# width cut to 2 of its 35 layers (55.4 GB: 27.2 GB a layer, 128 experts
# and the dense residual), prompts of 2,048.  config -> (layers, prompt)
MOE_BATCH = 2
MOE_MODELS = {"mixtral_8x7b": (8, 6144), "arctic_480b": (2, 2048)}
# Relative L2 error of the kernel path's last-token logits against the
# plain path's at each of the 33 calls, the plain path routed as the kernel
# path routed (its expert picks forced, its gates its own).  The attention
# kernel rounds P to bf16 before P V where the plain version keeps float32:
# on an H100, 0.0140-0.0195 (mixtral, 8 layers) and 0.0107-0.0156 (arctic,
# 2 layers).  Left free, a router near-tie sends a token to another expert
# on one path only, and with random weights such a flip moves a request's
# logits by up to 0.65 (a token's expert output replaced, the capacity's
# cut moved): the free run's error and the share of (token, layer) picks on
# which the two paths agree (96-97 %) are printed, not held.  A control
# that adds every live combine row to the next token gives 0.89 and more
# (0.187 at the batched dispatch's prefill; PERF.md, section 6); the limit
# lies between the two and the control must exceed it at every call.
MOE_SERVE_TOL = 0.04
# the MoE combine's shapes, phase 13 (c): (rows = experts x capacity,
# width, tokens)
COMBINE_SHAPES = {
    "mixtral prefill": (8 * 3848, 4096, MOE_BATCH * 6144),
    "arctic prefill": (128 * 88, 7168, MOE_BATCH * 2048),
    "mixtral decode": (8 * 8, 4096, MOE_BATCH),
    "arctic decode": (128 * 8, 7168, MOE_BATCH),
}


@contextlib.contextmanager
def _moe_record(forced=None):
    """Records each MoE layer call's top-k picks (``moe.route``) and dropped
    rows (``moe.moe_apply_grouped``), device tensors in call order.  With
    ``forced`` (another run's recorded picks, in the same call order) each
    call routes to those experts, its gates the softmax of its own logits
    there."""
    import torch
    from repro_torch.models import moe

    route, grouped = moe.route, moe.moe_apply_grouped
    rec = {"picks": [], "dropped": []}
    queue = None if forced is None else list(forced)

    def routed(*args, **kw):
        out = route(*args, **kw)
        if queue is not None:
            logits, _, top_e = out
            top_e = queue.pop(0).reshape(top_e.shape)
            gates = torch.softmax(torch.gather(logits, -1, top_e), dim=-1)
            out = (logits, gates.to(out[1].dtype), top_e)
        rec["picks"].append(out[2].reshape(-1, out[2].shape[-1]))
        return out

    def applied(*args, **kw):
        out, metrics = grouped(*args, **kw)
        rec["dropped"].append(metrics["dropped_tokens"])
        return out, metrics

    moe.route, moe.moe_apply_grouped = routed, applied
    try:
        yield rec
    finally:
        moe.route, moe.moe_apply_grouped = route, grouped


@contextlib.contextmanager
def _combine_shifted():
    """Phase 13's planted fault: the combine adds every live row to the next
    token (the last token's rows fall out of range and are dropped)."""
    import torch
    from repro_torch.models import moe

    segment_reduce = moe.segment_reduce

    def shifted(x, ids, n, **kw):
        return segment_reduce(x, torch.where(ids < n, ids + 1, ids), n, **kw)

    moe.segment_reduce = shifted
    try:
        yield
    finally:
        moe.segment_reduce = segment_reduce


def _rel_rows(got, want):
    """Relative L2 error of each last-token logits row: (call, request)."""
    return (got - want).norm(dim=-1) / want.norm(dim=-1)


def _route_agreement(a, b) -> dict:
    """The share of (token, layer) top-k picks, as sets, on which two runs'
    recorded picks agree: at the prefill and at the decode steps."""
    import torch

    out = {}
    for name in ("prefill", "decode"):
        same = total = 0
        for x, y in zip(a, b):
            if (x.shape[0] > MOE_BATCH) != (name == "prefill"):
                continue
            eq = (torch.sort(x, dim=-1).values == torch.sort(y, dim=-1).values).all(-1)
            same += int(eq.sum())
            total += eq.numel()
        if total:
            out[name] = {"agree": same, "total": total, "share": same / total}
    return out


def _moe_prefill(model, tokens):
    """One prefill into a fresh cache: (last-token logits, s)."""
    import torch

    cache = model.init_kv_cache(tokens.shape[0], tokens.shape[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.prefill(tokens, cache)
    torch.cuda.synchronize()
    return logits.float(), time.perf_counter() - t0


def serve_moe(dev, config):
    """Phase 13 (a), (b): ``config`` at full width and ``MOE_MODELS``'
    depth through the attention and segment-sum kernels (once to warm up,
    once counted, timed and recorded, with the decode steps' host syncs
    counted), through the plain path on the same weights and tokens, and
    with the combine shifted (the control); for mixtral also the prefill
    with ``optimized_config()``'s batched dispatch against its own plain
    path.  Returns (launches by run, summary)."""
    import dataclasses
    import importlib

    import torch
    from repro_torch.models.moe import _capacity
    from repro_torch.models.transformer import Transformer

    mod = importlib.import_module(f"repro_torch.configs.{config}")
    n_layers, prompt = MOE_MODELS[config]
    cfg = dataclasses.replace(mod.full_config(), n_layers=n_layers, kernel_backend="cuda")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev, seed=SEED)
    weights = dict(model.named_parameters())
    plain_model = Transformer(dataclasses.replace(cfg, kernel_backend="torch"),
                              weights=weights)
    torch.cuda.synchronize()
    weight_bytes = sum(w.numel() * w.element_size() for w in weights.values())
    log(f"[moe] {cfg.name}: {n_layers} of {mod.full_config().n_layers} layers, "
        f"{weight_bytes / 1e9:.2f} GB of bf16 weights drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; {MOE_BATCH} x {prompt} prompt tokens "
        f"(capacity {_capacity(MOE_BATCH * prompt, cfg.moe)} a prefill, "
        f"{_capacity(MOE_BATCH, cfg.moe)} a decode step), {SERVE_STEPS} steps")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab, (MOE_BATCH, prompt), generator=g, device=dev)
    slots = prompt + SERVE_STEPS
    # warm-up: cuBLAS picks its kernels
    _greedy_run(model, tokens, model.init_kv_cache(MOE_BATCH, slots))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    syncs = {}
    with _moe_record() as kernel_rec:  # the counted run's picks and drops
        logits, fed, prefill_s, decode_s = _greedy_run(
            model, tokens, model.init_kv_cache(MOE_BATCH, slots), syncs=syncs)
    launches = {f"moe_{config}": read_launches()}
    peak = torch.cuda.max_memory_allocated(dev)
    calls = n_layers * (1 + SERVE_STEPS)
    want = {**{k: 0 for k in launches[f"moe_{config}"]},
            "flash_attention": calls, "segment_matmul": calls}
    if launches[f"moe_{config}"] != want:
        raise AssertionError(f"{config}: launches {launches[f'moe_{config}']}, the "
                             f"code implies {want}")
    with _moe_record() as plain_rec:  # routed freely
        free, _, plain_prefill_s, plain_decode_s = _greedy_run(
            plain_model, tokens, plain_model.init_kv_cache(MOE_BATCH, slots), fed)
    with _moe_record(forced=kernel_rec["picks"]):  # routed as the kernel path
        plain, _, _, _ = _greedy_run(
            plain_model, tokens, plain_model.init_kv_cache(MOE_BATCH, slots), fed)
    with _combine_shifted():
        faulty, _, _, _ = _greedy_run(model, tokens,
                                      model.init_kv_cache(MOE_BATCH, slots), fed)
    if not bool(torch.isfinite(logits).all()) or logits.shape != (
            1 + SERVE_STEPS, MOE_BATCH, cfg.vocab):
        raise AssertionError(f"{config}: logits {tuple(logits.shape)} not finite")
    rel = _rel_rows(logits, plain).amax(dim=1)
    rel_free = _rel_rows(logits, free).amax(dim=1)
    ctrl = _rel_rows(faulty, plain).amax(dim=1)
    dropped = torch.stack(kernel_rec["dropped"]).tolist()
    summary = {
        "layers": n_layers, "prompt": prompt, "batch": MOE_BATCH,
        "weight_bytes": weight_bytes,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": MOE_BATCH * prompt / prefill_s,
        "decode_ms_per_step": decode_s / SERVE_STEPS * 1e3,
        "decode_tokens_per_s": MOE_BATCH * SERVE_STEPS / decode_s,
        "plain_prefill_s": plain_prefill_s,
        "plain_decode_ms_per_step": plain_decode_s / SERVE_STEPS * 1e3,
        "max_memory_allocated_bytes": peak,
        "decode_host_syncs": sum(syncs.values()), "decode_host_sync_sites": syncs,
        "dropped_prefill": sum(dropped[:n_layers]),
        "dropped_decode": sum(dropped[n_layers:]),
        "routing_agreement": _route_agreement(kernel_rec["picks"], plain_rec["picks"]),
        "free_logits_rel_l2_max": rel_free.max().item(),
        "free_logits_rel_l2_by_call": [round(x, 6) for x in rel_free.tolist()],
        "logits_rel_l2_max": rel.max().item(),
        "logits_rel_l2_by_call": [round(x, 6) for x in rel.tolist()],
        "control_rel_l2_min": ctrl.min().item(),
        "control_rel_l2_by_call": [round(x, 6) for x in ctrl.tolist()],
        "launches": launches[f"moe_{config}"],
    }
    failed = []
    if rel.max().item() > MOE_SERVE_TOL:
        failed.append(f"logits relative L2 error {rel.max().item()} above "
                      f"{MOE_SERVE_TOL}")
    if not ctrl.min().item() > MOE_SERVE_TOL:
        failed.append(f"the control (combine shifted) is within {MOE_SERVE_TOL} at "
                      "a call")
    if syncs:
        failed.append(f"host syncs in the decode steps: {syncs}")
    del plain_model, plain, free, faulty
    if config == "mixtral_8x7b":
        # the reference's adopted variant: batched dispatch, capacity factor 1.0
        bcfg = dataclasses.replace(mod.optimized_config(), n_layers=n_layers,
                                   kernel_backend="cuda")
        bmodel = Transformer(bcfg, weights=weights)
        bplain = Transformer(dataclasses.replace(bcfg, kernel_backend="torch"),
                             weights=weights)
        _moe_prefill(bmodel, tokens)
        reset_launches()
        with _moe_record() as brec:
            got, bs = _moe_prefill(bmodel, tokens)
        launches["moe_mixtral_8x7b_batched"] = read_launches()
        with _moe_record() as bfree:
            freeb, bps = _moe_prefill(bplain, tokens)
        with _moe_record(forced=brec["picks"]):
            wantb, _ = _moe_prefill(bplain, tokens)
        with _combine_shifted():
            faultyb, _ = _moe_prefill(bmodel, tokens)
        brel = _rel_rows(got, wantb).max().item()
        bctrl = _rel_rows(faultyb, wantb).min().item()
        summary["batched_prefill"] = {
            "capacity": _capacity(prompt, bcfg.moe), "prefill_s": bs,
            "prefill_tokens_per_s": MOE_BATCH * prompt / bs, "plain_prefill_s": bps,
            "dropped": int(sum(x.item() for x in brec["dropped"])),
            "routing_agreement": _route_agreement(brec["picks"], bfree["picks"]),
            "free_logits_rel_l2_max": _rel_rows(got, freeb).max().item(),
            "logits_rel_l2_max": brel, "control_rel_l2_min": bctrl,
            "launches": launches["moe_mixtral_8x7b_batched"]}
        if launches["moe_mixtral_8x7b_batched"] != {
                **{k: 0 for k in launches["moe_mixtral_8x7b_batched"]},
                "flash_attention": n_layers, "segment_matmul": n_layers}:
            failed.append(f"batched prefill launches "
                          f"{launches['moe_mixtral_8x7b_batched']}")
        if not (brel <= MOE_SERVE_TOL < bctrl):
            failed.append(f"batched prefill: logits {brel}, control {bctrl} "
                          f"against {MOE_SERVE_TOL}")
        del bmodel, bplain
    log(f"[moe] {config} " + json.dumps(summary))
    del model, weights
    if failed:
        raise AssertionError(f"{config}: " + "; ".join(failed))
    return launches, summary


def check_combine(dev):
    """Phase 13 (c): the segment-sum kernel at the MoE combine's shapes, two
    live rows a token in random slots, the other slots' ids out of range,
    bf16 rows: the float32 sums equal the plain version's bit for bit (two
    terms), and, cast to bf16, are compared with ``index_add_`` in bf16
    (the reference's combine in the rows' type, its spill index inside the
    call): bit-equal or not is reported.  Each timed by events and on the
    device alone beside the bound (the live bf16 rows and every int32 id
    read once, float32 sums written once).  Returns timed shape records."""
    import torch
    from repro_torch.kernels.ops import segment_reduce
    from repro_torch.kernels.segment_matmul import plan_segment_sum, segment_matmul_cuda

    g = torch.Generator(device=dev).manual_seed(6)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for case, (n, d, t) in COMBINE_SHAPES.items():
        ids = torch.full((n,), t, dtype=torch.int32, device=dev)
        slots = torch.randperm(n, generator=g, device=dev)[:2 * t]
        ids[slots] = torch.arange(t, device=dev, dtype=torch.int32).repeat_interleave(2)
        x = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
        kern = lambda: segment_matmul_cuda(x, ids, t)
        plain = lambda: segment_reduce(x, ids, t, backend="torch")
        library = lambda: torch.zeros(t + 1, d, dtype=x.dtype, device=dev).index_add_(
            0, torch.where(ids < t, ids, t).long(), x)[:t]
        got = kern()
        same(f"(combine, {case}) float32 sums", got, plain())
        lib = library()
        bit_equal = torch.equal(got.to(torch.bfloat16), lib)
        gap = (got.to(torch.bfloat16).float() - lib.float()).abs().max().item()
        plan = plan_segment_sum(n, d, t, sms)
        rec = {
            "case": f"MoE combine, {case}: x bf16 ({n}, {d}), {2 * t} live rows, "
                    f"into {t} tokens, {'partitioned' if plan.parts else 'direct'}",
            **timings(kern, plain, library),
            "with_cast_ms": time_ms(lambda: kern().to(torch.bfloat16)),
            "bf16_bit_equal_to_index_add": bit_equal, "bf16_max_abs_gap": gap,
            # the live rows' bf16 data, every id, the float32 sums: a row
            # whose id is out of range is never read
            "bound_ms": (2 * 2 * t * d + 4 * n + 4 * t * d) / HBM_BYTES_PER_S * 1e3,
        }
        log(f"  (combine, {case}) cast to bf16 {'bit-equal' if bit_equal else 'not bit-equal'}"
            f" to index_add_ in bf16 (max gap {gap:.3g})")
        shapes.append(rec)
        del x, ids, got, lib
    return shapes


def serve_moe_phase(dev):
    """Phase 13: (a) mixtral-8x7b, (b) arctic-480b, (c) the combine's
    shapes.  Returns (launches by run, summary, combine shape records)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory held at the phase's start: "
        f"{torch.cuda.memory_allocated(dev):,} B")
    launches, summary = {}, {}
    for config in MOE_MODELS:
        got, summary[config] = serve_moe(dev, config)
        launches.update(got)
        gc.collect()
        torch.cuda.empty_cache()
    log("[moe (c)] the segment-sum kernel at the combine's shapes")
    shapes = check_combine(dev)
    for s in shapes:
        log("  " + json.dumps(s))
    return launches, summary, shapes


# xDeepFM serving (phase 14): the published size, 39 tables of 38,190,000
# rows in all, x (10 + 1) float32 (1.68 GB), drawn on the card; ids from
# recsys_batches (Zipfian, modulo each field's vocabulary).  Relative L2
# error of the port's outputs (click probabilities; retrieval scores)
# against the reference's formulation written out plainly: the CIN sums
# its products in another order, which moves a logit of about 0.05 by
# float32 rounding, below the probability's resolution near 0.5 (on the
# CPU at the published widths: 0.0 between the two, 4.2e-8 each against
# float64); a control with one field's ids shifted by one must exceed the
# limit.
XDEEPFM_TOL = 1e-6
XDEEPFM_SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")
# rows of one pass of the plain CIN: its (B, H, H_k, D) float32
# intermediate is 4 x 200 x 200 x 10 = 1.6 MB a row, 6.6 GB at 2^12
XDEEPFM_PLAIN_CHUNK = 1 << 12
BAGS, BAG_IDS = 65536, 39  # embedding_bag's bag shape


def _xdeepfm_plain(params, cfg, ids, cand=None):
    """xDeepFM's serve step written out plainly as the reference computes
    it (``repro/models/recsys.py:115-151``), apart from ``models/recsys.py``:
    each field's row by ``F.embedding``, the CIN contracted as its two
    einsums in chunks of ``XDEEPFM_PLAIN_CHUNK`` rows, the MLP as ``x @ w +
    b`` with ReLU between.  Click probabilities ``(B,)``, or with ``cand``
    the scores of the mean field embedding ``(B, n_cand)``."""
    import torch
    import torch.nn.functional as F

    if cand is not None:
        embs = torch.stack([F.embedding(ids[:, i], params["tables"][f"f{i}"])
                            for i in range(ids.shape[1])], dim=1)
        return embs.mean(dim=1) @ cand.T
    return torch.sigmoid(_xdeepfm_plain_logits(params, cfg, ids))


def _xdeepfm_plain_logits(params, cfg, ids):
    """The logits ``(B,)`` of :func:`_xdeepfm_plain`, differentiable."""
    import torch
    import torch.nn.functional as F

    b, m = ids.shape
    embs = torch.stack([F.embedding(ids[:, i], params["tables"][f"f{i}"])
                        for i in range(m)], dim=1)
    lin = sum(F.embedding(ids[:, i], params["linear"][f"f{i}"]) for i in range(m))
    pooled = []
    for s in range(0, b, XDEEPFM_PLAIN_CHUNK):
        x0 = xk = embs[s:s + XDEEPFM_PLAIN_CHUNK]
        parts = []
        for w in params["cin"]:
            xk = torch.einsum("bhjd,bjd->bhd", torch.einsum("bid,hij->bhjd", x0, w), xk)
            parts.append(xk.sum(dim=-1))
        pooled.append(torch.cat(parts, dim=-1))
    cin = torch.cat(pooled) @ params["cin_out"]["w"]
    x = embs.reshape(b, -1)
    for i in range(len(params["mlp"])):
        x = x @ params["mlp"][f"l{i}"]["w"] + params["mlp"][f"l{i}"]["b"]
        if i < len(params["mlp"]) - 1:
            x = torch.relu(x)
    return (lin + cin + x)[:, 0] + params["bias"]


def _bag_bound(got, want, abs_sum, k):
    """|kernel - plain| of a bag sum (or mean) within the reordering bound:
    2 (k + 1) 2^-24 sum|x| a bag (one more term for the mean's division).
    Returns the largest |diff|."""
    err = (got.double() - want.double()).abs()
    if not bool((err <= 2 * (k + 1) * 2.0 ** -24 * abs_sum.double()).all()):
        raise AssertionError(f"embedding_bag: max |diff| {err.max().item()} beyond "
                             "the order bound")
    return err.max().item()


def serve_xdeepfm(dev):
    """Phase 14: xDeepFM's three serve shapes at the published size through
    the port and through :func:`_xdeepfm_plain`, each with a control; then
    ``embedding_bag`` at a bag shape through the segment-sum kernel (its
    launches counted) against its plain version, ``F.embedding_bag``,
    ``index_add_`` and its bound.  Returns (launches by run, summary, timed
    shape records, max |diff|)."""
    import statistics

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import xdeepfm
    from repro_torch.data.pipeline import recsys_batches
    from repro_torch.kernels.ops import segment_reduce
    from repro_torch.kernels.segment_matmul import segment_matmul_cuda
    from repro_torch.models.recsys import CIN_CHUNK, embedding_bag, xdeepfm_init

    cfg = xdeepfm.CFG
    vocabs = cfg.field_vocabs()
    t0 = time.perf_counter()
    params = xdeepfm_init(torch.Generator(device=dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    table_bytes = sum(t.numel() * t.element_size() for part in ("tables", "linear")
                      for t in params[part].values())
    log(f"[xdeepfm] {sum(vocabs):,} table rows x ({cfg.embed_dim} + 1) float32, "
        f"{table_bytes / 1e9:.3f} GB, drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    launches, summary, failed = {}, {}, []
    for shape in XDEEPFM_SHAPES:
        info = xdeepfm.SHAPES[shape]
        t0 = time.perf_counter()
        ids = torch.from_numpy(next(recsys_batches(info["batch"], cfg.n_sparse, vocabs,
                                                   seed=SEED))["sparse_ids"]).to(dev)
        ids_s = time.perf_counter() - t0
        shifted = ids.clone()
        shifted[:, 0] = (shifted[:, 0] + 1) % vocabs[0]
        extra = ()
        if shape == "retrieval_cand":
            extra = (torch.randn(info["n_cand"], cfg.embed_dim, generator=g, device=dev),)
        kern = xdeepfm.serve_fn(shape)
        kern(params, ids, *extra)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        got = kern(params, ids, *extra)
        torch.cuda.synchronize()
        served = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kern(params, ids, *extra)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        plain = lambda: _xdeepfm_plain(params, cfg, ids, *extra)
        if shape != "serve_bulk":  # warm-up; the bulk pass is 64 chunks
            plain()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        faulty = kern(params, shifted, *extra)
        rel = ((got - want).norm() / want.norm()).item()
        ctrl = ((faulty - want).norm() / want.norm()).item()
        rows = info["batch"] * info.get("n_cand", 1)
        wall = statistics.median(walls)
        summary[shape] = {
            "batch": info["batch"], "ids_made_s": ids_s, "wall_s": wall,
            "walls_s": walls, "plain_s": plain_s,
            ("candidates_per_s" if shape == "retrieval_cand" else "rows_per_s"):
                rows / wall,
            "max_memory_allocated_bytes": peak, "output_shape": list(got.shape),
            "rel_l2": rel, "max_abs_diff": (got - want).abs().max().item(),
            "control_rel_l2": ctrl, "launches": served,
        }
        if shape == "serve_bulk":
            summary[shape]["cin_chunks"] = -(-info["batch"] // CIN_CHUNK)
        log(f"[xdeepfm] {shape} " + json.dumps(summary[shape]))
        if any(served.values()):
            failed.append(f"{shape}: launches {served}, the gathers imply none")
        if not bool(torch.isfinite(got).all()) or not (rel <= XDEEPFM_TOL < ctrl):
            failed.append(f"{shape}: relative L2 {rel}, control {ctrl}, limit "
                          f"{XDEEPFM_TOL}")
        del ids, shifted, extra, got, want, faulty
        torch.cuda.empty_cache()
    # embedding_bag at a bag shape: BAGS bags of BAG_IDS ids each in the
    # largest field's table (10,000,000 x 10), uniform ids, every mode
    tab = params["tables"]["f0"]
    n, d = BAGS * BAG_IDS, tab.shape[1]
    idx = torch.randint(0, tab.shape[0], (n,), generator=g, device=dev)
    bags = (torch.arange(n, device=dev) // BAG_IDS).to(torch.int32)
    w = torch.rand(n, generator=g, device=dev)
    modes = (("sum", None), ("mean", None), ("sum", w))
    reset_launches()  # the bag path: each mode once, counted
    for mode, weights in modes:
        embedding_bag(tab, idx, bags, BAGS, weights, mode, backend="cuda")
    torch.cuda.synchronize()
    launches["xdeepfm_embedding_bag"] = read_launches()
    if launches["xdeepfm_embedding_bag"] != {
            **{k: 0 for k in launches["xdeepfm_embedding_bag"]}, "segment_matmul": 4}:
        failed.append(f"embedding_bag: launches {launches['xdeepfm_embedding_bag']}")
    shapes, max_err = [], 0.0
    for mode, weights in modes:
        name = f"{mode}{'' if weights is None else ', weighted'}"
        kern = lambda: embedding_bag(tab, idx, bags, BAGS, weights, mode, backend="cuda")
        plain = lambda: embedding_bag(tab, idx, bags, BAGS, weights, mode,
                                      backend="torch")
        library = lambda: F.embedding_bag(
            idx.view(BAGS, BAG_IDS), tab, mode=mode,
            per_sample_weights=None if weights is None else weights.view(BAGS, BAG_IDS))
        abs_sum = embedding_bag(tab.abs(), idx, bags, BAGS,
                                None if weights is None else weights.abs(), mode,
                                backend="torch")
        want = plain()
        max_err = max(max_err, _bag_bound(kern(), want, abs_sum, BAG_IDS))
        _bag_bound(library(), want, abs_sum, BAG_IDS)
        nbytes = n * d * 4 + n * 8 + n * 4 + BAGS * d * 4 + (0 if weights is None else n * 4)
        shapes.append({
            "case": f"embedding_bag {name}: table float32 {tuple(tab.shape)}, {BAGS} "
                    f"bags of {BAG_IDS} uniform ids",
            **timings(kern, plain, library),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        log("  " + json.dumps(shapes[-1]))
    # the segment-sum kernel alone on the gathered rows
    x = tab.index_select(0, idx)
    got = segment_matmul_cuda(x, bags, BAGS)
    want = torch.zeros(BAGS, d, device=dev).index_add_(0, bags.long(), x)
    max_err = max(max_err, _bag_bound(got, want, torch.zeros(BAGS, d, device=dev)
                                      .index_add_(0, bags.long(), x.abs()), BAG_IDS))
    shapes.append({
        "case": f"embedding_bag's segment sum: x float32 ({n}, {d}), {BAGS} bags of "
                f"{BAG_IDS} rows",
        **timings(lambda: segment_matmul_cuda(x, bags, BAGS),
                  lambda: segment_reduce(x, bags, BAGS, backend="torch"),
                  lambda: torch.zeros(BAGS, d, device=dev).index_add_(
                      0, bags.long(), x)),
        "bound_ms": (n * d * 4 + n * 4 + BAGS * d * 4) / HBM_BYTES_PER_S * 1e3})
    log("  " + json.dumps(shapes[-1]))
    del params, tab, idx, bags, w, x
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("xdeepfm: " + "; ".join(failed))
    return launches, summary, shapes, max_err


# MoE and xDeepFM training (phase 15).  mixtral-8x7b at full width cut to
# MOE_TRAIN_LAYERS of its 32 layers (a layer is 1.451 B parameters, 17.4 GB
# as bf16 weights and gradients and float32 moments; 3 layers with the
# embedding and head hold 55.3 GB, 4 would hold 72.7 GB before any
# activation), 4 x 2,048 tokens a step (cut from the train_4k cell's 256 x
# 4,096), through the port's lm_spec cell with the reference's LM AdamW
# (lr 3e-4, cosine over 10,000 steps): config -> (layers, batch, seq)
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 3, 4, 2048
MOE_TRAIN_STEPS, MOE_TRAIN_CHECK_STEPS = 6, 3
# |loss - the plain path's loss| at each of the first MOE_TRAIN_CHECK_STEPS
# steps from the same weights and batches (the kernel path's attention
# rounds P to bf16 before P V, and a router near-tie may send a token's row
# to another expert on one path only): on an H100, 6.5e-4, 2.6e-5 and
# 3.7e-4 at losses of 10.4-11.0.  A control that adds every live combine
# row to the next token gives 0.0205 and 0.0048 at steps 2 and 3, which it
# must exceed; at step 1 it gives 4.0e-4 and is not held: from random
# weights the logits are noise, and the mean cross-entropy of 8,192 tokens
# is the same to 1e-3 under any such reshuffle of them.
MOE_TRAIN_LOSS_TOL = 2e-3
# xDeepFM's train_batch cell at the published size, uncut: 65,536 rows a
# step, XDEEPFM_TRAIN_STEPS steps; the checks at XDEEPFM_CHECK_ROWS rows.
XDEEPFM_TRAIN_STEPS, XDEEPFM_CHECK_ROWS = 5, 4096
# Relative difference of the port's loss, and relative L2 error of each of
# its gradient leaves, against the reference's order written out plainly
# (``_xdeepfm_plain_logits`` under autograd) on the same weights and rows:
# the CIN's products sum in another order in float32, and a table's
# gradient is index_add_'s, with atomics.  On an H100: 0.0 and 1.83e-6.  A
# control with the labels flipped (2.3e-4 on the loss, 2.13 on a gradient
# leaf) must exceed it on both.
XDEEPFM_TRAIN_TOL = 1e-5


@contextlib.contextmanager
def _cin_kept():
    """The CIN without recompute: each chunk's outer products kept for the
    backward (``recsys.checkpoint`` replaced by a plain call)."""
    from repro_torch.models import recsys

    checkpoint = recsys.checkpoint
    recsys.checkpoint = lambda fn, *args, **kw: fn(*args)
    try:
        yield
    finally:
        recsys.checkpoint = checkpoint


def _moe_train_cell(config, n_layers):
    """The train_4k cell of ``config`` (``full_config`` or
    ``optimized_config`` of mixtral-8x7b) cut to ``n_layers``, through the
    port's ``lm_spec`` as the reference's ``launch/perf.py`` builds a depth
    variant (``dataclasses.replace(cfg, n_layers=L)``)."""
    import dataclasses

    from repro_torch.configs import SINGLE_POD, mixtral_8x7b
    from repro_torch.configs.common import lm_spec

    cut = lambda: dataclasses.replace(  # noqa: E731
        getattr(mixtral_8x7b, config)(), n_layers=n_layers, kernel_backend="cuda")
    return lm_spec(mixtral_8x7b.ARCH_ID, cut, mixtral_8x7b.smoke_config,
                   full_attention_only=False).build_cell("train_4k", SINGLE_POD)


def _moe_train_run(cell, dev, backend, steps, sync_steps=(), fault=None):
    """``steps`` steps of ``cell.step_fn`` on a model drawn on the card
    from SEED (the cell's config, attention and combine through
    ``backend``) and batches of ``lm_batches`` staged on the card first: an
    event at each step's start, each step's launches, the host syncs of the
    steps in ``sync_steps``.  Returns (step walls in ms, launches a step,
    metrics a step, peak bytes, host syncs by source line)."""
    import dataclasses
    import warnings

    import torch
    from repro_torch.convert import transformer_param_tree
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import adamw_init

    cfg = dataclasses.replace(cell.abstract_args[0].cfg, kernel_backend=backend)
    model = Transformer(cfg, device=dev, seed=SEED)
    opt = adamw_init(transformer_param_tree(model))
    batches = lm_batches(MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, cfg.vocab, seed=SEED)
    staged = [{k: torch.from_numpy(b[k]).to(dev) for k in ("tokens", "labels")}
              for b, _ in zip(batches, range(steps))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    events, launches, metrics = [], [], []
    with warnings.catch_warnings(record=True) as caught, (
            fault() if fault else contextlib.nullcontext()):
        warnings.simplefilter("always")
        try:
            for i, b in enumerate(staged):
                torch.cuda.set_sync_debug_mode("warn" if i in sync_steps else "default")
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                reset_launches()
                torch.cuda.reset_peak_memory_stats(dev)
                model, opt, m = cell.step_fn(model, opt, b["tokens"], b["labels"])
                launches.append(read_launches())
                metrics.append({**m, "peak_bytes": torch.cuda.max_memory_allocated(dev)})
        finally:
            torch.cuda.set_sync_debug_mode("default")
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    walls = [a.elapsed_time(b) for a, b in zip(events, events[1:] + [end])]
    metrics = [{k: v if isinstance(v, int) else v.item() for k, v in m.items()}
               for m in metrics]
    peak = max(m["peak_bytes"] for m in metrics)
    del model, opt, staged
    torch.cuda.empty_cache()
    return walls, launches, metrics, peak, _sync_sites(caught)


def train_moe(dev):
    """Phase 15 (a): mixtral-8x7b at full width through its train_4k cell
    cut to MOE_TRAIN_LAYERS layers, MOE_TRAIN_STEPS steps through the
    attention and segment-sum kernels (0 host syncs in steps 2 on), then
    MOE_TRAIN_CHECK_STEPS from the same weights and batches through the plain
    path (each loss within MOE_TRAIN_LOSS_TOL) and as many with the combine
    shifted (beyond it at every step after the first), then one step of the batched
    dispatch at capacity factor 1.0.  Returns (launches by run, summary)."""
    from repro_torch.models.moe import _capacity

    cell = _moe_train_cell("full_config", MOE_TRAIN_LAYERS)
    cfg = cell.abstract_args[0].cfg
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    log(f"[moe train] {cfg.name}: {cfg.n_layers} of 32 layers, {cfg.n_params:,} "
        f"parameters ({cfg.n_active_params:,} active), {MOE_TRAIN_BATCH} x "
        f"{MOE_TRAIN_SEQ} tokens a step, capacity {_capacity(tokens, cfg.moe)}, "
        f"remat {cfg.remat_policy!r}")
    walls, launches, metrics, peak, syncs = _moe_train_run(
        cell, dev, "cuda", MOE_TRAIN_STEPS, sync_steps=range(1, MOE_TRAIN_STEPS))
    flops = _step_flops(cfg, cfg.n_active_params, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)
    steps = [{"step": i + 1, "wall_ms": w, "tokens_per_s": tokens / w * 1e3,
              "mfu": flops / (w * 1e-3) / BF16_FLOPS,
              "attention_launches": l["flash_attention"],
              "segment_sum_launches": l["segment_matmul"],
              "loss": m["loss"], "moe_aux_loss": m["moe_aux_loss"],
              "moe_dropped": m["moe_dropped"], "grad_norm": m["grad_norm"],
              "peak_bytes": m["peak_bytes"]}
             for i, (w, l, m) in enumerate(zip(walls, launches, metrics))]
    for rec in steps:
        log("[moe train] " + json.dumps(rec))
    total = {k: sum(l[k] for l in launches) for k in launches[0]}
    step_ms = sorted(walls[1:])[len(walls[1:]) // 2]
    summary = {"layers": cfg.n_layers, "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ,
               "n_params": cfg.n_params, "n_active_params": cfg.n_active_params,
               "capacity": _capacity(tokens, cfg.moe), "flops_per_step": flops,
               "step_ms_median_2_on": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
               "mfu": flops / (step_ms * 1e-3) / BF16_FLOPS,
               "max_memory_allocated_bytes": peak, "host_syncs_steps_2_on": syncs,
               "steps": steps}
    failed = []
    want = {**{k: 0 for k in launches[0]}, "flash_attention": 2 * cfg.n_layers,
            "segment_matmul": 2 * cfg.n_layers}  # remat: twice a layer
    if any(l != want for l in launches):
        failed.append(f"launches a step {launches}, the code implies {want}")
    if syncs:
        failed.append(f"host syncs in steps 2-{MOE_TRAIN_STEPS}: {syncs}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics):
        failed.append(f"losses {[m['loss'] for m in metrics]}")
    kernel = [m["loss"] for m in metrics[:MOE_TRAIN_CHECK_STEPS]]
    plain = [m["loss"] for m in _moe_train_run(cell, dev, "torch",
                                               MOE_TRAIN_CHECK_STEPS)[2]]
    control = [m["loss"] for m in _moe_train_run(cell, dev, "cuda", MOE_TRAIN_CHECK_STEPS,
                                                 fault=_combine_shifted)[2]]
    sound = [abs(a - b) for a, b in zip(kernel, plain)]
    planted = [abs(a - b) for a, b in zip(control, plain)][1:]  # after an update
    summary["loss_vs_plain"] = {"plain_losses": plain, "kernel_minus_plain": sound,
                                "control_losses": control,
                                "control_minus_plain_steps_2_on": planted,
                                "limit": MOE_TRAIN_LOSS_TOL}
    log("[moe train] " + json.dumps(summary["loss_vs_plain"]))
    if max(sound) > MOE_TRAIN_LOSS_TOL:
        failed.append(f"kernel losses {sound} from the plain path's, above "
                      f"{MOE_TRAIN_LOSS_TOL}")
    if not min(planted) > MOE_TRAIN_LOSS_TOL:
        failed.append(f"the control (combine shifted) is within {MOE_TRAIN_LOSS_TOL} "
                      f"of the plain path: {planted}")
    runs = {"moe_train": total}
    # the reference's adopted variant: batched dispatch, capacity factor 1.0
    bcell = _moe_train_cell("optimized_config", MOE_TRAIN_LAYERS)
    bwalls, blaunches, bmetrics, bpeak, _ = _moe_train_run(bcell, dev, "cuda", 1)
    runs["moe_train_batched"] = blaunches[0]
    bcfg = bcell.abstract_args[0].cfg
    summary["batched"] = {"capacity": _capacity(MOE_TRAIN_SEQ, bcfg.moe),
                          "wall_ms": bwalls[0], "max_memory_allocated_bytes": bpeak,
                          **bmetrics[0], "launches": blaunches[0]}
    log("[moe train] batched dispatch " + json.dumps(summary["batched"]))
    if blaunches[0] != want:
        failed.append(f"batched dispatch launches {blaunches[0]}")
    if not math.isfinite(bmetrics[0]["loss"]):
        failed.append(f"batched dispatch loss {bmetrics[0]['loss']}")
    if failed:
        raise AssertionError("moe train: " + "; ".join(failed))
    return runs, summary


def check_combine_training(dev):
    """Phase 15 (b): ``SegmentSum`` (``ops.segment_reduce`` under autograd
    on the card) at the combine's training shape, 8 experts x the capacity
    of 4 x 2,048 tokens (C 2,568) bf16 rows of 4,096 into 8,192 tokens, two
    live rows a token in random slots: the float32 sums bit-equal to the
    plain version's (two terms), the rows' gradients bit-equal to plain
    autograd's for the same float32 upstream gradient; forward + backward
    timed by events and on the device alone beside plain autograd and
    ``index_add`` in bf16 under autograd, and the bytes bound.  Returns the
    shape record."""
    import torch
    from repro_torch.kernels.ops import segment_reduce
    from repro_torch.models.moe import _capacity
    from repro_torch.configs import mixtral_8x7b

    moe = mixtral_8x7b.full_config().moe
    t, d = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ, 4096
    n = moe.n_experts * _capacity(t, moe)
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    ids = torch.full((n,), t, dtype=torch.int32, device=dev)
    slots = torch.randperm(n, generator=g, device=dev)[:2 * t]
    ids[slots] = torch.arange(t, device=dev, dtype=torch.int32).repeat_interleave(2)
    x = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    up = torch.randn(t, d, generator=g, device=dev)
    name = f"MoE combine, training: x bf16 ({n}, {d}), {2 * t} live rows, into {t} tokens"
    got = segment_reduce(x, ids, t, backend="cuda")
    if type(got.grad_fn).__name__ != "SegmentSumBackward":
        raise AssertionError(f"{name}: grad_fn {got.grad_fn}")
    plain = segment_reduce(x, ids, t, backend="torch")
    same(f"({name}) float32 sums", got.detach(), plain.detach())
    same(f"({name}) rows' gradient", torch.autograd.grad(got, x, up)[0],
         torch.autograd.grad(plain, x, up)[0])
    del got, plain
    spill = torch.where(ids < t, ids, t).long()
    fwd_bwd = lambda f: lambda: torch.autograd.grad(f(), x, up)  # noqa: E731
    kern = fwd_bwd(lambda: segment_reduce(x, ids, t, backend="cuda"))
    library = fwd_bwd(lambda: torch.zeros(t + 1, d, dtype=x.dtype, device=dev).index_add(
        0, spill, x)[:t].float())
    # forward: the live bf16 rows and every id read, the float32 sums
    # written; backward: every id and the float32 upstream gradient read,
    # every row's bf16 gradient written
    nbytes = (2 * 2 * t * d + 4 * n + 4 * t * d) + (4 * n + 4 * t * d + 2 * n * d)
    rec = {"case": name, "fwd_bwd": True, "ms": time_ms(kern),
           "device_ms": device_time_ms(kern),
           "plain_ms": time_ms(fwd_bwd(lambda: segment_reduce(x, ids, t, backend="torch"))),
           "library_ms": time_ms(library), "library_device_ms": device_time_ms(library),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log("[moe train (b)] " + json.dumps(rec))
    del x, up, ids, spill
    torch.cuda.empty_cache()
    return rec


def _idle_share(fn) -> dict:
    """One call of ``fn`` traced by ``torch.profiler``: the device's busy ms
    (the union of its operations' intervals), the call's host wall and the
    idle share of that wall.  A marker kernel and a pause come first (a
    session after the first may drop the events right after its start)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy = (busy + (cur[1] - cur[0] if cur else 0)) / 1e3
    return {"traced_wall_ms": wall, "device_busy_ms": busy, "device_events": len(spans),
            "idle_share": 1 - busy / wall}


def train_xdeepfm(dev):
    """Phase 15 (c): xDeepFM's train_batch cell
    (``get_spec("xdeepfm").build_cell("train_batch", SINGLE_POD)``) at the
    published size, 65,536 rows a step from ``recsys_batches``, staged on
    the card: XDEEPFM_TRAIN_STEPS steps (walls on the device's timeline,
    rows/s, peak, 0 host syncs in steps 2 on, launches: none, the lookups
    being gathers), the last one traced for its idle share, and one more
    keeping the CIN's products (its peak: what the recompute saves); then at
    XDEEPFM_CHECK_ROWS rows the loss and every gradient leaf against the
    reference's order written out plainly, the CIN's recompute bit-equal to
    keeping its products, and the labels flipped (the control).  Returns
    (launches, summary)."""
    import warnings

    import torch
    from repro_torch.configs import SINGLE_POD, get_spec, xdeepfm
    from repro_torch.data.pipeline import recsys_batches
    from repro_torch.models import recsys
    from repro_torch.models.recsys import bce_loss, xdeepfm_apply, xdeepfm_init
    from repro_torch.train import adamw_init, tree_flatten

    cell = get_spec("xdeepfm").build_cell("train_batch", SINGLE_POD)
    cfg, rows = xdeepfm.CFG, cell.abstract_args[2].shape[0]
    params = xdeepfm_init(torch.Generator(device=dev).manual_seed(SEED), cfg)
    opt = adamw_init(params)
    staged = [{k: torch.from_numpy(b[k]).to(dev) for k in ("sparse_ids", "labels")}
              for b, _ in zip(recsys_batches(rows, cfg.n_sparse, cfg.field_vocabs(),
                                             seed=SEED), range(XDEEPFM_TRAIN_STEPS))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    events, metrics = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            for i, b in enumerate(staged[:-1]):
                torch.cuda.set_sync_debug_mode("warn" if i else "default")
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                params, opt, m = cell.step_fn(params, opt, b["sparse_ids"], b["labels"])
                metrics.append(m)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    walls = [a.elapsed_time(b) for a, b in zip(events, events[1:] + [end])]
    last = staged[-1]
    idle = _idle_share(lambda: metrics.append(cell.step_fn(
        params, opt, last["sparse_ids"], last["labels"])[2]))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    metrics = [{k: v.item() for k, v in m.items()} for m in metrics]
    # what the CIN's recompute saves: one more step keeping its products
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with _cin_kept():
            cell.step_fn(params, opt, last["sparse_ids"], last["labels"])
        torch.cuda.synchronize()
        kept_peak = torch.cuda.max_memory_allocated(dev)
    except torch.OutOfMemoryError:  # an answer too: keeping does not fit
        kept_peak = "out of memory"
    torch.cuda.empty_cache()
    step_ms = sorted(walls[1:])[len(walls[1:]) // 2]
    summary = {"rows": rows, "steps": len(metrics), "step_ms": walls,
               "traced_step": idle, "step_ms_median_2_on": step_ms,
               "rows_per_s": rows / step_ms * 1e3, "max_memory_allocated_bytes": peak,
               "products_kept_max_memory_allocated_bytes": kept_peak,
               "host_syncs_steps_2_on": _sync_sites(caught), "launches": launches,
               "metrics": metrics}
    log("[xdeepfm train] " + json.dumps(summary))
    failed = []
    if any(launches.values()):
        failed.append(f"launches {launches}: the gathers imply none")
    if summary["host_syncs_steps_2_on"]:
        failed.append(f"host syncs {summary['host_syncs_steps_2_on']}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics):
        failed.append(f"metrics {metrics}")
    del staged, opt
    torch.cuda.empty_cache()

    # the checks at XDEEPFM_CHECK_ROWS rows, on the trained weights
    b = next(recsys_batches(XDEEPFM_CHECK_ROWS, cfg.n_sparse, cfg.field_vocabs(),
                            seed=SEED + 1))
    ids, labels = (torch.from_numpy(b[k]).to(dev) for k in ("sparse_ids", "labels"))
    leaves = tree_flatten(params)[0]

    def grads(logits_fn, y):
        loss = bce_loss(logits_fn(), y)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    port = grads(lambda: xdeepfm_apply(params, cfg, ids), labels)
    want = grads(lambda: _xdeepfm_plain_logits(params, cfg, ids), labels)
    flipped = grads(lambda: xdeepfm_apply(params, cfg, ids), 1 - labels)
    # the CIN alone, recomputed and kept: the tables' gradients come from
    # index_add_'s atomics, whose order differs from run to run on the card
    x0 = torch.stack(recsys._lookup(params["tables"], ids), dim=1).detach()
    cin_leaves = [x0.requires_grad_(), *tree_flatten([params["cin"],
                                                      params["cin_out"]])[0]]
    up = torch.randn(XDEEPFM_CHECK_ROWS, 1, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)

    def cin():
        out = recsys._cin(params["cin"], params["cin_out"], x0)
        return [out.detach(), *torch.autograd.grad(out, cin_leaves, up)]

    recomputed = cin()
    with _cin_kept():
        kept = cin()
    loss_rel = lambda a: abs(a[0].item() - want[0].item()) / abs(want[0].item())  # noqa: E731
    grad_rel = lambda a: [_rel_l2(x, y) for x, y in zip(a[1], want[1])]  # noqa: E731
    check = {"rows": XDEEPFM_CHECK_ROWS, "loss": port[0].item(),
             "plain_loss": want[0].item(), "loss_rel": loss_rel(port),
             "grad_rel_l2_max": max(grad_rel(port)), "leaves": len(leaves),
             "cin_recompute_bit_equal": all(torch.equal(x, y)
                                            for x, y in zip(recomputed, kept)),
             "control_loss_rel": loss_rel(flipped),
             "control_grad_rel_l2_max": max(grad_rel(flipped)),
             "limit": XDEEPFM_TRAIN_TOL}
    summary["check"] = check
    log("[xdeepfm train] " + json.dumps(check))
    if not (check["loss_rel"] <= XDEEPFM_TRAIN_TOL
            and check["grad_rel_l2_max"] <= XDEEPFM_TRAIN_TOL):
        failed.append(f"loss or gradients beyond {XDEEPFM_TRAIN_TOL}: {check}")
    if not check["cin_recompute_bit_equal"]:
        failed.append("the CIN's recompute is not bit-equal to keeping its products")
    if not (check["control_loss_rel"] > XDEEPFM_TRAIN_TOL
            and check["control_grad_rel_l2_max"] > XDEEPFM_TRAIN_TOL):
        failed.append(f"the control (labels flipped) is within {XDEEPFM_TRAIN_TOL}")
    del params, leaves, port, want, flipped, x0, cin_leaves, recomputed, kept
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("xdeepfm train: " + "; ".join(failed))
    return launches, summary


def _moe_train_cli():
    """Phase 15 (d): ``python -m repro_torch.launch.train --arch
    mixtral-8x7b --d-head 64 --steps 20`` through its ``main`` (the smoke
    config, no remat: one launch of each kernel a layer a step).  Returns
    (summary, launches)."""
    from repro_torch.launch.train import main, smoke_config

    text = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = main(["--arch", "mixtral-8x7b", "--d-head", "64", "--steps", "20"])
    launches = read_launches()
    lines = [l for l in text.getvalue().splitlines() if l.startswith("[train]")]
    out = {"rc": rc, "s": time.perf_counter() - t0, "lines": lines, "launches": launches}
    log(f"[moe train (d)] rc {rc} in {out['s']:.1f} s, launches {launches}\n  "
        + "\n  ".join(lines))
    per_run = 20 * smoke_config("mixtral-8x7b").n_layers
    want = {**{k: 0 for k in launches}, "flash_attention": per_run,
            "segment_matmul": per_run}
    if rc != 0 or launches != want or not any("done: final loss" in l for l in lines):
        raise AssertionError(f"train CLI (mixtral-8x7b): rc {rc}, launches {launches}, "
                             f"the code implies {want}")
    return out, launches


def train_moe_xdeepfm_phase(dev):
    """Phase 15: (a) mixtral-8x7b training, (b) the combine's training
    shape, (c) xDeepFM training, (d) the train CLI on mixtral's smoke
    config.  Returns (launches by run, summary, the combine's record)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory held at the phase's start: "
        f"{torch.cuda.memory_allocated(dev):,} B")
    launches, summary = train_moe(dev)
    combine = check_combine_training(dev)
    launches["xdeepfm_train"], summary["xdeepfm"] = train_xdeepfm(dev)
    summary["cli"], launches["moe_train_cli"] = _moe_train_cli()
    return launches, summary, combine


def record(name, source, replaces, launches, max_err, shapes):
    head = shapes[0]
    rec = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.values()), "launches_by_run": launches,
        "max_abs_err": max_err, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head.get("bound_by", "bytes"),
        "library_ms": head["library_ms"], "shapes": shapes,
    }
    if not all(math.isfinite(rec[k]) for k in ("ms", "plain_ms", "bound_ms")):
        raise AssertionError(f"{name}: non-finite timing")
    return rec


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

    _phase(1, "build")
    build_kernels()

    _phase(2, "kernels against their plain versions")
    checks = {}
    for name, fn in (("histogram", check_histogram),
                     ("segment_max", check_segment_max), ("cms_update", check_cms)):
        checks[name] = fn(dev)
        for s in checks[name][1]:
            log("  " + json.dumps(s))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        _phase(3, f"main path, run_challenge at scale {SCALE}, "
            "then the sketch tier")
        main_launches, sketch_s, capture, ref, table3 = main_path(dev, workdir)
        _phase(4, f"the graph-algorithm pass at scale {ALGO_SCALE}")
        algo_launches, alone_launches, algo_ms = algorithm_pass(dev, workdir)

        _phase(5, f"the CLI with --algorithms --tier both, scale "
            f"{CLI_SCALE}")
        cli_launches = cli_algorithms_and_sketch()

        _phase(6, "attention and segment-sum kernels against their "
            "plain versions")
        for name, fn in (("flash_attention", check_attention),
                         ("segment_matmul", check_segment_sum)):
            checks[name] = fn(dev)
            for s in checks[name][1]:
                log("  " + json.dumps(s))
        segsum_launches = segment_reduce_path(dev)
        torch.cuda.empty_cache()
        _phase(7, f"LM serving, granite-8b at full size, {SERVE_BATCH} x "
            f"{SERVE_PROMPT} prompt tokens, {SERVE_STEPS} decode steps")
        serve_launches, serve = serve_granite(dev)
        torch.cuda.empty_cache()
        _phase(8, f"the streaming engine, phase 3's capture in "
            f"micro-batches of {STREAM_BATCH:,} rows")
        stream_launches, stream = stream_engine(dev, capture, ref)
        _phase(9, f"the A/B baselines, the query surface and --fused "
            f"on phase 3's table (scale {SCALE})")
        ab_launches, ab = ab_baselines_and_fused(dev, workdir, table3, ref)
        del table3
        _phase(10, f"the fault-tolerant service on phase 3's capture "
            f"({STREAM_BATCH:,}-row groups), then the serve CLI")
        serve_svc_launches, service = fault_tolerant_service(dev, capture, ref, card)
        del capture, ref
        torch.cuda.empty_cache()
        _phase(11, f"LM training, minicpm-2b at full size, {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} tokens a step")
        train_launches, train = train_minicpm(dev, workdir)
        _phase(12, "GNN training, the four archs at their published widths")
        gnn_launches, gnn = train_gnns(dev)
        _phase(13, "MoE serving, mixtral-8x7b and arctic-480b at full "
            "width, then the combine's shapes")
        moe_launches, moe, combine_shapes = serve_moe_phase(dev)
        _phase(14, "xDeepFM serving at its published size, then "
            "embedding_bag at a bag shape")
        xdeepfm_launches, xdeepfm, bag_shapes, bag_err = serve_xdeepfm(dev)
        _phase(15, "MoE and xDeepFM training, mixtral-8x7b at full width and "
            "xDeepFM at its published size")
        train15_launches, train15, combine_train = train_moe_xdeepfm_phase(dev)
        starts = sorted(_PHASE_STARTS.items()) + [(None, time.perf_counter())]
        log("phase walls (s): " + json.dumps({n: round(b - a, 1) for (n, a), (_, b)
                                               in zip(starts, starts[1:])}))

    # launches of the main path's runs only; the algorithms timed alone and
    # the comparisons with the plain versions are counted nowhere
    by_kernel = lambda k, runs: {r: v[k] for r, v in runs.items() if v[k]}
    launches = {**main_launches, "algorithms": algo_launches, "cli": cli_launches,
                "segment_reduce": segsum_launches, "serve": serve_launches,
                **stream_launches, **ab_launches, **serve_svc_launches,
                **train_launches, **gnn_launches, **moe_launches,
                **xdeepfm_launches, **train15_launches}
    hll_shape = [s for s in checks["segment_max"][1]
                 if s["case"].startswith(("h:", "h-"))]
    # phase 12 (a): the autograd Functions, forward + backward
    for name, op in (("segment_matmul", "sum"), ("segment_max", "max")):
        recs = [rec for key, rec in gnn["functions"].items() if key.startswith(op + "_")]
        checks[name] = (max([checks[name][0]] + [r["forward_max_abs_err"] for r in recs]),
                        checks[name][1] + recs)
    # phases 13 (c) and 14: the combine's and the bag's shapes (the combine's
    # float32 sums are bit-equal to the plain version's)
    checks["segment_matmul"] = (max(checks["segment_matmul"][0], bag_err),
                                checks["segment_matmul"][1] + combine_shapes + bag_shapes
                                + [combine_train])
    kernels = [
        record("histogram", "src/repro_torch/kernels/csrc/histogram.cu",
               "src/repro/kernels/histogram.py:108",
               by_kernel("histogram", launches), *checks["histogram"]),
        record("segment_max", "src/repro_torch/kernels/csrc/segreduce.cu",
               "src/repro/kernels/segreduce.py:92",
               by_kernel("segment_max", launches), *checks["segment_max"]),
        record("hll_update", "src/repro_torch/kernels/sketch.py",
               "src/repro/kernels/sketch.py:130",
               by_kernel("hll_update", launches), 0.0, hll_shape),
        record("cms_update", "src/repro_torch/kernels/csrc/sketch.cu",
               "src/repro/kernels/sketch.py:69",
               by_kernel("cms_update", launches), *checks["cms_update"]),
        record("segment_matmul", "src/repro_torch/kernels/csrc/segment_matmul.cu",
               "src/repro/kernels/segment_matmul.py:45",
               by_kernel("segment_matmul", launches), *checks["segment_matmul"]),
        record("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:85",
               by_kernel("flash_attention", launches), *checks["flash_attention"]),
    ]
    for rec in kernels:
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']}: no launch on the main path")
    log(json.dumps({"sketch_tier_s": sketch_s, "algorithms_alone_ms": algo_ms,
                    "algorithms_alone_launches": alone_launches, "serve": serve,
                    "stream": stream, "ab_and_fused": ab, "service": service,
                    "train": train, "gnn": gnn, "moe": moe, "xdeepfm": xdeepfm,
                    "train_moe_xdeepfm": train15}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(gnn_ogb_child() if sys.argv[1:] == ["--gnn-ogb"] else main())
