"""The CUDA kernels (histogram, segment max, Count-Min, segment sum,
attention) against their plain versions, on the card, and the paths that
run them: the transformer's serving and training (the attention kernel as
an ``autograd.Function``), the MoE decoders' serving (the combine on the
segment sum), xDeepFM's ``embedding_bag`` and ``serve_p99``, the GNNs,
the challenge, the stream and the service.

These tests need an NVIDIA card and ``nvcc``: they carry the ``cuda``
marker and skip without a card.  Run them on a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (the card's machine has no JAX).
"""
import itertools
import math
import time

import pytest
import torch

from repro_torch.convert import tensor_leaves
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import segment_matmul as segsum_kernel
from repro_torch.kernels import segreduce as segmax_kernel
from repro_torch.kernels import sketch as sketch_kernel
from repro_torch.kernels.launches import wrapper

# the kernel module (the package's own "histogram" is ops.histogram)
hist_kernel = wrapper("histogram")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(g, lo, hi, n, dev):
    return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int32)


# 50,000 rows: up to 12,288 float bins (48 KB) the private path, above it
# the scatter path (histogram.plan_histogram)
@pytest.mark.parametrize("num_bins", [1, 1000, 12288, 12289, 20000],
                         ids=lambda b: f"histogram-{b}-bins")
@pytest.mark.parametrize("with_init,gated,masked",
                         list(itertools.product([False, True], repeat=3)))
@pytest.mark.parametrize("out_dtype", [None, torch.int32])
def test_kernel_matches_plain(dev, num_bins, with_init, gated, masked, out_dtype):
    g = torch.Generator(device=dev).manual_seed(num_bins)
    n = 50_000
    kw = dict(out_dtype=out_dtype)
    if with_init:
        kw["init"] = _rand(g, -5, 5, num_bins, dev)
    if gated:
        kw.update(gate_ids=_rand(g, 0, 3, n, dev), gate_value=1)
    if masked:
        kw.update(valid_mask=_rand(g, 0, 2, num_bins, dev).bool(), retire=-7)
    ids = _rand(g, -10, num_bins + 10, n, dev)
    w = _rand(g, 0, 4, n, dev)
    before = hist_kernel.LAUNCHES
    got = ops.segmented_reduce(w, ids, num_bins, backend="cuda", **kw)
    assert hist_kernel.LAUNCHES == before + 1
    want = ops.segmented_reduce(w, ids, num_bins, backend="torch", **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("num_bins", [8192, 1 << 20])  # private, scatter
def test_histogram_int32_sums_past_2_24(dev, num_bins):
    """2^25 rows of weight 1, half of them on one bin: int32 sums exact past
    float32's 2^24, on both paths."""
    n = 1 << 25
    ids = torch.randint(0, num_bins, (n,), device=dev, dtype=torch.int32)
    ids[::2] = 3
    w = torch.ones(n, dtype=torch.int32, device=dev)
    private = num_bins == 8192
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert hist_kernel.plan_histogram(n, num_bins, 2 * sms, 2 * sms).private == private
    got = hist_kernel.histogram_cuda(ids, num_bins, w, out_dtype=torch.int32)
    want = ops.segmented_reduce(w, ids, num_bins, out_dtype=torch.int32, backend="torch")
    torch.cuda.synchronize()
    assert int(got[3]) > 1 << 24 and torch.equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 200, 4095])
@pytest.mark.parametrize("num_bins", [64, 5000])
def test_histogram_few_rows_and_sorted_runs(dev, n, num_bins):
    """Rows fewer than the bins (the scatter path), and as many (private),
    sorted into runs longer than a warp round, masked, gated, with init:
    equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(n + num_bins)
    for rows in (n, max(n, num_bins)):
        ids = torch.sort(_rand(g, -3, num_bins // 50 + 2, rows, dev))[0]
        kw = dict(init=_rand(g, -5, 5, num_bins, dev),
                  gate_ids=_rand(g, 0, 2, rows, dev), gate_value=1,
                  valid_mask=_rand(g, 0, 4, num_bins, dev) != 0, retire=-9,
                  out_dtype=torch.int32)
        w = _rand(g, 0, 4, rows, dev)
        got = hist_kernel.histogram_cuda(ids, num_bins, w, **kw)
        want = ops.segmented_reduce(w, ids, num_bins, backend="torch", **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), rows


def test_auto_dispatch_launches_the_kernel(dev):
    ids = torch.arange(10, dtype=torch.int32, device=dev)
    before = hist_kernel.LAUNCHES
    got = ops.histogram(ids, 10)
    assert hist_kernel.LAUNCHES == before + 1
    assert torch.equal(got, torch.ones(10, device=dev))


def test_entry_points_take_the_plain_cuda_device_name(dev, tmp_path):
    """``device="cuda"`` (the default) names the same card as the tables'
    ``cuda:0``; the CLI's defaults run end to end on it."""
    from repro_torch.challenge.pipeline import ChallengeConfig, run_challenge
    from repro_torch.challenge.run import main

    run = run_challenge(ChallengeConfig(scale=10, method="hash",
                                        workdir=str(tmp_path)))
    assert run.anon_table.device == dev
    assert main(["--scale", "10", "--workdir", str(tmp_path)]) == 0


def test_kernel_rejects_bad_inputs(dev):
    with pytest.raises(ValueError, match="int32"):
        hist_kernel.histogram_cuda(torch.zeros(4, dtype=torch.int64, device=dev), 3)
    with pytest.raises(ValueError, match="shape"):
        hist_kernel.histogram_cuda(torch.zeros(4, dtype=torch.int32, device=dev), 3,
                                   torch.ones(5, device=dev))


def _rand_floats(g, n, dev):
    """Normal floats with ±inf and both zeros mixed in."""
    v = torch.randn(n, generator=g, device=dev)
    special = torch.tensor([float("inf"), float("-inf"), -0.0, 0.0], device=dev)
    pick = torch.randint(0, 10, (n,), generator=g, device=dev) == 0
    return torch.where(pick, special[torch.randint(0, 4, (n,), generator=g,
                                                   device=dev)], v)


# few and many segments, and rows from the HyperLogLog fold's 2^15 to many
# times the segments
@pytest.mark.parametrize("num_segments", [1, 4096, 12288, 12289, 20000])
@pytest.mark.parametrize("n", [50_000, (1 << 17) + 1])
@pytest.mark.parametrize("with_init,gated,masked",
                         list(itertools.product([False, True], repeat=3)))
def test_segment_max_kernel_matches_plain(dev, num_segments, n, with_init, gated,
                                          masked):
    g = torch.Generator(device=dev).manual_seed(num_segments + 7)
    kw = {}
    if with_init:
        kw["init"] = _rand_floats(g, num_segments, dev)
    if gated:
        kw.update(gate_ids=_rand(g, 0, 3, n, dev), gate_value=1)
    if masked:
        kw.update(valid_mask=_rand(g, 0, 2, num_segments, dev).bool(),
                  retire=float("-inf"))
    ids = _rand(g, -10, num_segments + 10, n, dev)
    vals = _rand_floats(g, n, dev)
    before = segmax_kernel.LAUNCHES
    got = ops.segmented_reduce(vals, ids, num_segments, op="max",
                               backend="cuda", **kw)
    assert segmax_kernel.LAUNCHES == before + 1
    want = ops.segmented_reduce(vals, ids, num_segments, op="max",
                                backend="torch", **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("path", [None, "cluster", "cooperative"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
# the default width, one that is no multiple of the cluster, a wider one
@pytest.mark.parametrize("width", [4096, 4099, 20000])
@pytest.mark.parametrize("n", [0, 1, 32768])
def test_cms_kernel_matches_plain(dev, dtype, width, n, path):
    g = torch.Generator(device=dev).manual_seed(width + n)
    depth = 4
    counts = _rand(g, 0, 1 << 26, depth * width, dev).reshape(depth, width).to(dtype)
    cols = _rand(g, -1, width + 3, depth * n, dev).reshape(depth, n)
    props = _rand(g, 0, 1 << 27, n, dev)
    if dtype == torch.float32:  # signs, ±inf and both zeros
        counts = _rand_floats(g, depth * width, dev).reshape(depth, width)
        props = _rand_floats(g, n, dev)
    got = sketch_kernel.cms_update_cuda(counts, cols, props, path=path)
    want = ops.cms_update(counts, cols, props, backend="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_cms_kernel_wide_rows(dev, dtype):
    """A row wider than the opt-in shared memory takes the cooperative path;
    the cluster path refuses it."""
    g = torch.Generator(device=dev).manual_seed(9)
    depth, width, n = 3, 100_000, 50_000
    counts = _rand(g, 0, 1 << 26, depth * width, dev).reshape(depth, width).to(dtype)
    cols = _rand(g, -1, width + 3, depth * n, dev).reshape(depth, n)
    props = _rand(g, 0, 1 << 27, n, dev).to(dtype)
    got = sketch_kernel.cms_update_cuda(counts, cols, props)
    want = ops.cms_update(counts, cols, props, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="cluster path"):
        sketch_kernel.cms_update_cuda(counts, cols, props, path="cluster")


@pytest.mark.parametrize("num_segments", [4096, 12288])
@pytest.mark.parametrize("n", [0, 1, 4095, 1 << 15, (1 << 17) + 1])
def test_segment_max_int32_values_and_masked_rows(dev, num_segments, n):
    """int32 values and init read as they are, masked segments that receive
    rows: equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(n + num_segments)
    ids = _rand(g, -3, num_segments + 3, n, dev)
    vals = _rand(g, -(1 << 30), 1 << 30, n, dev)
    init = _rand(g, -(1 << 30), 1 << 30, num_segments, dev)
    mask = _rand(g, 0, 2, num_segments, dev).bool()
    mask[ids[(ids >= 0) & (ids < num_segments)][:8].long()] = False
    kw = dict(init=init, valid_mask=mask, retire=-2.5)
    want = ops.segmented_reduce(vals, ids, num_segments, op="max",
                                backend="torch", **kw)
    got = segmax_kernel.segment_max_cuda(vals, ids, num_segments, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _device_ops(fn) -> list:
    """Names of the device operations (kernels, copies, fills) of one call,
    from torch.profiler: the longest list over three sessions.  A session
    after the first in a process may drop device events that come right
    after its start, never add any; each session launches a marker
    kernel and pauses first."""
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


@pytest.mark.parametrize("case", ["vxm", "hll", "gated, float init", "many rows, masked",
                                  "molecule", "full_graph_sm", "bfloat16 rows",
                                  "partitioned", "hist (a), init and mask",
                                  "hist (b) gated, sorted", "hist (n) masked",
                                  "hist (o) int32, -1 padding", "cms (j) int32",
                                  "cms (j) float32"])
def test_scatter_wrappers_launch_one_kernel_per_call(dev, case):
    """A call with rows, on inputs contiguous and of the kernel's types, is
    one kernel and nothing else: no fill, no copy of init or the cells, no
    cast, no retire kernel."""
    g = torch.Generator(device=dev).manual_seed(11)
    if case.startswith("hist"):
        n, bins = {"(a)": (1 << 24, 8192), "(b)": (1 << 24, (1 << 24) + 1),
                   "(n)": (1 << 20, 2 << 20), "(o)": (1 << 20, 2 << 20)}[case[5:8]]
        ids = _rand(g, -1, bins, n, dev)
        kw = {}
        if case.startswith("hist (a)"):
            w = _rand(g, 0, 4, n, dev).float()
            kw.update(init=_rand(g, 0, 9, bins, dev).float(),
                      valid_mask=_rand(g, 0, 4, bins, dev) != 0, retire=-1.0)
        elif case.startswith("hist (b)"):
            ids = torch.sort(ids)[0]
            w = _rand(g, 0, 3, n, dev)
            kw.update(gate_ids=_rand(g, 0, 9, n, dev), gate_value=3,
                      out_dtype=torch.int32)
        elif case.startswith("hist (n)"):
            w = torch.rand(n, generator=g, device=dev)
            kw.update(valid_mask=_rand(g, 0, 4, bins, dev) != 0, retire=0.0)
        else:
            live = n - n // 8
            ids = torch.cat([torch.sort(ids[:live].abs())[0],
                             torch.full((n - live,), -1, dtype=torch.int32, device=dev)])
            w = _rand(g, 0, 40, n, dev)
            kw["out_dtype"] = torch.int32
        names = _device_ops(lambda: hist_kernel.histogram_cuda(ids, bins, w, **kw))
        path = "hist_private" if bins <= 12288 else "hist_scatter"
        assert len(names) == 1 and path in names[0], names
        return
    if case.startswith("cms"):
        depth, width, n = 4, 4096, 1 << 15
        counts = _rand(g, 0, 1 << 26, depth * width, dev).reshape(depth, width)
        cols = torch.where(_rand(g, 0, 4, n, dev) == 0, -1,
                           _rand(g, 0, width, depth * n, dev).reshape(depth, n))
        props = _rand(g, 0, 1 << 27, n, dev)
        if case.endswith("float32"):
            counts, props = counts.float(), props.float()
        for path in ("cluster", "cooperative"):
            names = _device_ops(
                lambda: sketch_kernel.cms_update_cuda(counts, cols, props, path=path))
            assert len(names) == 1 and f"cms_{path}" in names[0], names
        return
    if case in ("molecule", "full_graph_sm", "bfloat16 rows", "partitioned"):
        n, d, segs = {"molecule": (8192, 64, 4096), "full_graph_sm": (10752, 1433, 2816),
                      "bfloat16 rows": (5000, 33, 700),
                      "partitioned": (200_000, 100, 300_000)}[case]
        x = torch.randn(n, d, generator=g, device=dev)
        if case == "bfloat16 rows":
            x = x.to(torch.bfloat16)
        ids = _rand(g, 0, segs + 2, n, dev)
        names = _device_ops(lambda: segsum_kernel.segment_matmul_cuda(x, ids, segs))
        assert len(names) == 1 and "segment_sum_tiles" in names[0], names
        return
    n, segs = {"vxm": (1 << 20, 2 << 20), "hll": (1 << 15, 4096),
               "many rows, masked": ((1 << 17) + 1, 4096)
               }.get(case, (50_000, 4096))
    ids = _rand(g, -1, segs, n, dev)
    vals = _rand_floats(g, n, dev)
    kw = {}
    if case == "vxm":
        kw.update(valid_mask=_rand(g, 0, 4, segs, dev) != 0, retire=float("-inf"))
    elif case == "hll":
        vals = _rand(g, 1, 22, n, dev)
        kw["init"] = _rand(g, 0, 20, segs, dev).float()
    elif case == "gated, float init":
        kw.update(gate_ids=_rand(g, 0, 3, n, dev), gate_value=1,
                  init=_rand_floats(g, segs, dev))
    else:
        kw.update(valid_mask=_rand(g, 0, 2, segs, dev).bool(), retire=-1.0)
    names = _device_ops(lambda: segmax_kernel.segment_max_cuda(vals, ids, segs, **kw))
    assert len(names) == 1 and "segmax_cooperative" in names[0], names


def test_auto_dispatch_launches_the_new_kernels(dev):
    ids = torch.arange(10, dtype=torch.int32, device=dev)
    segmax_before, cms_before = segmax_kernel.LAUNCHES, sketch_kernel.LAUNCHES
    got = ops.segmented_reduce(ids.float(), ids, 10, op="max")
    assert torch.equal(got, ids.float())
    regs = ops.hll_update(torch.zeros(16, device=dev), ids, ids + 1)
    assert torch.equal(regs[:10], (ids + 1).float())
    assert segmax_kernel.LAUNCHES == segmax_before + 2
    out = ops.cms_update(torch.zeros((2, 16), dtype=torch.int32, device=dev),
                         torch.stack([ids, ids]), ids)
    assert sketch_kernel.LAUNCHES == cms_before + 1
    assert torch.equal(out[:, :10], torch.stack([ids, ids]))


def test_new_kernels_reject_bad_inputs(dev):
    with pytest.raises(ValueError, match="int32"):
        segmax_kernel.segment_max_cuda(torch.ones(4, device=dev),
                                       torch.zeros(4, dtype=torch.int64, device=dev), 3)
    with pytest.raises(ValueError, match="shape"):
        sketch_kernel.cms_update_cuda(torch.zeros((2, 3), dtype=torch.int32, device=dev),
                                      torch.zeros((3, 4), dtype=torch.int32, device=dev),
                                      torch.zeros(4, dtype=torch.int32, device=dev))


# Attention: float32 to 2e-3 and bfloat16 to 3e-2, tests/test_kernels.py's
# tolerances (bf16 outputs round at 2^-8; the bf16 kernel also rounds P).
ATTN_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
# Each output row (one query of one head) is also held by its relative L2
# error, chip_smoke.py's phase-6 limits: elementwise limits of 1 + |o| scale
# lie above small outputs, whose size falls as 1 / sqrt(keys seen).
ATTN_ROW_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def _assert_attention_close(got, want, dtype):
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    rows = ((got.float() - want.float()).norm(dim=-1)
            / (want.float().norm(dim=-1) + 1e-6))
    assert rows.max().item() <= ATTN_ROW_RTOL[dtype], rows.max().item()


def _qkv(g, dev, dtype, b, hq, hkv, lq, lkv, d):
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev).to(dtype)
    return rnd(b, hq, lq, d), rnd(b, hkv, lkv, d), rnd(b, hkv, lkv, d)


# bf16 calls whose group x lq rows fit the 16-row decode tile take the
# split-kv decode path, the rest the wgmma prefill path (attention_path)
@pytest.mark.parametrize("b,hq,hkv,lq,lkv,d", [
    (1, 1, 1, 128, 128, 64),     # MHA, one tile each way
    (2, 8, 2, 256, 256, 64),     # GQA 4:1
    (1, 4, 4, 96, 96, 128),      # not a multiple of the 64-row tiles
    (2, 8, 1, 1, 512, 64),       # decode against a cache (MQA)
    (1, 2, 2, 64, 320, 32),      # chunked prefill: lq < lkv
    (1, 2, 1, 65, 63, 128),      # lq > lkv: leading rows see no key
    (2, 4, 2, 200, 200, 128),
    (1, 8, 2, 1, 1, 128),        # decode, lkv 1
    (2, 8, 2, 1, 40, 64),        # decode, lkv below one 64-key chunk
    (2, 32, 8, 1, 2079, 128),    # granite decode: lkv off the tiles, 7 chunks
    (1, 4, 1, 1, 10000, 128),    # one kv head: 157 one-tile chunks
    (1, 8, 2, 2, 300, 64),       # decode, lq 2
    (1, 8, 2, 4, 1000, 128),     # group 4 x lq 4 = 16 rows: decode, at the boundary
    (1, 8, 2, 5, 1000, 128),     # 20 rows: prefill, past the boundary
    (1, 8, 8, 16, 700, 64),      # group 1, a 16-row chunk: decode
    (1, 16, 2, 2, 500, 32),      # group 8 x lq 2 = 16 rows, D 32: decode
    (1, 16, 2, 16, 2000, 128),   # a 16-row chunk of group 8 against a longer cache
    (1, 2, 2, 6, 4, 32),         # decode tile, lq > lkv: leading rows 0
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(dev, b, hq, hkv, lq, lkv, d, causal, dtype):
    g = torch.Generator(device=dev).manual_seed(lq * 31 + lkv + d)
    q, k, v = _qkv(g, dev, dtype, b, hq, hkv, lq, lkv, d)
    before = fa_kernel.LAUNCHES
    got = ops.attention(q, k, v, causal=causal, backend="cuda")
    assert fa_kernel.LAUNCHES == before + 1
    want = ops.attention(q, k, v, causal=causal, backend="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("shape", [
    (1, 4, 2, 300, 300, 64),
    (1, 8, 2, 1, 3000, 128),   # decode: the band cut from the cache
    (1, 1, 1, 16, 1000, 64),   # 16 rows, one kv head: chunks no key of a row sees
])
@pytest.mark.parametrize("window", [1, 40, 64, 200, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_sliding_window(dev, shape, window, dtype):
    g = torch.Generator(device=dev).manual_seed(window)
    q, k, v = _qkv(g, dev, dtype, *shape)
    for causal in (True, False):
        got = ops.attention(q, k, v, causal=causal, window=window, backend="cuda")
        want = ops.attention(q, k, v, causal=causal, window=window, backend="torch")
        _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_reads_a_strided_cache_view(dev, dtype):
    """Decode and chunked prefill against the written part of a longer cache,
    cut as a view: the kernel reads it in place."""
    g = torch.Generator(device=dev).manual_seed(5)
    cache = torch.randn(2, 3, 8, 130, 128, generator=g, device=dev).to(dtype)
    k, v = cache[0][:, :, :77], cache[1][:, :, :77]
    assert not k.is_contiguous()
    for lq in (1, 4, 13):  # decode, decode at 16 rows, prefill
        q = torch.randn(3, 32, lq, 128, generator=g, device=dev).to(dtype)
        got = ops.attention(q, k, v, backend="cuda")
        want = ops.attention(q, k, v, backend="torch")
        _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("scale", [0.3, -0.2])  # the kernels fold a positive scale
@pytest.mark.parametrize("lq", [1, 200])  # decode, prefill
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_scale(dev, scale, lq, dtype):
    g = torch.Generator(device=dev).manual_seed(lq)
    q, k, v = _qkv(g, dev, dtype, 2, 8, 2, lq, 300, 64)
    got = ops.attention(q, k, v, scale=scale, backend="cuda")
    want = ops.attention(q, k, v, scale=scale, backend="torch")
    _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("lq,lkv", [(1, 2079), (4, 2079), (2, 64), (4, 1)])
def test_attention_paths_agree_at_the_boundary(dev, lq, lkv):
    """Up to 16 packed rows both bf16 paths take the shape: the split-kv
    decode (the rule's pick) and the prefill path forced onto it, each within
    the limits of the plain version, one launch each."""
    g = torch.Generator(device=dev).manual_seed(lq + lkv)
    q, k, v = _qkv(g, dev, torch.bfloat16, 2, 32, 8, lq, lkv, 128)
    assert fa_kernel.attention_path(q, k) == "decode"
    want = ops.attention(q, k, v, backend="torch")
    for path in ("decode", "prefill"):
        before = fa_kernel.LAUNCHES
        got = fa_kernel.flash_attention_cuda(q, k, v, path=path)
        assert fa_kernel.LAUNCHES == before + 1
        _assert_attention_close(got, want, torch.bfloat16)
    q5 = torch.randn(2, 32, 5, 128, generator=g, device=dev).to(torch.bfloat16)
    assert fa_kernel.attention_path(q5, k) == "prefill"
    with pytest.raises(ValueError, match="decode tile"):
        fa_kernel.flash_attention_cuda(q5, k, v, path="decode")


def test_attention_kernel_rejects_bad_inputs(dev):
    q = torch.randn(1, 4, 8, 64, device=dev)
    k = torch.randn(1, 2, 8, 64, device=dev)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa_kernel.flash_attention_cuda(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="head size"):
        fa_kernel.flash_attention_cuda(q[..., :48], k[..., :48], k[..., :48])
    k3 = torch.randn(1, 3, 8, 64, device=dev)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa_kernel.flash_attention_cuda(q, k3, k3)
    with pytest.raises(ValueError, match="contiguous last axis"):
        fa_kernel.flash_attention_cuda(q, k.transpose(2, 3).contiguous()
                                       .transpose(2, 3), k)
    with pytest.raises(ValueError, match="window"):
        fa_kernel.flash_attention_cuda(q, k, k, window=0)


# the GNN regimes, narrow and odd widths, segment tiles that straddle the
# ids (d 33: 64-segment tiles; d 1,433 and 300: 32) and S of several tile
# rows; each shape both ways, direct and partitioned
@pytest.mark.parametrize("n,d,segs", [(8192, 64, 4096), (10752, 1433, 2816),
                                      (5000, 7, 3), (1, 300, 1), (20000, 33, 5000),
                                      (3000, 1433, 300), (4000, 300, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_segment_sum_kernel_matches_plain(dev, n, d, segs, dtype):
    """Integer-valued rows: float sums exact in any order, so bit-equal."""
    g = torch.Generator(device=dev).manual_seed(n + d)
    ids = _rand(g, -5, segs + 5, n, dev)
    x = _rand(g, -4, 5, n * d, dev).reshape(n, d).to(dtype)
    before = segsum_kernel.LAUNCHES
    got = ops.segment_reduce(x, ids, segs, backend="cuda")
    assert segsum_kernel.LAUNCHES == before + 1
    want = ops.segment_reduce(x, ids, segs, backend="torch")
    ts, tf, cap, parts = segsum_kernel.plan_segment_sum(
        n, d, segs, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert want.shape == (segs, d) and ts <= segsum_kernel.MAX_TILE_SEGMENTS
    for partition in (False, True):
        forced = segsum_kernel.segment_matmul_cuda(x, ids, segs, partition=partition)
        torch.cuda.synchronize()
        assert torch.equal(forced, want), partition
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("partition", [False, True])
def test_segment_sum_kernel_rounds_and_a_hub(dev, partition):
    """50,000 ids, read in 4 rounds of at most 16,384 (each round's sums
    added to the first's), and a hub segment that takes half the rows:
    bit-equal on integer-valued rows, direct and partitioned."""
    g = torch.Generator(device=dev).manual_seed(17)
    n, d, segs = 50_000, 70, 3000
    ids = _rand(g, -2, segs + 2, n, dev)
    ids[::2] = 1234
    x = _rand(g, -4, 5, n * d, dev).reshape(n, d).float()
    assert segsum_kernel.plan_segment_sum(n, d, segs, 132).cap < n
    got = segsum_kernel.segment_matmul_cuda(x, ids, segs, partition=partition)
    want = ops.segment_reduce(x, ids, segs, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,d,segs", [(200_000, 100, 300_000), (300_000, 8, 5_000_000),
                                      (150_000, 130, 50)])
def test_segment_sum_kernel_partitioned_shapes(dev, n, d, segs):
    """Shapes the planner partitions: many tiles (19,532 at 5,000,000
    segments, above one counting pass of 16,384 tiles), and few segments
    with many rows; bit-equal on integer-valued rows, one launch."""
    g = torch.Generator(device=dev).manual_seed(n + segs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert segsum_kernel.plan_segment_sum(n, d, segs, sms).parts > 0
    ids = _rand(g, -3, segs + 3, n, dev)
    x = _rand(g, -4, 5, n * d, dev).reshape(n, d).float()
    before = segsum_kernel.LAUNCHES
    got = ops.segment_reduce(x, ids, segs, backend="cuda")
    assert segsum_kernel.LAUNCHES == before + 1
    want = ops.segment_reduce(x, ids, segs, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_segment_sum_kernel_random_floats_and_edges(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    ids = _rand(g, 0, 100, 20000, dev)
    x = torch.randn(20000, 33, generator=g, device=dev)
    want = ops.segment_reduce(x, ids, 100, backend="torch")
    for partition in (None, False, True):
        got = segsum_kernel.segment_matmul_cuda(x, ids, 100, partition=partition)
        # sums of about 200 terms of size 1, in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    empty = torch.zeros(0, 4, device=dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    assert torch.equal(ops.segment_reduce(empty, none, 3, backend="cuda"),
                       torch.zeros(3, 4, device=dev))
    with pytest.raises(ValueError, match="int32"):
        segsum_kernel.segment_matmul_cuda(x, ids.long(), 100)
    with pytest.raises(ValueError, match="float32, bfloat16"):
        segsum_kernel.segment_matmul_cuda(x.double(), ids, 100)


@pytest.mark.parametrize("config", ["granite_8b", "minicpm_2b", "qwen2_72b"])
def test_transformer_serving_kernel_matches_plain(dev, config):
    """The smoke configs, bfloat16, with heads of 64 (the kernel's smallest
    head size is 32; the smoke configs' is 8) on the card: prefill of 40
    tokens into a 64-slot cache and 8 decode steps through the attention
    kernel, against the same weights through the plain attention; one launch
    per layer per call.  Logits within 3e-2 relative L2 (bf16 rounding of P
    in the kernel, through two layers)."""
    import dataclasses
    import importlib

    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(
        importlib.import_module(f"repro_torch.configs.{config}").smoke_config(),
        dtype=torch.bfloat16, d_head=64)
    runs = {}
    for backend in ("cuda", "torch"):
        model = Transformer(dataclasses.replace(cfg, kernel_backend=backend),
                            device="cuda", seed=0)
        g = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (2, 48), generator=g, device=dev)
        before = fa_kernel.LAUNCHES
        cache = model.init_kv_cache(2, 64)
        logits, cache = model.prefill(tokens[:, :40], cache)
        out = [logits]
        for i in range(40, 48):
            logits, cache = model.decode_step(tokens[:, i], cache)
            out.append(logits)
        runs[backend] = (torch.stack(out).float(), fa_kernel.LAUNCHES - before)
    assert runs["cuda"][1] == cfg.n_layers * 9 and runs["torch"][1] == 0
    got, want = runs["cuda"][0], runs["torch"][0]
    assert bool(torch.isfinite(got).all())
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    assert rel < 3e-2, rel


def _stream_engines(dev, batches):
    """Two streaming engines over the same 2^16-packet RMAT capture in
    batches of 2^14 rows, both tiers: one through the kernels, one through
    the plain versions, both on the card."""
    from repro_torch.challenge.pipeline import window_column
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.data.rmat import synthetic_packets
    from repro_torch.stream import StreamConfig, StreamEngine

    cols = synthetic_packets(1 << 16, scale=16, seed=1)
    win = window_column(cols["ts"], 8)
    rows = 1 << 14
    engines = {b: StreamEngine(StreamConfig(
        batch_capacity=rows, link_capacity=1 << 16, tier="both",
        sketch=SketchConfig(), backend=b, device=str(dev)))
        for b in ("cuda", "torch")}
    for backend, eng in engines.items():
        for i in batches:
            s = slice(i * rows, (i + 1) * rows)
            eng.ingest(cols["src"][s], cols["dst"][s], win[s])
    return engines


def test_stream_kernel_path_matches_plain(dev):
    """The streaming engine through the kernels (the histogram's ``init``
    epilogue, Count-Min, the HyperLogLog segment max) against its plain
    path, 4 batches: every leaf of the exact state and of the sketch bit for
    bit, and 1 histogram, 2 Count-Min and 3 segment-max launches a batch."""
    before = (hist_kernel.LAUNCHES, sketch_kernel.LAUNCHES, segmax_kernel.LAUNCHES)
    engines = _stream_engines(dev, range(4))
    after = (hist_kernel.LAUNCHES, sketch_kernel.LAUNCHES, segmax_kernel.LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == (4, 8, 12)
    got, want = engines["cuda"], engines["torch"]
    for state in ("state", "sketch_state"):
        pairs = list(zip(tensor_leaves(getattr(got, state)),
                         tensor_leaves(getattr(want, state))))
        assert len(pairs) == 14
        for (name, a), (_, b) in pairs:
            assert a.is_cuda and torch.equal(a, b), name
    snap = got.snapshot()
    assert snap.overflow == 0 and snap.n_packets == 4 << 14


def test_stream_update_queues_without_a_host_sync(dev):
    """After a warm-up batch, folding a batch into both tiers reads nothing
    back to the host (``torch.cuda.set_sync_debug_mode("error")`` raises on
    any synchronizing call)."""
    from repro_torch.stream import update_state
    from repro_torch.core.sketch import update_sketch

    eng = _stream_engines(dev, range(1))["cuda"]
    batch = [torch.randint(0, 1 << 16, (1 << 14,), device=dev, dtype=torch.int32)
             for _ in range(2)] + [torch.zeros(1 << 14, dtype=torch.int32, device=dev)]
    n_valid = torch.full((), 1 << 14, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        update_state(eng.state, *batch, 1 << 14)
        update_sketch(eng.sketch_state, batch[0], batch[1], n_valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# --- the challenge's one-program path and its A/B baselines -------------------

@pytest.mark.parametrize("method,fused_epilogue",
                         [("hash", False), ("shuffle", False), ("hash", True)])
def test_fused_graph_replay_equals_the_phases(dev, tmp_path, method, fused_epilogue):
    """``run_challenge(fused=True)`` at scale 12: the CUDA graph's replay
    (build's device part, anonymize, analyze; the shuffle's generator
    registered and reseeded) equals the timed phases' results bit for bit,
    and its capture launched the histogram kernel (1 launch a program, 66
    with the fused epilogue's gated sums)."""
    from repro_torch.challenge.pipeline import ChallengeConfig, run_challenge
    from repro_torch.convert import results_to_numpy

    cfg = ChallengeConfig(scale=12, method=method, fused=True,
                          fused_epilogue=fused_epilogue, workdir=str(tmp_path),
                          device=str(dev))
    before = hist_kernel.LAUNCHES
    run = run_challenge(cfg)
    # warm pass, timed analyze, the eager program, the capture
    per_program = 1 + (2 * cfg.n_windows * 4 + 1 if fused_epilogue else 0)
    assert hist_kernel.LAUNCHES - before == 4 * per_program
    assert run.timings.fused_s > 0
    got, want = results_to_numpy(run.fused_results), results_to_numpy(run.results)
    assert got.keys() == want.keys() and len(got) == 50
    for key in want:
        assert (got[key] == want[key]).all(), key


def test_challenge_chain_runs_without_a_host_sync(dev):
    """Build's device part, anonymize (hash and shuffle) and analyze queue
    on the card with every synchronizing call an error, after a warm run
    (the kernels' setup runs once, outside)."""
    from repro_torch.challenge.pipeline import analyze
    from repro_torch.core.anonymize import anonymize
    from repro_torch.core.queries import traffic_matrix
    from repro_torch.core.table import Table

    n = 1 << 12
    cols = [torch.randint(0, n, (n,), dtype=torch.int32).pin_memory()
            for _ in range(2)] + [torch.randint(0, 8, (n,), dtype=torch.int32)
                                  .pin_memory()]
    static = [c.to(dev, non_blocking=True) for c in cols]

    def chain(method):
        table = Table(columns=dict(zip(("src", "dst", "win"), static)),
                      n_valid=torch.full((), n - 5, dtype=torch.int32, device=dev))
        traffic_matrix(table)
        gen = torch.Generator(device=dev).manual_seed(0)
        t = anonymize(table, gen if method == "shuffle" else None,
                      method=method).table
        return analyze(t, n_windows=8, ip_bins=1024, k=10, device=dev)

    for method in ("hash", "shuffle"):
        chain(method)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            chain(method)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def test_histogram_at_the_naive_overlap_shape(dev):
    """Shape (v): 2 x 2^24 int32 window ids, non-members -1, into 8 bins with
    no weights (``cross_window_ip_overlap_naive``): bit-equal to plain, one
    launch (counts of 1.0 are exact in float32 below 2^24)."""
    g = torch.Generator(device=dev).manual_seed(5)
    n = 2 << 24
    ids = torch.randint(0, 8, (n,), generator=g, device=dev, dtype=torch.int32)
    ids = torch.where(torch.rand(n, generator=g, device=dev) < 0.6, ids, -1)
    before = hist_kernel.LAUNCHES
    got = ops.histogram(ids, 8, backend="cuda")
    assert hist_kernel.LAUNCHES == before + 1
    want = ops.histogram(ids, 8, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got.double().sum()) == int((ids >= 0).sum())


# --- the fault-tolerant service ----------------------------------------------

def _service_capture(tmp_path):
    """A scale-12 RMAT capture of 2^12 packets as a plq of 8 row groups."""
    from repro_torch.challenge.pipeline import window_column
    from repro_torch.data.plq import write_plq
    from repro_torch.data.rmat import synthetic_packets

    cols = synthetic_packets(1 << 12, scale=12, seed=2)
    path = str(tmp_path / "cap.plq")
    write_plq(path, cols, row_group_size=1 << 9)
    return path, window_column(cols["ts"], 8)


def _service_cfg(dev, **kw):
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.stream import StreamConfig

    return StreamConfig(batch_capacity=1 << 9, link_capacity=1 << 12, tier="both",
                        sketch=SketchConfig(), device=str(dev), **kw)


def _assert_engines_equal(got, want):
    for state in ("state", "sketch_state"):
        pairs = list(zip(tensor_leaves(getattr(got, state)),
                         tensor_leaves(getattr(want, state))))
        assert len(pairs) == 14
        for (name, a), (_, b) in pairs:
            assert a.is_cuda and torch.equal(a, b), name


def test_service_folds_without_a_host_sync(dev, tmp_path, monkeypatch):
    """``run_service`` on the card, both tiers, a commit every 3 batches:
    every fold after the first runs with every synchronizing call an error;
    only the commits (and the final wait) may sync."""
    from repro_torch.stream import recovery, run_service

    path, win = _service_capture(tmp_path)
    save = recovery.StreamCheckpointer.save

    def unchecked_save(self, engine, watermark):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            return save(self, engine, watermark)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(recovery.StreamCheckpointer, "save", unchecked_save)
    seqs = []

    def on_batch(seq, _):
        seqs.append(seq)
        torch.cuda.set_sync_debug_mode("default" if seq == 7 else "error")

    try:
        report = run_service(_service_cfg(dev), path, win,
                             checkpoint_dir=str(tmp_path / "ck"),
                             checkpoint_every=3, on_batch=on_batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert seqs == list(range(8)) and report.health.checkpoints_committed == 3


def test_service_checkpoint_roundtrip_on_the_card(dev, tmp_path):
    """A card engine saved and restored: every leaf bit-equal, on the card."""
    from repro_torch.stream import StreamCheckpointer, StreamEngine, stream_plq

    path, win = _service_capture(tmp_path)
    cfg = _service_cfg(dev)
    eng = StreamEngine(cfg)
    stream_plq(eng, path, win)
    StreamCheckpointer(str(tmp_path / "ck"), cfg).save(eng, watermark=8)
    rp = StreamCheckpointer(str(tmp_path / "ck"), cfg).restore_latest()
    back = StreamEngine(cfg)
    back.load(rp.state, rp.sketch_state, rp.health)
    _assert_engines_equal(back, eng)


@pytest.mark.parametrize("crash_at", [0, 3, 7])
def test_service_crash_and_replay_on_the_card(dev, tmp_path, crash_at):
    """The chaos cocktail and a crash on the card: the recovered engine is
    bit-equal to ``stream_plq``'s, through the kernels."""
    from repro_torch.data.faults import FaultConfig, RetryPolicy
    from repro_torch.stream import StreamEngine, run_service, stream_plq

    path, win = _service_capture(tmp_path)
    cfg = _service_cfg(dev)
    before = hist_kernel.LAUNCHES
    report = run_service(cfg, path, win, checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=2, retry=RetryPolicy(base_backoff_s=0.0),
                         faults=FaultConfig(seed=11, transient_io_rate=0.25,
                                            corrupt_rate=0.25, duplicate_rate=0.2,
                                            reorder_rate=0.2, crash_at_batch=crash_at))
    replayed = crash_at + 1 - crash_at // 2 * 2
    assert hist_kernel.LAUNCHES - before == 8 + replayed
    assert report.health.batches_replayed == replayed and report.restarts == 1
    oracle = StreamEngine(cfg)
    stream_plq(oracle, path, win)
    _assert_engines_equal(report.engine, oracle)


# --- LM training ---------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv,lq,lkv,d,window", [
    (32, 8, 512, 512, 128, None),   # granite-8b's GQA, prefill
    (32, 8, 5, 2048, 128, None),    # a decode chunk against a long cache
    (36, 36, 256, 256, 64, 96),     # minicpm-2b's heads, a window
    (8, 2, 64, 40, 64, None),       # Lq > Lkv: rows that see no key
], ids=["granite-prefill", "granite-chunk", "minicpm-window", "empty-rows"])
def test_train_ref_attention_forward_unchanged(dev, hq, hkv, lq, lkv, d, window):
    """The differentiable plain attention gives, on the card, the values of
    the in-place ``repeat_interleave`` formulation it replaced, bit for bit
    in bfloat16: the yardstick of the serving checks did not move."""
    from _ref_attention_before import ref_attention_before
    from repro_torch.kernels.ref import ref_attention

    g = torch.Generator(device=dev).manual_seed(hq + lq)
    q, k, v = (torch.randn(2, h, n, d, generator=g, device=dev, dtype=torch.bfloat16)
               for h, n in ((hq, lq), (hkv, lkv), (hkv, lkv)))
    with torch.no_grad():
        got = ref_attention(q, k, v, window=window)
        want = ref_attention_before(q, k, v, window=window)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("hq,hkv,d,window", [(36, 36, 64, None), (32, 8, 128, None),
                                             (8, 2, 64, 96)],
                         ids=["minicpm", "granite-gqa", "gqa-window96"])
def test_train_attention_function_matches_plain_autograd(dev, hq, hkv, d, window):
    """``ops.attention`` under autograd runs the kernel as the forward of
    ``FlashAttention`` (one launch): each output row within 2^-7 relative
    L2 of the plain version's, and dq, dk, dv bit-equal to plain autograd's
    for the same upstream gradient (the same plain backward on the same
    inputs)."""
    from repro_torch.kernels.ref import ref_attention

    g = torch.Generator(device=dev).manual_seed(hq + d)
    q, k, v = (torch.randn(2, h, 320, d, generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
               for h in (hq, hkv, hkv))
    up = torch.randn(2, hq, 320, d, generator=g, device=dev, dtype=torch.bfloat16)
    before = fa_kernel.LAUNCHES
    out = ops.attention(q, k, v, window=window)
    assert fa_kernel.LAUNCHES == before + 1
    assert "FlashAttention" in type(out.grad_fn).__name__
    plain = ref_attention(q, k, v, window=window)
    rows = (out.float() - plain.float()).norm(dim=-1) / (plain.float().norm(dim=-1)
                                                          + 1e-6)
    assert rows.max().item() <= 2 ** -7
    got = torch.autograd.grad(out, (q, k, v), up)
    want = torch.autograd.grad(plain, (q, k, v), up)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    with torch.no_grad():  # serving: the kernel alone, no autograd node
        assert ops.attention(q, k, v, window=window).grad_fn is None


def _train_smoke(dev, ckpt_dir=None, seed=0):
    """minicpm's smoke config in bfloat16 with heads of 64 and remat, on the
    card, through the attention kernel."""
    import dataclasses

    from repro_torch.configs import minicpm_2b
    from repro_torch.convert import transformer_param_tree
    from repro_torch.models.transformer import Transformer, loss_fn
    from repro_torch.train import AdamWConfig, Trainer

    cfg = dataclasses.replace(minicpm_2b.smoke_config(), dtype=torch.bfloat16,
                              d_head=64, remat=True, kernel_backend="cuda")
    model = Transformer(cfg, device=dev, seed=seed)
    trainer = Trainer(lambda p, b: loss_fn(model, b["tokens"], b["labels"]),
                      AdamWConfig(warmup_steps=2, total_steps=10, schedule="wsd"),
                      ckpt_dir=ckpt_dir, ckpt_every=3)
    return cfg, trainer, trainer.init_state(transformer_param_tree(model))


def test_train_steps_without_a_host_sync(dev):
    """``Trainer.run`` for 7 steps, logging every third: each step that does
    not log (1, 2, 4, 5) runs under ``set_sync_debug_mode("error")``, its
    batch copy, forward, remat, backward and AdamW included; the kernel
    runs twice a layer a step (remat)."""
    from repro_torch.data.pipeline import lm_batches

    cfg, trainer, state = _train_smoke(dev)
    logged = []

    def feed():
        for i, batch in enumerate(lm_batches(2, 64, cfg.vocab)):
            torch.cuda.set_sync_debug_mode("error" if i % 3 else "default")
            yield batch

    before = fa_kernel.LAUNCHES
    try:
        trainer.run(state, feed(), 7, log_every=3,
                    log_fn=lambda step, hist: logged.append(hist))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fa_kernel.LAUNCHES - before == 2 * cfg.n_layers * 7
    assert [h["step"] for h in logged] == [0, 3, 6]
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in logged)


def test_train_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A trainer's bfloat16 weights and float32 moments committed from the
    card restore bit-equal into a new trainer's tensors on the card."""
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.train import tree_flatten

    cfg, trainer, state = _train_smoke(dev, str(tmp_path))
    state, _ = trainer.run(state, lm_batches(2, 64, cfg.vocab), 3, log_every=0)
    saved = [x.detach().clone() for x in tree_flatten(state.tree())[0]]
    _, trainer2, fresh = _train_smoke(dev, str(tmp_path), seed=1)
    restored, step = trainer2.maybe_resume(fresh)
    assert step == 3
    for a, b in zip(tree_flatten(restored.tree())[0], saved):
        assert a.is_cuda and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


# ----------------------------------------------------------------- the GNNs


def _tied(g, n, d, dev):
    """Values on a grid of 1/4: feature-wise maxima tie."""
    return torch.randn(n, d, generator=g, device=dev).mul_(4).round_().div_(4)


@pytest.mark.parametrize("n,d,segs", [(8192, 64, 4096), (8192, 1, 4096), (8192, 3, 4096),
                                      (10752, 1433, 2816), (168_960, 75, 170_496),
                                      (300_000, 128, 50_000)])
def test_gnn_segment_sum_function_matches_plain_autograd(dev, n, d, segs):
    """``SegmentSum`` (``ops.segment_reduce`` under autograd): integer-valued
    rows summed bit-equal to the plain path, one launch, and the rows'
    gradient bit-equal to plain autograd's for the same upstream gradient;
    dropped ids (negative, at and past the capacity) take 0."""
    g = torch.Generator(device=dev).manual_seed(n + d)
    ids = _rand(g, -2, segs + 3, n, dev)
    x = torch.randint(-8, 9, (n, d), generator=g, device=dev,
                      dtype=torch.float32).requires_grad_()
    before = segsum_kernel.LAUNCHES
    got = ops.segment_reduce(x, ids, segs)
    assert segsum_kernel.LAUNCHES == before + 1
    assert type(got.grad_fn).__name__ == "SegmentSumBackward"
    want = ops.segment_reduce(x, ids, segs, backend="torch")
    assert torch.equal(got, want)
    up = torch.randn(segs, d, generator=g, device=dev)
    got_grad = torch.autograd.grad(got, x, up)[0]
    assert torch.equal(got_grad, torch.autograd.grad(want, x, up)[0])
    assert not bool(got_grad[(ids < 0) | (ids >= segs)].any())


@pytest.mark.parametrize("n,d,segs", [(8192, 75, 4096), (8192, 1, 4096),
                                      (168_960, 75, 170_496), (100_000, 8, 2_000_000)])
def test_gnn_segment_max_function_matches_plain_autograd(dev, n, d, segs):
    """``SegmentMax``: the feature-wise max through the 1-D segment-max
    kernel over flattened ids bit-equal to the plain ``scatter_reduce_``,
    one launch; with ties planted (values on a grid), the rows' gradient
    bit-equal to plain autograd's tie split."""
    g = torch.Generator(device=dev).manual_seed(n + d + 1)
    ids = _rand(g, -2, segs + 3, n, dev)
    x = _tied(g, n, d, dev).requires_grad_()
    before = segmax_kernel.LAUNCHES
    got = ops.segment_reduce(x, ids, segs, op="max")
    assert segmax_kernel.LAUNCHES == before + 1
    assert type(got.grad_fn).__name__ == "SegmentMaxBackward"
    want = ops.segment_reduce(x, ids, segs, op="max", backend="torch")
    assert torch.equal(got, want)
    up = torch.randn(segs, d, generator=g, device=dev)
    assert torch.equal(torch.autograd.grad(got, x, up)[0],
                       torch.autograd.grad(want, x, up)[0])
    with torch.no_grad():  # no autograd: the kernel alone, the same result
        assert torch.equal(ops.segment_reduce(x, ids, segs, op="max"), want)


def _molecule_graph(dev, config, seed=0):
    """The molecule shape on the card: 128 graphs of 30 nodes and 64 edges,
    the padding nodes' graph id 128; the batch of the arch's loss."""
    from repro_torch.configs.common_gnn import GNN_SHAPES
    from repro_torch.models.gnn import Graph

    info = GNN_SHAPES["molecule"]
    n, e, graphs = info["n_nodes"], info["n_edges"], info["n_graphs"]
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.arange(graphs, device=dev, dtype=torch.int32).repeat_interleave(64) * 30
    s, r = (base + _rand(g, 0, 30, e, dev) for _ in range(2))
    nodes = (_rand(g, 1, 10, n, dev)[:, None] if config == "schnet"
             else torch.randn(n, info["d_feat"], generator=g, device=dev))
    graph = Graph(nodes=nodes, senders=s, receivers=r,
                  positions=torch.randn(n, 3, generator=g, device=dev),
                  graph_ids=torch.clamp(torch.arange(n, device=dev,
                                                     dtype=torch.int32) // 30, max=graphs),
                  n_graphs=graphs)
    if config == "graphsage_reddit":
        return graph, (torch.arange(n, device=dev, dtype=torch.int32),
                       torch.zeros(n, device=dev, dtype=torch.int32))
    # targets away from the initial outputs: no loss near 0 (chip_smoke.py)
    return graph, (1 + 0.1 * torch.randn(graphs, 1, generator=g, device=dev),)


@pytest.mark.parametrize("config", ["schnet", "pna", "egnn", "graphsage_reddit"])
def test_gnn_train_steps_without_a_host_sync(dev, config):
    """Three training steps of the arch's cell at the molecule shape, at
    its published widths, each under ``set_sync_debug_mode("error")`` after
    a first step (builds, binds, cuBLAS): the kernels' launches as the code
    implies them, and the first step's loss within 1e-4 of the plain
    path's from the same weights."""
    import importlib

    from repro_torch.configs.common_gnn import GNN_SHAPES, init_train_state
    from repro_torch.kernels.launches import read_launches, reset_launches

    spec = importlib.import_module(f"repro_torch.configs.{config}").SPEC
    cfg = spec.make_cfg(GNN_SHAPES["molecule"])
    graph, batch = _molecule_graph(dev, config)
    losses = {}
    for backend in ("torch", "auto"):
        state = init_train_state(spec.init_fn(torch.Generator(device=dev).manual_seed(0),
                                              cfg))
        step = spec.step_fn("molecule", backend=backend)
        losses[backend] = step(state.params, state.opt, graph, *batch)[2]["loss"].item()
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = [step(state.params, state.opt, graph, *batch)[2] for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = {k: v for k, v in read_launches().items() if v}
    sums = {"schnet": 4, "pna": 1 + 4 * 4 + 2, "egnn": 3 * 4 + 2,
            "graphsage_reddit": 4}[config]
    want = {"segment_matmul": 3 * sums}
    if config == "pna":
        want["segment_max"] = 3 * 2 * 4
    assert launches == want
    assert all(torch.isfinite(m["loss"]) for m in metrics)
    assert int(state.opt["step"]) == 4
    assert abs(losses["auto"] - losses["torch"]) <= 1e-4 * max(abs(losses["torch"]), 1e-30)


@pytest.mark.parametrize("config", ["schnet", "pna", "egnn", "graphsage_reddit"])
def test_gnn_config_smoke_on_the_card(dev, config):
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.{config}")
    before = segsum_kernel.LAUNCHES
    assert mod.smoke() == mod.smoke("cpu")
    assert segsum_kernel.LAUNCHES > before


# ------------------------------------------------------ MoE and xDeepFM serving

def test_moe_layer_kernel_equals_plain(dev):
    """One MoE layer in bfloat16 at a mixtral-like shape (8 experts, top 2,
    rows dropped), global and batched dispatch: the combine on the
    segment-sum kernel equals the plain ``index_add_`` bit for bit (a
    token's two rows, summed in float32, round once to bfloat16 either
    way), one launch a call, no host sync."""
    from repro_torch.models import moe as M

    g = torch.Generator(device=dev).manual_seed(0)
    for dispatch in ("global", "batched"):
        cfg = M.MoEConfig(n_experts=8, top_k=2, d_ff=256, capacity_factor=0.75,
                          dense_residual_d_ff=128, dispatch=dispatch)
        p = M.moe_init(g, cfg, 128, dtype=torch.bfloat16)
        x = torch.randn(3, 200, 128, generator=g, device=dev, dtype=torch.bfloat16)
        want, wm = M.moe_apply_grouped(p, cfg, x, backend="torch")
        torch.cuda.synchronize()
        before = segsum_kernel.LAUNCHES
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, gm = M.moe_apply_grouped(p, cfg, x, backend="cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert segsum_kernel.LAUNCHES == before + 1
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        assert int(gm["dropped_tokens"]) == int(wm["dropped_tokens"]) > 0
        assert torch.equal(gm["aux_loss"], wm["aux_loss"])


@pytest.mark.parametrize("config", ["mixtral_8x7b", "arctic_480b"])
def test_moe_serving_kernel_matches_plain_without_a_host_sync(dev, config):
    """Each MoE smoke config in bfloat16 with heads of 128 (the kernel's;
    the smoke configs' are 8): a prompt of 40 tokens (past mixtral's window
    of 8) into a 64-slot cache and 8 decode steps through the attention
    and segment-sum kernels, once to warm up, then again with every host
    sync an error; the same through the plain path.  One launch of each
    kernel a layer a call; logits within 3e-2 relative L2 (bf16 rounding
    of P in the attention kernel, through two layers)."""
    import dataclasses
    import importlib

    from repro_torch.kernels.launches import read_launches, reset_launches
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(
        importlib.import_module(f"repro_torch.configs.{config}").smoke_config(),
        dtype=torch.bfloat16, d_head=128)
    tokens = torch.randint(0, cfg.vocab, (2, 48), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    def run(model):
        cache = model.init_kv_cache(2, 64)
        logits, cache = model.prefill(tokens[:, :40], cache)
        out = [logits]
        for i in range(40, 48):
            logits, cache = model.decode_step(tokens[:, i], cache)
            out.append(logits)
        return torch.stack(out).float()

    runs = {}
    for backend in ("cuda", "torch"):
        model = Transformer(dataclasses.replace(cfg, kernel_backend=backend),
                            device="cuda", seed=0)
        run(model)
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runs[backend] = (run(model), read_launches())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    calls = cfg.n_layers * 9
    assert {k: v for k, v in runs["cuda"][1].items() if v} == {
        "flash_attention": calls, "segment_matmul": calls}
    assert not any(runs["torch"][1].values())
    got, want = runs["cuda"][0], runs["torch"][0]
    assert bool(torch.isfinite(got).all())
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    assert rel < 3e-2, rel


def test_embedding_bag_kernel_equals_plain(dev):
    """``embedding_bag`` on the segment-sum kernel: 4,096 bags of 39 ids,
    width 10, with dropped bag ids, every mode; integer-valued tables and
    weights, so float sums are exact in any order: bit-equal to the plain
    ``index_add_``."""
    from repro_torch.models.recsys import embedding_bag

    g = torch.Generator(device=dev).manual_seed(2)
    table = torch.randint(-8, 9, (100_000, 10), generator=g, device=dev).float()
    n = 4096 * 39
    idx = torch.randint(0, 100_000, (n,), generator=g, device=dev)
    bags = torch.arange(n, device=dev) // 39
    bags[::97] = -1
    bags[1::101] = 4096
    w = torch.randint(-3, 4, (n,), generator=g, device=dev).float()
    for mode in ("sum", "mean"):
        for weights in (None, w):
            before = segsum_kernel.LAUNCHES
            got = embedding_bag(table, idx, bags, 4096, weights, mode, backend="cuda")
            assert segsum_kernel.LAUNCHES == before + (2 if mode == "mean" else 1)
            want = embedding_bag(table, idx, bags, 4096, weights, mode, backend="torch")
            torch.cuda.synchronize()
            assert torch.equal(got, want), (mode, weights is None)


def test_xdeepfm_serve_p99_on_the_card(dev):
    """xDeepFM's ``serve_p99`` step at the published size (38,190,000 table
    rows drawn on the card): 512 rows, one gathered row a field (no
    segment-sum launch; every host sync an error after a first call), equal
    to the same step on the CPU, which ``test_torch_recsys.py`` holds to
    the reference; the config's ``smoke()`` on the card."""
    from repro_torch.configs import xdeepfm
    from repro_torch.data.pipeline import recsys_batches
    from repro_torch.models.recsys import xdeepfm_init

    params = xdeepfm_init(torch.Generator(device=dev).manual_seed(0), xdeepfm.CFG)
    ids = torch.from_numpy(next(recsys_batches(512, 39, xdeepfm.CFG.field_vocabs()))
                           ["sparse_ids"]).to(dev)
    serve = xdeepfm.serve_fn("serve_p99")
    serve(params, ids)
    torch.cuda.synchronize()
    before = segsum_kernel.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = serve(params, ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert segsum_kernel.LAUNCHES == before
    def on_cpu(t):
        if isinstance(t, dict):
            return {k: on_cpu(v) for k, v in t.items()}
        return [on_cpu(v) for v in t] if isinstance(t, list) else t.cpu()

    want = serve(on_cpu(params), ids.cpu())
    assert got.shape == (512,) and bool(((got > 0) & (got < 1)).all())
    assert torch.allclose(got.cpu(), want, rtol=1e-6, atol=1e-7)
    del params
    assert math.isfinite(xdeepfm.smoke()["loss"])


@pytest.mark.parametrize("config", ["mixtral_8x7b", "arctic_480b"])
def test_moe_train_step_through_both_kernels_without_a_host_sync(dev, config):
    """The train_4k cell's step (``lm_spec``) on each MoE smoke config with
    heads of 128 (the kernel's; the smoke configs' are 8) and remat, 2 x 32
    tokens: a first step (builds, cuBLAS), then two with every host sync an
    error, through the attention and segment-sum kernels (each launched
    twice a layer a step: forward and recompute); the same three steps from
    the same weights through the plain path: each loss within 1e-4
    relative (float32; the kernels sum in other orders)."""
    import dataclasses
    import importlib

    from repro_torch.configs import SINGLE_POD
    from repro_torch.configs.common import lm_spec
    from repro_torch.convert import transformer_param_tree
    from repro_torch.kernels.launches import read_launches, reset_launches
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import adamw_init

    mod = importlib.import_module(f"repro_torch.configs.{config}")
    cfg = dataclasses.replace(mod.smoke_config(), d_head=128, remat=True)
    cell = lm_spec(mod.ARCH_ID, lambda: cfg, mod.smoke_config,
                   False).build_cell("train_4k", SINGLE_POD)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (3, 2, 33), generator=g, device=dev)
    runs = {}
    for backend in ("cuda", "torch"):
        model = Transformer(dataclasses.replace(cfg, kernel_backend=backend),
                            device=dev, seed=0)
        opt = adamw_init(transformer_param_tree(model))
        losses, launches = [], []
        for i in range(3):
            torch.cuda.synchronize()
            reset_launches()
            torch.cuda.set_sync_debug_mode("error" if i else "default")
            try:
                model, opt, m = cell.step_fn(model, opt, toks[i, :, :-1], toks[i, :, 1:])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            launches.append({k: v for k, v in read_launches().items() if v})
            losses.append(m["loss"].item())
        runs[backend] = (losses, launches)
    want = {"flash_attention": 2 * cfg.n_layers, "segment_matmul": 2 * cfg.n_layers}
    assert runs["cuda"][1] == [want] * 3 and runs["torch"][1] == [{}] * 3
    assert all(math.isfinite(x) for x in runs["cuda"][0])
    for got, plain in zip(runs["cuda"][0], runs["torch"][0]):
        assert abs(got - plain) <= 1e-4 * abs(plain), (runs["cuda"][0], runs["torch"][0])


def test_xdeepfm_train_cell_on_the_card(dev):
    """xDeepFM's train_batch cell at the smoke widths (``CFG`` patched),
    512 rows: a first step, then two with every host sync an error, no
    kernel launch (the lookups are gathers); the same three steps on the
    CPU from the same weights, which ``test_torch_configs.py`` holds to the
    reference: each loss and norm within 1e-5 relative, the weights within
    1e-5 relative or twice the steps' learning rates (a table row's
    gradient sums in another order: ``index_add_`` with atomics)."""
    from repro_torch.configs import SINGLE_POD, xdeepfm
    from repro_torch.models.recsys import XDeepFMConfig, xdeepfm_init
    from repro_torch.train import adamw_init, tree_flatten, tree_unflatten

    cfg = XDeepFMConfig(name="xdeepfm", n_sparse=6, embed_dim=8, cin_layers=(16, 16),
                        mlp_dims=(32,), vocab_sizes=(64,) * 6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(xdeepfm, "CFG", cfg)
        cell = xdeepfm.build_cell("train_batch", SINGLE_POD)
        g = torch.Generator().manual_seed(3)
        ids = torch.randint(0, 64, (3, 512, 6), generator=g, dtype=torch.int32)
        labels = torch.randint(0, 2, (3, 512), generator=g).float()
        start = xdeepfm_init(torch.Generator().manual_seed(0), cfg)
        runs = {}
        for where in (dev, torch.device("cpu")):
            leaves, treedef = tree_flatten(start)
            params = tree_unflatten(treedef, [x.clone().to(where) for x in leaves])
            opt = adamw_init(params)
            batch = (ids.to(where), labels.to(where))
            before = segsum_kernel.LAUNCHES
            metrics = []
            for i in range(3):
                if where.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error" if i else "default")
                try:
                    params, opt, m = cell.step_fn(params, opt, batch[0][i], batch[1][i])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                metrics.append({k: v.item() for k, v in m.items()})
            assert segsum_kernel.LAUNCHES == before
            runs[where.type] = (metrics, [x.detach().cpu() for x in tree_flatten(params)[0]])
    (got_m, got_p), (want_m, want_p) = runs["cuda"], runs["cpu"]
    for a, b in zip(got_m, want_m):
        assert a["lr"] == b["lr"]
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a, b)
    lr = sum(m["lr"] for m in want_m)
    for a, b in zip(got_p, want_p, strict=True):
        assert bool(((a - b).abs() <= torch.maximum(1e-5 * b.abs(),
                                                    torch.tensor(2 * lr))).all())
