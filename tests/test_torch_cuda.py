"""The CUDA kernels (histogram, segment max, Count-Min) against their plain
versions, on the card.

These tests need an NVIDIA card and ``nvcc``: they carry the ``cuda``
marker and skip without a card.  Run them on a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (the card's machine has no JAX).
"""
import itertools

import pytest
import torch

from repro_torch.kernels import histogram as hist_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import segreduce as segmax_kernel
from repro_torch.kernels import sketch as sketch_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(g, lo, hi, n, dev):
    return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int32)


@pytest.mark.parametrize("num_bins", [1, 1000, 12288, 20000])  # shared + global
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


@pytest.mark.parametrize("num_segments", [1, 4096, 12288, 20000])  # shared + global
@pytest.mark.parametrize("with_init,gated,masked",
                         list(itertools.product([False, True], repeat=3)))
def test_segment_max_kernel_matches_plain(dev, num_segments, with_init, gated,
                                          masked):
    g = torch.Generator(device=dev).manual_seed(num_segments + 7)
    n = 50_000
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


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("width", [4096, 20000])  # the default width and a wider one
@pytest.mark.parametrize("n", [0, 1, 32768])
def test_cms_kernel_matches_plain(dev, dtype, width, n):
    g = torch.Generator(device=dev).manual_seed(width + n)
    depth = 4
    counts = _rand(g, 0, 1 << 26, depth * width, dev).reshape(depth, width).to(dtype)
    cols = _rand(g, -1, width + 3, depth * n, dev).reshape(depth, n)
    props = _rand(g, 0, 1 << 27, n, dev)
    got = ops.cms_update(counts, cols, props, backend="cuda")
    want = ops.cms_update(counts, cols, props, backend="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


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
