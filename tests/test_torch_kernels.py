"""The port's histogram family on the CPU: its plain PyTorch version against
the reference's plain version (``repro.kernels.ref`` / the XLA path) and
against the Pallas kernel body run in interpret mode, for every epilogue
combination; plus the dispatch contract.  Integer-valued inputs, so every
comparison is bit-equal.  The CUDA kernel itself is held against the plain
version on the card in tests/test_torch_cuda.py and chip_smoke.py."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.histogram import histogram_pallas
from repro_torch.kernels import histogram as hist_kernel
from repro_torch.kernels import ops

N, BINS = 300, 50


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        ids=rng.integers(-3, BINS + 3, N).astype(np.int32),  # incl. out of range
        w=rng.integers(0, 5, N).astype(np.int32),
        gate=rng.integers(0, 4, N).astype(np.int32),
        init=rng.integers(-2, 7, BINS).astype(np.int32),
        mask=rng.random(BINS) < 0.7,
    )


def _assert_same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


COMBOS = list(itertools.product([False, True], repeat=3))  # init, gate, mask


@pytest.mark.parametrize("with_init,gated,masked", COMBOS)
def test_histogram_plain_matches_reference_and_pallas(with_init, gated, masked):
    x = _inputs(1 + 4 * with_init + 2 * gated + masked)
    kw = {}
    if with_init:
        kw["init"] = x["init"].astype(np.float32)
    if gated:
        kw.update(gate_ids=x["gate"], gate_value=2)
    if masked:
        kw.update(valid_mask=x["mask"], retire=-1.5)
    w = x["w"].astype(np.float32)
    got = ops.histogram(torch.from_numpy(x["ids"]), BINS, torch.from_numpy(w),
                        backend="torch",
                        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                           else v for k, v in kw.items()})
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ids, jw = jnp.asarray(x["ids"]), jnp.asarray(w)
    _assert_same(got, jax_ops.histogram(ids, BINS, jw, backend="xla", **jkw))
    _assert_same(got, histogram_pallas(ids, BINS, jw, interpret=True, **jkw))


@pytest.mark.parametrize("out_dtype", [None, "int32"])
@pytest.mark.parametrize("with_init,gated,masked", COMBOS)
def test_segmented_sum_plain_matches_reference_and_pallas(
        out_dtype, with_init, gated, masked):
    x = _inputs(11 + gated + 2 * masked + 4 * with_init + 8 * (out_dtype is not None))
    kw = {"init": x["init"]} if with_init else {}
    if gated:
        kw.update(gate_ids=x["gate"], gate_value=1)
    if masked:
        kw.update(valid_mask=x["mask"],
                  retire=-(2 ** 31) if out_dtype else -4.0)
    got = ops.segmented_reduce(
        torch.from_numpy(x["w"]), torch.from_numpy(x["ids"]), BINS, op="sum",
        out_dtype=getattr(torch, out_dtype) if out_dtype else None,
        backend="torch",
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    vals, seg = jnp.asarray(x["w"]), jnp.asarray(x["ids"])
    jdt = getattr(jnp, out_dtype) if out_dtype else None
    want = jax_ref.ref_segmented_reduce(vals, seg, BINS, "sum", out_dtype=jdt,
                                        **jkw)
    assert got.dtype == (torch.int32 if out_dtype else torch.float32)
    _assert_same(got, want)
    _assert_same(got, jax_ops.segmented_reduce(
        vals, seg, BINS, op="sum", out_dtype=jdt, backend="interpret", **jkw))


def test_histogram_unweighted_and_empty():
    ids = np.random.default_rng(5).integers(0, BINS, 777).astype(np.int32)
    got = ops.histogram(torch.from_numpy(ids), BINS)
    np.testing.assert_array_equal(got.numpy(), np.bincount(ids, minlength=BINS))
    init = torch.arange(BINS, dtype=torch.float32)
    mask = torch.arange(BINS) % 2 == 0
    empty = ops.histogram(torch.empty(0, dtype=torch.int32), BINS, init=init,
                          valid_mask=mask, retire=9.0)
    np.testing.assert_array_equal(
        empty.numpy(), np.where(mask.numpy(), init.numpy(), 9.0))


def test_windowed_histogram_matches_reference():
    rng = np.random.default_rng(7)
    win = rng.integers(-1, 5, 400).astype(np.int32)
    ids = rng.integers(-1, 33, 400).astype(np.int32)
    w = rng.integers(0, 3, 400).astype(np.float32)
    got = ops.windowed_histogram(torch.from_numpy(win), torch.from_numpy(ids),
                                 4, 32, torch.from_numpy(w))
    want = jax_ops.windowed_histogram(jnp.asarray(win), jnp.asarray(ids), 4, 32,
                                      jnp.asarray(w), backend="xla")
    _assert_same(got, want)


def test_auto_dispatch_takes_the_plain_version_for_cpu_tensors():
    before = hist_kernel.LAUNCHES
    ops.histogram(torch.zeros(4, dtype=torch.int32), 3)
    assert hist_kernel.LAUNCHES == before


def test_cuda_backend_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.histogram(torch.zeros(4, dtype=torch.int32), 3, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        hist_kernel.histogram_cuda(torch.zeros(4, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.histogram(torch.zeros(4, dtype=torch.int32), 3, backend="xla")


def test_segment_max_is_not_ported_yet():
    for backend in ("auto", "torch", "cuda"):
        with pytest.raises(NotImplementedError, match="queue 2 item 2"):
            ops.segmented_reduce(torch.ones(3), torch.zeros(3, dtype=torch.int32),
                                 2, op="max", backend=backend)
