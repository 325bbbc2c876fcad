"""The port's sketch tier (``repro_torch.core.sketch``) against
``repro.core.sketch`` on numpy-seeded batches: the uint32 hash family bit
for bit, ``top_k``'s lowest-index tie rule, three ``update_sketch`` folds
from one starting state (carried across by ``convert.sketch_state_from_numpy``)
giving bit-equal Count-Min cells, HyperLogLog registers and heavy-hitter
tables, the snapshot's estimates (HLL cardinalities to float32 tolerance),
and padding and weights."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import x64_shim  # noqa: F401  (fixture)
from repro.core import ops as jops
from repro.core import sketch as jsk
from repro_torch.convert import results_to_numpy, sketch_state_from_numpy
from repro_torch.core import ops
from repro_torch.core import sketch as sk

pytestmark = pytest.mark.usefixtures("x64_shim")

U32 = 1 << 32
CFG = dict(cms_depth=3, cms_width=128, hll_p=6, heavy_capacity=8, seed=5)
CAP = 256


def _words(seed, n=500):
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, 2, 3, (1 << 31) - 1, 1 << 31, U32 - 2, U32 - 1])
    return np.concatenate([edge, rng.integers(0, U32, n)]).astype(np.int64)


def _ids(seed, n=500):
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, -1, 2 ** 31 - 1, -(2 ** 31)], np.int32)
    return np.concatenate([edge, rng.integers(-2 ** 31, 2 ** 31 - 1, n)]).astype(np.int32)


def _u(x):
    return np.asarray(x).astype(np.int64)


def test_hashes_match_reference():
    src, dst = _ids(1), _ids(2)
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    for salt in (0, 7, 0x85EBCA6B * 3 + 0x9E3779B9, 2 ** 40 + 3):
        np.testing.assert_array_equal(sk._hash_src(ts, salt).numpy(),
                                      _u(jsk._hash_src(js, salt)))
        np.testing.assert_array_equal(sk._hash_link(ts, td, salt).numpy(),
                                      _u(jsk._hash_link(js, jd, salt)))
    for depth, width in ((3, 128), (4, 4096), (2, 1000)):
        got = sk._link_rows(ts, td, 11, depth, width)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsk._link_rows(js, jd, 11, depth, width)))
        np.testing.assert_array_equal(
            sk._src_rows(ts, 11, depth, width).numpy(),
            np.asarray(jsk._src_rows(js, 11, depth, width)))


def test_floor_log2_at_powers_of_two():
    x = sorted({v for k in range(32) for v in ((1 << k) - 1, 1 << k, (1 << k) + 1)
                if 0 < v < U32} | {U32 - 1})
    x = np.array(x, np.int64)
    got = sk._floor_log2_u32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.floor(np.log2(x.astype(np.float64))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsk._floor_log2_u32(jnp.asarray(x.astype(np.uint32)))))


@pytest.mark.parametrize("p", [4, 6, 12, 18])
def test_hll_parts_match_reference(p):
    h = _words(3)
    zero_residual = np.array([0, 1 << (32 - p), 5 << (32 - p), U32 - (1 << (32 - p))])
    h = np.concatenate([h, zero_residual]) % U32
    reg, rho = sk._hll_parts(torch.from_numpy(h), p)
    jreg, jrho = jsk._hll_parts(jnp.asarray(h.astype(np.uint32)), p)
    assert reg.dtype == rho.dtype == torch.int32
    np.testing.assert_array_equal(reg.numpy(), np.asarray(jreg))
    np.testing.assert_array_equal(rho.numpy(), np.asarray(jrho))
    assert (rho.numpy()[-4:] == 32 - p + 1).all()


@pytest.mark.parametrize("use_mask", [False, True])
def test_top_k_ties_go_to_the_lowest_index(use_mask):
    v = np.array([3, 9, 9, 1, 9, 0, 9, 4, 3], np.int32)
    mask = np.array([1, 1, 0, 1, 1, 1, 1, 0, 1], bool) if use_mask else None
    for k in (1, 3, 5, 20):
        got = ops.top_k(torch.from_numpy(v), k,
                        None if mask is None else torch.from_numpy(mask))
        want = jops.top_k(jnp.asarray(v), k, None if mask is None else jnp.asarray(mask))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    vals, idx, _ = ops.top_k(torch.from_numpy(v), 4)
    assert idx.tolist() == [1, 2, 4, 6]


def _batch(seed, n_valid, weighted=False):
    """Skewed keys, so the heavy-hitter tables fill and evict; garbage in the
    padding rows."""
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.5, CAP) % 40).astype(np.int32)
    dst = (rng.zipf(1.5, CAP) % 30 + 1000).astype(np.int32)
    src[n_valid:] = rng.integers(0, 10, CAP - n_valid)
    w = rng.integers(1, 5, CAP).astype(np.int32) if weighted else None
    return src, dst, w


def _state_arrays(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state) if f.name != "seed"}


@pytest.mark.parametrize("jax_backend", ["xla", "interpret"])
def test_three_batches_fold_bit_equal(jax_backend):
    jstate = jsk.init_sketch(jsk.SketchConfig(**CFG))
    for i, (n_valid, weighted) in enumerate(((CAP, False), (200, True), (17, False))):
        src, dst, w = _batch(10 + i, n_valid, weighted)
        state = sketch_state_from_numpy(_state_arrays(jstate), jstate.seed,
                                        device="cpu")
        got = sk.update_sketch(
            state, torch.from_numpy(src), torch.from_numpy(dst), n_valid,
            weights=None if w is None else torch.from_numpy(w))
        jstate = jsk.update_sketch(
            jstate, jnp.asarray(src), jnp.asarray(dst), n_valid,
            weights=None if w is None else jnp.asarray(w), backend=jax_backend)
        want = _state_arrays(jstate)
        for name, arr in _state_arrays(got).items():
            assert arr.dtype == want[name].dtype and arr.shape == want[name].shape, name
            np.testing.assert_array_equal(arr, want[name], err_msg=f"{name}, batch {i}")
        assert got.seed == jstate.seed
    assert int(jstate.hh_src_offset) > 0  # the summaries evicted on the way


def _folded(weighted=True):
    jstate = jsk.init_sketch(jsk.SketchConfig(**CFG))
    state = sk.init_sketch(sk.SketchConfig(**CFG), device="cpu")
    for i in range(3):
        src, dst, w = _batch(20 + i, CAP - 10 * i, weighted)
        state = sk.update_sketch(state, torch.from_numpy(src), torch.from_numpy(dst),
                                 CAP - 10 * i, weights=torch.from_numpy(w))
        jstate = jsk.update_sketch(jstate, jnp.asarray(src), jnp.asarray(dst),
                                   CAP - 10 * i, weights=jnp.asarray(w), backend="xla")
    return state, jstate


def test_snapshot_matches_reference():
    state, jstate = _folded()
    got = results_to_numpy(sk.snapshot_sketch(state, k=5))
    want = results_to_numpy(jsk.snapshot_sketch(jstate, k=5))
    assert got.keys() == want.keys()
    for key in want:
        if key.startswith("unique_"):  # HLL sums 2^-register in another order
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for regs in (state.hll_src, state.hll_links, torch.zeros(16), torch.full((64,), 3.0)):
        np.testing.assert_allclose(sk.hll_cardinality(regs).numpy(),
                                   np.asarray(jsk.hll_cardinality(jnp.asarray(regs.numpy()))),
                                   rtol=1e-6)


def test_update_ignores_padding_and_counts_weights():
    cfg = sk.SketchConfig(**CFG)
    src = torch.tensor([1, 2, 2, 9, 9], dtype=torch.int32)
    dst = torch.tensor([5, 6, 6, 9, 9], dtype=torch.int32)
    weighted = sk.update_sketch(sk.init_sketch(cfg, device="cpu"), src, dst, 3,
                                weights=torch.tensor([2, 1, 3, 7, 7], dtype=torch.int32))
    # the same traffic one row per packet, padded with other garbage
    src2 = torch.tensor([1, 1, 2, 2, 2, 2, 4, 4], dtype=torch.int32)
    dst2 = torch.tensor([5, 5, 6, 6, 6, 6, 4, 4], dtype=torch.int32)
    unrolled = sk.update_sketch(sk.init_sketch(cfg, device="cpu"), src2, dst2, 6)
    for f in dataclasses.fields(sk.SketchState):
        a, b = getattr(weighted, f.name), getattr(unrolled, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert int(weighted.n_packets) == 6
    assert int(sk.estimate_source_packets(weighted, src[:2])[1]) >= 4
