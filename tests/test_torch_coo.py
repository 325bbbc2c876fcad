"""The streaming engine's primitives in the port against ``repro.core`` on
numpy-seeded inputs: ``multi_key_sort`` by three and four keys (prefix
validity and a ``valid_mask``, keys at ``INT32_MAX`` and ``INT32_MIN``
among the live rows), ``isin``, ``unique_concat(positions=)``,
``from_coo`` under each op with one- and two-column row keys and both
truncations, ``ewise_union`` and ``merge_sketches``.  Outputs compare bit
for bit, tails included, except a sort's tail, which the reference leaves
undefined with three or more keys."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import x64_shim  # noqa: F401  (fixture)
from repro.core import ops as jops
from repro.core import plan as jplan
from repro.core import sketch as jsk
from repro.core import sparse as jsparse
from repro_torch.convert import results_to_numpy, sketch_state_from_numpy
from repro_torch.core import ops, plan, sparse
from repro_torch.core import sketch as sk
from repro_torch.core.plan import SortCounter

pytestmark = pytest.mark.usefixtures("x64_shim")

I32 = np.iinfo(np.int32)


def _keys(seed, n_keys, cap=300, hi=6):
    """Narrow keys (many ties) with int32 extremes planted among them."""
    rng = np.random.default_rng(seed)
    keys = [rng.integers(-hi, hi, cap).astype(np.int32) for _ in range(n_keys)]
    for k in keys:
        k[rng.integers(0, cap, 12)] = I32.max
        k[rng.integers(0, cap, 12)] = I32.min
    for k in keys:  # rows whose every key is INT32_MAX: the sentinel's twin
        k[:3] = I32.max
    return keys


def _mask(seed, cap=300):
    return np.random.default_rng(seed).random(cap) < 0.7


def _np(x):
    return {k: np.asarray(v) for k, v in x.items()}


@pytest.mark.parametrize("n_keys", [3, 4])
@pytest.mark.parametrize("validity", ["prefix", "mask", "none"])
def test_multi_key_sort_three_and_four_keys(n_keys, validity):
    keys = _keys(n_keys, n_keys)
    cap = len(keys[0])
    pay = np.arange(cap, dtype=np.int32)
    kw, jkw, n_live, live = {}, {}, cap, np.ones(cap, bool)
    if validity == "prefix":
        n_live = 211
        live = np.arange(cap) < n_live
        kw, jkw = dict(n_valid=n_live), dict(n_valid=jnp.int32(n_live))
    elif validity == "mask":
        live = _mask(n_keys)
        n_live = int(live.sum())
        kw, jkw = (dict(valid_mask=torch.from_numpy(live)),
                   dict(valid_mask=jnp.asarray(live)))
    with SortCounter() as c:
        got_k, (got_p,) = ops.multi_key_sort([torch.from_numpy(k) for k in keys],
                                             [torch.from_numpy(pay)], **kw)
    assert c.n == 2  # one stable pass per pair of keys (the lone key sorts first)
    want_k, (want_p,) = jops.multi_key_sort([jnp.asarray(k) for k in keys],
                                            [jnp.asarray(pay)], **jkw)
    for g, w in zip(got_k, want_k):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy()[:n_live], np.asarray(w)[:n_live])
    np.testing.assert_array_equal(got_p.numpy()[:n_live], np.asarray(want_p)[:n_live])
    # the live rows, stably sorted: numpy's lexsort of them
    rows = np.flatnonzero(live)
    order = rows[np.lexsort([k[rows] for k in reversed(keys)])]
    np.testing.assert_array_equal(got_p.numpy()[:n_live], order)
    assert set(got_p.numpy()[n_live:]) == set(np.flatnonzero(~live))


def test_multi_key_sort_keeps_the_one_and_two_key_paths():
    keys = _keys(7, 2)
    live = _mask(7)
    with SortCounter() as c:
        for n in (1, 2):
            ops.multi_key_sort([torch.from_numpy(k) for k in keys[:n]],
                               valid_mask=torch.from_numpy(live))
    assert c.n == 2
    with pytest.raises(ValueError):
        ops.multi_key_sort([])


def test_isin_matches_reference():
    rng = np.random.default_rng(3)
    uniq = np.unique(rng.integers(-50, 50, 40)).astype(np.int32)
    n_u = len(uniq) - 5
    table = np.concatenate([uniq, np.full(64 - len(uniq), I32.max, np.int32)])
    x = np.concatenate([rng.integers(-60, 60, 180), [I32.max, I32.min, uniq[-1]]]
                       ).astype(np.int32)
    for n_valid in (None, 150, 0):
        got = ops.isin(torch.from_numpy(x), torch.from_numpy(table), n_u,
                       n_valid=n_valid)
        want = jops.isin(jnp.asarray(x), jnp.asarray(table), jnp.int32(n_u),
                         n_valid=None if n_valid is None else jnp.int32(n_valid))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy().any()


@pytest.mark.parametrize("n_valid", [0, 1, 97, 128])
def test_unique_concat_first_positions_match_reference(n_valid):
    rng = np.random.default_rng(n_valid)
    a, b = (rng.integers(0, 40, 128).astype(np.int32) for _ in range(2))
    rows = np.arange(128, dtype=np.int32)
    pos = np.concatenate([2 * rows, 2 * rows + 1])
    got = plan.unique_concat(torch.from_numpy(a), torch.from_numpy(b), n_valid,
                             positions=torch.from_numpy(pos), count_name=None)
    want = jplan.unique_concat(jnp.asarray(a), jnp.asarray(b), jnp.int32(n_valid),
                               positions=jnp.asarray(pos), count_name=None)
    np.testing.assert_array_equal(got.keys[0].numpy(), np.asarray(want.keys[0]))
    np.testing.assert_array_equal(got.aggs["first_pos"].numpy(),
                                  np.asarray(want.aggs["first_pos"]))
    assert int(got.n_groups) == int(want.n_groups)
    assert list(got.aggs) == ["first_pos"]


def _coo(seed, n_row_keys, cap=256, dtype=np.int32):
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 6, cap).astype(np.int32) for _ in range(n_row_keys)]
    cols = rng.integers(0, 12, cap).astype(np.int32)
    rows[-1][:4] = I32.max  # live rows at the key maximum
    cols[:2] = I32.max
    vals = rng.integers(-20, 20, cap).astype(dtype)
    return rows, cols, vals


def _csr_arrays(csr):
    return {k: np.asarray(v) for k, v in results_to_numpy(csr).items()}


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("op", ["plus", "max", "min"])
@pytest.mark.parametrize("n_row_keys", [1, 2])
@pytest.mark.parametrize("validity", ["prefix", "mask"])
@pytest.mark.parametrize("caps", [(None, None), (60, None), (None, 4), (300, 200)],
                         ids=["default", "nnz-cut", "row-cut", "wider"])
def test_from_coo_matches_reference(op, n_row_keys, validity, caps):
    rows, cols, vals = _coo(n_row_keys, n_row_keys,
                            dtype=np.float32 if op != "plus" else np.int32)
    nnz_cap, row_cap = caps
    if validity == "prefix":
        kw, jkw = dict(n_valid=200), dict(n_valid=jnp.int32(200))
    else:
        live = _mask(11, len(cols))
        kw, jkw = (dict(valid_mask=torch.from_numpy(live)),
                   dict(valid_mask=jnp.asarray(live)))
    got, dropped = sparse.from_coo(
        [torch.from_numpy(r) for r in rows], torch.from_numpy(cols),
        torch.from_numpy(vals), op=op, nnz_capacity=nnz_cap,
        row_capacity=row_cap, **kw)
    want, jdropped = jsparse.from_coo(
        [jnp.asarray(r) for r in rows], jnp.asarray(cols), jnp.asarray(vals),
        op=op, nnz_capacity=nnz_cap, row_capacity=row_cap, **jkw)
    _assert_same(_csr_arrays(got), _csr_arrays(want))
    assert dropped.dtype == torch.int32 and int(dropped) == int(jdropped)
    if caps in ((60, None), (None, 4)):
        assert int(dropped) > 0
    else:
        assert int(dropped) == 0


def test_from_coo_rejects_unknown_op():
    with pytest.raises(ValueError):
        sparse.from_coo([torch.zeros(4, dtype=torch.int32)],
                        torch.zeros(4, dtype=torch.int32),
                        torch.zeros(4, dtype=torch.int32), op="times")


@pytest.mark.parametrize("n_row_keys", [1, 2])
@pytest.mark.parametrize("caps", [(None, None), (300, 250), (70, None)],
                         ids=["default", "wide", "nnz-cut"])
def test_ewise_union_matches_reference(n_row_keys, caps):
    sides, jsides = [], []
    for seed, n in ((1, 180), (2, 90)):
        rows, cols, vals = _coo(seed + 10 * n_row_keys, n_row_keys, cap=128 + seed)
        sides.append(sparse.from_coo([torch.from_numpy(r) for r in rows],
                                     torch.from_numpy(cols), torch.from_numpy(vals),
                                     n_valid=min(n, len(cols)))[0])
        jsides.append(jsparse.from_coo([jnp.asarray(r) for r in rows],
                                       jnp.asarray(cols), jnp.asarray(vals),
                                       n_valid=jnp.int32(min(n, len(cols))))[0])
    got, dropped = sparse.ewise_union(*sides, nnz_capacity=caps[0],
                                      row_capacity=caps[1])
    want, jdropped = jsparse.ewise_union(*jsides, nnz_capacity=caps[0],
                                         row_capacity=caps[1])
    _assert_same(_csr_arrays(got), _csr_arrays(want))
    assert int(dropped) == int(jdropped)
    if caps[0] is not None:  # the union holds at most 211 entries
        assert (int(dropped) > 0) == (caps[0] == 70)


def test_ewise_union_rejects_arity_mismatch():
    one = sparse.from_coo([torch.zeros(4, dtype=torch.int32)],
                          torch.zeros(4, dtype=torch.int32),
                          torch.ones(4, dtype=torch.int32))[0]
    two = sparse.from_coo([torch.zeros(4, dtype=torch.int32)] * 2,
                          torch.zeros(4, dtype=torch.int32),
                          torch.ones(4, dtype=torch.int32))[0]
    with pytest.raises(ValueError):
        sparse.ewise_union(one, two)


SK = dict(cms_depth=3, cms_width=128, hll_p=6, heavy_capacity=8, seed=5)


def _sketch_arrays(state):
    import dataclasses
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state) if f.name != "seed"}


def _jsketch(seed, batches=2, cap=200):
    rng = np.random.default_rng(seed)
    state = jsk.init_sketch(jsk.SketchConfig(**SK))
    for i in range(batches):
        src = rng.integers(0, 30, cap).astype(np.int32)
        dst = rng.integers(0, 30, cap).astype(np.int32)
        state = jsk.update_sketch(state, jnp.asarray(src), jnp.asarray(dst),
                                  cap - 7 * i, backend="xla")
    return state


def test_merge_sketches_matches_reference():
    ja, jb = _jsketch(1), _jsketch(2, batches=3)
    a, b = (sketch_state_from_numpy(_sketch_arrays(s), s.seed, device="cpu")
            for s in (ja, jb))
    for x, y, jx, jy in ((a, b, ja, jb), (b, a, jb, ja)):
        got, want = _sketch_arrays(sk.merge_sketches(x, y)), _sketch_arrays(
            jsk.merge_sketches(jx, jy))
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert int(sk.merge_sketches(a, b).hh_src_offset) > 0
    other = sk.init_sketch(sk.SketchConfig(**{**SK, "seed": 6}), device="cpu")
    with pytest.raises(ValueError):
        sk.merge_sketches(a, other)
