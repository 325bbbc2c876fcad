"""The port's relational primitives against ``repro.core`` on the same
numpy-seeded inputs: mix32, the packed sort, segment structure, group-by,
the plan, factorize, argmax top-k and the permutations — whole buffers,
tail padding included, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import x64_shim  # noqa: F401  (fixture)
from repro.core import ops as jops
from repro.core import plan as jplan
from repro_torch.core import ops, plan

pytestmark = pytest.mark.usefixtures("x64_shim")

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_mix32_matches_reference():
    edge = np.array([0, 1, I32_MAX, -1, I32_MIN], np.int32)
    rand = np.random.default_rng(0).integers(I32_MIN, I32_MAX, 1000, dtype=np.int64)
    x = np.concatenate([edge, rand.astype(np.int32)])
    got = ops.mix32(_t(x))
    assert got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < 2 ** 32
    _same(got, np.asarray(jops.mix32(jnp.asarray(x))).astype(np.int64))


def _keys(seed, cap, hi=6):
    rng = np.random.default_rng(seed)
    k0 = rng.integers(-hi, hi, cap).astype(np.int32)
    k1 = rng.integers(-hi, hi, cap).astype(np.int32)
    k0[:3] = [I32_MAX, I32_MIN, I32_MAX]  # dtype extremes, incl. the sentinel pair
    k1[:3] = [I32_MAX, I32_MIN, I32_MAX]
    return k0, k1


@pytest.mark.parametrize("n_keys", [1, 2])
@pytest.mark.parametrize("validity", ["none", "prefix", "mask"])
def test_packed_sort_matches_reference(n_keys, validity):
    cap = 97
    k0, k1 = _keys(n_keys * 10 + len(validity), cap)
    keys = [k0, k1][:n_keys]
    payload = np.arange(cap, dtype=np.int32) * 3
    mask = np.random.default_rng(3).random(cap) < 0.6
    kw = {"none": {}, "prefix": {"n_valid": 60}, "mask": {"valid_mask": mask}}[validity]
    (gk, (gp,)) = ops.multi_key_sort([_t(k) for k in keys], [_t(payload)],
                                     **{k: _t(v) if isinstance(v, np.ndarray) else v
                                        for k, v in kw.items()})
    (wk, (wp,)) = jops.multi_key_sort([jnp.asarray(k) for k in keys],
                                      [jnp.asarray(payload)],
                                      **{k: jnp.asarray(v) for k, v in kw.items()})
    for g, w in zip(gk, wk):
        _same(g, w)
    _same(gp, wp)


def test_packed_sort_uint32_words():
    """mix32 outputs (uint32 in the reference, int64 words in the port)."""
    cap = 80
    x = np.random.default_rng(4).integers(I32_MIN, I32_MAX, cap).astype(np.int32)
    iota = np.arange(cap, dtype=np.int32)
    (gk,), (gp,) = ops.multi_key_sort([ops.mix32(_t(x))], [_t(iota)], n_valid=50)
    (wk,), (wp,) = jops.multi_key_sort([jops.mix32(jnp.asarray(x))],
                                       [jnp.asarray(iota)], n_valid=50)
    _same(gk, np.asarray(wk).astype(np.int64))
    _same(gp, wp)


def test_groupby_aggregate_matches_reference():
    cap, n_valid = 120, 101
    k0, k1 = _keys(7, cap, hi=4)
    v = np.random.default_rng(8).integers(-50, 50, cap).astype(np.int32)
    aggs = {"s": "sum", "mx": "max", "mn": "min", "c": "count", "m": "mean"}
    got = ops.groupby_aggregate([_t(k0), _t(k1)],
                                {k: (_t(v), a) for k, a in aggs.items()},
                                n_valid=n_valid)
    want = jops.groupby_aggregate([jnp.asarray(k0), jnp.asarray(k1)],
                                  {k: (jnp.asarray(v), a) for k, a in aggs.items()},
                                  n_valid=n_valid)
    for g, w in zip(got.keys, want.keys):
        _same(g, w)
    assert sorted(got.aggs) == sorted(want.aggs)
    for name in got.aggs:
        _same(got.aggs[name], want.aggs[name])
    assert int(got.n_groups) == int(want.n_groups)
    _same(got.mask(), want.mask())


def test_plan_and_derivations_match_reference():
    cap, n_valid = 150, 131
    rng = np.random.default_rng(9)
    src = rng.integers(0, 12, cap).astype(np.int32)
    dst = rng.integers(0, 12, cap).astype(np.int32)
    w = rng.integers(1, 4, cap).astype(np.int32)
    got = plan.sorted_edges(_t(src), _t(dst), _t(w), n_valid=n_valid)
    want = jplan.sorted_edges(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                              n_valid=n_valid)
    for f in ("key0", "key1", "w", "row", "seg", "first", "k0_seg", "k0_first",
              "n_valid", "n_links", "n_k0"):
        _same(getattr(got, f), getattr(want, f))
    _same(got.link_to_k0(), want.link_to_k0())
    for fn in ("link_groups", "lead_groups", "lead_fanout"):
        g, wt = getattr(plan, fn)(got), getattr(jplan, fn)(want)
        for a, b in zip(g.keys, wt.keys):
            _same(a, b)
        for name in g.aggs:
            _same(g.aggs[name], wt.aggs[name])
    u, wu = plan.unique_lead(got), jplan.unique_lead(want)
    _same(u.values, wu.values)
    _same(u.counts, wu.counts)
    gc = plan.unique_concat(_t(src), _t(dst), n_valid)
    wc = jplan.unique_concat(jnp.asarray(src), jnp.asarray(dst), n_valid)
    _same(gc.keys[0], wc.keys[0])
    _same(gc.aggs["count"], wc.aggs["count"])


def test_segment_ids_and_factorize_match_reference():
    s = np.sort(np.random.default_rng(2).integers(0, 20, 64)).astype(np.int32)
    for a, b in zip(ops.segment_ids_from_sorted([_t(s)], 50),
                    jops.segment_ids_from_sorted([jnp.asarray(s)], 50)):
        _same(a, b)
    u = np.array([1, 4, 9, I32_MAX, I32_MAX], np.int32)
    x = np.array([0, 1, 4, 5, 9, 10, I32_MAX], np.int32)
    _same(ops.factorize(_t(x), _t(u)), jops.factorize(jnp.asarray(x), jnp.asarray(u)))


@pytest.mark.parametrize("use_mask", [False, True])
def test_argmax_top_k_keeps_first_max_tie_rule(use_mask):
    v = np.array([3, 9, 9, 1, 9, 0, 9, 4], np.int32)
    mask = np.array([1, 1, 0, 1, 1, 1, 1, 0], bool) if use_mask else None
    for k in (3, 5, 20):
        got = ops.argmax_top_k(_t(v), k, None if mask is None else _t(mask))
        want = jops.argmax_top_k(jnp.asarray(v), k,
                                 None if mask is None else jnp.asarray(mask))
        for a, b in zip(got, want):
            _same(a, b)


def test_masked_max_floor_and_clamp():
    assert int(ops.masked_max(_t(np.array([5, 7], np.int32)),
                              _t(np.array([False, False])))) == 0
    assert ops.clamp_k(10, 4) == 4


def test_hash_permutation_matches_reference():
    for cap, n in ((100, 70), (64, 64)):
        got = ops.hash_permutation(cap, torch.tensor(n, dtype=torch.int32))
        _same(got, jops.hash_permutation(cap, n))


def test_random_permutation_is_a_permutation():
    g = torch.Generator().manual_seed(5)
    out = ops.random_permutation(g, 50, torch.tensor(30, dtype=torch.int32)).numpy()
    assert sorted(out[:30]) == list(range(30))
    assert sorted(out) == list(range(50))
    again = ops.random_permutation(torch.Generator().manual_seed(5), 50,
                                   torch.tensor(30, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(out, again)


def _same_unique(got, want):
    for f in ("values", "counts", "n_unique"):
        _same(getattr(got, f), getattr(want, f))
    assert (got.weight_sums is None) == (want.weight_sums is None)
    if got.weight_sums is not None:
        _same(got.weight_sums, want.weight_sums)
    _same(got.mask(), want.mask())


@pytest.mark.parametrize("n_valid", [0, 1, 70, 97])  # 0: all padding
@pytest.mark.parametrize("weighted", [False, True])
def test_unique_and_value_counts_match_reference(n_valid, weighted):
    """``unique`` (values, counts, weight sums, mask) and ``value_counts``,
    padding that collides with live values included."""
    cap = 97
    rng = np.random.default_rng(n_valid + 100 * weighted)
    x = rng.integers(-20, 20, cap).astype(np.int32)
    x[n_valid:] = 7
    w = rng.integers(0, 9, cap).astype(np.int32) if weighted else None
    got = ops.unique(_t(x), n_valid=n_valid,
                     weights=None if w is None else _t(w))
    want = jops.unique(jnp.asarray(x), n_valid=n_valid,
                       weights=None if w is None else jnp.asarray(w))
    _same_unique(got, want)
    vals, counts = np.unique(x[:n_valid], return_counts=True)
    _same(got.values[:len(vals)], vals)
    _same(got.counts[:len(vals)], counts.astype(np.int32))
    _same_unique(ops.value_counts(_t(x), n_valid),
                 jops.value_counts(jnp.asarray(x), n_valid))


def test_unique_with_valid_mask_matches_reference():
    cap = 64
    rng = np.random.default_rng(5)
    x = rng.integers(0, 10, cap).astype(np.int32)
    mask = rng.random(cap) < 0.5
    _same_unique(ops.unique(_t(x), valid_mask=_t(mask)),
                 jops.unique(jnp.asarray(x), valid_mask=jnp.asarray(mask)))


@pytest.mark.parametrize("n_valid", [0, 50, 120])
def test_drop_duplicates_matches_reference(n_valid):
    k0, k1 = _keys(n_valid + 3, 120, hi=4)
    got = ops.drop_duplicates([_t(k0), _t(k1)], n_valid)
    want = jops.drop_duplicates([jnp.asarray(k0), jnp.asarray(k1)], n_valid)
    for g, w in zip(got.keys, want.keys):
        _same(g, w)
    _same(got.aggs["count"], want.aggs["count"])
    _same(got.n_groups, want.n_groups)
    rows = {(a, b) for a, b in zip(k0[:n_valid], k1[:n_valid])}
    assert int(got.n_groups) == len(rows)


@pytest.mark.parametrize("n_keys", [1, 2])
@pytest.mark.parametrize("ln,rn", [(0, 0), (1, 0), (0, 1), (120, 60), (64, 64)])
def test_semi_join_matches_reference_and_numpy(n_keys, ln, rn):
    """Left rows whose key tuple appears among the right's live rows:
    against ``np.isin`` on the tuples (packed into one int64) and the
    reference's mask, padding rows False."""
    rng = np.random.default_rng(ln * 100 + rn + n_keys)
    lcap, rcap = ln + 9, rn + 5
    left = [rng.integers(0, 9, lcap).astype(np.int32) for _ in range(n_keys)]
    right = [rng.integers(0, 9, rcap).astype(np.int32) for _ in range(n_keys)]
    got = ops.semi_join([_t(k) for k in left], [_t(k) for k in right], ln, rn)
    want = jops.semi_join([jnp.asarray(k) for k in left],
                          [jnp.asarray(k) for k in right],
                          left_n_valid=ln, right_n_valid=rn)
    _same(got, want)
    pack = lambda cols, n: sum(c[:n].astype(np.int64) * 16 ** i
                               for i, c in enumerate(cols))
    _same(got[:ln], np.isin(pack(left, ln), pack(right, rn)))
    assert not got[ln:].any()
