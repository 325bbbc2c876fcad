"""The port's CSR substrate (``repro_torch.core.sparse``) against
``repro.core.sparse`` on the same numpy-seeded plan: the CSR buffers, entry
rows, row reductions, degrees, the vertex/row-slot bridges and the masked
semiring products.  The max and min semirings are exact in any order, so
they compare bit for bit against both the XLA path and the Pallas segment-max
kernel run in interpret mode; plus-times sums floats in another order and
is held to the reordering bound stated in :func:`_sum_tolerance`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import x64_shim  # noqa: F401  (fixture)
from repro.core import plan as jplan
from repro.core import sparse as jsparse
from repro_torch.core import plan, sparse

pytestmark = pytest.mark.usefixtures("x64_shim")

CAP, N_VALID, KEYS, NUM_COLS = 150, 131, 40, 32  # keys 32..39 fall outside


def _pair(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, KEYS, CAP).astype(np.int32)
    dst = rng.integers(0, KEYS, CAP).astype(np.int32)
    w = rng.integers(1, 4, CAP).astype(np.int32)
    got = sparse.csr_from_plan(plan.sorted_edges(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
        n_valid=N_VALID))
    want = jsparse.csr_from_plan(jplan.sorted_edges(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), n_valid=N_VALID))
    return got, want


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_csr_from_plan_buffers_and_entry_rows():
    got, want = _pair(1)
    for f in ("indptr", "col_keys", "vals", "n_rows", "nnz"):
        _same(getattr(got, f), getattr(want, f))
    _same(got.row_keys[0], want.row_keys[0])
    _same(got.row_mask(), want.row_mask())
    _same(got.entry_mask(), want.entry_mask())
    _same(got.entry_rows(), want.entry_rows())
    assert got.entry_rows() is got.entry_rows()  # computed once per matrix
    _same(got.entry_row_key(0), want.entry_row_key(0))


@pytest.mark.parametrize("op", ["plus", "max"])
def test_reduce_rows_and_degrees(op):
    got, want = _pair(2)
    _same(sparse.reduce_rows(got, op), jsparse.reduce_rows(want, op))
    _same(sparse.degrees(got), jsparse.degrees(want))
    with pytest.raises(ValueError, match="monoid"):
        sparse.reduce_rows(got, "min")


def test_gather_and_scatter_rows():
    got, want = _pair(3)
    x = np.random.default_rng(4).standard_normal(NUM_COLS).astype(np.float32)
    _same(sparse.gather_rows(got, torch.from_numpy(x), fill=-7.0),
          jsparse.gather_rows(want, jnp.asarray(x), fill=-7.0))
    slots = np.arange(CAP, dtype=np.float32) * 0.5
    _same(sparse.scatter_rows(got, torch.from_numpy(slots), NUM_COLS, fill=9.0),
          jsparse.scatter_rows(want, jnp.asarray(slots), NUM_COLS, fill=9.0))


def _sum_tolerance(csr, x, num, side):
    """Two orders of k float32 terms differ by at most 2(k-1)·2^-24·Σ|term|;
    Σ|term| per output slot is the same product over |x| (values are
    positive) and k is at most the entry count."""
    k = int(csr.nnz)
    ax = torch.from_numpy(np.abs(x))
    abs_sum = (sparse.vxm(ax, csr, num) if side == "vxm" else sparse.mxv(csr, ax))
    return 2 * k * 2.0 ** -24 * abs_sum.numpy()


SEMIRINGS = [("min", "second"), ("max", "first"), ("plus", "times")]


@pytest.mark.parametrize("side", ["vxm", "mxv"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("add,mul", SEMIRINGS)
def test_semiring_products_match_reference(side, masked, add, mul):
    got, want = _pair(5 + masked)
    rng = np.random.default_rng(6)
    n_in = CAP if side == "vxm" else NUM_COLS
    n_out = NUM_COLS if side == "vxm" else CAP
    x = rng.standard_normal(n_in).astype(np.float32)
    x[::5] = np.inf if add == "min" else x[::5]
    mask = rng.random(n_out) < 0.6 if masked else None
    kw = dict(add=add, mul=mul)

    def run(mod, csr, xx, mk, backend):
        if side == "vxm":
            return mod.vxm(xx, csr, NUM_COLS, mask=mk, backend=backend, **kw)
        return mod.mxv(csr, xx, mask=mk, backend=backend, **kw)

    res = run(sparse, got, torch.from_numpy(x),
              None if mask is None else torch.from_numpy(mask), "auto")
    jm = None if mask is None else jnp.asarray(mask)
    for backend in ("xla", "interpret"):
        ref = np.asarray(run(jsparse, want, jnp.asarray(x), jm, backend))
        if add == "plus":
            np.testing.assert_array_equal(np.isfinite(res.numpy()), np.isfinite(ref))
            err = np.abs(res.numpy() - ref)
            assert (err <= _sum_tolerance(got, x, NUM_COLS, side)).all()
        else:
            np.testing.assert_array_equal(res.numpy(), ref)


def test_unknown_semiring_raises():
    got, _ = _pair(7)
    with pytest.raises(ValueError, match="semiring"):
        sparse.vxm(torch.zeros(CAP), got, NUM_COLS, add="min", mul="plus")


def _same_csr(got, want):
    for f in ("indptr", "col_keys", "vals", "n_rows", "nnz"):
        _same(getattr(got, f), getattr(want, f))
    assert len(got.row_keys) == len(want.row_keys)
    for g, w in zip(got.row_keys, want.row_keys):
        _same(g, w)


@pytest.mark.parametrize("op", ["plus", "max"])
def test_reduce_cols_matches_reference(op):
    """Columns 32..39 fall outside ``num_cols`` and drop out."""
    got, want = _pair(8)
    _same(sparse.reduce_cols(got, NUM_COLS, op),
          jsparse.reduce_cols(want, NUM_COLS, op))
    with pytest.raises(ValueError, match="monoid"):
        sparse.reduce_cols(got, NUM_COLS, "min")


@pytest.mark.parametrize("nnz_capacity,row_capacity", [(None, None), (60, 20)])
def test_transpose_matches_reference(nnz_capacity, row_capacity):
    """A^T's buffers and its drop count, at the default capacities and at
    capacities that cut it."""
    got, want = _pair(9)
    kw = dict(nnz_capacity=nnz_capacity, row_capacity=row_capacity)
    (gt, gd), (wt, wd) = sparse.transpose(got, **kw), jsparse.transpose(want, **kw)
    _same_csr(gt, wt)
    _same(gd, wd)
    if nnz_capacity is None:
        assert int(gd) == 0 and int(gt.nnz) == int(got.nnz)
    else:
        assert int(gd) > 0


@pytest.mark.parametrize("given_transpose", [False, True])
@pytest.mark.parametrize("op", ["plus", "max"])
def test_symmetrize_matches_reference(given_transpose, op):
    got, want = _pair(10)
    gt = sparse.transpose(got)[0] if given_transpose else None
    wt = jsparse.transpose(want)[0] if given_transpose else None
    (gs, gd), (ws, wd) = (sparse.symmetrize(got, gt, op=op),
                          jsparse.symmetrize(want, wt, op=op))
    _same_csr(gs, ws)
    _same(gd, wd)
    assert int(gd) == 0


def test_transpose_needs_one_row_key():
    got, _ = _pair(11)
    two = sparse.CsrMatrix(row_keys=(got.row_keys[0], got.row_keys[0]),
                           indptr=got.indptr, col_keys=got.col_keys,
                           vals=got.vals, n_rows=got.n_rows, nnz=got.nnz)
    with pytest.raises(ValueError, match="1-column row key"):
        sparse.transpose(two)
