"""The port's windowed suite (``repro_torch.core.temporal``) against
``repro.core.temporal``: the dense-grid path and the pre-plan naive path
bit for bit against JAX's and against the port's CSR path, on a
hash-anonymized scale-10 capture with and without packet weights, the
empty table, and the method checks."""
import numpy as np
import pytest
import torch

from _torch_parity import x64_shim, x64_shim_applied  # noqa: F401  (fixture)
from repro.challenge import pipeline as jax_pipeline
from repro.core import temporal as jtemporal
from repro.core.anonymize import anonymize as jax_anonymize
from repro.core.table import Table as JaxTable
from repro_torch.convert import table_from_numpy
from repro_torch.core import temporal
from repro_torch.core.plan import SortCounter

pytestmark = pytest.mark.usefixtures("x64_shim")

N_WINDOWS = 8


@pytest.fixture(scope="module", params=[False, True], ids=["unweighted", "weighted"])
def tables(request, tmp_path_factory):
    """Both packages' tables of one hash-anonymized scale-10 capture, its
    window ids in ``win``; weighted adds ``n_packets`` in [1, 5)."""
    with x64_shim_applied():
        cfg = jax_pipeline.ChallengeConfig(scale=10, capacity=1100,
                                           n_windows=N_WINDOWS)
        cols = jax_pipeline.read_phase(cfg, str(tmp_path_factory.mktemp("cap")))
        src, dst, win, n = jax_pipeline.build_columns(cols, cfg)
        jt = jax_anonymize(jax_pipeline.build_table(src, dst, win, n),
                           method="hash").table
        host = {c: np.array(jt[c]) for c in ("src", "dst", "win")}
        if request.param:
            host["n_packets"] = np.random.default_rng(2).integers(
                1, 5, len(src)).astype(np.int32)
        return (table_from_numpy(host, n, device="cpu"),
                JaxTable.from_dict(host, n_valid=n))


def _same_dict(got, want):
    assert got.keys() == want.keys() and len(got) == 9
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == torch.int32 and w.dtype == np.int32, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


WQ = dict(window_len=1, n_windows=N_WINDOWS, ts_col="win", t0=0)


def test_grid_matches_jax_and_the_csr_path(tables):
    t, jt = tables
    got = temporal.windowed_queries(t, method="grid", **WQ)
    _same_dict(got, jtemporal.windowed_queries(jt, method="grid", **WQ))
    _same_dict(got, {k: v.numpy() for k, v in
                     temporal.windowed_queries(t, method="csr", **WQ).items()})


def test_naive_matches_jax_and_the_csr_path(tables):
    t, jt = tables
    got = temporal.windowed_queries_naive(t, **WQ)
    _same_dict(got, jtemporal.windowed_queries_naive(jt, **WQ))
    _same_dict(got, {k: v.numpy() for k, v in
                     temporal.windowed_queries(t, **WQ).items()})


@pytest.mark.parametrize("method,sorts", [("csr", 2), ("grid", 2), ("naive", 6)])
def test_windowed_sort_counts(tables, method, sorts):
    """The plan paths sort the two plans; the naive path's five group-bys
    take six sorts ((win, src, dst) in two passes)."""
    t = tables[0]
    with SortCounter() as counter:
        if method == "naive":
            temporal.windowed_queries_naive(t, **WQ)
        else:
            temporal.windowed_queries(t, method=method, **WQ)
    assert counter.n == sorts


@pytest.mark.parametrize("method", ["csr", "grid", "naive"])
def test_empty_table(method):
    """n_valid == 0: every statistic is 0 in every window, on every path."""
    host = {c: np.zeros(16, np.int32) for c in ("src", "dst", "ts")}
    t = table_from_numpy(host, 0, device="cpu")
    res = (temporal.windowed_queries_naive(t, 10, 4) if method == "naive"
           else temporal.windowed_queries(t, 10, 4, method=method))
    want = (jtemporal.windowed_queries_naive if method == "naive" else
            lambda *a: jtemporal.windowed_queries(*a, method=method))(
        JaxTable.from_dict(host, n_valid=0), 10, 4)
    _same_dict(res, want)
    for k, v in res.items():
        assert v.shape == (4,) and not v.any(), k


def test_method_checks(tables):
    t = tables[0]
    with pytest.raises(ValueError, match="requires method='csr'"):
        temporal.windowed_queries(t, method="grid", fused=True, **WQ)
    with pytest.raises(ValueError, match="unknown windowed method"):
        temporal.windowed_queries(t, method="dense", **WQ)
