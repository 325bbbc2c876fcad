"""The port's query surface (``repro_torch.core.queries``) against
``repro.core.queries`` on hash-anonymized RMAT captures at scale 10, with
and without an ``n_packets`` weight column: every per-query function, the
three suite entry points (plan, CSR matrix language, pre-plan) and the
detection queries, whole buffers bit for bit; the scalars against the
NumPy oracle; the sort budgets."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import x64_shim, x64_shim_applied  # noqa: F401  (fixture)
from repro.challenge import pipeline as jax_pipeline
from repro.core import queries as jq
from repro.core.anonymize import anonymize as jax_anonymize
from repro.core.table import Table as JaxTable
from repro_torch.convert import results_to_numpy, table_from_numpy
from repro_torch.core import queries as q
from repro_torch.core import sketch
from repro_torch.core.plan import SortCounter
from repro_torch.core.ref import ref_run_all_queries

pytestmark = pytest.mark.usefixtures("x64_shim")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(got, want):
    """Equal field for field (``results_to_numpy`` on dataclasses), or as
    arrays of the same dtype and shape."""
    if isinstance(got, torch.Tensor):
        got, want = {"": got}, {"": want}
    else:
        got, want = results_to_numpy(got), results_to_numpy(want)
    assert got.keys() == want.keys()
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module", params=[False, True], ids=["unweighted", "weighted"])
def tables(request, tmp_path_factory):
    """The port's and JAX's hash-anonymized scale-10 tables, padded to
    1,100 rows; weighted adds an ``n_packets`` column in [1, 5)."""
    with x64_shim_applied():
        cfg = jax_pipeline.ChallengeConfig(scale=10, capacity=1100)
        cols = jax_pipeline.read_phase(cfg, str(tmp_path_factory.mktemp("cap")))
        src, dst, win, n = jax_pipeline.build_columns(cols, cfg)
        jt = jax_anonymize(jax_pipeline.build_table(src, dst, win, n),
                           method="hash").table
        host = {c: np.array(jt[c]) for c in ("src", "dst")}
        if request.param:
            host["n_packets"] = np.random.default_rng(1).integers(
                1, 5, len(src)).astype(np.int32)
        t = table_from_numpy(host, n, device="cpu")
        jt = JaxTable.from_dict(host, n_valid=n)
        return t, jt, host, n


PER_QUERY = ["traffic_matrix", "valid_packets", "unique_links", "link_packets",
             "max_link_packets", "unique_sources", "unique_destinations",
             "unique_ips", "packets_per_source", "max_source_packets",
             "source_fanout", "max_source_fanout", "packets_per_destination",
             "max_destination_packets", "destination_fanin",
             "max_destination_fanin"]


@pytest.mark.parametrize("name", PER_QUERY)
def test_per_query_function_matches_jax(tables, name):
    t, jt, _, _ = tables
    _same(getattr(q, name)(t), getattr(jq, name)(jt))


@pytest.mark.parametrize("k", [1, 10, 5000])  # 5000 > capacity: clamped
def test_top_links_matches_jax_and_the_plan_path(tables, k):
    t, jt, _, _ = tables
    got = q.top_links(t, k)
    _same(got, jq.top_links(jt, k))
    plan_src, _ = q.table_plans(t)
    _same(got, q.top_links_from_plan(plan_src, k))


def test_suite_entry_points_match_oracle_and_jax(tables):
    """``run_all_queries``, ``run_all_queries_csr`` and
    ``run_all_queries_naive``: equal to each other, to JAX's and to the
    NumPy oracle."""
    t, jt, host, n = tables
    w = host.get("n_packets")
    ref = ref_run_all_queries(host["src"][:n].astype(np.int64),
                              host["dst"][:n].astype(np.int64),
                              None if w is None else w[:n])
    got = {name: getattr(q, name)(t) for name in (
        "run_all_queries", "run_all_queries_csr", "run_all_queries_naive")}
    for name, res in got.items():
        _same(res, getattr(jq, name)(jt))
        assert {k: int(v) for k, v in res.as_dict().items()} == ref, name


def test_csr_formulation_matches_jax(tables):
    t, jt, _, _ = tables
    _same(q.traffic_matrix_csr(t), jq.traffic_matrix_csr(jt))
    plans = q.table_plans(t)
    csrs, jcsrs = q.table_csrs(t, plans), jq.table_csrs(jt)
    _same(q.traffic_matrix_csr(t, plans[0]), csrs[0])
    _same(q.scalar_queries_from_csrs(t, *csrs), jq.scalar_queries_from_csrs(jt, *jcsrs))
    _same(q.scalar_queries_from_csrs(t, *csrs),
          q.scalar_queries_from_plans(t, *plans))


@pytest.mark.parametrize("name,sorts", [("run_all_queries", 3),
                                        ("run_all_queries_csr", 3),
                                        ("run_all_queries_naive", 6)])
def test_suite_sort_budgets(tables, name, sorts):
    """Three sorts off the plan (two plans and the concat), six pre-plan:
    five group-bys and the concat."""
    with SortCounter() as counter:
        getattr(q, name)(tables[0])
    assert counter.n == sorts


def _halves(host, n):
    """Two windows' tables: the first and the second half of the rows."""
    h = n // 2
    cut = lambda a, b: {c: np.ascontiguousarray(v[a:b]) for c, v in host.items()}
    return [(table_from_numpy(cut(a, b), b - a, device="cpu"),
             JaxTable.from_dict(cut(a, b), n_valid=b - a))
            for a, b in ((0, h), (h, n))]


def test_detection_queries_match_jax(tables):
    """Drift of the top links and the exact new-talker rate between two
    windows, and the drift and rate's own arithmetic on edge cases."""
    _, _, host, n = tables
    (t0, j0), (t1, j1) = _halves(host, n)
    for k in (5, 50):
        _same(q.top_links_drift(q.top_links(t0, k), q.top_links(t1, k)),
              jq.top_links_drift(jq.top_links(j0, k), jq.top_links(j1, k)))
    _same(q.new_talker_rate_exact(q.unique_sources(t0), q.unique_sources(t1)),
          jq.new_talker_rate_exact(jq.unique_sources(j0), jq.unique_sources(j1)))
    keys = [torch.tensor([1, 2, 3, 0], dtype=torch.int32)]
    for prev_n, cur_n in ((3, 3), (0, 3), (3, 0), (2, 1)):
        _same(q.top_k_drift(keys, prev_n, keys, cur_n),
              jq.top_k_drift([jnp.asarray(keys[0].numpy())], prev_n,
                             [jnp.asarray(keys[0].numpy())], cur_n))
    for cards in ((10.0, 14.0, 5.0), (10.0, 9.5, 0.0), (3, 3, 3), (0, 7, 7)):
        _same(q.new_talker_rate(*cards), jq.new_talker_rate(*cards))


def test_new_talker_rate_sketch_matches_jax():
    """Two register banks of the port's HyperLogLog: the rate through
    three cardinalities.  Each cardinality sums 2^-register over 4,096
    registers, float32 in another order than XLA's; the tolerance is that
    of ``test_torch_sketch.py``'s ``hll_cardinality`` parity (rtol 1e-6)."""
    rng = np.random.default_rng(2)
    cfg = sketch.SketchConfig()
    regs = []
    for lo in (0, 1 << 12):
        s = sketch.init_sketch(cfg, "cpu")
        ids = torch.from_numpy(rng.integers(lo, lo + 6000, 1 << 13).astype(np.int32))
        s = sketch.update_sketch(s, ids, ids, 1 << 13)
        regs.append(s.hll_src)
    got = q.new_talker_rate_sketch(*regs)
    want = jq.new_talker_rate_sketch(*(jnp.asarray(r.numpy()) for r in regs))
    assert got.dtype == torch.float32 and 0.5 < float(got) < 0.9  # exact: 0.68
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(
        q.new_talker_rate_sketch(regs[0], regs[0]).numpy(), 0.0, atol=1e-6)
