"""The port's graph algorithms (``repro_torch.core.algorithms``) against
``repro.core.algorithms`` and the NumPy oracles, on hash-anonymized RMAT
captures at scales 8 and 10: BFS levels, component labels and triangle
counts bit for bit; PageRank within 1e-6 L1 of both, its iteration count
within one of JAX's (float sums run in another order).  Then the
reference's edge cases, the fixed-point cap-out, components with the
transpose built from the CSR (``csr_t=None``), the three-sort budget of
``analyze(algorithms=True)`` and the whole ``analyze`` against JAX's."""
import numpy as np
import pytest
import torch

from _torch_parity import x64_shim, x64_shim_applied  # noqa: F401  (fixture)
from repro.challenge import pipeline as jax_pipeline
from repro.core import algorithms as jalg
from repro.core.anonymize import anonymize as jax_anonymize
from repro.core.queries import table_csrs as jax_table_csrs
from repro_torch.challenge import pipeline
from repro_torch.convert import results_to_numpy, table_from_numpy
from repro_torch.core import algorithms as alg
from repro_torch.core.anonymize import anonymize
from repro_torch.core.plan import SortCounter
from repro_torch.core.queries import table_csrs, unique_ips
from repro_torch.core.ref import ref_bfs, ref_cc, ref_pagerank, ref_triangles

pytestmark = pytest.mark.usefixtures("x64_shim")

UNREACHABLE = alg.UNREACHABLE
L1_TOL = 1e-6


def _capture(scale, tmp_path):
    cfg = jax_pipeline.ChallengeConfig(scale=scale)
    cols = jax_pipeline.read_phase(cfg, str(tmp_path))
    src, dst, win, n = jax_pipeline.build_columns(cols, cfg)
    return {"src": src, "dst": dst, "win": win}, n


@pytest.fixture(scope="module", params=[8, 10])
def graphs(request, tmp_path_factory):
    """Both packages' CSR pairs of one hash-anonymized capture, its live
    edge list and vertex counts."""
    with x64_shim_applied():
        cols, n = _capture(request.param, tmp_path_factory.mktemp("cap"))
        t = anonymize(table_from_numpy(cols, n, device="cpu"), method="hash").table
        jt = jax_anonymize(jax_pipeline.build_table(
            cols["src"], cols["dst"], cols["win"], n), method="hash").table
        n_live = int(unique_ips(t).n_unique)
        return dict(
            csrs=table_csrs(t), jcsrs=jax_table_csrs(jt),
            src=t["src"][:n].numpy().astype(np.int64),
            dst=t["dst"][:n].numpy().astype(np.int64),
            nv=2 * t.capacity, n_live=n_live)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _busy_source(g):
    """The most frequent source: a vertex with out-edges, unlike vertex 0,
    which an anonymized capture may leave isolated."""
    return int(np.bincount(g["src"]).argmax())


def test_bfs_matches_jax_and_oracle(graphs):
    g = graphs
    for source in (0, _busy_source(g)):
        got = alg.bfs_levels(g["csrs"][0], source, g["nv"], n_live=g["n_live"])
        want = jalg.bfs_levels(g["jcsrs"][0], source, g["nv"],
                               n_live=g["n_live"], backend="xla")
        for f in ("levels", "n_reached", "iterations", "converged"):
            _same(getattr(got, f), getattr(want, f))
        lv = got.levels.numpy()
        np.testing.assert_array_equal(
            lv[:g["n_live"]], ref_bfs(g["src"], g["dst"], g["n_live"], source))
        assert np.all(lv[g["n_live"]:] == UNREACHABLE)
    assert int(got.iterations) >= 3  # the busy source reaches past one hop


def test_components_match_jax_and_oracle(graphs):
    g = graphs
    got = alg.connected_components(g["csrs"][0], g["nv"], csr_t=g["csrs"][1],
                                   n_live=g["n_live"])
    want = jalg.connected_components(g["jcsrs"][0], g["nv"], csr_t=g["jcsrs"][1],
                                     n_live=g["n_live"], backend="xla")
    for f in ("labels", "n_components", "iterations", "converged"):
        _same(getattr(got, f), getattr(want, f))
    oracle = ref_cc(g["src"], g["dst"], g["n_live"])
    np.testing.assert_array_equal(got.labels.numpy()[:g["n_live"]], oracle)
    assert int(got.n_components) == len(np.unique(oracle))


def test_pagerank_within_tolerance_of_jax_and_oracle(graphs):
    g = graphs
    got = alg.pagerank(g["csrs"][0], g["nv"], n_live=g["n_live"])
    want = jalg.pagerank(g["jcsrs"][0], g["nv"], n_live=g["n_live"],
                         backend="xla")
    ranks = got.ranks.numpy()
    assert ranks.dtype == np.float32
    assert np.abs(ranks - np.asarray(want.ranks)).sum() < L1_TOL
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    assert bool(got.converged) and bool(want.converged)
    oracle, _, _ = ref_pagerank(g["src"], g["dst"], np.ones(len(g["src"])),
                                g["n_live"])
    assert np.abs(ranks[:g["n_live"]] - oracle).sum() < L1_TOL
    assert np.all(ranks[g["n_live"]:] == 0.0)


def test_triangles_match_jax_and_oracle(graphs):
    g = graphs
    want = jalg.triangle_counts(g["jcsrs"][0], g["nv"], backend="xla")
    pn, total = ref_triangles(g["src"], g["dst"], g["n_live"])
    for block in (63, 5):  # any block gives the same integers
        got = alg.triangle_counts(g["csrs"][0], g["nv"], block=block)
        for f in ("per_entry", "per_node", "total"):
            _same(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(got.per_node.numpy()[:g["n_live"]],
                                      pn.astype(np.float32))
        assert int(got.total) == total


# --- edge cases (the reference's tests/test_algorithms.py:167-256) ------------

def _graph(src, dst, n_valid=None):
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    t = table_from_numpy({"src": src, "dst": dst},
                         len(src) if n_valid is None else n_valid, device="cpu")
    cs, cd = table_csrs(t)
    nv = int(max(src.max(), dst.max())) + 1 if len(src) else 1
    return src, dst, cs, cd, nv


def test_empty_graph():
    _, _, cs, cd, _ = _graph(np.zeros(8), np.zeros(8), n_valid=0)
    res = alg.graph_algorithms(cs, cd, 4, n_live=0, source=0)
    assert np.all(res.bfs.levels.numpy() == UNREACHABLE)
    assert int(res.bfs.n_reached) == 0
    assert int(res.components.n_components) == 0
    assert np.all(res.pagerank.ranks.numpy() == 0.0)
    assert int(res.triangles.total) == 0


def test_single_node_with_self_loop():
    src, dst, cs, cd, nv = _graph([0], [0])
    res = alg.graph_algorithms(cs, cd, nv, source=0)
    assert res.bfs.levels.tolist() == [0]
    assert res.components.labels.tolist() == [0]
    assert int(res.components.n_components) == 1
    np.testing.assert_allclose(res.pagerank.ranks.numpy(), [1.0], atol=1e-6)
    assert int(res.triangles.total) == ref_triangles(src, dst, nv)[1] == 1


def test_disconnected_components_and_self_loops():
    src, dst, cs, cd, _ = _graph([0, 1, 2, 3, 4, 5, 3], [1, 2, 0, 4, 5, 3, 3])
    nv = 7
    res = alg.graph_algorithms(cs, cd, nv, n_live=nv, source=0)
    np.testing.assert_array_equal(res.components.labels.numpy(),
                                  ref_cc(src, dst, nv))
    assert int(res.components.n_components) == 3
    lv = res.bfs.levels.numpy()
    assert lv.tolist()[:3] == [0, 1, 2] and np.all(lv[3:] == UNREACHABLE)
    np.testing.assert_array_equal(lv, ref_bfs(src, dst, nv, 0))


def test_bfs_isolated_non_live_and_out_of_range_sources():
    _, _, cs, _, _ = _graph([1], [2])
    res = alg.bfs_levels(cs, 0, 3)  # live but isolated: only itself
    assert res.levels.tolist() == [0, UNREACHABLE, UNREACHABLE]
    assert int(res.n_reached) == 1 and bool(res.converged)
    _, _, cs, _, _ = _graph([0, 1], [1, 2])
    res = alg.bfs_levels(cs, 2, 4, n_live=2)  # 2 is beyond the live range
    assert np.all(res.levels.numpy() == UNREACHABLE) and int(res.n_reached) == 0
    res = alg.bfs_levels(cs, 9, 4)  # past the vertex domain, as ref_bfs says
    np.testing.assert_array_equal(res.levels.numpy(),
                                  ref_bfs(np.array([0, 1]), np.array([1, 2]), 4, 9))


def test_pagerank_dangling_mass_conserved():
    src, dst, cs, _, nv = _graph([0, 0, 0], [1, 2, 3])
    res = alg.pagerank(cs, nv)
    ranks = res.ranks.numpy()
    assert abs(ranks.sum() - 1.0) < 1e-5
    want, _, _ = ref_pagerank(src, dst, np.ones(3), nv)
    assert np.abs(ranks - want).sum() < L1_TOL and bool(res.converged)


def test_max_iters_cap_outs_report_partial_results():
    _, _, cs, _, nv = _graph(list(range(9)), list(range(1, 10)))  # a path
    res = alg.bfs_levels(cs, 0, nv, max_iters=3)
    assert not bool(res.converged) and int(res.iterations) == 3
    lv = res.levels.numpy()
    assert lv[:4].tolist() == [0, 1, 2, 3] and np.all(lv[4:] == UNREACHABLE)
    _, _, cs, _, nv = _graph([0, 1, 2], [1, 2, 0])
    res = alg.pagerank(cs, nv, tol=0.0, max_iters=5)
    assert not bool(res.converged) and int(res.iterations) == 5
    assert abs(float(res.ranks.sum()) - 1.0) < 1e-5


def test_triangle_per_entry_wedge_counts():
    src, dst, cs, _, nv = _graph([0, 1, 2, 0], [1, 2, 0, 2])
    res = alg.triangle_counts(cs, nv)
    want_pn, want_total = ref_triangles(src, dst, nv)
    np.testing.assert_array_equal(res.per_node.numpy(), want_pn.astype(np.float32))
    assert int(res.total) == want_total
    with pytest.raises(ValueError, match="block"):
        alg.triangle_counts(cs, nv, block=64)


def test_fixed_point_harness():
    x = torch.tensor([0.0])
    fp = alg.fixed_point(lambda s: s + 1, x, 4, lambda old, new: new[0] > 10)
    assert int(fp.iterations) == 4 and not bool(fp.converged)
    assert fp.iterations.dtype == torch.int32 and fp.converged.dtype == torch.bool
    fp = alg.fixed_point(lambda s: s + 1, x, 100, lambda old, new: new[0] >= 3)
    assert int(fp.iterations) == 3 and bool(fp.converged)
    fp = alg.fixed_point(lambda s: s + 1, x, 0, lambda old, new: new[0] >= 3)
    assert int(fp.iterations) == 0 and float(fp.state[0]) == 0.0
    with pytest.raises(ValueError, match="max_iters"):
        alg.fixed_point(lambda s: s, x, -1, lambda old, new: True)


def test_components_without_transpose_builds_it(graphs):
    """``csr_t=None`` sorts the transpose itself (``sparse.transpose``): the
    labels equal the ones off the dst-keyed CSR and JAX's ``csr_t=None``."""
    g = graphs
    with SortCounter() as counter:
        got = alg.connected_components(g["csrs"][0], g["nv"], n_live=g["n_live"])
    assert counter.n == 1
    given = alg.connected_components(g["csrs"][0], g["nv"], csr_t=g["csrs"][1],
                                     n_live=g["n_live"])
    want = jalg.connected_components(g["jcsrs"][0], g["nv"], n_live=g["n_live"],
                                     backend="xla")
    for f in ("labels", "n_components", "iterations", "converged"):
        _same(getattr(got, f), getattr(given, f))
        _same(getattr(got, f), getattr(want, f))


# --- analyze(algorithms=True) -------------------------------------------------

N_WINDOWS, IP_BINS, K = 8, 1024, 10


@pytest.fixture(scope="module")
def scale10(tmp_path_factory):
    cols, n = _capture(10, tmp_path_factory.mktemp("s10"))
    t = anonymize(table_from_numpy(cols, n, device="cpu"), method="hash").table
    return cols, n, t


def test_analyze_with_algorithms_runs_three_sorts(scale10):
    with SortCounter() as counter:
        res = pipeline.analyze(scale10[2], n_windows=N_WINDOWS, ip_bins=IP_BINS,
                               k=K, algorithms=True, device="cpu")
    assert counter.n == 3
    assert res.algorithms is not None


def test_analyze_with_algorithms_matches_jax(scale10):
    cols, n, t = scale10
    jt = jax_anonymize(jax_pipeline.build_table(
        cols["src"], cols["dst"], cols["win"], n), method="hash").table
    kw = dict(n_windows=N_WINDOWS, ip_bins=IP_BINS, k=K, algorithms=True)
    want = results_to_numpy(jax_pipeline.analyze(jt, bfs_source=3, **kw))
    got = results_to_numpy(pipeline.analyze(t, bfs_source=3, device="cpu", **kw))
    assert got.keys() == want.keys()
    assert sum(k.startswith("algorithms.") for k in got) == 15
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        if key == "algorithms.pagerank.ranks":
            assert np.abs(got[key] - want[key]).sum() < L1_TOL
        elif key == "algorithms.pagerank.residual":
            assert got[key] < L1_TOL and want[key] < L1_TOL
        elif key == "algorithms.pagerank.iterations":
            assert abs(int(got[key]) - int(want[key])) <= 1
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
