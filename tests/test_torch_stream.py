"""The port's streaming engine (``repro_torch.stream``) against
``repro.stream`` on numpy-seeded RMAT captures, on the CPU (the plain
kernel versions): every ``StreamState`` leaf bit-equal to the reference
engine's after each of 4 batches, tails included, also when the link table
or the dictionary overflows; ``update_state_naive`` equal to
``update_state``; ``merge_states`` equal to the reference's; the sorts an
update runs; the snapshot equal to the reference's and to the NumPy oracle;
``snapshot_algorithms`` against the reference's; stable ids, re-chunking,
``degrade``'s backfill, ``load``, the ``Prefetcher``, ``read_plq_chunks``,
the scenarios and the CLI's exit codes."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import x64_shim  # noqa: F401  (fixture)
from repro.data import plq as jplq
from repro.data import scenarios as jscenarios
from repro.stream import StreamConfig as JStreamConfig
from repro.stream import StreamEngine as JStreamEngine
from repro.stream import merge_states as jmerge_states
from repro.stream.algorithms import snapshot_algorithms as jsnapshot_algorithms
from repro_torch.challenge.pipeline import window_column
from repro_torch.convert import results_to_numpy, tensor_leaves
from repro_torch.core.plan import SortCounter
from repro_torch.core.ref import ref_bfs, ref_cc, ref_run_all_queries, ref_triangles
from repro_torch.core.sketch import SketchConfig
from repro_torch.data import plq, scenarios
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.rmat import synthetic_packets
from repro_torch.obs import get_registry, reset_registry
from repro_torch.stream import (
    StreamConfig,
    StreamEngine,
    anonymization_mapping,
    init_state,
    link_table,
    merge_states,
    snapshot_algorithms,
    stream_plq,
    update_state,
    update_state_naive,
)
from repro_torch.stream import run as stream_run

pytestmark = pytest.mark.usefixtures("x64_shim")

N, SCALE, BATCH, N_WINDOWS, IP_BINS, TOP_K = 1024, 10, 256, 3, 64, 5
L1_TOL = 1e-6  # PageRank, as tests/test_torch_algorithms.py holds it


@pytest.fixture(scope="module")
def capture():
    cols = synthetic_packets(N, scale=SCALE, seed=3)
    return (cols["src"].astype(np.int32), cols["dst"].astype(np.int32),
            window_column(cols["ts"], N_WINDOWS))


def _kw(**kw):
    return dict(batch_capacity=kw.pop("batch", BATCH),
                link_capacity=kw.pop("link_capacity", N), n_windows=N_WINDOWS,
                ip_bins=IP_BINS, top_k=TOP_K, **kw)


def _engines(capture, batches=range(4), **kw):
    """The port's engine and the reference's, fed the same batches."""
    src, dst, win = capture
    ours = StreamEngine(StreamConfig(device="cpu", **_kw(**kw)))
    jkw = _kw(**kw)
    if "sketch" in jkw and jkw["sketch"] is not None:
        from repro.core.sketch import SketchConfig as JSketchConfig
        jkw["sketch"] = JSketchConfig(**dataclasses.asdict(jkw["sketch"]))
    theirs = JStreamEngine(JStreamConfig(backend="xla", **jkw))
    for b in batches:
        s = slice(b * BATCH, (b + 1) * BATCH)
        ours.ingest(src[s], dst[s], win[s])
        theirs.ingest(src[s], dst[s], win[s])
    return ours, theirs


def _leaves(state):
    return {k: np.asarray(v) for k, v in results_to_numpy(state).items()}


def _assert_states_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    assert len(got) == 14  # every leaf: the CSR's seven, both row keys among them
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


CASES = {"exact": {}, "link-overflow": dict(link_capacity=700),
         "ip-overflow": dict(ip_capacity=300)}


@pytest.mark.parametrize("case", list(CASES))
def test_update_state_bit_equal_to_reference_each_batch(capture, case):
    src, dst, win = capture
    kw = _kw(**CASES[case])
    ours = StreamEngine(StreamConfig(device="cpu", **kw))
    theirs = JStreamEngine(JStreamConfig(backend="xla", **kw))
    for b in range(4):
        s = slice(b * BATCH, (b + 1) * BATCH)
        n = BATCH - 37 * (b == 3)  # a short last batch: padded rows
        ours.ingest(src[s], dst[s], win[s], n_valid=n)
        theirs.ingest(src[s], dst[s], win[s], n_valid=n)
        _assert_states_equal(ours.state, theirs.state)
    overflow = int(ours.state.overflow)
    assert (overflow > 0) == (case != "exact")


@pytest.mark.parametrize("case", list(CASES))
def test_update_state_naive_equals_update_state(capture, case):
    src, dst, win = capture
    cfg = StreamConfig(device="cpu", **_kw(**CASES[case]))
    a = b = init_state(cfg.link_capacity, cfg.ips, N_WINDOWS, IP_BINS, "cpu")
    for i in range(4):
        cols = [torch.from_numpy(c[i * BATCH:(i + 1) * BATCH]) for c in capture]
        a = update_state(a, *cols, BATCH - 11 * i)
        b = update_state_naive(b, *cols, BATCH - 11 * i)
        _assert_states_equal(a, b)


def test_update_state_sorts(capture):
    """Five sorts an update (the endpoint union, the new IPs' ranks, the
    dictionary, the upsert's two passes); the naive path nine."""
    cfg = StreamConfig(device="cpu", **_kw())
    state = init_state(cfg.link_capacity, cfg.ips, N_WINDOWS, IP_BINS, "cpu")
    cols = [torch.from_numpy(c[:BATCH]) for c in capture]
    for fn, want in ((update_state, 5), (update_state_naive, 9)):
        with SortCounter() as c:
            fn(state, *cols, BATCH)
        assert c.n == want, fn.__name__


def test_merge_states_matches_reference(capture):
    (a, ja), (b, jb) = _engines(capture, range(2)), _engines(capture, range(2, 4))
    _assert_states_equal(merge_states(a.state, b.state),
                         jmerge_states(ja.state, jb.state))
    _assert_states_equal(merge_states(b.state, a.state),
                         jmerge_states(jb.state, ja.state))
    a.merge_from(b.state)
    full, _ = _engines(capture)
    snap, want = a.snapshot(), full.snapshot()
    assert snap.overflow == 0 and snap.n_batches == 4
    for k in ("valid_packets", "unique_links", "n_unique_ips", "max_link_packets"):
        assert int(getattr(snap.results.scalars, k)) == int(
            getattr(want.results.scalars, k)), k
    assert torch.equal(a.state.activity, full.state.activity)
    with pytest.raises(ValueError):
        small = StreamEngine(StreamConfig(device="cpu", **_kw(link_capacity=512)))
        merge_states(small.state, a.state)


def test_snapshot_matches_reference_and_oracle(capture):
    ours, theirs = _engines(capture)
    got, want = ours.snapshot(), theirs.snapshot()
    g, w = results_to_numpy(got.results), results_to_numpy(want.results)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for f in ("n_packets", "n_batches", "n_links", "n_ips", "overflow", "tier"):
        assert getattr(got, f) == getattr(want, f), f
    src, dst, _ = capture
    for k, v in ref_run_all_queries(src.astype(np.int64), dst.astype(np.int64)).items():
        assert int(getattr(got.results.scalars, k)) == v, k
    assert got.reliable and got.health.lost_batches == 0
    assert torch.equal(got.results.window_activity, ours.state.activity)


def test_snapshot_algorithms_matches_reference_and_oracles(capture):
    ours, theirs = _engines(capture)
    got = ours.algorithms(source=2)
    want = jsnapshot_algorithms(theirs.state, 2)
    assert torch.equal(got.bfs.levels, snapshot_algorithms(ours.state, 2).bfs.levels)
    g, w = results_to_numpy(got), results_to_numpy(want)
    assert g.keys() == w.keys()
    for k in w:
        if k == "pagerank.ranks":
            assert np.abs(g[k] - w[k]).sum() < L1_TOL
        elif k == "pagerank.residual":
            assert g[k] < L1_TOL and w[k] < L1_TOL
        elif k == "pagerank.iterations":
            assert abs(int(g[k]) - int(w[k])) <= 1
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the oracles, on the link table in the stable-id domain
    t = link_table(ours.state)
    n = int(t.n_valid)
    s, d = (t[c][:n].numpy().astype(np.int64) for c in ("src", "dst"))
    n_live = int(ours.state.n_ips)
    levels = got.bfs.levels.numpy()
    assert np.array_equal(levels[:n_live], ref_bfs(s, d, n_live, 2))
    assert np.array_equal(got.components.labels.numpy()[:n_live], ref_cc(s, d, n_live))
    per_node, total = ref_triangles(s, d, n_live)
    assert int(got.triangles.total) == total


def test_ids_stable_across_batches_and_rechunking(capture):
    src, dst, win = capture
    eng = StreamEngine(StreamConfig(device="cpu", **_kw()))
    seen = {}
    for s in range(0, N, BATCH):
        eng.ingest(src[s:s + BATCH], dst[s:s + BATCH], win[s:s + BATCH])
        ips, ids = anonymization_mapping(eng.state)
        current = dict(zip(ips.tolist(), ids.tolist()))
        assert all(current[ip] == i for ip, i in seen.items())
        seen = current
    assert sorted(seen.values()) == list(range(len(seen)))
    other = StreamEngine(StreamConfig(device="cpu", **_kw(batch=100)))
    for s in range(0, N, 100):
        other.ingest(src[s:s + 100], dst[s:s + 100], win[s:s + 100])
    a, b = _leaves(eng.state), _leaves(other.state)
    for k in a:
        if k != "n_batches":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_degrade_backfills_the_sketch_as_the_reference(capture):
    sketch = SketchConfig(cms_depth=3, cms_width=128, hll_p=6, heavy_capacity=8)
    ours, theirs = _engines(capture, range(2), sketch=sketch)
    for eng in (ours, theirs):
        eng.degrade("both")
    src, dst, win = capture
    for b in (2, 3):
        s = slice(b * BATCH, (b + 1) * BATCH)
        ours.ingest(src[s], dst[s], win[s])
        theirs.ingest(src[s], dst[s], win[s])
    for f in dataclasses.fields(ours.sketch_state):
        g, w = getattr(ours.sketch_state, f.name), getattr(theirs.sketch_state, f.name)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f.name)
    snap = ours.snapshot()
    assert snap.tier == "both" and snap.sketch.n_packets == N
    assert snap.health.degraded_to == "both" and snap.health.degraded_at_batch == 2
    with pytest.raises(ValueError):
        ours.degrade("exact")


def test_load_copies_every_leaf(capture):
    src, dst, win = capture
    eng, _ = _engines(capture, range(1))
    fresh = StreamEngine(StreamConfig(device="cpu", **_kw()))
    fresh.load(eng.state)
    ptrs = lambda st: [v.data_ptr() for _, v in tensor_leaves(st)]
    mine, theirs = ptrs(fresh.state), ptrs(eng.state)
    assert len(set(mine)) == len(mine) == 14
    assert not set(mine) & set(theirs)
    _assert_states_equal(fresh.state, eng.state)
    fresh.ingest(src[BATCH:2 * BATCH], dst[BATCH:2 * BATCH], win[BATCH:2 * BATCH])
    assert int(eng.state.n_batches) == 1  # the source is untouched
    # arrays restored on the host (numpy leaves) load as fresh tensors too
    restored = _as_numpy(eng.state)
    fresh.load(restored)
    _assert_states_equal(fresh.state, eng.state)
    restored.ip_values[:] = -1
    assert int(fresh.state.ip_values[0]) != -1


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().copy()
    if isinstance(x, tuple):
        return tuple(_as_numpy(v) for v in x)
    return dataclasses.replace(x, **{f.name: _as_numpy(getattr(x, f.name))
                                     for f in dataclasses.fields(x)})


def test_init_state_leaves_never_alias():
    st = init_state(64, 128, N_WINDOWS, IP_BINS, "cpu")
    ptrs = [t.data_ptr() for _, t in tensor_leaves(st)]
    assert len(ptrs) == 14 and len(set(ptrs)) == 14


def test_snapshot_distributed_is_refused(capture):
    eng, _ = _engines(capture, range(1))
    with pytest.raises(NotImplementedError, match="item 10"):
        eng.snapshot(distributed=True)


def test_prefetcher_reraises_producer_error():
    def produce():
        yield 1
        yield 2
        raise OSError("torn read")

    seen = []
    with Prefetcher(produce(), depth=1) as p:
        with pytest.raises(OSError, match="torn read"):
            for item in p:
                seen.append(item)
    assert seen in ([], [1], [1, 2])
    with Prefetcher(iter(range(5)), depth=2) as p:
        assert list(p) == list(range(5))


def test_read_plq_chunks_match_reference_and_check_crc(tmp_path):
    cols = synthetic_packets(1000, scale=8, seed=1)
    path = str(tmp_path / "c.plq")
    plq.write_plq(path, cols, row_group_size=300)
    got = list(plq.read_plq_chunks(path, ["src", "dst"]))
    want = list(jplq.read_plq_chunks(path, ["src", "dst"]))
    assert [len(c["src"]) for c in got] == [300, 300, 300, 100]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(
        plq.read_plq_group(path, 2, ["dst"])["dst"], cols["dst"][600:900])
    page = plq.plq_info(path)["groups"][1]["pages"]["dst"]
    with open(path, "r+b") as f:
        f.seek(page["offset"] + 5)
        byte = f.read(1)
        f.seek(page["offset"] + 5)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(plq.PlqCorruptionError, match="CRC32") as e:
        list(plq.read_plq_chunks(path, ["src", "dst"]))
    assert (e.value.group, e.value.column) == (1, "dst")
    with pytest.raises(IndexError):
        plq.read_plq_group(path, 4)


@pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
def test_scenarios_match_reference(name):
    got = scenarios.scenario_packets(name, 2048, scale=9, seed=4)
    want = jscenarios.scenario_packets(name, 2048, scale=9, seed=4)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_stream_plq_equals_ingest_and_fills_the_registry(capture, tmp_path):
    reset_registry()
    n = 1000
    cols = synthetic_packets(n, scale=SCALE, seed=3)
    path = str(tmp_path / "s.plq")
    plq.write_plq(path, cols, row_group_size=BATCH)
    win = window_column(cols["ts"], N_WINDOWS)
    eng = StreamEngine(StreamConfig(device="cpu", **_kw()))
    timings = stream_plq(eng, path, win, time_phases=True)
    assert [t.n_packets for t in timings] == [256, 256, 256, 232]
    assert timings[0].compile and not any(t.compile for t in timings[1:])
    other = StreamEngine(StreamConfig(device="cpu", **_kw()))
    src, dst = cols["src"].astype(np.int32), cols["dst"].astype(np.int32)
    for s in range(0, n, BATCH):
        other.ingest(src[s:s + BATCH], dst[s:s + BATCH], win[s:s + BATCH])
    _assert_states_equal(eng.state, other.state)
    reg = get_registry()
    assert reg.get("stream_batches_ingested_total").value == 8
    assert reg.get("stream_packets_ingested_total").value == 2 * n
    assert reg.get("stream_batch_seconds").count == 3
    eng.snapshot()
    assert reg.get("stream_links").value == int(eng.state.n_links)
    assert "stream_overflow 0" in reg.to_prometheus()
    reset_registry()


def test_cli_exit_codes(tmp_path, capsys):
    base = ["--scale", "9", "--batches", "3", "--windows", "2", "--device", "cpu",
            "--workdir", str(tmp_path)]
    assert stream_run.main(base + ["--tier", "both", "--snapshot-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "all scalar queries match the NumPy oracle" in out
    assert "all sketch estimates within their configured bounds" in out
    assert "[batch 1] packets=" in out
    assert stream_run.main(base + ["--link-capacity", "100"]) == 1
    assert "state overflow" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        stream_run.main(base + ["--distributed"])
    assert e.value.code == 2
    assert "item 10" in capsys.readouterr().err
