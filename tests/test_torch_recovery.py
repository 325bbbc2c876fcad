"""The port's fault-tolerant streaming service (``repro_torch.stream.
recovery``) and its CLI (``python -m repro_torch.launch.serve``), on the CPU
(``device="cpu"``, the plain kernel versions), at the reference battery's
size: 2,048 packets in row groups of 256, 3 windows, 64 bins, scale 10.

Held to ``repro.stream``: the final state leaves and the health ledger of
``run_service`` under the chaos cocktail plus a crash, and checkpoints
restored across packages both ways (a step the reference saves finishes in
the port, and one the port saves finishes in the reference, each equal to
an uninterrupted run).  Held to the port's own uninterrupted
``stream_plq``: a crash at every batch boundary on both tiers, a crash
without a checkpoint directory, the restart budget, the torn-step fallback,
foreign geometry, lost batches, degradation before overflow and across a
crash, and the dead engine freed before the restore."""
import dataclasses
import gc
import json
import os
import weakref

import jax
import numpy as np
import pytest
import torch

from _torch_parity import x64_shim  # noqa: F401  (fixture)
from repro.data.faults import FaultConfig as JFaultConfig
from repro.data.faults import RetryPolicy as JRetryPolicy
from repro.stream import StreamConfig as JStreamConfig
from repro.stream import StreamEngine as JStreamEngine
from repro.stream import SimulatedCrash as JSimulatedCrash
from repro.stream import run_service as jrun_service
from repro.stream import stream_plq as jstream_plq
from repro_torch.challenge.pipeline import window_column
from repro_torch.data.faults import (FaultConfig, IngestHealth, RetryPolicy,
                                     inspect_quarantine)
from repro_torch.data.plq import write_plq
from repro_torch.data.rmat import synthetic_packets
from repro_torch.launch import serve
from repro_torch.obs import get_registry, reset_registry
from repro_torch.stream import recovery
from repro_torch.stream import (
    DegradePolicy,
    SimulatedCrash,
    StreamCheckpointer,
    StreamConfig,
    StreamEngine,
    run_service,
    stream_plq,
)
from repro_torch.train.checkpoint import tree_flatten

N, BATCH, NW, SCALE = 2048, 256, 3, 10
N_BATCHES = N // BATCH
# the serve CLI's --chaos cocktail
CHAOS = dict(seed=11, transient_io_rate=0.25, corrupt_rate=0.25,
             duplicate_rate=0.2, reorder_rate=0.2)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    cols = synthetic_packets(N, scale=SCALE, seed=0)
    path = str(tmp_path_factory.mktemp("cap") / "cap.plq")
    write_plq(path, cols, row_group_size=BATCH)
    return path, window_column(cols["ts"], NW)


def _kw(tier="exact", link_capacity=N, **kw):
    return dict(batch_capacity=BATCH, link_capacity=link_capacity, n_windows=NW,
                ip_bins=64, top_k=5, tier=tier, **kw)


def _cfg(**kw):
    return StreamConfig(backend="torch", device="cpu", **_kw(**kw))


def _jcfg(**kw):
    return JStreamConfig(backend="xla", **_kw(**kw))


_ORACLES = {}


def _oracle(capture, **kw):
    """The port's uninterrupted fault-free run every recovery must match
    (one per configuration and module)."""
    key = tuple(sorted(kw.items()))
    if key not in _ORACLES:
        eng = StreamEngine(_cfg(**kw))
        stream_plq(eng, *capture)
        _ORACLES[key] = eng
    return _ORACLES[key]


def _leaves(engine):
    """Every leaf of the exact state, then of the sketch, as numpy."""
    tree = {"exact": engine.state}
    if engine.sketch_state is not None:
        tree["sketch"] = engine.sketch_state
    return [np.asarray(x) for x in tree_flatten(tree)[0]]


def _jleaves(engine):
    tree = {"exact": engine.state}
    if engine.sketch_state is not None:
        tree["sketch"] = engine.sketch_state
    return [np.asarray(x) for x in jax.tree_util.tree_flatten(tree)[0]]


def _assert_leaves_equal(got, want):
    assert len(got) == len(want) and len(got) in (14, 28)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def _assert_scalars_equal(snap, want):
    got, want = snap.results.scalars.as_dict(), want.results.scalars.as_dict()
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}


# ---------------------------------------------------- held to the reference

@pytest.mark.usefixtures("x64_shim")
def test_chaos_and_crash_match_reference(capture, tmp_path):
    """The cocktail plus a crash after batch 4: the port's final leaves,
    health ledger, restarts, watermark and quarantine trail equal the
    reference's under the same ``FaultConfig``."""
    path, win = capture
    runs = {}
    for name, fn, cfg, faults, retry in (
            ("ours", run_service, _cfg(tier="both"),
             FaultConfig(crash_at_batch=4, **CHAOS), RetryPolicy(base_backoff_s=0.0)),
            ("theirs", jrun_service, _jcfg(tier="both"),
             JFaultConfig(crash_at_batch=4, **CHAOS), JRetryPolicy(base_backoff_s=0.0))):
        report = fn(cfg, path, win, checkpoint_dir=str(tmp_path / name / "ck"),
                    faults=faults, retry=retry,
                    quarantine_dir=str(tmp_path / name / "q"))
        runs[name] = (report, inspect_quarantine(str(tmp_path / name / "q")))
    (ours, q_ours), (theirs, q_theirs) = runs["ours"], runs["theirs"]
    _assert_leaves_equal(_leaves(ours.engine), _jleaves(theirs.engine))
    assert ours.health.as_dict() == theirs.health.as_dict()
    assert (ours.restarts, ours.watermark) == (theirs.restarts, theirs.watermark) == (1, 8)
    assert q_ours == q_theirs and q_ours
    h = ours.health
    assert h.faults_seen > 0 and h.crashes_recovered == 1 and h.lost_batches == 0
    _assert_leaves_equal(_leaves(ours.engine), _leaves(_oracle(capture, tier="both")))


@pytest.mark.usefixtures("x64_shim")
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_restore_across_packages(capture, tmp_path, writer):
    """One package folds batches 0-4, commits 0-3 (watermarks 1-4) and
    dies before batch 4's commit; the other boots from those files at
    watermark 4 and finishes.  The result equals the uninterrupted run of
    the package that finishes, leaf for leaf."""
    path, win = capture
    ck = str(tmp_path / "ck")
    if writer == "reference":
        with pytest.raises(JSimulatedCrash):
            jrun_service(_jcfg(tier="both"), path, win, checkpoint_dir=ck,
                         faults=JFaultConfig(crash_at_batch=4), max_restarts=0)
        report = run_service(_cfg(tier="both"), path, win, checkpoint_dir=ck)
        got, want = _leaves(report.engine), _leaves(_oracle(capture, tier="both"))
    else:
        with pytest.raises(SimulatedCrash):
            run_service(_cfg(tier="both"), path, win, checkpoint_dir=ck,
                        faults=FaultConfig(crash_at_batch=4), max_restarts=0)
        report = jrun_service(_jcfg(tier="both"), path, win, checkpoint_dir=ck)
        oracle = JStreamEngine(_jcfg(tier="both"))
        jstream_plq(oracle, path, win)
        got, want = _jleaves(report.engine), _jleaves(oracle)
    _assert_leaves_equal(got, want)
    # 4 commits before the crash (watermarks 1-4) come back in the ledger
    assert report.health.checkpoints_committed == N_BATCHES
    assert report.watermark == N_BATCHES and report.restarts == 0
    assert report.health.batches_replayed == 0


# ------------------------------------------- the port against its own stream

def test_checkpointer_watermark_roundtrip(capture, tmp_path):
    eng = _oracle(capture, tier="both")
    health = dataclasses.replace(eng.health)
    cfg = _cfg(tier="both")
    ck = StreamCheckpointer(str(tmp_path), cfg)
    ck.save(eng, watermark=N_BATCHES)
    eng.health = health  # the oracle is shared: undo the commit's count
    assert os.path.isdir(tmp_path / f"step_{N_BATCHES:08d}")
    rp = StreamCheckpointer(str(tmp_path), cfg).restore_latest()
    assert rp is not None and rp.watermark == N_BATCHES
    assert rp.tier == "both" and rp.sketch_state is not None
    assert rp.health.checkpoints_committed == 1
    back = StreamEngine(cfg)
    back.load(rp.state, rp.sketch_state)
    _assert_leaves_equal(_leaves(back), _leaves(eng))
    reg = get_registry()
    assert reg.get("serve_watermark").value == N_BATCHES
    assert reg.get("checkpoint_save_seconds").count >= 1


def test_checkpointer_rejects_foreign_geometry(capture, tmp_path):
    StreamCheckpointer(str(tmp_path), _cfg()).save(
        StreamEngine(_cfg()), watermark=N_BATCHES)
    assert StreamCheckpointer(str(tmp_path), _cfg(link_capacity=N // 2)
                              ).restore_latest() is None
    # placement and query knobs are not geometry
    same = dataclasses.replace(_cfg(), top_k=9, backend="auto")
    assert StreamCheckpointer(str(tmp_path), same).restore_latest() is not None


def test_checkpointer_falls_back_over_torn_step(capture, tmp_path):
    path, win = capture
    cfg = _cfg()
    ck = StreamCheckpointer(str(tmp_path), cfg, keep=10)
    walls = []
    stream_plq(StreamEngine(cfg), path, win,
               on_batch=lambda i, e: walls.append(ck.save(e, watermark=i + 1)))
    leaf = os.path.join(walls[-1], "leaf_00000.npy")
    with open(leaf, "r+b") as f:
        f.truncate(os.path.getsize(leaf) - 4)
    rp = StreamCheckpointer(str(tmp_path), cfg).restore_latest()
    assert rp is not None and rp.watermark == N_BATCHES - 1


@pytest.mark.parametrize("tier", ["exact", "both"])
@pytest.mark.parametrize("crash_at", range(N_BATCHES))
def test_crash_at_every_batch_boundary(capture, tmp_path, tier, crash_at):
    """Kill after each batch in turn, on the exact tier and on both: the
    recovered state (sketch included) is bit-identical to an uninterrupted
    run; exactly the uncommitted batch replays, one commit per batch."""
    path, win = capture
    report = run_service(_cfg(tier=tier), path, win,
                         checkpoint_dir=str(tmp_path / "ck"),
                         faults=FaultConfig(crash_at_batch=crash_at))
    oracle = _oracle(capture, tier=tier)
    _assert_leaves_equal(_leaves(report.engine), _leaves(oracle))
    snap = report.snapshot()
    _assert_scalars_equal(snap, oracle.snapshot())
    h = report.health
    assert report.restarts == 1 and h.crashes_recovered == 1
    assert h.batches_replayed == 1 and h.lost_batches == 0
    assert h.checkpoints_committed == N_BATCHES and report.watermark == N_BATCHES
    assert snap.reliable and len(report.restore_walls) == (crash_at > 0)
    if tier == "both":
        assert snap.sketch.n_packets == N


def test_crash_without_checkpoint_dir_replays_from_zero(capture):
    report = run_service(_cfg(), *capture, faults=FaultConfig(crash_at_batch=5))
    _assert_leaves_equal(_leaves(report.engine), _leaves(_oracle(capture)))
    assert report.restarts == 1
    assert report.health.batches_replayed == 6  # groups [0, 5] re-folded
    assert report.checkpoint_walls == [] and report.restore_walls == []


def test_crash_budget_exhaustion_propagates(capture, tmp_path):
    with pytest.raises(SimulatedCrash) as e:
        run_service(_cfg(), *capture, checkpoint_dir=str(tmp_path / "ck"),
                    faults=FaultConfig(crash_at_batch=2), max_restarts=0)
    assert e.value.at_seq == 3


def test_crash_frees_the_dead_engine_before_the_restore(capture, tmp_path,
                                                        monkeypatch):
    """With the cycle collector off, every earlier engine is gone when the
    service builds the next one: nothing (the crash's traceback included)
    keeps a dead state alive beside the restored one."""
    built = []

    class Checked(StreamEngine):
        def __init__(self, cfg):
            assert all(ref() is None for ref in built), "a dead engine lives on"
            super().__init__(cfg)
            built.append(weakref.ref(self))

    monkeypatch.setattr(recovery, "StreamEngine", Checked)
    gc.collect()
    gc.disable()
    try:
        run_service(_cfg(tier="both"), *capture, checkpoint_dir=str(tmp_path / "ck"),
                    faults=FaultConfig(crash_at_batch=3))
    finally:
        gc.enable()
    assert len(built) == 2


def test_chaos_is_seeded_and_counted(capture, tmp_path):
    """The cocktail fires, nothing is lost, and a second run observes the
    identical ledger."""
    path, win = capture
    kw = dict(faults=FaultConfig(crash_at_batch=4, **CHAOS),
              retry=RetryPolicy(base_backoff_s=0.0))
    a = run_service(_cfg(), path, win, checkpoint_dir=str(tmp_path / "a"), **kw)
    b = run_service(_cfg(), path, win, checkpoint_dir=str(tmp_path / "b"), **kw)
    assert a.health.as_dict() == b.health.as_dict()
    assert a.health.faults_seen > 0 and a.snapshot().reliable
    _assert_leaves_equal(_leaves(a.engine), _leaves(_oracle(capture)))


def test_unrecoverable_batches_are_counted_never_silent(capture, tmp_path):
    report = run_service(
        _cfg(), *capture,
        faults=FaultConfig(seed=1, corrupt_rate=1.0, max_torn=1),
        retry=RetryPolicy(max_attempts=1, base_backoff_s=0.0),
        quarantine_dir=str(tmp_path / "dead"))
    snap = report.snapshot()
    assert report.health.lost_batches == snap.health.lost_batches == N_BATCHES
    assert not snap.reliable and snap.n_packets == 0
    trail = inspect_quarantine(str(tmp_path / "dead"))
    assert sum(r["attempt"] == -1 for r in trail) == N_BATCHES


def test_degradation_sheds_exact_tier_before_overflow(capture):
    cap = 1500  # the capture holds about 1.9k links
    policy = DegradePolicy(to_both=0.5, to_sketch=1 - BATCH / cap)
    report = run_service(_cfg(link_capacity=cap, ip_capacity=4 * N), *capture,
                         degrade=policy)
    snap = report.snapshot()
    assert snap.tier == "sketch" and report.health.degraded_to == "sketch"
    assert report.health.degraded_at_batch is not None
    assert int(report.engine.state.overflow) == 0
    assert snap.overflow is None and snap.results is None
    assert snap.sketch.n_packets == N  # the backfill covers the history
    assert snap.reliable


def test_degradation_survives_crash_and_restore(capture, tmp_path):
    cap = 1500
    cfg = _cfg(link_capacity=cap, ip_capacity=4 * N)
    policy = DegradePolicy(to_both=0.3, to_sketch=1 - BATCH / cap)
    uninterrupted = run_service(cfg, *capture, degrade=policy)
    assert uninterrupted.health.degraded_to == "sketch"
    report = run_service(cfg, *capture, checkpoint_dir=str(tmp_path / "ck"),
                         faults=FaultConfig(crash_at_batch=N_BATCHES - 1),
                         degrade=policy)
    assert report.engine.cfg.tier == "sketch"
    assert report.health.degraded_at_batch == uninterrupted.health.degraded_at_batch
    _assert_leaves_equal(_leaves(report.engine), _leaves(uninterrupted.engine))


def test_degrade_is_forward_only_and_the_policy_validates():
    with pytest.raises(ValueError, match="forward-only"):
        StreamEngine(_cfg(tier="both")).degrade("exact")
    with pytest.raises(ValueError, match="forward-only"):
        StreamEngine(_cfg(tier="sketch")).degrade("both")
    with pytest.raises(ValueError, match="unknown tier"):
        StreamEngine(_cfg()).degrade("bogus")
    for bad in (dict(to_both=0.9, to_sketch=0.5), dict(to_both=0.0),
                dict(check_every=0)):
        with pytest.raises(ValueError):
            DegradePolicy(**bad)
    assert DegradePolicy().apply(StreamEngine(_cfg(tier="sketch"))) is None


def test_snapshot_surfaces_health_and_tier(capture):
    report = run_service(_cfg(), *capture)
    snap = report.snapshot()
    assert snap.tier == "exact" and isinstance(snap.health, IngestHealth)
    assert snap.health.faults_seen == 0 and snap.reliable
    report.engine.health.lost_batches = 99
    assert snap.health.lost_batches == 0  # a copy, not a live alias


def test_run_service_needs_a_card_unless_asked_for_the_cpu(capture):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_service(StreamConfig(**_kw()), *capture)


# ------------------------------------------------------------------ the CLI

def test_serve_cli_chaos_crash_verify(tmp_path, capsys):
    d = tmp_path
    m = str(d / "m.jsonl")
    argv = ["--scale", str(SCALE), "--n-packets", str(N), "--batch-size", str(BATCH),
            "--tier", "both", "--chaos", "--fault-seed", "11", "--crash-at-batch", "4",
            "--checkpoint-dir", str(d / "ck"), "--quarantine-dir", str(d / "q"),
            "--metrics-out", m, "--verify", "--device", "cpu",
            "--workdir", str(d / "w")]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "[serve] verify OK" in out and "crashes=1" in out
    assert "[serve] health:" in out and "[serve] batch latency:" in out
    with open(m) as f:
        recs = [json.loads(line) for line in f]
    assert recs[0]["kind"] == "run" and "torch_version" in recs[0]
    spans = [r for r in recs if r.get("kind") == "span"]
    assert {r["name"] for r in spans} >= {"serve_stream", "serve_query"}
    assert all({"git_sha", "torch_version", "cuda_version", "device"} <= r.keys()
               for r in spans)
    names = {r.get("name") for r in recs}
    assert {"serve_commits_total", "checkpoint_save_seconds",
            "serve_watermark", "serve_fold_seconds"} <= names
    with open(m + ".prom") as f:
        assert f"serve_watermark {N_BATCHES}" in f.read()
    reset_registry()


def test_serve_cli_exit_codes(tmp_path, capsys):
    base = ["--scale", "9", "--n-packets", "1024", "--batch-size", "256",
            "--device", "cpu", "--workdir", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        serve.main(base + ["--distributed"])
    assert e.value.code == 2 and "item 10" in capsys.readouterr().err
    assert serve.main(base + ["--link-capacity", "100"]) == 1
    assert "state overflow" in capsys.readouterr().err
    assert serve.main(base + ["--tier", "sketch", "--verify"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(base[:-4] + ["--workdir", str(tmp_path)])
    reset_registry()
