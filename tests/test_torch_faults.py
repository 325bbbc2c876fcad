"""The port's fault layer (``repro_torch.data.faults``) and checkpoint
protocol (``repro_torch.train.checkpoint``), on the CPU.

Held to the JAX package: ``FaultInjector.draw`` and ``arrival_order`` (also
the suffix from a watermark) for several seeds, the ``ResilientReader``'s
health counts and quarantine records, the order ``tree_flatten`` gives the
streaming service's checkpoint tree (``jax.tree_util.tree_flatten``'s), and
the manifest a save writes.  On its own: the retry policy, validation,
quarantine and the checkpoint cases of the reference's substrate and fault
tests (round trip, ``LATEST`` ahead of a commit, retention, shape checks,
torn and missing steps)."""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.core.sketch import SketchConfig as JSketchConfig
from repro.core.sketch import init_sketch as jinit_sketch
from repro.data import faults as jfaults
from repro.stream.state import init_state as jinit_state
from repro.train import checkpoint as jckpt
from repro_torch.core.sketch import SketchConfig, init_sketch
from repro_torch.data import faults
from repro_torch.data.faults import (
    FaultConfig,
    FaultInjector,
    IngestHealth,
    PlqCorruptionError,
    Quarantine,
    ResilientReader,
    RetryPolicy,
    TransientIOError,
    inspect_quarantine,
    validate_chunk,
)
from repro_torch.data.plq import PlqCorruptionError as PlqError
from repro_torch.stream.state import init_state
from repro_torch.train.checkpoint import (
    complete_steps,
    gc_checkpoints,
    latest_step,
    read_manifest,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
    step_is_complete,
    tree_flatten,
    tree_unflatten,
)

COCKTAIL = dict(transient_io_rate=0.5, corrupt_rate=0.5, duplicate_rate=0.5,
                reorder_rate=0.5, latency_rate=0.5)


def _chunks(n_groups=6, rows=32):
    return {gi: {"src": np.arange(rows, dtype=np.int32) + 1000 * gi,
                 "dst": np.arange(rows, dtype=np.int32) + 2000 * gi}
            for gi in range(n_groups)}


def _reader(mod, cfg_kw, n_groups=6, rows=32, retry_kw=None, quarantine=None,
            start=0):
    """A ``ResilientReader`` of package ``mod`` (the port's faults module or
    the reference's) over in-memory groups, no sleeping."""
    chunks = _chunks(n_groups, rows)
    inj = mod.FaultInjector(mod.FaultConfig(**cfg_kw), n_groups)
    health = mod.IngestHealth()
    reader = mod.ResilientReader(
        lambda seq: dict(chunks[seq]), inj.arrival_order(start),
        health=health, expected_rows={gi: rows for gi in range(n_groups)},
        retry=mod.RetryPolicy(**{"base_backoff_s": 0.0, **(retry_kw or {})}),
        injector=inj, quarantine=quarantine, sleep=lambda s: None)
    return reader, inj, health, chunks


# ------------------------------------------------------- held to the reference

@pytest.mark.parametrize("seed", [0, 7, 11, 2 ** 31 + 5])
def test_fault_draws_and_arrival_order_match_reference(seed):
    """The same seed injects the identical schedule in both packages, over
    the whole capture and over every suffix a restore resumes from."""
    cfg = dict(seed=seed, **COCKTAIL)
    ours = FaultInjector(FaultConfig(**cfg), 48)
    theirs = jfaults.FaultInjector(jfaults.FaultConfig(**cfg), 48)
    for seq in range(48):
        assert dataclasses.asdict(ours.draw(seq)) == \
            dataclasses.asdict(theirs.draw(seq)), seq
    for start in (0, 1, 17, 32, 47, 48):
        assert ours.arrival_order(start) == theirs.arrival_order(start), start


@pytest.mark.parametrize("case", [
    dict(cfg=dict(seed=2, transient_io_rate=1.0, max_transient=2)),
    dict(cfg=dict(seed=5, corrupt_rate=1.0, max_torn=1)),
    dict(cfg=dict(seed=11, **COCKTAIL, max_transient=3, max_torn=2)),
    dict(cfg=dict(seed=0, corrupt_rate=1.0, max_torn=1),
         retry=dict(max_attempts=1)),
    dict(cfg=dict(seed=3, **COCKTAIL), start=4),
], ids=["transient", "torn", "cocktail", "exhausted", "suffix"])
def test_resilient_reader_health_matches_reference(case):
    got = {}
    for name, mod in (("ours", faults), ("theirs", jfaults)):
        q = mod.Quarantine()
        reader, _, health, _ = _reader(mod, case["cfg"], retry_kw=case.get("retry"),
                                       quarantine=q, start=case.get("start", 0))
        delivered = [(seq, None if c is None else {k: v.tolist()
                                                   for k, v in sorted(c.items())})
                     for seq, c in reader]
        got[name] = (health.as_dict(), delivered, q.records)
    assert got["ours"] == got["theirs"]
    assert got["ours"][0] != IngestHealth().as_dict()


def test_tree_flatten_order_is_jax_tree_util_order():
    """The service's checkpoint tree, ``{"exact": StreamState, "sketch":
    SketchState}``: 28 leaves, exact's 14 first, in ``jax.tree_util``'s order
    with the same shapes and dtypes; ``seed`` is static."""
    sk = SketchConfig(cms_depth=2, cms_width=16, hll_p=4, heavy_capacity=4, seed=9)
    ours = {"exact": init_state(64, 128, 3, 8, "cpu"),
            "sketch": init_sketch(sk, "cpu")}
    theirs = {"exact": jinit_state(64, 128, 3, 8),
              "sketch": jinit_sketch(JSketchConfig(**dataclasses.asdict(sk)))}
    leaves, treedef = tree_flatten(ours)
    jleaves, _ = jax.tree_util.tree_flatten(theirs)
    assert len(leaves) == len(jleaves) == 28
    for a, b in zip(leaves, jleaves):
        a = a.numpy()
        assert a.shape == np.asarray(b).shape and a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    back = tree_unflatten(treedef, leaves)
    assert back["sketch"].seed == 9 and back["exact"].links.row_keys[1] is leaves[4]
    assert "seed=9" in str(treedef)


def test_manifest_matches_reference(tmp_path):
    """A save of the same tree writes the same manifest keys, leaf specs and
    extra in both packages (``treedef`` is each package's own text)."""
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"c": np.ones((5,), np.int32), "z": np.int32(7)}}
    ours = {"a": torch.from_numpy(tree["a"]),
            "b": {"c": torch.from_numpy(tree["b"]["c"]),
                  "z": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path / "ours"), 3, ours, extra={"k": 1})
    jckpt.save_checkpoint(str(tmp_path / "theirs"), 3, tree, extra={"k": 1})
    m = {k: read_manifest(str(tmp_path / k), 3) for k in ("ours", "theirs")}
    assert m["ours"].keys() == m["theirs"].keys()
    for k in ("step", "n_leaves", "leaves", "extra"):
        assert m["ours"][k] == m["theirs"][k], k
    assert m["ours"]["leaves"][2]["shape"] == []  # a 0-d tensor keeps shape ()


# --------------------------------------------------------------- faults alone

def test_reexports_the_plq_corruption_error():
    assert PlqCorruptionError is PlqError


def test_injected_faults_clear_after_their_budget():
    inj = FaultInjector(FaultConfig(seed=1, transient_io_rate=1.0, corrupt_rate=1.0,
                                    max_transient=2, max_torn=1), 4)
    chunks = _chunks(4)
    d = inj.draw(0)
    assert d.n_transient >= 1 and d.n_torn == 1
    for attempt in range(d.n_transient):
        with pytest.raises(TransientIOError):
            inj.read(0, attempt, lambda s: dict(chunks[s]))
    torn = inj.read(0, d.n_transient, lambda s: dict(chunks[s]))
    assert validate_chunk(torn, 32) is not None
    clean = inj.read(0, d.n_transient + d.n_torn, lambda s: dict(chunks[s]))
    assert validate_chunk(clean, 32) is None
    np.testing.assert_array_equal(clean["src"], chunks[0]["src"])


def test_retry_policy_backoff_is_bounded_exponential():
    rp = RetryPolicy(max_attempts=8, base_backoff_s=0.01, max_backoff_s=0.05,
                     multiplier=2.0)
    walls = [rp.backoff(a) for a in range(8)]
    assert walls[:2] == pytest.approx([0.01, 0.02])
    assert walls == sorted(walls) and max(walls) == pytest.approx(0.05)
    for bad in (dict(max_attempts=0), dict(base_backoff_s=-1),
                dict(multiplier=0.5)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)
    with pytest.raises(ValueError):
        FaultConfig(corrupt_rate=1.5)
    with pytest.raises(ValueError):
        FaultConfig(max_torn=0)


def test_retry_budget_exhaustion_is_a_counted_lost_batch(tmp_path):
    q = Quarantine(str(tmp_path / "dead"))
    reader, _, health, _ = _reader(faults, dict(seed=0, corrupt_rate=1.0, max_torn=1),
                                   retry_kw=dict(max_attempts=1), quarantine=q)
    assert all(v is None for _, v in reader)
    assert health.lost_batches == 6 and health.quarantined == 6
    recs = inspect_quarantine(str(tmp_path / "dead"))
    assert len(recs) == 12 and sum(r["attempt"] == -1 for r in recs) == 6
    assert any(f.endswith(".npz") for f in os.listdir(tmp_path / "dead"))
    assert inspect_quarantine(str(tmp_path / "none")) == []


def test_reader_quarantines_crc_failures_and_rereads():
    """A read that raises ``PlqCorruptionError`` is quarantined (no payload)
    and read again."""
    calls = []

    def read(seq):
        calls.append(seq)
        if len(calls) == 1:
            raise PlqCorruptionError("crc mismatch", group=seq, column="src")
        return {"src": np.arange(4)}

    health = IngestHealth()
    q = Quarantine()
    out = list(ResilientReader(read, [0], health=health, quarantine=q,
                               sleep=lambda s: None))
    assert out[0][1] is not None and calls == [0, 0]
    assert health.quarantined == 1 and q.records[0]["columns"] is None


def test_validate_chunk_rejects_structural_damage():
    good = {"a": np.arange(4), "b": np.arange(4)}
    assert validate_chunk(good, 4) is None
    assert validate_chunk(good, 5) is not None
    assert validate_chunk({}, None) is not None
    assert validate_chunk({"a": np.arange(4), "b": np.arange(3)}) is not None
    assert validate_chunk({"a": np.zeros((2, 2))}) is not None


# ---------------------------------------------------------------- checkpoints

def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}


def _np_tree(i):
    return {"a": np.full((4,), i, np.int32), "b": np.arange(3) * i}


def test_checkpoint_roundtrip_and_latest(tmp_path):
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 10, t, extra={"k": 1})
    save_checkpoint(d, 20, t)
    assert latest_step(d) == 20
    step, tree, extra = restore_latest(d, t)
    assert step == 20 and extra == {}
    np.testing.assert_array_equal(tree["a"], t["a"].numpy())
    assert restore_checkpoint(d, 10, t)[1] == {"k": 1}


def test_checkpoint_crash_safety(tmp_path):
    """A torn tmp dir is invisible; ``LATEST`` ahead of a commit falls back."""
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 10, t)
    os.makedirs(os.path.join(d, "step_00000030.tmp"))
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("30")
    assert latest_step(d) == 10
    assert restore_latest(d, t)[0] == 10


def test_checkpoint_gc_keeps_last_k(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, _tree(), keep=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    bad = {"a": torch.zeros((2, 2)), "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    with pytest.raises(ValueError, match="leaf 0"):
        restore_checkpoint(d, 1, bad)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(d, 1, {"a": torch.zeros((3, 4))})


def test_restore_latest_skips_torn_steps(tmp_path):
    d = str(tmp_path)
    for i in (1, 2, 3):
        save_checkpoint(d, i, _np_tree(i), keep=10)
    leaf = os.path.join(d, "step_00000003", "leaf_00000.npy")
    with open(leaf, "r+b") as f:
        f.truncate(os.path.getsize(leaf) - 4)
    assert not step_is_complete(d, 3)
    assert complete_steps(d) == [1, 2]
    step, tree, _ = restore_latest(d, _np_tree(0))
    assert step == 2
    np.testing.assert_array_equal(tree["a"], _np_tree(2)["a"])
    with open(os.path.join(d, "step_00000002", "manifest.json"), "w") as f:
        f.write("{ not json")
    assert restore_latest(d, _np_tree(0))[0] == 1
    for s in (1, 2, 3):
        os.remove(os.path.join(d, f"step_{s:08d}", "manifest.json"))
    assert restore_latest(d, _np_tree(0)) is None


def test_restore_latest_survives_missing_pointed_step(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 5, _np_tree(5), keep=10)
    save_checkpoint(d, 6, _np_tree(6), keep=10)
    shutil.rmtree(os.path.join(d, "step_00000006"))
    step, tree, _ = restore_latest(d, _np_tree(0))
    assert step == 5
    np.testing.assert_array_equal(tree["b"], _np_tree(5)["b"])


def test_gc_checkpoints_retention_and_tmp_cleanup(tmp_path):
    d = str(tmp_path)
    for i in range(6):
        save_checkpoint(d, i, _np_tree(i), keep=3)
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004", "step_00000005"]
    os.makedirs(os.path.join(d, "step_00000099.tmp"))
    gc_checkpoints(d, keep=3)
    assert not os.path.exists(os.path.join(d, "step_00000099.tmp"))
    gc_checkpoints(d, keep=0)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == kept


def test_save_writes_the_atomic_protocol(tmp_path):
    """``step_%08d`` with ``leaf_%05d.npy`` files and a manifest, ``LATEST``
    holding the step, no tmp left behind; meta tensors restore as templates."""
    d = str(tmp_path)
    path = save_checkpoint(d, 7, _tree(), extra={"watermark": 7})
    assert sorted(os.listdir(path)) == ["leaf_00000.npy", "leaf_00001.npy",
                                        "manifest.json"]
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000007"]
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read() == "7"
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    assert m["n_leaves"] == 2 and m["extra"] == {"watermark": 7}
    meta = {"a": torch.empty((3, 4), device="meta"),
            "b": {"c": torch.empty(5, device="meta")}}
    tree, _ = restore_checkpoint(d, 7, meta)
    assert isinstance(tree["a"], np.ndarray) and tree["b"]["c"].dtype == np.int32
