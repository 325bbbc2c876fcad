"""The port's challenge slice on the CPU: the whole ``analyze`` at scale 10
against the JAX ``analyze`` through ``repro_torch.convert`` (bit for bit, on
every output), the three-sort budget, the CSR windowed suite and the
cross-window overlap against the NumPy oracle, anonymization, the timed
run and the CLI."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import x64_shim  # noqa: F401  (fixture)
from repro.challenge import pipeline as jax_pipeline
from repro.core.anonymize import anonymize as jax_anonymize
from repro_torch.challenge import pipeline
from repro_torch.challenge.run import main
from repro_torch.convert import results_to_numpy, table_from_numpy
from repro_torch.core.anonymize import anonymize
from repro_torch.core.plan import SortCounter
from repro_torch.core.ref import (
    ref_anonymize_check,
    ref_run_all_queries,
    ref_top_links,
    ref_window_ip_overlap,
)
from repro_torch.core.temporal import windowed_queries
from repro_torch.obs import export_jsonl, get_tracer, read_jsonl

N_WINDOWS, IP_BINS, K = 8, 1024, 10
ROOT = Path(__file__).resolve().parents[1]


def _columns(scale, tmp_path, capacity=None):
    cfg = jax_pipeline.ChallengeConfig(scale=scale, capacity=capacity)
    cols = jax_pipeline.read_phase(cfg, str(tmp_path))
    src, dst, win, n = jax_pipeline.build_columns(cols, cfg)
    return cols, {"src": src, "dst": dst, "win": win}, n


@pytest.fixture(scope="module")
def scale10(tmp_path_factory):
    """Scale-10 capture padded to 1100 rows, hash-anonymized by the port."""
    cols, table_cols, n = _columns(10, tmp_path_factory.mktemp("s10"), 1100)
    t = table_from_numpy(table_cols, n, device="cpu")
    return cols, table_cols, n, anonymize(t, method="hash").table


@pytest.mark.parametrize("fused", [False, True])
def test_analyze_matches_jax_bit_for_bit(x64_shim, scale10, fused):
    _, table_cols, n, anon = scale10
    jt = jax_anonymize(
        jax_pipeline.build_table(table_cols["src"], table_cols["dst"],
                                 table_cols["win"], n), method="hash").table
    for c in ("src", "dst", "win"):  # hash anonymization is bit-identical
        np.testing.assert_array_equal(anon[c].numpy(), np.asarray(jt[c]))
    kw = dict(n_windows=N_WINDOWS, ip_bins=IP_BINS, k=K, fused_epilogue=fused)
    want = results_to_numpy(jax_pipeline.analyze(jt, **kw))
    got = results_to_numpy(pipeline.analyze(anon, device="cpu", **kw))
    assert got.keys() == want.keys() and len(got) == 50
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("fused", [False, True])
def test_analyze_runs_three_sorts(scale10, fused):
    anon = scale10[3]
    with SortCounter() as counter:
        pipeline.analyze(anon, n_windows=N_WINDOWS, ip_bins=IP_BINS, k=K,
                         fused_epilogue=fused, device="cpu")
    assert counter.n == 3


def test_sort_counter_sees_hidden_sorts():
    with SortCounter() as counter:
        torch.unique(torch.tensor([3, 1, 3]))
        torch.topk(torch.arange(5), 2)
    assert counter.n == 2


def _per_window_oracle(src, dst, win, names):
    rows = [ref_run_all_queries(src[win == w], dst[win == w])
            for w in range(N_WINDOWS)]
    return {k: np.array([r[k] for r in rows]) for k in names}


@pytest.mark.parametrize("fused", [False, True])
def test_windowed_queries_match_numpy_oracle(scale10, fused):
    _, table_cols, n, anon = scale10
    got = windowed_queries(anon, 1, N_WINDOWS, ts_col="win", t0=0, fused=fused)
    src, dst = anon["src"][:n].numpy(), anon["dst"][:n].numpy()
    want = _per_window_oracle(src, dst, table_cols["win"][:n], got)
    assert len(got) == 9
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_overlap_top_links_and_activity_match_numpy_oracle(scale10):
    _, table_cols, n, anon = scale10
    res = pipeline.analyze(anon, n_windows=N_WINDOWS, ip_bins=IP_BINS, k=K,
                           device="cpu")
    src, dst = anon["src"][:n].numpy(), anon["dst"][:n].numpy()
    win = table_cols["win"][:n]
    np.testing.assert_array_equal(res.window_ip_overlap.numpy(),
                                  ref_window_ip_overlap(src, dst, win, N_WINDOWS))
    ts, td, tp = ref_top_links(src, dst, K)
    np.testing.assert_array_equal(res.top.src.numpy(), ts)
    np.testing.assert_array_equal(res.top.dst.numpy(), td)
    np.testing.assert_array_equal(res.top.packets.numpy(), tp)
    act = res.window_activity.sum(dim=1).to(torch.int32)
    np.testing.assert_array_equal(act.numpy(), res.windowed["valid_packets"].numpy())


def test_shuffle_anonymization_is_an_isomorphism(scale10):
    cols, table_cols, n, _ = scale10
    t = table_from_numpy(table_cols, n, device="cpu")
    anon = anonymize(t, torch.Generator().manual_seed(3), method="shuffle",
                     rounds=2).table
    assert ref_anonymize_check(table_cols["src"][:n], table_cols["dst"][:n],
                               anon["src"][:n].numpy(), anon["dst"][:n].numpy())
    with pytest.raises(ValueError, match="Generator"):
        anonymize(t, method="shuffle")


def test_run_challenge_on_cpu_matches_oracle_and_spans(tmp_path):
    get_tracer().clear()
    cfg = pipeline.ChallengeConfig(scale=9, n_windows=2, device="cpu",
                                   workdir=str(tmp_path), fmt="pcaplite")
    run = pipeline.run_challenge(cfg)
    ref = ref_run_all_queries(run.capture["src"].astype(np.int64),
                              run.capture["dst"].astype(np.int64))
    assert {k: int(v) for k, v in run.results.scalars.as_dict().items()} == ref
    assert run.timings.compile_s is not None and run.timings.total_s > 0
    path = tmp_path / "spans.jsonl"
    export_jsonl(str(path))
    records = read_jsonl(str(path))
    assert records[0]["kind"] == "run" and "torch_version" in records[0]
    assert pipeline.timings_from_spans(records) == run.timings


def test_cli_on_cpu_prints_report_and_oracle_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.challenge.run", "--scale", "9",
         "--windows", "2", "--device", "cpu", "--workdir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "all scalar queries match the NumPy oracle" in proc.stdout
    assert "14 max destination fan-in" in proc.stdout
    assert "top-10 heaviest links" in proc.stdout


def test_cli_algorithms_and_sketch_tier_on_cpu(tmp_path, capsys):
    rc = main(["--scale", "9", "--windows", "2", "--device", "cpu",
               "--algorithms", "--tier", "both", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    for line in ("all scalar queries match the NumPy oracle",
                 "all four graph algorithms match their NumPy oracles",
                 "all sketch estimates within their configured bounds",
                 "graph algorithms over the anonymized traffic graph",
                 "sketch tier (bounded memory"):
        assert line in out


@pytest.mark.parametrize("flag", [["--fused"], ["--distributed"], ["--autotune"]])
def test_cli_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--scale", "9", "--device", "cpu", *flag])
    assert e.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_challenge(pipeline.ChallengeConfig(scale=6))
    t = table_from_numpy({"src": np.zeros(4, np.int32)}, 4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.analyze(t, n_windows=1, ip_bins=4, k=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table_from_numpy({"src": np.zeros(4, np.int32)}, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--scale", "6"])


def test_span_records_are_json(tmp_path):
    with get_tracer().span("probe", n=torch.tensor(3), v=torch.arange(2)):
        pass
    rec = get_tracer().records()[-1]
    assert rec["attrs"] == {"n": 3, "v": [0, 1]}
    assert json.loads(json.dumps(rec)) == rec
