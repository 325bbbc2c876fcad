"""The port's challenge slice on the CPU: the whole ``analyze`` at scale 10
against the JAX ``analyze`` through ``repro_torch.convert`` (bit for bit, on
every output), the three-sort budget, the CSR windowed suite and the
cross-window overlap against the NumPy oracle, anonymization, the timed
run and the CLI; then the A/B baselines (``analyze(use_plan=False)``,
``windowed_method="grid"``, both overlap methods and the naive one) at
scales 10 and 12 against the plan path and against JAX's, their sort
counts, and the one-program path (``fused=True``, ``--fused``)."""
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


@pytest.mark.parametrize("flag", [["--distributed"], ["--autotune"]])
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


# --- the A/B baselines and the one-program path ------------------------------

@pytest.fixture(scope="module", params=[10, 12])
def both_tables(request, tmp_path_factory):
    """The port's and JAX's hash-anonymized tables of one capture."""
    from _torch_parity import x64_shim_applied

    with x64_shim_applied():
        cols, table_cols, n = _columns(request.param,
                                       tmp_path_factory.mktemp("ab"))
        t = anonymize(table_from_numpy(table_cols, n, device="cpu"),
                      method="hash").table
        jt = jax_anonymize(jax_pipeline.build_table(
            table_cols["src"], table_cols["dst"], table_cols["win"], n),
            method="hash").table
    return t, jt, table_cols, n


def _same_results(got, want):
    assert got.keys() == want.keys() and len(got) == 50
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


AB = {"naive": dict(use_plan=False), "grid": dict(windowed_method="grid")}


@pytest.mark.parametrize("mode", sorted(AB))
def test_ab_baselines_match_the_plan_path_and_jax(x64_shim, both_tables, mode):
    t, jt, _, _ = both_tables
    kw = dict(n_windows=N_WINDOWS, ip_bins=IP_BINS, k=K)
    got = results_to_numpy(pipeline.analyze(t, device="cpu", **AB[mode], **kw))
    _same_results(got, results_to_numpy(pipeline.analyze(t, device="cpu", **kw)))
    _same_results(got, results_to_numpy(jax_pipeline.analyze(jt, **AB[mode], **kw)))


@pytest.mark.parametrize("method", ["scan", "grid", "naive"])
def test_overlap_methods_match_jax_and_oracle(x64_shim, both_tables, method):
    t, jt, table_cols, n = both_tables
    if method == "naive":
        got = pipeline.cross_window_ip_overlap_naive(t, N_WINDOWS)
        want = jax_pipeline.cross_window_ip_overlap_naive(jt, N_WINDOWS,
                                                          backend="xla")
    else:
        got = pipeline.cross_window_ip_overlap(t, N_WINDOWS, method=method)
        want = jax_pipeline.cross_window_ip_overlap(jt, N_WINDOWS, method=method)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), ref_window_ip_overlap(
        t["src"][:n].numpy(), t["dst"][:n].numpy(), table_cols["win"][:n],
        N_WINDOWS))


@pytest.mark.parametrize("mode,sorts", [("plan", 3), ("grid", 3), ("naive", 18)])
def test_analyze_sort_counts(scale10, mode, sorts):
    """The plan path sorts three times, on either windowed method; the
    pre-plan path 18 times (``pipeline._analyze_naive``), at least the 8
    that the reference's test asks of its naive path."""
    with SortCounter() as counter:
        pipeline.analyze(scale10[3], n_windows=N_WINDOWS, ip_bins=IP_BINS, k=K,
                         device="cpu", **AB.get(mode, {}))
    assert counter.n == sorts
    assert mode != "naive" or counter.n >= 8


def test_naive_analyze_refuses_plan_only_options(scale10):
    kw = dict(n_windows=N_WINDOWS, ip_bins=IP_BINS, k=K, device="cpu",
              use_plan=False)
    for opt in ("algorithms", "fused_epilogue"):
        with pytest.raises(ValueError, match="requires the plan path"):
            pipeline.analyze(scale10[3], **kw, **{opt: True})


@pytest.mark.parametrize("method", ["hash", "shuffle"])
@pytest.mark.parametrize("algorithms", [False, True])
def test_run_challenge_fused_on_cpu(tmp_path, method, algorithms):
    """``fused=True``: ``fused_s`` timed and in the table, its results equal
    to the phases', and the span read back by ``timings_from_spans``."""
    get_tracer().clear()
    cfg = pipeline.ChallengeConfig(scale=9, n_windows=2, device="cpu",
                                   workdir=str(tmp_path), method=method,
                                   fused=True, algorithms=algorithms)
    run = pipeline.run_challenge(cfg)
    assert run.timings.fused_s > 0
    assert "fused(b+a+a)" in run.timings.format_table()
    assert run.timings.as_dict()["fused_s"] == run.timings.fused_s
    assert run.timings.packets_per_s("fused") == 512 / run.timings.fused_s
    got, want = (results_to_numpy(run.fused_results),
                 results_to_numpy(run.results))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert pipeline.timings_from_spans(get_tracer().records()) == run.timings


def test_cli_fused_on_cpu(tmp_path, capsys):
    rc = main(["--scale", "9", "--windows", "2", "--device", "cpu", "--fused",
               "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "fused(b+a+a)" in out
    assert "all scalar queries match the NumPy oracle" in out
