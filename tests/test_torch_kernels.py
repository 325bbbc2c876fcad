"""The port's kernel families on the CPU — histogram, segment max,
Count-Min and the HyperLogLog fold: each plain PyTorch version against the
reference's plain version (``repro.kernels.ref`` / the XLA path) and against
the Pallas kernel body run in interpret mode, for every epilogue
combination; plus the dispatch contract, and ``ref_segment_max_blocked``,
the segment-max kernel's decomposition (the mask applied at the seed, the
rows folded one grid-stride step at a time).  Sums take
integer-valued inputs and max is exact in any order, so every comparison
is bit-equal.  The CUDA
kernels themselves are held against the plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.histogram import histogram_pallas
from repro.kernels.segreduce import segment_max_pallas
from repro.kernels.sketch import cms_update_pallas, hll_update_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import segreduce as segmax_kernel
from repro_torch.kernels import sketch as sketch_kernel
from repro_torch.kernels.launches import wrapper

# the kernel module (the package's own "histogram" is ops.histogram)
hist_kernel = wrapper("histogram")

N, BINS = 300, 50


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        ids=rng.integers(-3, BINS + 3, N).astype(np.int32),  # incl. out of range
        w=rng.integers(0, 5, N).astype(np.int32),
        gate=rng.integers(0, 4, N).astype(np.int32),
        init=rng.integers(-2, 7, BINS).astype(np.int32),
        mask=rng.random(BINS) < 0.7,
    )


def _assert_same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


COMBOS = list(itertools.product([False, True], repeat=3))  # init, gate, mask


@pytest.mark.parametrize("with_init,gated,masked", COMBOS)
def test_histogram_plain_matches_reference_and_pallas(with_init, gated, masked):
    x = _inputs(1 + 4 * with_init + 2 * gated + masked)
    kw = {}
    if with_init:
        kw["init"] = x["init"].astype(np.float32)
    if gated:
        kw.update(gate_ids=x["gate"], gate_value=2)
    if masked:
        kw.update(valid_mask=x["mask"], retire=-1.5)
    w = x["w"].astype(np.float32)
    got = ops.histogram(torch.from_numpy(x["ids"]), BINS, torch.from_numpy(w),
                        backend="torch",
                        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                           else v for k, v in kw.items()})
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ids, jw = jnp.asarray(x["ids"]), jnp.asarray(w)
    _assert_same(got, jax_ops.histogram(ids, BINS, jw, backend="xla", **jkw))
    _assert_same(got, histogram_pallas(ids, BINS, jw, interpret=True, **jkw))


@pytest.mark.parametrize("out_dtype", [None, "int32"])
@pytest.mark.parametrize("with_init,gated,masked", COMBOS)
def test_segmented_sum_plain_matches_reference_and_pallas(
        out_dtype, with_init, gated, masked):
    x = _inputs(11 + gated + 2 * masked + 4 * with_init + 8 * (out_dtype is not None))
    kw = {"init": x["init"]} if with_init else {}
    if gated:
        kw.update(gate_ids=x["gate"], gate_value=1)
    if masked:
        kw.update(valid_mask=x["mask"],
                  retire=-(2 ** 31) if out_dtype else -4.0)
    got = ops.segmented_reduce(
        torch.from_numpy(x["w"]), torch.from_numpy(x["ids"]), BINS, op="sum",
        out_dtype=getattr(torch, out_dtype) if out_dtype else None,
        backend="torch",
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    vals, seg = jnp.asarray(x["w"]), jnp.asarray(x["ids"])
    jdt = getattr(jnp, out_dtype) if out_dtype else None
    want = jax_ref.ref_segmented_reduce(vals, seg, BINS, "sum", out_dtype=jdt,
                                        **jkw)
    assert got.dtype == (torch.int32 if out_dtype else torch.float32)
    _assert_same(got, want)
    _assert_same(got, jax_ops.segmented_reduce(
        vals, seg, BINS, op="sum", out_dtype=jdt, backend="interpret", **jkw))


def test_histogram_unweighted_and_empty():
    ids = np.random.default_rng(5).integers(0, BINS, 777).astype(np.int32)
    got = ops.histogram(torch.from_numpy(ids), BINS)
    np.testing.assert_array_equal(got.numpy(), np.bincount(ids, minlength=BINS))
    init = torch.arange(BINS, dtype=torch.float32)
    mask = torch.arange(BINS) % 2 == 0
    empty = ops.histogram(torch.empty(0, dtype=torch.int32), BINS, init=init,
                          valid_mask=mask, retire=9.0)
    np.testing.assert_array_equal(
        empty.numpy(), np.where(mask.numpy(), init.numpy(), 9.0))


def test_windowed_histogram_matches_reference():
    rng = np.random.default_rng(7)
    win = rng.integers(-1, 5, 400).astype(np.int32)
    ids = rng.integers(-1, 33, 400).astype(np.int32)
    w = rng.integers(0, 3, 400).astype(np.float32)
    got = ops.windowed_histogram(torch.from_numpy(win), torch.from_numpy(ids),
                                 4, 32, torch.from_numpy(w))
    want = jax_ops.windowed_histogram(jnp.asarray(win), jnp.asarray(ids), 4, 32,
                                      jnp.asarray(w), backend="xla")
    _assert_same(got, want)


def test_auto_dispatch_takes_the_plain_version_for_cpu_tensors():
    before = hist_kernel.LAUNCHES
    ops.histogram(torch.zeros(4, dtype=torch.int32), 3)
    assert hist_kernel.LAUNCHES == before


def test_cuda_backend_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.histogram(torch.zeros(4, dtype=torch.int32), 3, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        hist_kernel.histogram_cuda(torch.zeros(4, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.histogram(torch.zeros(4, dtype=torch.int32), 3, backend="xla")


def test_segment_max_runs_plain_on_cpu_and_cuda_backend_refuses():
    """``op="max"`` takes the plain version for a CPU tensor under ``auto``
    and ``torch``, and the ``cuda`` backend refuses a CPU tensor."""
    vals, seg = torch.tensor([1.0, 5.0, -2.0]), torch.tensor([0, 0, 1], dtype=torch.int32)
    for backend in ("auto", "torch"):
        got = ops.segmented_reduce(vals, seg, 3, op="max", backend=backend)
        np.testing.assert_array_equal(got.numpy(), [5.0, -2.0, -np.inf])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.segmented_reduce(vals, seg, 3, op="max", backend="cuda")


# --- segment max ---------------------------------------------------------------

def _max_inputs(seed, n=N):
    """Random float32 values with ties, ±inf and both zeros."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n).astype(np.float32)
    special = np.array([np.inf, -np.inf, -0.0, 0.0], np.float32)
    pick = rng.random(n) < 0.1
    vals[pick] = rng.choice(special, pick.sum())
    vals[:3] = [0.0, -0.0, -0.0]  # zeros of both signs, whatever else
    x = _inputs(seed)
    x["vals"] = vals
    x["init"] = rng.standard_normal(BINS).astype(np.float32)
    x["init"][::7] = -np.inf
    return x


def _torch_kw(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _jax_kw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("with_init,gated,masked", COMBOS)
def test_segment_max_plain_matches_reference_and_pallas(with_init, gated, masked):
    x = _max_inputs(21 + 4 * with_init + 2 * gated + masked)
    kw = {"init": x["init"]} if with_init else {}
    if gated:
        kw.update(gate_ids=x["gate"], gate_value=2)
    if masked:
        kw.update(valid_mask=x["mask"], retire=-3.5)
    got = ops.segmented_reduce(torch.from_numpy(x["vals"]),
                               torch.from_numpy(x["ids"]), BINS, op="max",
                               **_torch_kw(kw))
    assert got.dtype == torch.float32
    vals, seg, jkw = jnp.asarray(x["vals"]), jnp.asarray(x["ids"]), _jax_kw(kw)
    _assert_same(got, jax_ref.ref_segmented_reduce(vals, seg, BINS, "max", **jkw))
    _assert_same(got, segment_max_pallas(vals, seg, BINS, interpret=True, **jkw))
    direct = ref.ref_segment_max(torch.from_numpy(x["vals"]),
                                 torch.from_numpy(x["ids"]), BINS, **_torch_kw(kw))
    _assert_same(direct, np.asarray(got))


def test_segment_max_empty_segments_out_of_range_and_no_rows():
    x = _max_inputs(30, n=40)
    ids = np.random.default_rng(31).integers(-5, BINS + 5, 40).astype(np.int32)
    got = ops.segmented_reduce(torch.from_numpy(x["vals"]),
                               torch.from_numpy(ids), BINS, op="max")
    empty = np.setdiff1d(np.arange(BINS), ids)
    assert len(empty) > 0 and np.all(got.numpy()[empty] == -np.inf)
    # ids in -5..-1 and BINS..BINS+4 are dropped: only in-range rows count
    ok = (ids >= 0) & (ids < BINS)
    assert not ok.all()
    want = np.full(BINS, -np.inf, np.float32)
    np.maximum.at(want, ids[ok], x["vals"][ok])
    np.testing.assert_array_equal(got.numpy(), want)
    _assert_same(got, segment_max_pallas(jnp.asarray(x["vals"]), jnp.asarray(ids),
                                         BINS, interpret=True))
    # no rows: -inf, or init, then the retire epilogue
    no = torch.empty(0, dtype=torch.int32)
    init = torch.from_numpy(x["init"])
    mask = torch.from_numpy(x["mask"])
    for kw in (dict(), dict(init=init), dict(init=init, valid_mask=mask, retire=7.0)):
        got = ops.segmented_reduce(torch.empty(0), no, BINS, op="max", **kw)
        want = segment_max_pallas(jnp.zeros(0), jnp.zeros(0, jnp.int32), BINS,
                                  interpret=True, **_jax_kw(
                                      {k: v.numpy() if isinstance(v, torch.Tensor)
                                       else v for k, v in kw.items()}))
        _assert_same(got, want)


def test_segment_max_refuses_out_dtype_and_unknown_ops():
    vals, seg = torch.ones(3), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="out_dtype"):
        ops.segmented_reduce(vals, seg, 2, op="max", out_dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown segmented-reduce op"):
        ops.segmented_reduce(vals, seg, 2, op="min")


# --- the segment-max kernel's decomposition, mirrored on the CPU ---------------

@pytest.mark.parametrize("blocks,block_rows", [(1, 256), (16, 1024), (8, 7), (3, 1)])
@pytest.mark.parametrize("with_init,gated,masked", COMBOS)
def test_blocked_mirror_matches_plain_and_pallas(blocks, block_rows, with_init,
                                                 gated, masked):
    """The mask applied at the seed, the rows folded one grid-stride step
    at a time: bit-equal to the plain version and the Pallas kernel (max is
    exact in any order)."""
    x = _max_inputs(60 + 4 * with_init + 2 * gated + masked)
    kw = {"init": x["init"]} if with_init else {}
    if gated:
        kw.update(gate_ids=x["gate"], gate_value=2)
    if masked:
        kw.update(valid_mask=x["mask"], retire=-3.5)
    vals, ids = torch.from_numpy(x["vals"]), torch.from_numpy(x["ids"])
    got = ref.ref_segment_max_blocked(vals, ids, BINS, blocks=blocks,
                                      block_rows=block_rows, **_torch_kw(kw))
    if masked:  # masked segments that receive rows still take retire
        hit = np.isin(np.arange(BINS), x["ids"])
        assert (hit & ~x["mask"]).any()
    _assert_same(got, np.asarray(ref.ref_segment_max(vals, ids, BINS,
                                                     **_torch_kw(kw))))
    _assert_same(got, segment_max_pallas(jnp.asarray(x["vals"]),
                                         jnp.asarray(x["ids"]), BINS,
                                         interpret=True, **_jax_kw(kw)))


@pytest.mark.parametrize("case", ["int32 values and init", "all ids out of range",
                                  "no rows", "no rows, masked"])
def test_blocked_mirror_edge_cases(case):
    rng = np.random.default_rng(70)
    vals = rng.integers(-(1 << 26), 1 << 26, N).astype(np.int32)
    ids = rng.integers(-3, BINS + 3, N).astype(np.int32)
    init = rng.integers(-50, 50, BINS).astype(np.int32)
    mask = rng.random(BINS) < 0.6
    kw = dict(init=init)
    if case == "all ids out of range":
        ids = np.where(ids < 0, ids, ids + BINS + 3).astype(np.int32)
        kw["valid_mask"] = mask
    elif case.startswith("no rows"):
        vals, ids = vals[:0], ids[:0]
        if case.endswith("masked"):
            kw.update(valid_mask=mask, retire=7.0)
    got = ref.ref_segment_max_blocked(torch.from_numpy(vals), torch.from_numpy(ids),
                                      BINS, blocks=4, block_rows=16, **_torch_kw(kw))
    want = ref.ref_segment_max(torch.from_numpy(vals), torch.from_numpy(ids), BINS,
                               **_torch_kw(kw))
    _assert_same(got, want.numpy())
    jax_want = (jax_ref.ref_segmented_reduce if not len(ids) else
                lambda *a, **k: segment_max_pallas(*a[:3], interpret=True, **k))
    _assert_same(got, jax_want(jnp.asarray(vals), jnp.asarray(ids), BINS,
                               *(("max",) if not len(ids) else ()), **_jax_kw(kw)))


# --- Count-Min and HyperLogLog -------------------------------------------------

DEPTH, WIDTH, NPROP = 4, 64, 500


def _cms_inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    big = 1 << 25  # counts past 2^24: float32 would round them
    counts = rng.integers(0, big, (DEPTH, WIDTH)).astype(dtype)
    cols = rng.integers(-1, WIDTH + 2, (DEPTH, NPROP)).astype(np.int32)
    props = rng.integers(0, 2 * big, NPROP).astype(dtype)
    return counts, cols, props


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("all_masked", [False, True])
def test_cms_update_plain_matches_reference_and_pallas(dtype, all_masked):
    counts, cols, props = _cms_inputs(40 + all_masked, dtype)
    if all_masked:
        cols[:] = -1
    got = ops.cms_update(torch.from_numpy(counts), torch.from_numpy(cols),
                         torch.from_numpy(props))
    assert got.dtype == torch.from_numpy(counts).dtype
    jc, jcols, jp = jnp.asarray(counts), jnp.asarray(cols), jnp.asarray(props)
    _assert_same(got, jax_ref.ref_cms_update(jc, jcols, jp))
    _assert_same(got, cms_update_pallas(jc, jcols, jp, interpret=True))
    if all_masked:
        np.testing.assert_array_equal(got.numpy(), counts)
    else:
        assert (got.numpy() > counts).any()


def test_cms_update_no_proposals_keeps_counts():
    counts, _, _ = _cms_inputs(45, np.int32)
    got = ops.cms_update(torch.from_numpy(counts),
                         torch.empty((DEPTH, 0), dtype=torch.int32),
                         torch.empty(0, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), counts)


def test_hll_update_matches_reference_and_pallas():
    rng = np.random.default_rng(50)
    m = 64
    regs = rng.integers(0, 6, m).astype(np.float32)
    ids = rng.integers(-1, m + 1, N).astype(np.int32)
    rhos = rng.integers(1, 22, N).astype(np.int32)
    got = ops.hll_update(torch.from_numpy(regs), torch.from_numpy(ids),
                         torch.from_numpy(rhos))
    jr, ji, jh = jnp.asarray(regs), jnp.asarray(ids), jnp.asarray(rhos)
    _assert_same(got, jax_ref.ref_hll_update(jr, ji, jh))
    _assert_same(got, hll_update_pallas(jr, ji, jh, interpret=True))


def test_new_kernels_dispatch_by_device():
    segmax_before, cms_before = segmax_kernel.LAUNCHES, sketch_kernel.LAUNCHES
    cpu_i32 = torch.zeros(4, dtype=torch.int32)
    ops.segmented_reduce(torch.ones(4), cpu_i32, 3, op="max")
    ops.hll_update(torch.zeros(3), cpu_i32, cpu_i32)
    ops.cms_update(torch.zeros((2, 3), dtype=torch.int32),
                   torch.zeros((2, 4), dtype=torch.int32), cpu_i32)
    assert segmax_kernel.LAUNCHES == segmax_before
    assert sketch_kernel.LAUNCHES == cms_before
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.cms_update(torch.zeros((2, 3), dtype=torch.int32),
                       torch.zeros((2, 4), dtype=torch.int32), cpu_i32,
                       backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.hll_update(torch.zeros(3), cpu_i32, cpu_i32, backend="cuda")


# --- the histogram kernel's decomposition, mirrored on the CPU ------------------

# (private, blocks, threads, rows_in_flight): one block of the card's shape,
# blocks of 2 warps that deal 300 rows round the grid in tiles of 32 or 128,
# more blocks than a block has warps (copy groups of several copies each)
HIST_GRIDS = [(True, 1, 1024, 4), (True, 3, 64, 1), (True, 40, 64, 1),
              (True, 6, 128, 4), (False, 1, 1024, 4), (False, 5, 64, 1)]
_HIST_CASES = {}


def _hist_case(seed, kw_keys, out_dtype):
    """The inputs of a seed, with runs of equal ids for the warp merge, and
    the interpret-mode Pallas kernel's sum of them under the epilogues
    named in ``kw_keys``: computed once for all the grids."""
    key = (seed, kw_keys, out_dtype)
    if key not in _HIST_CASES:
        x = _inputs(seed)
        x["ids"][::7] = x["ids"][1::7]
        kw = {"init": x["init"]} if "init" in kw_keys else {}
        if "gate_ids" in kw_keys:
            kw.update(gate_ids=x["gate"], gate_value=1)
        if "valid_mask" in kw_keys:
            kw.update(valid_mask=x["mask"], retire=-(2 ** 31) if out_dtype else -4.0)
        jdt = getattr(jnp, out_dtype) if out_dtype else None
        pallas = np.asarray(jax_ops.segmented_reduce(
            jnp.asarray(x["w"]), jnp.asarray(x["ids"]), BINS, op="sum",
            out_dtype=jdt, backend="interpret", **_jax_kw(kw)))
        _HIST_CASES[key] = (x, kw, pallas)
    return _HIST_CASES[key]


@pytest.mark.parametrize("private,blocks,threads,rows_in_flight", HIST_GRIDS)
@pytest.mark.parametrize("out_dtype", [None, "int32"])
@pytest.mark.parametrize("with_init,gated,masked", COMBOS)
def test_histogram_blocked_mirror_matches_plain_and_pallas(
        private, blocks, threads, rows_in_flight, out_dtype, with_init, gated, masked):
    """Private copies summed in the kernel's fixed order, or the seed and
    the scatter of warp-merged runs: bit-equal to the plain version and the
    Pallas kernel on integer-valued weights."""
    keys = tuple(k for k, on in (("init", with_init), ("gate_ids", gated),
                                 ("valid_mask", masked)) if on)
    x, kw, pallas = _hist_case(90 + 4 * with_init + 2 * gated + masked, keys,
                               out_dtype)
    acc = getattr(torch, out_dtype) if out_dtype else None
    args = (torch.from_numpy(x["ids"]), BINS, torch.from_numpy(x["w"]))
    got = ref.ref_histogram_blocked(*args, out_dtype=acc, private=private,
                                    blocks=blocks, threads=threads,
                                    rows_in_flight=rows_in_flight, **_torch_kw(kw))
    assert got.dtype == (acc or torch.float32)
    _assert_same(got, ref.ref_histogram(*args, out_dtype=acc, **_torch_kw(kw)).numpy())
    _assert_same(got, pallas)


@pytest.mark.parametrize("private", [True, False])
@pytest.mark.parametrize("case", ["no rows", "every bin masked",
                                  "ids out of range and -1", "int32 sums past 2^24",
                                  "float sums"])
def test_histogram_blocked_mirror_edge_cases(private, case):
    rng = np.random.default_rng(95)
    ids = rng.integers(-3, BINS + 3, N).astype(np.int32)
    w = rng.integers(0, 9, N).astype(np.int32)
    init = rng.integers(-5, 5, BINS).astype(np.int32)
    kw, out_dtype = dict(init=init), "int32"
    if case == "no rows":
        ids, w = ids[:0], w[:0]
        kw.update(valid_mask=rng.random(BINS) < 0.5, retire=7)
    elif case == "every bin masked":
        kw.update(valid_mask=np.zeros(BINS, bool), retire=-2)
    elif case == "ids out of range and -1":
        ids = np.where(ids % 2 == 0, -1, ids + BINS).astype(np.int32)
    elif case == "int32 sums past 2^24":
        ids[: N // 2] = 7
        w[:] = 3_000_001  # 150 on bin 7: 450,000,150, odd, past 2^24
    else:
        w, init, out_dtype = w.astype(np.float32) / 4, init.astype(np.float32), None
        kw["init"] = init
    acc = getattr(torch, out_dtype) if out_dtype else None
    args = (torch.from_numpy(ids), BINS, torch.from_numpy(w))
    got = ref.ref_histogram_blocked(*args, out_dtype=acc, private=private, blocks=5,
                                    threads=64, rows_in_flight=1, **_torch_kw(kw))
    _assert_same(got, ref.ref_histogram(*args, out_dtype=acc, **_torch_kw(kw)).numpy())
    jdt = getattr(jnp, out_dtype) if out_dtype else None
    jargs = (jnp.asarray(w), jnp.asarray(ids), BINS)
    if case == "int32 sums past 2^24":
        # the Pallas kernel sums in float32, exact only below 2^24: the
        # reference's exact int32 path instead
        assert int(got[7]) > 1 << 24
        want = jax_ref.ref_segmented_reduce(*jargs, "sum", out_dtype=jdt, **_jax_kw(kw))
    else:
        want = jax_ops.segmented_reduce(*jargs, op="sum", out_dtype=jdt,
                                        backend="interpret", **_jax_kw(kw))
    _assert_same(got, want)


# --- the Count-Min kernel's cluster path, mirrored on the CPU --------------------

@pytest.mark.parametrize("cluster", [1, 3, 8])
@pytest.mark.parametrize("width", [64, 67])  # 67: no multiple of the cluster
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("case", ["random", "all masked", "no proposals"])
def test_cms_clustered_mirror_matches_plain_and_pallas(cluster, width, dtype, case):
    rng = np.random.default_rng(100 + width + cluster)
    big = 1 << 25
    counts = rng.integers(0, big, (DEPTH, width)).astype(dtype)
    cols = rng.integers(-1, width + 2, (DEPTH, NPROP)).astype(np.int32)
    props = rng.integers(0, 2 * big, NPROP).astype(dtype)
    if dtype == np.float32:  # negative cells, -inf, both zeros
        counts = rng.standard_normal((DEPTH, width)).astype(np.float32)
        counts[:, ::9] = -np.inf
        counts[:, 1::9] = -0.0
        props = rng.standard_normal(NPROP).astype(np.float32)
        props[::11] = 0.0
    if case == "all masked":
        cols[:] = -1
    elif case == "no proposals":
        cols, props = cols[:, :0], props[:0]
    got = ref.ref_cms_update_clustered(torch.from_numpy(counts), torch.from_numpy(cols),
                                       torch.from_numpy(props), cluster=cluster)
    assert got.dtype == torch.from_numpy(counts).dtype
    _assert_same(got, ref.ref_cms_update(torch.from_numpy(counts),
                                         torch.from_numpy(cols),
                                         torch.from_numpy(props)).numpy())
    jc, jcols, jp = jnp.asarray(counts), jnp.asarray(cols), jnp.asarray(props)
    _assert_same(got, jax_ref.ref_cms_update(jc, jcols, jp) if case == "no proposals"
                 else cms_update_pallas(jc, jcols, jp, interpret=True))


def test_launch_counters_by_kernel_name():
    """``kernels.launches`` reads and resets every wrapper's counter by
    kernel name, the histogram module included (the package attribute of
    that name is ``ops.histogram``)."""
    import repro_torch.kernels as port_kernels
    from repro_torch.kernels import launches

    assert hist_kernel.__name__ == "repro_torch.kernels.histogram"
    assert port_kernels.histogram is ops.histogram
    hist_kernel.LAUNCHES, sketch_kernel.HLL_LAUNCHES = 3, 5
    assert launches.read_launches()["histogram"] == 3
    assert launches.read_launches()["hll_update"] == 5
    launches.reset_launches()
    assert set(launches.read_launches()) == {
        "histogram", "segment_max", "cms_update", "hll_update",
        "flash_attention", "segment_matmul"}
    assert not any(launches.read_launches().values())
