"""The port's segment sum on the CPU against the JAX package's.

``repro_torch.kernels.ops.segment_reduce`` (its plain version,
``ref_segment_matmul``) against the Pallas kernel ``segment_matmul_pallas``
run in interpret mode and against the reference's ``ref_segment_matmul``,
ids out of range included; inputs from a seeded numpy generator.
Integer-valued features sum exactly in any order, so those comparisons are
bit-equal; random floats agree to 1e-5 (float32 sums of at most a few
hundred terms of size 1, taken in another order).  The kernel's plan
(``plan_segment_sum``) is checked to cover every (segment, feature) once
and to give about one block per SM, and ``ref_segment_matmul_tiled``, the
kernel's decomposition in plain PyTorch (tiles, rounds of ids, the counting
sort, the warps' segments), is held to the plain version and the Pallas
kernel: bit-equal on integer-valued rows, within ``2 k 2^-24 sum|x|`` on
random floats.  The CUDA kernel itself is held against the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ref_segment_matmul as jax_ref_segment_matmul
from repro.kernels.segment_matmul import segment_matmul_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import segment_matmul as segsum_kernel
from repro_torch.kernels.segment_matmul import segment_matmul_cuda


def _inputs(seed, n, d, segs, integer):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, segs + 3, n).astype(np.int32)  # incl. out of range
    x = (rng.integers(-4, 5, (n, d)) if integer
         else rng.standard_normal((n, d))).astype(np.float32)
    return x, ids


@pytest.mark.parametrize("n,d,segs", [(1, 1, 1), (100, 7, 10), (600, 130, 300),
                                      (1000, 16, 4096)])
@pytest.mark.parametrize("integer", [True, False])
def test_plain_segment_sum_matches_pallas_and_reference(n, d, segs, integer):
    x, ids = _inputs(n + d + segs, n, d, segs, integer)
    got = ops.segment_reduce(torch.from_numpy(x), torch.from_numpy(ids), segs,
                             backend="torch")
    assert got.dtype == torch.float32 and got.shape == (segs, d)
    pallas = segment_matmul_pallas(jnp.asarray(x), jnp.asarray(ids), segs,
                                   interpret=True)
    want = jax_ref_segment_matmul(jnp.asarray(x), jnp.asarray(ids), segs)
    for other in (pallas, want):
        if integer:
            np.testing.assert_array_equal(got.numpy(), np.asarray(other))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(other),
                                       rtol=1e-5, atol=1e-5)


def test_plain_segment_sum_of_bfloat16_rows_is_float32():
    """bfloat16 rows sum in float32 and come out float32, as the TPU kernel
    returns them (the reference's plain path would return bfloat16)."""
    x, ids = _inputs(4, 300, 24, 50, integer=True)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.segment_reduce(xb, torch.from_numpy(ids), 50)
    assert got.dtype == torch.float32
    pallas = segment_matmul_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ids),
                                   50, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_plain_segment_sum_of_no_rows_and_no_segments():
    x = torch.zeros(0, 5)
    ids = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(ops.segment_reduce(x, ids, 3), torch.zeros(3, 5))
    assert ops.segment_reduce(torch.ones(4, 5), torch.zeros(4, dtype=torch.int32),
                              0).shape == (0, 5)


def test_dispatch_contract():
    x, ids = (torch.from_numpy(a) for a in _inputs(1, 50, 4, 8, integer=True))
    before = segsum_kernel.LAUNCHES
    assert torch.equal(ops.segment_reduce(x, ids, 8),
                       ops.segment_reduce(x, ids, 8, backend="torch"))
    assert segsum_kernel.LAUNCHES == before  # "auto" on a CPU tensor
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.segment_reduce(x, ids, 8, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_matmul_cuda(x, ids, 8)


# --- the kernel's tiling, mirrored on the CPU ---------------------------------

GNN_REGIMES = {"molecule": (64, 4096), "full_graph_sm": (1433, 2816)}  # (d, S)


def _covered(d, segs, ts, tf):
    """How often the tiles of plan (ts, tf) cover each (segment, feature)."""
    hits = np.zeros((segs, d), np.int32)
    for s0 in range(0, segs, ts):
        for f0 in range(0, d, tf):
            hits[s0:s0 + ts, f0:f0 + tf] += 1
    return hits


@pytest.mark.parametrize("n,d,segs,sms", [
    (8192, 64, 4096, 132), (10752, 1433, 2816, 132), (700, 37, 10, 132),
    (1, 1, 1, 132), (5000, 7, 3, 132), (1, 300, 1, 132), (20000, 129, 5000, 132),
    (1 << 20, 128, 2 ** 21, 132), (100, 33, 100, 8), (10752, 1433, 2816, 1),
    (0, 5, 9, 132)])
def test_plan_covers_every_segment_and_feature_once(n, d, segs, sms):
    ts, tf, cap, parts = segsum_kernel.plan_segment_sum(n, d, segs, sms)
    assert 1 <= tf <= segsum_kernel.MAX_TILE_FEATURES
    assert 1 <= ts <= segsum_kernel.MAX_TILE_SEGMENTS and ts <= max(segs, 1)
    assert 1 <= cap <= segsum_kernel.MAX_ROUND_IDS and cap >= min(n, 1)
    if segs * d <= 1 << 24:
        assert (_covered(d, segs, ts, tf) == 1).all()
    blocks = -(-segs // ts) * -(-d // tf)
    # about one block per SM: never fewer than half the SMs unless the tile
    # is at its floor (one segment) or its ceiling, never twice as many
    # unless the tile is at its ceiling of 256 segments
    assert blocks >= sms / 2 or ts in (1, segsum_kernel.MAX_TILE_SEGMENTS) or ts == segs
    assert blocks <= 2 * sms or ts == segsum_kernel.MAX_TILE_SEGMENTS
    # direct blocks each read every id, an SM's tiles one after another:
    # never more than PARTITION_IDS ids an SM, else one block per SM that
    # sorts the rows by tile first
    waves = -(-blocks // sms)
    assert parts in (0, sms) and (parts == 0) == (n * waves <= segsum_kernel.PARTITION_IDS
                                                  or n == 0)


def test_plan_at_the_gnn_regimes():
    """full_graph_sm: 256 x 128 tiles, 11 x 12 = 132 direct blocks, the
    last feature tile 25 wide; molecule: 32 x 64, 128 direct blocks; each
    reads its ids in one round.  minibatch_lg and ogb_products: 256 x 128
    (100) tiles, partitioned by one block per SM, so the ids are read twice
    in all where direct blocks would read them 3,330 and 9,570 times; the
    partitioned launch's shared memory (a counting pass of 16,384 tiles,
    64 KB) and its tile's (8 x 257 + 12 x 16,384 bytes) fit the H100's
    227 KB."""
    plan = segsum_kernel.plan_segment_sum
    assert plan(10752, 1433, 2816, 132) == (256, 128, 10752, 0)
    assert 1433 - 11 * 128 == 25 and -(-2816 // 256) * 12 == 132
    assert plan(8192, 64, 4096, 132) == (32, 64, 8192, 0)
    assert plan(168960, 602, 170496, 132) == (256, 128, 16384, 132)
    assert -(-170496 // 256) * -(-602 // 128) == 3330
    assert plan(61865984, 100, 2449920, 132) == (256, 100, 16384, 132)
    assert -(-2449920 // 256) == 9570
    assert max(4 * 16384, 8 * 257 + 12 * 16384) <= 227 * 1024
    # forced either way
    assert plan(8192, 64, 4096, 132, partition=True).parts == 132
    assert plan(168960, 602, 170496, 132, partition=False).parts == 0
    assert plan(0, 64, 4096, 132, partition=True).parts == 0


def _tolerance(x, ids, segs):
    """2 * k * 2^-24 * sum|x| per segment: a float32 sum of k terms in any
    order is within (k - 1) * 2^-24 * sum|x| of any other order."""
    ok = (ids >= 0) & (ids < segs)
    k = np.bincount(ids[ok], minlength=segs).max(initial=0)
    abs_sum = np.zeros((segs, x.shape[1]), np.float64)
    np.add.at(abs_sum, ids[ok], np.abs(x[ok]).astype(np.float64))
    return 2 * k * 2.0 ** -24 * abs_sum


@pytest.mark.parametrize("n,d,segs,sms,cap,partition", [
    (700, 37, 300, 132, None, None),   # d = 37, segment tiles of 4
    (300, 1433, 40, 4, None, None),    # 1,433-like width: 11 full feature tiles + 25
    (5000, 130, 260, 2, None, None),   # a ragged 2-wide feature tile, 256-segment tiles
    (3000, 5, 33, 132, 1000, None),    # ids in 3 rounds, sums added to the first's
    (64, 9, 48, 132, None, None),      # segments on tile edges (ids 15, 16, 31, 32)
    (200, 17, 6, 132, None, None),     # every id out of range
    (0, 11, 7, 132, None, None),       # no rows
    (600, 37, 300, 5, 64, True),       # partitioned by 5 blocks, a tile's rows in rounds
    (2000, 6, 5000, 3, None, True),    # partitioned, 20 tiles of 256 segments
    (900, 1433, 40, 7, 100, True),     # partitioned, 1,433-like width, rounds of 100
    (200, 17, 6, 3, None, True),       # partitioned, every id out of range
    (2000, 6, 41, 132, None, None),    # a hub: half the rows on segment 7, split
    (2000, 6, 41, 3, 300, True),       # the same partitioned, rounds of 300
])
@pytest.mark.parametrize("integer", [True, False])
def test_tiled_mirror_matches_plain_and_pallas(n, d, segs, sms, cap, partition,
                                               integer):
    x, ids = _inputs(n * 7 + d, n, d, segs, integer)
    if segs == 48:
        ids[:8] = [15, 16, 31, 32, 0, 47, 16, 15]
    if segs == 41:
        ids[::2] = 7
    if segs == 6:
        ids = np.where(ids % 2 == 0, -1 - np.abs(ids), segs + np.abs(ids)).astype(np.int32)
    plan = segsum_kernel.plan_segment_sum(n, d, segs, sms, partition)
    if cap is not None:
        plan = plan._replace(cap=cap)
    got = ref.ref_segment_matmul_tiled(torch.from_numpy(x), torch.from_numpy(ids),
                                       segs, **plan._asdict())
    plain = ref.ref_segment_matmul(torch.from_numpy(x), torch.from_numpy(ids), segs)
    jax_side = [np.asarray(jax_ref_segment_matmul(jnp.asarray(x), jnp.asarray(ids),
                                                  segs))]
    if n:  # the Pallas kernel takes no empty row block
        jax_side.append(np.asarray(segment_matmul_pallas(
            jnp.asarray(x), jnp.asarray(ids), segs, interpret=True)))
    assert got.dtype == torch.float32 and got.shape == (segs, d)
    if segs == 6 or n == 0:
        assert not got.any()
    for other in (plain.numpy(), *jax_side):
        if integer:
            np.testing.assert_array_equal(got.numpy(), other)
        else:
            tol = _tolerance(x, ids, segs)
            assert (np.abs(got.numpy().astype(np.float64) - other) <= tol).all()


def test_tiled_mirror_of_half_precision_rows():
    """bfloat16 and float16 rows convert to float32 before the tile sums."""
    x, ids = _inputs(8, 500, 70, 40, integer=True)
    plan = segsum_kernel.plan_segment_sum(500, 70, 40, 132)
    for dtype in (torch.bfloat16, torch.float16):
        xt = torch.from_numpy(x).to(dtype)
        got = ref.ref_segment_matmul_tiled(xt, torch.from_numpy(ids), 40,
                                           **plan._asdict())
        assert torch.equal(got, ref.ref_segment_matmul(xt, torch.from_numpy(ids), 40))
