"""The port's segment sum on the CPU against the JAX package's.

``repro_torch.kernels.ops.segment_reduce`` (its plain version,
``ref_segment_matmul``) against the Pallas kernel ``segment_matmul_pallas``
run in interpret mode and against the reference's ``ref_segment_matmul``,
ids out of range included; inputs from a seeded numpy generator.
Integer-valued features sum exactly in any order, so those comparisons are
bit-equal; random floats agree to 1e-5 (float32 sums of at most a few
hundred terms of size 1, taken in another order).  The CUDA kernel itself is
held against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ref_segment_matmul as jax_ref_segment_matmul
from repro.kernels.segment_matmul import segment_matmul_pallas
from repro_torch.kernels import ops
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
