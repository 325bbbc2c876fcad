"""The port's plain attention on the CPU against the JAX package's.

``repro_torch.kernels.ops.attention`` (its plain version, ``ref_attention``)
against the Pallas kernel ``flash_attention_pallas`` run in interpret mode
and against the reference's ``ref_attention``, over the shapes of
``tests/test_kernels.py:84-135``: MHA, GQA 4:1, a length that is not a
multiple of the block, decode against a cache, lq < lkv, windows
1/64/200/4096, float32 and bfloat16; inputs from a seeded numpy generator.
Tolerances are ``test_kernels.py``'s: 2e-3 in float32, 3e-2 in bfloat16
(bf16 outputs round at 2^-8 relative).  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import ref_attention as jax_ref_attention
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_cuda

F32, BF16 = 2e-3, 3e-2


def _qkv(seed, b, hq, hkv, lq, lkv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, lq, d)).astype(dtype),
            rng.standard_normal((b, hkv, lkv, d)).astype(dtype),
            rng.standard_normal((b, hkv, lkv, d)).astype(dtype))


def _port(q, k, v, **kw):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    return ops.attention(*t, backend="torch", **kw)


SHAPES = [
    (1, 1, 1, 128, 128, 64),     # MHA square
    (2, 8, 2, 256, 256, 64),     # GQA 4:1
    (1, 4, 4, 96, 96, 128),      # non-multiple of block
    (2, 8, 1, 1, 512, 64),       # decode: single query vs KV cache (MQA)
    (1, 2, 2, 64, 320, 32),      # chunked prefill: lq < lkv
]


@pytest.mark.parametrize("b,hq,hkv,lq,lkv,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_pallas_and_reference(b, hq, hkv, lq, lkv, d, causal):
    q, k, v = _qkv(lq * 7 + lkv + causal, b, hq, hkv, lq, lkv, d)
    got = _port(q, k, v, causal=causal).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=F32, atol=F32)
    want = jax_ref_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32, atol=F32)


@pytest.mark.parametrize("window", [1, 64, 200, 4096])
def test_plain_attention_sliding_window(window):
    q, k, v = _qkv(window, 1, 2, 2, 256, 256, 64)
    got = _port(q, k, v, window=window).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=F32, atol=F32)
    want = jax_ref_attention(jq, jk, jv, window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32, atol=F32)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32), (torch.bfloat16, BF16)])
def test_plain_attention_dtypes(dtype, tol):
    q, k, v = _qkv(5, 1, 4, 2, 128, 128, 64)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    got = ops.attention(tq, tk, tv, backend="torch")
    assert got.dtype == dtype and got.shape == tq.shape
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jdt) for x in (tq, tk, tv))
    pallas = flash_attention_pallas(jq, jk, jv, interpret=True).astype(jnp.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas),
                               rtol=tol, atol=tol)


def test_plain_attention_decode_on_a_strided_cache_view():
    """Decode against the written part of a longer cache, cut as a view (the
    model's path), equals attention against a contiguous copy and the
    Pallas kernel on that copy."""
    rng = np.random.default_rng(9)
    cache = torch.from_numpy(rng.standard_normal((2, 2, 4, 40, 32)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 8, 1, 32)).astype(np.float32))
    k, v = cache[0][:, :, :23], cache[1][:, :, :23]
    assert not k.is_contiguous()
    got = ops.attention(q, k, v, backend="torch")
    want = ops.attention(q, k.contiguous(), v.contiguous(), backend="torch")
    assert torch.equal(got, want)
    pallas = flash_attention_pallas(*(jnp.asarray(x.contiguous().numpy())
                                      for x in (q, k, v)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=F32, atol=F32)


def test_plain_attention_row_without_keys_is_zero():
    """lq > lkv, causal: the first rows see no key; the kernel's ``l == 0``
    branch gives 0 there, and so does the plain version."""
    q, k, v = _qkv(3, 1, 2, 2, 6, 4, 32)
    got = _port(q, k, v).numpy()
    assert np.all(got[:, :, :2] == 0) and np.all(np.isfinite(got))
    want = np.asarray(jax_ref_attention(*(jnp.asarray(x) for x in (q, k, v))))
    np.testing.assert_allclose(got[:, :, 2:], want[:, :, 2:], rtol=F32, atol=F32)


def test_dispatch_contract():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 2, 1, 4, 4, 32))
    before = fa_kernel.LAUNCHES
    assert torch.equal(ops.attention(q, k, v), ops.attention(q, k, v, backend="torch"))
    assert fa_kernel.LAUNCHES == before  # "auto" on a CPU tensor: plain version
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.attention(q, k, v, backend="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v)
