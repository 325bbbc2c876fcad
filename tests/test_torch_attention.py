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
``chip_smoke.py``).  Here also: ``ref_attention_split``, the plain mirror of
the kernel's split-kv decode arithmetic, against ``ref_attention`` and the
reference at the chunk edge cases, and the kernel's dispatch rule and kv
split, which are plain Python.
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
from repro_torch.kernels.ref import ref_attention, ref_attention_split

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


# The split-kv mirror against ref_attention, both float32: the same sums in
# another grouping (per chunk, then rescaled), so within 1e-5 of outputs of
# size about 1 (float32 rounding of sums of a few hundred terms).
SPLIT_TOL = 1e-5


@pytest.mark.parametrize("b,hq,hkv,lq,lkv,d,window,chunk,begin", [
    (2, 8, 2, 1, 300, 64, None, 64, 0),      # lkv not a multiple of the chunk
    (1, 8, 2, 1, 1, 128, None, 64, 0),       # lkv 1
    (2, 4, 1, 1, 40, 32, None, 64, 0),       # lkv below one chunk
    (1, 8, 8, 16, 700, 64, None, 64, 0),     # group 1, 16 rows
    (1, 16, 2, 2, 500, 32, None, 128, 0),    # group 8, lq 2
    (1, 1, 1, 16, 1000, 64, 40, 16, 0),      # window: whole chunks no row sees
    (1, 1, 1, 16, 1000, 64, 40, 64, 896),    # the kernel's cut of that band
    (1, 4, 1, 3, 2079, 128, 5, 64, 0),       # decode window far narrower than lkv
    (1, 2, 2, 6, 4, 32, None, 64, 0),        # lq > lkv: leading rows see no key
    (1, 8, 2, 1, 0, 64, None, 64, 0),        # no key at all
])
def test_split_mirror_matches_reference(b, hq, hkv, lq, lkv, d, window, chunk, begin):
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(lq + 3 * lkv + d, b, hq, hkv, lq, lkv, d))
    want = ref_attention(q, k, v, window=window)
    got = ref_attention_split(q, k, v, window=window, chunk_keys=chunk, begin=begin)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SPLIT_TOL, atol=SPLIT_TOL)
    if lkv >= lq:  # every row sees a key; the reference gives NaN for one that does not
        jax_want = jax_ref_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                     window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), rtol=F32, atol=F32)


def test_split_mirror_non_causal_and_bf16():
    q, k, v = (torch.from_numpy(x) for x in _qkv(11, 1, 8, 2, 2, 333, 64))
    np.testing.assert_allclose(
        ref_attention_split(q, k, v, causal=False, chunk_keys=64).numpy(),
        ref_attention(q, k, v, causal=False).numpy(), rtol=SPLIT_TOL, atol=SPLIT_TOL)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    got = ref_attention_split(qb, kb, vb, chunk_keys=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               ref_attention(qb, kb, vb).float().numpy(),
                               rtol=BF16, atol=BF16)


@pytest.mark.parametrize("hq,hkv,lq,path", [
    (32, 8, 1, "decode"), (32, 8, 4, "decode"), (32, 8, 5, "prefill"),
    (16, 2, 2, "decode"), (16, 2, 3, "prefill"),
    (8, 8, 16, "decode"), (8, 8, 17, "prefill"),
    (64, 2, 1, "prefill"),  # a group of 32 heads overflows the 16-row tile
])
def test_attention_path_rule(hq, hkv, lq, path):
    """The dispatch rule on both sides of the boundary: bf16 calls whose
    group x lq rows fit the 16-row decode tile take the decode path;
    float32 calls always the float32 kernel."""
    k = torch.zeros(1, hkv, 9, 64)
    q = torch.zeros(1, hq, lq, 64, dtype=torch.bfloat16)
    assert fa_kernel.attention_path(q, k.bfloat16()) == path
    assert fa_kernel.attention_path(q.float(), k) == "f32"


@pytest.mark.parametrize("b,hkv,lq,lkv,window", [
    (4, 8, 1, 2079, None), (4, 8, 1, 32767, None), (1, 1, 1, 10000, None),
    (1, 8, 4, 1, None), (2, 8, 1, 0, None), (1, 1, 16, 1000, 40),
    (64, 8, 1, 4000, None), (1, 8, 2, 3000, 64),
])
def test_decode_split_covers_the_band(b, hkv, lq, lkv, window):
    """The chunks tile the keys any packed row may see, in whole 64-key
    tiles, in about two blocks per SM of a 132-SM card (one chunk at least,
    one tile per chunk at least), none of them empty of keys below lkv."""
    sms = 132
    begin, chunk, n = fa_kernel.decode_split(b, hkv, lq, lkv, window, sms)
    assert begin % 64 == 0 and chunk % 64 == 0 and chunk >= 64 and n >= 1
    first_seen = max(0, lkv - lq - window + 1) if window else 0
    assert begin <= first_seen
    assert begin + (n - 1) * chunk < max(lkv, 1) <= begin + n * chunk
    assert n == 1 or b * hkv * n <= 2 * sms
