"""LM training in the port on the CPU against the JAX package's.

Same weights on both sides (the reference's ``init_params``, carried over by
``convert``), same batches (numpy, seeded).  Held here, each with its
tolerance:

* ``loss_fn`` and its gradient against ``jax.value_and_grad`` of the
  reference's (``"xla"`` attention) on the granite, minicpm and qwen2
  smoke configs and ``tests/test_models.py``'s GQA ``tiny_cfg`` (with and
  without a window), float32: the loss within 1e-6 relative, each
  gradient leaf within 1e-5 of its largest magnitude (the two sides sum in
  other orders; measured 1.5e-6);
* the plain attention's gradient against ``jax.grad`` through the
  reference's ``flash_attention(..., interpret=True)`` (its
  ``custom_vjp``), with GQA and a window (2e-5 of the largest gradient);
  and the attention ``autograd.Function``'s plumbing, with the plain
  version standing in for the kernel: bit-equal to plain autograd;
* remat off, ``"nothing"`` and ``"dots"``: equal loss and gradients (the
  recomputation repeats the same float32 operations: bit-equal);
* ``adamw_update`` over 5 steps (cosine, wsd, constant; clip on and off;
  float32 and bfloat16 moments) and the schedules over a grid of steps;
* ``Trainer.run``'s logged losses over 6 steps within 1e-5 of the
  reference ``Trainer``'s; a training state carried both ways by
  ``convert`` mid-run;
* checkpoints: resume bit-equal, float32 steps restored across packages
  both ways, bfloat16 leaves (queue 3 item 10), and the reference's own
  ``restore_latest`` giving None for a bfloat16 checkpoint from either
  package;
* ``lm_batches`` bit-equal, the CLI, the ``__all__`` re-exports.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.kernels as jax_kernels
import repro_torch.core as port_core
import repro_torch.kernels as port_kernels
from repro.configs import granite_8b as jax_granite
from repro.configs import minicpm_2b as jax_minicpm
from repro.configs import qwen2_72b as jax_qwen2
from repro.data.pipeline import lm_batches as jax_lm_batches
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models import transformer as T
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jax_opt
from repro.train.elastic import StragglerWatchdog as JaxWatchdog
from repro.train.loop import Trainer as JaxTrainer
from repro_torch.configs import minicpm_2b
from repro_torch.convert import (train_state_from_numpy, train_state_to_numpy,
                                 transformer_param_tree,
                                 transformer_params_from_numpy)
from repro_torch.data.pipeline import lm_batches
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_attention
from repro_torch.models import transformer as PT
from repro_torch.train import (AdamWConfig, Trainer, adamw_init, adamw_update,
                               read_manifest, restore_checkpoint, restore_latest,
                               save_checkpoint, tree_flatten)
from repro_torch.train import optimizer as port_opt
from repro_torch.train.elastic import StragglerWatchdog

from _ref_attention_before import ref_attention_before

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVED = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab", "d_head", "qkv_bias", "sliding_window", "rope_theta",
          "tie_embeddings")
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5      # of each leaf's largest |gradient|
TRAIN_LOSS_TOL = 1e-5


def _tiny(**kw):
    """``tests/test_models.py:21``'s ``tiny_cfg``."""
    base = dict(name="t", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=97, dtype=jnp.float32, qkv_bias=True,
                remat=False)
    base.update(kw)
    return T.TransformerConfig(**base)


CONFIGS = {
    "granite-smoke": jax_granite.smoke_config,
    "minicpm-smoke": jax_minicpm.smoke_config,
    "qwen2-smoke": jax_qwen2.smoke_config,
    "tiny": _tiny,
    "tiny-window4": lambda: _tiny(sliding_window=4),
}


def _port_cfg(ref_cfg, **kw) -> PT.TransformerConfig:
    kw = {"remat": ref_cfg.remat, **kw}
    return PT.TransformerConfig(**{f: getattr(ref_cfg, f) for f in SERVED},
                                dtype=torch.float32, kernel_backend="torch", **kw)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax(tree):
    """New JAX arrays of a numpy tree (the reference's trainer donates)."""
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _pair(name, **kw):
    ref_cfg = CONFIGS[name]()
    params = T.init_params(jax.random.key(0), ref_cfg)
    model = transformer_params_from_numpy(_numpy(params), _port_cfg(ref_cfg, **kw),
                                          "cpu")
    return ref_cfg, params, model


def _tokens(vocab, shape=(2, 13), seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _port_loss_and_grads(model, toks):
    leaves = tree_flatten(transformer_param_tree(model))[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = PT.loss_fn(model, torch.from_numpy(toks[:, :-1]),
                               torch.from_numpy(toks[:, 1:]))
    return loss, metrics, torch.autograd.grad(loss, leaves)


def _close_leaf(got: torch.Tensor, want, tol=GRAD_TOL):
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# ------------------------------------------------------------ loss and grads

@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grad_match_reference(name):
    ref_cfg, params, model = _pair(name)
    toks = _tokens(ref_cfg.vocab)
    (want, aux), want_g = jax.value_and_grad(
        lambda p: T.loss_fn(p, ref_cfg, toks[:, :-1], toks[:, 1:]),
        has_aux=True)(params)
    loss, metrics, grads = _port_loss_and_grads(model, toks)
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    assert metrics["moe_aux_loss"].item() == float(aux["moe_aux_loss"]) == 0
    assert metrics["moe_dropped"].dtype == torch.int32
    want_leaves = jax.tree_util.tree_leaves(want_g)  # the same (sorted) order
    assert len(grads) == len(want_leaves)
    for got, ref in zip(grads, want_leaves):
        _close_leaf(got, ref)


def test_cross_entropy_mask_matches_reference():
    from repro.models.layers import cross_entropy_loss as jax_ce
    from repro_torch.models.layers import cross_entropy_loss

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                      None if m is None else jnp.asarray(m))
        got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


def test_remat_policies_equal_loss_and_grads():
    """``tests/test_models.py:59`` for the port, with the gradients too."""
    toks = _tokens(97, (2, 16))
    outs = []
    for remat, policy in [(False, "nothing"), (True, "nothing"), (True, "dots")]:
        _, _, model = _pair("tiny", remat=remat, remat_policy=policy)
        loss, _, grads = _port_loss_and_grads(model, toks)
        outs.append((loss, grads))
    for loss, grads in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, outs[0][1]))
    _, _, model = _pair("tiny", remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        _port_loss_and_grads(model, toks)


# ------------------------------------------------------------------ attention

@pytest.mark.parametrize("hkv,window", [(2, None), (2, 16), (4, 24)],
                         ids=["gqa", "gqa-window16", "mha-window24"])
def test_plain_attention_grad_matches_reference_vjp(hkv, window):
    """The port's backward (the plain version's autograd) against
    ``jax.grad`` through the reference's ``custom_vjp`` around the Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(hkv + (window or 0))
    q = rng.standard_normal((1, 4, 64, 32)).astype(np.float32)
    k = rng.standard_normal((1, hkv, 64, 32)).astype(np.float32)
    v = rng.standard_normal((1, hkv, 64, 32)).astype(np.float32)
    g = rng.standard_normal(q.shape).astype(np.float32)

    def f(q_, k_, v_):
        return jnp.sum(jax_flash_attention(q_, k_, v_, True, window, None, True) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ref_attention(qt, kt, vt, window=window)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    for a, b in zip(got, want):
        _close_leaf(a, b, tol=2e-5)


def test_ref_attention_backward_does_not_write_saved_tensors():
    """The regression of the in-place fault: softmax's saved output was
    zeroed in place, so any backward raised."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 6, 8, generator=g, requires_grad=True)
               for _ in range(3))
    ref_attention(q, k[:, :, :3], v[:, :, :3]).sum().backward()  # Lq > Lkv too
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    before = ref_attention(q, k, v, window=2)
    assert before.grad_fn is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,lq,lkv,causal,window", [
    (8, 2, 24, 24, True, None),   # GQA, causal
    (8, 2, 24, 24, True, 5),      # GQA, a window
    (4, 4, 3, 40, True, None),    # MHA, a decode-like chunk at the end
    (8, 4, 12, 7, True, 3),       # Lq > Lkv: rows that see no key
    (6, 3, 10, 16, False, None),  # not causal
], ids=["gqa", "gqa-window", "mha-chunk", "empty-rows", "noncausal"])
def test_ref_attention_forward_unchanged(dtype, hq, hkv, lq, lkv, causal, window):
    """The differentiable plain attention gives the values of the in-place
    ``repeat_interleave`` formulation it replaced, bit for bit (the rows
    that see no key 0 in both)."""
    g = torch.Generator().manual_seed(hq * 100 + lq)
    q = torch.randn(2, hq, lq, 16, generator=g).to(dtype)
    k = torch.randn(2, hkv, lkv, 16, generator=g).to(dtype)
    v = torch.randn(2, hkv, lkv, 16, generator=g).to(dtype)
    got = ref_attention(q, k, v, causal=causal, window=window)
    want = ref_attention_before(q, k, v, causal=causal, window=window)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


def test_attention_function_backward_is_plain_autograd(monkeypatch):
    """``FlashAttention``'s plumbing with the plain version standing in for
    the kernel (which needs a card): the same output, and the same
    gradients bit for bit; ``ops.attention`` takes it only when grad is
    recorded."""
    calls = []

    def kernel(q, k, v, **kw):
        calls.append(torch.is_grad_enabled())
        return ref_attention(q, k, v, **kw)

    monkeypatch.setattr(fa_kernel, "flash_attention_cuda", kernel)
    monkeypatch.setattr(ops, "flash_attention_cuda", kernel)
    monkeypatch.setattr(ops, "_use_kernel", lambda backend, x: True)
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 8, 10, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 2, 10, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 2, 10, 16, generator=g, requires_grad=True)
    up = torch.randn(2, 8, 10, 16, generator=g)
    out = ops.attention(q, k, v, window=5)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), up)
    plain = ref_attention(q, k, v, window=5)
    want = torch.autograd.grad(plain, (q, k, v), up)
    assert torch.equal(out, plain)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        served = ops.attention(q, k, v, window=5)
    assert served.grad_fn is None and calls == [False, False]


# ------------------------------------------------------------------ optimizer

def _grad_trees(steps, shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: np.asarray(rng.standard_normal(s) * (3.0 if i % 2 else 0.1),
                           dtype=np.float32)
             for k, s in shapes.items()} for i in range(steps)]


SHAPES = {"a": (3, 4), "b": (5,), "c": ()}


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(schedule, clip, state_dtype):
    """Five steps from the same weights and gradients; float32 weights,
    moments in ``state_dtype``: weights within 1e-6 relative (float32 ops
    in the same order, transcendental functions that may differ in the last
    bit); the moments and metrics the same."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule,
              grad_clip=clip, state_dtype=state_dtype, weight_decay=0.1)
    rng = np.random.default_rng(3)
    p0 = {k: np.asarray(rng.standard_normal(s), dtype=np.float32)
          for k, s in SHAPES.items()}
    jcfg, cfg = jax_opt.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jax_opt.adamw_init(jp, state_dtype)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = adamw_init(tp, state_dtype)
    for grads in _grad_trees(5, SHAPES):
        jp, js, jm = jax_opt.adamw_update({k: jnp.asarray(v) for k, v in grads.items()},
                                          js, jp, jcfg)
        tp2, ts2, tm = adamw_update({k: torch.from_numpy(v) for k, v in grads.items()},
                                    ts, tp, cfg)
        assert tp2 is tp and ts2 is ts  # in place
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5 and ts["step"].dtype == torch.int32
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7)
        for mom in ("m", "v"):
            assert ts[mom][k].dtype == getattr(torch, state_dtype)
            np.testing.assert_allclose(ts[mom][k].float().numpy(),
                                       np.asarray(js[mom][k], np.float32),
                                       rtol=1e-2 if state_dtype == "bfloat16" else 1e-6,
                                       atol=1e-12)


def test_adamw_bf16_weights_round_like_reference():
    """bfloat16 weights and gradients: the float32 math cast back to
    bfloat16 at each step, as the reference's; equal after 5 steps but
    for a last-bit rounding tie (at most one bfloat16 ulp)."""
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=6, schedule="constant")
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((64,)).astype(np.float32)
    jp = {"w": jnp.asarray(p0, jnp.bfloat16)}
    js = jax_opt.adamw_init(jp)
    tp = {"w": torch.from_numpy(p0).to(torch.bfloat16)}
    ts = adamw_init(tp)
    for grads in _grad_trees(5, {"w": (64,)}):
        g = grads["w"]
        jp, js, _ = jax_opt.adamw_update({"w": jnp.asarray(g, jnp.bfloat16)}, js, jp,
                                         jax_opt.AdamWConfig(**kw))
        adamw_update({"w": torch.from_numpy(g).to(torch.bfloat16)}, ts, tp,
                     AdamWConfig(**kw))
    want = np.asarray(jp["w"], np.float32)
    got = tp["w"].float().numpy()
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedules_match_reference(schedule):
    cfg = dict(lr=1e-3, warmup_steps=100, total_steps=1_000, decay_fraction=0.2,
               schedule=schedule)
    jf = jax_opt.make_schedule(jax_opt.AdamWConfig(**cfg))
    tf = port_opt.make_schedule(AdamWConfig(**cfg))
    steps = np.array([0, 1, 50, 99, 100, 101, 400, 799, 800, 801, 900, 999, 1000,
                      1500], np.int32)
    want = np.array([float(jf(jnp.asarray(s))) for s in steps])
    got = np.array([tf(torch.tensor(int(s), dtype=torch.int32)).item()
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_adamw_slices_of_a_large_leaf_bit_equal(monkeypatch):
    """A leaf over ``ADAMW_SLICE`` elements updates in slices of its
    leading axis (bf16 and float32 leaves, a 0-d leaf, float32 and bf16
    moments): three steps bit-equal to the whole-leaf update."""
    def run(slice_elems, state_dtype):
        monkeypatch.setattr(port_opt, "ADAMW_SLICE", slice_elems)
        g = torch.Generator().manual_seed(0)
        params = {"a": torch.randn(7, 5, 3, generator=g).to(torch.bfloat16),
                  "b": torch.randn(9, 4, generator=g), "c": torch.randn((), generator=g)}
        state = adamw_init(params, state_dtype)
        for _ in range(3):
            grads = {k: torch.randn(v.shape, generator=g).to(v.dtype)
                     for k, v in params.items()}
            adamw_update(grads, state, params, AdamWConfig(warmup_steps=1))
        return tree_flatten({"params": params, "opt": state})[0]

    assert port_opt._slices(torch.empty(7, 5, 3)) == [(0, 7)]
    monkeypatch.setattr(port_opt, "ADAMW_SLICE", 16)
    assert port_opt._slices(torch.empty(7, 5, 3)) == [(i, i + 1) for i in range(7)]
    assert port_opt._slices(torch.empty(9, 4)) == [(0, 4), (4, 8), (8, 9)]
    for state_dtype in ("float32", "bfloat16"):
        whole, sliced = run(1 << 28, state_dtype), run(16, state_dtype)
        assert all(torch.equal(a, b) for a, b in zip(whole, sliced, strict=True))


def test_adamw_decreases_quadratic():
    """``tests/test_substrate.py:242`` for the port."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=100, schedule="constant")
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(50):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_wsd_has_plateau():
    """``tests/test_substrate.py:265`` for the port."""
    cfg = AdamWConfig(lr=1e-3, warmup_steps=100, total_steps=1_000,
                      decay_fraction=0.2, schedule="wsd")
    f = port_opt.wsd_schedule(cfg)
    plateau = [float(f(torch.tensor(s))) for s in (200, 400, 700)]
    assert all(abs(p - 1e-3) < 1e-9 for p in plateau)
    assert float(f(torch.tensor(999))) < 2e-4  # decayed ~10x


@pytest.mark.parametrize("watchdog", [StragglerWatchdog, JaxWatchdog],
                         ids=["port", "reference"])
def test_straggler_watchdog_flags_slow_steps(watchdog, monkeypatch):
    """``tests/test_substrate.py:284``, for the port beside the reference,
    on a clock the test advances (ten 2 ms steps, then one of 50 ms), so
    that no load on the machine can make a 2 ms step a straggler."""
    import time

    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    wd = watchdog(window=20, threshold=2.0)
    for _ in range(10):
        wd.start()
        now[0] += 0.002
        assert wd.stop() is False
    wd.start()
    now[0] += 0.05
    assert wd.stop() is True
    assert wd.flagged == 1


# ------------------------------------------------------------------- trainer

OPT = dict(lr=3e-4, warmup_steps=2, total_steps=6, schedule="wsd")
BATCH, SEQ = 4, 16


def _jax_trainer(cfg, ckpt_dir=None, ckpt_every=100):
    return JaxTrainer(lambda p, b: T.loss_fn(p, cfg, b["tokens"], b["labels"]),
                      jax_opt.AdamWConfig(**OPT), ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every)


def _port_trainer(model, ckpt_dir=None, ckpt_every=100):
    return Trainer(lambda p, b: PT.loss_fn(model, b["tokens"], b["labels"]),
                   AdamWConfig(**OPT), ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)


def _log(out):
    return lambda step, hist: out.append(hist)


def test_trainer_losses_match_reference():
    """minicpm's smoke config, 6 steps from the same weights and batches:
    each logged loss within 1e-5 (measured 1e-6), and the same metrics."""
    cfg = jax_minicpm.smoke_config()
    params = _numpy(T.init_params(jax.random.key(0), cfg))
    want = []
    jt = _jax_trainer(cfg)
    jt.run(jt.init_state(_jax(params)), jax_lm_batches(BATCH, SEQ, cfg.vocab), 6,
           log_every=1, log_fn=_log(want))
    model = transformer_params_from_numpy(params, _port_cfg(cfg), "cpu")
    got = []
    pt = _port_trainer(model)
    state, hist = pt.run(pt.init_state(transformer_param_tree(model)),
                         lm_batches(BATCH, SEQ, cfg.vocab), 6, log_every=1,
                         log_fn=_log(got))
    assert [h["step"] for h in got] == list(range(6)) and hist == got[-1]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert abs(g["loss"] - w["loss"]) <= TRAIN_LOSS_TOL
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    assert int(state.opt["step"]) == 6


def test_train_state_converts_both_ways_mid_run():
    """Three reference steps, the state to the port, three port steps;
    and three port steps, the state to the reference, three reference
    steps: both end where six reference steps end."""
    cfg = jax_minicpm.smoke_config()
    params = _numpy(T.init_params(jax.random.key(0), cfg))
    jt = _jax_trainer(cfg)
    six, _ = jt.run(jt.init_state(_jax(params)), jax_lm_batches(BATCH, SEQ, cfg.vocab),
                    6, log_every=0)
    want = jax.tree_util.tree_leaves(_numpy(six.tree()))

    three, _ = jt.run(jt.init_state(_jax(params)),
                      jax_lm_batches(BATCH, SEQ, cfg.vocab), 3, log_every=0)
    model, state = train_state_from_numpy(_numpy(three.tree()), _port_cfg(cfg), "cpu")
    pt = _port_trainer(model)
    state, _ = pt.run(state, lm_batches(BATCH, SEQ, cfg.vocab, start_step=3), 3,
                      log_every=0)
    got = tree_flatten(train_state_to_numpy(state))[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)

    model = transformer_params_from_numpy(params, _port_cfg(cfg), "cpu")
    pt = _port_trainer(model)
    state, _ = pt.run(pt.init_state(transformer_param_tree(model)),
                      lm_batches(BATCH, SEQ, cfg.vocab), 3, log_every=0)
    tree = _jax(train_state_to_numpy(state))
    jstate = type(three)(params=tree["params"], opt=tree["opt"])
    batches = jax_lm_batches(BATCH, SEQ, cfg.vocab, start_step=3)
    for _ in range(3):
        b = {k: v for k, v in next(batches).items() if k in ("tokens", "labels")}
        jstate.params, jstate.opt, _ = jt._step(jstate.params, jstate.opt, b)
    for a, b in zip(jax.tree_util.tree_leaves(_numpy(jstate.tree())), want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def _leaves(state):
    return [x.detach().clone() for x in tree_flatten(state.tree())[0]]


def test_trainer_resumes_bit_equal(tmp_path):
    """Checkpoint every 2 steps, run to 5, drop the trainer, resume a new
    one from scratch weights: it restores step 4 bit-equal and its steps
    4-5 log the uninterrupted run's losses (the same batches through
    ``lm_batches(start_step=4)``)."""
    cfg = _port_cfg(jax_minicpm.smoke_config())
    ref_losses = []
    model = PT.Transformer(cfg, device="cpu", seed=5)
    pt = _port_trainer(model)
    pt.run(pt.init_state(transformer_param_tree(model)),
           lm_batches(BATCH, SEQ, cfg.vocab), 6, log_every=1, log_fn=_log(ref_losses))

    d = str(tmp_path / "ck")
    model = PT.Transformer(cfg, device="cpu", seed=5)
    pt = _port_trainer(model, d, ckpt_every=2)
    state, _ = pt.run(pt.init_state(transformer_param_tree(model)),
                      lm_batches(BATCH, SEQ, cfg.vocab), 5, log_every=0)
    del pt
    model2 = PT.Transformer(cfg, device="cpu", seed=99)  # other weights
    pt2 = _port_trainer(model2, d, ckpt_every=2)
    fresh = pt2.init_state(transformer_param_tree(model2))
    restored, step = pt2.maybe_resume(fresh)
    assert step == 4 and restored is fresh
    saved = restore_checkpoint(d, 4, fresh.tree())[0]
    for got, want in zip(_leaves(restored), tree_flatten(saved)[0]):
        assert torch.equal(got, torch.as_tensor(want))
    got = []
    pt2.run(restored, lm_batches(BATCH, SEQ, cfg.vocab, start_step=4), 6,
            log_every=1, log_fn=_log(got))
    assert [h["step"] for h in got] == [4, 5]
    assert [h["loss"] for h in got] == [h["loss"] for h in ref_losses[4:]]


def test_pinned_stager_takes_turns():
    """``PinnedStager`` off the card: two slots that take turns, a buffer
    remade when a batch's shape or type changes, each batch sent as
    filled."""
    from repro_torch.data.pipeline import PinnedStager

    stager = PinnedStager("cpu")
    sent = []
    for i, (shape, dtype) in enumerate([((2, 3), np.int32), ((2, 3), np.int32),
                                        ((2, 3), np.int32), ((4,), np.float32)]):
        bufs = stager.take({"x": (shape, dtype), "y": ((), np.int64)})
        bufs["x"][...] = i
        bufs["y"][...] = -i
        out = stager.send()
        assert out["x"].shape == shape and out["x"].numpy().dtype == dtype
        assert (out["x"] == i).all() and int(out["y"]) == -i
        sent.append(out["x"])
    assert sent[2].data_ptr() == sent[0].data_ptr() != sent[1].data_ptr()
    assert sent[3].data_ptr() not in (sent[0].data_ptr(), sent[1].data_ptr())


def test_checkpoints_restore_across_packages(tmp_path):
    """A float32 step either package's ``Trainer`` writes restores in the
    other's, every leaf equal (the port writes the reference's layout in
    ``jax.tree_util``'s leaf order)."""
    cfg = jax_minicpm.smoke_config()
    params = _numpy(T.init_params(jax.random.key(0), cfg))
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jt = _jax_trainer(cfg, jd, ckpt_every=2)
    jstate, _ = jt.run(jt.init_state(_jax(params)),
                       jax_lm_batches(BATCH, SEQ, cfg.vocab), 2, log_every=0)
    model = transformer_params_from_numpy(params, _port_cfg(cfg), "cpu")
    pt = _port_trainer(model, jd)
    state, step = pt.maybe_resume(pt.init_state(transformer_param_tree(model)))
    assert step == 2
    for a, b in zip(tree_flatten(train_state_to_numpy(state))[0],
                    jax.tree_util.tree_leaves(_numpy(jstate.tree()))):
        np.testing.assert_array_equal(a, b)

    pt = _port_trainer(model, pd, ckpt_every=3)
    state, _ = pt.run(state, lm_batches(BATCH, SEQ, cfg.vocab, start_step=2), 3,
                      log_every=0)
    jt2 = _jax_trainer(cfg, pd)
    fresh = jt2.init_state(T.init_params(jax.random.key(7), cfg))
    jrestored, jstep = jt2.maybe_resume(fresh)
    assert jstep == 3
    for a, b in zip(jax.tree_util.tree_leaves(_numpy(jrestored.tree())),
                    tree_flatten(train_state_to_numpy(state))[0]):
        np.testing.assert_array_equal(a, b)


def test_bf16_leaves_round_trip(tmp_path):
    """A bfloat16 leaf is saved as its 16-bit pattern under the dtype
    "bfloat16" and restores bit-equal (queue 3 item 10): a trainer's
    bfloat16 weights and moments included."""
    d = str(tmp_path)
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 5, generator=g).to(torch.bfloat16),
            "special": torch.tensor([float("inf"), -0.0, float("nan"), 1e-40],
                                    dtype=torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(d, 1, tree)
    manifest = read_manifest(d, 1)
    assert [s["dtype"] for s in manifest["leaves"]] == ["bfloat16", "int32", "bfloat16"]
    step, out, _ = restore_latest(d, tree)
    assert step == 1
    for k in ("w", "special"):
        assert out[k].dtype == torch.bfloat16
        assert torch.equal(out[k].view(torch.int16), tree[k].view(torch.int16))

    cfg = dataclasses.replace(minicpm_2b.smoke_config(), dtype=torch.bfloat16)
    model = PT.Transformer(cfg, device="cpu", seed=1)
    pt = Trainer(lambda p, b: PT.loss_fn(model, b["tokens"], b["labels"]),
                 AdamWConfig(state_dtype="bfloat16"), ckpt_dir=d + "/t", ckpt_every=2)
    state, _ = pt.run(pt.init_state(transformer_param_tree(model)),
                      lm_batches(2, 8, cfg.vocab), 2, log_every=0)
    saved = _leaves(state)
    model2 = PT.Transformer(cfg, device="cpu", seed=2)
    pt2 = Trainer(pt.loss_fn, pt.opt_cfg, ckpt_dir=d + "/t")
    restored, step = pt2.maybe_resume(pt2.init_state(transformer_param_tree(model2)))
    assert step == 2
    for a, b in zip(_leaves(restored), saved):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_reference_bf16_checkpoints(tmp_path):
    """The reference's bfloat16 leaves (``|V2`` to numpy) restore in the
    port bit-equal; the reference's ``restore_latest`` returns None for a
    bfloat16 checkpoint from either package (its dtype check fails on both
    files), pinned here and left as it is."""
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((3, 7)).astype(np.float32)
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jtree = {"w": jnp.asarray(vals, jnp.bfloat16), "n": jnp.arange(3, dtype=jnp.int32)}
    jax_ckpt.save_checkpoint(jd, 1, jtree)
    assert jax_ckpt.restore_latest(jd, jtree) is None
    ptree = {"w": torch.from_numpy(vals).to(torch.bfloat16),
             "n": torch.arange(3, dtype=torch.int32)}
    step, out, _ = restore_latest(jd, ptree)
    assert step == 1 and out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), ptree["w"].view(torch.int16))
    np.testing.assert_array_equal(out["n"], np.arange(3))
    save_checkpoint(pd, 1, ptree)
    assert jax_ckpt.restore_latest(pd, jtree) is None


# ----------------------------------------------------------------- the rest

@pytest.mark.parametrize("seed,start,shard", [(0, 0, 0), (3, 17, 2), (11, 5, 1)])
def test_lm_batches_bit_equal(seed, start, shard):
    want = jax_lm_batches(3, 33, 1000, seed=seed, shard_id=shard, start_step=start)
    got = lm_batches(3, 33, 1000, seed=seed, shard_id=shard, start_step=start)
    for _ in range(3):
        a, b = next(got), next(want)
        assert set(a) == set(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(a[k], b[k])


def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=ROOT)


def test_train_cli_on_the_cpu(tmp_path):
    d = str(tmp_path / "ck")
    first = _cli("--arch", "minicpm-2b", "--steps", "10", "--batch", "2", "--seq",
                 "16", "--log-every", "3", "--ckpt-dir", d, "--device", "cpu")
    assert first.returncode == 0, first.stderr
    lines = [l for l in first.stdout.splitlines() if l.startswith("[train]")]
    assert all(f in lines[0] for f in ("attn=torch", "device=cpu", "d_head=8"))
    assert [l.split("step=")[1].split()[0] for l in lines[1:-1]] == ["0", "3", "6", "9"]
    assert all("loss=" in l and "grad_norm=" in l and "lr=" in l for l in lines[1:-1])
    assert "done: final loss" in lines[-1]
    again = _cli("--arch", "minicpm-2b", "--steps", "10", "--batch", "2", "--seq",
                 "16", "--ckpt-dir", d, "--device", "cpu")
    assert again.returncode == 0, again.stderr
    assert "resumed at step 10 of 10" in again.stdout
    # a MoE arch trains through the same loss_fn, its auxiliary term logged
    moe = _cli("--arch", "mixtral-8x7b", "--steps", "3", "--batch", "2", "--seq",
               "16", "--log-every", "1", "--device", "cpu")
    assert moe.returncode == 0, moe.stderr
    steps = [l for l in moe.stdout.splitlines() if l.startswith("[train] moe_aux_loss=")]
    assert len(steps) == 3 and "done: final loss" in moe.stdout
    assert all(float(l.split("moe_aux_loss=")[1].split()[0]) > 0
               and "moe_dropped=" in l for l in steps)


def test_train_cli_needs_a_card_or_cpu(monkeypatch):
    from repro_torch.launch import train as launcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--steps", "1"])


def test_train_cli_head_size(monkeypatch, capsys):
    """``--d-head`` sets the smoke config's heads (stated in the header);
    on the card a head size the attention kernel does not take (the smoke
    configs' 8) exits 2 before anything is built, never running the plain
    attention in its place."""
    from repro_torch.core import table
    from repro_torch.launch import train as launcher

    assert launcher.main(["--steps", "2", "--batch", "2", "--seq", "8",
                          "--d-head", "16", "--device", "cpu"]) == 0
    assert "d_head=16" in capsys.readouterr().out
    monkeypatch.setattr(table, "resolve_device", lambda d: torch.device("cuda", 0))
    called = []
    monkeypatch.setattr(launcher, "train_lm", lambda *a: called.append(a))
    assert launcher.main(["--steps", "1"]) == 2
    assert "--d-head" in capsys.readouterr().err and not called
    assert launcher.main(["--steps", "1", "--d-head", "32"]) == 0
    assert called[0][-1] == 32


@pytest.mark.parametrize("ref,port,exceptions", [
    (jax_core, port_core, {"packable_keys", "count_hlo_sorts"}),
    (jax_kernels, port_kernels, set()),
], ids=["core", "kernels"])
def test_packages_export_the_reference_names(ref, port, exceptions):
    """Queue 3 item 9: the reference's ``__all__`` less the stated
    exceptions, each name importable; the port adds only
    ``resolve_device``."""
    assert set(ref.__all__) - set(port.__all__) == exceptions
    assert set(port.__all__) - set(ref.__all__) <= {"resolve_device"}
    assert all(hasattr(port, n) for n in port.__all__)
