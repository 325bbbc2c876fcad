"""The port's mixture-of-experts layer and MoE decoders on the CPU against
the JAX package's.

Same weights on both sides (the reference's initialisers, carried over by
``convert``), same inputs (numpy, seeded), all float32, the reference on
its ``"xla"`` path.  Held here, each with its tolerance:

* ``moe_apply`` against ``repro.models.moe.moe_apply``, global and batched
  dispatch (the batched one against the reference transformer's ``vmap``),
  with and without the dense residual, at a capacity that keeps every row
  and one low enough that rows drop: ``out`` within 1e-5 absolute and
  relative (the expert products sum in other orders; a token's two rows
  add in one order on both sides), ``aux_loss`` within 1e-6 relative,
  ``dropped_tokens`` equal;
* tied router logits (duplicated router columns, and a zero router):
  the port's picks equal ``jax.lax.top_k``'s (the lower index first) and
  the outputs agree as above; at the model level too (a duplicated router
  column in every layer: logits, metrics, loss and gradients as below);
* the counterparts of ``tests/test_models.py``'s MoE tests: the dense
  ensemble at ``k == E`` (2e-4, theirs), drops counted, gradients flow;
* the mixtral and arctic smoke configs (and each with the batched
  dispatch): ``forward`` with its metrics, ``prefill`` into a cache longer
  than the prompt (mixtral's window of 8 inside a 12-token prompt) and
  four ``decode_step``s, within 2e-4 absolute and relative
  (``test_torch_models.py``'s), the metrics as above;
* ``loss_fn`` (the auxiliary term included) and its gradient against
  ``jax.value_and_grad``: the loss within 1e-6 relative, each gradient
  leaf within 1e-5 of its largest magnitude (``test_torch_train.py``'s);
* ``convert`` both ways for a MoE training state: bit-equal leaves;
* the configs' numbers letter for letter, and the train CLI on the CPU
  (``test_torch_train.py`` runs it on mixtral's smoke config);
* each smoke config (and its batched dispatch) under remat ``"nothing"``
  and ``"dots"``: the loss, metrics and gradients bit-equal to remat off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arctic_480b as jax_arctic
from repro.configs import mixtral_8x7b as jax_mixtral
from repro.models import moe as JM
from repro.models import transformer as T
from repro_torch.configs import arctic_480b, mixtral_8x7b
from repro_torch.convert import (gnn_params_from_numpy, gnn_params_to_numpy,
                                 train_state_from_numpy, train_state_to_numpy,
                                 transformer_param_tree,
                                 transformer_params_from_numpy)
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.models.layers import swiglu
from repro_torch.train import tree_flatten

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
AUX_RTOL = 1e-6
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
B, PROMPT, CACHE, STEPS = 2, 12, 20, 4
SERVED = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab", "d_head", "qkv_bias", "sliding_window", "rope_theta",
          "tie_embeddings")
PORTED = {"mixtral": (jax_mixtral, mixtral_8x7b), "arctic": (jax_arctic, arctic_480b)}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_moe(cfg: JM.MoEConfig) -> PM.MoEConfig:
    return PM.MoEConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


def _layer(cfg, d=12, seed=0):
    p = JM.moe_init(jax.random.key(seed), cfg, d)
    return p, gnn_params_from_numpy(_numpy(p), "cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_batched(p, cfg, h):
    """The reference transformer's batched dispatch (``transformer.py:
    276-280``)."""
    y, m = jax.vmap(lambda hs: JM.moe_apply(p, cfg, hs))(h)
    return y, {"dropped_tokens": jnp.sum(m["dropped_tokens"]),
               "aux_loss": jnp.mean(m["aux_loss"])}


def _close_metrics(got, want):
    assert got["dropped_tokens"].dtype == torch.int32
    assert int(got["dropped_tokens"]) == int(want["dropped_tokens"])
    np.testing.assert_allclose(got["aux_loss"].item(), float(want["aux_loss"]),
                               rtol=AUX_RTOL)


# ------------------------------------------------------------------ the layer

@pytest.mark.parametrize("dispatch", ["global", "batched"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dense_residual", [None, 8])
def test_moe_apply_matches_reference(dispatch, capacity_factor, dense_residual):
    cfg = JM.MoEConfig(n_experts=4, top_k=2, d_ff=16, capacity_factor=capacity_factor,
                       dense_residual_d_ff=dense_residual, dispatch=dispatch)
    p, tp = _layer(cfg)
    if dispatch == "global":
        x = _x((40, 12))
        want, wm = JM.moe_apply(p, cfg, jnp.asarray(x))
        got, gm = PM.moe_apply(tp, _port_moe(cfg), torch.from_numpy(x))
    else:
        x = _x((3, 20, 12))
        want, wm = _jax_batched(p, cfg, jnp.asarray(x))
        got, gm = PM.moe_apply_grouped(tp, _port_moe(cfg), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    _close_metrics(gm, wm)
    if capacity_factor < 1:
        assert int(gm["dropped_tokens"]) > 0
    else:
        assert int(gm["dropped_tokens"]) == 0


@pytest.mark.parametrize("tie", ["duplicated-columns", "zero-router"])
def test_tied_router_logits_pick_as_top_k(tie):
    """Logits that tie exactly: the port's picks are ``jax.lax.top_k``'s,
    the lower expert index first, and so are its outputs and auxiliary
    loss (whose ``ce`` reads the first pick)."""
    cfg = JM.MoEConfig(n_experts=6, top_k=2, d_ff=16, capacity_factor=2.0)
    p = JM.moe_init(jax.random.key(3), cfg, 12)
    w = np.asarray(p["router"]["w"]).copy()
    if tie == "duplicated-columns":
        w[:, 4] = w[:, 1]          # experts 1 and 4 tie for every token
        w[:, 5] = w[:, 2]          # and 2 and 5
    else:
        w[:] = 0                   # every expert ties
    p["router"]["w"] = jnp.asarray(w)
    tp = gnn_params_from_numpy(_numpy(p), "cpu")
    x = _x((48, 12), seed=4)
    logits = jnp.asarray(x) @ p["router"]["w"]
    _, want_e = jax.lax.top_k(logits.astype(jnp.float32), cfg.top_k)
    _, _, got_e = PM.route(tp, _port_moe(cfg), torch.from_numpy(x))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    if tie == "zero-router":
        assert (got_e.numpy() == [0, 1]).all()
    else:
        assert np.isin(got_e.numpy(), [4, 5]).sum() < np.isin(got_e.numpy(), [1, 2]).sum()
    want, wm = JM.moe_apply(p, cfg, jnp.asarray(x))
    got, gm = PM.moe_apply(tp, _port_moe(cfg), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    _close_metrics(gm, wm)


def test_capacity_is_the_reference_arithmetic():
    for t in (1, 2, 7, 64, 4096, 12288, 6144):
        for cfg in (JM.MoEConfig(8, 2, 16), JM.MoEConfig(128, 2, 16),
                    JM.MoEConfig(8, 2, 16, capacity_factor=1.0),
                    JM.MoEConfig(4, 1, 16, capacity_factor=0.3)):
            assert PM._capacity(t, _port_moe(cfg)) == JM._capacity(t, cfg)
    # the full-width serving shapes of chip_smoke.py's phase 13
    assert PM._capacity(12288, _port_moe(jax_mixtral.full_config().moe)) == 3848
    assert PM._capacity(4096, _port_moe(jax_arctic.full_config().moe)) == 88
    assert PM._capacity(2, _port_moe(jax_arctic.full_config().moe)) == 8


def test_unknown_dispatch_raises():
    with pytest.raises(ValueError, match="dispatch"):
        PM.MoEConfig(4, 2, 16, dispatch="vmap")


# the counterparts of tests/test_models.py's MoE tests

def test_moe_matches_dense_ensemble_when_k_equals_e():
    """top_k == n_experts with a zero router: the experts' mean."""
    cfg = PM.MoEConfig(n_experts=2, top_k=2, d_ff=32, capacity_factor=4.0)
    p = PM.moe_init(torch.Generator().manual_seed(0), cfg, 16)
    p["router"]["w"].zero_()
    x = torch.from_numpy(_x((24, 16)))
    out, m = PM.moe_apply(p, cfg, x)
    assert int(m["dropped_tokens"]) == 0
    e = p["experts"]
    want = 0.5 * sum(swiglu(x, e["gate"]["w"][i], e["up"]["w"][i], e["down"]["w"][i])
                     for i in range(2))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_moe_capacity_drops_are_counted():
    cfg = PM.MoEConfig(n_experts=4, top_k=1, d_ff=16, capacity_factor=0.3)
    p = PM.moe_init(torch.Generator().manual_seed(0), cfg, 8)
    p["router"]["w"].zero_()[:, 0] = 10.0     # most tokens to expert 0
    x = torch.from_numpy(_x((64, 8)))
    out, m = PM.moe_apply(p, cfg, x)
    load = torch.bincount(PM.route(p, cfg, x)[2][:, 0], minlength=4)
    want = int(torch.clamp(load - PM._capacity(64, cfg), min=0).sum())
    assert int(m["dropped_tokens"]) == want > 0
    assert bool(torch.isfinite(out).all())


def test_moe_grad_flows():
    cfg = PM.MoEConfig(n_experts=4, top_k=2, d_ff=16)
    p = PM.moe_init(torch.Generator().manual_seed(0), cfg, 8)
    leaves = tree_flatten(p)[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    out, _ = PM.moe_apply(p, cfg, torch.from_numpy(_x((32, 8))))
    grads = torch.autograd.grad((out ** 2).sum(), leaves)
    gn = sum(float((g * g).sum()) for g in grads)
    assert gn > 0 and np.isfinite(gn)


def test_moe_grads_match_reference():
    """The layer's gradient (the router through the gates and the
    auxiliary loss, the experts, the residual, the input) against
    ``jax.grad``, with rows dropped."""
    cfg = JM.MoEConfig(n_experts=4, top_k=2, d_ff=16, capacity_factor=0.75,
                       dense_residual_d_ff=8)
    p, tp = _layer(cfg, seed=5)
    x = _x((40, 12), seed=6)

    def jloss(p, x):
        out, m = JM.moe_apply(p, cfg, x)
        return jnp.sum(out ** 2) + m["aux_loss"]

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    leaves = tree_flatten(tp)[0]
    xt = torch.from_numpy(x).requires_grad_(True)
    for leaf in leaves:
        leaf.requires_grad_(True)
    out, m = PM.moe_apply(tp, _port_moe(cfg), xt)
    assert int(m["dropped_tokens"]) > 0
    grads = torch.autograd.grad((out ** 2).sum() + m["aux_loss"], [*leaves, xt])
    for got, want in zip(grads, [*jax.tree_util.tree_leaves(want_p), want_x]):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= GRAD_TOL * np.abs(want).max()


# ------------------------------------------------------------- the decoders

CONFIGS = {
    "mixtral-smoke": jax_mixtral.smoke_config,
    "arctic-smoke": jax_arctic.smoke_config,
    "mixtral-smoke-batched": lambda: dataclasses.replace(
        jax_mixtral.smoke_config(), moe=dataclasses.replace(
            jax_mixtral.smoke_config().moe, dispatch="batched", capacity_factor=1.0)),
    "arctic-smoke-batched": lambda: dataclasses.replace(
        jax_arctic.smoke_config(), moe=dataclasses.replace(
            jax_arctic.smoke_config().moe, dispatch="batched")),
}


def _port_cfg(ref_cfg) -> PT.TransformerConfig:
    assert ref_cfg.dtype == jnp.float32
    return PT.TransformerConfig(**{f: getattr(ref_cfg, f) for f in SERVED},
                                moe=_port_moe(ref_cfg.moe), remat=ref_cfg.remat,
                                dtype=torch.float32, kernel_backend="torch")


def _pair(name):
    ref_cfg = dataclasses.replace(CONFIGS[name](), attn_backend="xla")
    params = T.init_params(jax.random.key(0), ref_cfg)
    model = transformer_params_from_numpy(_numpy(params), _port_cfg(ref_cfg), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, ref_cfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)
    return ref_cfg, params, model, tokens


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_reference(name):
    ref_cfg, params, model, tokens = _pair(name)
    want, wm = T.forward(params, ref_cfg, jnp.asarray(tokens))
    got, gm = model.forward_with_metrics(torch.from_numpy(tokens).long())
    assert got.shape == (B, PROMPT + STEPS, ref_cfg.vocab)
    _close(got, want)
    assert gm["moe_dropped"].dtype == torch.int32
    assert int(gm["moe_dropped"]) == int(wm["moe_dropped"])
    np.testing.assert_allclose(gm["moe_aux_loss"].item(), float(wm["moe_aux_loss"]),
                               rtol=AUX_RTOL)
    assert torch.equal(model(torch.from_numpy(tokens).long()), got)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_reference(name):
    """A prompt of 12 into a 20-slot cache, then 4 steps: the cache is
    longer than what is written at every call, and mixtral's window of 8
    lies inside the prompt."""
    ref_cfg, params, model, tokens = _pair(name)
    ref_cache = T.init_kv_cache(ref_cfg, B, CACHE, dtype=jnp.float32)
    want, ref_cache = T.prefill(params, ref_cfg, jnp.asarray(tokens[:, :PROMPT]),
                                ref_cache)
    cache = model.init_kv_cache(B, CACHE)
    got, cache = model.prefill(torch.from_numpy(tokens[:, :PROMPT]).long(), cache)
    _close(got, want)
    for i in range(PROMPT, PROMPT + STEPS):
        want, ref_cache = T.decode_step(params, ref_cfg, jnp.asarray(tokens[:, i]),
                                        ref_cache)
        got, cache = model.decode_step(torch.from_numpy(tokens[:, i]).long(), cache)
        _close(got, want)
    assert cache["pos"] == PROMPT + STEPS
    _close(cache["k"], ref_cache["k"])
    _close(cache["v"], ref_cache["v"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grad_match_reference(name):
    ref_cfg, params, model = _pair(name)[:3]
    toks = np.random.default_rng(2).integers(0, ref_cfg.vocab, (2, 13)).astype(np.int32)
    (want, aux), want_g = jax.value_and_grad(
        lambda p: T.loss_fn(p, ref_cfg, toks[:, :-1], toks[:, 1:]),
        has_aux=True)(params)
    leaves = tree_flatten(transformer_param_tree(model))[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = PT.loss_fn(model, torch.from_numpy(toks[:, :-1]),
                               torch.from_numpy(toks[:, 1:]))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    assert float(aux["moe_aux_loss"]) > 0 and not metrics["moe_aux_loss"].requires_grad
    np.testing.assert_allclose(metrics["moe_aux_loss"].item(), float(aux["moe_aux_loss"]),
                               rtol=AUX_RTOL)
    assert int(metrics["moe_dropped"]) == int(aux["moe_dropped"])
    # the auxiliary term is in the loss: 0.01 * aux / n_layers over the CE
    ce = PT.cross_entropy_loss(model(torch.from_numpy(toks[:, :-1])),
                               torch.from_numpy(toks[:, 1:]))
    np.testing.assert_allclose(
        loss.item() - ce.item(), 0.01 * float(aux["moe_aux_loss"]) / ref_cfg.n_layers,
        rtol=1e-4)
    want_leaves = jax.tree_util.tree_leaves(want_g)  # the same (sorted) order
    assert len(grads) == len(want_leaves)
    for got, ref in zip(grads, want_leaves):
        ref = np.asarray(ref, dtype=np.float32)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= GRAD_TOL * np.abs(ref).max()


@pytest.mark.parametrize("name", ["mixtral-smoke", "arctic-smoke"])
def test_tied_router_model_matches_reference(name):
    """Each layer's router with a duplicated column (two experts tie for
    every token, the lower picked first): logits, metrics, loss and
    gradients as the reference's, rows dropped."""
    ref_cfg = dataclasses.replace(CONFIGS[name](), attn_backend="xla")
    params = _numpy(T.init_params(jax.random.key(0), ref_cfg))
    w = params["layers"]["moe"]["router"]["w"].copy()
    w[..., 3] = w[..., 1]
    params["layers"]["moe"]["router"]["w"] = w
    model = transformer_params_from_numpy(params, _port_cfg(ref_cfg), "cpu")
    toks = np.random.default_rng(3).integers(0, ref_cfg.vocab, (2, 13)).astype(np.int32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (want, aux), want_g = jax.value_and_grad(
        lambda p: T.loss_fn(p, ref_cfg, toks[:, :-1], toks[:, 1:]),
        has_aux=True)(jparams)
    leaves = tree_flatten(transformer_param_tree(model))[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = PT.loss_fn(model, torch.from_numpy(toks[:, :-1]),
                               torch.from_numpy(toks[:, 1:]))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    assert int(metrics["moe_dropped"]) == int(aux["moe_dropped"]) > 0
    np.testing.assert_allclose(metrics["moe_aux_loss"].item(), float(aux["moe_aux_loss"]),
                               rtol=AUX_RTOL)
    for got, ref in zip(grads, jax.tree_util.tree_leaves(want_g)):
        ref = np.asarray(ref, dtype=np.float32)
        assert np.abs(got.numpy() - ref).max() <= GRAD_TOL * np.abs(ref).max()
    want_logits, _ = T.forward(jparams, ref_cfg, jnp.asarray(toks))
    _close(model(torch.from_numpy(toks).long()), want_logits)


def test_moe_train_state_converts_both_ways():
    """A MoE training state (parameters and AdamW moments, the router,
    experts and dense residual among them) from the reference's layout to
    the port's and back: every leaf bit-equal, in the same order."""
    from repro.train.optimizer import adamw_init as jax_adamw_init

    ref_cfg = jax_arctic.smoke_config()
    params = T.init_params(jax.random.key(0), ref_cfg)
    opt = jax_adamw_init(params)
    rng = np.random.default_rng(7)
    opt = {"step": np.asarray(5, np.int32),
           "m": jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape)
                                       .astype(np.float32), _numpy(opt["m"])),
           "v": jax.tree_util.tree_map(lambda a: rng.random(a.shape)
                                       .astype(np.float32), _numpy(opt["v"]))}
    tree = {"params": _numpy(params), "opt": opt}
    model, state = train_state_from_numpy(tree, _port_cfg(ref_cfg), "cpu")
    assert model.expert_gate.shape == (2, 8, 64, 64)
    assert model.residual_down.shape == (2, 64, 64)
    back = train_state_to_numpy(state)
    want = jax.tree_util.tree_leaves(tree)
    got = tree_flatten(back)[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_moe_params_carry_both_ways():
    cfg = JM.MoEConfig(n_experts=4, top_k=2, d_ff=16, dense_residual_d_ff=8)
    p, tp = _layer(cfg)
    for a, b in zip(jax.tree_util.tree_leaves(_numpy(p)),
                    tree_flatten(gnn_params_to_numpy(tp))[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(PORTED))
def test_configs_match_reference(name):
    """The port's configs carry the reference's numbers letter for letter:
    the full ones in bfloat16, the smoke ones in float32, the optimized
    ones' dispatch and capacity."""
    ref_mod, port_mod = PORTED[name]
    for which, dtype in (("full_config", torch.bfloat16),
                         ("smoke_config", torch.float32),
                         ("optimized_config", torch.bfloat16)):
        ref_cfg, cfg = getattr(ref_mod, which)(), getattr(port_mod, which)()
        assert {f: getattr(cfg, f) for f in SERVED} == {
            f: getattr(ref_cfg, f) for f in SERVED}
        assert cfg.moe == _port_moe(ref_cfg.moe) and cfg.dtype == dtype
        assert cfg.remat == ref_cfg.remat
        assert (cfg.n_params, cfg.n_active_params) == (ref_cfg.n_params,
                                                       ref_cfg.n_active_params)
    assert port_mod.ARCH_ID == ref_mod.ARCH_ID


def test_full_size_numbers():
    """mixtral-8x7b: 46.7 B parameters, 12.9 B active, 2.9 GB a layer in
    bfloat16, heads of 128, GQA 4:1, window 4,096; arctic-480b: 476.9 B, 27.2
    GB a layer (128 experts and the dense residual), heads of 128, GQA
    7:1."""
    m, a = mixtral_8x7b.full_config(), arctic_480b.full_config()
    assert (m.n_params, m.n_active_params) == (46_702_792_704, 12_879_925_248)
    assert (m.head_dim, m.n_heads // m.n_kv_heads, m.sliding_window) == (128, 4, 4096)
    assert (a.n_params, a.head_dim, a.n_heads // a.n_kv_heads) == (476_850_275_328,
                                                                  128, 7)
    per_layer = lambda c: sum(  # noqa: E731
        np.prod(s[1:]) for k, s in PT.weight_shapes(c).items()
        if k not in ("embed", "final_norm", "lm_head"))
    assert round(2 * per_layer(m) / 1e9, 1) == 2.9
    assert round(2 * per_layer(a) / 1e9, 1) == 27.2


def test_drawn_moe_weights_follow_the_reference_initialisers():
    cfg = dataclasses.replace(arctic_480b.smoke_config(), n_layers=3)
    model = PT.Transformer(cfg, device="cpu", seed=0)
    assert set(dict(model.named_parameters())) == set(PT.weight_shapes(cfg))
    for name, d_in in (("router", 64), ("expert_gate", 64), ("expert_down", 64),
                       ("residual_up", 64)):
        w = getattr(model, name)
        np.testing.assert_allclose(w.std().item(), d_in ** -0.5, rtol=0.1)
    assert not hasattr(model, "w_gate")
    assert not model.expert_up.requires_grad


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_remat_gradients_bit_equal(name, policy):
    """A MoE layer under remat (the full configs' ``remat=True``): the
    recomputed forward routes as the first (the same sorts, slots and
    combine ids), so the loss, its metrics and every gradient are the bits
    of the run without remat; under ``"dots"`` the experts' batched
    products (``aten.bmm``) are recomputed, the dense ones kept."""
    ref_cfg = dataclasses.replace(CONFIGS[name](), attn_backend="xla")
    params = _numpy(T.init_params(jax.random.key(0), ref_cfg))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, ref_cfg.vocab, (2, 13)).astype(np.int32))
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(_port_cfg(ref_cfg), remat=remat, remat_policy=policy)
        model = transformer_params_from_numpy(params, cfg, "cpu")
        leaves = tree_flatten(transformer_param_tree(model))[0]
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, metrics = PT.loss_fn(model, toks[:, :-1], toks[:, 1:])
        out[remat] = (loss, metrics, torch.autograd.grad(loss, leaves))
    (l0, m0, g0), (l1, m1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert len(g0) == len(g1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
