"""The port's dense transformer on the CPU against the JAX package's.

Same weights on both sides (the reference's ``init_params``, carried over by
``convert.transformer_params_from_numpy``), same token ids (numpy, seeded):
``forward``, ``prefill`` into a cache longer than the prompt and four
``decode_step``s against the reference's ``attn_backend="xla"`` path (the
one that masks unwritten cache slots), and a prompt that fills the cache
against ``"interpret"`` (the Pallas kernel body, right only there; ROADMAP
queue 3 item 6).  Configs: the smoke configs of granite, minicpm (tied
embeddings, MHA) and qwen2 (QKV bias), and ``tests/test_models.py``'s
``tiny_cfg`` with and without ``sliding_window=4``.  All float32; the
tolerance, 2e-4 absolute and relative, is ``test_models.py``'s for
prefill against forward (the two sides sum in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_8b as jax_granite
from repro.configs import minicpm_2b as jax_minicpm
from repro.configs import qwen2_72b as jax_qwen2
from repro.models import transformer as T
from repro_torch.configs import granite_8b, minicpm_2b, qwen2_72b
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.models.transformer import Transformer, TransformerConfig

TOL = dict(rtol=2e-4, atol=2e-4)
B, PROMPT, CACHE, STEPS = 2, 8, 16, 4

PORTED = {  # name -> (reference module, port module)
    "granite": (jax_granite, granite_8b),
    "minicpm": (jax_minicpm, minicpm_2b),
    "qwen2": (jax_qwen2, qwen2_72b),
}
SERVED = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab", "d_head", "qkv_bias", "sliding_window", "rope_theta",
          "tie_embeddings")


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


def _port_cfg(ref_cfg) -> TransformerConfig:
    assert ref_cfg.dtype == jnp.float32
    return TransformerConfig(**{f: getattr(ref_cfg, f) for f in SERVED},
                             dtype=torch.float32, kernel_backend="torch")


def _pair(name):
    ref_cfg = dataclasses.replace(CONFIGS[name](), attn_backend="xla")
    params = T.init_params(jax.random.key(0), ref_cfg)
    model = transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), _port_cfg(ref_cfg), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, ref_cfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)
    return ref_cfg, params, model, tokens


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_reference(name):
    ref_cfg, params, model, tokens = _pair(name)
    want, _ = T.forward(params, ref_cfg, jnp.asarray(tokens))
    got = model(torch.from_numpy(tokens).long())
    assert got.shape == (B, PROMPT + STEPS, ref_cfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_reference_xla(name):
    """A prompt of 8 into a 16-slot cache, then 4 steps: the cache is longer
    than what is written at every call."""
    ref_cfg, params, model, tokens = _pair(name)
    ref_cache = T.init_kv_cache(ref_cfg, B, CACHE, dtype=jnp.float32)
    want, ref_cache = T.prefill(params, ref_cfg, jnp.asarray(tokens[:, :PROMPT]),
                                ref_cache)
    cache = model.init_kv_cache(B, CACHE)
    got, cache = model.prefill(torch.from_numpy(tokens[:, :PROMPT]).long(), cache)
    assert cache["pos"] == PROMPT and got.shape == (B, ref_cfg.vocab)
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
def test_prefill_filling_the_cache_matches_reference_interpret(name):
    """Where the prompt fills the cache, the reference's Pallas path (in
    interpret mode) is right too, and the port agrees with it."""
    ref_cfg, params, model, tokens = _pair(name)
    ref_cfg = dataclasses.replace(ref_cfg, attn_backend="interpret")
    ref_cache = T.init_kv_cache(ref_cfg, B, PROMPT, dtype=jnp.float32)
    want, _ = T.prefill(params, ref_cfg, jnp.asarray(tokens[:, :PROMPT]), ref_cache)
    got, _ = model.prefill(torch.from_numpy(tokens[:, :PROMPT]).long(),
                           model.init_kv_cache(B, PROMPT))
    _close(got, want)


@pytest.mark.parametrize("name", list(PORTED))
def test_configs_match_reference(name):
    """The port's configs carry the reference's numbers letter for letter,
    the full ones in bfloat16, the smoke ones in float32."""
    ref_mod, port_mod = PORTED[name]
    for which, dtype in (("full_config", torch.bfloat16),
                         ("smoke_config", torch.float32)):
        ref_cfg, cfg = getattr(ref_mod, which)(), getattr(port_mod, which)()
        assert {f: getattr(cfg, f) for f in SERVED} == {
            f: getattr(ref_cfg, f) for f in SERVED}
        assert cfg.dtype == dtype and ref_cfg.dtype == jnp.dtype(
            "bfloat16" if dtype == torch.bfloat16 else "float32")
        assert cfg.n_params == ref_cfg.n_params and cfg.moe is None


def test_granite_full_size_numbers():
    """granite-8b at its published size: 8.25 B parameters, 16.5 GB in
    bfloat16, head size 128, GQA 4:1."""
    cfg = granite_8b.full_config()
    assert cfg.n_params == 8_254_689_280
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) == (128, 4)


def test_drawn_weights_follow_the_reference_initialisers():
    cfg = dataclasses.replace(qwen2_72b.smoke_config(), n_layers=3)
    model = Transformer(cfg, device="cpu", seed=3)
    same = Transformer(cfg, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  same.parameters()))
    assert model.wq.shape == (3, 64, 64) and model.wk.shape == (3, 64, 16)
    assert torch.equal(model.attn_norm, torch.ones(3, 64))
    assert torch.equal(model.bq, torch.zeros(3, 64))
    # normal times 1/sqrt(d_in): the sample's spread, within 10 %
    assert abs(model.w_down.std().item() * cfg.d_ff ** 0.5 - 1) < 0.1
    assert abs(model.embed.std().item() / 0.02 - 1) < 0.1
    assert not any(p.requires_grad for p in model.parameters())


def test_model_refuses_what_is_not_ported():
    """A MoE config is ported (``tests/test_torch_moe.py``): the model draws
    its weights, and refuses a dense model's weights for it; a prompt past
    the cache raises."""
    from repro_torch.models.moe import MoEConfig

    cfg = granite_8b.smoke_config()
    moe_cfg = dataclasses.replace(cfg, moe=MoEConfig(n_experts=4, top_k=2, d_ff=32))
    assert Transformer(moe_cfg, device="cpu").expert_gate.shape == (2, 4, 64, 32)
    model = Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="are not those of"):
        Transformer(moe_cfg, weights=dict(model.named_parameters()))
    cache = model.init_kv_cache(1, 4)
    with pytest.raises(ValueError, match="cannot hold"):
        model.prefill(torch.zeros(1, 5, dtype=torch.long), cache)


def test_cache_layout_and_in_place_writes():
    cfg = granite_8b.smoke_config()
    model = Transformer(cfg, device="cpu")
    cache = model.init_kv_cache(2, 12)
    assert cache["k"].shape == (2, 2, 2, 12, 8) and cache["pos"] == 0
    k_store = cache["k"]
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 5)))
    _, out = model.prefill(toks, cache)
    assert out is cache and cache["k"] is k_store and cache["pos"] == 5
    assert bool((k_store[:, :, :, :5] != 0).any())
    assert bool((k_store[:, :, :, 5:] == 0).all())


@pytest.mark.parametrize("slots", [12, 20])
def test_reference_pallas_path_attends_to_unwritten_slots(slots):
    """The reference's fault that the port's cut of the cache avoids
    (ROADMAP queue 3 item 6): with a cache longer than what is written, its
    Pallas path aligns the query with the end of the whole static cache and
    attends to the zero slots, in prefill and in the decode step after it;
    ``"xla"`` and the port mask them."""
    ref_cfg, params, model, tokens = _pair("granite-smoke")
    logits = {}
    for backend in ("xla", "interpret"):
        cfg = dataclasses.replace(ref_cfg, attn_backend=backend)
        cache = T.init_kv_cache(cfg, B, slots, jnp.float32)
        pre, cache = T.prefill(params, cfg, jnp.asarray(tokens[:, :PROMPT]), cache)
        dec, _ = T.decode_step(params, cfg, jnp.asarray(tokens[:, PROMPT]), cache)
        logits[backend] = (pre, dec)
    cache = model.init_kv_cache(B, slots)
    pre, cache = model.prefill(torch.from_numpy(tokens[:, :PROMPT]).long(), cache)
    dec, _ = model.decode_step(torch.from_numpy(tokens[:, PROMPT]).long(), cache)
    for got, want, wrong in zip((pre, dec), logits["xla"], logits["interpret"]):
        _close(got, want)
        gap = np.abs(np.asarray(wrong) - np.asarray(want)).max()
        assert gap > 0.1, gap
