"""The port's xDeepFM on the CPU against the JAX package's.

Same weights on both sides (the reference's ``xdeepfm_init``, carried over
by ``convert.xdeepfm_params_from_numpy``), same inputs (numpy, seeded), all
float32.  Held here, each with its tolerance:

* ``embedding_bag`` in every mode (sum, mean, weighted sum, weighted
  mean), bag ids out of range above and below (dropped), against
  ``repro.models.recsys.embedding_bag``: within 1e-6 relative and 1e-7
  absolute (the segment sums add a bag's rows in row order on both sides;
  measured equal), and against sums written out in numpy;
* ``_cin`` against the reference's (other contraction orders: 1e-5
  relative, 1e-6 absolute) and against the explicit outer product
  ``sum_ij W[h,i,j] x0[b,i,d] xk[b,j,d]`` in float64 (1e-5);
* ``xdeepfm_apply``, ``retrieval_scores`` and ``bce_loss`` against the
  reference's, at the smoke widths and at the published widths (39
  fields, embed 10, CIN 200-200-200, MLP 400-400) with small vocabularies:
  logits within 1e-5 relative and absolute; the lookups alone bit-equal;
* ``xdeepfm_apply`` in CIN chunks of 3 and 5 rows equal to one pass, to
  1e-6 (each chunk's matrix product may block its rows otherwise);
* the config's numbers, ``serve_fn`` of each serve shape, ``smoke()``,
  ``recsys_batches`` bit-equal over 3 steps, and the parameters carried
  both ways bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import xdeepfm as jax_xdeepfm
from repro.data.pipeline import recsys_batches as jax_recsys_batches
from repro.models import recsys as JR
from repro_torch.configs import xdeepfm
from repro_torch.convert import (xdeepfm_params_from_numpy,
                                 xdeepfm_params_to_numpy)
from repro_torch.data.pipeline import recsys_batches
from repro_torch.models import recsys as PR
from repro_torch.train import tree_flatten

BAG_TOL = dict(rtol=1e-6, atol=1e-7)
CIN_TOL = dict(rtol=1e-5, atol=1e-6)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
SMOKE = dict(n_sparse=6, embed_dim=8, cin_layers=(16, 16), mlp_dims=(32,),
             vocab_sizes=(64,) * 6)
# the published widths with small vocabularies (the published tables hold
# 38,190,000 rows)
WIDE = dict(n_sparse=39, embed_dim=10, cin_layers=(200, 200, 200),
            mlp_dims=(400, 400), vocab_sizes=(97, 61) * 19 + (97,))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(widths, seed=0):
    ref_cfg = JR.XDeepFMConfig(name="x", **widths)
    params = JR.xdeepfm_init(jax.random.key(seed), ref_cfg)
    cfg = PR.XDeepFMConfig(name="x", **widths)
    return ref_cfg, params, cfg, xdeepfm_params_from_numpy(_numpy(params), "cpu")


def _ids(cfg, b, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, b) for v in cfg.field_vocabs()],
                    axis=1).astype(np.int32)


# -------------------------------------------------------------- embedding bag

@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(mode, weighted):
    """300 ids into 40 bags, unsorted, with bag ids past the end (the
    reference clamps them to a spill bag it cuts off) and negative ones
    (JAX's segment sum drops them): both dropped."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((97, 6)).astype(np.float32)
    idx = rng.integers(0, 97, 300).astype(np.int32)
    bags = rng.integers(-5, 45, 300).astype(np.int32)
    w = rng.standard_normal(300).astype(np.float32) if weighted else None
    want = JR.embedding_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bags),
                            40, weights=None if w is None else jnp.asarray(w),
                            mode=mode)
    got = PR.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(bags), 40,
                           weights=None if w is None else torch.from_numpy(w), mode=mode)
    assert got.dtype == torch.float32 and got.shape == (40, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG_TOL)
    # the sums written out
    rows = table[idx] * (1 if w is None else w[:, None])
    for b in (0, 7, 39):
        sel = bags == b
        expect = rows[sel].sum(0)
        if mode == "mean":
            expect = expect / max(sel.sum(), 1)
        np.testing.assert_allclose(got[b].numpy(), expect, rtol=1e-5, atol=1e-6)


def test_embedding_bag_reference_cases():
    """``tests/test_models.py``'s embedding-bag cases, and empty bags."""
    tab = np.random.default_rng(0).standard_normal((20, 4)).astype(np.float32)
    t = torch.from_numpy(tab)
    idx = torch.tensor([1, 2, 3, 7, 7], dtype=torch.int32)
    bags = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32)
    s = PR.embedding_bag(t, idx, bags, 3, mode="sum")
    m = PR.embedding_bag(t, idx, bags, 3, mode="mean")
    np.testing.assert_allclose(s[0].numpy(), tab[1] + tab[2], rtol=1e-6)
    np.testing.assert_allclose(m[1].numpy(), (tab[3] + 2 * tab[7]) / 3, rtol=1e-6)
    assert not s[2].any() and not m[2].any()
    out = PR.embedding_bag(t, idx[:2], bags[:2], 1,
                           weights=torch.tensor([2.0, 0.5]))
    np.testing.assert_allclose(out[0].numpy(), 2.0 * tab[1] + 0.5 * tab[2], rtol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        PR.embedding_bag(t, idx, bags, 3, mode="max")


# ------------------------------------------------------------------------ CIN

def test_cin_matches_reference_and_the_outer_product():
    rng = np.random.default_rng(3)
    b, m, d, layers = 5, 6, 4, (7, 5)
    x0 = rng.standard_normal((b, m, d)).astype(np.float32)
    ws, h_prev = [], m
    for h in layers:
        ws.append(rng.standard_normal((h, m, h_prev)).astype(np.float32))
        h_prev = h
    out_w = rng.standard_normal((sum(layers), 1)).astype(np.float32)
    want = JR._cin([jnp.asarray(w) for w in ws], {"w": jnp.asarray(out_w)},
                   jnp.asarray(x0))
    got = PR._cin([torch.from_numpy(w) for w in ws], {"w": torch.from_numpy(out_w)},
                  torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CIN_TOL)
    # explicit: x_{k+1}[b,h,d] = sum_ij w[h,i,j] x0[b,i,d] xk[b,j,d], float64
    xk, pooled = x0.astype(np.float64), []
    for w in ws:
        xk = np.einsum("hij,bid,bjd->bhd", w.astype(np.float64), x0.astype(np.float64), xk)
        pooled.append(xk.sum(-1))
    np.testing.assert_allclose(got.numpy(), np.concatenate(pooled, -1) @ out_w,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("widths", [SMOKE, WIDE], ids=["smoke", "published"])
def test_xdeepfm_apply_and_retrieval_match_reference(widths):
    ref_cfg, params, cfg, tp = _pair(widths)
    ids = _ids(cfg, 24)
    want = JR.xdeepfm_apply(params, ref_cfg, jnp.asarray(ids))
    got = PR.xdeepfm_apply(tp, cfg, torch.from_numpy(ids))
    assert got.shape == (24,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    # the lookups are the reference's take bit for bit
    rows = PR._lookup(tp["tables"], torch.from_numpy(ids))
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(r.numpy(), np.asarray(params["tables"][f"f{i}"])[ids[:, i]])
    cand = np.random.default_rng(4).standard_normal((300, cfg.embed_dim)).astype(np.float32)
    want = JR.retrieval_scores(params, ref_cfg, jnp.asarray(ids[:1]), jnp.asarray(cand))
    got = PR.retrieval_scores(tp, cfg, torch.from_numpy(ids[:1]), torch.from_numpy(cand))
    assert got.shape == (1, 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_bce_loss_matches_reference():
    rng = np.random.default_rng(5)
    logits = (4 * rng.standard_normal(257)).astype(np.float32)
    logits[:3] = (0.0, 40.0, -40.0)
    labels = rng.integers(0, 2, 257).astype(np.float32)
    want = JR.bce_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = PR.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("chunk", [3, 5])
def test_cin_chunks_equal_one_pass(chunk, monkeypatch):
    """serve_bulk's chunking: CIN rows are independent."""
    _, _, cfg, tp = _pair(SMOKE)
    ids = torch.from_numpy(_ids(cfg, 17, seed=6))
    whole = PR.xdeepfm_apply(tp, cfg, ids)
    monkeypatch.setattr(PR, "CIN_CHUNK", chunk)
    np.testing.assert_allclose(PR.xdeepfm_apply(tp, cfg, ids).numpy(),
                               whole.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("chunk", [5, 32])
def test_cin_recompute_bit_equal_to_keeping_its_products(chunk, monkeypatch):
    """Under autograd each CIN chunk runs under ``torch.utils.checkpoint``
    (its outer products recomputed in the backward); with the chunk smaller
    than the batch and not, the CIN logit and the gradients of its input
    and weights are the bits of the same chunks with nothing recomputed.
    Without grad no checkpoint runs."""
    _, _, cfg, tp = _pair(SMOKE)
    monkeypatch.setattr(PR, "CIN_CHUNK", chunk)
    rng = np.random.default_rng(9)
    x0 = torch.from_numpy(rng.standard_normal((23, cfg.n_sparse, cfg.embed_dim))
                          .astype(np.float32)).requires_grad_()
    weights = [*tp["cin"], tp["cin_out"]["w"]]
    for w in weights:
        w.requires_grad_(True)
    up = torch.from_numpy(rng.standard_normal((23, 1)).astype(np.float32))
    calls = []
    checkpoint = PR.checkpoint
    monkeypatch.setattr(PR, "checkpoint", lambda *a, **kw: calls.append(1) or
                        checkpoint(*a, **kw))
    got = PR._cin(tp["cin"], tp["cin_out"], x0)
    assert len(calls) == -(-23 // chunk)
    want = PR.linear(tp["cin_out"], torch.cat([
        PR._cin_rows(tp["cin"], x0[s:s + chunk]) for s in range(0, 23, chunk)]))
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(got, [x0, *weights], up),
                    torch.autograd.grad(want, [x0, *weights], up), strict=True):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(PR._cin(tp["cin"], tp["cin_out"], x0), want)
    monkeypatch.setattr(PR, "checkpoint", None)  # serving never reaches it
    with torch.no_grad():
        PR._cin(tp["cin"], tp["cin_out"], x0)


def test_params_carry_both_ways():
    _, params, _, tp = _pair(SMOKE)
    want = jax.tree_util.tree_leaves(_numpy(params))
    got = tree_flatten(xdeepfm_params_to_numpy(tp))[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_drawn_params_follow_the_reference_initialisers():
    cfg = PR.XDeepFMConfig(name="x", **{**WIDE, "vocab_sizes": (4000,) * 39})
    p = PR.xdeepfm_init(torch.Generator().manual_seed(0), cfg)
    ref = jax.eval_shape(lambda k: JR.xdeepfm_init(k, JR.XDeepFMConfig(
        name="x", **{**WIDE, "vocab_sizes": (4000,) * 39})), jax.random.key(0))
    shapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(ref)]
    assert [tuple(x.shape) for x in tree_flatten(p)[0]] == shapes
    np.testing.assert_allclose(p["tables"]["f3"].std().item(), 0.01, rtol=0.05)
    np.testing.assert_allclose(p["cin"][1].std().item(), (2 / (39 * 200)) ** 0.5,
                               rtol=0.05)
    assert p["bias"].item() == 0


# --------------------------------------------------------------- the config

def test_config_matches_reference():
    assert xdeepfm.ARCH_ID == jax_xdeepfm.ARCH_ID
    assert xdeepfm.SHAPES == jax_xdeepfm.SHAPES
    ref = jax_xdeepfm.CFG
    assert {f.name: getattr(xdeepfm.CFG, f.name) for f in dataclasses.fields(ref)
            if f.name != "dtype"} == {f.name: getattr(ref, f.name)
                                      for f in dataclasses.fields(ref) if f.name != "dtype"}
    assert xdeepfm.CFG.field_vocabs() == ref.field_vocabs()
    assert sum(xdeepfm.CFG.field_vocabs()) == 38_190_000
    for f in ("lr", "schedule", "total_steps", "weight_decay"):
        assert getattr(xdeepfm.OPT, f) == getattr(jax_xdeepfm.OPT, f)


def test_serve_fns_match_reference(monkeypatch):
    """Each serve shape's step at the published widths (small
    vocabularies), against the reference's ``build_cell`` step bodies."""
    ref_cfg, params, cfg, tp = _pair(WIDE)
    monkeypatch.setattr(xdeepfm, "CFG", cfg)
    ids = _ids(cfg, 40, seed=7)
    want = jax.nn.sigmoid(JR.xdeepfm_apply(params, ref_cfg, jnp.asarray(ids)))
    for shape in ("serve_p99", "serve_bulk"):
        got = xdeepfm.serve_fn(shape)(tp, torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    cand = np.random.default_rng(8).standard_normal((64, 10)).astype(np.float32)
    want = JR.retrieval_scores(params, ref_cfg, jnp.asarray(ids[:1]), jnp.asarray(cand))
    got = xdeepfm.serve_fn("retrieval_cand")(tp, torch.from_numpy(ids[:1]),
                                             torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    with pytest.raises(ValueError, match="serve"):
        xdeepfm.serve_fn("train_batch")


def test_smoke_on_the_cpu():
    out = xdeepfm.smoke("cpu")
    assert np.isfinite(out["loss"]) and out == xdeepfm.smoke("cpu")


@pytest.mark.parametrize("seed,start,shard", [(0, 0, 0), (3, 17, 2), (11, 5, 1)])
def test_recsys_batches_bit_equal(seed, start, shard):
    vocabs = jax_xdeepfm.CFG.field_vocabs()
    want = jax_recsys_batches(64, 39, vocabs, seed=seed, shard_id=shard,
                              start_step=start)
    got = recsys_batches(64, 39, vocabs, seed=seed, shard_id=shard, start_step=start)
    for _ in range(3):
        a, b = next(got), next(want)
        assert set(a) == set(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(a[k], b[k])
