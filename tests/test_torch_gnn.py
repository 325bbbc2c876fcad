"""The port's GNNs (``repro_torch.models.gnn``, ``configs/{common_gnn,
schnet,pna,egnn,graphsage_reddit}``, ``data/sampler``) against the
reference's, on the CPU: the same numpy-seeded graphs (padding edges at
capacity, ``graph_ids`` where the arch pools) and the reference's weights
carried across by ``convert``.

Tolerances, float32 throughout:

* outputs: each element within ``1e-5 |want| + 1e-5 max|want|``;
* gradients, each leaf within ``1e-5 |want| + GRAD_TOL[arch] * max|want|``
  of the reference's (``jax.value_and_grad``).  The two frameworks sum the
  edges, the matrix products and the gradient contributions in other
  orders (about 1e-7 relative a sum).  PNA's std aggregator amplifies that:
  its backward takes the small difference ``2 (m - mean)`` of large terms
  and scales it by ``1 / (2 sqrt(var + 1e-5))``, up to 158.  Against the
  reference run in float64, at the molecule width and one layer, the
  reference's own float32 gradient of ``pre.l0.w`` is 2.4e-4 of the leaf's
  largest element away, the port's 1.0e-4 (and the port in float64 5e-8):
  hence 1e-3 for PNA and 5e-5 for the others, whose worst measured was 1e-5
  (SchNet).

The kernels' backwards (``SegmentSum``, ``SegmentMax``) are held to plain
autograd bit for bit (``torch.equal``) through their CPU-testable halves.
"""
import dataclasses as dc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import SINGLE_POD
from repro.data import sampler as ref_sampler
from repro.models import gnn as RG
from repro.models import layers as ref_layers
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro_torch.configs import common_gnn as PC
from repro_torch.convert import (gnn_params_from_numpy, gnn_params_to_numpy,
                                 train_state_from_numpy, train_state_to_numpy)
from repro_torch.data import sampler as port_sampler
from repro_torch.kernels import ops, ref
from repro_torch.kernels.segment_matmul import segment_sum_backward
from repro_torch.kernels.segreduce import flat_segment_ids, segment_max_backward
from repro_torch.models import gnn as PG
from repro_torch.models import layers as port_layers
from repro_torch.train.checkpoint import tree_flatten, tree_unflatten

GRAD_TOL = {"graphsage": 5e-5, "graphsage-max": 5e-5, "pna": 1e-3,
            "schnet": 5e-5, "egnn": 5e-5}
CONFIGS = ("schnet", "pna", "egnn", "graphsage_reddit")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, scale_tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bound = rtol * np.abs(want) + scale_tol * max(np.abs(want).max(initial=0), 1e-30)
    excess = np.abs(got - want) - bound
    assert (excess <= 0).all(), (f"{what}: max |diff| {np.abs(got - want).max()} "
                                 f"beyond the tolerance by {excess.max()}")


def _graph(rng, n=40, e=160, d=8, pad_nodes=8, pad_edges=32, geometric=False,
           batched=False, atom=False):
    """A graph of ``n - pad_nodes`` real nodes and ``e`` real edges, padded
    with ``pad_edges`` edges at the capacity ``n``; batched: two graphs,
    the padding nodes' graph id 2 (dropped by the pooling)."""
    real = n - pad_nodes
    nodes = (rng.integers(1, 9, (n, 1)).astype(np.int32) if atom
             else rng.standard_normal((n, d)).astype(np.float32))
    pad = np.full(pad_edges, n)
    return dict(
        nodes=nodes,
        senders=np.concatenate([rng.integers(0, real, e), pad]).astype(np.int32),
        receivers=np.concatenate([rng.integers(0, real, e), pad]).astype(np.int32),
        positions=rng.standard_normal((n, 3)).astype(np.float32) if geometric else None,
        graph_ids=(np.minimum(np.arange(n) * 2 // real, 2).astype(np.int32)
                   if batched else None),
        n_graphs=2 if batched else 1)


def _ref_graph(g):
    return RG.Graph(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                       for k, v in g.items()})


def _port_graph(g):
    return PG.Graph(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                       for k, v in g.items()})


def _port_params(tree):
    """The reference's parameters as the port's tree, every leaf requiring
    grad; returns (tree, leaves)."""
    params = gnn_params_from_numpy(_np_tree(tree), "cpu")
    leaves = tree_flatten(params)[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    return params, leaves


def _first(out):
    return out[0] if isinstance(out, tuple) else out


ARCHS = {
    "graphsage": (dict(d_in=8, n_classes=3, d_hidden=16), "graphsage", {}),
    "graphsage-max": (dict(d_in=8, n_classes=3, d_hidden=16, aggregator="max"),
                      "graphsage", {}),
    "pna": (dict(n_layers=2, d_hidden=16, d_in=8), "pna", dict(batched=True)),
    "schnet": (dict(n_interactions=2, d_hidden=16, n_rbf=20), "schnet",
               dict(geometric=True, batched=True, atom=True)),
    "egnn": (dict(d_in=8, n_layers=2, d_hidden=16), "egnn",
             dict(geometric=True, batched=True)),
}
_CFG = {"graphsage": "GraphSAGEConfig", "pna": "PNAConfig",
        "schnet": "SchNetConfig", "egnn": "EGNNConfig"}


def _arch(name):
    kw, fam, graph_kw = ARCHS[name]
    rcfg = getattr(RG, _CFG[fam])(**kw)
    pcfg = getattr(PG, _CFG[fam])(**kw)
    return (rcfg, pcfg, getattr(RG, f"{fam}_init"), getattr(RG, f"{fam}_apply"),
            getattr(PG, f"{fam}_apply"), graph_kw)


# --------------------------------------------------------------- layers


def test_layernorm_and_mlp_match_the_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((33, 24)) * 3 + 1).astype(np.float32)
    p = {"g": rng.standard_normal(24).astype(np.float32),
         "b": rng.standard_normal(24).astype(np.float32)}
    want = np.asarray(ref_layers.layernorm(_np_tree(p), jnp.asarray(x)))
    got = port_layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the population variance (jnp.var), not torch.var's default
    x64 = x.astype(np.float64)
    pop = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(x64.var(-1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(got, pop * p["g"] + p["b"], rtol=1e-5, atol=1e-5)
    init = port_layers.layernorm_init(5)
    assert torch.equal(init["g"], torch.ones(5)) and torch.equal(init["b"], torch.zeros(5))

    mp = _np_tree(ref_layers.mlp_init(jax.random.key(1), [24, 16, 4]))
    for final_act in (False, True):
        want = np.asarray(ref_layers.mlp(mp, jnp.asarray(x), final_act=final_act))
        got = port_layers.mlp(gnn_params_from_numpy(mp, "cpu"), torch.from_numpy(x),
                              final_act=final_act).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    tree = port_layers.mlp_init(gen, [24, 16, 4])
    assert {k: {n: tuple(v.shape) for n, v in l.items()} for k, l in tree.items()} == {
        k: {n: v.shape for n, v in l.items()} for k, l in mp.items()}
    assert set(port_layers.linear_init(gen, 3, 2)) == {"w"}
    assert torch.equal(port_layers.linear_init(gen, 3, 2, bias=True)["b"], torch.zeros(2))


@pytest.mark.parametrize("n_rbf,cutoff", [(300, 10.0), (20, 10.0), (64, 5.0), (2, 3.0),
                                          (1, 10.0)])
def test_rbf_centres_bit_equal_to_jnp_linspace(n_rbf, cutoff):
    want = np.asarray(jnp.linspace(0.0, cutoff, n_rbf, dtype=jnp.float32))
    got = PG.rbf_centres(PG.SchNetConfig(n_rbf=n_rbf, cutoff=cutoff), "cpu").numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)
    if n_rbf == 300:  # torch.linspace rounds otherwise
        assert (torch.linspace(0.0, cutoff, n_rbf).numpy() != want).sum() > 0


# --------------------------------------------------------- segment ops


def _seg_inputs(rng, n=300, d=5, segs=40, ties=True):
    x = rng.integers(-4, 5, (n, d)).astype(np.float32) if ties else \
        rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(-3, segs + 3, n).astype(np.int32)  # out of range: dropped
    ids[:40] = 7  # a crowded segment: ties among small integers
    return x, ids


@pytest.mark.parametrize("op", ["max", "min"])
def test_feature_wise_max_min_bit_equal_to_jax(op):
    rng = np.random.default_rng(1)
    x, ids = _seg_inputs(rng)
    segs = 40
    rfn, pfn = getattr(RG, f"segment_{op}"), getattr(PG, f"segment_{op}")
    ids_j = jnp.asarray(np.maximum(ids, 0) + (ids < 0) * (segs + 5))  # no negatives for JAX
    want = np.asarray(rfn(jnp.asarray(x), ids_j, segs))
    xt = torch.from_numpy(x).requires_grad_()
    got = pfn(xt, torch.from_numpy(ids), segs)
    dropped = torch.from_numpy((ids < 0) | (ids >= segs))
    assert np.array_equal(got.detach().numpy(), want)  # empty segments 0
    # the tie-split gradients: JAX multiplies by 1/N where torch divides by
    # N, one rounding apart
    up = rng.standard_normal(want.shape).astype(np.float32)
    gj = np.asarray(jax.grad(lambda v: jnp.sum(rfn(v, ids_j, segs) * up))(jnp.asarray(x)))
    gt = torch.autograd.grad(torch.sum(got * torch.from_numpy(up)), xt)[0].numpy()
    np.testing.assert_allclose(gt, gj, rtol=2.0 ** -23, atol=0)
    assert (gt[dropped.numpy()] == 0).all()
    assert (np.abs(gt).sum(0) > 0).all()


def test_flattened_ids_give_the_feature_wise_max_bit_equal():
    rng = np.random.default_rng(2)
    x, ids = _seg_inputs(rng, ties=False)
    xt, it = torch.from_numpy(x), torch.from_numpy(ids)
    flat = flat_segment_ids(it, 40, 5)
    assert flat.dtype == torch.int32 and flat.shape == (300 * 5,)
    got = ref.ref_segment_max(xt.reshape(-1), flat, 40 * 5).view(40, 5)
    assert torch.equal(got, ref.ref_segment_max_features(xt, it, 40))
    assert torch.equal(ops.segment_reduce(xt, it, 40, op="max"), got)


@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("segs", [1, 40, 400])
def test_segment_max_backward_bit_equal_to_plain_autograd(ties, segs):
    rng = np.random.default_rng(segs)
    x, ids = _seg_inputs(rng, segs=segs, ties=ties)
    xt, it = torch.from_numpy(x).requires_grad_(), torch.from_numpy(ids)
    out = ref.ref_segment_max_features(xt, it, segs)
    up = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    want = torch.autograd.grad(out, xt, up)[0]
    got = segment_max_backward(up, xt.detach(), it, out.detach())
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("segs", [1, 40, 400])
def test_segment_sum_backward_bit_equal_to_plain_autograd(segs):
    rng = np.random.default_rng(segs)
    x, ids = _seg_inputs(rng, segs=segs, ties=False)
    xt, it = torch.from_numpy(x).requires_grad_(), torch.from_numpy(ids)
    out = ref.ref_segment_matmul(xt, it, segs)
    up = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    want = torch.autograd.grad(out, xt, up)[0]
    got = segment_sum_backward(up, it, segs)
    assert torch.equal(got, want)
    assert bool((got[(it < 0) | (it >= segs)] == 0).all())


def test_segment_reduce_ops_and_refusals():
    x = torch.randn(6, 3)
    ids = torch.tensor([0, 1, 1, 9, -1, 2], dtype=torch.int32)
    full = ops.segment_reduce(x, ids, 4, op="max")
    assert full.dtype == torch.float32 and bool(torch.isinf(full[3]).all())
    with pytest.raises(ValueError, match="unknown segment-reduce op"):
        ops.segment_reduce(x, ids, 4, op="min")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.segment_reduce(x, ids, 4, op="max", backend="cuda")


# ------------------------------------------------------------ the models


@pytest.mark.parametrize("arch", list(ARCHS))
def test_apply_and_gradients_match_the_reference(arch):
    rcfg, pcfg, init, rapply, papply, graph_kw = _arch(arch)
    rng = np.random.default_rng(3)
    g = _graph(rng, **graph_kw)
    params = init(jax.random.key(0), rcfg)
    want = _first(rapply(params, rcfg, _ref_graph(g)))
    up = rng.standard_normal(want.shape).astype(np.float32)
    gj = jax.grad(lambda p: jnp.sum(_first(rapply(p, rcfg, _ref_graph(g))) * up))(params)
    tparams, leaves = _port_params(params)
    got = _first(papply(tparams, pcfg, _port_graph(g), backend="torch"))
    _close(got.detach().numpy(), want, 1e-5, 1e-5, f"{arch} output")
    gt = torch.autograd.grad(torch.sum(got * torch.from_numpy(up)), leaves,
                             allow_unused=True, materialize_grads=True)
    want_leaves = tree_flatten(_np_tree(gj))[0]
    assert len(want_leaves) == len(gt)
    for i, (a, b) in enumerate(zip(gt, want_leaves)):
        _close(a.numpy(), b, 1e-5, GRAD_TOL[arch], f"{arch} gradient leaf {i}")


def test_egnn_positions_match_the_reference():
    rcfg, pcfg, init, rapply, papply, graph_kw = _arch("egnn")
    g = _graph(np.random.default_rng(4), **graph_kw)
    params = init(jax.random.key(0), rcfg)
    _, want = rapply(params, rcfg, _ref_graph(g))
    _, got = papply(gnn_params_from_numpy(_np_tree(params), "cpu"), pcfg, _port_graph(g))
    _close(got.numpy(), want, 1e-5, 1e-5, "egnn positions")


def test_init_trees_have_the_reference_structure():
    gen = torch.Generator().manual_seed(0)
    for fam, kw in (("graphsage", {}), ("pna", {}), ("schnet", {}), ("egnn", {})):
        rcfg, pcfg = getattr(RG, _CFG[fam])(**kw), getattr(PG, _CFG[fam])(**kw)
        want = _np_tree(getattr(RG, f"{fam}_init")(jax.random.key(0), rcfg))
        got = getattr(PG, f"{fam}_init")(gen, pcfg)
        (wl, wd), (gl, gd) = tree_flatten(want), tree_flatten(got)
        assert str(wd) == str(gd), fam
        assert [w.shape for w in wl] == [tuple(x.shape) for x in gl], fam
        assert all(x.dtype == torch.float32 and x.device.type == "cpu" for x in gl)
    assert PG.__all__ == RG.__all__


# reference invariances (tests/test_models.py), on the port


def test_port_egnn_equivariance():
    rng = np.random.default_rng(5)
    cfg = PG.EGNNConfig(d_in=8, n_layers=2, d_hidden=16)
    p = PG.egnn_init(torch.Generator().manual_seed(0), cfg)
    g = _port_graph(_graph(rng, geometric=True, batched=True))
    out, x = PG.egnn_apply(p, cfg, g)
    rot = torch.from_numpy(np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32))
    t = torch.tensor([0.5, -1.0, 2.0])
    out2, x2 = PG.egnn_apply(p, cfg, dc.replace(g, positions=g.positions @ rot.T + t))
    torch.testing.assert_close(out2, out, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(x2, x @ rot.T + t, rtol=1e-3, atol=1e-3)


def test_port_schnet_translation_invariance():
    cfg = PG.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=16)
    p = PG.schnet_init(torch.Generator().manual_seed(0), cfg)
    g = _port_graph(_graph(np.random.default_rng(6), geometric=True, batched=True,
                           atom=True))
    e1 = PG.schnet_apply(p, cfg, g)
    e2 = PG.schnet_apply(p, cfg, dc.replace(g, positions=g.positions + 5.0))
    torch.testing.assert_close(e1, e2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_port_padding_edges_are_inert(arch):
    """Edges pointing at the node-capacity sentinel change no output, and
    no gradient (the gathers clamp them onto the last node)."""
    rcfg, pcfg, init, _, papply, graph_kw = _arch(arch)
    g = _graph(np.random.default_rng(7), pad_edges=0, **graph_kw)
    padded = dict(g, senders=np.concatenate([g["senders"], np.full(32, 40, np.int32)]),
                  receivers=np.concatenate([g["receivers"], np.full(32, 40, np.int32)]))
    params, leaves = _port_params(init(jax.random.key(0), rcfg))
    outs, grads = [], []
    for graph in (g, padded):
        out = _first(papply(params, pcfg, _port_graph(graph)))
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out.sum(), leaves, allow_unused=True,
                                         materialize_grads=True))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


# --------------------------------------------------- the training step


def _molecule(rng, info, atom):
    """The molecule shape: 128 graphs of 30 nodes and 64 edges (8,192 edges,
    the edge capacity), the node capacity's 256 padding rows zero, their
    graph id 128 (dropped by the pooling)."""
    n, graphs, per_n, per_e = info["n_nodes"], info["n_graphs"], 30, 64
    base = np.repeat(np.arange(graphs) * per_n, per_e)
    nodes = (rng.integers(1, 10, (n, 1)).astype(np.int32) if atom
             else rng.standard_normal((n, info["d_feat"])).astype(np.float32))
    nodes[graphs * per_n:] = 0
    return dict(nodes=nodes,
                senders=(base + rng.integers(0, per_n, base.size)).astype(np.int32),
                receivers=(base + rng.integers(0, per_n, base.size)).astype(np.int32),
                positions=rng.standard_normal((n, 3)).astype(np.float32),
                graph_ids=np.minimum(np.arange(n) // per_n, graphs).astype(np.int32),
                n_graphs=graphs)


_ARCH_OF = {"schnet": "schnet", "pna": "pna", "egnn": "egnn",
            "graphsage_reddit": "graphsage"}


@pytest.mark.parametrize("config", CONFIGS)
def test_one_train_step_at_the_molecule_shape_matches_the_reference(config):
    """One step of the reference's own cell (``build_cell("molecule",
    SINGLE_POD).step_fn``, jitted, at the published widths) and of the
    port's, from the same weights, graph and batch: the loss, AdamW's
    moments within the gradient tolerance (m is 0.1 g, v 0.001 g^2 after
    clipping), the step, and the parameters.  A parameter moves by the
    first step's lr (1e-5) times m/(sqrt(v) + eps), about sign(g): it
    matches within 1e-7 where the reference's gradient is clear of the
    tolerance, and within 2 lr elsewhere (a gradient within rounding of 0
    may take either sign)."""
    fam = _ARCH_OF[config]
    rmod = importlib.import_module(f"repro.configs.{config}")
    pspec = importlib.import_module(f"repro_torch.configs.{config}").SPEC
    info = PC.GNN_SHAPES["molecule"]
    rng = np.random.default_rng(8)
    g = _molecule(rng, info, atom=fam == "schnet")
    if fam not in ("schnet", "egnn"):
        g["positions"] = None
    params = _np_tree(getattr(RG, f"{fam}_init")(jax.random.key(0), rmod.make_cfg(info)))
    opt = _np_tree(ref_adamw_init(params))
    if pspec.loss_kind == "node_class":
        seeds = np.arange(info["n_nodes"], dtype=np.int32)
        batch = (seeds, np.zeros(info["n_nodes"], np.int32))
    else:
        batch = (rng.standard_normal((info["n_graphs"], 1)).astype(np.float32),)
    step = jax.jit(rmod.SPEC.build_cell("molecule", SINGLE_POD).step_fn)
    p2, o2, m2 = step(params, opt, _ref_graph(g), *map(jnp.asarray, batch))
    want = _np_tree({"params": p2, "opt": o2})

    _, state = train_state_from_numpy({"params": params, "opt": opt}, None, "cpu")
    _, _, mt = pspec.step_fn("molecule", backend="torch")(
        state.params, state.opt, _port_graph(g), *map(torch.from_numpy, batch))
    got = train_state_to_numpy(state)
    assert set(mt) == set(m2)
    np.testing.assert_allclose(float(mt["loss"]), float(m2["loss"]), rtol=1e-6)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    tol = GRAD_TOL[fam]
    lr = PC.GNN_OPT.lr / PC.GNN_OPT.warmup_steps
    leaves = lambda t: {"m": tree_flatten(t["opt"]["m"])[0],  # noqa: E731
                        "v": tree_flatten(t["opt"]["v"])[0],
                        "p": tree_flatten(t["params"])[0]}
    gl, wl = leaves(got), leaves(want)
    for i in range(len(wl["p"])):
        _close(gl["m"][i], wl["m"][i], 1e-5, tol, f"{config} m leaf {i}")
        _close(gl["v"][i], wl["v"][i], 1e-5, 2 * tol, f"{config} v leaf {i}")
        gp, wp, wm = gl["p"][i], wl["p"][i], wl["m"][i]
        clear = np.abs(wm) > 2 * tol * np.abs(wm).max(initial=0)
        np.testing.assert_allclose(gp[clear], wp[clear], rtol=1e-6, atol=1e-7,
                                   err_msg=f"{config} params leaf {i}")
        assert (np.abs(gp - wp) <= 2 * lr * 1.001).all(), f"{config} params {i}"


def test_gnn_train_step_metrics_and_unused_parameters():
    """EGNN's last coordinate MLP reaches only the positions, which the loss
    does not read: its gradient is zero, as JAX's, and the step runs."""
    spec = importlib.import_module("repro_torch.configs.egnn").SPEC
    cfg = PG.EGNNConfig(d_in=8, n_layers=2, d_hidden=16)
    state = PC.init_train_state(PG.egnn_init(torch.Generator().manual_seed(0), cfg))
    step = PC.gnn_train_step(spec.apply_fn, cfg, "graph_reg", backend="torch")
    g = _port_graph(_graph(np.random.default_rng(9), geometric=True, batched=True))
    before = state.params["layers"][1]["coord"]["l0"]["w"].detach().clone()
    losses = []
    for _ in range(3):
        _, _, m = step(state.params, state.opt, g, torch.ones(2, 1))
        losses.append(float(m["loss"]))
    assert set(m) == {"loss", "lr", "grad_norm"} and int(state.opt["step"]) == 3
    assert torch.equal(state.params["layers"][1]["coord"]["l0"]["w"], before)
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="unknown loss kind"):
        PC.gnn_train_step(spec.apply_fn, cfg, "ranking")


def test_node_class_loss_and_accuracy():
    logits = torch.tensor([[2.0, 0.0], [0.0, 1.0], [5.0, 5.5]])
    loss, m = PC.node_class_loss(logits, torch.tensor([0, 2], dtype=torch.int32),
                                 torch.tensor([0, 0], dtype=torch.int32))
    want = -(torch.log_softmax(logits[[0, 2]], -1)[:, 0]).mean()
    torch.testing.assert_close(loss, want)
    assert float(m["acc"]) == 0.5


# --------------------------------------------------------- configs, data


def test_shapes_and_published_widths_match_the_reference():
    from repro.configs.common_gnn import GNN_SHAPES

    assert PC.GNN_SHAPES == GNN_SHAPES
    for config in CONFIGS:
        rmod = importlib.import_module(f"repro.configs.{config}")
        pmod = importlib.import_module(f"repro_torch.configs.{config}")
        assert pmod.ARCH_ID == rmod.ARCH_ID
        assert pmod.SPEC.loss_kind == {"graphsage_reddit": "node_class"}.get(
            config, "graph_reg")
        for shape, info in GNN_SHAPES.items():
            want = dc.asdict(rmod.make_cfg(info))
            got = dc.asdict(pmod.make_cfg(info))
            assert {k: v for k, v in got.items() if k != "dtype"} == {
                k: v for k, v in want.items() if k != "dtype"}, (config, shape)
            assert got["dtype"] == torch.float32
    assert PC.GNN_OPT.lr == 1e-3 and PC.GNN_OPT.total_steps == 5000
    assert PC.GNN_OPT.weight_decay == 0.0 and PC.GNN_OPT.schedule == "cosine"


@pytest.mark.parametrize("config", CONFIGS)
def test_config_smoke_runs_on_the_cpu(config):
    out = importlib.import_module(f"repro_torch.configs.{config}").smoke("cpu")
    want = importlib.import_module(f"repro.configs.{config}").smoke()
    assert out == want


@pytest.mark.parametrize("seeds,fanouts,seed", [(16, (5, 3), 1), (1024, (15, 10), 0),
                                                (64, (4, 4, 2), 7)])
def test_sampler_bit_equal_to_the_reference(seeds, fanouts, seed):
    rng = np.random.default_rng(seed)
    n, e = 3000, 30000
    s = rng.integers(0, n, e).astype(np.int64)
    r = rng.integers(50, n, e).astype(np.int64)  # 50 isolated: self-loops
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    labels = rng.integers(0, 41, n)
    want_csr = ref_sampler.build_csr(s, r, n)
    got_csr = port_sampler.build_csr(s, r, n)
    for k in ("indptr", "indices"):
        a, b = getattr(got_csr, k), getattr(want_csr, k)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got_csr.n_nodes == want_csr.n_nodes
    seed_ids = rng.choice(n, seeds, replace=False)
    want = ref_sampler.sample_subgraph(want_csr, seed_ids, fanouts, feats, labels, seed)
    got = port_sampler.sample_subgraph(got_csr, seed_ids, fanouts, feats, labels, seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    if fanouts == (15, 10):  # minibatch_lg's static shape
        assert got["nodes"].shape[0] == 169_984 and got["senders"].shape == (168_960,)


def test_sampler_shares_the_reference_fault_at_an_isolated_last_node():
    """A sampled node without in-edges whose CSR row starts at the edge
    count (the last node) indexes past ``indices`` before the self-loop
    fallback masks it: the reference raises, and so does its copy."""
    s, r = np.array([1, 2, 0]), np.array([0, 0, 1])
    feats, labels = np.zeros((3, 2), np.float32), np.zeros(3, np.int64)
    for mod in (ref_sampler, port_sampler):
        csr = mod.build_csr(s, r, 3)
        with pytest.raises(IndexError):
            mod.sample_subgraph(csr, np.array([2]), [2], feats, labels, 0)
        assert mod.sample_subgraph(csr, np.array([0]), [2], feats, labels, 0)[
            "senders"].shape == (2,)


def test_gnn_state_crosses_both_ways():
    params = _np_tree(RG.pna_init(jax.random.key(0), RG.PNAConfig(n_layers=1, d_hidden=8,
                                                                  d_in=4)))
    opt = _np_tree(ref_adamw_init(params))
    opt["m"] = jax.tree.map(lambda a: a + 0.5, opt["m"])
    tree = {"params": params, "opt": opt}
    model, state = train_state_from_numpy(tree, None, "cpu")
    assert model is None
    assert all(x.requires_grad for x in tree_flatten(state.params)[0])
    assert state.opt["step"].dtype == torch.int32
    back = train_state_to_numpy(state)
    (bl, bd), (tl, td) = tree_flatten(back), tree_flatten(tree)
    assert str(bd) == str(td)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(bl, tl))
    again = gnn_params_to_numpy(gnn_params_from_numpy(params, "cpu"))
    assert all(np.array_equal(a, b) for a, b in zip(tree_flatten(again)[0],
                                                    tree_flatten(params)[0]))
    ts = tree_unflatten(td, tl)
    assert ts["params"]["encode"]["w"].shape == (4, 8)
