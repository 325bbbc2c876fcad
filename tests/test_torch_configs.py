"""The port's arch registry (``repro_torch.configs``: ``ArchSpec``,
``Cell``, ``get_spec``, each arch's ``SPEC``) against the reference's, on the
CPU.

* Every assigned arch, every shape, both meshes: ``build_cell`` is None
  exactly where the reference's is; ``kind``, ``donate`` and ``note`` are
  equal; each abstract argument's leaves (meta tensors; an LM model's
  parameter tree) have the reference's ``ShapeDtypeStruct`` shapes and
  types in ``jax.tree_util``'s order, and each partition spec is
  ``tuple(PartitionSpec)`` of the reference's, leaf by leaf.
* The registry: ``ASSIGNED_ARCHS``, ``get_spec``, ``all_specs``, the
  unknown arch's ``KeyError`` and ``network-sensing`` refused until the
  distribution item; every arch's ``smoke(device="cpu")``.
* Steps of the cells against ``jax.jit`` of the reference's own cells,
  which run on the CPU only under a mesh (the LM cells' activation
  constraint): a 1 x 1 mesh of ``AxisType.Auto`` axes, ``jax.set_mesh``.
  Same weights (the reference's, carried across by ``convert``), same
  numpy-seeded batches, float32, the reference on its ``"xla"`` path:

  - two train steps of mixtral's and arctic's smoke configs, global and
    batched dispatch, and of xDeepFM's ``train_batch`` cell (the
    reference's ``CFG`` patched to the smoke widths on both sides): the
    losses within 1e-6 relative (1e-5 for xDeepFM, whose CIN sums its
    products in another order), ``moe_aux_loss`` within 1e-6 relative,
    ``moe_dropped`` equal, ``lr`` equal, ``grad_norm`` within 1e-5
    relative; AdamW's moments ``m`` within ``GRAD_TOL`` of their leaf's
    largest element and ``v`` within twice that, the step equal; each
    parameter within 1e-6 relative (1e-7 absolute) where the reference's
    ``m`` is clear of the tolerance, and everywhere within twice the
    learning rates' sum (a gradient within rounding of 0 may take either
    sign, and AdamW moves a weight by about lr sign(m)).  ``GRAD_TOL`` is
    ``test_torch_moe.py``'s 1e-5 for the decoders and 1e-4 for xDeepFM;
  - a prefill and two decode steps of the prefill and decode cells
    (mixtral, arctic, qwen2 smoke configs): logits and the cache within
    ``test_torch_models.py``'s 2e-4.
* Each GNN's ``build_cell("molecule").step_fn`` bit-equal to its
  ``GNNSpec.step_fn`` at the molecule shape and published widths.
"""
import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from jax.sharding import PartitionSpec as P

import repro.configs as RC
from repro.configs import common as ref_common
from repro.configs import xdeepfm as jax_xdeepfm
from repro.models import recsys as JR
from repro.models import transformer as T
from repro.train.optimizer import adamw_init as ref_adamw_init
import repro_torch.configs as PCfg
from repro_torch.configs import SINGLE_POD, MULTI_POD, common, common_gnn, xdeepfm
from repro_torch.convert import (gnn_params_from_numpy, gnn_params_to_numpy,
                                 transformer_param_tree,
                                 transformer_params_from_numpy)
from repro_torch.models import gnn as PG
from repro_torch.models import recsys as PR
from repro_torch.train import adamw_init, tree_flatten

LOSS_RTOL = {"lm": 1e-6, "xdeepfm": 1e-5}
GRAD_TOL = {"lm": 1e-5, "xdeepfm": 1e-4}
AUX_RTOL = 1e-6
NORM_RTOL = 1e-5
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
MESHES = {"single_pod": (SINGLE_POD, ref_common.SINGLE_POD),
          "multi_pod": (MULTI_POD, ref_common.MULTI_POD)}
CELLS = [(arch, shape) for arch in RC.ASSIGNED_ARCHS
         for shape in RC.get_spec(arch).shapes]


@contextlib.contextmanager
def _ref_mesh():
    """A 1 x 1 mesh of Auto axes, under which the reference's cells run on
    the CPU."""
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


# ------------------------------------------------------------ the registry

def test_registry_matches_the_reference():
    assert PCfg.ASSIGNED_ARCHS == RC.ASSIGNED_ARCHS
    assert set(RC.ALL_ARCHS) - set(PCfg.ALL_ARCHS) == {"network-sensing"}
    specs = PCfg.all_specs()
    assert tuple(specs) == PCfg.ALL_ARCHS
    for arch, spec in specs.items():
        ref = RC.get_spec(arch)
        assert isinstance(spec, common.ArchSpec)
        assert (spec.arch, spec.family, spec.shapes, spec.meta) == (
            ref.arch, ref.family, ref.shapes, ref.meta)
        assert PCfg.get_spec(arch) is spec
    for cls in ("MeshAxes", "Cell", "ArchSpec"):
        assert [f.name for f in dataclasses.fields(getattr(common, cls))] == [
            f.name for f in dataclasses.fields(getattr(ref_common, cls))]
    for mp, ref_mp in MESHES.values():
        assert (mp.dp_axes, mp.tp_axis, mp.multi_pod, mp.all_axes, mp.dp, mp.fsdp) == (
            ref_mp.dp_axes, ref_mp.tp_axis, ref_mp.multi_pod, ref_mp.all_axes,
            ref_mp.dp, ref_mp.fsdp)
    assert common.AXIS_SIZES == ref_common.AXIS_SIZES


def test_unknown_and_unported_archs_are_refused():
    with pytest.raises(KeyError, match="unknown arch"):
        PCfg.get_spec("gpt-5")
    with pytest.raises(KeyError):
        RC.get_spec("gpt-5")
    assert "network-sensing" in RC.ALL_ARCHS
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        PCfg.get_spec("network-sensing")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_matches_the_reference(arch, shape, mesh):
    """Skips, kind, donate and note; every abstract leaf's shape and type and
    every partition spec, leaf by leaf in ``jax.tree_util``'s order."""
    mp, ref_mp = MESHES[mesh]
    want = RC.get_spec(arch).build_cell(shape, ref_mp)
    got = PCfg.get_spec(arch).build_cell(shape, mp)
    if want is None:
        assert got is None
        return
    assert (got.arch, got.shape, got.kind, got.donate, got.note) == (
        want.arch, want.shape, want.kind, want.donate, want.note)
    assert len(got.abstract_args) == len(want.abstract_args) == len(got.arg_pspecs)
    for i, (arg, specs, ref_arg, ref_specs) in enumerate(zip(
            got.abstract_args, got.arg_pspecs, want.abstract_args, want.arg_pspecs)):
        leaves = tree_flatten(common.arg_tree(arg))[0]
        ref_leaves = jax.tree_util.tree_leaves(ref_arg)
        assert [(tuple(x.shape), _dtype(x)) for x in leaves] == [
            (tuple(x.shape), _dtype(x)) for x in ref_leaves], f"argument {i}"
        assert all(x.device.type == "meta" for x in leaves)
        ref_spec_leaves = jax.tree_util.tree_leaves(
            ref_specs, is_leaf=lambda x: isinstance(x, P))
        assert common.spec_leaves(specs, arg) == [tuple(p) for p in ref_spec_leaves], (
            f"argument {i}")


@pytest.mark.parametrize("arch", RC.ASSIGNED_ARCHS)
def test_smoke_on_the_cpu(arch):
    """The counterpart of ``tests/test_arch_smoke.py``: each arch's reduced
    config runs for real, here on the CPU."""
    out = PCfg.get_spec(arch).smoke(device="cpu")
    ref = RC.get_spec(arch).smoke()
    assert set(out) == set(ref)
    for k, v in out.items():
        if isinstance(v, tuple):
            assert v == tuple(ref[k])
        else:
            assert np.isfinite(v)


# ------------------------------------------------------------ the LM cells

LM_CONFIGS = {
    "mixtral-8x7b": ("mixtral_8x7b", None),
    "mixtral-8x7b-batched": ("mixtral_8x7b", dict(dispatch="batched",
                                                  capacity_factor=1.0)),
    "arctic-480b": ("arctic_480b", None),
    "arctic-480b-batched": ("arctic_480b", dict(dispatch="batched")),
}


def _smoke_cfgs(module, moe=None):
    """The reference's and the port's smoke configs of ``module``, with
    ``moe`` replaced on both; the port's on its plain path."""
    ref_cfg = importlib.import_module(f"repro.configs.{module}").smoke_config()
    cfg = importlib.import_module(f"repro_torch.configs.{module}").smoke_config()
    if moe:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return ref_cfg, dataclasses.replace(cfg, kernel_backend="torch")


def _lm_cells(module, shape, moe=None):
    ref_cfg, cfg = _smoke_cfgs(module, moe)
    full_only = RC.get_spec(module.replace("_", "-")).meta["full_attention_only"]
    ref = ref_common.lm_spec(module, lambda: ref_cfg, lambda: ref_cfg, full_only)
    port = common.lm_spec(module, lambda: cfg, lambda: cfg, full_only)
    return (ref_cfg, ref.build_cell(shape, ref_common.SINGLE_POD),
            cfg, port.build_cell(shape, SINGLE_POD))


def _close_state(got, want, p0, lrs, kind):
    """AdamW's state and the parameters after the steps, as the module
    docstring states."""
    tol = GRAD_TOL[kind]
    assert int(got["opt"]["step"]) == int(want["opt"]["step"])
    flat = lambda t, k: tree_flatten(t[k] if k == "params" else t["opt"][k])[0]  # noqa: E731
    for k in ("m", "v"):
        for i, (g, w) in enumerate(zip(flat(got, k), flat(want, k), strict=True)):
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            scale = (1 if k == "m" else 2) * tol * np.abs(w).max(initial=0)
            assert np.abs(g - w).max(initial=0) <= scale, f"{k} leaf {i}"
    for i, (g, w, m) in enumerate(zip(flat(got, "params"), flat(want, "params"),
                                      flat(want, "m"), strict=True)):
        g, w, m = (np.asarray(a, np.float64) for a in (g, w, m))
        clear = np.abs(m) > 2 * tol * np.abs(m).max(initial=0)
        np.testing.assert_allclose(g[clear], w[clear], rtol=1e-6, atol=1e-7,
                                   err_msg=f"params leaf {i}")
        assert (np.abs(g - w) <= 2 * sum(lrs) * 1.001).all(), f"params leaf {i}"
    assert len(flat(got, "params")) == len(p0)


@pytest.mark.parametrize("name", list(LM_CONFIGS))
def test_lm_train_cell_matches_the_reference(name):
    module, moe = LM_CONFIGS[name]
    ref_cfg, ref_cell, cfg, cell = _lm_cells(module, "train_4k", moe)
    params = T.init_params(jax.random.key(0), ref_cfg)
    opt = ref_adamw_init(params)
    model = transformer_params_from_numpy(_np(params), cfg, "cpu")
    state = adamw_init(transformer_param_tree(model))
    p0 = tree_flatten(_np(params))[0]
    rng = np.random.default_rng(11)
    step = jax.jit(ref_cell.step_fn)
    lrs = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32)
        with _ref_mesh():
            params, opt, wm = step(params, opt, jnp.asarray(toks[:, :-1]),
                                   jnp.asarray(toks[:, 1:]))
        model, state, gm = cell.step_fn(model, state, torch.from_numpy(toks[:, :-1]),
                                        torch.from_numpy(toks[:, 1:]))
        assert set(gm) == set(wm) == {"loss", "moe_aux_loss", "moe_dropped", "lr",
                                      "grad_norm"}
        np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                                   rtol=LOSS_RTOL["lm"])
        np.testing.assert_allclose(float(gm["moe_aux_loss"]), float(wm["moe_aux_loss"]),
                                   rtol=AUX_RTOL)
        assert int(gm["moe_dropped"]) == int(wm["moe_dropped"])
        assert float(gm["lr"]) == float(wm["lr"])
        np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]),
                                   rtol=NORM_RTOL)
        lrs.append(float(wm["lr"]))
    assert all(leaf.requires_grad for leaf in tree_flatten(transformer_param_tree(model))[0])
    got = gnn_params_to_numpy({"params": transformer_param_tree(model), "opt": state})
    _close_state(got, _np({"params": params, "opt": opt}), p0, lrs, "lm")


@pytest.mark.parametrize("module", ["mixtral_8x7b", "arctic_480b", "qwen2_72b"])
def test_lm_prefill_and_decode_cells_match_the_reference(module):
    """A 12-token prompt into a 16-slot cache through the prefill cell's
    step, then two decode steps through the decode cell's."""
    ref_cfg, ref_prefill, cfg, prefill = _lm_cells(module, "prefill_32k")
    ref_decode, decode = _lm_cells(module, "decode_32k")[1::2]
    params = T.init_params(jax.random.key(0), ref_cfg)
    model = transformer_params_from_numpy(_np(params), cfg, "cpu")
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 14)).astype(np.int32)
    ref_cache = T.init_kv_cache(ref_cfg, 2, 16)
    cache = model.init_kv_cache(2, 16)
    with _ref_mesh():
        want, ref_cache = jax.jit(ref_prefill.step_fn)(params, jnp.asarray(toks[:, :12]),
                                                       ref_cache)
    got, cache = prefill.step_fn(model, torch.from_numpy(toks[:, :12]), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    for i in (12, 13):
        with _ref_mesh():
            want, ref_cache = jax.jit(ref_decode.step_fn)(params, jnp.asarray(toks[:, i]),
                                                          ref_cache)
        got, cache = decode.step_fn(model, torch.from_numpy(toks[:, i]), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert cache["pos"] == int(ref_cache["pos"]) == 14
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(ref_cache[k]), **MODEL_TOL)


# ------------------------------------------------------- the xDeepFM cell

XDEEPFM_SMOKE = dict(n_sparse=6, embed_dim=8, cin_layers=(16, 16), mlp_dims=(32,),
                     vocab_sizes=(64,) * 6)


def test_xdeepfm_train_cell_matches_the_reference(monkeypatch):
    """Two steps of ``build_cell("train_batch")``'s step at the smoke
    widths (both packages' ``CFG`` patched), 64 rows a step."""
    ref_cfg = JR.XDeepFMConfig(name="xdeepfm", **XDEEPFM_SMOKE)
    monkeypatch.setattr(jax_xdeepfm, "CFG", ref_cfg)
    monkeypatch.setattr(xdeepfm, "CFG", PR.XDeepFMConfig(name="xdeepfm", **XDEEPFM_SMOKE))
    ref_cell = jax_xdeepfm.build_cell("train_batch", ref_common.SINGLE_POD)
    cell = xdeepfm.build_cell("train_batch", SINGLE_POD)
    assert cell.abstract_args[2].shape == (65_536, 6)
    params = jax_xdeepfm.xdeepfm_init(jax.random.key(0), ref_cfg)
    opt = ref_adamw_init(params)
    p0 = tree_flatten(_np(params))[0]
    port = gnn_params_from_numpy(_np(params), "cpu")
    state = adamw_init(port)
    rng = np.random.default_rng(13)
    step = jax.jit(ref_cell.step_fn)
    lrs = []
    for _ in range(2):
        ids = rng.integers(0, 64, (64, 6)).astype(np.int32)
        labels = rng.integers(0, 2, 64).astype(np.float32)
        with _ref_mesh():
            params, opt, wm = step(params, opt, jnp.asarray(ids), jnp.asarray(labels))
        port, state, gm = cell.step_fn(port, state, torch.from_numpy(ids),
                                       torch.from_numpy(labels))
        assert set(gm) == set(wm) == {"loss", "lr", "grad_norm"}
        np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                                   rtol=LOSS_RTOL["xdeepfm"])
        assert float(gm["lr"]) == float(wm["lr"])
        np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]),
                                   rtol=NORM_RTOL)
        lrs.append(float(wm["lr"]))
    got = gnn_params_to_numpy({"params": port, "opt": state})
    _close_state(got, _np({"params": params, "opt": opt}), p0, lrs, "xdeepfm")


def test_xdeepfm_serve_cells_are_serve_fn():
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        cell = xdeepfm.build_cell(shape, SINGLE_POD)
        assert cell.kind == "serve"
    cfg = PR.XDeepFMConfig(name="xdeepfm", **XDEEPFM_SMOKE)
    params = PR.xdeepfm_init(torch.Generator().manual_seed(0), cfg)
    ids = torch.randint(0, 64, (8, 6), generator=torch.Generator().manual_seed(1))
    got = xdeepfm.build_cell("serve_p99", SINGLE_POD).step_fn
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(xdeepfm, "CFG", cfg)
        assert torch.equal(got(params, ids), xdeepfm.serve_fn("serve_p99")(params, ids))


# ----------------------------------------------------------- the GNN cells

@pytest.mark.parametrize("config", ["schnet", "pna", "egnn", "graphsage_reddit"])
def test_gnn_cell_step_is_gnn_spec_step(config):
    """``build_cell("molecule", SINGLE_POD).step_fn`` and
    ``GNNSpec.step_fn("molecule")`` from the same state on the same graph:
    every parameter, moment and metric bit-equal."""
    spec = importlib.import_module(f"repro_torch.configs.{config}").SPEC
    info = common_gnn.GNN_SHAPES["molecule"]
    cfg = spec.make_cfg(info)
    cell = spec.build_cell("molecule", SINGLE_POD)
    rng = np.random.default_rng(14)
    n, e = info["n_nodes"], info["n_edges"]
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    nodes = (rng.integers(1, 10, (n, 1)).astype(np.int32) if config == "schnet"
             else rng.standard_normal((n, info["d_feat"])).astype(np.float32))
    graph = PG.Graph(nodes=t(nodes), senders=t(rng.integers(0, n, e).astype(np.int32)),
                     receivers=t(rng.integers(0, n, e).astype(np.int32)),
                     positions=t(rng.standard_normal((n, 3)).astype(np.float32)),
                     graph_ids=t((np.arange(n) * info["n_graphs"] // n).astype(np.int32)),
                     n_graphs=info["n_graphs"])
    if spec.loss_kind == "node_class":
        batch = (t(np.arange(n, dtype=np.int32)), t(np.zeros(n, np.int32)))
    else:
        batch = (t(rng.standard_normal((info["n_graphs"], 1)).astype(np.float32)),)
    params = spec.init_fn(torch.Generator().manual_seed(0), cfg)
    out = []
    for step in (cell.step_fn, spec.step_fn("molecule")):
        tree = gnn_params_from_numpy(gnn_params_to_numpy(params), "cpu")
        state = common_gnn.init_train_state(tree)
        _, _, m = step(state.params, state.opt, graph, *batch)
        out.append((tree_flatten(state.tree())[0], m))
    (a, ma), (b, mb) = out
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
