"""GNN config machinery: the 4 graph shapes and the cells of the 4
architectures — the port of ``repro/configs/common_gnn.py``.

Shape regimes (the reference's numbers and notes):
  full_graph_sm  cora-size full batch   (2,708 n / 10,556 e / 1,433 f)
  minibatch_lg   reddit sampled batch   (232,965 n graph; 1,024 seeds, 15-10)
  ogb_products   full-batch large       (2,449,029 n / 61,859,140 e / 100 f)
  molecule       batched small graphs   (30 n / 64 e × batch 128)

Capacities are the reference's, padded for its 256- and 512-device
meshes.  :func:`gnn_spec` builds an arch's :class:`GNNSpec`, the
reference's ``ArchSpec`` (``build_cell`` over the four shapes: the graph,
parameters and AdamW state on the meta device, their partition specs, the
train step) that also keeps what it binds of the arch, with
:meth:`GNNSpec.step_fn` to pick the kernels' backend.  :func:`gnn_train_step`
is ``build_cell``'s ``train_step`` for either loss (``common_gnn.py:105-142``)
over ``common.train_step_fn``: the loss, its gradient with respect to
every parameter and AdamW in place, whose step, learning rate and norm
stay 0-d device tensors, so a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..models.gnn import Graph
from ..train.checkpoint import tree_flatten
from ..train.loop import TrainState
from ..train.optimizer import AdamWConfig, adamw_init
from .common import (ArchSpec, Cell, MeshAxes, abstract_adamw, abstract_init,
                     adamw_pspecs, meta_tensor, replicated, train_step_fn)

__all__ = ["GNN_SHAPES", "GNN_OPT", "GNNSpec", "gnn_spec", "node_class_loss",
           "graph_reg_loss", "gnn_train_step", "init_train_state"]

# capacities padded to lcm-divisibility for 256- and 512-way meshes
GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2_816, n_edges=10_752, d_feat=1_433,
                          n_graphs=1, n_classes=7,
                          raw="n_nodes=2708 n_edges=10556 d_feat=1433"),
    "minibatch_lg": dict(n_nodes=170_496, n_edges=168_960, d_feat=602,
                         n_graphs=1, n_classes=41, n_seeds=1_024,
                         raw="reddit 232,965n/114.6Me; batch=1024 fanout 15-10"),
    "ogb_products": dict(n_nodes=2_449_920, n_edges=61_865_984, d_feat=100,
                         n_graphs=1, n_classes=47,
                         raw="n_nodes=2,449,029 n_edges=61,859,140 d_feat=100"),
    "molecule": dict(n_nodes=4_096, n_edges=8_192, d_feat=16,
                     n_graphs=128, n_classes=1,
                     raw="30n/64e per graph × batch 128"),
}

# the reference's GNN optimizer (common_gnn.py:86)
GNN_OPT = AdamWConfig(lr=1e-3, schedule="cosine", total_steps=5_000,
                      weight_decay=0.0)


def node_class_loss(logits: torch.Tensor, seeds: torch.Tensor,
                    labels: torch.Tensor):
    """Log-softmax cross-entropy on the seed rows, and their accuracy."""
    sel = logits.index_select(0, seeds)
    logp = F.log_softmax(sel.to(torch.float32), -1)
    loss = -torch.mean(torch.gather(logp, 1, labels.long()[:, None])[:, 0])
    acc = torch.mean((torch.argmax(sel, -1) == labels).to(torch.float32))
    return loss, {"acc": acc}


def graph_reg_loss(out, target: torch.Tensor):
    """Mean squared error; EGNN's ``(out, x)`` takes ``out``."""
    out = out[0] if isinstance(out, tuple) else out
    return torch.mean((out.to(torch.float32) - target) ** 2), {}


def gnn_train_step(apply_fn: Callable, cfg: Any, loss_kind: str, *,
                   backend: str = "auto") -> Callable:
    """The reference's ``train_step``: for ``"node_class"``
    ``step(params, opt_state, graph, seeds, labels)``, for ``"graph_reg"``
    ``step(params, opt_state, graph, target)``; each returns ``(params,
    opt_state, metrics)``, the trees updated in place by AdamW under
    ``GNN_OPT`` (``common.train_step_fn``), the metrics 0-d device tensors
    (``loss``, ``acc`` for node classification, ``lr``, ``grad_norm``)."""
    if loss_kind == "node_class":
        def loss_fn(params, graph, seeds, labels):
            return node_class_loss(apply_fn(params, cfg, graph, backend=backend),
                                   seeds, labels)
    elif loss_kind == "graph_reg":
        def loss_fn(params, graph, target):
            return graph_reg_loss(apply_fn(params, cfg, graph, backend=backend),
                                  target)
    else:
        raise ValueError(f"unknown loss kind {loss_kind!r}")
    return train_step_fn(loss_fn, GNN_OPT)


def init_train_state(params) -> TrainState:
    """The parameters marked as requiring grad, and AdamW's zero state."""
    for leaf in tree_flatten(params)[0]:
        leaf.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params, GNN_OPT.state_dtype))


def _abstract_graph(arch: str, info: dict) -> Graph:
    n, e = info["n_nodes"], info["n_edges"]
    geometric = arch in ("schnet", "egnn")
    atom_input = arch == "schnet"
    nodes = (meta_tensor((n, 1), torch.int32) if atom_input
             else meta_tensor((n, info["d_feat"]), torch.float32))
    return Graph(
        nodes=nodes,
        senders=meta_tensor((e,), torch.int32),
        receivers=meta_tensor((e,), torch.int32),
        positions=meta_tensor((n, 3), torch.float32) if geometric else None,
        graph_ids=meta_tensor((n,), torch.int32) if info["n_graphs"] > 1 else None,
        n_graphs=info["n_graphs"],
    )


def _graph_pspecs(g: Graph, mp: MeshAxes, shard_nodes: bool) -> Graph:
    """Row-shard edge tables over every axis; node tables over dp when big."""
    edge_spec = (mp.all_axes,)
    node_rows = mp.dp if shard_nodes else None
    return Graph(
        nodes=(node_rows, None),
        senders=edge_spec,
        receivers=edge_spec,
        positions=None if g.positions is None else (node_rows, None),
        graph_ids=None if g.graph_ids is None else (node_rows,),
        n_graphs=g.n_graphs,
    )


@dataclasses.dataclass(frozen=True)
class GNNSpec(ArchSpec):
    """The reference's ``ArchSpec`` of a GNN, and what ``gnn_spec`` binds
    of the arch: its model config for a shape
    (``make_cfg(GNN_SHAPES[shape])``), init and apply, and its loss."""
    make_cfg: Optional[Callable[[Dict], Any]] = None
    init_fn: Optional[Callable] = None
    apply_fn: Optional[Callable] = None
    loss_kind: str = ""

    def step_fn(self, shape: str, *, backend: str = "auto") -> Callable:
        """The training step of the arch's cell at ``shape``, its segment
        ops through ``backend`` (``kernels/ops.py``)."""
        return gnn_train_step(self.apply_fn, self.make_cfg(GNN_SHAPES[shape]),
                              self.loss_kind, backend=backend)


def gnn_spec(
    arch: str,
    make_cfg: Callable[[dict], Any],      # info -> model config
    init_fn: Callable,                    # (gen, cfg) -> params
    apply_fn: Callable,                   # (params, cfg, graph) -> output
    loss_kind: str,                       # "node_class" | "graph_reg"
    make_smoke: Callable[..., Dict[str, Any]],
) -> GNNSpec:
    def build_cell(shape: str, mp: MeshAxes) -> Optional[Cell]:
        info = GNN_SHAPES[shape]
        cfg = make_cfg(info)
        a_graph = _abstract_graph(arch, info)
        g_specs = _graph_pspecs(a_graph, mp, shard_nodes=info["n_nodes"] >= 65536)
        a_params = abstract_init(init_fn, cfg)
        p_specs = replicated(a_params)
        a_opt = abstract_adamw(a_params)
        o_specs = adamw_pspecs(p_specs)
        step = gnn_train_step(apply_fn, cfg, loss_kind)

        if loss_kind == "node_class":
            n_lab = info.get("n_seeds", info["n_nodes"])
            return Cell(
                arch=arch, shape=shape, kind="train", step_fn=step,
                abstract_args=(a_params, a_opt, a_graph, meta_tensor((n_lab,), torch.int32),
                               meta_tensor((n_lab,), torch.int32)),
                arg_pspecs=(p_specs, o_specs, g_specs, (None,), (None,)),
                donate=(0, 1), note=info["raw"],
            )
        # graph-level regression (schnet energies, pna/egnn targets)
        return Cell(
            arch=arch, shape=shape, kind="train", step_fn=step,
            abstract_args=(a_params, a_opt, a_graph,
                           meta_tensor((info["n_graphs"], 1), torch.float32)),
            arg_pspecs=(p_specs, o_specs, g_specs, (None, None)),
            donate=(0, 1), note=info["raw"],
        )

    return GNNSpec(arch=arch, family="gnn", shapes=tuple(GNN_SHAPES),
                   build_cell=build_cell, smoke=make_smoke, make_cfg=make_cfg,
                   init_fn=init_fn, apply_fn=apply_fn, loss_kind=loss_kind)
