"""GNN config machinery: the 4 graph shapes and the training step of the 4
architectures — the port of ``repro/configs/common_gnn.py``.

Shape regimes (the reference's numbers and notes):
  full_graph_sm  cora-size full batch   (2,708 n / 10,556 e / 1,433 f)
  minibatch_lg   reddit sampled batch   (232,965 n graph; 1,024 seeds, 15-10)
  ogb_products   full-batch large       (2,449,029 n / 61,859,140 e / 100 f)
  molecule       batched small graphs   (30 n / 64 e × batch 128)

Capacities are the reference's, padded for its 256- and 512-device
meshes.  The reference's ``ArchSpec``, ``Cell``, ``MeshAxes`` and partition
specs are not ported (they belong to the launch item); :class:`GNNSpec`
keeps what ``gnn_spec`` binds of an arch for training, and :func:`gnn_train_step` is
``build_cell``'s ``train_step`` for either loss (``common_gnn.py:105-142``):
the loss, its gradient with respect to every parameter
(``torch.autograd.grad``; a parameter the loss does not reach gets zeros,
as ``jax.value_and_grad`` gives) and AdamW in place
(``train/optimizer.adamw_update``), whose step, learning rate and norm stay
0-d device tensors, so a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from ..train.checkpoint import tree_flatten, tree_unflatten
from ..train.loop import TrainState
from ..train.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["GNN_SHAPES", "GNN_OPT", "GNNSpec", "node_class_loss",
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
    ``GNN_OPT``, the metrics 0-d device tensors (``loss``, ``acc`` for node
    classification, ``lr``, ``grad_norm``).  The parameters must require
    grad (:func:`init_train_state`)."""
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

    def train_step(params, opt_state, graph, *batch):
        leaves, treedef = tree_flatten(params)
        loss, metrics = loss_fn(params, graph, *batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        params, opt_state, om = adamw_update(tree_unflatten(treedef, list(grads)),
                                             opt_state, params, GNN_OPT)
        return params, opt_state, {"loss": loss.detach(), **metrics, **om}

    return train_step


def init_train_state(params) -> TrainState:
    """The parameters marked as requiring grad, and AdamW's zero state."""
    for leaf in tree_flatten(params)[0]:
        leaf.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params, GNN_OPT.state_dtype))


@dataclasses.dataclass(frozen=True)
class GNNSpec:
    """What the reference's ``gnn_spec`` binds of an arch for training: its
    model config for a shape (``make_cfg(GNN_SHAPES[shape])``), init and
    apply, and its loss."""
    arch: str
    make_cfg: Callable[[Dict], Any]
    init_fn: Callable
    apply_fn: Callable
    loss_kind: str

    def step_fn(self, shape: str, *, backend: str = "auto") -> Callable:
        """The training step of the arch's cell at ``shape``."""
        return gnn_train_step(self.apply_fn, self.make_cfg(GNN_SHAPES[shape]),
                              self.loss_kind, backend=backend)
