"""GNN zoo: SchNet, PNA, EGNN, GraphSAGE — the port of ``repro/models/gnn.py``.

Message passing is an edge-table gather, then a segment reduction over the
receivers.  The edge list (senders, receivers) is the graph engine; every
segment sum runs through ``kernels.ops.segment_reduce``, which is the
hand-written segment-sum kernel for a CUDA tensor, and every segment max
or min through the segment-max kernel over flattened ids (``op="max"``;
a min is ``-max(-x)``).  Where autograd records, the kernels run as the
forwards of ``SegmentSum`` and ``SegmentMax``, whose backwards give the
plain autograd's gradients.  ``backend`` ("auto", "torch", "cuda") picks
the kernels or their plain versions, as in ``kernels.ops``.

Graphs are static-shape, as the reference's: node and edge buffers padded
to capacity, padding edges pointing at node index ``capacity``, dropped
by the segment ops.  Batched small graphs (the molecule shape) share one
node buffer with a ``graph_ids`` column; padding nodes take the id
``n_graphs``, which the pooling drops.

Differences from the reference:

* a JAX gather clamps an out-of-range index, where torch's raises; every
  gather here indexes with its ids clamped to ``[0, capacity)``.  A
  padding edge's message is dropped by the segment op, and so is its
  gradient, so the clamp changes no result;
* parameters are the reference's nested tree (dicts of dicts and lists of
  tensors, the same keys), drawn with a ``torch.Generator`` on its device,
  so a tree crosses from the reference unchanged (``convert``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.ops import segment_reduce
from .layers import layernorm, layernorm_init, linear, linear_init, mlp, mlp_init

__all__ = [
    "Graph", "segment_sum", "segment_mean", "segment_max", "segment_min",
    "GraphSAGEConfig", "graphsage_init", "graphsage_apply",
    "PNAConfig", "pna_init", "pna_apply",
    "SchNetConfig", "schnet_init", "schnet_apply",
    "EGNNConfig", "egnn_init", "egnn_apply",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Static-shape (possibly batched) graph.

    nodes: (N, F) features; senders/receivers: (E,) int32 edge endpoints
    (padding edges use index N_capacity — out of range, dropped);
    positions: (N, 3) for geometric models; graph_ids: (N,) int32 segment id
    of each node's graph for batched graphs; ``n_graphs`` a plain int.
    """

    nodes: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    positions: Optional[torch.Tensor] = None
    graph_ids: Optional[torch.Tensor] = None
    n_graphs: int = 1

    @property
    def n_node_cap(self) -> int:
        return self.nodes.shape[0]


def segment_sum(data, seg_ids, num_segments, backend: str = "auto"):
    """``(n, d)`` rows summed into ``(num_segments, d)``; ids outside
    ``[0, num_segments)`` dropped (the reference clamps them to a spill
    segment it cuts off)."""
    return segment_reduce(data, seg_ids, num_segments, backend=backend)


def segment_mean(data, seg_ids, num_segments, backend: str = "auto"):
    s = segment_sum(data, seg_ids, num_segments, backend)
    cnt = segment_sum(torch.ones((data.shape[0], 1), dtype=data.dtype,
                                 device=data.device), seg_ids, num_segments, backend)
    return s / torch.clamp(cnt, min=1)


def segment_max(data, seg_ids, num_segments, backend: str = "auto"):
    """Feature-wise max; empty segments (``-inf``) give 0."""
    full = segment_reduce(data, seg_ids, num_segments, op="max", backend=backend)
    return torch.where(torch.isfinite(full), full, 0.0)


def segment_min(data, seg_ids, num_segments, backend: str = "auto"):
    """Feature-wise min, ``-max(-x)`` (exact); empty segments give 0."""
    full = -segment_reduce(-data, seg_ids, num_segments, op="max", backend=backend)
    return torch.where(torch.isfinite(full), full, 0.0)


def _degree(g: Graph, backend: str = "auto") -> torch.Tensor:
    n = g.n_node_cap
    return segment_sum(torch.ones((g.receivers.shape[0], 1), dtype=torch.float32,
                                  device=g.receivers.device), g.receivers, n, backend)


def _gather_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Edge endpoints clamped into ``[0, n)``, as a JAX gather reads them."""
    return ids.clamp(0, n - 1)


# ------------------------------------------------------------------ GraphSAGE

@dataclasses.dataclass(frozen=True)
class GraphSAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41
    aggregator: str = "mean"
    sample_sizes: tuple = (25, 10)
    dtype: torch.dtype = torch.float32


def graphsage_init(gen: torch.Generator, cfg: GraphSAGEConfig) -> Dict:
    layers = []
    d = cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append({
            "self": linear_init(gen, d, cfg.d_hidden, bias=True, dtype=cfg.dtype),
            "neigh": linear_init(gen, d, cfg.d_hidden, bias=False, dtype=cfg.dtype),
        })
        d = cfg.d_hidden
    return {"layers": layers,
            "out": linear_init(gen, d, cfg.n_classes, bias=True, dtype=cfg.dtype)}


def graphsage_apply(p, cfg: GraphSAGEConfig, g: Graph, *,
                    backend: str = "auto") -> torch.Tensor:
    h = g.nodes
    n = g.n_node_cap
    senders = _gather_ids(g.senders, n)
    for layer in p["layers"]:
        msgs = h.index_select(0, senders)
        agg = (segment_mean(msgs, g.receivers, n, backend) if cfg.aggregator == "mean"
               else segment_max(msgs, g.receivers, n, backend))
        del msgs  # (E, d): neither the gather nor the segment op keeps it
        h = F.relu(linear(layer["self"], h) + linear(layer["neigh"], agg))
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                            min=1e-6)
    return linear(p["out"], h)  # (N, n_classes) node logits


# ------------------------------------------------------------------------ PNA

@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 16
    n_out: int = 1
    aggregators: tuple = ("mean", "max", "min", "std")
    scalers: tuple = ("identity", "amplification", "attenuation")
    delta: float = 2.5  # avg log-degree of the training set (paper's δ)
    dtype: torch.dtype = torch.float32


def pna_init(gen: torch.Generator, cfg: PNAConfig) -> Dict:
    d = cfg.d_hidden
    layers = []
    for _ in range(cfg.n_layers):
        n_cat = len(cfg.aggregators) * len(cfg.scalers) * d + d
        layers.append({
            "pre": mlp_init(gen, [2 * d, d], dtype=cfg.dtype),      # message MLP
            "post": mlp_init(gen, [n_cat, d], dtype=cfg.dtype),     # update MLP
            "norm": layernorm_init(d, cfg.dtype, gen.device),
        })
    return {
        "encode": linear_init(gen, cfg.d_in, d, bias=True, dtype=cfg.dtype),
        "layers": layers,
        "out": mlp_init(gen, [d, d, cfg.n_out], dtype=cfg.dtype),
    }


def pna_apply(p, cfg: PNAConfig, g: Graph, *, backend: str = "auto") -> torch.Tensor:
    n = g.n_node_cap
    senders, receivers = _gather_ids(g.senders, n), _gather_ids(g.receivers, n)
    h = linear(p["encode"], g.nodes)
    deg = _degree(g, backend)
    log_deg = torch.log(deg + 1.0)
    scale = {
        "identity": torch.ones_like(log_deg),
        "amplification": log_deg / cfg.delta,
        "attenuation": cfg.delta / torch.clamp(log_deg, min=1e-3),
    }
    for layer in p["layers"]:
        m = mlp(layer["pre"], torch.cat([h.index_select(0, senders),
                                         h.index_select(0, receivers)], -1))
        aggs = []
        mean = segment_mean(m, g.receivers, n, backend)
        for a in cfg.aggregators:
            if a == "mean":
                agg = mean
            elif a == "max":
                agg = segment_max(m, g.receivers, n, backend)
            elif a == "min":
                agg = segment_min(m, g.receivers, n, backend)
            elif a == "std":
                sq = segment_mean(m * m, g.receivers, n, backend)
                var = sq - mean * mean
                # torch.maximum splits a tie's gradient in halves, as
                # jnp.maximum does (torch.clamp passes it whole): a node with
                # one message has var exactly 0
                zero = torch.zeros((), dtype=var.dtype, device=var.device)
                agg = torch.sqrt(torch.maximum(var, zero) + 1e-5)
            for s in cfg.scalers:
                aggs.append(agg * scale[s])
        upd = mlp(layer["post"], torch.cat(aggs + [h], -1))
        h = h + layernorm(layer["norm"], upd)  # residual
    if g.graph_ids is not None:
        pooled = segment_mean(h, g.graph_ids, g.n_graphs, backend)
    else:
        pooled = torch.mean(h, 0, keepdim=True)
    return mlp(p["out"], pooled, act=F.relu)


# --------------------------------------------------------------------- SchNet

@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100
    dtype: torch.dtype = torch.float32


def schnet_init(gen: torch.Generator, cfg: SchNetConfig) -> Dict:
    inter = []
    d = cfg.d_hidden
    for _ in range(cfg.n_interactions):
        inter.append({
            "filter": mlp_init(gen, [cfg.n_rbf, d, d], dtype=cfg.dtype),
            "in": linear_init(gen, d, d, bias=False, dtype=cfg.dtype),
            "out1": linear_init(gen, d, d, bias=True, dtype=cfg.dtype),
            "out2": linear_init(gen, d, d, bias=True, dtype=cfg.dtype),
        })
    return {
        "embed": torch.randn(cfg.n_atom_types, d, generator=gen, dtype=cfg.dtype,
                             device=gen.device).mul_(0.1),
        "interactions": inter,
        "readout": mlp_init(gen, [d, d // 2, 1], dtype=cfg.dtype),
    }


def _shifted_softplus(x):
    return F.softplus(x) - math.log(2.0)


def rbf_centres(cfg: SchNetConfig, device) -> torch.Tensor:
    """``jnp.linspace(0, cutoff, n_rbf, dtype=float32)`` bit for bit, made
    on ``device``.  JAX writes ``start * (1 - step) + stop * step`` with
    ``step = iota / (n - 1)``, and XLA's simplifier compiles the division
    as a product with the float32 reciprocal ``r`` and folds ``stop * r``
    into one constant: ``start * (1 - iota * r) + iota * (stop * r)``, then
    ``stop`` appended.  (``torch.linspace`` differs in 124 of SchNet's 300,
    the literal formula in 174.)"""
    div = cfg.n_rbf - 1
    start = torch.zeros((), dtype=torch.float32, device=device)
    stop = torch.full((), cfg.cutoff, dtype=torch.float32, device=device)
    if div < 1:
        return start.reshape(1)[:cfg.n_rbf]
    r = torch.full((), 1.0, dtype=torch.float32, device=device) / div
    iota = torch.arange(div, dtype=torch.float32, device=device)
    return torch.cat([start * (1 - iota * r) + iota * (stop * r), stop.reshape(1)])


def schnet_apply(p, cfg: SchNetConfig, g: Graph, *,
                 backend: str = "auto") -> torch.Tensor:
    """g.nodes: (N, 1) int atom types; g.positions: (N, 3). Returns energy/graph."""
    n = g.n_node_cap
    senders, receivers = _gather_ids(g.senders, n), _gather_ids(g.receivers, n)
    z = g.nodes[:, 0].to(torch.int32)
    h = p["embed"].index_select(0, z.clamp(0, cfg.n_atom_types - 1))
    dist = torch.linalg.vector_norm(
        g.positions.index_select(0, senders) - g.positions.index_select(0, receivers)
        + 1e-12, dim=-1)  # (E,)
    mu = rbf_centres(cfg, dist.device)
    gamma = 10.0
    rbf = torch.exp(-gamma * (dist[:, None] - mu[None, :]) ** 2)  # (E, n_rbf)
    # cosine cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1)) + 1.0)
    for layer in p["interactions"]:
        w = mlp(layer["filter"], rbf, act=_shifted_softplus, final_act=True)
        msg = linear(layer["in"], h).index_select(0, senders) * w * env[:, None]
        agg = segment_sum(msg, g.receivers, n, backend)
        v = _shifted_softplus(linear(layer["out1"], agg))
        h = h + linear(layer["out2"], v)
    atom_e = mlp(p["readout"], h, act=_shifted_softplus)  # (N, 1)
    if g.graph_ids is not None:
        return segment_sum(atom_e, g.graph_ids, g.n_graphs, backend)
    return torch.sum(atom_e, 0, keepdim=True)


# ----------------------------------------------------------------------- EGNN

@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    dtype: torch.dtype = torch.float32


def egnn_init(gen: torch.Generator, cfg: EGNNConfig) -> Dict:
    d = cfg.d_hidden
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "edge": mlp_init(gen, [2 * d + 1, d, d], dtype=cfg.dtype),
            "coord": mlp_init(gen, [d, d, 1], dtype=cfg.dtype),
            "node": mlp_init(gen, [2 * d, d, d], dtype=cfg.dtype),
        })
    return {
        "encode": linear_init(gen, cfg.d_in, d, bias=True, dtype=cfg.dtype),
        "layers": layers,
        "out": mlp_init(gen, [d, d, 1], dtype=cfg.dtype),
    }


def egnn_apply(p, cfg: EGNNConfig, g: Graph, *, backend: str = "auto"):
    """E(n)-equivariant layers. Returns (graph outputs, final positions)."""
    n = g.n_node_cap
    senders, receivers = _gather_ids(g.senders, n), _gather_ids(g.receivers, n)
    h = linear(p["encode"], g.nodes)
    x = g.positions
    for layer in p["layers"]:
        diff = x.index_select(0, senders) - x.index_select(0, receivers)  # (E, 3)
        d2 = torch.sum(diff * diff, -1, keepdim=True)                     # (E, 1)
        m = mlp(layer["edge"], torch.cat([h.index_select(0, senders),
                                          h.index_select(0, receivers), d2], -1),
                final_act=True)
        w = mlp(layer["coord"], m)                    # (E, 1)
        # normalized coordinate update keeps equivariance + stability
        upd = segment_mean(diff * torch.tanh(w), g.receivers, n, backend)
        x = x + upd
        agg = segment_sum(m, g.receivers, n, backend)
        h = h + mlp(layer["node"], torch.cat([h, agg], -1))
    if g.graph_ids is not None:
        pooled = segment_mean(h, g.graph_ids, g.n_graphs, backend)
    else:
        pooled = torch.mean(h, 0, keepdim=True)
    return mlp(p["out"], pooled), x
