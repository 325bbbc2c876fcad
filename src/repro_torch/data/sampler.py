"""GraphSAGE neighbor sampler — a copy of ``repro/data/sampler.py``.

Host-side (numpy) layered uniform sampling over a CSR adjacency:
``sample_subgraph`` draws fanout-f neighbors per hop for a seed batch and
emits a padded, static-shape edge list the model consumes unchanged
(minibatch_lg: batch_nodes=1024, fanout 15-10).  Deterministic per
``(seed, step)``; for the same inputs and seed it gives the reference's
arrays bit for bit (NumPy only, the same calls in the same order).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["CSRGraph", "build_csr", "sample_subgraph"]


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,)
    n_nodes: int


def build_csr(senders: np.ndarray, receivers: np.ndarray, n_nodes: int) -> CSRGraph:
    """CSR over incoming edges: neighbors(v) = senders of edges into v."""
    order = np.argsort(receivers, kind="stable")
    s = senders[order]
    r = receivers[order]
    counts = np.bincount(r, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=s.astype(np.int32), n_nodes=n_nodes)


def _sample_neighbors(g: CSRGraph, nodes: np.ndarray, fanout: int,
                      rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform-with-replacement fanout sampling (GraphSAGE §3.1).

    Returns (senders, receivers) of the sampled edges; isolated nodes get
    self-loops so the static shape (len(nodes)*fanout) always holds.
    """
    deg = g.indptr[nodes + 1] - g.indptr[nodes]
    starts = g.indptr[nodes]
    offs = (rng.random((len(nodes), fanout)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
    nbr = g.indices[starts[:, None] + offs]
    nbr = np.where(deg[:, None] > 0, nbr, nodes[:, None])  # self-loop fallback
    recv = np.repeat(nodes, fanout)
    return nbr.reshape(-1).astype(np.int32), recv.astype(np.int32)


def sample_subgraph(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    features: np.ndarray,
    labels: np.ndarray,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Layered sampling -> padded subgraph with *local* node ids.

    Output arrays have static shapes determined by (len(seeds), fanouts):
      nodes   (cap_nodes, F)   local feature matrix (padded with zeros)
      senders/receivers (cap_edges,) local-id edge list (padding = cap_nodes)
      seed_local (len(seeds),) local ids of the seed nodes
      labels  (len(seeds),)
    """
    rng = np.random.default_rng(seed)
    frontier = seeds.astype(np.int32)
    all_s: List[np.ndarray] = []
    all_r: List[np.ndarray] = []
    cap_nodes = len(seeds)
    f_prod = len(seeds)
    for f in fanouts:
        f_prod *= f
        cap_nodes += f_prod
    cap_edges = cap_nodes - len(seeds)

    for f in fanouts:
        s, r = _sample_neighbors(g, frontier, f, rng)
        all_s.append(s)
        all_r.append(r)
        frontier = np.unique(s)

    s = np.concatenate(all_s)
    r = np.concatenate(all_r)
    uniq, inv = np.unique(np.concatenate([seeds, s, r]), return_inverse=True)
    n_local = len(uniq)
    seed_local = inv[: len(seeds)].astype(np.int32)
    s_local = inv[len(seeds): len(seeds) + len(s)].astype(np.int32)
    r_local = inv[len(seeds) + len(s):].astype(np.int32)

    nodes = np.zeros((cap_nodes, features.shape[1]), features.dtype)
    nodes[:n_local] = features[uniq]
    senders = np.full(cap_edges, cap_nodes, np.int32)
    receivers = np.full(cap_edges, cap_nodes, np.int32)
    senders[: len(s_local)] = s_local
    receivers[: len(r_local)] = r_local
    return {
        "nodes": nodes,
        "senders": senders,
        "receivers": receivers,
        "seed_local": seed_local,
        "labels": labels[seeds],
        "n_local": np.int32(n_local),
    }
