"""graphsage-reddit [arXiv:1706.02216]: 2L mean-agg, d=128, fanout 25-10 —
the port of ``repro/configs/graphsage_reddit.py``.

Node classification; minibatch_lg uses the real neighbor sampler
(``data/sampler.py``, the port's copy).  ``make_cfg`` says
``sample_sizes=(25, 10)`` where the shape samples 15-10, as the
reference's does."""
import numpy as np
import torch

from ..core.table import resolve_device
from ..models import gnn as G
from .common_gnn import gnn_spec

ARCH_ID = "graphsage-reddit"


def make_cfg(info):
    return G.GraphSAGEConfig(
        name=ARCH_ID, n_layers=2, d_hidden=128, aggregator="mean",
        sample_sizes=(25, 10), d_in=info["d_feat"], n_classes=info["n_classes"],
    )


def smoke(device="cuda"):
    from ..data.rmat import rmat_edges
    from ..data.sampler import build_csr, sample_subgraph

    device = resolve_device(device)
    cfg = G.GraphSAGEConfig(name=ARCH_ID, d_in=8, n_classes=5, d_hidden=16)
    params = G.graphsage_init(torch.Generator(device=device).manual_seed(0), cfg)
    s, r = rmat_edges(9, 4096, seed=0)
    csr = build_csr(s.astype(np.int64), r.astype(np.int64), 512)
    feats = np.random.default_rng(0).standard_normal((512, 8)).astype(np.float32)
    labels = np.random.default_rng(1).integers(0, 5, 512)
    sub = sample_subgraph(csr, np.arange(16), [5, 3], feats, labels, seed=1)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    g = G.Graph(nodes=t(sub["nodes"]), senders=t(sub["senders"]),
                receivers=t(sub["receivers"]))
    logits = G.graphsage_apply(params, cfg, g)
    sel = logits.index_select(0, t(sub["seed_local"]))
    if sel.shape != (16, 5) or bool(torch.isnan(sel).any()):
        raise AssertionError(f"graphsage smoke: logits {sel}")
    return {"logits_shape": tuple(sel.shape)}


SPEC = gnn_spec(ARCH_ID, make_cfg, G.graphsage_init, G.graphsage_apply,
                "node_class", smoke)
