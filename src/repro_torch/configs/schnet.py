"""schnet [arXiv:1706.08566]: 3 interactions, d=64, 300 RBF, cutoff 10 Å —
the port of ``repro/configs/schnet.py``.

Geometric: nodes are atom types, positions drive the continuous-filter conv.
Non-molecular shapes get synthetic positions."""
import numpy as np
import torch

from ..core.table import resolve_device
from ..models import gnn as G
from .common_gnn import gnn_spec

ARCH_ID = "schnet"


def make_cfg(info):
    return G.SchNetConfig(name=ARCH_ID, n_interactions=3, d_hidden=64,
                          n_rbf=300, cutoff=10.0)


def smoke(device="cuda"):
    device = resolve_device(device)
    cfg = G.SchNetConfig(name=ARCH_ID, n_interactions=2, d_hidden=16, n_rbf=20)
    params = G.schnet_init(torch.Generator(device=device).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    g = G.Graph(nodes=t(rng.integers(1, 10, (60, 1)).astype(np.int32)),
                senders=t(rng.integers(0, 60, 128).astype(np.int32)),
                receivers=t(rng.integers(0, 60, 128).astype(np.int32)),
                positions=t(rng.standard_normal((60, 3)).astype(np.float32)),
                graph_ids=t((np.arange(60) // 30).astype(np.int32)),
                n_graphs=2)
    e = G.schnet_apply(params, cfg, g)
    if e.shape != (2, 1) or bool(torch.isnan(e).any()):
        raise AssertionError(f"schnet smoke: energies {e}")
    return {"energy_shape": tuple(e.shape)}


SPEC = gnn_spec(ARCH_ID, make_cfg, G.schnet_init, G.schnet_apply,
                "graph_reg", smoke)
