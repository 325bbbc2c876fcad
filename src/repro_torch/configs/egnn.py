"""egnn [arXiv:2102.09844]: 4L d=64, E(n)-equivariant — the port of
``repro/configs/egnn.py`` (equivariance held in tests/test_torch_gnn.py)."""
import numpy as np
import torch

from ..core.table import resolve_device
from ..models import gnn as G
from .common_gnn import gnn_spec

ARCH_ID = "egnn"


def make_cfg(info):
    return G.EGNNConfig(name=ARCH_ID, n_layers=4, d_hidden=64,
                        d_in=info["d_feat"])


def smoke(device="cuda"):
    device = resolve_device(device)
    cfg = G.EGNNConfig(name=ARCH_ID, n_layers=2, d_hidden=16, d_in=8)
    params = G.egnn_init(torch.Generator(device=device).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    g = G.Graph(nodes=t(rng.standard_normal((64, 8)).astype(np.float32)),
                senders=t(rng.integers(0, 64, 256).astype(np.int32)),
                receivers=t(rng.integers(0, 64, 256).astype(np.int32)),
                positions=t(rng.standard_normal((64, 3)).astype(np.float32)),
                graph_ids=t((np.arange(64) // 32).astype(np.int32)),
                n_graphs=2)
    out, x = G.egnn_apply(params, cfg, g)
    if out.shape != (2, 1) or x.shape != (64, 3) or bool(torch.isnan(out).any()):
        raise AssertionError(f"egnn smoke: outputs {out}, positions {tuple(x.shape)}")
    return {"out_shape": tuple(out.shape)}


SPEC = gnn_spec(ARCH_ID, make_cfg, G.egnn_init, G.egnn_apply,
                "graph_reg", smoke)
