"""pna [arXiv:2004.05718]: 4L d=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation — the port of
``repro/configs/pna.py``."""
import numpy as np
import torch

from ..core.table import resolve_device
from ..models import gnn as G
from .common_gnn import gnn_spec

ARCH_ID = "pna"


def make_cfg(info):
    return G.PNAConfig(name=ARCH_ID, n_layers=4, d_hidden=75,
                       d_in=info["d_feat"], n_out=1)


def smoke(device="cuda"):
    device = resolve_device(device)
    cfg = G.PNAConfig(name=ARCH_ID, n_layers=2, d_hidden=16, d_in=8)
    params = G.pna_init(torch.Generator(device=device).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    g = G.Graph(nodes=t(rng.standard_normal((64, 8)).astype(np.float32)),
                senders=t(rng.integers(0, 64, 256).astype(np.int32)),
                receivers=t(rng.integers(0, 64, 256).astype(np.int32)),
                graph_ids=t((np.arange(64) // 32).astype(np.int32)),
                n_graphs=2)
    out = G.pna_apply(params, cfg, g)
    if out.shape != (2, 1) or bool(torch.isnan(out).any()):
        raise AssertionError(f"pna smoke: outputs {out}")
    return {"out_shape": tuple(out.shape)}


SPEC = gnn_spec(ARCH_ID, make_cfg, G.pna_init, G.pna_apply,
                "graph_reg", smoke)
