"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed 10, CIN 200-200-200,
MLP 400-400 — the port of ``repro/configs/xdeepfm.py``.

Embedding tables are the hot path: 38,190,000 rows x (10 + 1) float32,
1.68 GB, one gathered row per field and row (``models/recsys.py``; its
``embedding_bag``, for bags of many ids, runs on the segment-sum kernel).  Shapes: train 65,536 / online
512 / offline 262,144 / retrieval 1 x 10^6 (padded to 2^20).

``SPEC`` is the reference's ``ArchSpec``: :func:`build_cell` for the four
shapes, the parameters (and, to train, AdamW's state) on the meta device
with their partition specs (:func:`_param_pspecs`: the tables' and linear
weights' rows over the tp axis).  The ``train_batch`` step is the
reference's body: ``bce_loss(xdeepfm_apply(...))``, its gradient with
respect to every parameter (a table's is dense, autograd's ``index_add_``
of the gathered rows' gradients, as ``jnp.take``'s is a scatter-add; the
CIN's chunks recomputed in the backward, ``recsys._cin``) and AdamW under
:data:`OPT` in place.  :func:`serve_fn` gives the serve step of each serve
shape (``serve_p99``, ``serve_bulk``: the click probabilities, the CIN in
chunks of ``recsys.CIN_CHUNK`` rows; ``retrieval_cand``: the scores of one
query against the candidates), which is the serve cells' step.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.table import resolve_device
from ..models.recsys import (XDeepFMConfig, bce_loss, retrieval_scores,
                             xdeepfm_apply, xdeepfm_init)
from ..train.optimizer import AdamWConfig
from .common import (ArchSpec, Cell, MeshAxes, abstract_adamw, abstract_init,
                     adamw_pspecs, meta_tensor, train_step_fn, tree_map_with_key)

ARCH_ID = "xdeepfm"

SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="serve", batch=1, n_cand=1_048_576,
                           raw="n_candidates=1,000,000 (padded to 2^20)"),
}

CFG = XDeepFMConfig(name=ARCH_ID, n_sparse=39, embed_dim=10,
                    cin_layers=(200, 200, 200), mlp_dims=(400, 400))

OPT = AdamWConfig(lr=1e-3, schedule="cosine", total_steps=20_000,
                  weight_decay=1e-5)


def serve_fn(shape: str) -> Callable:
    """The serve step of ``shape``: ``(params, ids) -> sigmoid(logits)``,
    or for ``retrieval_cand`` ``(params, ids, cand) -> scores (1,
    n_cand)``."""
    if SHAPES[shape]["kind"] != "serve":
        raise ValueError(f"{shape} is not a serve shape")
    if shape == "retrieval_cand":
        return lambda params, ids, cand: retrieval_scores(params, CFG, ids, cand)
    return lambda params, ids: torch.sigmoid(xdeepfm_apply(params, CFG, ids))


def _param_pspecs(mp: MeshAxes, a_params):
    tp = mp.tp_axis

    def spec(key, leaf):
        if "tables/" in key or "linear/" in key:
            return (tp, None)  # shard the huge vocab rows
        return (None,) * leaf.dim()

    return tree_map_with_key(spec, a_params)


def build_cell(shape: str, mp: MeshAxes) -> Optional[Cell]:
    info = SHAPES[shape]
    a_params = abstract_init(xdeepfm_init, CFG)
    p_specs = _param_pspecs(mp, a_params)
    B = info["batch"]
    a_ids = meta_tensor((B, CFG.n_sparse), torch.int32)
    ids_spec = (mp.dp, None) if B > 1 else (None, None)

    if info["kind"] == "train":
        step = train_step_fn(lambda p, ids, labels: (
            bce_loss(xdeepfm_apply(p, CFG, ids), labels), {}), OPT)
        return Cell(arch=ARCH_ID, shape=shape, kind="train", step_fn=step,
                    abstract_args=(a_params, abstract_adamw(a_params), a_ids,
                                   meta_tensor((B,), torch.float32)),
                    arg_pspecs=(p_specs, adamw_pspecs(p_specs), ids_spec, (mp.dp,)),
                    donate=(0, 1))

    if shape == "retrieval_cand":
        return Cell(arch=ARCH_ID, shape=shape, kind="serve", step_fn=serve_fn(shape),
                    abstract_args=(a_params, a_ids,
                                   meta_tensor((info["n_cand"], CFG.embed_dim), torch.float32)),
                    arg_pspecs=(p_specs, ids_spec, (mp.all_axes, None)),
                    note=info.get("raw", ""))

    return Cell(arch=ARCH_ID, shape=shape, kind="serve", step_fn=serve_fn(shape),
                abstract_args=(a_params, a_ids), arg_pspecs=(p_specs, ids_spec))


def smoke(device="cuda"):
    """The reference's smoke test at its sizes (6 fields of 64 ids, embed 8,
    CIN 16-16, MLP 32), weights drawn from seed 0 on ``device``, inputs
    from numpy's seed 0: logits, a finite loss, retrieval scores."""
    device = resolve_device(device)
    cfg = XDeepFMConfig(name=ARCH_ID + "-smoke", n_sparse=6, embed_dim=8,
                        cin_layers=(16, 16), mlp_dims=(32,),
                        vocab_sizes=(64,) * 6)
    params = xdeepfm_init(torch.Generator(device=device).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 64, (16, 6)).astype(np.int32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 2, 16).astype(np.float32)).to(device)
    logits = xdeepfm_apply(params, cfg, ids)
    loss = bce_loss(logits, labels)
    if logits.shape != (16,) or bool(torch.isnan(loss)):
        raise AssertionError(f"xdeepfm smoke: logits {tuple(logits.shape)}, "
                             f"loss {loss}")
    cand = torch.from_numpy(rng.standard_normal((256, 8)).astype(np.float32)).to(device)
    scores = retrieval_scores(params, cfg, ids[:1], cand)
    if scores.shape != (1, 256):
        raise AssertionError(f"xdeepfm smoke: scores {tuple(scores.shape)}")
    return {"loss": float(loss)}


SPEC = ArchSpec(arch=ARCH_ID, family="recsys", shapes=tuple(SHAPES),
                build_cell=build_cell, smoke=smoke)
