"""xDeepFM (CIN + DNN + linear) with an EmbeddingBag built from a gather and
a segment sum — the port of ``repro/models/recsys.py``.

:func:`embedding_bag` is ``nn.EmbeddingBag``'s function as the reference
builds it (``recsys.py:59-82``): the rows of the bags' ids gathered from the
table, summed into their bags by ``kernels.ops.segment_reduce`` (the CUDA
segment-sum kernel, #4, on the card; ``ref.ref_segment_matmul`` on the
CPU), the choice the port's GNNs make (ROADMAP queue 3 item 7).
:func:`xdeepfm_apply` and :func:`retrieval_scores` look each field's id up
with a plain gather (``index_select``), as the reference does with
``jnp.take``: one id a field and row has no sum to make.

Table ids must lie in ``[0, vocab)``: ``jnp.take`` fills an id past the
table with NaN and wraps a negative one, where the port's gather raises on
the CPU (the synthetic stream, ``data/pipeline.recsys_batches``, takes ids
modulo the field's vocabulary).  Bag ids outside ``[0, num_bags)`` are
dropped, as the reference drops them.

CIN (``_cin``): with X^0 ``(B, m, D)`` field embeddings and X^k ``(B, H_k,
D)``, ``X^{k+1}[b,h,d] = sum_{i,j} W^k[h,i,j] X^0[b,i,d] X^k[b,j,d]``.  The
reference contracts ``W`` with ``X^0`` first, which materialises ``(B, H,
H_k, D)`` (despite its docstring's claim); here the outer product ``z[b, d,
i, j] = X^0[b,i,d] X^k[b,j,d]`` comes first, ``(B, D, m, H_k)``, the
smallest intermediate any order leaves (m = 39 < H = 200), and one matrix
product with ``W`` as ``(H, m H_k)`` compresses it.  Rows are independent,
so :func:`_cin` runs in chunks of :data:`CIN_CHUNK` rows, which changes
nothing of the function.  Under autograd each chunk runs under
``torch.utils.checkpoint``: its outer products are recomputed in the
backward rather than kept (at ``train_batch``'s 65,536 rows they would
hold 44.9 GB), and the values and gradients are the same bits as one pass
that keeps them.  Serving records no gradient and checkpoints nothing.  The two orders sum the same products in
different orders: float32 results agree within rounding
(``tests/test_torch_recsys.py`` states the tolerance).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import segment_reduce
from .layers import linear, linear_init, mlp, mlp_init

__all__ = ["XDeepFMConfig", "xdeepfm_init", "xdeepfm_apply", "embedding_bag",
           "retrieval_scores", "bce_loss", "CIN_CHUNK"]

# Rows of one CIN pass.  The outer product z is 4 D m H_k bytes a row in
# float32: 4 x 10 x 39 x 200 = 312,000 at the published widths, so 2^15
# rows hold 10.2 GB a layer (82 GB at serve_bulk's 262,144 rows at once,
# and 419 GB for the reference's (B, H, H_k, D) order).
CIN_CHUNK = 1 << 15


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_dims: tuple = (400, 400)
    vocab_sizes: Optional[tuple] = None  # per-field; default heavy-tailed mix
    dtype: torch.dtype = torch.float32

    def field_vocabs(self) -> Tuple[int, ...]:
        if self.vocab_sizes is not None:
            return tuple(self.vocab_sizes)
        # Criteo-like heavy tail: a few huge fields, many small ones
        sizes = []
        for i in range(self.n_sparse):
            if i % 13 == 0:
                sizes.append(10_000_000)
            elif i % 5 == 0:
                sizes.append(1_000_000)
            elif i % 3 == 0:
                sizes.append(100_000)
            else:
                sizes.append(10_000)
        return tuple(sizes)


def embedding_bag(
    table: torch.Tensor,
    indices: torch.Tensor,
    bag_ids: torch.Tensor,
    num_bags: int,
    weights: Optional[torch.Tensor] = None,
    mode: str = "sum",
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """``nn.EmbeddingBag`` from a gather and a segment sum.

    table ``(V, D)``; indices ``(nnz,)`` row ids in ``[0, V)``; bag_ids
    ``(nnz,)`` the bag of each index (sorted or not; ids outside ``[0,
    num_bags)`` dropped); ``weights`` scale each row; ``mode="mean"``
    divides each bag by its count of ids, at least 1.  Returns ``(num_bags,
    D)`` in the table's type.  ``backend`` picks the segment sum
    (``kernels.ops``)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"unknown embedding_bag mode {mode!r}")
    rows = table.index_select(0, indices)
    if weights is not None:
        rows = rows * weights[:, None]
    seg = bag_ids.to(torch.int32)
    out = segment_reduce(rows, seg, num_bags, backend=backend)
    if mode == "mean":
        ones = torch.ones(seg.shape[0], 1, dtype=table.dtype, device=table.device)
        cnt = segment_reduce(ones, seg, num_bags, backend=backend)
        out = out / torch.clamp(cnt, min=1)
    return out.to(table.dtype)


def xdeepfm_init(gen: torch.Generator, cfg: XDeepFMConfig) -> Dict:
    """The reference's initialisers on the generator's device: tables and
    linear weights normal times 0.01, CIN kernels ``(H, m, H_prev)`` normal
    times ``sqrt(2 / (m H_prev))``, the CIN output and the MLP
    ``dense_init``, the bias 0."""
    dev, dt = gen.device, cfg.dtype
    vocabs = cfg.field_vocabs()

    def normal(*shape):
        return torch.randn(*shape, generator=gen, dtype=dt, device=dev)

    tables = {f"f{i}": normal(v, cfg.embed_dim).mul_(0.01)
              for i, v in enumerate(vocabs)}
    cin = []
    h_prev = cfg.n_sparse
    for h in cfg.cin_layers:
        cin.append(normal(h, cfg.n_sparse, h_prev).mul_(
            (2.0 / (cfg.n_sparse * h_prev)) ** 0.5))
        h_prev = h
    d_flat = cfg.n_sparse * cfg.embed_dim
    return {
        "tables": tables,
        "linear": {f"f{i}": normal(v, 1).mul_(0.01) for i, v in enumerate(vocabs)},
        "cin": cin,
        "cin_out": linear_init(gen, sum(cfg.cin_layers), 1, dtype=dt),
        "mlp": mlp_init(gen, [d_flat, *cfg.mlp_dims, 1], dtype=dt),
        "bias": torch.zeros((), dtype=dt, device=dev),
    }


def _cin_rows(p_cin: List[torch.Tensor], x0: torch.Tensor) -> torch.Tensor:
    """The CIN's pooled features ``(B, sum H)`` of ``x0 (B, m, D)``."""
    b, m, d = x0.shape
    x0t = x0.transpose(1, 2)                       # (B, D, m)
    xt = x0t                                       # X^k as (B, D, H_k)
    pooled = []
    for w in p_cin:                                # (H, m, H_k)
        h, _, hk = w.shape
        z = (x0t[..., :, None] * xt[..., None, :]).reshape(b * d, m * hk)
        xt = (z @ w.reshape(h, m * hk).T).view(b, d, h)
        del z  # before the next layer's: one outer product alive at a time
        pooled.append(xt.sum(dim=1))               # (B, H): sum over D
    return torch.cat(pooled, dim=-1)


def _cin(p_cin: List[torch.Tensor], cin_out: Dict, x0: torch.Tensor) -> torch.Tensor:
    """x0 ``(B, m, D)`` -> the CIN logit ``(B, 1)``, :data:`CIN_CHUNK` rows
    a pass, each recomputed in the backward where autograd records."""
    rows = _cin_rows
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x0, *p_cin)):
        rows = lambda p, x: checkpoint(_cin_rows, p, x, use_reentrant=False,  # noqa: E731
                                       preserve_rng_state=False)
    pooled = torch.cat([rows(p_cin, x0[s:s + CIN_CHUNK])
                        for s in range(0, x0.shape[0], CIN_CHUNK)])
    return linear(cin_out, pooled)


def _lookup(tables: Dict[str, torch.Tensor], ids: torch.Tensor) -> List[torch.Tensor]:
    """Each field's rows ``(B, D_table)``: ``ids[:, i]`` gathered from
    field ``i``'s table."""
    return [tables[f"f{i}"].index_select(0, ids[:, i]) for i in range(ids.shape[1])]


def xdeepfm_apply(p: Dict, cfg: XDeepFMConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    """sparse_ids ``(B, n_sparse)``, one id per field -> logits ``(B,)``:
    the linear term, the CIN logit and the DNN's, plus the bias."""
    b = sparse_ids.shape[0]
    embs = torch.stack(_lookup(p["tables"], sparse_ids), dim=1)  # (B, m, D)
    lin = sum(_lookup(p["linear"], sparse_ids))                  # (B, 1)
    cin_logit = _cin(p["cin"], p["cin_out"], embs)
    deep = mlp(p["mlp"], embs.reshape(b, -1), act=F.relu)
    return (lin + cin_logit + deep)[:, 0] + p["bias"]


def retrieval_scores(p: Dict, cfg: XDeepFMConfig, query_ids: torch.Tensor,
                     candidate_emb: torch.Tensor) -> torch.Tensor:
    """One query against ``n_cand`` candidates as one ``(B, D) @ (D,
    n_cand)`` product: the query tower is the mean field embedding,
    candidates are item embeddings ``(n_cand, D)``."""
    q = torch.stack(_lookup(p["tables"], query_ids), dim=1).mean(dim=1)
    return q @ candidate_emb.T


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits, in float32 (``recsys.py:163``)."""
    logits = logits.to(torch.float32)
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))
