"""Mixture-of-experts layer with sort-based dispatch — the port of
``repro/models/moe.py``.

Top-k routing is a group-by: the (token, pick) rows are sorted by expert
id, each row's rank in its expert's group is its slot, and the rows are
gathered into per-expert buffers of a static capacity ``C``; rows past
``C`` are dropped and counted.  The combine, each expert output scaled by
its gate and summed back onto its token, is exactly the segment sum of
kernel #4: it runs through ``kernels.ops.segment_reduce`` (the CUDA
segment-sum kernel on the card, ``ref.ref_segment_matmul`` on the CPU),
under autograd as its ``SegmentSum`` Function.

:func:`moe_apply` is the reference's function step by step:

* the capacity (:func:`_capacity`) is the reference's host arithmetic on
  the token count, never read from a tensor;
* top-k takes the first ``K`` of a stable descending sort of the float32
  router logits, so a tie goes to the lower expert index, as
  ``jax.lax.top_k`` breaks it (``torch.topk`` makes no promise);
* the group-by is a stable ``argsort`` of the flat expert ids and a
  fill-forward of the group starts (``torch.cummax``, the reference's
  ``associative_scan(max)``); dropped rows all write the overflow slot
  ``E * C``, which is cut;
* the expert SwiGLU is batched over the leading ``E`` axis
  (``torch.matmul``, where the reference ``vmap``s ``swiglu`` outside any
  kernel);
* the combine sums in float32 and casts to the input's type (the reference
  adds in the input's type: with ``top_k = 2`` a token's two rows give one
  rounding either way).

Nothing in the layer waits for the host: no ``.item()``, no boolean-mask
indexing, no ``nonzero``; the dropped count and the auxiliary loss stay
0-d device tensors.  :func:`moe_apply_grouped` runs ``G`` independent
dispatches at once (the reference's ``"batched"`` dispatch, a ``vmap`` of
:func:`moe_apply` over sequences) as batched tensor ops.

Parameters are the reference's nested tree (``{"router": {"w"},
"experts": {"gate", "up", "down"}: {"w"}, ["dense_residual": ...]}``,
expert weights with a leading ``E`` axis), drawn by :func:`moe_init` with
a ``torch.Generator`` where they will live.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..kernels.ops import segment_reduce
from .layers import dense_init, swiglu

__all__ = ["MoEConfig", "moe_init", "moe_apply", "moe_apply_grouped", "route"]

DISPATCHES = ("global", "batched")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig``.  ``dispatch`` is ``"global"`` (one
    sort over all of a call's tokens) or ``"batched"`` (one dispatch per
    sequence).  ``weight_pspecs`` is accepted and ignored: it is only a
    sharding constraint on the expert weights, dropped as the port drops
    the transformer's ``act_pspec``."""
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    dense_residual_d_ff: Optional[int] = None  # arctic: parallel dense branch
    dispatch: str = "global"
    weight_pspecs: Optional[dict] = None

    def __post_init__(self):
        if self.dispatch not in DISPATCHES:
            raise ValueError(f"unknown dispatch {self.dispatch!r}; expected one of "
                             f"{DISPATCHES}")


def _swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, *lead: int,
                 dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    return {"gate": {"w": dense_init(gen, d_model, d_ff, *lead, dtype=dtype)},
            "up": {"w": dense_init(gen, d_model, d_ff, *lead, dtype=dtype)},
            "down": {"w": dense_init(gen, d_ff, d_model, *lead, dtype=dtype)}}


def moe_init(gen: torch.Generator, cfg: MoEConfig, d_model: int,
             dtype=torch.float32) -> Dict:
    """The reference's initialisers on the generator's device: the router
    ``dense_init`` ``(d, E)``, each expert a SwiGLU with a leading ``E``
    axis, and the dense residual's SwiGLU when ``dense_residual_d_ff``."""
    p = {"router": {"w": dense_init(gen, d_model, cfg.n_experts, dtype=dtype)},
         "experts": _swiglu_init(gen, d_model, cfg.d_ff, cfg.n_experts, dtype=dtype)}
    if cfg.dense_residual_d_ff:
        p["dense_residual"] = _swiglu_init(gen, d_model, cfg.dense_residual_d_ff,
                                           dtype=dtype)
    return p


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert (``moe.py:70-72``): ``T k / E`` times the capacity
    factor, plus one, rounded up to 8, at least 8."""
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    return max(8, -(-c // 8) * 8)


def route(p: Dict, cfg: MoEConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router: ``(logits, gates, top_e)`` for tokens ``x (..., d)``:
    float32 logits ``(..., E)`` of the product in x's type, the top
    ``K`` experts ``(..., K)`` int64 with ties to the lower index (a stable
    descending sort, ``jax.lax.top_k``'s order), and their softmax gates in
    x's type."""
    logits = (x @ p["router"]["w"]).to(torch.float32)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_e = idx[..., :cfg.top_k]
    gates = torch.softmax(vals[..., :cfg.top_k], dim=-1).to(x.dtype)
    return logits, gates, top_e


def _experts(p: Dict, xin: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its buffer: ``xin (E, N, d)`` -> ``(E, N,
    d)``."""
    e = p["experts"]
    return swiglu(xin, e["gate"]["w"], e["up"]["w"], e["down"]["w"])


def moe_apply_grouped(p: Dict, cfg: MoEConfig, x: torch.Tensor, *,
                      backend: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """``G`` independent dispatches: x ``(G, T, d)`` -> ``(out (G, T, d),
    {"dropped_tokens", "aux_loss"})``, each group routed, grouped by expert
    at the capacity of ``T`` tokens and combined as :func:`moe_apply`
    routes one; the dropped rows summed over the groups and the auxiliary
    losses averaged (``transformer.py:276-280``).  ``backend`` picks the
    combine's segment sum (``kernels.ops``)."""
    G, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    dev = x.device

    logits, gates, top_e = route(p, cfg, x)                   # (G, T, K)

    # ---- sort-based group-by expert: stable, so ties keep token order
    flat_e = top_e.reshape(G, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = order // K                                         # token of each row
    sgate = torch.gather(gates.reshape(G, T * K), 1, order)
    rows = torch.arange(T * K, device=dev)
    first = torch.ones_like(se, dtype=torch.bool)
    first[:, 1:] = se[:, 1:] != se[:, :-1]
    starts = torch.cummax(torch.where(first, rows, 0), dim=1).values
    pos = rows - starts                                       # rank in group
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)             # overflow slot

    # ---- per-expert buffers; the overflow slot is cut
    def buffer(src, dtype):
        return torch.zeros(G, E * C + 1, dtype=dtype, device=dev).scatter_(
            1, slot, src.to(dtype))[:, :-1]

    buf_tok = buffer(stok, torch.int64)
    buf_gate = buffer(sgate, x.dtype)
    buf_live = buffer(keep, torch.bool)
    tok = buf_tok + (torch.arange(G, device=dev) * T)[:, None]  # into (G * T)
    xin = torch.where(buf_live[..., None],
                      x.reshape(G * T, d).index_select(0, tok.reshape(-1))
                      .view(G, E * C, d), 0)
    # (G, E, C, d) -> (E, G * C, d): one batched product per expert
    xin = xin.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    yout = _experts(p, xin).reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # ---- combine: each live row, scaled by its gate, summed onto its token
    contrib = yout * buf_gate[..., None]
    ids = torch.where(buf_live, tok, G * T).to(torch.int32)
    out = segment_reduce(contrib.reshape(G * E * C, d), ids.reshape(-1), G * T,
                         backend=backend).to(x.dtype).reshape(G, T, d)

    if cfg.dense_residual_d_ff:
        r = p["dense_residual"]
        out = out + swiglu(x, r["gate"]["w"], r["up"]["w"], r["down"]["w"])

    dropped = (~keep).sum().to(torch.int32)
    # load-balancing auxiliary loss (Switch): E * sum_e(f_e * p_e) a group
    me = torch.softmax(logits, dim=-1).mean(dim=1)            # (G, E)
    ce = torch.zeros(G, E, dtype=torch.float32, device=dev).scatter_add_(
        1, top_e[..., 0], torch.ones(G, T, dtype=torch.float32, device=dev)) / T
    aux = (E * (me * ce).sum(dim=-1)).mean()
    return out, {"dropped_tokens": dropped, "aux_loss": aux}


def moe_apply(p: Dict, cfg: MoEConfig, x: torch.Tensor, *,
              backend: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """x ``(T, d)`` token-major -> ``(out (T, d), {"dropped_tokens",
    "aux_loss"})``: one dispatch over all ``T`` tokens (``moe.py:75``)."""
    out, metrics = moe_apply_grouped(p, cfg, x[None], backend=backend)
    return out[0], metrics
