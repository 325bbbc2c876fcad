"""Layers of the models — the port of ``repro/models/layers.py``
(``dense``, ``rmsnorm``, ``swiglu``, ``layernorm``, ``mlp``, their
initialisers and ``cross_entropy_loss``).

The reference's layers are (init, apply) pairs over dicts of arrays.  The
dense decoder's apply functions here take the weight tensors themselves
(``dense``, ``rmsnorm``, ``swiglu``); the GNNs' keep the reference's dicts
(``linear`` over ``{"w", ["b"]}``, ``layernorm`` over ``{"g", "b"}``,
``mlp`` over ``{"l0", "l1", ...}``), so a GNN's parameter tree crosses
from the reference unchanged and ``train/checkpoint.py::tree_flatten``
walks it in ``jax.tree_util``'s order.  The initialisers draw with a
``torch.Generator`` where the weights will live.  Weights keep the
reference's layout: a dense weight is ``(d_in, d_out)`` and ``y = x @ w``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["dense", "rmsnorm", "swiglu", "dense_init", "embedding_init",
           "cross_entropy_loss", "linear_init", "linear", "layernorm_init",
           "layernorm", "mlp_init", "mlp"]


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)``; w is ``(d_in, d_out)``."""
    y = x @ w
    return y if b is None else y + b


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalisation with the reference's cast points
    (``layers.py:52-55``): normalise in float32, cast back to x's type,
    then scale by ``g``."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * g


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``down(silu(gate(x)) * up(x))``."""
    return dense(F.silu(dense(x, w_gate)) * dense(x, w_up), w_down)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *lead: int,
               dtype=torch.float32) -> torch.Tensor:
    """Normal weights times ``1 / sqrt(d_in)``, drawn and scaled in
    ``dtype`` on the generator's device, of shape ``(*lead, d_in, d_out)``
    (``lead`` stacks layers)."""
    w = torch.randn(*lead, d_in, d_out, generator=gen, dtype=dtype,
                    device=gen.device)
    return w.mul_(1.0 / math.sqrt(d_in))


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Normal embedding table times 0.02, ``(vocab, d)``."""
    return torch.randn(vocab, d, generator=gen, dtype=dtype,
                       device=gen.device).mul_(0.02)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's ``dense_init`` (``layers.py:33``): ``{"w"}``, normal
    times ``1 / sqrt(d_in)``, and with ``bias`` a zero ``"b"``."""
    p = {"w": dense_init(gen, d_in, d_out, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The reference's ``dense`` over its dict: ``x @ p["w"] (+ p["b"])``."""
    return dense(x, p["w"], p.get("b"))


def layernorm_init(d: int, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    return {"g": torch.ones(d, dtype=dtype, device=device),
            "b": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(p: Dict[str, torch.Tensor], x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer normalisation as the reference's (``layers.py:62-66``): in
    float32, the population variance (``jnp.var``; ``torch.var``'s default
    is the unbiased one), cast back to x's type, then ``* g + b``."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * p["g"] + p["b"]


def mlp_init(gen: torch.Generator, dims: Sequence[int], *, bias: bool = True,
             dtype=torch.float32) -> Dict[str, Dict[str, torch.Tensor]]:
    """Plain MLP, ``dims = [d_in, h1, ..., d_out]``: ``{"l0", "l1", ...}``."""
    return {f"l{i}": linear_init(gen, dims[i], dims[i + 1], bias=bias, dtype=dtype)
            for i in range(len(dims) - 1)}


def mlp(p: Dict, x: torch.Tensor, act: Callable = F.silu,
        final_act: bool = False) -> torch.Tensor:
    """``act`` after every layer but the last (and after it too with
    ``final_act``)."""
    n = len(p)
    for i in range(n):
        x = linear(p[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in float32 (``layers.py:125``): logits
    ``(..., V)``, integer labels ``(...)``; with ``mask``, the masked mean
    over at least one token.  A 0-d float32 tensor on the logits' device."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
