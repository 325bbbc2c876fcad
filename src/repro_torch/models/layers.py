"""Layers of the dense decoder — the port of ``repro/models/layers.py``
(``dense``, ``rmsnorm``, ``swiglu``, their initialisers and
``cross_entropy_loss``).

The reference's layers are (init, apply) pairs over dicts of arrays; here
the apply functions take the weight tensors themselves, and the
initialisers draw them with a ``torch.Generator`` where they will live.
Weights keep the reference's layout: a dense weight is ``(d_in, d_out)``
and ``y = x @ w``, so weights cross from the reference unchanged.
``layernorm`` and ``mlp`` come with the GNN slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["dense", "rmsnorm", "swiglu", "dense_init", "embedding_init",
           "cross_entropy_loss"]


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
