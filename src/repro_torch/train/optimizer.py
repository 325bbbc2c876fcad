"""AdamW and its learning-rate schedules — the port of
``repro/train/optimizer.py`` (pure pytree functions there, no optax).

AdamW with decoupled weight decay; schedules: linear-warmup cosine and WSD
(Warmup–Stable–Decay, the MiniCPM schedule [arXiv:2404.06395]), which holds
a constant plateau after warmup and decays only in the final fraction.

Trees are dicts (and lists, tuples) of tensors, walked in
``jax.tree_util``'s order by ``checkpoint.tree_flatten``.  The math runs in
float32 and is cast back to each leaf's type (``optimizer.py:109-117``),
a leaf over :data:`ADAMW_SLICE` elements in slices of its leading axis;
:func:`adamw_update` writes the parameters and the moments in place under
``torch.no_grad`` (the counterpart of the reference's donated buffers) and
returns the same objects.  The step, the learning rate, the bias
corrections and the global norm stay on the device as 0-d tensors: no call
here reads a device value to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from .checkpoint import tree_flatten, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "wsd_schedule", "make_schedule", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    schedule: str = "cosine"        # "cosine" | "wsd" | "constant"
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_fraction: float = 0.1     # WSD: final fraction spent decaying
    state_dtype: str = "float32"    # "bfloat16" halves the moments' memory;
                                    # the math still runs in float32


# Elements of a leaf that AdamW's float32 math takes at a time: a larger
# leaf runs in slices of its leading axis.  The math is elementwise, so the
# result is the same bits; the float32 temporaries (the gradient's copy,
# the moments' quotients, the weight's copy and its decay term) shrink to a
# slice's.  On an H100 80GB HBM3 (700 W), mixtral-8x7b at full width and 3
# layers holds 55.5 GB of state before the update, and its stacked expert
# leaves (1.41 B elements) took 22.5 GB of temporaries whole: out of memory
# at the second step.
ADAMW_SLICE = 1 << 28


def _slices(leaf: torch.Tensor):
    """``(start, stop)`` ranges of the leading axis, each at most
    :data:`ADAMW_SLICE` elements (at least one row); one range for a small
    or 0-d leaf."""
    n = leaf.shape[0] if leaf.dim() else 1
    if leaf.numel() <= ADAMW_SLICE or n == 1:
        return [(0, n)]
    rows = max(1, ADAMW_SLICE * n // leaf.numel())
    return [(a, min(a + rows, n)) for a in range(0, n, rows)]


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together, float32, on the leaves' device."""
    leaves = tree_flatten(tree)[0]
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in leaves))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf in place by ``min(1, max_norm / norm)`` (in float32,
    cast back to the leaf's type).  Returns ``(tree, norm)``, the norm before
    scaling."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    for leaf in tree_flatten(tree)[0]:
        leaf.mul_(scale)
    return tree, n


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(prog, 0, 1)))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)
    return lr


def wsd_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Warmup -> stable plateau -> short decay (MiniCPM WSD)."""
    decay_steps = int(cfg.total_steps * cfg.decay_fraction)
    stable_end = cfg.total_steps - decay_steps

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        decay_prog = (step - stable_end) / max(decay_steps, 1)
        # 10 ** (-prog) spans one decade, as the reference's
        decay = torch.pow(10.0, -torch.clamp(decay_prog, 0, 1))
        val = torch.where(step < cfg.warmup_steps, warm,
                          torch.where(step < stable_end, 1.0, decay))
        return cfg.lr * val
    return lr


def make_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    if cfg.schedule == "cosine":
        return cosine_schedule(cfg)
    if cfg.schedule == "wsd":
        return wsd_schedule(cfg)
    return lambda step: torch.full((), cfg.lr, dtype=torch.float32,
                                   device=step.device)


def adamw_init(params, state_dtype: str = "float32") -> Dict:
    """``{"step": 0, "m": zeros, "v": zeros}``, the moments in
    ``state_dtype`` on each parameter's device, the step a 0-d int32 tensor
    on the first parameter's."""
    dt = getattr(torch, state_dtype)
    leaves, treedef = tree_flatten(params)
    zeros = lambda: tree_unflatten(treedef, [  # noqa: E731
        torch.zeros(p.shape, dtype=dt, device=p.device) for p in leaves])
    return {"step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            "m": zeros(), "v": zeros()}


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig) -> Tuple:
    """One AdamW step, in place: the gradients are clipped, the step
    advanced, the moments and parameters written.  Returns ``(params,
    state, {"lr", "grad_norm"})`` (the same tree objects, updated)."""
    sched = make_schedule(cfg)
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    state["step"].add_(1)
    step = state["step"].to(torch.float32)
    lr = sched(state["step"])
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step)
    bc2 = 1 - torch.pow(b2, step)
    flat = [tree_flatten(t)[0] for t in (grads, state["m"], state["v"], params)]
    for leaves in zip(*flat):
        for a, b in _slices(leaves[3]):
            g, m, v, p = (x[a:b] if x.dim() else x for x in leaves)
            _adamw_math(g, m, v, p, cfg, lr, bc1, bc2)
    return params, state, {"lr": lr, "grad_norm": gnorm}


def _adamw_math(g, m, v, p, cfg: AdamWConfig, lr, bc1, bc2) -> None:
    """The reference's ``upd()``, term for term, on one leaf or a slice of
    one, written in place: ``.to(float32)`` of a float32 tensor is the
    tensor itself, so float32 moments and weights update where they lie."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = g.to(torch.float32)
    m32 = m.to(torch.float32).mul_(b1).add_(g32 * (1 - b1))
    v32 = v.to(torch.float32).mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
    del g32
    delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
    p32 = p.to(torch.float32)
    delta.add_(cfg.weight_decay * p32)
    p32.sub_(delta.mul_(lr))
    for dst, src in ((m, m32), (v, v32), (p, p32)):
        if dst is not src:
            dst.copy_(src)
