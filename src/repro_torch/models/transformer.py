"""The decoder-only transformer, dense and mixture-of-experts — the port of
``repro/models/transformer.py`` for qwen2, minicpm, granite, mixtral and
arctic: training (``forward`` with autograd, remat, :func:`loss_fn`) and
serving.

:class:`Transformer` holds the weights (layers stacked on a leading
``n_layers`` axis, as the reference's pytree holds them) and computes
:meth:`~Transformer.forward`, :meth:`~Transformer.init_kv_cache`,
:meth:`~Transformer.prefill` and :meth:`~Transformer.decode_step`, with the
reference's names and semantics; :func:`loss_fn` is the reference's.
``forward`` is differentiable once the weights require grad (the trainer
marks them); serving runs under ``torch.no_grad``.  With ``cfg.remat``
each layer of a differentiated forward runs under
``torch.utils.checkpoint`` (:func:`_remat`), the counterpart of
``_remat_wrap`` around the reference's scanned body.  A config with
``moe`` set takes the reference's MoE branch in place of the SwiGLU
(``transformer.py:272-285``, :mod:`.moe`): ``"global"`` dispatch over the
call's ``B x L`` tokens, ``"batched"`` one dispatch per sequence; serving
routes the whole step's tokens, as the reference's does.  Differences:

* the KV cache is written in place (the reference returns new arrays), and
  its ``pos`` is a Python int;
* attention on the cache runs on the cut ``cache[:, :, :n]`` of the slots
  written so far, a strided view that the attention kernel reads where it
  lies.  With the query and key ranges' ends aligned, that is exactly the
  reference's ``"xla"`` path (``_gqa_chunked``, which masks the unwritten
  slots by position), a sliding window included: each query keeps the
  keys in ``(pos - window, pos]`` of the cut.  The reference's
  ``"pallas"`` path hands the kernel the whole static cache and attends to
  unwritten zero slots whenever the cache is longer than what was written
  (ROADMAP queue 3 item 6);
* ``forward`` returns the logits; :meth:`~Transformer.forward_with_metrics`
  returns them with the reference's metrics (the MoE auxiliary loss summed
  over the layers and the dropped rows, zeros for a dense model).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.table import resolve_device
from ..kernels.ops import attention
from . import moe as moe_layer
from .layers import (cross_entropy_loss, dense, dense_init, embedding_init,
                     rmsnorm, swiglu)
from .moe import MoEConfig

__all__ = ["TransformerConfig", "Transformer", "weight_shapes", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's ``TransformerConfig`` fields that training and
    serving read.

    Dropped, as the XLA program's alone: ``act_pspec`` (a sharding
    constraint), ``attn_chunk`` and ``attn_mixed_precision`` (the shape and
    precision of ``_gqa_chunked``).  ``remat_policy`` is ``"nothing"`` (a
    layer saves only its input) or ``"dots"`` (it also saves its matrix
    products, as ``dots_with_no_batch_dims_saveable``).  The reference's
    ``attn_backend`` is ``kernel_backend`` here, the port's
    ``auto|torch|cuda`` (``kernels/ops.py``) for every kernel of the
    decoder: the attention kernel and the MoE combine's segment sum, or
    their plain versions.
    """
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False                # qwen2
    sliding_window: Optional[int] = None  # mixtral
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    tie_embeddings: bool = False          # minicpm
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "nothing"         # "nothing" | "dots" — what remat saves
    kernel_backend: str = "auto"          # "auto" | "torch" | "cuda"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def _count(self, experts: int) -> int:
        """Parameters with ``experts`` expert FFNs a layer (the reference's
        formulas, ``transformer.py:76-103``)."""
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        if self.moe:
            ff = 3 * d * self.moe.d_ff * experts + d * self.moe.n_experts
            if self.moe.dense_residual_d_ff:
                ff += 3 * d * self.moe.dense_residual_d_ff
        else:
            ff = 3 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6 N D roofline accounting)."""
        return self._count(self.moe.n_experts if self.moe else 0)

    @property
    def n_active_params(self) -> int:
        """Parameters a token touches (MoE: its ``top_k`` experts only)."""
        return self._count(self.moe.top_k if self.moe else 0)


def _rope_tables(positions: torch.Tensor, d: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of ``transformer.py:160``'s angles, float32 ``(L, 1,
    D/2)`` (broadcast over heads), computed once per call for every layer."""
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=positions.device) / d))
    f = positions.to(torch.float32)[:, None] * inv[None, :]
    return torch.cos(f)[:, None], torch.sin(f)[:, None]


def _rope(x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Rotary embedding as ``transformer.py:160``: split halves, float32,
    cast back.  x ``(B, L, H, D)``."""
    c, s = rope
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# the matrix products a "dots" layer saves: the dense layers' (no batch
# dimension).  Batched products are recomputed: attention's, and a MoE
# layer's experts', whose ``torch.matmul`` over the leading E axis is
# ``aten.bmm``.  A MoE layer's recomputed forward routes as the first did
# (the same stable sorts, slots and combine ids from the same inputs), so
# remat changes no bit of its gradients.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: TransformerConfig, block, *args):
    """``block(*args)`` under activation checkpointing (``_remat_wrap``):
    ``"nothing"`` keeps only the layer's inputs and recomputes the rest in
    the backward; ``"dots"`` is a selective checkpoint that also keeps the
    dense products.  No randomness runs inside a layer, so no RNG state is
    saved."""
    if cfg.remat_policy not in ("nothing", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)
    return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False,
                      **kw)


class Transformer(nn.Module):
    """A decoder's weights on one device, and its functions.

    ``weights`` (named and shaped as :func:`weight_shapes` says, as
    ``convert.transformer_params_from_numpy`` builds them) are taken as
    they are; without them every weight is drawn on ``device`` by a
    ``torch.Generator`` seeded with ``seed``, with the reference's
    initialisers: dense weights (the router and each expert's included)
    normal times ``1 / sqrt(d_in)``, the embedding normal times 0.02, norm
    gains ones, biases zeros.  A full
    model's weights are drawn on the card, never on the host.  The weights
    do not require grad until a trainer marks them
    (``Trainer.init_state``).
    """

    def __init__(self, cfg: TransformerConfig, *, device="cuda", seed: int = 0,
                 weights: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.cfg = cfg
        if weights is None:
            weights = _draw_weights(cfg, resolve_device(device), seed)
        if set(weights) != set(weight_shapes(cfg)):
            raise ValueError(f"weights {sorted(weights)} are not those of "
                             f"{cfg.name}: {sorted(weight_shapes(cfg))}")
        for name, shape in weight_shapes(cfg).items():
            w = weights[name]
            if tuple(w.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(w.shape)}, "
                                 f"{cfg.name} needs {shape}")
            self.register_parameter(name, nn.Parameter(w, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------ training

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens ``(B, L)`` -> logits ``(B, L, V)``; differentiable, with
        each layer under remat when ``cfg.remat`` and autograd records."""
        return self.forward_with_metrics(tokens)[0]

    def forward_with_metrics(self, tokens: torch.Tensor
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's ``forward``: logits and ``{"moe_aux_loss",
        "moe_dropped"}``, the layers' auxiliary losses and dropped rows
        summed (0-d device tensors; zeros for a dense model)."""
        rope = self._rope_tables(0, tokens.shape[1])
        x = self.embed[tokens]
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux, dropped = [], []
        for i, w in enumerate(self._layers()):
            if remat:
                x, m = _remat(self.cfg, self._layer, i, w, x, rope)
            else:
                x, m = self._layer(i, w, x, rope)
            if m is not None:
                aux.append(m["aux_loss"])
                dropped.append(m["dropped_tokens"])
        dev = x.device
        metrics = {
            "moe_aux_loss": (torch.stack(aux).sum() if aux else
                             torch.zeros((), dtype=torch.float32, device=dev)),
            "moe_dropped": (torch.stack(dropped).sum().to(torch.int32) if dropped
                            else torch.zeros((), dtype=torch.int32, device=dev))}
        return self._logits(x), metrics

    # ------------------------------------------------------------- serving

    def init_kv_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """Zeros of the reference's layout, ``(n_layers, B, Hkv, max_len,
        D)`` in ``cfg.dtype``, for ``"k"`` and ``"v"``, on the model's
        device; ``"pos"`` 0."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "pos": 0}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Run the prompt ``(B, Lp)`` through the model, writing its k/v into
        cache slots ``[0, Lp)`` in place.  Returns the last token's logits
        ``(B, V)`` and the cache, its ``pos`` set to ``Lp``."""
        l = tokens.shape[1]
        rope = self._rope_tables(0, l)
        x = self.embed[tokens]
        for i, w in enumerate(self._layers()):
            x, _ = self._layer(i, w, x, rope, cache, 0)
        cache["pos"] = l
        return self._logits(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One incremental step: tokens ``(B,)`` at position ``cache["pos"]``
        -> logits ``(B, V)``; the cache is written in place and its ``pos``
        advanced by one."""
        pos = cache["pos"]
        rope = self._rope_tables(pos, 1)
        x = self.embed[tokens][:, None, :]
        for i, w in enumerate(self._layers()):
            x, _ = self._layer(i, w, x, rope, cache, pos)
        cache["pos"] = pos + 1
        return self._logits(x)[:, 0], cache

    # ------------------------------------------------------------ internals

    def _rope_tables(self, start: int, length: int):
        positions = torch.arange(start, start + length, device=self.device)
        return _rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)

    def _layers(self) -> List[Dict[str, torch.Tensor]]:
        """Each layer's weights by name, views of the stacked parameters.
        One ``unbind`` a parameter gives every layer's view in one autograd
        node, whose backward stacks the layers' gradients once; indexing a
        layer at a time would give each layer's gradient the stacked size."""
        names = [n for n in _LAYER_WEIGHTS if hasattr(self, n)]
        return [dict(zip(names, ws))
                for ws in zip(*(getattr(self, n).unbind(0) for n in names))]

    def _layer(self, i: int, w: Dict[str, torch.Tensor], x: torch.Tensor,
               rope: Tuple[torch.Tensor, torch.Tensor],
               cache: Optional[Dict[str, Any]] = None, pos: int = 0
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """Block ``i`` with weights ``w``; x ``(B, L, d)`` at positions
        ``[pos, pos + L)``, whose rotary tables are ``rope``.  With a cache,
        the new k/v go into slots ``[pos, pos + L)`` and attention reads
        slots ``[0, pos + L)``.  Returns the block's output and, for a MoE
        block, its metrics (None for a dense one)."""
        cfg = self.cfg
        b, l, _ = x.shape
        dh = cfg.head_dim
        h = rmsnorm(x, w["attn_norm"])
        q = dense(h, w["wq"], w.get("bq")).view(b, l, cfg.n_heads, dh)
        k = dense(h, w["wk"], w.get("bk")).view(b, l, cfg.n_kv_heads, dh)
        v = dense(h, w["wv"], w.get("bv")).view(b, l, cfg.n_kv_heads, dh)
        q = _rope(q, rope).transpose(1, 2)
        k = _rope(k, rope).transpose(1, 2)
        v = v.transpose(1, 2)
        if cache is not None:
            end = pos + l
            if end > cache["k"].shape[3]:
                raise ValueError(f"cache of {cache['k'].shape[3]} slots cannot "
                                 f"hold positions [{pos}, {end})")
            ck, cv = cache["k"][i], cache["v"][i]
            ck[:, :, pos:end] = k
            cv[:, :, pos:end] = v
            k, v = ck[:, :, :end], cv[:, :, :end]
        o = attention(q, k, v, causal=True, window=cfg.sliding_window,
                      backend=cfg.kernel_backend)
        x = x + dense(o.transpose(1, 2).reshape(b, l, cfg.n_heads * dh), w["wo"])
        h = rmsnorm(x, w["mlp_norm"])
        if cfg.moe is None:
            return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"]), None
        p = {"router": {"w": w["router"]},
             "experts": {k: {"w": w[f"expert_{k}"]} for k in _SWIGLU}}
        if cfg.moe.dense_residual_d_ff:
            p["dense_residual"] = {k: {"w": w[f"residual_{k}"]} for k in _SWIGLU}
        if cfg.moe.dispatch == "batched":  # one dispatch per sequence
            y, m = moe_layer.moe_apply_grouped(p, cfg.moe, h,
                                               backend=cfg.kernel_backend)
        else:
            y, m = moe_layer.moe_apply(p, cfg.moe, h.reshape(b * l, -1),
                                       backend=cfg.kernel_backend)
            y = y.view(b, l, -1)
        return x + y, m

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_norm)
        if self.cfg.tie_embeddings:
            return x @ self.embed.T
        return dense(x, self.lm_head)


def loss_fn(model: Transformer, tokens: torch.Tensor, labels: torch.Tensor,
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean token cross-entropy of ``model(tokens)`` against ``labels``
    (``transformer.py:313-319``), plus, for a MoE model, ``aux_weight``
    times the layers' auxiliary loss over ``n_layers``; and the reference's
    metrics, the MoE auxiliary loss and dropped rows (zeros for a dense
    model), detached."""
    logits, metrics = model.forward_with_metrics(tokens)
    loss = cross_entropy_loss(logits, labels)
    if model.cfg.moe:
        loss = loss + aux_weight * metrics["moe_aux_loss"] / model.cfg.n_layers
    return loss, {k: v.detach() for k, v in metrics.items()}


_SWIGLU = ("gate", "up", "down")
# the stacked per-layer weights, in :func:`weight_shapes`'s names
_LAYER_WEIGHTS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
                  "w_up", "w_down", "bq", "bk", "bv", "router", "expert_gate",
                  "expert_up", "expert_down", "residual_gate", "residual_up",
                  "residual_down")


def weight_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """The port's weight names and shapes; layer weights stacked on a
    leading ``n_layers`` axis, dense weights ``(d_in, d_out)``.  A MoE
    layer has the router ``(n, d, E)``, the experts' ``expert_{gate,up}``
    ``(n, E, d, f)`` and ``expert_down`` ``(n, E, f, d)``, and with a dense
    residual ``residual_{gate,up,down}``, in place of ``w_{gate,up,down}``."""
    n, d, dh, f = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    shapes = {
        "embed": (cfg.vocab, d),
        "attn_norm": (n, d), "wq": (n, d, hq), "wk": (n, d, hkv),
        "wv": (n, d, hkv), "wo": (n, hq, d), "mlp_norm": (n, d),
    }
    if cfg.moe is None:
        shapes.update(w_gate=(n, d, f), w_up=(n, d, f), w_down=(n, f, d))
    else:
        e, fe, fr = cfg.moe.n_experts, cfg.moe.d_ff, cfg.moe.dense_residual_d_ff
        shapes.update(router=(n, d, e), expert_gate=(n, e, d, fe),
                      expert_up=(n, e, d, fe), expert_down=(n, e, fe, d))
        if fr:
            shapes.update(residual_gate=(n, d, fr), residual_up=(n, d, fr),
                          residual_down=(n, fr, d))
    shapes["final_norm"] = (d,)
    if cfg.qkv_bias:
        shapes.update(bq=(n, hq), bk=(n, hkv), bv=(n, hkv))
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    return shapes


def _draw_weights(cfg: TransformerConfig, device: torch.device,
                  seed: int) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in weight_shapes(cfg).items():
        if name == "embed":
            out[name] = embedding_init(gen, *shape, dtype=cfg.dtype)
        elif name.endswith("norm"):  # gains
            out[name] = torch.ones(shape, dtype=cfg.dtype, device=device)
        elif name in ("bq", "bk", "bv"):
            out[name] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        elif name == "lm_head":
            out[name] = dense_init(gen, *shape, dtype=cfg.dtype)
        else:  # stacked dense weights (n, [E,] d_in, d_out)
            out[name] = dense_init(gen, shape[-2], shape[-1], *shape[:-2],
                                   dtype=cfg.dtype)
    return out
