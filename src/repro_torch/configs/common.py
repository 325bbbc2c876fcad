"""Shared config machinery: the ``ArchSpec`` registry's types and the LM
specs and step builders — the port of ``repro/configs/common.py``.

Every ``configs/<arch>.py`` exposes ``SPEC: ArchSpec``.  An ArchSpec knows,
for each of its input shapes, how to build a :class:`Cell`
(``build_cell(shape, mp)``, None where the shape is skipped): the step
function, its abstract arguments and their partition specs; and it runs a
reduced config for real (``smoke(device)``).

* **Abstract arguments are tensors on the ``meta`` device**, the
  counterpart of ``jax.ShapeDtypeStruct``: shapes and types, no storage
  (:func:`abstract_init` draws a parameter tree there).  An LM cell's first
  argument is a :class:`~repro_torch.models.transformer.Transformer` on
  meta weights; its parameters, its AdamW state and its partition specs
  are trees in the reference's nested layout
  (``convert.transformer_param_tree``, :func:`arg_tree`).  A GNN's or
  xDeepFM's cell takes the parameter tree itself.
* **Partition specs are plain tuples**, ``tuple(PartitionSpec(...))`` of
  the reference's: one entry a dimension, each None, an axis name or a
  tuple of names.  Nothing here builds a mesh: distribution over several
  cards (ROADMAP queue 1 item 10) places trees by them.  A spec tree is congruent to its argument's tree, and
  :func:`spec_leaves` flattens it in the argument's leaf order, which is
  ``jax.tree_util``'s (``train/checkpoint.tree_flatten``).
* The step bodies are the reference's.  A train step takes the loss's
  gradient with respect to every parameter (``torch.autograd.grad``; the
  step marks the parameters as requiring grad) and runs AdamW in place
  (``train/optimizer.adamw_update``): it returns the same objects, updated,
  and its metrics as 0-d device tensors, so a step reads nothing back to
  the host.  ``donate`` keeps the reference's indices: in the port every
  step updates those arguments in place.  An LM step runs the model as it
  is given, under its own config (a depth-cut factory, or
  ``kernel_backend="torch"`` for the plain path); the cell's config is the
  abstract model's.  The reference's ``act_pspec`` (a sharding constraint
  on the activations) is dropped, as ``TransformerConfig`` drops it.
* An abstract KV cache's ``"pos"`` is the reference's 0-d int32 leaf; a
  concrete one (``Transformer.init_kv_cache``) holds a Python int, which the
  cache's slicing reads without a host sync.

Sharding policy (the reference's DESIGN.md §5): TP over "model", FSDP over
"data", pure DP over "pod"; parameters never shard over "pod".
``mp.dp_axes`` is ("data",) or ("pod", "data").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..convert import transformer_param_tree
from ..core.table import resolve_device
from ..models import transformer as T
from ..train.checkpoint import TreeDef, tree_flatten, tree_unflatten
from ..train.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["MeshAxes", "Cell", "ArchSpec", "lm_param_pspecs", "lm_spec",
           "abstract_adamw", "SINGLE_POD", "MULTI_POD", "abstract_init",
           "meta_tensor", "arg_tree", "spec_leaves"]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical axis layout of the target mesh (and the mesh itself once one
    is built: None here)."""
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    multi_pod: bool = False
    mesh: Any = None

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return (*self.dp_axes, self.tp_axis)

    @property
    def dp(self):  # batch-sharding spec component
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def fsdp(self) -> str:
        return "data"


SINGLE_POD = MeshAxes(dp_axes=("data",))
MULTI_POD = MeshAxes(dp_axes=("pod", "data"), multi_pod=True)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (arch x shape) unit."""
    arch: str
    shape: str
    kind: str                         # train | prefill | decode | serve
    step_fn: Callable
    abstract_args: Tuple              # trees of meta tensors
    arg_pspecs: Tuple                 # congruent trees of spec tuples
    donate: Tuple[int, ...] = ()
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch: str
    family: str                                  # lm | gnn | recsys
    shapes: Tuple[str, ...]
    build_cell: Callable[[str, MeshAxes], Optional[Cell]]  # None => skipped
    smoke: Callable[..., Dict[str, Any]]         # smoke(device="cuda")
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


# ------------------------------------------------------------ abstract trees

class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: the port's initialisers
    draw on their generator's device, so with this one they build the
    tree's shapes and types and allocate nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_init(init_fn: Callable, cfg) -> Any:
    """``init_fn(gen, cfg)``'s tree on the meta device (the reference's
    ``jax.eval_shape(lambda k: init_fn(k, cfg), key)``)."""
    return init_fn(_MetaGenerator(), cfg)


def meta_tensor(shape, dtype) -> torch.Tensor:
    """An abstract argument: ``shape`` and ``dtype`` on the meta device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def arg_tree(x):
    """The tree a cell argument stands for: a ``Transformer``'s parameter
    tree in the reference's layout, any other argument itself."""
    return transformer_param_tree(x) if isinstance(x, T.Transformer) else x


def spec_leaves(specs, like) -> List:
    """The spec tree ``specs`` flattened in the leaf order of ``like``
    (a cell argument, or a tree of them), to which it is congruent: one
    spec tuple a tensor leaf."""
    return _spec_walk(specs, tree_flatten(arg_tree(like))[1], [])


def _spec_walk(specs, td: TreeDef, out: List) -> List:
    if td.kind == "leaf":
        out.append(specs)
    elif td.kind == "dataclass":
        for k, c in zip(td.keys, td.children):
            _spec_walk(getattr(specs, k), c, out)
    elif td.kind == "dict":
        for k, c in zip(td.keys, td.children):
            _spec_walk(specs[k], c, out)
    else:
        for s, c in zip(specs, td.children, strict=True):
            _spec_walk(s, c, out)
    return out


def tree_map_with_key(fn: Callable[[str, Any], Any], tree) -> Any:
    """``fn(key, leaf)`` over a tree of dicts and lists, ``key`` the leaf's
    path joined by "/", a list index as "" (the reference's
    ``"/".join(getattr(p, "key", ""))`` over a ``jax.tree_util`` path)."""
    def walk(x, path):
        if isinstance(x, dict):
            return {k: walk(v, (*path, str(k))) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, (*path, "")) for v in x)
        return fn("/".join(path), x)
    return walk(tree, ())


def replicated(tree) -> Any:
    """Every leaf's spec replicated, ``(None,) * ndim``."""
    return tree_map_with_key(lambda _, leaf: (None,) * leaf.dim(), tree)


# ---------------------------------------------------------------- optimizer

def abstract_adamw(abstract_params, state_dtype: str = "float32"):
    """AdamW's state for ``abstract_params`` on their (meta) device."""
    return adamw_init(abstract_params, state_dtype)


def adamw_pspecs(param_pspecs):
    return {"step": (), "m": param_pspecs, "v": param_pspecs}


def train_step_fn(loss_of: Callable, opt: AdamWConfig) -> Callable:
    """The reference's train step over ``loss_of(params, *batch) -> (loss,
    metrics)``: ``step(params, opt_state, *batch) -> (params, opt_state,
    {"loss", **metrics, "lr", "grad_norm"})``, AdamW under ``opt`` in
    place.  The parameters are marked as requiring grad; one the loss does
    not reach gets a zero gradient, as ``jax.value_and_grad`` gives."""
    def train_step(params, opt_state, *batch):
        leaves, treedef = tree_flatten(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, m = loss_of(params, *batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        params, opt_state, om = adamw_update(tree_unflatten(treedef, list(grads)),
                                             opt_state, params, opt)
        return params, opt_state, {"loss": loss.detach(), **m, **om}
    return train_step


# ------------------------------------------------------------ LM arch support

# Production mesh axis sizes (the reference's launch/mesh.py), for the
# divisibility checks
AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _fits(axis, dim: int):
    """Use ``axis`` only if it divides ``dim`` (else replicate that dim)."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        size = 1
        for a in axis:
            size *= AXIS_SIZES.get(a, 1)
    else:
        size = AXIS_SIZES.get(axis, 1)
    return axis if dim % size == 0 else None


def lm_param_pspecs(cfg: T.TransformerConfig, mp: MeshAxes, abstract_params,
                    expert_shard: str = "auto"):
    """Spec tree congruent to the parameter tree (the reference's layout).

    TP over mp.tp_axis on the head/ff/vocab dims, FSDP over "data" on the
    other big dim.  Experts go expert-parallel on the tp axis when the
    expert count divides it cleanly (arctic, 128e); otherwise experts stay
    replicated and the ffn dims are tensor-parallel (mixtral, 8e < 16).
    Dims not divisible by their axis (minicpm's 122753 vocab) fall back to
    replicated — checked via AXIS_SIZES.
    """
    tp, fs = mp.tp_axis, mp.fsdp
    expert_parallel = bool(cfg.moe) and cfg.moe.n_experts % AXIS_SIZES[tp] == 0

    def spec_for(key: str, leaf) -> tuple:
        sh = tuple(leaf.shape)
        nd = len(sh)

        def ps(*axes):  # divisibility-guarded spec
            return tuple(_fits(a, d) for a, d in zip(axes, sh))

        if "embed" in key:
            return ps(tp, fs)                      # (V, d)
        if "lm_head" in key:
            return ps(fs, tp)                      # (d, V)
        if "final_norm" in key:
            return (None,)
        # --- stacked layer params: leading dim = n_layers ---
        if "moe" in key:
            if "router" in key:
                return ps(None, fs, None) if nd == 3 else (None, None)
            if "experts" in key:                   # (L, E, ...) swiglu leaves
                if expert_shard == "ff2d":
                    if "down" in key:              # (L, E, ff, d)
                        return ps(None, None, (fs, tp), None)
                    return ps(None, None, None, (fs, tp))
                if "down" in key:                  # (L, E, ff, d)
                    return (ps(None, tp, None, fs) if expert_parallel
                            else ps(None, None, tp, fs))
                return (ps(None, tp, fs, None) if expert_parallel
                        else ps(None, None, fs, tp))   # gate/up (L, E, d, ff)
            if "dense_residual" in key:
                if "down" in key:
                    return ps(None, tp, fs)        # (L, ff, d)
                return ps(None, fs, tp)            # (L, d, ff)
        if "wq" in key or "wk" in key or "wv" in key:
            if nd == 3:
                return ps(None, fs, tp)            # (L, d, H*dh)
            return ps(None, tp)                    # bias (L, H*dh)
        if "wo" in key:
            return ps(None, tp, fs)                # (L, H*dh, d)
        if "mlp" in key and nd == 3:
            if "down" in key:
                return ps(None, tp, fs)            # (L, ff, d)
            return ps(None, fs, tp)                # gate/up (L, d, ff)
        return (None,) * nd                        # norms / scalars

    return tree_map_with_key(spec_for, abstract_params)


def _kv_cache_pspecs(cfg: T.TransformerConfig, mp: MeshAxes, batch: int):
    """(layers, B, Hkv, S, dh): shard B over dp when possible, S over tp
    (flash-decoding-style sequence sharding); B==1 long-context shards S over
    everything."""
    if batch == 1:
        kv = (None, None, None, (*mp.dp_axes, mp.tp_axis), None)
    else:
        kv = (None, mp.dp, None, mp.tp_axis, None)
    return {"k": kv, "v": kv, "pos": ()}


def abstract_model(cfg: T.TransformerConfig) -> T.Transformer:
    """A ``Transformer`` of ``cfg`` on meta weights."""
    return T.Transformer(cfg, weights={name: meta_tensor(shape, cfg.dtype)
                                       for name, shape in T.weight_shapes(cfg).items()})


def abstract_kv_cache(cfg: T.TransformerConfig, batch: int, max_len: int) -> Dict:
    """``init_kv_cache``'s layout on the meta device, ``"pos"`` the
    reference's 0-d int32 leaf."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": meta_tensor(shape, cfg.dtype), "v": meta_tensor(shape, cfg.dtype),
            "pos": meta_tensor((), torch.int32)}


def lm_spec(
    arch: str,
    cfg_factory: Callable[[], T.TransformerConfig],
    smoke_cfg_factory: Callable[[], T.TransformerConfig],
    full_attention_only: bool,
    opt: Optional[AdamWConfig] = None,
    expert_shard: str = "auto",
) -> ArchSpec:
    """Build the ArchSpec shared by all five LM architectures."""
    opt = opt or AdamWConfig(lr=3e-4, schedule="cosine", total_steps=10_000)
    SHAPES = {
        "train_4k": dict(kind="train", seq=4096, batch=256),
        "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
        "decode_32k": dict(kind="decode", seq=32768, batch=128),
        "long_500k": dict(kind="decode", seq=524288, batch=1),
    }

    def build_cell(shape: str, mp: MeshAxes) -> Optional[Cell]:
        info = SHAPES[shape]
        if shape == "long_500k" and full_attention_only:
            return None  # quadratic attention at 512k — skipped per spec
        cfg = cfg_factory()
        model = abstract_model(cfg)
        a_params = transformer_param_tree(model)
        p_specs = lm_param_pspecs(cfg, mp, a_params, expert_shard=expert_shard)
        B, S = info["batch"], info["seq"]

        if info["kind"] == "train":
            tok = meta_tensor((B, S), torch.int32)
            tok_spec = (mp.dp, None)
            def train_step(model, opt_state, tokens, labels):
                step = train_step_fn(lambda _, tokens, labels: T.loss_fn(
                    model, tokens, labels), opt)
                _, opt_state, metrics = step(transformer_param_tree(model), opt_state,
                                             tokens, labels)
                return model, opt_state, metrics

            return Cell(
                arch=arch, shape=shape, kind="train", step_fn=train_step,
                abstract_args=(model, abstract_adamw(a_params, opt.state_dtype),
                               tok, tok),
                arg_pspecs=(p_specs, adamw_pspecs(p_specs), tok_spec, tok_spec),
                donate=(0, 1),
            )

        # prefill: the prompt fills the whole cache (benchmark semantics);
        # decode: one new token against a KV cache of length S
        cache = abstract_kv_cache(cfg, B, S)
        c_specs = _kv_cache_pspecs(cfg, mp, B)
        if info["kind"] == "prefill":
            def prefill_step(model, tokens, cache):
                return model.prefill(tokens, cache)

            return Cell(
                arch=arch, shape=shape, kind="prefill", step_fn=prefill_step,
                abstract_args=(model, meta_tensor((B, S), torch.int32), cache),
                arg_pspecs=(p_specs, (mp.dp, None), c_specs),
                donate=(2,),
            )

        def decode(model, tokens, cache):
            return model.decode_step(tokens, cache)

        return Cell(
            arch=arch, shape=shape, kind="decode", step_fn=decode,
            abstract_args=(model, meta_tensor((B,), torch.int32), cache),
            arg_pspecs=(p_specs, (mp.dp,) if B > 1 else (None,), c_specs),
            donate=(2,),
            note="serve_step (single token, static KV cache)",
        )

    def smoke(device="cuda") -> Dict[str, Any]:
        """The smoke config drawn from seed 0 on ``device``: the loss,
        logits and a prefill of two random 16-token sequences.  On the card
        attention runs through the kernel, which takes heads of 32, 64 or
        128 (the smoke configs' are 8)."""
        cfg = smoke_cfg_factory()
        model = T.Transformer(cfg, device=resolve_device(device), seed=0)
        gen = torch.Generator(device=model.device).manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device=model.device)
        with torch.no_grad():
            loss, _ = T.loss_fn(model, toks[:, :-1], toks[:, 1:])
            logits = model(toks)
        lg, _ = model.prefill(toks, model.init_kv_cache(2, 16))
        if logits.shape != (2, 16, cfg.vocab) or bool(torch.isnan(logits).any()) or (
                bool(torch.isnan(loss))):
            raise AssertionError(f"{arch} smoke: logits {tuple(logits.shape)}, "
                                 f"loss {loss}")
        return {"loss": float(loss), "logits_shape": tuple(logits.shape),
                "decode_logits_shape": tuple(lg.shape)}

    return ArchSpec(
        arch=arch, family="lm",
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        build_cell=build_cell, smoke=smoke,
        meta={"full_attention_only": full_attention_only},
    )
