"""Carrying state between the JAX package and the port.

What crosses is the packet table going in, the sketch tier's state, the
results coming out, and a transformer's weights.  :func:`table_from_numpy`
builds the port's ``Table`` from the host columns a JAX ``Table`` holds;
:func:`sketch_state_from_numpy` builds the port's ``SketchState`` from a
JAX ``SketchState``'s arrays, so both sides can fold the same batch into the
same starting state; :func:`results_to_numpy` flattens a ``ChallengeResults``
(its ``AlgorithmResults`` included), a ``SketchSnapshot`` or any other
dataclass of results into one dict of numpy arrays keyed by field path
(``"links.keys.0"``, ``"algorithms.bfs.levels"``, ``"bounds.cms_delta"``...).
It reads fields by name and turns every leaf into a numpy array, so the same
call flattens the reference's results (whose fields carry the same names)
and the tests compare the two dicts key by key.  The challenge pipeline
builds its packet table with :func:`table_from_numpy` too.
:func:`tensor_leaves` walks a state (a ``StreamState``, a ``SketchState``)
down to its tensors, for comparing two states on the device.
:func:`transformer_params_from_numpy` builds the port's ``Transformer``
from the reference's parameter pytree, so both compute with one set of
weights; :func:`transformer_param_tree` is the other way, the model's own
parameters in the reference's nested layout (what the port's trainer
trains and checkpoints, so that a step either package writes restores in
the other; a MoE layer's router, experts and dense residual included).
:func:`gnn_params_from_numpy` and :func:`gnn_params_to_numpy` carry a
GNN's parameter tree (the reference's nested dicts and lists, which the
port's models take as they are); :func:`xdeepfm_params_from_numpy` and
:func:`xdeepfm_params_to_numpy` are the same for xDeepFM's tree (tables,
linear weights, CIN kernels, MLP, bias).  :func:`train_state_from_numpy`
and :func:`train_state_to_numpy` carry a whole training state,
``{"params": ..., "opt": {"step", "m", "v"}}``, across both ways, a
transformer's or a GNN's.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from .core.sketch import SketchState
from .core.table import Table, resolve_device

if TYPE_CHECKING:  # the model and training layers load only when used
    from .models.transformer import Transformer, TransformerConfig
    from .train.loop import TrainState

__all__ = ["table_from_numpy", "sketch_state_from_numpy", "results_to_numpy",
           "tensor_leaves", "transformer_params_from_numpy",
           "transformer_param_tree", "gnn_params_from_numpy",
           "gnn_params_to_numpy", "xdeepfm_params_from_numpy",
           "xdeepfm_params_to_numpy", "train_state_from_numpy",
           "train_state_to_numpy"]


def table_from_numpy(columns: Mapping[str, np.ndarray], n_valid: int,
                     device="cuda") -> Table:
    """The port's ``Table`` on ``device`` from equal-length host columns
    (``capacity`` rows, the first ``n_valid`` live)."""
    device = resolve_device(device)
    return Table(
        columns={k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in columns.items()},
        # a fill on the device, not a blocking copy of a host scalar
        n_valid=torch.full((), int(n_valid), dtype=torch.int32, device=device),
    )


def sketch_state_from_numpy(arrays: Mapping[str, np.ndarray], seed: int,
                            device="cuda") -> SketchState:
    """The port's ``SketchState`` on ``device`` from the arrays of a sketch
    state as numpy, keyed by field name (every field but ``seed``)."""
    device = resolve_device(device)
    names = [f.name for f in dataclasses.fields(SketchState) if f.name != "seed"]
    return SketchState(
        **{k: torch.from_numpy(np.array(arrays[k])).to(device) for k in names},
        seed=int(seed))


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(prefix: str, x, out: Dict[str, np.ndarray]) -> None:
    if x is None:
        return
    if isinstance(x, Mapping):
        for k in sorted(x):
            _flatten(f"{prefix}.{k}", x[k], out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _flatten(f"{prefix}.{i}", v, out)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _flatten(f"{prefix}.{f.name}", getattr(x, f.name), out)
    else:
        out[prefix] = _leaf(x)


def results_to_numpy(results) -> Dict[str, np.ndarray]:
    """Flatten the fields of a results dataclass (``ChallengeResults``,
    ``AlgorithmResults``, ``SketchSnapshot``) into numpy arrays.

    Works on the port's results and, field for field, on the reference's;
    a field that is None (``algorithms`` when that pass is off) contributes
    nothing.
    """
    out: Dict[str, np.ndarray] = {}
    for f in dataclasses.fields(results):
        _flatten(f.name, getattr(results, f.name), out)
    return out


def tensor_leaves(x, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor in ``x``, through tuples and
    dataclasses, in field order (``"links.row_keys.0"``...)."""
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            yield from tensor_leaves(v, f"{prefix}.{i}" if prefix else str(i))
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from tensor_leaves(getattr(x, f.name),
                                     f"{prefix}.{f.name}" if prefix else f.name)


def _weight(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _reference_paths(cfg: TransformerConfig) -> Dict[str, Tuple[str, ...]]:
    """Each port weight's path in the reference's parameter pytree
    (``repro.models.transformer.init_params``; a MoE layer's under
    ``layers/moe``: ``router/w``, ``experts/{gate,up,down}/w`` and
    ``dense_residual/{gate,up,down}/w``)."""
    paths = {
        "embed": ("embed", "table"),
        "attn_norm": ("layers", "attn_norm", "g"),
        "wq": ("layers", "wq", "w"), "wk": ("layers", "wk", "w"),
        "wv": ("layers", "wv", "w"), "wo": ("layers", "wo", "w"),
        "mlp_norm": ("layers", "mlp_norm", "g"),
        "final_norm": ("final_norm", "g"),
    }
    swiglu = ("gate", "up", "down")
    if cfg.moe is None:
        paths.update({f"w_{k}": ("layers", "mlp", k, "w") for k in swiglu})
    else:
        paths["router"] = ("layers", "moe", "router", "w")
        paths.update({f"expert_{k}": ("layers", "moe", "experts", k, "w")
                      for k in swiglu})
        if cfg.moe.dense_residual_d_ff:
            paths.update({f"residual_{k}": ("layers", "moe", "dense_residual", k, "w")
                          for k in swiglu})
    if cfg.qkv_bias:
        paths.update(bq=("layers", "wq", "b"), bk=("layers", "wk", "b"),
                     bv=("layers", "wv", "b"))
    if not cfg.tie_embeddings:
        paths["lm_head"] = ("lm_head", "w")
    return paths


def transformer_params_from_numpy(params: Mapping, cfg: TransformerConfig,
                                  device="cuda") -> Transformer:
    """The port's ``Transformer`` on ``device`` holding the weights of the
    reference's parameter pytree (``repro.models.transformer.init_params``:
    layer weights stacked on a leading axis), its leaves as numpy arrays or
    anything ``np.asarray`` takes, cast to ``cfg.dtype``.

    The port keeps the reference's layout (dense weights ``(d_in, d_out)``,
    ``y = x @ w``), so no weight is transposed; only the names change.
    """
    from .models.transformer import Transformer

    device = resolve_device(device)
    weights = {}
    for name, path in _reference_paths(cfg).items():
        leaf = params
        for key in path:
            leaf = leaf[key]
        weights[name] = _weight(leaf, cfg.dtype, device)
    return Transformer(cfg, weights=weights)


def transformer_param_tree(model: Transformer) -> Dict:
    """The model's parameters, the tensors themselves, nested as the
    reference's parameter pytree: ``{"embed": {"table"}, "final_norm":
    {"g"}, "layers": {...}, ["lm_head": {"w"}]}``."""
    tree: Dict = {}
    for name, path in _reference_paths(model.cfg).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = getattr(model, name)
    return tree


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor on ``device`` in its own type (a bfloat16
    leaf as ``torch.bfloat16``)."""
    a = np.asarray(x)
    dt = (torch.bfloat16 if a.dtype.name == "bfloat16"
          else torch.from_numpy(np.empty(0, a.dtype)).dtype)
    return _weight(a, dt, device)


def gnn_params_from_numpy(tree, device="cuda"):
    """A GNN's parameter tree on ``device`` from the reference's
    (``repro.models.gnn.*_init``: dicts and lists, leaves as numpy arrays or
    anything ``np.asarray`` takes), the same structure, each leaf in its own
    type."""
    from .train.checkpoint import tree_flatten, tree_unflatten

    device = resolve_device(device)
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [_tensor(x, device) for x in leaves])


def gnn_params_to_numpy(tree):
    """A tree of tensors (a GNN's parameters, a whole training state) with
    every leaf on the host as numpy, the same structure; a bfloat16 leaf
    widens to float32 (exactly: numpy has no bfloat16)."""
    from .train.checkpoint import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        x.detach().to(torch.float32 if x.dtype == torch.bfloat16 else x.dtype)
        .cpu().numpy() for x in leaves])


# xDeepFM's tree is nested dicts and lists too, carried the same way
xdeepfm_params_from_numpy = gnn_params_from_numpy
xdeepfm_params_to_numpy = gnn_params_to_numpy


def train_state_from_numpy(tree: Mapping, cfg: Optional[TransformerConfig] = None,
                           device="cuda") -> Tuple[Optional[Transformer], TrainState]:
    """The port's model and training state on ``device`` from the
    reference's ``TrainState.tree()`` (``{"params": ..., "opt": {"step",
    "m", "v"}}``, leaves as numpy arrays): with a ``TransformerConfig`` the
    model holding the weights in ``cfg.dtype``; without one (a GNN's state)
    no model, None, and the parameter tree as it is, each leaf in its own
    type.  The moments keep their type (float32 or bfloat16), the step is a
    0-d int32 tensor, and the parameters require grad."""
    from .train.checkpoint import tree_flatten, tree_unflatten
    from .train.loop import TrainState

    model = None
    if cfg is None:
        params = gnn_params_from_numpy(tree["params"], device)
    else:
        model = transformer_params_from_numpy(tree["params"], cfg, device)
        params = transformer_param_tree(model)
    leaves, treedef = tree_flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    device = leaves[0].device
    moments = {k: tree_unflatten(treedef, [
        _tensor(x, device) for x in tree_flatten(tree["opt"][k])[0]])
        for k in ("m", "v")}
    step = torch.full((), int(np.asarray(tree["opt"]["step"])),
                      dtype=torch.int32, device=device)
    return model, TrainState(params=params, opt={"step": step, **moments})


def train_state_to_numpy(state: TrainState) -> Dict:
    """``state.tree()`` with every leaf on the host as numpy, in the
    reference's layout; a bfloat16 leaf widens to float32 (exactly: numpy
    has no bfloat16)."""
    return gnn_params_to_numpy(state.tree())
