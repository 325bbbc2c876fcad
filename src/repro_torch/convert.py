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
weights.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from .core.sketch import SketchState
from .core.table import Table, resolve_device

if TYPE_CHECKING:  # the model layer loads only when a transformer is built
    from .models.transformer import Transformer, TransformerConfig

__all__ = ["table_from_numpy", "sketch_state_from_numpy", "results_to_numpy",
           "tensor_leaves", "transformer_params_from_numpy"]


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
    layers = params["layers"]
    names = {
        "embed": params["embed"]["table"],
        "attn_norm": layers["attn_norm"]["g"],
        "wq": layers["wq"]["w"], "wk": layers["wk"]["w"], "wv": layers["wv"]["w"],
        "wo": layers["wo"]["w"],
        "mlp_norm": layers["mlp_norm"]["g"],
        "w_gate": layers["mlp"]["gate"]["w"], "w_up": layers["mlp"]["up"]["w"],
        "w_down": layers["mlp"]["down"]["w"],
        "final_norm": params["final_norm"]["g"],
    }
    if cfg.qkv_bias:
        names.update(bq=layers["wq"]["b"], bk=layers["wk"]["b"], bv=layers["wv"]["b"])
    if not cfg.tie_embeddings:
        names["lm_head"] = params["lm_head"]["w"]
    return Transformer(cfg, weights={k: _weight(v, cfg.dtype, device)
                                     for k, v in names.items()})
