"""Carrying state between the JAX package and the port.

The system has no weights: what crosses is the packet table going in, the
sketch tier's state, and the results coming out.  :func:`table_from_numpy`
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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .core.sketch import SketchState
from .core.table import Table, resolve_device

__all__ = ["table_from_numpy", "sketch_state_from_numpy", "results_to_numpy"]


def table_from_numpy(columns: Mapping[str, np.ndarray], n_valid: int,
                     device="cuda") -> Table:
    """The port's ``Table`` on ``device`` from equal-length host columns
    (``capacity`` rows, the first ``n_valid`` live)."""
    device = resolve_device(device)
    return Table(
        columns={k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in columns.items()},
        n_valid=torch.tensor(int(n_valid), dtype=torch.int32, device=device),
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
