"""Architecture registry: ``--arch <id>`` resolution — the port of
``repro/configs/__init__.py``.

Every assigned architecture's module exposes ``SPEC``, an
:class:`~.common.ArchSpec`: the decoders (``qwen2_72b``, ``minicpm_2b``,
``granite_8b`` and the mixtures of experts ``mixtral_8x7b`` and
``arctic_480b``) through ``common.lm_spec``, with ``ARCH_ID``,
``full_config()``, ``smoke_config()`` and, for the MoE two,
``optimized_config()``; the GNNs (``schnet``, ``pna``, ``egnn``,
``graphsage_reddit``) through ``common_gnn.gnn_spec``, with ``make_cfg(info)``
and ``smoke()``; xDeepFM (``xdeepfm``) with ``SHAPES``, ``CFG``, ``OPT`` and
``serve_fn(shape)``.  All with the reference's numbers.

The reference also registers ``network-sensing``, the paper's pipeline as a
``shard_map`` cell over a mesh.  It comes with distribution over
several cards (ROADMAP queue 1 item 10): until then ``ALL_ARCHS`` lacks it
and :func:`get_spec` refuses it.
"""
from __future__ import annotations

import importlib
from typing import Dict

from .common import ArchSpec, Cell, MeshAxes, MULTI_POD, SINGLE_POD

_MODULES = {
    "qwen2-72b": "qwen2_72b",
    "minicpm-2b": "minicpm_2b",
    "granite-8b": "granite_8b",
    "arctic-480b": "arctic_480b",
    "mixtral-8x7b": "mixtral_8x7b",
    "schnet": "schnet",
    "pna": "pna",
    "egnn": "egnn",
    "graphsage-reddit": "graphsage_reddit",
    "xdeepfm": "xdeepfm",
}
# registered by the reference, not ported yet
_NOT_PORTED = {"network-sensing": "the paper's pipeline as a mesh cell comes with "
                                  "distribution (ROADMAP queue 1 item 10)"}

ASSIGNED_ARCHS = tuple(_MODULES)
ALL_ARCHS = tuple(_MODULES)


def get_spec(arch: str) -> ArchSpec:
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"{arch}: {_NOT_PORTED[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted([*_MODULES, *_NOT_PORTED])}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__).SPEC


def all_specs() -> Dict[str, ArchSpec]:
    return {a: get_spec(a) for a in ALL_ARCHS}


__all__ = ["ArchSpec", "Cell", "MeshAxes", "MULTI_POD", "SINGLE_POD",
           "ASSIGNED_ARCHS", "ALL_ARCHS", "get_spec", "all_specs"]
