"""Fault-tolerant checkpointing: atomic, manifest-driven, resumable — the
port of ``repro/train/checkpoint.py``.

Layout (one directory per step):

    <dir>/step_00000123/
        manifest.json      # treedef, per-leaf shape/dtype/file, step, extra
        leaf_00000.npy ... # one .npy per tree leaf (copied to the host)
    <dir>/LATEST           # text file with the newest *committed* step

Crash-safety protocol:
  1. write everything into ``step_X.tmp/``,
  2. fsync each file, atomically ``rename`` to ``step_X/`` (POSIX atomic),
  3. only then rewrite ``LATEST`` (``LATEST.tmp`` -> ``os.replace``).
A step directory either exists completely or not at all; a torn write can
never be observed by :func:`restore_latest`.

Trees are flattened by :func:`tree_flatten`: dicts in sorted key order,
tuples and lists in order, dataclass fields in declaration order; tensors
and numpy arrays are leaves, and any other dataclass field is static
(``SketchState.seed``).  That is the leaf order of
``jax.tree_util.tree_flatten`` on the same trees, and the manifest holds
the same keys as the reference's, so a step written by either package
restores in the other: a restore checks only the leaf count and shapes,
never ``treedef``.

A ``torch.bfloat16`` leaf is written as its 16-bit pattern (a uint16 file)
with ``"bfloat16"`` as its manifest dtype and restores bit-equal; the
reference's bfloat16 leaves (numpy reads them as ``|V2``) restore too.  The
reference itself restores neither: its dtype check fails on both files, so
its ``restore_latest`` returns None for a checkpoint with a bfloat16 leaf.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["TreeDef", "tree_flatten", "tree_unflatten",
           "save_checkpoint", "restore_checkpoint", "restore_latest",
           "latest_step", "read_manifest", "step_is_complete",
           "complete_steps", "gc_checkpoints"]


# ---------------------------------------------------------------------------
# flattening
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a flattened tree.  ``kind`` is ``"leaf"``,
    ``"dict"``, ``"tuple"``, ``"list"`` or ``"dataclass"``;
    ``keys`` the dict keys (sorted) or dataclass field names of the
    children, ``static`` a dataclass's non-leaf fields by name."""

    kind: str
    children: Tuple["TreeDef", ...] = ()
    keys: Tuple[str, ...] = ()
    cls: Any = None
    static: Tuple[Tuple[str, Any], ...] = ()

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.keys, self.children)) + "}"
        if self.kind in ("tuple", "list"):
            inner = ", ".join(str(c) for c in self.children)
            return f"({inner})" if self.kind == "tuple" else f"[{inner}]"
        fields = [f"{k}={c}" for k, c in zip(self.keys, self.children)]
        fields += [f"{k}={v!r}" for k, v in self.static]
        return f"{self.cls.__name__}({', '.join(fields)})"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _walk(x, leaves: List) -> TreeDef:
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return TreeDef("dict", tuple(_walk(x[k], leaves) for k in keys), keys)
    if isinstance(x, (tuple, list)):
        return TreeDef(type(x).__name__, tuple(_walk(v, leaves) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        keys, children, static = [], [], []
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if _is_leaf(v) or isinstance(v, (dict, tuple, list)) or (
                    dataclasses.is_dataclass(v) and not isinstance(v, type)):
                keys.append(f.name)
                children.append(_walk(v, leaves))
            else:
                static.append((f.name, v))
        return TreeDef("dataclass", tuple(children), tuple(keys), type(x),
                       tuple(static))
    leaves.append(x)
    return TreeDef("leaf")


def tree_flatten(tree) -> Tuple[List, TreeDef]:
    """``(leaves, treedef)`` of ``tree`` in ``jax.tree_util`` order."""
    leaves: List = []
    return leaves, _walk(tree, leaves)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """Rebuild the tree of ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, kids))
        if td.kind == "tuple":
            return tuple(kids)
        if td.kind == "list":
            return kids
        return td.cls(**dict(zip(td.keys, kids)), **dict(td.static))

    return build(treedef)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array (a 0-d tensor keeps shape ``()``) and
    its manifest dtype.  numpy has no bfloat16: a ``torch.bfloat16`` leaf
    is saved as its 16-bit pattern (uint16) under the dtype ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            bits = leaf.detach().view(torch.int16).cpu().numpy().view(np.uint16)
            return bits, "bfloat16"
        arr = leaf.detach().cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _stored_as(arr: np.ndarray, dtype: str) -> bool:
    """Whether a loaded leaf file holds the manifest's ``dtype``.  A
    bfloat16 leaf loads as 2-byte words: uint16 as the port writes it, or
    ``|V2`` as numpy reads the reference's (``ml_dtypes``) bfloat16."""
    if dtype == "bfloat16":
        return arr.dtype.itemsize == 2 and arr.dtype.kind in "uV"
    return str(arr.dtype) == dtype


def _leaf_from_file(arr: np.ndarray, dtype: str):
    """A restored leaf: the numpy array, or for a bfloat16 leaf a bit-equal
    ``torch.bfloat16`` tensor on the host."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    return arr


# ---------------------------------------------------------------------------
# the on-disk protocol
# ---------------------------------------------------------------------------

def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _all_steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )


def save_checkpoint(directory: str, step: int, tree, extra: Optional[Dict] = None,
                    keep: int = 3) -> str:
    """Atomically persist a tree.  Returns the committed path.  Every leaf
    is copied to the host first, then written and fsynced one file each."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves, treedef = tree_flatten(tree)
    arrays, dtypes = zip(*map(_host, leaves)) if leaves else ((), ())
    manifest = {
        "step": step,
        "treedef": str(treedef),
        "n_leaves": len(arrays),
        "leaves": [],
        "extra": extra or {},
    }
    for i, (arr, dtype) in enumerate(zip(arrays, dtypes)):
        fname = f"leaf_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append(
            {"file": fname, "shape": list(arr.shape), "dtype": dtype}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # commit point

    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))

    gc_checkpoints(directory, keep=keep)
    return final


def latest_step(directory: str) -> Optional[int]:
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        step = int(f.read().strip())
    if not os.path.exists(_step_dir(directory, step)):
        # LATEST ahead of a crashed commit — fall back to newest complete dir
        steps = _all_steps(directory)
        return steps[-1] if steps else None
    return step


def read_manifest(directory: str, step: int) -> Dict:
    """Parsed manifest of one committed step (raises if torn/missing)."""
    with open(os.path.join(_step_dir(directory, step), "manifest.json")) as f:
        return json.load(f)


def step_is_complete(directory: str, step: int) -> bool:
    """True iff the step directory is fully readable: the manifest parses
    and every leaf file loads with its recorded shape/dtype.

    The atomic rename makes a torn *write* unobservable, but the storage
    underneath can still lose or truncate files after commit — recovery
    must skip such steps rather than crash mid-restore.
    """
    path = _step_dir(directory, step)
    try:
        manifest = read_manifest(directory, step)
        if len(manifest["leaves"]) != manifest["n_leaves"]:
            return False
        for spec in manifest["leaves"]:
            arr = np.load(os.path.join(path, spec["file"]))
            if (list(arr.shape) != list(spec["shape"])
                    or not _stored_as(arr, spec["dtype"])):
                return False
    except Exception:  # any unreadable byte makes the step a non-candidate
        return False
    return True


def complete_steps(directory: str) -> list:
    """All fully-readable steps, ascending (the restore candidates)."""
    return [s for s in _all_steps(directory) if step_is_complete(directory, s)]


def restore_checkpoint(directory: str, step: int, target_tree):
    """Restore into the *structure* of ``target_tree`` (leaf count and
    shapes checked).  The leaves come back as host numpy arrays, a bfloat16
    leaf as a bit-equal host ``torch.bfloat16`` tensor; the template's
    leaves only give shapes (they may be ``meta`` tensors)."""
    path = _step_dir(directory, step)
    manifest = read_manifest(directory, step)
    leaves, treedef = tree_flatten(target_tree)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target has {len(leaves)}"
        )
    restored = []
    for i, (leaf, spec) in enumerate(zip(leaves, manifest["leaves"])):
        arr = np.load(os.path.join(path, spec["file"]))
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {i}: checkpoint {arr.shape} vs target {want}")
        restored.append(_leaf_from_file(arr, spec["dtype"]))
    return tree_unflatten(treedef, restored), manifest["extra"]


def restore_latest(directory: str, target_tree):
    """Restore the newest *fully readable* step.

    ``LATEST`` is a hint, not the authority: if its step directory is
    missing, or the manifest / a leaf file is truncated (see
    :func:`step_is_complete`), the restore falls back through older steps,
    newest first, and returns ``(step, tree, extra)`` of the first one that
    validates, or ``None`` when no step survives.
    """
    candidates = []
    pointed = latest_step(directory)
    if pointed is not None:
        candidates.append(pointed)
    candidates.extend(s for s in reversed(_all_steps(directory))
                      if s not in candidates)
    for step in candidates:
        if not step_is_complete(directory, step):
            continue
        tree, extra = restore_checkpoint(directory, step, target_tree)
        return step, tree, extra
    return None


def gc_checkpoints(directory: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` steps (``keep=0``: all) and sweep the tmp
    directories of crashed writers."""
    steps = _all_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
    for d in os.listdir(directory):
        if d.endswith(".tmp") and d.startswith("step_"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
