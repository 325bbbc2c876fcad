"""``plq`` ("parquet-lite") — the port's copy of ``repro/data/plq.py``.

A chunked columnar binary format: column-major pages per row group, a JSON
footer with a CRC32 per page, and zero-parse reads (``np.frombuffer``, or an
mmap for the cached path).  The port keeps what the challenge's read phase
needs (write, whole-column read, footer); files are byte-identical to the
reference's.

Layout: ``[MAGIC u64][pages...][footer json][footer_len u64][MAGIC u64]``.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["write_plq", "read_plq", "plq_info"]

_MAGIC = 0x504C515F52455052  # "PLQ_REPR"


def write_plq(
    path: str,
    columns: Dict[str, np.ndarray],
    row_group_size: int = 1 << 20,
) -> None:
    """Write equal-length 1-D arrays as a plq file (atomic via tmp+rename)."""
    n = len(next(iter(columns.values())))
    for k, v in columns.items():
        if v.ndim != 1 or len(v) != n:
            raise ValueError(f"column {k!r}: need 1-D length {n}, got {v.shape}")
    tmp = path + ".tmp"
    footer = {"n_rows": n, "row_group_size": row_group_size, "columns": {}, "groups": []}
    with open(tmp, "wb") as f:
        f.write(np.uint64(_MAGIC).tobytes())
        for k, v in columns.items():
            footer["columns"][k] = str(v.dtype)
        for start in range(0, max(n, 1), row_group_size):
            stop = min(start + row_group_size, n)
            group = {"start": start, "stop": stop, "pages": {}}
            for k, v in columns.items():
                off = f.tell()
                buf = np.ascontiguousarray(v[start:stop]).tobytes()
                f.write(buf)
                group["pages"][k] = {
                    "offset": off,
                    "nbytes": len(buf),
                    "crc32": zlib.crc32(buf) & 0xFFFFFFFF,
                }
            footer["groups"].append(group)
        fj = json.dumps(footer).encode()
        f.write(fj)
        f.write(np.uint64(len(fj)).tobytes())
        f.write(np.uint64(_MAGIC).tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def plq_info(path: str) -> dict:
    with open(path, "rb") as f:
        f.seek(0)
        if np.frombuffer(f.read(8), np.uint64)[0] != _MAGIC:
            raise ValueError(f"{path}: bad magic (not a plq file)")
        f.seek(-16, os.SEEK_END)
        flen = int(np.frombuffer(f.read(8), np.uint64)[0])
        if np.frombuffer(f.read(8), np.uint64)[0] != _MAGIC:
            raise ValueError(f"{path}: truncated (bad trailing magic)")
        f.seek(-16 - flen, os.SEEK_END)
        return json.loads(f.read(flen))


def read_plq(
    path: str, columns: Optional[Sequence[str]] = None, mmap: bool = True
) -> Dict[str, np.ndarray]:
    """Read whole columns. mmap=True = the paper's 'cached' fast path."""
    info = plq_info(path)
    names = list(columns or info["columns"])
    out = {k: [] for k in names}
    raw = np.memmap(path, np.uint8, "r") if mmap else None
    with open(path, "rb") as f:
        for g in info["groups"]:
            for k in names:
                page = g["pages"][k]
                dt = np.dtype(info["columns"][k])
                if mmap:
                    arr = raw[page["offset"]: page["offset"] + page["nbytes"]].view(dt)
                else:
                    f.seek(page["offset"])
                    arr = np.frombuffer(f.read(page["nbytes"]), dt)
                out[k].append(arr)
    return {k: np.concatenate(v) if len(v) != 1 else v[0] for k, v in out.items()}
