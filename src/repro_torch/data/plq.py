"""``plq`` ("parquet-lite") — the port's copy of ``repro/data/plq.py``.

A chunked columnar binary format: column-major pages per row group, a JSON
footer with a CRC32 per page, and zero-parse reads (``np.frombuffer``, or an
mmap for the cached path).  The port keeps what the challenge's read phase
needs (write, whole-column read, footer) and what the streaming engine
reads (one row group, or every row group in turn, each page checked
against its CRC32: :class:`PlqCorruptionError` on a torn or flipped page);
files are byte-identical to the reference's.

Layout: ``[MAGIC u64][pages...][footer json][footer_len u64][MAGIC u64]``.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

__all__ = ["PlqCorruptionError", "write_plq", "read_plq", "read_plq_group",
           "read_plq_chunks", "plq_info"]

_MAGIC = 0x504C515F52455052  # "PLQ_REPR"


class PlqCorruptionError(ValueError):
    """A page failed its integrity check (truncated bytes or CRC mismatch);
    ``group`` and ``column`` name the unit that tore."""

    def __init__(self, msg: str, group: Optional[int] = None,
                 column: Optional[str] = None):
        super().__init__(msg)
        self.group = group
        self.column = column


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


def _read_page(f, info: dict, group: dict, gi: int, name: str,
               validate: bool) -> np.ndarray:
    """Read one column page of one row group, integrity-checked."""
    page = group["pages"][name]
    f.seek(page["offset"])
    buf = f.read(page["nbytes"])
    if len(buf) != page["nbytes"]:
        raise PlqCorruptionError(
            f"row group {gi} column {name!r}: truncated page "
            f"({len(buf)} of {page['nbytes']} bytes)", group=gi, column=name)
    if validate and "crc32" in page:
        crc = zlib.crc32(buf) & 0xFFFFFFFF
        if crc != page["crc32"]:
            raise PlqCorruptionError(
                f"row group {gi} column {name!r}: CRC32 mismatch "
                f"(got {crc:#010x}, footer {page['crc32']:#010x})",
                group=gi, column=name)
    return np.frombuffer(buf, np.dtype(info["columns"][name]))


def read_plq_group(
    path: str,
    group: int,
    columns: Optional[Sequence[str]] = None,
    validate: bool = True,
    info: Optional[dict] = None,
) -> Dict[str, np.ndarray]:
    """Read one row group by index.  Raises :class:`PlqCorruptionError` on
    a truncated page or a CRC32 mismatch, ``IndexError`` on a group out of
    range; ``info`` (a cached :func:`plq_info`) skips re-parsing the footer."""
    info = plq_info(path) if info is None else info
    if not 0 <= group < len(info["groups"]):
        raise IndexError(f"row group {group} out of range [0, {len(info['groups'])})")
    g = info["groups"][group]
    names = list(columns or info["columns"])
    with open(path, "rb") as f:
        return {k: _read_page(f, info, g, group, k, validate) for k in names}


def read_plq_chunks(
    path: str,
    columns: Optional[Sequence[str]] = None,
    start_group: int = 0,
    validate: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield the row groups in file order from ``start_group`` on, each
    page integrity-checked: the streaming engine's prefetchable unit."""
    info = plq_info(path)
    names = list(columns or info["columns"])
    with open(path, "rb") as f:
        for gi in range(start_group, len(info["groups"])):
            g = info["groups"][gi]
            yield {k: _read_page(f, info, g, gi, k, validate) for k in names}
