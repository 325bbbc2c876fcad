"""``pcaplite`` — the port's copy of ``repro/data/pcaplite.py``.

A PCAP-style sequential binary packet format: fixed-size little-endian
records in file order (row-major, like PCAP).  The port keeps the writer and
the vectorized reader the challenge's read phase uses; files are
byte-identical to the reference's.

Record layout (24 bytes, little-endian):
    ts u64 | src u32 | dst u32 | sport u16 | dport u16 | proto u8 |
    pad u8 | length u16
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["RECORD_DTYPE", "write_pcaplite", "parse_fast"]

RECORD_DTYPE = np.dtype([
    ("ts", "<u8"),
    ("src", "<u4"),
    ("dst", "<u4"),
    ("sport", "<u2"),
    ("dport", "<u2"),
    ("proto", "u1"),
    ("pad", "u1"),
    ("length", "<u2"),
])

_MAGIC = b"PCPL\x01\x00\x00\x00"


def write_pcaplite(path: str, cols: Dict[str, np.ndarray]) -> None:
    n = len(cols["src"])
    rec = np.zeros(n, RECORD_DTYPE)
    for k in ("ts", "src", "dst", "sport", "dport", "proto", "length"):
        if k in cols:
            rec[k] = cols[k]
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(rec.tobytes())


def parse_fast(path: str) -> Dict[str, np.ndarray]:
    """Vectorized parse: one read + dtype view (numpy ceiling for row-major)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"{path}: bad pcaplite magic")
        rec = np.frombuffer(f.read(), RECORD_DTYPE)
    return {k: np.ascontiguousarray(rec[k]) for k in ("ts", "src", "dst", "sport",
                                                      "dport", "proto", "length")}
