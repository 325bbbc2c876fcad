"""RMAT synthetic traffic generator — the port's copy of ``repro/data/rmat.py``.

Stands in for the challenge's 2^30-packet capture; RMAT's recursive quadrant
sampling gives the hypersparse power-law src/dst distribution the challenge
highlights.  NumPy only, and kept byte-for-byte equivalent to the reference:
the same ``(scale, n, seed)`` yields the same columns.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["rmat_edges", "synthetic_packets"]


def rmat_edges(
    scale: int,
    n_edges: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generate n_edges (src, dst) pairs over 2^scale vertices, vectorized."""
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r = rng.random(n_edges)
        right = (r >= a) & (r < ab)          # top-right: dst bit set
        bottom = (r >= ab) & (r < abc)       # bottom-left: src bit set
        both = r >= abc                      # bottom-right: both
        src = (src << 1) | (bottom | both)
        dst = (dst << 1) | (right | both)
    return src.astype(np.uint32), dst.astype(np.uint32)


def synthetic_packets(
    n_packets: int,
    scale: int = 20,
    seed: int = 0,
    with_ports: bool = True,
):
    """A PCAP-like packet table: RMAT endpoints + timestamps/ports/sizes."""
    rng = np.random.default_rng(seed + 1)
    src, dst = rmat_edges(scale, n_packets, seed=seed)
    cols = {
        "ts": np.cumsum(rng.integers(1, 1000, n_packets).astype(np.uint64)),
        "src": src,
        "dst": dst,
        "length": rng.integers(64, 1500, n_packets).astype(np.uint16),
    }
    if with_ports:
        cols["sport"] = rng.integers(1024, 65535, n_packets).astype(np.uint16)
        cols["dport"] = rng.choice(
            np.array([53, 80, 443, 8080, 22], np.uint16), n_packets
        )
        cols["proto"] = rng.choice(np.array([6, 17], np.uint8), n_packets)
    return cols
