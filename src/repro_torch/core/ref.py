"""NumPy oracle for the challenge queries — the port's copy of
``repro/core/ref.py`` (the "single-core Pandas" role).

A straightforward, sequential NumPy implementation of the Table III queries
with dynamic shapes: the ground truth the port is checked against, on the
CPU in the tests and on the card by ``chip_smoke.py``.

The graph-algorithm oracles (``ref_bfs``, ``ref_cc``, ``ref_pagerank``,
``ref_triangles``) are the port's copy of ``repro/kernels/ref.py:229-342``:
deliberately boring NumPy/SciPy (a queue, union-find, dense power iteration,
a SciPy sparse product), structurally unlike the semiring fixed points of
:mod:`repro_torch.core.algorithms`, so agreement is evidence.  They sit
here, beside the other NumPy oracles, because the port's
``kernels/ref.py`` holds the kernels' plain PyTorch versions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "ref_traffic_matrix",
    "ref_run_all_queries",
    "ref_anonymize_check",
    "ref_top_links",
    "ref_windowed_histogram",
    "ref_window_ip_overlap",
    "ref_bfs",
    "ref_cc",
    "ref_pagerank",
    "ref_triangles",
]


def _weights(src: np.ndarray, n_packets: Optional[np.ndarray]) -> np.ndarray:
    return np.ones(len(src), np.int64) if n_packets is None else np.asarray(n_packets, np.int64)


def ref_traffic_matrix(src, dst, n_packets=None):
    """A_t as (src, dst, packets) arrays, lexicographically sorted."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    w = _weights(src, n_packets)
    order = np.lexsort((dst, src))
    s, d, w = src[order], dst[order], w[order]
    first = np.ones(len(s), bool)
    first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
    seg = np.cumsum(first) - 1
    packets = np.zeros(int(seg[-1]) + 1 if len(seg) else 0, np.int64)
    np.add.at(packets, seg, w)
    return s[first], d[first], packets


def ref_run_all_queries(src, dst, n_packets=None) -> Dict[str, int]:
    """All scalar challenge statistics (paper Table III), dynamically shaped."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    w = _weights(src, n_packets)
    ls, ld, lp = ref_traffic_matrix(src, dst, n_packets)

    def _maxcount(x) -> int:
        if len(x) == 0:
            return 0
        return int(np.unique(x, return_counts=True)[1].max())

    def _max_groupsum(keys, vals) -> int:
        if len(keys) == 0:
            return 0
        _, inv = np.unique(keys, return_inverse=True)
        sums = np.zeros(inv.max() + 1, np.int64)
        np.add.at(sums, inv, vals)
        return int(sums.max())

    return {
        "valid_packets": int(w.sum()),
        "unique_links": int(len(ls)),
        "max_link_packets": int(lp.max()) if len(lp) else 0,
        "n_unique_sources": int(len(np.unique(src))),
        "n_unique_destinations": int(len(np.unique(dst))),
        "n_unique_ips": int(len(np.unique(np.concatenate([src, dst])))),
        "max_source_packets": _max_groupsum(src, w),
        "max_source_fanout": _maxcount(ls),
        "max_destination_packets": _max_groupsum(dst, w),
        "max_destination_fanin": _maxcount(ld),
    }


def ref_top_links(src, dst, k, n_packets=None):
    """Oracle for the top-k links: k heaviest, ties by (src, dst) ascending."""
    ls, ld, lp = ref_traffic_matrix(src, dst, n_packets)
    order = np.lexsort((ld, ls, -lp))[:k]
    return ls[order], ld[order], lp[order]


def ref_windowed_histogram(win, ids, n_windows, num_bins, weights=None) -> np.ndarray:
    """Oracle for kernels.ops.windowed_histogram: 2-D bincount."""
    win = np.asarray(win)
    ids = np.asarray(ids)
    w = np.ones(len(ids), np.float64) if weights is None else np.asarray(weights, np.float64)
    out = np.zeros((n_windows, num_bins), np.float64)
    ok = (win >= 0) & (win < n_windows) & (ids >= 0) & (ids < num_bins)
    np.add.at(out, (win[ok], ids[ok]), w[ok])
    return out


def ref_window_ip_overlap(src, dst, win, n_windows) -> np.ndarray:
    """Oracle for challenge.cross_window_ip_overlap: overlap[w] = |distinct
    IPs (src ∪ dst) active in window w AND in w-1|; overlap[0] = 0."""
    win = np.asarray(win)
    per_window = [
        set(np.concatenate([np.asarray(src)[win == w], np.asarray(dst)[win == w]]).tolist())
        for w in range(n_windows)
    ]
    out = np.zeros(n_windows, np.int64)
    for w in range(1, n_windows):
        out[w] = len(per_window[w] & per_window[w - 1])
    return out


def ref_anonymize_check(orig_src, orig_dst, anon_src, anon_dst) -> bool:
    """Anonymization invariant: the mapping IP -> id is a graph isomorphism,
    a bijection onto [0, n_unique_ips) that preserves the edge multiset."""
    orig = np.concatenate([orig_src, orig_dst])
    anon = np.concatenate([anon_src, anon_dst])
    mapping: Dict[int, int] = {}
    for o, a in zip(orig.tolist(), anon.tolist()):
        if mapping.setdefault(o, a) != a:
            return False  # not a function
    vals = sorted(mapping.values())
    n = len(np.unique(orig))
    if vals != list(range(n)):
        return False  # not a bijection onto [0, n)
    remapped = [(mapping[s], mapping[d]) for s, d in zip(orig_src.tolist(), orig_dst.tolist())]
    return sorted(remapped) == sorted(zip(anon_src.tolist(), anon_dst.tolist()))


def _ref_adjacency(
    src: np.ndarray, dst: np.ndarray, n_vertices: int
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR-ish adjacency: (neighbors sorted by source, per-source offsets)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    order = np.argsort(src, kind="stable")
    starts = np.searchsorted(src[order], np.arange(n_vertices + 1))
    return dst[order], starts


def ref_bfs(
    src: np.ndarray, dst: np.ndarray, n_vertices: int, source: int
) -> np.ndarray:
    """Textbook queue BFS over directed edges: hop levels, -1 unreachable."""
    levels = np.full(n_vertices, -1, np.int32)
    if not 0 <= source < n_vertices:
        return levels
    nbrs, starts = _ref_adjacency(src, dst, n_vertices)
    levels[source] = 0
    frontier = [source]
    depth = 0
    while frontier:
        depth += 1
        nxt = []
        for u in frontier:
            for v in nbrs[starts[u]:starts[u + 1]]:
                if levels[v] < 0:
                    levels[v] = depth
                    nxt.append(int(v))
        frontier = nxt
    return levels


def ref_cc(src: np.ndarray, dst: np.ndarray, n_vertices: int) -> np.ndarray:
    """Weakly connected components by union-find: label = min vertex id in
    the component (isolated vertices are their own singletons)."""
    parent = np.arange(n_vertices, dtype=np.int64)

    def find(u):
        root = u
        while parent[root] != root:
            root = parent[root]
        while parent[u] != root:  # path compression
            parent[u], u = root, parent[u]
        return root

    for u, v in zip(np.asarray(src, np.int64), np.asarray(dst, np.int64)):
        ru, rv = find(u), find(v)
        if ru != rv:
            # union by min id keeps the root the component minimum
            lo, hi = (ru, rv) if ru < rv else (rv, ru)
            parent[hi] = lo
    return np.array([find(u) for u in range(n_vertices)], np.int32)


def ref_pagerank(
    src: np.ndarray,
    dst: np.ndarray,
    weights: np.ndarray,
    n_vertices: int,
    *,
    damping: float = 0.85,
    tol: float = 1e-6,
    max_iters: int = 100,
) -> Tuple[np.ndarray, int, bool]:
    """Dense float64 power iteration, same update as core.algorithms.pagerank.

    Duplicate (src, dst) rows act as additive weights (np.add.at), matching
    the duplicate-collapsing CSR build.  Returns (ranks, iterations,
    converged).
    """
    n = int(n_vertices)
    if n == 0:
        return np.zeros((0,), np.float64), 0, True
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(weights, np.float64)
    outw = np.zeros(n, np.float64)
    np.add.at(outw, src, w)
    r = np.full(n, 1.0 / n, np.float64)
    for it in range(1, max_iters + 1):
        contrib = np.divide(r, outw, out=np.zeros_like(r), where=outw > 0)
        y = np.zeros(n, np.float64)
        np.add.at(y, dst, w * contrib[src])
        dangling = r[outw <= 0].sum()
        new = damping * (y + dangling / n) + (1.0 - damping) / n
        residual = np.abs(new - r).sum()
        r = new
        if residual < tol:
            return r, it, True
    return r, max_iters, False


def ref_triangles(
    src: np.ndarray, dst: np.ndarray, n_vertices: int
) -> Tuple[np.ndarray, int]:
    """Masked sparse product C = A ⊙ (A·A) via SciPy (structural A).

    Returns (per-source-vertex wedge-closure counts, global total) — the
    oracle for core.algorithms.triangle_counts.
    """
    import scipy.sparse as sp

    n = int(n_vertices)
    a = sp.csr_matrix(
        (np.ones(len(src), np.float64),
         (np.asarray(src, np.int64), np.asarray(dst, np.int64))),
        shape=(n, n),
    )
    a.data[:] = 1.0  # collapse duplicate edges to structural 1s
    c = a.multiply(a @ a)
    per_node = np.asarray(c.sum(axis=1)).ravel()
    return per_node, int(round(c.sum()))
