"""Iterative graph algorithms on the CSR substrate — the port of
``repro/core/algorithms.py``.

BFS levels, connected components, PageRank and triangle counting over the
anonymized traffic CSR that :func:`repro_torch.core.sparse.csr_from_plan`
builds off the sort-once plan, with the reference's conventions:

  * **Vertex domain.**  The vertices are the compact anonymized ids
    ``[0, n_live)`` in static ``(n_vertices,)`` buffers.  One step is a
    masked :func:`~repro_torch.core.sparse.vxm` push, with
    :func:`~repro_torch.core.sparse.gather_rows` bridging vertex-indexed
    state back to the row slots ``vxm`` consumes.  No sorts.
  * **Fixed points, never silent cap-outs.**  Every loop runs through
    :func:`fixed_point`, whose result carries the executed iteration count
    and a ``converged`` flag: hitting the static cap reports
    ``converged == False``.
  * **float32 carriers.**  Distances and labels ride float32 through the
    semiring kernels; vertex ids and hop counts stay below 2^24, so the
    integer results are exact.

Where JAX has ``lax.while_loop`` the port has a Python loop that reads the
convergence verdict on the host (``.item()``) after every step; where JAX
scans the triangle census over row blocks, so does the port, over the live
rows only (see :func:`triangle_counts`).  Every result equals the
reference's bit for bit, PageRank to float tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..kernels.ops import segmented_reduce
from .ops import _iota
from .sparse import (CsrMatrix, degrees, gather_rows, reduce_rows, scatter_rows,
                     transpose, vxm)

__all__ = [
    "FixedPoint",
    "fixed_point",
    "UNREACHABLE",
    "BfsResult",
    "bfs_levels",
    "ComponentsResult",
    "connected_components",
    "PageRankResult",
    "pagerank",
    "TriangleResult",
    "triangle_counts",
    "AlgorithmResults",
    "graph_algorithms",
]

_INF = float("inf")

#: BFS level / component label reported for unreachable or non-live vertices.
UNREACHABLE = -1


def _device_of(x) -> torch.device:
    if isinstance(x, torch.Tensor):
        return x.device
    for v in x:
        if isinstance(v, torch.Tensor):
            return v.device
    raise ValueError("fixed_point state holds no tensor")


@dataclasses.dataclass(frozen=True)
class FixedPoint:
    """Result of :func:`fixed_point`: final state and how the loop ended.

    ``iterations`` (0-d int32) is the number of steps executed;
    ``converged`` (0-d bool) is False when the static cap was hit first.
    """

    state: Any
    iterations: torch.Tensor
    converged: torch.Tensor


def fixed_point(
    step: Callable[[Any], Any],
    init: Any,
    max_iters: int,
    converged: Callable[[Any, Any], torch.Tensor],
) -> FixedPoint:
    """Iterate ``state = step(state)`` until ``converged(old, new)`` holds
    or ``max_iters`` steps have run.

    The reference's ``lax.while_loop`` with a static cap; here a Python
    loop that reads the verdict on the host after every step.  Capping out
    is reported as ``converged == False``, never passed off as convergence.
    """
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    state, it, conv = init, 0, False
    while not conv and it < max_iters:
        new = step(state)
        conv = bool(converged(state, new))
        state, it = new, it + 1
    device = _device_of(init)
    return FixedPoint(
        state=state,
        iterations=torch.tensor(it, dtype=torch.int32, device=device),
        converged=torch.tensor(conv, device=device),
    )


def _live(n: int, n_live, device) -> torch.Tensor:
    n_live = torch.as_tensor(n if n_live is None else n_live,
                             dtype=torch.int32, device=device)
    return _iota(n, device) < n_live


# -----------------------------------------------------------------------------
# BFS levels — min-plus frontier expansion
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BfsResult:
    """Hop levels from a source over directed edges: ``levels[v]`` is the
    least hop count source -> v, ``UNREACHABLE`` for unreachable and
    non-live vertices; ``iterations`` is eccentricity(source) + 1 when
    converged (the last step confirms the empty frontier)."""

    levels: torch.Tensor     # (n_vertices,) int32
    n_reached: torch.Tensor  # 0-d int32
    iterations: torch.Tensor
    converged: torch.Tensor


def bfs_levels(
    csr: CsrMatrix,
    source,
    n_vertices: int,
    *,
    n_live=None,
    max_iters: Optional[int] = None,
    backend: str = "auto",
) -> BfsResult:
    """BFS hop levels from ``source`` — min-plus masked frontier expansion.

    Each step pushes the frontier's distances one hop through the (min,
    second) semiring, ``cand = vxm(dist | frontier, A) + 1``, then ``dist =
    min(dist, cand)``; the new frontier is the vertices whose distance
    improved, and the fixed point is the empty frontier.  ``max_iters``
    defaults to ``n_vertices``.  A source outside ``[-n_vertices,
    n_vertices)`` reaches nothing (JAX drops an out-of-range scatter; torch
    would raise, so the port checks).
    """
    n = int(n_vertices)
    cap = n if max_iters is None else max_iters
    device = csr.indptr.device
    live = _live(n, n_live, device)
    source = int(source)
    dist0 = torch.full((n,), _INF, dtype=torch.float32, device=device)
    if -n <= source < n:
        dist0[source] = 0.0
    frontier0 = (_iota(n, device) == source) & live

    def step(carry):
        dist, frontier = carry
        x = torch.where(frontier, dist, _INF)
        hop = vxm(gather_rows(csr, x, fill=_INF), csr, n, add="min",
                  mul="second", mask=live, backend=backend) + 1.0
        new = torch.minimum(dist, hop)
        return new, new < dist

    fp = fixed_point(step, (dist0, frontier0), cap,
                     lambda old, new: ~torch.any(new[1]))
    dist, _ = fp.state
    reached = live & torch.isfinite(dist)
    levels = torch.where(reached, dist, float(UNREACHABLE)).to(torch.int32)
    return BfsResult(levels=levels, n_reached=reached.sum(dtype=torch.int32),
                     iterations=fp.iterations, converged=fp.converged)


# -----------------------------------------------------------------------------
# connected components — min-label propagation
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ComponentsResult:
    """Weakly connected components as min-vertex-id labels
    (``UNREACHABLE`` on non-live vertices); ``n_components`` counts the
    label roots over the live range, isolated vertices included."""

    labels: torch.Tensor        # (n_vertices,) int32
    n_components: torch.Tensor  # 0-d int32
    iterations: torch.Tensor
    converged: torch.Tensor


def connected_components(
    csr: CsrMatrix,
    n_vertices: int,
    *,
    csr_t: Optional[CsrMatrix] = None,
    n_live=None,
    max_iters: Optional[int] = None,
    backend: str = "auto",
) -> ComponentsResult:
    """Label propagation under the (min, second) semiring to a fixed point.

    Labels start as own vertex ids; each step takes the min over both edge
    directions (``A`` and ``A^T``) and self, so ``csr_t`` (the challenge's
    dst-keyed CSR) gives weak connectivity with no sort; ``csr_t=None``
    builds it with :func:`repro_torch.core.sparse.transpose` (one sort).
    Converges in at most diameter + 1 steps (cap: ``n_vertices``).
    """
    if csr_t is None:
        csr_t, _ = transpose(csr)
    n = int(n_vertices)
    cap = n if max_iters is None else max_iters
    device = csr.indptr.device
    live = _live(n, n_live, device)
    vids = _iota(n, device)
    labels0 = torch.where(live, vids.to(torch.float32), _INF)

    def step(labels):
        fwd = vxm(gather_rows(csr, labels, fill=_INF), csr, n, add="min",
                  mul="second", mask=live, backend=backend)
        bwd = vxm(gather_rows(csr_t, labels, fill=_INF), csr_t, n, add="min",
                  mul="second", mask=live, backend=backend)
        return torch.minimum(labels, torch.minimum(fwd, bwd))

    fp = fixed_point(step, labels0, cap,
                     lambda old, new: torch.equal(old, new))
    labels = torch.where(live, fp.state, float(UNREACHABLE)).to(torch.int32)
    roots = live & (labels == vids)
    return ComponentsResult(labels=labels,
                            n_components=roots.sum(dtype=torch.int32),
                            iterations=fp.iterations, converged=fp.converged)


# -----------------------------------------------------------------------------
# PageRank — damped plus-times vxm with L1-residual convergence
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PageRankResult:
    """Damped PageRank: ``ranks`` sums to 1 over the live range (0 on
    non-live slots; dangling mass is spread uniformly); ``residual`` is the
    L1 change of the last step."""

    ranks: torch.Tensor     # (n_vertices,) float32
    residual: torch.Tensor  # 0-d float32
    iterations: torch.Tensor
    converged: torch.Tensor


def pagerank(
    csr: CsrMatrix,
    n_vertices: int,
    *,
    n_live=None,
    damping: float = 0.85,
    tol: float = 1e-6,
    max_iters: int = 100,
    weighted: bool = True,
    backend: str = "auto",
) -> PageRankResult:
    """Power iteration ``r = d·(rP + dangling/n) + (1-d)/n`` to L1 ``tol``.

    ``weighted=True`` splits each vertex's rank over its out-edges in
    proportion to packet counts (the (plus, times) semiring against
    ``r / out_weight``); ``weighted=False`` splits it evenly.  The damping
    factor is a float32 scalar, as in the reference, so both compute the
    same float32 constants.
    """
    n = int(n_vertices)
    device = csr.indptr.device
    n_live_ = torch.as_tensor(n if n_live is None else n_live,
                              dtype=torch.int32, device=device)
    live = _iota(n, device) < n_live_
    nf = torch.clamp(n_live_, min=1).to(torch.float32)
    d = torch.tensor(damping, dtype=torch.float32, device=device)

    w_slot = (reduce_rows(csr, "plus") if weighted else degrees(csr))
    outw = scatter_rows(csr, w_slot.to(torch.float32), n, fill=0.0)
    base = torch.where(live, 1.0 / nf, 0.0)
    mul = "times" if weighted else "second"
    has_out = outw > 0
    safe_outw = torch.where(has_out, outw, 1.0)
    dangling_mask = live & ~has_out

    def step(carry):
        r, _ = carry
        contrib = torch.where(has_out, r / safe_outw, 0.0)
        y = vxm(gather_rows(csr, contrib, fill=0.0), csr, n, add="plus",
                mul=mul, mask=live, backend=backend)
        dangling = torch.where(dangling_mask, r, 0.0).sum()
        new = d * (y + dangling * base) + (1.0 - d) * base
        return new, (new - r).abs().sum()

    tol32 = torch.tensor(tol, dtype=torch.float32, device=device)
    fp = fixed_point(step, (base, torch.tensor(_INF, device=device)),
                     max_iters, lambda old, new: new[1] < tol32)
    ranks, residual = fp.state
    return PageRankResult(ranks=ranks, residual=residual,
                          iterations=fp.iterations, converged=fp.converged)


# -----------------------------------------------------------------------------
# triangle counting — masked sparse A ⊙ (A·A)
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TriangleResult:
    """Structural ``C = A ⊙ (A·A)``: ``per_entry[e]`` counts the length-2
    directed paths closing stored edge e, ``per_node`` sums them per source
    vertex and ``total`` over the graph."""

    per_entry: torch.Tensor  # (nnz_capacity,) float32
    per_node: torch.Tensor   # (n_vertices,) float32
    total: torch.Tensor      # 0-d int32


def _popcount63(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 in ``[0, 2^63)`` (SWAR, no overflow)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def triangle_counts(
    csr: CsrMatrix,
    n_vertices: int,
    *,
    block: int = 63,
    backend: str = "auto",
) -> TriangleResult:
    """Structural ``A ⊙ (A·A)`` without forming A·A — zero sorts.

    Only the stored coordinates of ``A`` are evaluated: for each stored
    (i, j), ``Σ_k A[i, k]·A[k, j]`` accumulated over blocks of ``block``
    middle vertices k (row slots).  The reference densifies each block as a
    ``(block, n_vertices)`` float32 slice of A; the port keeps the same
    blocked scan but packs a block's 0/1 row into the bits of one int64
    (``block <= 63``, so the words stay non-negative): ``right[j]`` has bit
    b where ``A[k0+b, j]``, ``left[r]`` bit b where ``A[r, key(k0+b)]``, and
    the wedge count of entry (i, j) is ``popcount(left[i] & right[j])``.
    Bits of distinct coordinates never collide, so ``index_add_`` sets them.
    The scan walks the live rows only (``n_rows / block`` steps, with the
    blocks' row pointers read on the host); a block's own entries are a
    contiguous range of the CSR.  Counts are integers, so any block size and layout
    give the reference's numbers; ``per_node`` rolls up through the
    histogram kernel with an int32 accumulator (exact), and ``total`` sums
    the int64 per-entry counts.
    """
    n = int(n_vertices)
    blk = int(block)
    if not 1 <= blk <= 63:
        raise ValueError(f"block must be in [1, 63], got {blk}")
    device = csr.indptr.device
    cap_r, cap_e = csr.row_capacity, csr.nnz_capacity
    nnz, n_rows = int(csr.nnz), int(csr.n_rows)
    rows_all = csr.entry_rows()
    rows_e = rows_all[:nnz].long()          # live entries are the prefix
    keys_e = csr.col_keys[:nnz]
    cols_e = keys_e.to(torch.int32)
    col_ok = (cols_e >= 0) & (cols_e < n)
    col_safe = torch.clamp(cols_e, 0, n - 1).long()

    # the row slot owning vertex col_keys[e], if any (a lookup: searchsorted
    # ranks, the equality check confirms)
    rk = csr.row_keys[0]
    pos = torch.searchsorted(rk, keys_e)
    pos_safe = torch.clamp(pos, max=cap_r - 1)
    hit = (pos < n_rows) & (rk[pos_safe] == keys_e)
    c_step = torch.where(hit, pos_safe // blk, -1)
    c_bit = torch.bitwise_left_shift(torch.ones_like(pos_safe), pos_safe % blk)
    r_bit = torch.bitwise_left_shift(torch.ones_like(rows_e), rows_e % blk)
    # entry range of each block of rows: the row pointers at block starts
    starts = torch.arange(0, n_rows + blk, blk, device=device).clamp(max=n_rows)
    bounds = csr.indptr[starts].tolist()

    acc = torch.zeros(nnz, dtype=torch.int64, device=device)
    right = torch.zeros(n, dtype=torch.int64, device=device)
    left = torch.zeros(cap_r, dtype=torch.int64, device=device)
    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        # entries outside the block add 0 at their own slot: sending them
        # all to one spill slot would serialize a million atomics on it
        right.zero_().index_add_(0, col_safe[lo:hi],
                                 torch.where(col_ok[lo:hi], r_bit[lo:hi], 0))
        left.zero_().index_add_(0, rows_e, torch.where(c_step == s, c_bit, 0))
        acc += _popcount63(left[rows_e] & right[col_safe])
    acc = torch.where(col_ok, acc, 0)

    per_entry = torch.zeros(cap_e, dtype=torch.float32, device=device)
    per_entry[:nnz] = acc.to(torch.float32)
    counts = torch.zeros(cap_e, dtype=torch.int32, device=device)
    counts[:nnz] = acc.to(torch.int32)
    rvert = csr.entry_row_key(0, rows_all).to(torch.int32)
    seg = torch.where(csr.entry_mask() & (rvert >= 0) & (rvert < n), rvert, -1)
    per_node = segmented_reduce(counts, seg, n, op="sum", out_dtype=torch.int32,
                                backend=backend).to(torch.float32)
    return TriangleResult(per_entry=per_entry, per_node=per_node,
                          total=acc.sum().to(torch.int32))


# -----------------------------------------------------------------------------
# the bundle — all four off one plan pair
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlgorithmResults:
    """All four Graph Challenge algorithms off one (A, A^T) CSR pair."""

    bfs: BfsResult
    components: ComponentsResult
    pagerank: PageRankResult
    triangles: TriangleResult


def graph_algorithms(
    csr_src: CsrMatrix,
    csr_dst: CsrMatrix,
    n_vertices: int,
    *,
    n_live=None,
    source=0,
    damping: float = 0.85,
    tol: float = 1e-6,
    pagerank_iters: int = 100,
    max_iters: Optional[int] = None,
    backend: str = "auto",
) -> AlgorithmResults:
    """BFS + components + PageRank + triangles off the plan's CSR pair
    (``csr_src`` = A, ``csr_dst`` = A^T, components' transpose): no sort."""
    return AlgorithmResults(
        bfs=bfs_levels(csr_src, source, n_vertices, n_live=n_live,
                       max_iters=max_iters, backend=backend),
        components=connected_components(
            csr_src, n_vertices, csr_t=csr_dst, n_live=n_live,
            max_iters=max_iters, backend=backend),
        pagerank=pagerank(csr_src, n_vertices, n_live=n_live, damping=damping,
                          tol=tol, max_iters=pagerank_iters, backend=backend),
        triangles=triangle_counts(csr_src, n_vertices, backend=backend),
    )
