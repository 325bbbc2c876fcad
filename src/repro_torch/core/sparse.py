"""Static-shape CSR traffic matrices — the port of ``repro/core/sparse.py``.

:class:`CsrMatrix` keeps the reference's static-shape discipline: every
buffer has a fixed capacity, validity is the row-pointer prefix
(``indptr[r] == nnz`` for every padding row), entry tails are padding
(column key = dtype max, value 0).  :func:`csr_from_plan` builds one off a
``SortedEdges`` plan with scatters only, zero sorts.  The GraphBLAS-lite
operations are :func:`reduce_rows`, :func:`reduce_cols`, :func:`degrees`,
the masked semiring
products :func:`mxv`/:func:`vxm` (their reduction goes through the kernels
of :mod:`repro_torch.kernels.ops`: the histogram kernel for plus, the
segment-max kernel for max, and for min by negation) and the bridges
:func:`gather_rows`/:func:`scatter_rows` between vertex and row-slot
domains.  The duplicate-collapsing constructor :func:`from_coo` (one sort,
two passes for a two-column row key; overflow counted) and the CSR union
:func:`ewise_union` carry the streaming engine's upsert and merge;
:func:`transpose` (one ``from_coo`` sort) and :func:`symmetrize` (A ⊕ A^T
through ``ewise_union``) are built on them.

One difference from JAX shapes the code: under ``jit`` XLA shares the
binary search of :meth:`CsrMatrix.entry_rows` between every use, but an
eager program would redo it in every ``vxm`` of every algorithm step, so the
port computes it once per matrix and keeps it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.ops import segmented_reduce
from .ops import (
    _count,
    _iota,
    _max_ident,
    _min_ident,
    _scatter_firsts,
    _segment_extreme,
    multi_key_sort,
    segment_ids_from_sorted,
    segment_sum,
)
from .plan import SortedEdges

__all__ = [
    "CsrMatrix",
    "csr_from_plan",
    "from_coo",
    "ewise_union",
    "reduce_rows",
    "reduce_cols",
    "degrees",
    "mxv",
    "vxm",
    "transpose",
    "symmetrize",
    "gather_rows",
    "scatter_rows",
]


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """Static-shape CSR: row pointers + column keys + values, tail-padded.

    ``row_keys`` is a tuple of ``(row_capacity,)`` key columns identifying
    each row (padding = dtype max); ``indptr`` has ``row_capacity + 1``
    slots, ``nnz`` on every padding row; ``col_keys``/``vals`` are the
    ``(nnz_capacity,)`` entry buffers (padding dtype max / 0); ``n_rows``
    and ``nnz`` are the live counts (0-d int32).
    """

    row_keys: Tuple[torch.Tensor, ...]
    indptr: torch.Tensor
    col_keys: torch.Tensor
    vals: torch.Tensor
    n_rows: torch.Tensor
    nnz: torch.Tensor

    @property
    def row_capacity(self) -> int:
        return self.row_keys[0].shape[0]

    @property
    def nnz_capacity(self) -> int:
        return self.col_keys.shape[0]

    def row_mask(self) -> torch.Tensor:
        return _iota(self.row_capacity, self.indptr.device) < self.n_rows

    def entry_mask(self) -> torch.Tensor:
        return _iota(self.nnz_capacity, self.indptr.device) < self.nnz

    @functools.cached_property
    def _entry_rows(self) -> torch.Tensor:
        idx = _iota(self.nnz_capacity, self.indptr.device)
        rows = torch.searchsorted(self.indptr, idx, right=True).to(torch.int32) - 1
        return torch.where(idx < self.nnz, rows, self.row_capacity)

    def entry_rows(self) -> torch.Tensor:
        """Row id of each stored entry (``row_capacity`` on padding slots):
        entry i belongs to row r iff ``indptr[r] <= i < indptr[r + 1]``, one
        binary search per entry, computed once per matrix."""
        return self._entry_rows

    def entry_row_key(self, k: int = 0,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Row key column ``k`` expanded to per-entry granularity (dtype max
        on padding entries)."""
        key = self.row_keys[k]
        rows = self.entry_rows() if rows is None else rows
        safe = torch.clamp(rows, 0, self.row_capacity - 1).long()
        return torch.where(self.entry_mask(), key[safe], _max_ident(key.dtype))


def csr_from_plan(plan: SortedEdges) -> CsrMatrix:
    """The traffic matrix A_t as CSR off an existing plan — zero sorts.

    The plan's link segmentation is the entry list (column = key1, value =
    the link's weight sum), its key0 segmentation the row list, and the link
    id at each key0-group start that row's pointer.
    """
    cap = plan.capacity
    device = plan.key0.device
    valid = plan.valid_rows()
    col_keys = _scatter_firsts(plan.key1, plan.seg, plan.first, cap)
    vals = segment_sum(torch.where(valid, plan.w, 0), plan.seg, cap + 1)[:cap]
    row_keys = (_scatter_firsts(plan.key0, plan.k0_seg, plan.k0_first, cap),)
    # row pointer = link id at the first packet-row of each key0 group; the
    # spill slot cap takes every other row and is overwritten below
    starts = torch.zeros(cap + 1, dtype=torch.int32, device=device).scatter_(
        0, torch.where(plan.k0_first.bool(), plan.k0_seg, cap).long(), plan.seg)
    indptr = torch.where(_iota(cap + 1, device) < plan.n_k0, starts,
                         plan.n_links)
    return CsrMatrix(row_keys=row_keys, indptr=indptr, col_keys=col_keys,
                     vals=vals, n_rows=plan.n_k0, nnz=plan.n_links)


def _resize(a: torch.Tensor, size: int, fill) -> torch.Tensor:
    if a.shape[0] >= size:
        return a[:size]
    return torch.cat([a, torch.full((size - a.shape[0],), fill, dtype=a.dtype,
                                    device=a.device)])


_COO_AGGS = ("plus", "max", "min")


def from_coo(
    row_keys: Sequence[torch.Tensor],
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_valid=None,
    valid_mask: Optional[torch.Tensor] = None,
    *,
    op: str = "plus",
    nnz_capacity: Optional[int] = None,
    row_capacity: Optional[int] = None,
) -> Tuple[CsrMatrix, torch.Tensor]:
    """Duplicate-collapsing COO -> CSR: ONE sort by (row_keys..., cols).

    Duplicate (row, col) coordinates collapse under ``op`` (``"plus"``,
    ``"max"`` or ``"min"``, GraphBLAS ``GrB_Matrix_build`` semantics).  A
    one-column row key packs into one sort pass, a two-column one takes
    two (:func:`repro_torch.core.ops.multi_key_sort`).

    ``nnz_capacity`` (default: the input capacity) bounds the output
    entries and ``row_capacity`` (default ``nnz_capacity``) the rows;
    groups past either, the lexicographically largest, are dropped and
    counted in the returned ``dropped`` (0-d int32), never silently.

    Returns ``(csr, dropped)``.
    """
    if op not in _COO_AGGS:
        raise ValueError(f"unknown dup-collapse op {op!r}")
    cap_in = cols.shape[0]
    device = cols.device
    nnz_cap = cap_in if nnz_capacity is None else nnz_capacity
    row_cap = nnz_cap if row_capacity is None else row_capacity
    if valid_mask is not None:
        n_valid = valid_mask.sum(dtype=torch.int32)
    else:
        n_valid = _count(n_valid, cap_in, device)

    skeys, (svals,) = multi_key_sort(
        [*row_keys, cols], [vals],
        n_valid=None if valid_mask is not None else n_valid,
        valid_mask=valid_mask,
    )
    *srow_keys, scols = skeys
    seg, first, n_groups = segment_ids_from_sorted(skeys, n_valid)
    r_seg, r_first, _ = segment_ids_from_sorted(srow_keys, n_valid)
    valid = _iota(cap_in, device) < n_valid

    # entry buffers at input granularity (group slot g = entry g)
    g_cols = _scatter_firsts(scols, seg, first, cap_in)
    if op == "plus":
        agg = segment_sum(torch.where(valid, svals, 0), seg, cap_in + 1)[:cap_in]
    else:
        ident = (_min_ident if op == "max" else _max_ident)(svals.dtype)
        agg = _segment_extreme(torch.where(valid, svals, ident), seg, cap_in + 1,
                               "amax" if op == "max" else "amin", ident)[:cap_in]

    # row id of each entry (group), via the group-start scatter; the spill
    # slot cap_in takes every other row and is cut off
    entry_row = torch.full((cap_in + 1,), row_cap, dtype=torch.int32,
                           device=device).scatter_(
        0, torch.where(first.bool(), seg, cap_in).long(), r_seg)[:cap_in]
    # truncation: entries are lex-sorted, so both overflow cuts are suffix
    # cuts — keep the first n_kept groups, count the rest as dropped
    gidx = _iota(cap_in, device)
    fits_rows = ((gidx < n_groups) & (entry_row < row_cap)).sum(dtype=torch.int32)
    n_kept = torch.minimum(torch.clamp(n_groups, max=nnz_cap), fits_rows)
    dropped = n_groups - n_kept
    # a 1-element gather, not a 0-d index (which reads it on the host)
    last = entry_row.index_select(0, torch.clamp(n_kept - 1, min=0).view(1))[0]
    n_rows_kept = torch.where(n_kept > 0, last + 1, 0).to(torch.int32)

    e_live = _iota(nnz_cap, device) < n_kept
    col_max = _max_ident(g_cols.dtype)
    col_keys = torch.where(e_live, _resize(g_cols, nnz_cap, col_max), col_max)
    out_vals = torch.where(e_live, _resize(agg, nnz_cap, 0), 0)

    r_live = _iota(row_cap, device) < n_rows_kept
    out_row_keys = []
    for k, sk in zip(row_keys, srow_keys):
        kmax = _max_ident(k.dtype)
        buf = _scatter_firsts(sk, r_seg, r_first, cap_in)
        out_row_keys.append(torch.where(r_live, _resize(buf, row_cap, kmax), kmax))

    # row pointer = entry id at the first row of each row group
    starts = torch.zeros(cap_in + 1, dtype=torch.int32, device=device).scatter_(
        0, torch.where(r_first.bool(), r_seg, cap_in).long(), seg)
    indptr = torch.where(_iota(row_cap + 1, device) < n_rows_kept,
                         torch.minimum(_resize(starts, row_cap + 1, 0), n_kept),
                         n_kept)
    csr = CsrMatrix(row_keys=tuple(out_row_keys), indptr=indptr,
                    col_keys=col_keys, vals=out_vals, n_rows=n_rows_kept,
                    nnz=n_kept)
    return csr, dropped


def ewise_union(
    a: CsrMatrix,
    b: CsrMatrix,
    *,
    op: str = "plus",
    nnz_capacity: Optional[int] = None,
    row_capacity: Optional[int] = None,
) -> Tuple[CsrMatrix, torch.Tensor]:
    """CSR ↔ CSR element-wise union (GraphBLAS ``eWiseAdd``): the entries
    of either operand, coincident coordinates combined under ``op``.  One
    concat and one :func:`from_coo`; returns ``(csr, dropped)`` with
    overflow counted as there."""
    if len(a.row_keys) != len(b.row_keys):
        raise ValueError(
            f"row-key arity mismatch: {len(a.row_keys)} vs {len(b.row_keys)}")
    if nnz_capacity is None:
        nnz_capacity = max(a.nnz_capacity, b.nnz_capacity)
    if row_capacity is None:
        row_capacity = max(a.row_capacity, b.row_capacity)
    rows = [torch.cat([a.entry_row_key(i), b.entry_row_key(i)])
            for i in range(len(a.row_keys))]
    return from_coo(
        rows, torch.cat([a.col_keys, b.col_keys]), torch.cat([a.vals, b.vals]),
        valid_mask=torch.cat([a.entry_mask(), b.entry_mask()]),
        op=op, nnz_capacity=nnz_capacity, row_capacity=row_capacity,
    )


def reduce_rows(csr: CsrMatrix, op: str = "plus") -> torch.Tensor:
    """A·1 under the plus or max monoid, exact in the values' dtype; empty
    and padding rows report 0 (no kernel: :func:`mxv` is the float
    semiring path)."""
    seg = csr.entry_rows()
    live = csr.entry_mask()
    cap = csr.row_capacity
    vals = torch.where(live, csr.vals, 0)
    if op == "plus":
        return segment_sum(vals, seg, cap + 1)[:cap]
    if op == "max":
        return torch.clamp(_segment_extreme(
            vals, seg, cap + 1, "amax", _min_ident(vals.dtype))[:cap], min=0)
    raise ValueError(f"unknown monoid {op!r}")


def reduce_cols(csr: CsrMatrix, num_cols: int, op: str = "plus") -> torch.Tensor:
    """1^T·A over a compact column domain: the column keys are the bins.

    Entries whose column falls outside ``[0, num_cols)`` are dropped;
    empty columns report 0, as in :func:`reduce_rows`.
    """
    ok = csr.entry_mask() & (csr.col_keys >= 0) & (csr.col_keys < num_cols)
    seg = torch.where(ok, csr.col_keys.to(torch.int32), num_cols)
    vals = torch.where(ok, csr.vals, 0)
    if op == "plus":
        return segment_sum(vals, seg, num_cols + 1)[:num_cols]
    if op == "max":
        return torch.clamp(_segment_extreme(
            vals, seg, num_cols + 1, "amax", _min_ident(vals.dtype))[:num_cols],
            min=0)
    raise ValueError(f"unknown monoid {op!r}")


def degrees(csr: CsrMatrix) -> torch.Tensor:
    """|A|_0·1 — stored entries per row, a pointer difference."""
    return (csr.indptr[1:] - csr.indptr[:-1]).to(torch.int32)


_ADD_OPS = {"plus": "sum", "max": "max", "min": "max"}
_MUL_OPS = ("times", "first", "second")
_ADD_IDENTS = {"plus": 0.0, "max": float("-inf"), "min": float("inf")}


def _semiring_reduce(prod: torch.Tensor, seg: torch.Tensor, num_segments: int,
                     add: str, backend: str,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ⊕ reduction.  Min rides the max kernel by negation
    (``min(x) = -max(-x)``, identity ``+inf``); ``mask`` rides the kernels'
    ``valid_mask``/``retire`` epilogue, with masked-out segments taking the
    ⊕ identity."""
    if add == "min":
        return -segmented_reduce(
            -prod, seg, num_segments, op="max", backend=backend,
            valid_mask=mask, retire=None if mask is None else -_ADD_IDENTS["min"])
    return segmented_reduce(
        prod, seg, num_segments, op=_ADD_OPS[add], backend=backend,
        valid_mask=mask, retire=None if mask is None else _ADD_IDENTS[add])


def _products(vals: torch.Tensor, xv: torch.Tensor, mul: str) -> torch.Tensor:
    v = vals.to(torch.float32)
    if mul == "times":
        return v * xv
    if mul == "first":
        return v
    return xv  # "second"


def _check_semiring(add: str, mul: str) -> None:
    if add not in _ADD_OPS or mul not in _MUL_OPS:
        raise ValueError(f"unsupported semiring ({add!r}, {mul!r})")


def mxv(csr: CsrMatrix, x: torch.Tensor, *, add: str = "plus",
        mul: str = "times", mask: Optional[torch.Tensor] = None,
        backend: str = "auto") -> torch.Tensor:
    """Masked ``y = A ⊕.⊗ x`` over the (add, mul) semiring, float32.

    ``x`` is indexed by column key (entries with out-of-range columns drop
    out); ``mask`` (``(row_capacity,)`` bool) keeps only the selected output
    rows; unmasked and empty rows report the ⊕ identity (0, ``-inf`` or
    ``+inf``).
    """
    _check_semiring(add, mul)
    n_x = x.shape[0]
    ok = csr.entry_mask() & (csr.col_keys >= 0) & (csr.col_keys < n_x)
    safe = torch.clamp(csr.col_keys.to(torch.int32), 0, n_x - 1).long()
    prod = _products(csr.vals, x[safe].to(torch.float32), mul)
    seg = torch.where(ok, csr.entry_rows(), -1)
    return _semiring_reduce(prod, seg, csr.row_capacity, add, backend, mask)


def vxm(x: torch.Tensor, csr: CsrMatrix, num_cols: int, *, add: str = "plus",
        mul: str = "times", mask: Optional[torch.Tensor] = None,
        backend: str = "auto") -> torch.Tensor:
    """Masked ``y = x ⊕.⊗ A`` — the column-side mirror of :func:`mxv`:
    ``x`` is indexed by row slot, the output has ``num_cols`` slots indexed
    by column key."""
    _check_semiring(add, mul)
    rows = csr.entry_rows()
    ok = (csr.entry_mask() & (csr.col_keys >= 0) & (csr.col_keys < num_cols)
          & (rows < x.shape[0]))
    safe = torch.clamp(rows, 0, x.shape[0] - 1).long()
    prod = _products(csr.vals, x[safe].to(torch.float32), mul)
    seg = torch.where(ok, csr.col_keys.to(torch.int32), -1)
    return _semiring_reduce(prod, seg, num_cols, add, backend, mask)


def transpose(
    csr: CsrMatrix,
    *,
    nnz_capacity: Optional[int] = None,
    row_capacity: Optional[int] = None,
) -> Tuple[CsrMatrix, torch.Tensor]:
    """A^T of a CSR with a one-column row key: ONE :func:`from_coo` sort of
    the entries by (column, row).  Entries are distinct, so at the default
    capacities nothing drops; ``dropped`` counts what a smaller capacity
    cuts.  Returns ``(csr_t, dropped)``."""
    if len(csr.row_keys) != 1:
        raise ValueError(
            f"transpose needs a 1-column row key, got {len(csr.row_keys)}")
    return from_coo(
        [csr.col_keys], csr.entry_row_key(0), csr.vals,
        valid_mask=csr.entry_mask(), op="plus",
        nnz_capacity=csr.nnz_capacity if nnz_capacity is None else nnz_capacity,
        row_capacity=row_capacity,
    )


def symmetrize(
    csr: CsrMatrix,
    csr_t: Optional[CsrMatrix] = None,
    *,
    op: str = "plus",
    nnz_capacity: Optional[int] = None,
    row_capacity: Optional[int] = None,
) -> Tuple[CsrMatrix, torch.Tensor]:
    """A ⊕ A^T through :func:`ewise_union`: two sorts, or one when the
    caller holds the transpose (the challenge's dst-keyed CSR).  Coincident
    (u, v)/(v, u) entries combine under ``op``; ``nnz_capacity`` defaults
    to the sum of both operands' (a fully asymmetric matrix fits) and
    ``row_capacity`` to ``nnz_capacity``.  Returns ``(csr_sym, dropped)``."""
    if csr_t is None:
        csr_t, _ = transpose(csr)
    if nnz_capacity is None:
        nnz_capacity = csr.nnz_capacity + csr_t.nnz_capacity
    return ewise_union(
        csr, csr_t, op=op, nnz_capacity=nnz_capacity,
        row_capacity=nnz_capacity if row_capacity is None else row_capacity)


def gather_rows(csr: CsrMatrix, x: torch.Tensor, *, fill=0.0) -> torch.Tensor:
    """Row-slot view of a vertex-domain vector: ``out[r] = x[row_key[r]]``;
    rows whose key falls outside ``[0, len(x))``, padding rows included,
    report ``fill``."""
    key = csr.row_keys[0].to(torch.int32)
    ok = csr.row_mask() & (key >= 0) & (key < x.shape[0])
    safe = torch.clamp(key, 0, x.shape[0] - 1).long()
    return torch.where(ok, x[safe], fill)


def scatter_rows(csr: CsrMatrix, slot_vals: torch.Tensor, num_vertices: int,
                 *, fill=0.0) -> torch.Tensor:
    """Vertex-domain view of a row-slot vector: ``out[row_key[r]] =
    slot_vals[r]``, the inverse of :func:`gather_rows`.  Row keys are
    distinct, so only the spill slot ``num_vertices`` (out-of-range keys,
    padding rows) collides; vertices with no row report ``fill``."""
    key = csr.row_keys[0].to(torch.int32)
    ok = csr.row_mask() & (key >= 0) & (key < num_vertices)
    out = torch.full((num_vertices + 1,), fill, dtype=slot_vals.dtype,
                     device=slot_vals.device)
    return out.scatter_(0, torch.where(ok, key, num_vertices).long(),
                        slot_vals)[:num_vertices]
