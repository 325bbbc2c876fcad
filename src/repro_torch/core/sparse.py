"""Static-shape CSR traffic matrices — the port of the subset of
``repro/core/sparse.py`` that the graph-algorithm pass runs.

:class:`CsrMatrix` keeps the reference's static-shape discipline: every
buffer has a fixed capacity, validity is the row-pointer prefix
(``indptr[r] == nnz`` for every padding row), entry tails are padding
(column key = dtype max, value 0).  :func:`csr_from_plan` builds one off a
``SortedEdges`` plan with scatters only, zero sorts.  The GraphBLAS-lite
operations are :func:`reduce_rows`, :func:`degrees`, the masked semiring
products :func:`mxv`/:func:`vxm` (their reduction goes through the kernels
of :mod:`repro_torch.kernels.ops`: the histogram kernel for plus, the
segment-max kernel for max, and for min by negation) and the bridges
:func:`gather_rows`/:func:`scatter_rows` between vertex and row-slot
domains.

Not ported yet (ROADMAP.md queue 1 item 2): ``from_coo``, ``ewise_union``,
``transpose``, ``symmetrize`` and ``reduce_cols``, which no path of the port
runs.

One difference from JAX shapes the code: under ``jit`` XLA shares the
binary search of :meth:`CsrMatrix.entry_rows` between every use, but an
eager program would redo it in every ``vxm`` of every algorithm step, so the
port computes it once per matrix and keeps it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..kernels.ops import segmented_reduce
from .ops import _iota, _max_ident, _min_ident, _scatter_firsts, _segment_extreme, segment_sum
from .plan import SortedEdges

__all__ = [
    "CsrMatrix",
    "csr_from_plan",
    "reduce_rows",
    "degrees",
    "mxv",
    "vxm",
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
