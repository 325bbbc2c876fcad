"""Mergeable incremental stream state — the port of ``repro/stream/state.py``.

The windowed traffic matrix is a sufficient statistic for the whole
challenge: every Table III query is a function of the accumulated
``(window, src, dst) -> packets`` group-by, so the engine never keeps
packets.  ``StreamState`` is that summary plus the persistent anonymization
dictionary and the per-window activity accumulator, in the static-shape
discipline of the rest of the port (fixed capacities, live prefixes,
padded tails):

  * ``ip_values``/``ip_ids``/``n_ips`` — the anonymization dictionary: the
    sorted distinct IPs seen so far and their *stable* ids.  An IP keeps its
    id forever; new IPs take the next free ids in first-appearance order
    (row-major, src before dst), so the dictionary does not depend on how
    the stream is cut into micro-batches.
  * ``links`` — the accumulated windowed traffic matrix as a
    :class:`repro_torch.core.sparse.CsrMatrix`: rows are the distinct
    ``(window, src)`` pairs (a two-column row key), columns destinations,
    values per-link packet sums, keys in the original IP domain.  Batches
    fold in through ``from_coo`` and states merge through ``ewise_union``.
    The flat ``win``/``src``/``dst``/``packets`` properties expand it back
    to one entry per link.
  * ``activity`` — the running per-window histogram of hashed sources
    (``mix32(src) % ip_bins``), folded each batch through the histogram
    kernel's ``init`` epilogue; bins hash the original IP, so two states
    merge by addition.
  * ``n_packets``/``n_batches``/``overflow`` — totals.  ``overflow`` counts
    dictionary entries and link groups dropped because a buffer filled:
    results are exact iff it is 0.

Every leaf is its own allocation: ``load`` copies restored tensors, and no
two leaves alias.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.sparse import CsrMatrix
from ..core.table import resolve_device

__all__ = ["StreamState", "init_state", "empty_links_csr"]

_I32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class StreamState:
    """One shard's accumulated stream state (see the module docstring)."""

    # anonymization dictionary
    ip_values: torch.Tensor  # (ip_capacity,) int32 sorted asc, tail = int32 max
    ip_ids: torch.Tensor     # (ip_capacity,) int32 stable id per slot, tail = 0
    n_ips: torch.Tensor      # 0-d int32
    # accumulated windowed traffic matrix (original-IP keys), CSR form:
    # rows = distinct (window, src), cols = dst, vals = packet sums
    links: CsrMatrix
    # running per-window activity histogram (hashed original-IP bins)
    activity: torch.Tensor   # (n_windows, ip_bins) float32
    # totals
    n_packets: torch.Tensor  # 0-d int32
    n_batches: torch.Tensor  # 0-d int32
    overflow: torch.Tensor   # 0-d int32: dropped dictionary entries + link groups

    @property
    def device(self) -> torch.device:
        return self.ip_values.device

    @property
    def ip_capacity(self) -> int:
        return self.ip_values.shape[0]

    @property
    def link_capacity(self) -> int:
        return self.links.nnz_capacity

    @property
    def n_windows(self) -> int:
        return self.activity.shape[0]

    @property
    def ip_bins(self) -> int:
        return self.activity.shape[1]

    # -- flat entry-granularity views ---------------------------------------
    @property
    def n_links(self) -> torch.Tensor:
        return self.links.nnz

    @property
    def win(self) -> torch.Tensor:
        """(link_capacity,) int32 window per link, tail = int32 max."""
        return self.links.entry_row_key(0)

    @property
    def src(self) -> torch.Tensor:
        return self.links.entry_row_key(1)

    @property
    def dst(self) -> torch.Tensor:
        return self.links.col_keys

    @property
    def packets(self) -> torch.Tensor:
        return self.links.vals


def empty_links_csr(link_capacity: int, device="cuda") -> CsrMatrix:
    """The empty accumulated matrix: every row pointer is 0 (== nnz)."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return CsrMatrix(
        row_keys=(torch.full((link_capacity,), _I32_MAX, **i32),   # window
                  torch.full((link_capacity,), _I32_MAX, **i32)),  # src
        indptr=torch.zeros(link_capacity + 1, **i32),
        col_keys=torch.full((link_capacity,), _I32_MAX, **i32),
        vals=torch.zeros(link_capacity, **i32),
        n_rows=torch.zeros((), **i32),
        nnz=torch.zeros((), **i32),
    )


def init_state(link_capacity: int, ip_capacity: int, n_windows: int,
               ip_bins: int, device="cuda") -> StreamState:
    """The empty (identity) state on ``device``: ``merge(init, s) == s``.
    Every leaf is a distinct allocation."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return StreamState(
        ip_values=torch.full((ip_capacity,), _I32_MAX, **i32),
        ip_ids=torch.zeros(ip_capacity, **i32),
        n_ips=torch.zeros((), **i32),
        links=empty_links_csr(link_capacity, device),
        activity=torch.zeros((n_windows, ip_bins), dtype=torch.float32,
                             device=device),
        n_packets=torch.zeros((), **i32),
        n_batches=torch.zeros((), **i32),
        overflow=torch.zeros((), **i32),
    )
