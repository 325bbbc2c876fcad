"""Columnar Table — the port of ``repro/core/table.py``.

A ``Table`` is an ordered dict of equal-length 1-D tensors on one device
plus a validity count: it always carries ``capacity`` rows, of which the
first ``n_valid`` are live (the reference's static-shape discipline, kept so
that every buffer of the port lines up with the reference's bit for bit).
``n_valid`` is a 0-d int32 tensor on the table's device, so counts derived
from it on the device never force a host round trip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

__all__ = ["Table", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and there is no
    card: the port's entry points default to ``"cuda"`` and never drop to
    the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain versions on the CPU")
    # "cuda" names the current card; tensors report it with its index
    return device if device.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class Table:
    """An immutable columnar table of equal-length 1-D tensors.

    Attributes:
      columns: mapping column name -> tensor of shape (capacity,).
      n_valid: 0-d int32 tensor — number of live rows (<= capacity).  Rows
        at index >= n_valid are padding and must be ignored by every
        consumer.  ``None`` means "all rows valid" and is normalised to
        capacity.
    """

    columns: Dict[str, torch.Tensor]
    n_valid: Optional[torch.Tensor] = None

    def __post_init__(self):
        lens = {k: v.shape[0] for k, v in self.columns.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged columns: {lens}")
        devices = {v.device for v in self.columns.values()}
        if len(devices) > 1:
            raise ValueError(f"columns on several devices: {devices}")
        if self.n_valid is None:
            object.__setattr__(self, "n_valid", torch.tensor(
                self.capacity, dtype=torch.int32, device=self.device))

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0] if self.columns else 0

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def valid_mask(self) -> torch.Tensor:
        """Boolean mask of live rows, shape (capacity,)."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.n_valid

    def with_columns(self, **cols: torch.Tensor) -> "Table":
        new = dict(self.columns)
        new.update(cols)
        return Table(columns=new, n_valid=self.n_valid)
