"""The port's relational engine (``repro.core`` on PyTorch): ``Table``,
packed-key sort + segment reduction, the sort-once plan, the Table III
queries, anonymization, the CSR windowed suite and the NumPy oracle."""
from .table import Table, resolve_device  # noqa: F401

__all__ = ["Table", "resolve_device"]
