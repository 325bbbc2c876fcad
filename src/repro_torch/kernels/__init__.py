"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
ctypes wrappers, plain PyTorch versions (``ref``) and the dispatching entry
points (``ops``), of which this package exports the reference's three
(``repro/kernels/__init__.py``)."""
from .ops import attention, histogram, segment_reduce

__all__ = ["attention", "histogram", "segment_reduce"]
