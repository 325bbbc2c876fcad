"""The kernel wrappers' launch counters, read and reset in one place.

Each wrapper module counts its kernel's launches in a module global
(``LAUNCHES``; ``sketch`` counts its HLL fold apart, in ``HLL_LAUNCHES``).
The package attribute ``repro_torch.kernels.histogram`` is
``ops.histogram``, the reference's export of that name, not the module, so
the modules are looked up by module path, here.
"""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

# kernel name -> (wrapper module, its counter)
COUNTERS = {
    "histogram": ("histogram", "LAUNCHES"),
    "segment_max": ("segreduce", "LAUNCHES"),
    "cms_update": ("sketch", "LAUNCHES"),
    "hll_update": ("sketch", "HLL_LAUNCHES"),
    "flash_attention": ("flash_attention", "LAUNCHES"),
    "segment_matmul": ("segment_matmul", "LAUNCHES"),
}


def wrapper(module: str) -> ModuleType:
    """The wrapper module ``repro_torch.kernels.<module>``."""
    return importlib.import_module(f"{__package__}.{module}")


def reset_launches() -> None:
    for module, counter in COUNTERS.values():
        setattr(wrapper(module), counter, 0)


def read_launches() -> Dict[str, int]:
    """Each kernel's launches since the last reset, by kernel name."""
    return {name: getattr(wrapper(module), counter)
            for name, (module, counter) in COUNTERS.items()}
