"""repro_torch.obs — structured spans (the port's copy of ``repro.obs.trace``).

The metrics registry of ``repro.obs.metrics`` is not ported yet.
"""
from .trace import (  # noqa: F401
    SCHEMA_VERSION,
    Span,
    Tracer,
    export_jsonl,
    get_tracer,
    read_jsonl,
    run_context,
    span,
)

__all__ = [
    "SCHEMA_VERSION",
    "Span",
    "Tracer",
    "span",
    "get_tracer",
    "run_context",
    "export_jsonl",
    "read_jsonl",
]
