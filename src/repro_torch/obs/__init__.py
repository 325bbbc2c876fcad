"""repro_torch.obs — structured spans and the metrics registry (the port's
copies of ``repro.obs.trace`` and ``repro.obs.metrics``)."""
from .trace import (  # noqa: F401
    SCHEMA_VERSION,
    Span,
    Tracer,
    export_jsonl,
    get_tracer,
    read_jsonl,
    reset_tracer,
    run_context,
    span,
)
from .metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    reset_registry,
)

__all__ = [
    "SCHEMA_VERSION",
    "Span",
    "Tracer",
    "span",
    "get_tracer",
    "reset_tracer",
    "run_context",
    "export_jsonl",
    "read_jsonl",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "reset_registry",
    "DEFAULT_LATENCY_BUCKETS",
]
