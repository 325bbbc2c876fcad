"""repro_torch.stream — the streaming incremental analytics engine (the
port of ``repro.stream``).

Consumes packet micro-batches and keeps mergeable state — a persistent
anonymization dictionary with stable ids, the accumulated windowed traffic
matrix, and per-window activity histograms folded through the histogram
kernel's ``init`` epilogue — from which all 14 Table III queries are
answerable at any point, equal to a one-shot batch run.  CLI:

    PYTHONPATH=src python -m repro_torch.stream.run --scale 12 --batches 3

The fault-tolerant service of ``repro.stream.recovery`` (checkpoints,
crash, restore and replay) is not ported yet (ROADMAP.md queue 1 item 8).
"""
from .engine import (
    StreamBatchTimings,
    StreamConfig,
    StreamEngine,
    StreamSnapshot,
    anonymization_mapping,
    link_table,
    merge_states,
    steady_state,
    stream_plq,
    update_state,
    update_state_naive,
)
from .algorithms import snapshot_algorithms
from .state import StreamState, init_state

__all__ = [
    "StreamBatchTimings",
    "StreamConfig",
    "StreamEngine",
    "StreamSnapshot",
    "StreamState",
    "anonymization_mapping",
    "init_state",
    "link_table",
    "merge_states",
    "snapshot_algorithms",
    "steady_state",
    "stream_plq",
    "update_state",
    "update_state_naive",
]
