"""repro_torch.stream — the streaming incremental analytics engine (the
port of ``repro.stream``).

Consumes packet micro-batches and keeps mergeable state — a persistent
anonymization dictionary with stable ids, the accumulated windowed traffic
matrix, and per-window activity histograms folded through the histogram
kernel's ``init`` epilogue — from which all 14 Table III queries are
answerable at any point, equal to a one-shot batch run.  CLI:

    PYTHONPATH=src python -m repro_torch.stream.run --scale 12 --batches 3

The fault-tolerant service (:mod:`repro_torch.stream.recovery`) runs the
engine under watermarked atomic checkpoints, seeded chaos, bounded
retries, a dead-letter quarantine, crash, restore and replay, and
pressure-driven degradation to the sketch tier.  CLI:

    PYTHONPATH=src python -m repro_torch.launch.serve --scale 10 \
        --n-packets 2048 --batch-size 256 --chaos --crash-at-batch 4 \
        --checkpoint-dir /tmp/ck --verify --device cpu
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
from .recovery import (
    DegradePolicy,
    RestorePoint,
    ServiceReport,
    SimulatedCrash,
    StreamCheckpointer,
    run_service,
)
from .state import StreamState, init_state

__all__ = [
    "DegradePolicy",
    "RestorePoint",
    "ServiceReport",
    "SimulatedCrash",
    "StreamBatchTimings",
    "StreamCheckpointer",
    "StreamConfig",
    "StreamEngine",
    "StreamSnapshot",
    "StreamState",
    "anonymization_mapping",
    "init_state",
    "link_table",
    "merge_states",
    "run_service",
    "snapshot_algorithms",
    "steady_state",
    "stream_plq",
    "update_state",
    "update_state_naive",
]
