"""The ingest path's health ledger — the port's copy of ``IngestHealth``
from ``repro/data/faults.py``.  Fault injection, retries and quarantine
(the rest of that module) belong to the fault-tolerant service and are not
ported yet (ROADMAP.md queue 1 item 8); the streaming engine carries the
ledger on every snapshot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["IngestHealth"]


@dataclasses.dataclass
class IngestHealth:
    """Counted-never-silent ledger of everything the fault path did.

    ``lost_batches`` is the only *lossy* counter — a snapshot with
    ``lost_batches > 0`` is unreliable exactly like one with state
    overflow.  Everything else records recovered events: duplicates
    dropped by the exactly-once sequencer, out-of-order arrivals buffered
    back into order, torn copies quarantined then re-read clean, transient
    IO retries, latency spikes ridden out, batches replayed after a crash,
    and the graceful-degradation tier switch (never silent: the snapshot
    carries both the active tier and where/why it changed).
    """

    duplicates_dropped: int = 0
    reordered_buffered: int = 0
    quarantined: int = 0
    io_retries: int = 0
    latency_spikes: int = 0
    lost_batches: int = 0
    batches_replayed: int = 0
    crashes_recovered: int = 0
    checkpoints_committed: int = 0
    degraded_to: Optional[str] = None
    degraded_at_batch: Optional[int] = None

    @property
    def faults_seen(self) -> int:
        """Total injected/observed fault events (recovered or not)."""
        return (self.duplicates_dropped + self.reordered_buffered
                + self.quarantined + self.io_retries + self.latency_spikes
                + self.lost_batches + self.crashes_recovered)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "IngestHealth":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
