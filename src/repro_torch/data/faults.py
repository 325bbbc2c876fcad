"""Deterministic fault injection and the resilient ingest path — the
port's copy of ``repro/data/faults.py`` (numpy only, nothing of torch).

The streaming service (:mod:`repro_torch.stream.recovery`) reads capture
row groups through two halves:

  * :class:`FaultInjector` — a **seeded, deterministic** chaos layer over
    per-row-group reads.  Every decision (how many transient ``IOError``
    attempts a group suffers, whether its first read is torn, whether it is
    delivered twice or out of order, whether it takes a latency spike) is a
    pure function of ``(seed, group index)``, drawn exactly as the
    reference draws it, so both packages inject the identical schedule for
    a seed and a crash-recovery run can be held bit for bit to an
    uninterrupted one.
  * :class:`ResilientReader` — bounded retries with exponential backoff on
    transient faults, structural validation of every chunk (CRC failures
    surface from the read as :class:`PlqCorruptionError`), a **dead-letter
    quarantine** for malformed copies, and a ``lost_batches`` counter for
    the unrecoverable case (retry budget exhausted), so a snapshot never
    passes as exact while data went missing.

Corruption and IO errors are injected *in transit*: the capture at rest is
durable, so a retry re-reads clean bytes.  :class:`IngestHealth` is the
ledger of all of it, surfaced on every
:class:`~repro_torch.stream.engine.StreamSnapshot`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .plq import PlqCorruptionError

__all__ = [
    "TransientIOError",
    "FaultConfig",
    "FaultDraw",
    "FaultInjector",
    "RetryPolicy",
    "IngestHealth",
    "PlqCorruptionError",
    "Quarantine",
    "ResilientReader",
    "validate_chunk",
    "inspect_quarantine",
]


class TransientIOError(IOError):
    """An injected (or wrapped) IO failure that a retry may clear."""


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded chaos rates for the ingest path.

    Rates are per row group (the ingest/retry unit).  ``crash_at_batch``
    arms one :class:`~repro_torch.stream.recovery.SimulatedCrash` after the
    service *folds* that batch sequence number but before it checkpoints —
    the worst-case crash point (committed work since the last watermark is
    lost and must be replayed).  The crash fires once per service lifetime:
    the supervisor's recovery disarms it.
    """

    seed: int = 0
    transient_io_rate: float = 0.0   # P(group suffers transient IOErrors)
    max_transient: int = 2           # failing attempts per afflicted group
    corrupt_rate: float = 0.0        # P(first read(s) of group arrive torn)
    max_torn: int = 1                # torn attempts per afflicted group
    duplicate_rate: float = 0.0      # P(group is delivered twice)
    reorder_rate: float = 0.0        # P(group swaps with its successor)
    latency_rate: float = 0.0        # P(first read takes a latency spike)
    latency_s: float = 0.0           # spike duration (seconds)
    crash_at_batch: Optional[int] = None

    def __post_init__(self):
        for f in ("transient_io_rate", "corrupt_rate", "duplicate_rate",
                  "reorder_rate", "latency_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.max_transient < 1 or self.max_torn < 1:
            raise ValueError("max_transient and max_torn must be >= 1")

    @property
    def any_enabled(self) -> bool:
        return (self.transient_io_rate > 0 or self.corrupt_rate > 0
                or self.duplicate_rate > 0 or self.reorder_rate > 0
                or self.latency_rate > 0 or self.crash_at_batch is not None)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff for the ingest path."""

    max_attempts: int = 6
    base_backoff_s: float = 0.005
    max_backoff_s: float = 0.5
    multiplier: float = 2.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoffs must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")

    def backoff(self, attempt: int) -> float:
        """Seconds to sleep after failed attempt ``attempt`` (0-based)."""
        return min(self.base_backoff_s * self.multiplier ** attempt,
                   self.max_backoff_s)


# ---------------------------------------------------------------------------
# the health ledger (surfaced on every StreamSnapshot)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# the injector (pure function of (seed, group))
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultDraw:
    """The full fault schedule of one row group (deterministic)."""

    n_transient: int     # attempts that raise TransientIOError first
    n_torn: int          # attempts (after transients) that arrive torn
    duplicate: bool      # delivered twice
    reorder: bool        # swaps arrival position with its successor
    latency: bool        # first read sleeps latency_s


class FaultInjector:
    """Seeded chaos over a per-group read function.

    ``draw(seq)`` is a pure function of ``(cfg.seed, seq)``; the arrival
    order and every read outcome derive from it, so two runs with the same
    seed inject the identical fault schedule — including across service
    restarts, where only the not-yet-committed suffix is re-read.
    """

    def __init__(self, cfg: FaultConfig, n_groups: int):
        self.cfg = cfg
        self.n_groups = n_groups
        self._draws: Dict[int, FaultDraw] = {}

    def draw(self, seq: int) -> FaultDraw:
        d = self._draws.get(seq)
        if d is None:
            cfg = self.cfg
            rng = np.random.default_rng((cfg.seed & 0x7FFFFFFF, seq))
            u = rng.random(5)
            k = rng.integers(1, max(cfg.max_transient, cfg.max_torn) + 1)
            d = FaultDraw(
                n_transient=(int(min(k, cfg.max_transient))
                             if u[0] < cfg.transient_io_rate else 0),
                n_torn=(int(min(k, cfg.max_torn))
                        if u[1] < cfg.corrupt_rate else 0),
                duplicate=bool(u[2] < cfg.duplicate_rate),
                reorder=bool(u[3] < cfg.reorder_rate),
                latency=bool(u[4] < cfg.latency_rate),
            )
            self._draws[seq] = d
        return d

    def arrival_order(self, start: int = 0) -> List[int]:
        """Delivery sequence over groups ``[start, n_groups)`` with the
        reorder/duplicate schedule applied.  Deterministic; a resumed
        service (``start = watermark``) sees the same perturbations over
        the remaining suffix."""
        base = list(range(start, self.n_groups))
        out: List[int] = []
        i = 0
        while i < len(base):
            s = base[i]
            if self.draw(s).reorder and i + 1 < len(base):
                out.extend([base[i + 1], s])   # successor arrives first
                i += 2
            else:
                out.append(s)
                i += 1
        final: List[int] = []
        for s in out:
            final.append(s)
            if self.draw(s).duplicate:
                final.append(s)                # at-least-once redelivery
        return final

    @staticmethod
    def _tamper(chunk: Dict[str, np.ndarray], seq: int,
                attempt: int) -> Dict[str, np.ndarray]:
        """A deterministically torn copy: the first column loses its tail
        (the classic truncated-page shape, caught by validate_chunk)."""
        out = dict(chunk)
        name = sorted(out)[0]
        col = out[name]
        cut = max(0, len(col) - 1 - (seq + attempt) % 3)
        out[name] = col[:cut]
        return out

    def read(self, seq: int, attempt: int,
             read_fn: Callable[[int], Dict[str, np.ndarray]]
             ) -> Dict[str, np.ndarray]:
        """One (possibly faulted) read attempt of group ``seq``."""
        d = self.draw(seq)
        if d.latency and attempt == 0 and self.cfg.latency_s > 0:
            time.sleep(self.cfg.latency_s)
        if attempt < d.n_transient:
            raise TransientIOError(
                f"injected transient IO failure: group {seq} attempt {attempt}"
            )
        chunk = read_fn(seq)
        if attempt < d.n_transient + d.n_torn:
            return self._tamper(chunk, seq, attempt)
        return chunk


# ---------------------------------------------------------------------------
# validation + dead-letter quarantine
# ---------------------------------------------------------------------------

def validate_chunk(chunk: Dict[str, np.ndarray],
                   expected_rows: Optional[int] = None) -> Optional[str]:
    """Structural validation of one ingest chunk.  Returns a reason string
    when malformed (column length mismatch, truncated vs the footer's row
    count, non-1D payload), else None."""
    if not chunk:
        return "empty chunk (no columns)"
    for k, v in chunk.items():
        if np.asarray(v).ndim != 1:
            return f"column {k!r} is not 1-D"
    lengths = {k: len(v) for k, v in chunk.items()}
    if len(set(lengths.values())) != 1:
        return f"ragged columns: {lengths}"
    n = next(iter(lengths.values()))
    if expected_rows is not None and n != expected_rows:
        return f"row count {n} != footer row count {expected_rows}"
    return None


class Quarantine:
    """Dead-letter store for malformed batch copies.

    When ``directory`` is set, every quarantined copy is persisted as
    ``batch_<seq>_attempt_<k>.npz`` beside an append-only
    ``quarantine.jsonl`` index (seq, attempt, reason, columns) — the
    operator's forensic trail.  Without a
    directory the records are kept in memory only; either way the *count*
    lives in :class:`IngestHealth` and is surfaced on the snapshot.
    """

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        self.records: List[Dict] = []
        if directory:
            os.makedirs(directory, exist_ok=True)

    def put(self, seq: int, attempt: int, reason: str,
            chunk: Optional[Dict[str, np.ndarray]] = None) -> None:
        rec = {
            "seq": int(seq),
            "attempt": int(attempt),
            "reason": reason,
            "columns": (
                {k: [int(len(v)), str(np.asarray(v).dtype)]
                 for k, v in chunk.items()} if chunk else None
            ),
        }
        self.records.append(rec)
        if self.directory:
            if chunk is not None:
                np.savez(
                    os.path.join(self.directory,
                                 f"batch_{seq:06d}_attempt_{attempt}.npz"),
                    **{k: np.asarray(v) for k, v in chunk.items()},
                )
            with open(os.path.join(self.directory, "quarantine.jsonl"),
                      "a") as f:
                f.write(json.dumps(rec) + "\n")


def inspect_quarantine(directory: str) -> List[Dict]:
    """Load the dead-letter index of a quarantine directory."""
    path = os.path.join(directory, "quarantine.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# the resilient reader (retry + validate + quarantine)
# ---------------------------------------------------------------------------

class ResilientReader:
    """Iterate ``(seq, chunk)`` over an arrival order, surviving faults.

    Per group: retry transient IO errors with exponential backoff,
    validate every chunk (CRC failures surface as
    :class:`PlqCorruptionError` from the read itself,
    structural damage via :func:`validate_chunk`), quarantine malformed
    copies, and re-read until clean or the retry budget exhausts.  An
    exhausted group yields ``chunk=None`` — the *counted* lost-batch case
    the service loop must skip forward over (never silently absorbed).
    """

    def __init__(
        self,
        read_fn: Callable[[int], Dict[str, np.ndarray]],
        order: Sequence[int],
        *,
        health: IngestHealth,
        expected_rows: Optional[Dict[int, int]] = None,
        retry: Optional[RetryPolicy] = None,
        injector: Optional[FaultInjector] = None,
        quarantine: Optional[Quarantine] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.read_fn = read_fn
        self.order = list(order)
        self.health = health
        self.expected_rows = expected_rows or {}
        self.retry = retry or RetryPolicy()
        self.injector = injector
        self.quarantine = quarantine or Quarantine()
        self._sleep = sleep

    def _read_one(self, seq: int) -> Optional[Dict[str, np.ndarray]]:
        for attempt in range(self.retry.max_attempts):
            if (self.injector is not None and attempt == 0
                    and self.injector.draw(seq).latency):
                self.health.latency_spikes += 1
            try:
                if self.injector is not None:
                    chunk = self.injector.read(seq, attempt, self.read_fn)
                else:
                    chunk = self.read_fn(seq)
            except TransientIOError:
                self.health.io_retries += 1
                self._sleep(self.retry.backoff(attempt))
                continue
            except PlqCorruptionError as e:
                # torn at the storage layer: quarantine the report (no
                # payload survived decoding) and re-read
                self.health.quarantined += 1
                self.quarantine.put(seq, attempt, f"crc/page: {e}")
                continue
            reason = validate_chunk(chunk, self.expected_rows.get(seq))
            if reason is not None:
                # torn in transit: quarantine the malformed copy itself
                self.health.quarantined += 1
                self.quarantine.put(seq, attempt, reason, chunk)
                continue
            return chunk
        self.health.lost_batches += 1
        self.quarantine.put(
            seq, -1,
            f"retry budget exhausted ({self.retry.max_attempts} attempts)",
        )
        return None

    def __iter__(self) -> Iterator[Tuple[int, Optional[Dict[str, np.ndarray]]]]:
        for seq in self.order:
            yield seq, self._read_one(seq)
