"""Durable recovery for the streaming service — the port of
``repro/stream/recovery.py``.

The paper's pipeline is a *service*: it folds capture row groups for hours,
and what kills it in practice is a dead process, not a wrong kernel.  This
module makes the stream engine restartable with **exactly-once fold
semantics**:

  * :class:`StreamCheckpointer` persists the engine's full analytic state
    (the exact :class:`~repro_torch.stream.state.StreamState`, the optional
    :class:`~repro_torch.core.sketch.SketchState`, the
    :class:`~repro_torch.data.faults.IngestHealth` ledger, the active tier)
    through the atomic manifest protocol of
    :mod:`repro_torch.train.checkpoint`, extended with a **batch-sequence
    watermark**: the checkpoint's step number *is* the number of capture
    row groups whose folds it contains.  The files are the reference's, so
    a step written by either package restores in the other.
  * :func:`run_service` is the supervised loop: boot (restore the newest
    complete checkpoint, or start fresh), stream the capture suffix from the
    watermark through the resilient ingest path
    (:class:`~repro_torch.data.faults.ResilientReader` under a
    :class:`~repro_torch.data.pipeline.Prefetcher`), checkpoint every K
    committed batches, and on a crash restore + replay.

Replay is exactly-once because the capture at rest is durable and the fold
is deterministic: re-folding groups ``[watermark, crash)`` from the restored
state reproduces the uninterrupted state bit for bit.  Replays are counted
in ``health.batches_replayed``, and the sequencer in front of the engine
(dedup + reorder buffer) folds each sequence number at most once per life,
in order, even when the fault layer delivers it twice or out of order
(anonymization ids follow first-seen order, so order matters).

On the card a fold does not synchronize with the host: each group is
padded into one of a :class:`~repro_torch.data.pipeline.PinnedStager`'s two
pinned host buffers and copied with ``non_blocking=True`` (as
:func:`~repro_torch.stream.engine.stream_plq` does), and a buffer is
refilled only after the event of the copy that last read it.  The host waits for the card only to commit (``engine.block()``
and the copies of the state to the host) and, when a
:class:`DegradePolicy` is set, to read the two live counts its pressure
needs after each fold.

Graceful degradation (:class:`DegradePolicy`): when the exact tier's
capacity pressure crosses a threshold, the engine is switched forward
(exact -> both -> sketch) *before* overflow corrupts exactness; the switch
is recorded in the health ledger and on every snapshot.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.sketch import SketchState, init_sketch
from ..data.faults import (
    FaultConfig,
    FaultInjector,
    IngestHealth,
    Quarantine,
    ResilientReader,
    RetryPolicy,
)
from ..data.pipeline import PinnedStager, Prefetcher
from ..data.plq import plq_info, read_plq_group
from ..obs import get_registry
from ..train import checkpoint as ckpt
from .engine import _TIER_ORDER, StreamBatchTimings, StreamConfig, StreamEngine
from .state import StreamState, init_state

__all__ = [
    "SimulatedCrash",
    "RestorePoint",
    "StreamCheckpointer",
    "DegradePolicy",
    "ServiceReport",
    "run_service",
]


class SimulatedCrash(RuntimeError):
    """A chaos-armed process death (``FaultConfig.crash_at_batch``).

    Raised after the service has *folded* the armed batch but before it
    checkpoints — the worst-case crash point: every fold since the last
    committed watermark is lost in memory and must be replayed.
    ``at_seq`` is the next uncommitted sequence number at death.
    """

    def __init__(self, msg: str, at_seq: int):
        super().__init__(msg)
        self.at_seq = at_seq


# ---------------------------------------------------------------------------
# checkpointing with a batch-sequence watermark
# ---------------------------------------------------------------------------

def _fingerprint(cfg: StreamConfig) -> Dict:
    """The shape-relevant config facts a checkpoint must match to restore:
    the reference's dict for the same geometry.  Leaves out ``tier``
    (degradation changes it mid-run; the checkpoint records the active tier
    apart) and what shapes answers or placement, not state buffers
    (``top_k``, ``backend``, ``device``)."""
    s = cfg.sketch_config
    return {
        "link_capacity": cfg.link_capacity,
        "ip_capacity": cfg.ips,
        "n_windows": cfg.n_windows,
        "ip_bins": cfg.ip_bins,
        "sketch": {
            "cms_depth": s.cms_depth, "cms_width": s.cms_width,
            "hll_p": s.hll_p, "heavy_capacity": s.heavy_capacity,
            "seed": s.seed,
        },
    }


@dataclasses.dataclass
class RestorePoint:
    """What a successful restore hands the supervisor: host (numpy) leaves
    in the state's structure, which ``StreamEngine.load`` copies to the
    engine's device."""

    watermark: int                       # committed batch-sequence number
    tier: str                            # tier active when checkpointed
    state: StreamState
    sketch_state: Optional[SketchState]
    health: IngestHealth


class StreamCheckpointer:
    """Watermarked durable snapshots of a :class:`StreamEngine`.

    The checkpoint **step number is the watermark**: ``step_00000007/``
    holds exactly the folds of row groups ``[0, 7)``, so a restore knows
    that replay starts at group 7.  The engine's two trees ride one
    manifest as ``{"exact": ..., "sketch": ...}``; the health ledger,
    active tier and config fingerprint travel in the manifest's ``extra``.
    A torn write is unobservable, and post-commit storage damage makes
    :meth:`restore_latest` fall back to the newest step that validates.
    """

    def __init__(self, directory: str, cfg: StreamConfig, keep: int = 3):
        self.directory = directory
        self.cfg = cfg
        self.keep = keep
        self._fp = _fingerprint(cfg)
        self.save_walls: List[float] = []
        self.restore_walls: List[float] = []

    # -- template trees ------------------------------------------------------
    def _template(self, has_sketch: bool) -> Dict:
        """The restore target's structure and shapes, on the ``meta``
        device: no memory behind it, on the card or the host."""
        tree: Dict = {"exact": init_state(self.cfg.link_capacity, self.cfg.ips,
                                          self.cfg.n_windows, self.cfg.ip_bins,
                                          "meta")}
        if has_sketch:
            tree["sketch"] = init_sketch(self.cfg.sketch_config, "meta")
        return tree

    # -- save ----------------------------------------------------------------
    def save(self, engine: StreamEngine, watermark: int) -> str:
        """Commit the engine's state at ``watermark`` committed batches.

        Waits for the card first, and counts itself in
        ``health.checkpoints_committed`` *before* serializing, so the
        restored ledger includes the commit that carried it.
        """
        engine.block()
        engine.health.checkpoints_committed += 1
        tree: Dict = {"exact": engine.state}
        if engine.sketch_state is not None:
            tree["sketch"] = engine.sketch_state
        extra = {
            "watermark": int(watermark),
            "tier": engine.cfg.tier,
            "has_sketch": engine.sketch_state is not None,
            "health": engine.health.as_dict(),
            "fingerprint": self._fp,
        }
        t0 = time.perf_counter()
        path = ckpt.save_checkpoint(
            self.directory, int(watermark), tree, extra=extra, keep=self.keep)
        wall = time.perf_counter() - t0
        self.save_walls.append(wall)
        reg = get_registry()
        reg.histogram("checkpoint_save_seconds",
                      "wall seconds per committed checkpoint").observe(wall)
        reg.counter("serve_commits_total",
                    "watermark advances committed durably").inc()
        reg.gauge("serve_watermark", "committed batch-sequence watermark"
                  ).set(int(watermark))
        return path

    # -- restore -------------------------------------------------------------
    def restore_latest(self) -> Optional[RestorePoint]:
        """Restore the newest complete checkpoint whose fingerprint matches.

        Walks candidates newest-first (the ``LATEST`` hint first), skipping
        torn or incomplete steps and steps written under another geometry.
        Returns ``None`` when nothing usable survives: the supervisor then
        boots fresh from watermark 0.
        """
        t0 = time.perf_counter()
        candidates: List[int] = []
        pointed = ckpt.latest_step(self.directory)
        if pointed is not None:
            candidates.append(pointed)
        candidates.extend(
            s for s in sorted(ckpt._all_steps(self.directory), reverse=True)
            if s not in candidates)
        for step in candidates:
            if not ckpt.step_is_complete(self.directory, step):
                continue
            extra = ckpt.read_manifest(self.directory, step)["extra"]
            if extra.get("fingerprint") != self._fp:
                continue
            tree, _ = ckpt.restore_checkpoint(
                self.directory, step, self._template(extra["has_sketch"]))
            wall = time.perf_counter() - t0
            self.restore_walls.append(wall)
            reg = get_registry()
            reg.histogram("checkpoint_restore_seconds",
                          "wall seconds per successful restore").observe(wall)
            reg.counter("serve_restores_total",
                        "checkpoint restores performed").inc()
            return RestorePoint(
                watermark=int(extra["watermark"]),
                tier=extra["tier"],
                state=tree["exact"],
                sketch_state=tree.get("sketch"),
                health=IngestHealth.from_dict(extra["health"]),
            )
        return None


# ---------------------------------------------------------------------------
# graceful degradation policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Capacity-pressure thresholds for the forward tier switch.

    Pressure is ``max(n_links / link_capacity, n_ips / ip_capacity)`` of
    the exact state.  At ``to_both`` the sketch tier is brought up beside
    the exact one (backfilled from the accumulated link table, so it
    covers the full history); at ``to_sketch`` the exact state freezes and
    the sketch carries on alone.  **Headroom rule**: the check runs after
    each fold, and one batch can add at most ``batch_capacity`` links, so
    ``to_sketch <= 1 - batch_capacity / link_capacity`` guarantees the
    switch fires before the exact tier can overflow.  Reading the two live
    counts waits for the card: the one host sync a fold makes with a
    policy set.
    """

    to_both: float = 0.85
    to_sketch: float = 0.95
    check_every: int = 1

    def __post_init__(self):
        if not 0.0 < self.to_both <= self.to_sketch <= 1.0:
            raise ValueError(
                "need 0 < to_both <= to_sketch <= 1, got "
                f"{self.to_both}/{self.to_sketch}")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")

    def pressure(self, engine: StreamEngine) -> float:
        st = engine.state
        return max(int(st.n_links) / st.link_capacity,
                   int(st.n_ips) / st.ip_capacity)

    def apply(self, engine: StreamEngine) -> Optional[str]:
        """Check pressure; degrade forward when a threshold is crossed.
        Returns the new tier, or None when nothing changed."""
        if not engine.cfg.exact_enabled:
            return None  # already sketch-only: nothing left to shed
        p = self.pressure(engine)
        target: Optional[str] = None
        if p >= self.to_sketch:
            target = "sketch"
        elif p >= self.to_both and engine.cfg.tier == "exact":
            target = "both"
        if target is None or _TIER_ORDER[target] <= _TIER_ORDER[engine.cfg.tier]:
            return None
        engine.degrade(target)
        return target


# ---------------------------------------------------------------------------
# the supervised service loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServiceReport:
    """Everything one :func:`run_service` run did, for gates and benches."""

    engine: StreamEngine
    watermark: int                       # committed batches at exit
    n_groups: int                        # capture row groups
    restarts: int                        # crash->restore cycles survived
    timings: List[StreamBatchTimings]    # per-fold walls (all lives)
    checkpoint_walls: List[float]        # per-commit wall seconds
    restore_walls: List[float]           # per-restore wall seconds
    replay_wall_s: float                 # total wall re-folding replayed seqs
    health: IngestHealth

    def snapshot(self, distributed: bool = False):
        return self.engine.snapshot(distributed=distributed)


def _group_read_fn(path: str, info: dict, columns: Sequence[str]
                   ) -> Callable[[int], Dict[str, np.ndarray]]:
    return lambda seq: read_plq_group(path, seq, columns=list(columns), info=info)


def _serve_one_life(
    engine: StreamEngine,
    path: str,
    info: dict,
    win_full: np.ndarray,
    watermark: int,
    *,
    columns: Sequence[str],
    checkpointer: Optional[StreamCheckpointer],
    checkpoint_every: int,
    faults: Optional[FaultConfig],
    injector: Optional[FaultInjector],
    retry: Optional[RetryPolicy],
    quarantine: Quarantine,
    degrade: Optional[DegradePolicy],
    crash_armed: bool,
    replay_until: int,
    depth: int,
    timings: List[StreamBatchTimings],
    on_batch: Optional[Callable[[int, StreamEngine], None]],
) -> Tuple[int, float]:
    """One process life: stream groups ``[watermark, n_groups)`` in order.

    Returns ``(committed_watermark, replay_wall_s)``; raises
    :class:`SimulatedCrash` when the armed batch folds.  The exactly-once
    sequencer sits between the (possibly duplicating, reordering) fault
    layer and the engine: folds happen strictly in sequence order.
    """
    n_groups = len(info["groups"])
    cap = engine.cfg.batch_capacity
    expected = {gi: g["stop"] - g["start"] for gi, g in enumerate(info["groups"])}
    order = (injector.arrival_order(watermark) if injector is not None
             else list(range(watermark, n_groups)))
    reader = ResilientReader(
        _group_read_fn(path, info, columns), order,
        health=engine.health, expected_rows=expected,
        retry=retry, injector=injector, quarantine=quarantine,
    )
    stager = PinnedStager(engine.device)

    next_seq = watermark
    committed = watermark
    pending: Dict[int, Optional[Dict[str, np.ndarray]]] = {}
    replay_wall = 0.0
    n_folded = 0

    def fold(seq: int, chunk: Optional[Dict[str, np.ndarray]]) -> None:
        nonlocal n_folded, replay_wall
        if chunk is None:
            return  # lost batch: counted by the reader; the seq still advances
        t0 = time.perf_counter()
        g = info["groups"][seq]
        n = g["stop"] - g["start"]
        if n > cap:
            raise ValueError(
                f"row group {seq} has {n} rows > batch_capacity {cap}; "
                f"rewrite the capture with row_group_size <= {cap}")
        # the window column is cut by the group's own rows: groups may be
        # lost, duplicated or reordered, so no running offset
        host = stager.take({"rows": ((3, cap), np.int32)})["rows"]
        for row, col in enumerate((chunk[columns[0]], chunk[columns[1]],
                                   win_full[g["start"]:g["stop"]])):
            np.copyto(host[row, :n], col, casting="unsafe")
        host[:, n:] = 0
        t1 = time.perf_counter()
        batch = stager.send()["rows"]
        t2 = time.perf_counter()
        engine.ingest_padded(batch[0], batch[1], batch[2], n)
        t3 = time.perf_counter()
        timings.append(StreamBatchTimings(
            n_packets=n, prep_s=t1 - t0, transfer_s=t2 - t1,
            update_s=t3 - t2, total_s=t3 - t0, compile=n_folded == 0))
        if n_folded:  # steady state only: the first fold would skew p99
            get_registry().histogram(
                "serve_fold_seconds",
                "steady-state wall seconds per folded batch (all lives)",
            ).observe(t3 - t0)
        n_folded += 1
        if seq < replay_until:
            engine.health.batches_replayed += 1
            replay_wall += t3 - t0
            get_registry().counter(
                "serve_batches_replayed_total",
                "previously-folded batches re-folded after a restore").inc()
        if degrade is not None and (seq + 1) % degrade.check_every == 0:
            degrade.apply(engine)
        if on_batch is not None:
            on_batch(seq, engine)

    def commit(seq_done: int) -> None:
        """Advance the durable watermark past ``seq_done``."""
        nonlocal committed
        if checkpointer is not None and (seq_done + 1) % checkpoint_every == 0:
            checkpointer.save(engine, watermark=seq_done + 1)
            committed = seq_done + 1

    with Prefetcher(iter(reader), depth=depth) as pf:
        for seq, chunk in pf:
            if seq < next_seq:
                engine.health.duplicates_dropped += 1
                continue
            if seq > next_seq:
                engine.health.reordered_buffered += 1
                pending[seq] = chunk
                continue
            while True:
                fold(next_seq, chunk)
                done = next_seq
                next_seq += 1
                if (crash_armed and faults is not None
                        and faults.crash_at_batch == done):
                    raise SimulatedCrash(
                        f"injected crash after folding batch {done} "
                        f"(uncommitted since watermark {committed})",
                        at_seq=next_seq)
                commit(done)
                if next_seq in pending:
                    chunk = pending.pop(next_seq)
                    continue
                break
    if next_seq != n_groups:
        raise RuntimeError(
            f"ingest ended at sequence {next_seq} of {n_groups} "
            f"(suffix never delivered; pending buffer: {sorted(pending)[:8]})")
    if checkpointer is not None and committed != n_groups:
        checkpointer.save(engine, watermark=n_groups)
        committed = n_groups
    return committed, replay_wall


def run_service(
    cfg: StreamConfig,
    path: str,
    win_full: np.ndarray,
    *,
    columns: Sequence[str] = ("src", "dst"),
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    keep: int = 3,
    faults: Optional[FaultConfig] = None,
    retry: Optional[RetryPolicy] = None,
    degrade: Optional[DegradePolicy] = None,
    quarantine_dir: Optional[str] = None,
    max_restarts: int = 3,
    depth: int = 2,
    on_batch: Optional[Callable[[int, StreamEngine], None]] = None,
) -> ServiceReport:
    """Run the fault-tolerant streaming service over one plq capture.

    Supervision protocol: boot (restore the newest complete checkpoint or
    start fresh at watermark 0) -> stream the suffix through the resilient
    ingest path -> on :class:`SimulatedCrash`, drop the dead engine's
    memory, restore, replay, continue — up to ``max_restarts`` times.
    Without ``checkpoint_dir`` the service still streams resiliently but a
    crash restarts the fold from group 0 (nothing durable to restore).
    The engine lives on ``cfg.device``: the card unless the caller asks
    for the CPU.

    The report's ``health`` ledger accounts for every fault event across
    all lives; ``ServiceReport.snapshot()`` answers the 14 queries.
    """
    info = plq_info(path)
    n_groups = len(info["groups"])
    checkpointer = (StreamCheckpointer(checkpoint_dir, cfg, keep=keep)
                    if checkpoint_dir else None)
    injector = (FaultInjector(faults, n_groups)
                if faults is not None and faults.any_enabled else None)
    quarantine = Quarantine(quarantine_dir)
    crash_armed = faults is not None and faults.crash_at_batch is not None

    timings: List[StreamBatchTimings] = []
    restarts = 0
    replay_wall_total = 0.0
    folded_at_crash: Optional[int] = None
    carry_health: Optional[IngestHealth] = None

    while True:
        # -- boot: restore or fresh -----------------------------------------
        restored = checkpointer.restore_latest() if checkpointer else None
        if restored is not None:
            engine = StreamEngine(dataclasses.replace(cfg, tier=restored.tier))
            engine.load(restored.state, restored.sketch_state, restored.health)
            watermark = restored.watermark
        else:
            engine = StreamEngine(cfg)
            watermark = 0
        del restored  # the host copy: the engine holds its own now
        if carry_health is not None:
            # a crashed life's ledger survives in the supervisor even when
            # its folds did not: fault accounting is never lost with them
            engine.health = carry_health
        if folded_at_crash is not None:
            engine.health.crashes_recovered += 1
        replay_until = folded_at_crash if folded_at_crash is not None else 0

        try:
            watermark, replay_wall = _serve_one_life(
                engine, path, info, win_full, watermark,
                columns=columns, checkpointer=checkpointer,
                checkpoint_every=checkpoint_every, faults=faults,
                injector=injector, retry=retry, quarantine=quarantine,
                degrade=degrade, crash_armed=crash_armed,
                replay_until=replay_until, depth=depth,
                timings=timings, on_batch=on_batch,
            )
            replay_wall_total += replay_wall
            break
        except SimulatedCrash as crash:
            restarts += 1
            get_registry().counter(
                "serve_restarts_total", "crash->restore cycles survived").inc()
            if restarts > max_restarts:
                raise
            crash_armed = False  # the chaos crash fires once per service
            folded_at_crash = crash.at_seq
            # the dead process's ledger survives in the supervisor (fault
            # accounting, not folds); its memory is gone.  The restore
            # allocates the next state on the card only after this block,
            # when ``crash`` and its traceback (whose frames hold the dead
            # engine) are gone too
            carry_health = engine.health
            del engine

    engine.block()
    return ServiceReport(
        engine=engine,
        watermark=watermark,
        n_groups=n_groups,
        restarts=restarts,
        timings=timings,
        checkpoint_walls=list(checkpointer.save_walls) if checkpointer else [],
        restore_walls=list(checkpointer.restore_walls) if checkpointer else [],
        replay_wall_s=replay_wall_total,
        health=engine.health,
    )
