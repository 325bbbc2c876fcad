"""Incremental analytics engine over packet micro-batches — the port of
``repro/stream/engine.py``.

``StreamEngine`` folds micro-batches (plq row groups through
:class:`repro_torch.data.pipeline.Prefetcher`, or any ``(src, dst, win)``
column slices) into a :class:`repro_torch.stream.state.StreamState`:

  1. **dictionary update** — batch-distinct IPs not yet in the persistent
     anonymization dictionary get the next free stable ids, and the sorted
     dictionary is rebuilt by one validity-masked sort;
  2. **link accumulation** — ONE ``core.sparse.from_coo`` over the state's
     entries and the raw batch rows is both the batch's ``(window, src,
     dst)`` group-by and the upsert into the accumulated matrix;
  3. **activity accumulation** — the batch's per-window histogram of hashed
     sources folds into the running one through the histogram kernel's
     ``init`` epilogue (``windowed_histogram(..., init=state.activity)``).

All 14 Table III queries are answerable at any point from the state alone
(``snapshot()``), equal to a one-shot batch run over the packets seen so
far: the accumulated link table, weighted by per-link packet sums, goes
through the batch pipeline's ``challenge.analyze``.

The reference jits the transition and donates the old state; the port runs
it eagerly.  What that changes:

  * **No host syncs in the transition.**  Nothing in :func:`update_state`
    reads a device value on the host (no ``.item()``, boolean-mask
    indexing, one-argument ``where`` or ``nonzero``), and the batch's live
    count becomes a device scalar by a fill, not a copy, so the host runs
    ahead of the card and prepares the next batch while the card folds
    this one.
  * **Pinned, double-buffered transfers.**  :func:`stream_plq` pads each
    row group into one of two pinned host buffers and copies it to the card
    with ``non_blocking=True``; before refilling a buffer the host waits for
    the event recorded after the copy that last read it.
  * **Nothing computed to be thrown away.**  The reference's snapshot runs
    ``analyze`` and replaces its activity histogram with the accumulated
    one, and ``jit`` drops the unused histogram; here ``analyze`` is handed
    the accumulated activity (``window_activity=``) and launches no
    histogram for it.
  * **Old state is freed when dropped**, in place of donation; ``load``
    copies what it is given, so no leaf aliases a caller's buffer.

``merge_states`` combines two independently built states.
``snapshot(distributed=True)`` is not ported (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..challenge.pipeline import ChallengeResults
from ..challenge.pipeline import analyze as challenge_analyze
from ..core.ops import (_count, _iota, factorize, groupby_aggregate, isin, mix32,
                        multi_key_sort)
from ..core.plan import unique_concat
from ..core.sketch import (
    SketchConfig,
    SketchSnapshot,
    SketchState,
    init_sketch,
    merge_sketches,
    snapshot_sketch,
    update_sketch,
)
from ..core.sparse import ewise_union, from_coo
from ..core.table import Table, resolve_device
from ..data.faults import IngestHealth
from ..data.pipeline import PinnedStager, Prefetcher
from ..data.plq import read_plq_chunks
from ..kernels.ops import windowed_histogram
from ..obs import get_registry
from .state import StreamState, init_state

__all__ = [
    "StreamConfig",
    "StreamEngine",
    "StreamBatchTimings",
    "StreamSnapshot",
    "update_state",
    "update_state_naive",
    "merge_states",
    "link_table",
    "anonymization_mapping",
    "stream_plq",
    "steady_state",
]

_TIER_ORDER = {"exact": 0, "both": 1, "sketch": 2}

_I32_MAX = torch.iinfo(torch.int32).max


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static capacities + query parameters of one stream engine.

    ``link_capacity`` bounds the distinct ``(window, src, dst)`` groups the
    state can hold and ``ip_capacity`` the distinct IPs; exceeding either is
    counted in ``state.overflow``, never silent.  Results are exact iff
    overflow == 0: dropped links undercount, and dropped dictionary entries
    alias their IPs onto surviving ids at snapshot time.
    ``batch_capacity`` is the static micro-batch buffer size.

    ``tier`` selects the analytics substrate(s) every batch folds into:
    ``"exact"`` is the CSR state; ``"sketch"`` the bounded-memory
    approximate tier (:mod:`repro_torch.core.sketch`, never overflows,
    answers carry error bounds); ``"both"`` runs the two side by side.
    ``backend`` is the kernels' dispatch (``"auto"``: the CUDA kernels on
    the card, the plain versions on the CPU); ``device`` is where the state
    lives: the card unless the caller asks for the CPU.
    """

    batch_capacity: int
    link_capacity: int
    ip_capacity: Optional[int] = None    # default: 2 * link_capacity
    n_windows: int = 8
    ip_bins: int = 1024
    top_k: int = 10
    backend: str = "auto"                # kernel dispatch: auto|torch|cuda
    tier: str = "exact"                  # exact | sketch | both
    sketch: Optional[SketchConfig] = None  # geometry of the approximate tier
    device: str = "cuda"

    def __post_init__(self):
        for f in ("batch_capacity", "link_capacity", "ip_capacity",
                  "n_windows", "ip_bins", "top_k"):
            if getattr(self, f) is not None and getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1")
        if self.tier not in _TIER_ORDER:
            raise ValueError(f"tier must be exact|sketch|both, got {self.tier!r}")

    @property
    def ips(self) -> int:
        # each link contributes at most 2 distinct IPs
        return self.ip_capacity or 2 * self.link_capacity

    @property
    def exact_enabled(self) -> bool:
        return self.tier in ("exact", "both")

    @property
    def sketch_enabled(self) -> bool:
        return self.tier in ("sketch", "both")

    @property
    def sketch_config(self) -> SketchConfig:
        return self.sketch if self.sketch is not None else SketchConfig()


# ---------------------------------------------------------------------------
# the state transition (pure; no host sync)
# ---------------------------------------------------------------------------

def _rank_among(order: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of ``order[i]`` among the masked entries sorted
    ascending (garbage where ``~mask``).  Orders must be distinct."""
    cap = order.shape[0]
    idx = _iota(cap, order.device)
    (_,), (slot,) = multi_key_sort([order.to(torch.int32)], [idx],
                                   valid_mask=mask)
    return torch.zeros(cap, dtype=torch.int32, device=order.device).scatter_(
        0, slot.long(), idx)


def _merge_dictionary(
    values: torch.Tensor,
    ids: torch.Tensor,
    n: torch.Tensor,
    cand_values: torch.Tensor,
    cand_new: torch.Tensor,
    cand_order: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert candidate IPs (sorted distinct, ``cand_new`` mask) into the
    dictionary.  New entries get ids ``n, n+1, ...`` in ascending
    ``cand_order`` (first-appearance positions); existing ids never change.
    Returns ``(values, ids, n, dropped)``, ``dropped`` > 0 iff it filled."""
    cap = values.shape[0]
    device = values.device
    n_new = cand_new.sum(dtype=torch.int32)
    fresh = n + _rank_among(cand_order, cand_new)
    cat_v = torch.cat([values, cand_values.to(torch.int32)])
    cat_i = torch.cat([ids, fresh.to(torch.int32)])
    cat_ok = torch.cat([_iota(cap, device) < n, cand_new])
    (sv,), (si,) = multi_key_sort([cat_v], [cat_i], valid_mask=cat_ok)
    total = n + n_new
    n2 = torch.clamp(total, max=cap)
    live = _iota(cap, device) < n2
    return (torch.where(live, sv[:cap], _I32_MAX),
            torch.where(live, si[:cap], 0), n2, total - n2)


def _merge_links(
    state: StreamState,
    keys: Sequence[torch.Tensor],
    packets: torch.Tensor,
    valid: torch.Tensor,
):
    """Merge incoming distinct links into the accumulated flat link table:
    one concat + (win, src, dst) group-by with packet sums.  Truncation on
    overflow keeps the lexicographically smallest groups and is counted."""
    cap = state.link_capacity
    device = state.device
    state_valid = _iota(cap, device) < state.n_links
    merged = groupby_aggregate(
        [torch.cat([state.win, keys[0]]), torch.cat([state.src, keys[1]]),
         torch.cat([state.dst, keys[2]])],
        {"packets": (torch.cat([state.packets, packets]), "sum")},
        valid_mask=torch.cat([state_valid, valid]),
        count_name=None,
    )
    n2 = torch.clamp(merged.n_groups, max=cap)
    live = _iota(cap, device) < n2
    return (
        torch.where(live, merged.keys[0][:cap], _I32_MAX),
        torch.where(live, merged.keys[1][:cap], _I32_MAX),
        torch.where(live, merged.keys[2][:cap], _I32_MAX),
        torch.where(live, merged.aggs["packets"][:cap].to(torch.int32), 0),
        n2,
        merged.n_groups - n2,
    )


def _fold_dictionary_and_activity(state: StreamState, src, dst, win, valid,
                                  n_valid, backend: str):
    """Steps 1 and 3 of the transition, shared by both link paths.

    1. the dictionary: batch-distinct IPs carry their first-appearance
    position (row-major, src before dst) from the plan's concat sort
    (``core.plan.unique_concat``), so new ids follow first-seen order.

    3. the activity accumulator: bins hash the ORIGINAL IP, so states built
    apart merge by addition; the histogram kernel folds the batch into the
    running histogram through its ``init`` epilogue.
    """
    rows = _iota(src.shape[0], src.device)
    bu = unique_concat(src, dst, n_valid,
                       positions=torch.cat([2 * rows, 2 * rows + 1]),
                       count_name=None)
    known = isin(bu.keys[0], state.ip_values, state.n_ips, n_valid=bu.n_groups)
    new = bu.mask() & ~known
    dictionary = _merge_dictionary(state.ip_values, state.ip_ids, state.n_ips,
                                   bu.keys[0], new, bu.aggs["first_pos"])
    act_ids = torch.where(valid, (mix32(src) % state.ip_bins).to(torch.int32), -1)
    activity = windowed_histogram(
        win, act_ids, state.n_windows, state.ip_bins,
        weights=valid.to(torch.float32), init=state.activity, backend=backend)
    return dictionary, activity


def _batch_columns(state: StreamState, src, dst, win, n_valid):
    """The batch as the transition reads it: int32 columns, windows clipped
    into range, the live count on the device and the live-row mask."""
    n_valid = _count(n_valid, 0, state.device)
    src = src.to(torch.int32)
    dst = dst.to(torch.int32)
    win = torch.clamp(win.to(torch.int32), 0, state.n_windows - 1)
    valid = Table(columns={"src": src, "dst": dst}, n_valid=n_valid).valid_mask()
    return src, dst, win, n_valid, valid


def update_state(state: StreamState, src: torch.Tensor, dst: torch.Tensor,
                 win: torch.Tensor, n_valid, *,
                 backend: str = "auto") -> StreamState:
    """Fold one micro-batch (padded to ``batch_capacity``, the first
    ``n_valid`` rows live) into the state.

    2. the accumulated windowed traffic matrix: ONE ``from_coo`` over the
    state's CSR entries ++ the raw batch rows — duplicate collapse under
    plus is at once the batch's (win, src, dst) group-by AND the upsert, so
    the link path costs one three-key sort (two passes) where
    :func:`update_state_naive` pays two.  Overflow past ``link_capacity`` is
    counted by ``from_coo``.  Five sorts in all: the batch's endpoint union,
    the rank of its new IPs, the dictionary, and the upsert's two passes.
    """
    src, dst, win, n_valid, valid = _batch_columns(state, src, dst, win, n_valid)
    (ip_values, ip_ids, n_ips, ov_ips), activity = _fold_dictionary_and_activity(
        state, src, dst, win, valid, n_valid, backend)
    links, ov_links = from_coo(
        [torch.cat([state.win, win]), torch.cat([state.src, src])],
        torch.cat([state.dst, dst]),
        torch.cat([state.packets, torch.ones_like(src)]),
        valid_mask=torch.cat([state.links.entry_mask(), valid]),
        op="plus",
        nnz_capacity=state.link_capacity,
    )
    return StreamState(
        ip_values=ip_values, ip_ids=ip_ids, n_ips=n_ips,
        links=links,
        activity=activity,
        n_packets=state.n_packets + n_valid,
        n_batches=state.n_batches + 1,
        overflow=state.overflow + ov_ips + ov_links,
    )


def update_state_naive(state: StreamState, src: torch.Tensor,
                       dst: torch.Tensor, win: torch.Tensor, n_valid, *,
                       backend: str = "auto") -> StreamState:
    """The A/B baseline link path: a batch group-by, a second concat
    group-by merging it into the flat link table (:func:`_merge_links`), and
    a pack into the CSR layout.  Gives a bit-identical ``StreamState`` to
    :func:`update_state`, at two more three-key sorts (four more passes)."""
    src, dst, win, n_valid, valid = _batch_columns(state, src, dst, win, n_valid)
    (ip_values, ip_ids, n_ips, ov_ips), activity = _fold_dictionary_and_activity(
        state, src, dst, win, valid, n_valid, backend)
    bl = groupby_aggregate([win, src, dst],
                           {"packets": (torch.ones_like(src), "sum")},
                           n_valid=n_valid, count_name=None)
    w2, s2, d2, pk2, n_links, ov_links = _merge_links(
        state, bl.keys, bl.aggs["packets"], bl.mask())
    # pack the (already distinct, lex-sorted) flat table into the CSR layout
    links, _ = from_coo([w2, s2], d2, pk2, n_valid=n_links, op="plus")
    return StreamState(
        ip_values=ip_values, ip_ids=ip_ids, n_ips=n_ips,
        links=links,
        activity=activity,
        n_packets=state.n_packets + n_valid,
        n_batches=state.n_batches + 1,
        overflow=state.overflow + ov_ips + ov_links,
    )


def merge_states(a: StreamState, b: StreamState) -> StreamState:
    """Merge two independently built shard states (same capacities).

    Exact for links, scalars and activity: the accumulated matrices merge
    by ``ewise_union`` under plus (overflow counted).  ``b``'s IPs unknown
    to ``a`` get fresh ids continuing ``a``'s sequence in ``b``'s first-seen
    order, so the merge is associative and commutative up to id relabeling.
    """
    if (a.link_capacity != b.link_capacity
            or a.ip_capacity != b.ip_capacity
            or a.activity.shape != b.activity.shape):
        raise ValueError(
            "merge_states requires equal static capacities and "
            f"(n_windows, ip_bins): {a.link_capacity}/{a.ip_capacity}/"
            f"{tuple(a.activity.shape)} vs {b.link_capacity}/{b.ip_capacity}/"
            f"{tuple(b.activity.shape)}")
    known = isin(b.ip_values, a.ip_values, a.n_ips, n_valid=b.n_ips)
    new = (_iota(b.ip_capacity, b.device) < b.n_ips) & ~known
    ip_values, ip_ids, n_ips, ov_ips = _merge_dictionary(
        a.ip_values, a.ip_ids, a.n_ips, b.ip_values, new, b.ip_ids)
    links, ov_links = ewise_union(a.links, b.links, op="plus",
                                  nnz_capacity=a.link_capacity,
                                  row_capacity=a.link_capacity)
    return StreamState(
        ip_values=ip_values, ip_ids=ip_ids, n_ips=n_ips,
        links=links,
        activity=a.activity + b.activity,
        n_packets=a.n_packets + b.n_packets,
        n_batches=a.n_batches + b.n_batches,
        overflow=a.overflow + b.overflow + ov_ips + ov_links,
    )


# ---------------------------------------------------------------------------
# queries over the state
# ---------------------------------------------------------------------------

def link_table(state: StreamState) -> Table:
    """The accumulated windowed traffic matrix as an anonymized packet table:
    one row per distinct ``(window, src, dst)`` with ``n_packets`` weights,
    src/dst the dictionary's stable ids — query-equivalent to the packets
    streamed so far.  A key missing from a full dictionary (overflow) takes
    the last slot's id, as the reference's clamped gather does."""
    cap = state.link_capacity
    live = _iota(cap, state.device) < state.n_links
    last = state.ip_capacity - 1
    stable = lambda keys: state.ip_ids[
        torch.clamp(factorize(keys, state.ip_values), max=last).long()]
    return Table(
        columns={
            "win": torch.where(live, state.win, 0),
            "src": torch.where(live, stable(state.src), 0),
            "dst": torch.where(live, stable(state.dst), 0),
            "n_packets": torch.where(live, state.packets, 0),
        },
        n_valid=state.n_links,
    )


def _snapshot_results(state: StreamState, *, top_k: int,
                      backend: str) -> ChallengeResults:
    # the accumulated activity (original-IP bins, mergeable) stands in for
    # the snapshot's own (stable-id bins), which is therefore not computed
    return challenge_analyze(
        link_table(state), n_windows=state.n_windows, ip_bins=state.ip_bins,
        k=top_k, backend=backend, device=state.device,
        window_activity=state.activity)


def anonymization_mapping(state: StreamState) -> Tuple[np.ndarray, np.ndarray]:
    """Host copy of the dictionary: ``(original_ips, stable_ids)`` (live rows)."""
    n = int(state.n_ips)
    return state.ip_values[:n].cpu().numpy(), state.ip_ids[:n].cpu().numpy()


@dataclasses.dataclass
class StreamSnapshot:
    """Point-in-time query answer over everything streamed so far.

    ``results`` is the exact tier's answer (None when ``tier="sketch"``),
    ``sketch`` the approximate tier's (None when ``tier="exact"``).
    ``n_links``/``n_ips``/``overflow`` are exact-tier facts, None when that
    tier is off.  ``tier`` is the tier active at snapshot time (``degrade``
    can move it; ``health`` records where), ``health`` the ingest ledger.
    """

    results: Optional[ChallengeResults]
    n_packets: int
    n_batches: int
    n_links: Optional[int]
    n_ips: Optional[int]
    overflow: Optional[int]  # > 0 => exact results unreliable (never silent)
    sketch: Optional[SketchSnapshot] = None
    tier: str = "exact"
    health: Optional[IngestHealth] = None

    @property
    def reliable(self) -> bool:
        """True iff nothing was lost: no exact-tier overflow (or that tier is
        off) and no batch dropped past its retry budget."""
        overflowed = self.overflow is not None and self.overflow != 0
        lost = self.health is not None and self.health.lost_batches > 0
        return not overflowed and not lost


# ---------------------------------------------------------------------------
# per-batch timings
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamBatchTimings:
    """Wall seconds of one ingest.  ``compile=True`` marks the first batch,
    which carries the kernels' build and load and the allocator's first
    blocks; steady-state summaries leave it out."""

    n_packets: int
    prep_s: float        # host: window slice + padding into the pinned buffer
    transfer_s: float    # host->device (waited for only with time_phases)
    update_s: float      # the state transition (waited for only with time_phases)
    total_s: float
    compile: bool = False


def steady_state(timings: Sequence[StreamBatchTimings]) -> Dict[str, float]:
    """Aggregate steady-state (first batch excluded) per-batch walls."""
    steady = [t for t in timings if not t.compile]
    if not steady:
        return {"batches": 0.0, "batch_s": 0.0, "packets_per_s": 0.0,
                "prep_s": 0.0, "transfer_s": 0.0, "update_s": 0.0}
    n = len(steady)
    pk = sum(t.n_packets for t in steady)
    tot = sum(t.total_s for t in steady)
    return {
        "batches": float(n),
        "batch_s": tot / n,
        "packets_per_s": pk / tot if tot > 0 else float("inf"),
        "prep_s": sum(t.prep_s for t in steady) / n,
        "transfer_s": sum(t.transfer_s for t in steady) / n,
        "update_s": sum(t.update_s for t in steady) / n,
    }


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _fresh(x, device: torch.device):
    """``x`` with every tensor (or numpy) leaf copied into a new allocation
    on ``device``, through tuples and dataclasses."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, copy=True)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x)).to(device)
    if isinstance(x, tuple):
        return tuple(_fresh(v, device) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _fresh(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x)})
    return x


class StreamEngine:
    """Stateful driver around the pure state transition.

    ``ingest`` returns once the batch's work is queued on the card: the
    host prepares the next micro-batch while the card folds this one, so
    calling ``ingest`` in a loop overlaps the two.  The old state is freed
    as the new one replaces it.
    """

    def __init__(self, cfg: StreamConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self._state = init_state(cfg.link_capacity, cfg.ips, cfg.n_windows,
                                 cfg.ip_bins, self.device)
        self._sketch_state = (init_sketch(cfg.sketch_config, self.device)
                              if cfg.sketch_enabled else None)
        self.n_ingested = 0
        self.health = IngestHealth()

    # -- state access --------------------------------------------------------
    @property
    def state(self) -> StreamState:
        return self._state

    @property
    def sketch_state(self) -> Optional[SketchState]:
        return self._sketch_state

    def block(self) -> StreamState:
        """Wait until every queued fold has finished on the card."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._state

    def merge_from(self, other: StreamState,
                   sketch: Optional[SketchState] = None) -> None:
        """Fold another shard's state into this engine (host-level merge).
        Pass the shard's ``sketch_state`` too when the sketch tier is on."""
        if self.cfg.exact_enabled:
            self._state = merge_states(self._state, other)
        if sketch is not None:
            if self._sketch_state is None:
                raise ValueError("sketch merge on a tier='exact' engine")
            self._sketch_state = merge_sketches(self._sketch_state, sketch)

    def load(self, state: Optional[StreamState] = None,
             sketch_state: Optional[SketchState] = None,
             health: Optional[IngestHealth] = None) -> None:
        """Adopt restored state.  Every leaf is copied into a fresh
        allocation on the engine's device, so none aliases the caller's
        buffers (restored arrays may share memory with read buffers)."""
        if state is not None:
            self._state = _fresh(state, self.device)
        if sketch_state is not None:
            if not self.cfg.sketch_enabled:
                raise ValueError("sketch state loaded into a tier='exact' engine")
            self._sketch_state = _fresh(sketch_state, self.device)
        if health is not None:
            self.health = health

    # -- graceful degradation ------------------------------------------------
    def degrade(self, to_tier: str) -> None:
        """Switch the active tier forward (exact -> both -> sketch).

        Forward-only: re-enabling the exact tier after its state froze would
        silently un-count everything streamed in between.  When the switch
        turns the sketch tier on for the first time, the fresh sketch is
        backfilled from the exact link table (one weighted ``update_sketch``
        over the accumulated ``(src, dst, packets)`` rows), so its answers
        cover the whole history.  ``"sketch"`` freezes the exact state.  The
        switch is recorded in ``health`` and shows on every later snapshot.
        """
        if to_tier not in _TIER_ORDER:
            raise ValueError(f"unknown tier {to_tier!r}")
        if _TIER_ORDER[to_tier] <= _TIER_ORDER[self.cfg.tier]:
            raise ValueError(
                f"degrade is forward-only: {self.cfg.tier!r} -> {to_tier!r}")
        at_batch = int(self._state.n_batches) if self.cfg.exact_enabled \
            else int(self._sketch_state.n_batches)
        if self._sketch_state is None:
            st = self._state
            self._sketch_state = update_sketch(
                init_sketch(self.cfg.sketch_config, self.device),
                st.src, st.dst, st.n_links,
                weights=st.packets, backend=self.cfg.backend)
        self.cfg = dataclasses.replace(self.cfg, tier=to_tier)
        self.health.degraded_to = to_tier
        self.health.degraded_at_batch = at_batch
        reg = get_registry()
        reg.counter("stream_degrade_total", "tier degradations applied").inc()
        reg.gauge("stream_tier", "active tier (0=exact 1=both 2=sketch)"
                  ).set(_TIER_ORDER[to_tier])

    # -- ingest --------------------------------------------------------------
    def ingest(self, src, dst, win, n_valid: Optional[int] = None) -> None:
        """Fold one micro-batch of host columns; they may be shorter than
        ``batch_capacity`` (padded here)."""
        cap = self.cfg.batch_capacity
        n = len(src) if n_valid is None else int(n_valid)
        if n > cap:
            raise ValueError(f"micro-batch of {n} rows exceeds "
                             f"batch_capacity {cap}")
        pad = lambda a: np.concatenate(
            [np.asarray(a[:n], np.int32), np.zeros(cap - n, np.int32)])
        self.ingest_padded(pad(src), pad(dst), pad(win), n)

    def ingest_padded(self, src, dst, win, n_valid: int) -> None:
        """Fold a pre-padded micro-batch (tensors on the engine's device, or
        host arrays, copied here) into every enabled tier."""
        src, dst, win = (a if isinstance(a, torch.Tensor)
                         else torch.from_numpy(np.ascontiguousarray(a))
                         for a in (src, dst, win))
        src, dst, win = (a.to(self.device) for a in (src, dst, win))
        if self.cfg.exact_enabled:
            self._state = update_state(self._state, src, dst, win, n_valid,
                                       backend=self.cfg.backend)
        if self.cfg.sketch_enabled:
            self._sketch_state = update_sketch(
                self._sketch_state, src, dst,
                _count(n_valid, 0, self.device), backend=self.cfg.backend)
        self.n_ingested += 1
        reg = get_registry()
        reg.counter("stream_batches_ingested_total",
                    "micro-batches folded into the stream state").inc()
        reg.counter("stream_packets_ingested_total",
                    "live packet rows folded").inc(int(n_valid))

    # -- queries -------------------------------------------------------------
    def snapshot(self, distributed: bool = False) -> StreamSnapshot:
        """Answer all challenge queries from the accumulated state (waits
        for the card).  ``distributed=True`` is not ported yet."""
        if distributed:
            raise NotImplementedError(
                "snapshot(distributed=True) is not ported to PyTorch yet "
                "(ROADMAP.md queue 1 item 10)")
        t0 = time.perf_counter()
        state = self._state
        results = None
        if self.cfg.exact_enabled:
            results = _snapshot_results(state, top_k=self.cfg.top_k,
                                        backend=self.cfg.backend)
            self.block()
        sketch = None
        if self._sketch_state is not None:
            sketch = snapshot_sketch(self._sketch_state, k=self.cfg.top_k)
        exact = self.cfg.exact_enabled
        totals = state if exact else self._sketch_state
        snap = StreamSnapshot(
            results=results,
            n_packets=int(totals.n_packets),
            n_batches=int(totals.n_batches),
            n_links=int(state.n_links) if exact else None,
            n_ips=int(state.n_ips) if exact else None,
            overflow=int(state.overflow) if exact else None,
            sketch=sketch,
            tier=self.cfg.tier,
            health=dataclasses.replace(self.health),
        )
        # the snapshot already waits for the card, so mirroring the engine's
        # and the ingest path's facts into the registry costs no extra sync
        reg = get_registry()
        reg.histogram("stream_snapshot_seconds",
                      "wall seconds per snapshot() query pass"
                      ).observe(time.perf_counter() - t0)
        reg.gauge("stream_packets", "packets folded so far").set(snap.n_packets)
        reg.gauge("stream_batches", "batches folded so far").set(snap.n_batches)
        if exact:
            reg.gauge("stream_links", "distinct links held").set(snap.n_links)
            reg.gauge("stream_ips", "dictionary entries held").set(snap.n_ips)
            reg.gauge("stream_overflow", "rows dropped past capacity (0 == exact)"
                      ).set(snap.overflow)
        reg.gauge("stream_reliable", "1 iff no overflow and no lost batches"
                  ).set(int(snap.reliable))
        h = self.health
        reg.gauge("ingest_duplicates_dropped", "").set(h.duplicates_dropped)
        reg.gauge("ingest_reordered_buffered", "").set(h.reordered_buffered)
        reg.gauge("ingest_quarantined", "").set(h.quarantined)
        reg.gauge("ingest_io_retries", "").set(h.io_retries)
        reg.gauge("ingest_lost_batches", "").set(h.lost_batches)
        reg.gauge("ingest_batches_replayed", "").set(h.batches_replayed)
        reg.gauge("ingest_crashes_recovered", "").set(h.crashes_recovered)
        reg.gauge("ingest_checkpoints_committed", "").set(h.checkpoints_committed)
        return snap

    def algorithms(self, source: int = 0):
        """BFS, components, PageRank and triangles over everything streamed
        so far, from the accumulated link table (two sorts over
        ``link_capacity`` rows, never the packet stream); waits for the card.
        """
        from .algorithms import snapshot_algorithms

        out = snapshot_algorithms(self._state, source, backend=self.cfg.backend)
        self.block()
        return out


# ---------------------------------------------------------------------------
# plq streaming driver
# ---------------------------------------------------------------------------

def stream_plq(
    engine: StreamEngine,
    path: str,
    win_full: np.ndarray,
    *,
    columns: Sequence[str] = ("src", "dst"),
    depth: int = 2,
    time_phases: bool = False,
    on_batch: Optional[Callable[[int, StreamEngine], None]] = None,
) -> List[StreamBatchTimings]:
    """Stream a plq capture's row groups through the engine.

    A background thread (``Prefetcher``) reads row groups ahead; each is
    padded into one of the ``PinnedStager``'s two pinned host buffers and
    copied to the card with ``non_blocking=True``, and its fold is queued
    behind the copy, so the host reads and pads batch i+1 while the card
    folds batch i.  ``win_full`` holds the window id of every capture row
    (row groups arrive in file order).

    ``time_phases=True`` waits after the transfer and after the fold, so
    that each phase's wall is its own (no overlap); the default overlapped
    mode records queueing walls and is the throughput measurement.
    """
    cap = engine.cfg.batch_capacity
    stager = PinnedStager(engine.device)
    timings: List[StreamBatchTimings] = []
    off = 0
    with Prefetcher(read_plq_chunks(path, list(columns)), depth=depth) as chunks:
        for i, chunk in enumerate(chunks):
            t_start = time.perf_counter()
            n = len(chunk[columns[0]])
            if n > cap:
                raise ValueError(
                    f"row group {i} has {n} rows > batch_capacity {cap}; "
                    f"rewrite the capture with row_group_size <= {cap}")
            host = stager.take({"rows": ((3, cap), np.int32)})["rows"]
            for row, col in enumerate((chunk["src"], chunk["dst"],
                                       win_full[off:off + n])):
                np.copyto(host[row, :n], col, casting="unsafe")
            host[:, n:] = 0
            off += n
            t1 = time.perf_counter()
            batch = stager.send(wait=time_phases)["rows"]
            t2 = time.perf_counter()
            engine.ingest_padded(batch[0], batch[1], batch[2], n)
            if time_phases:
                engine.block()
            t3 = time.perf_counter()
            timings.append(StreamBatchTimings(
                n_packets=n, prep_s=t1 - t_start, transfer_s=t2 - t1,
                update_s=t3 - t2, total_s=t3 - t_start, compile=(i == 0)))
            if i > 0:  # steady state only: the first batch would skew p99
                get_registry().histogram(
                    "stream_batch_seconds",
                    "steady-state wall seconds per ingested micro-batch",
                ).observe(t3 - t_start)
            if on_batch is not None:
                on_batch(i, engine)
    engine.block()
    return timings
