"""Sketch-based bounded-memory analytics tier — the port of what
``run_sketch_tier`` reaches in ``repro/core/sketch.py``.

Three classical summaries whose memory is fixed at configuration time,
with checked error bounds instead of exactness:

  * **Count–Min sketch** (conservative update) of per-link and per-source
    packet counts: a point estimate never underestimates and overestimates
    by more than ``e/width · N`` with probability at most ``e^-depth``;
  * **HyperLogLog** of unique sources, destinations and links: relative
    error around ``1.04 / sqrt(2^p)``, with the linear-counting correction;
  * **space-saving heavy hitters** (Misra–Gries normal form plus the
    accumulated decrement ``offset``): ``count + offset`` never
    underestimates and errs by at most ``offset <= N / (capacity + 1)``.

The CMS fold is one :func:`repro_torch.kernels.ops.cms_update` launch per
summary and batch (the Count–Min kernel on the card), the HLL fold one
:func:`repro_torch.kernels.ops.hll_update` per summary (the segment-max
kernel with ``init``), the heavy-hitter fold one group-by and one top-k.

The hashes are the reference's uint32 ``mix32`` family, computed in int64
masked to 32 bits (torch has no ``>>`` or ``%`` on ``uint32``; see
:mod:`repro_torch.core.ops`), so every register and cell equals the
reference's bit for bit.  :func:`merge_sketches` combines two states
(the streaming engine's ``merge_from``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.ops import cms_update, hll_update
from .ops import _iota, groupby_aggregate, mix32, top_k
from .table import resolve_device

__all__ = [
    "SketchConfig",
    "SketchState",
    "SketchSnapshot",
    "init_sketch",
    "update_sketch",
    "merge_sketches",
    "snapshot_sketch",
    "sketch_scalars",
    "estimate_link_packets",
    "estimate_source_packets",
    "hll_cardinality",
    "heavy_links",
    "heavy_talkers",
    "error_bounds",
]

_I32_MAX = torch.iinfo(torch.int32).max
_U32_MASK = 0xFFFFFFFF
_GOLD = 0x9E3779B9       # 32-bit golden-ratio constant (salt mixing)
_ROW_SALT = 0x85EBCA6B   # per-depth-row salt stride (odd, from murmur3)


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Static geometry of one sketch tier: ``2 · cms_depth · cms_width``
    int32 CMS cells, ``3 · 2^hll_p`` float32 HLL registers and
    ``O(heavy_capacity)`` heavy-hitter slots, whatever the traffic."""

    cms_depth: int = 4
    cms_width: int = 4096
    hll_p: int = 12              # 2^p registers per cardinality
    heavy_capacity: int = 64     # space-saving counters per summary
    seed: int = 0                # hash-family salt

    def __post_init__(self):
        if self.cms_depth < 1:
            raise ValueError("cms_depth must be >= 1")
        if self.cms_width < 2:
            raise ValueError("cms_width must be >= 2")
        if not 4 <= self.hll_p <= 18:
            raise ValueError("hll_p must be in [4, 18]")
        if self.heavy_capacity < 1:
            raise ValueError("heavy_capacity must be >= 1")

    @property
    def hll_m(self) -> int:
        return 1 << self.hll_p


@dataclasses.dataclass(frozen=True)
class SketchState:
    """One accumulated sketch tier.  Heavy-hitter tables are in
    descending-count order, ties toward the smallest key; empty slots hold
    key ``int32 max`` and count 0.  ``seed`` is the hash-family salt."""

    cms_links: torch.Tensor       # (depth, width) int32
    cms_sources: torch.Tensor     # (depth, width) int32
    hll_src: torch.Tensor         # (m,) float32
    hll_dst: torch.Tensor         # (m,) float32
    hll_links: torch.Tensor       # (m,) float32
    hh_link_src: torch.Tensor     # (heavy_capacity,) int32, pad = int32 max
    hh_link_dst: torch.Tensor     # (heavy_capacity,) int32
    hh_link_count: torch.Tensor   # (heavy_capacity,) int32, pad = 0
    hh_link_offset: torch.Tensor  # 0-d int32, total decremented mass
    hh_src_key: torch.Tensor      # (heavy_capacity,) int32
    hh_src_count: torch.Tensor    # (heavy_capacity,) int32
    hh_src_offset: torch.Tensor   # 0-d int32
    n_packets: torch.Tensor       # 0-d int32
    n_batches: torch.Tensor       # 0-d int32
    seed: int

    @property
    def cms_depth(self) -> int:
        return self.cms_links.shape[0]

    @property
    def cms_width(self) -> int:
        return self.cms_links.shape[1]

    @property
    def hll_m(self) -> int:
        return self.hll_src.shape[0]

    @property
    def hll_p(self) -> int:
        return int(self.hll_m).bit_length() - 1

    @property
    def heavy_capacity(self) -> int:
        return self.hh_link_count.shape[0]


def init_sketch(cfg: SketchConfig, device="cuda") -> SketchState:
    """The empty state on ``device``, every field its own buffer."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    k = cfg.heavy_capacity
    cms = lambda: torch.zeros((cfg.cms_depth, cfg.cms_width), **i32)
    regs = lambda: torch.zeros(cfg.hll_m, dtype=torch.float32, device=device)
    zero = lambda: torch.zeros((), **i32)
    return SketchState(
        cms_links=cms(), cms_sources=cms(),
        hll_src=regs(), hll_dst=regs(), hll_links=regs(),
        hh_link_src=torch.full((k,), _I32_MAX, **i32),
        hh_link_dst=torch.full((k,), _I32_MAX, **i32),
        hh_link_count=torch.zeros(k, **i32), hh_link_offset=zero(),
        hh_src_key=torch.full((k,), _I32_MAX, **i32),
        hh_src_count=torch.zeros(k, **i32), hh_src_offset=zero(),
        n_packets=zero(), n_batches=zero(), seed=cfg.seed,
    )


# -----------------------------------------------------------------------------
# hashing (one mix32 family, salted per structure and per depth row); uint32
# words are int64 in [0, 2^32)
# -----------------------------------------------------------------------------

def _hash_src(src: torch.Tensor, salt: int) -> torch.Tensor:
    """uint32 hash of a single key under ``salt``."""
    return mix32(src.to(torch.int64) + (salt & _U32_MASK))


def _hash_link(src: torch.Tensor, dst: torch.Tensor, salt: int) -> torch.Tensor:
    """uint32 hash of a key pair: mix each endpoint, then mix the xor."""
    hs = mix32(src.to(torch.int64) + (salt & _U32_MASK))
    hd = mix32(dst.to(torch.int64) + ((salt ^ _GOLD) & _U32_MASK))
    return mix32(hs ^ hd)


def _cms_cols(hashes_per_row, width: int) -> torch.Tensor:
    """Stack per-row uint32 hashes into (depth, n) int32 column ids."""
    return torch.stack([(h % width).to(torch.int32) for h in hashes_per_row])


def _link_rows(src, dst, seed: int, depth: int, width: int) -> torch.Tensor:
    return _cms_cols(
        [_hash_link(src, dst, seed + (r + 1) * _ROW_SALT) for r in range(depth)],
        width)


def _src_rows(src, seed: int, depth: int, width: int) -> torch.Tensor:
    return _cms_cols(
        [_hash_src(src, seed + (r + 1) * _ROW_SALT + _GOLD) for r in range(depth)],
        width)


def _floor_log2_u32(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(x)) of uint32 words ``x > 0`` (integer binary
    reduce, no float round trip)."""
    y = x.to(torch.int64)
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for s in (16, 8, 4, 2, 1):
        big = y >= (1 << s)
        n = n + torch.where(big, s, 0).to(torch.int32)
        y = torch.where(big, y >> s, y)
    return n


def _hll_parts(h: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a uint32 hash into (register id, rho): the register is the top
    ``p`` bits, rho 1 + the leading zeros of the other ``32 - p`` bits,
    ``32 - p + 1`` when they are all zero."""
    reg = (h >> (32 - p)).to(torch.int32)
    w = (h << p) & _U32_MASK  # the residual in the top bits, back to 32 bits
    rho = torch.where(w == 0, 32 - p + 1,
                      32 - _floor_log2_u32(torch.clamp(w, min=1)))
    return reg, rho.to(torch.int32)


# -----------------------------------------------------------------------------
# space-saving fold (Misra–Gries merge with decrement accounting)
# -----------------------------------------------------------------------------

def _ss_fold(keys_a, counts_a, offset_a, keys_b, counts_b, valid_b, offset_b,
             capacity: int):
    """Fold candidate (key, count) rows into a space-saving summary: one
    concat group-by sums coincident keys, then the Misra–Gries step
    subtracts the ``(capacity+1)``-th largest count from everything, keeps
    the survivors and adds the subtraction to ``offset``.  Ties in the top-k
    go to the lowest index, i.e. the smallest key, so the fold is a pure
    function of the union.  Returns (keys, counts, offset)."""
    cat_keys = [torch.cat([ka, kb]) for ka, kb in zip(keys_a, keys_b)]
    cat_counts = torch.cat([counts_a, counts_b]).to(torch.int32)
    cat_valid = torch.cat([counts_a > 0, valid_b])
    g = groupby_aggregate(cat_keys, {"count": (cat_counts, "sum")},
                          valid_mask=cat_valid, count_name=None)
    vals, idx, n_live = top_k(g.aggs["count"], capacity + 1, g.mask())
    thr = torch.where(n_live > capacity, vals[capacity], 0).to(torch.int32)
    kept = vals[:capacity].to(torch.int32) - thr
    keep = (_iota(capacity, kept.device) < n_live) & (kept > 0)
    out_keys = [torch.where(keep, k[idx[:capacity].long()], _I32_MAX)
                for k in g.keys]
    return out_keys, torch.where(keep, kept, 0), offset_a + offset_b + thr


def update_sketch(
    state: SketchState,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_valid,
    *,
    weights: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> SketchState:
    """Fold one micro-batch (padded to a static capacity, the first
    ``n_valid`` rows live) into the sketch.

    ``weights`` is the per-row packet multiplicity (1 per row by default).
    The batch is first collapsed to distinct links and sources (the
    conservative update needs per-key batch totals), then each summary
    folds in one launch.  Nothing overflows: accuracy, not capacity, is
    what degrades.
    """
    cap = src.shape[0]
    device = src.device
    src = src.to(torch.int32)
    dst = dst.to(torch.int32)
    valid = _iota(cap, device) < n_valid
    w = (torch.ones(cap, dtype=torch.int32, device=device) if weights is None
         else weights.to(torch.int32))
    w = torch.where(valid, w, 0)
    seed, depth, width = state.seed, state.cms_depth, state.cms_width

    g_link = groupby_aggregate([src, dst], {"packets": (w, "sum")},
                               valid_mask=valid, count_name=None)
    g_src = groupby_aggregate([src], {"packets": (w, "sum")},
                              valid_mask=valid, count_name=None)

    def cms_fold(counts, rows, group_counts, mask):
        # conservative update: propose est + batch count at every row's
        # cell, int32 end to end (a float32 round trip would round the
        # proposal down past 2^24 and underestimate)
        safe = torch.clamp(rows, 0, width - 1).long()
        est = counts.gather(1, safe).min(dim=0).values
        props = torch.where(mask, est + group_counts.to(torch.int32), 0)
        ids = torch.where(mask[None, :], rows, -1)
        return cms_update(counts, ids, props, backend=backend)

    lmask = g_link.mask() & (g_link.aggs["packets"] > 0)
    smask = g_src.mask() & (g_src.aggs["packets"] > 0)
    cms_links = cms_fold(
        state.cms_links,
        _link_rows(g_link.keys[0], g_link.keys[1], seed, depth, width),
        g_link.aggs["packets"], lmask)
    cms_sources = cms_fold(
        state.cms_sources, _src_rows(g_src.keys[0], seed, depth, width),
        g_src.aggs["packets"], smask)

    # HLL folds over raw rows (duplicates are harmless to a max fold)
    p = state.hll_p

    def hll_fold(regs, hashes):
        reg, rho = _hll_parts(hashes, p)
        return hll_update(regs, torch.where(valid, reg, -1), rho,
                          backend=backend)

    hll_src = hll_fold(state.hll_src, _hash_src(src, seed + 1))
    hll_dst = hll_fold(state.hll_dst, _hash_src(dst, seed + 2))
    hll_links = hll_fold(state.hll_links, _hash_link(src, dst, seed + 3))

    zero = torch.zeros((), dtype=torch.int32, device=device)
    (hl_src, hl_dst), hl_count, hl_off = _ss_fold(
        [state.hh_link_src, state.hh_link_dst], state.hh_link_count,
        state.hh_link_offset, [g_link.keys[0], g_link.keys[1]],
        g_link.aggs["packets"], lmask, zero, state.heavy_capacity)
    (hs_key,), hs_count, hs_off = _ss_fold(
        [state.hh_src_key], state.hh_src_count, state.hh_src_offset,
        [g_src.keys[0]], g_src.aggs["packets"], smask, zero,
        state.heavy_capacity)

    return SketchState(
        cms_links=cms_links, cms_sources=cms_sources,
        hll_src=hll_src, hll_dst=hll_dst, hll_links=hll_links,
        hh_link_src=hl_src, hh_link_dst=hl_dst, hh_link_count=hl_count,
        hh_link_offset=hl_off,
        hh_src_key=hs_key, hh_src_count=hs_count, hh_src_offset=hs_off,
        n_packets=state.n_packets + w.sum(dtype=torch.int32),
        n_batches=state.n_batches + 1,
        seed=seed,
    )


def merge_sketches(a: SketchState, b: SketchState) -> SketchState:
    """Merge two independently built sketch states (same geometry + seed).

    Count–Min merges by addition (the conservative-update lower bound
    survives: ``min_r(a+b) >= min_r a + min_r b``), HyperLogLog by the
    element-wise max — both associative and commutative bit for bit.  The
    heavy-hitter tables merge through the Misra–Gries fold: commutative bit
    for bit, associative up to the error bound.
    """
    if (a.cms_links.shape != b.cms_links.shape
            or a.hll_m != b.hll_m
            or a.heavy_capacity != b.heavy_capacity
            or a.seed != b.seed):
        raise ValueError(
            "merge_sketches requires equal geometry and seed: "
            f"cms {tuple(a.cms_links.shape)}/{tuple(b.cms_links.shape)}, "
            f"hll {a.hll_m}/{b.hll_m}, "
            f"heavy {a.heavy_capacity}/{b.heavy_capacity}, "
            f"seed {a.seed}/{b.seed}")
    (hl_src, hl_dst), hl_count, hl_off = _ss_fold(
        [a.hh_link_src, a.hh_link_dst], a.hh_link_count, a.hh_link_offset,
        [b.hh_link_src, b.hh_link_dst], b.hh_link_count, b.hh_link_count > 0,
        b.hh_link_offset, a.heavy_capacity)
    (hs_key,), hs_count, hs_off = _ss_fold(
        [a.hh_src_key], a.hh_src_count, a.hh_src_offset,
        [b.hh_src_key], b.hh_src_count, b.hh_src_count > 0,
        b.hh_src_offset, a.heavy_capacity)
    return SketchState(
        cms_links=a.cms_links + b.cms_links,
        cms_sources=a.cms_sources + b.cms_sources,
        hll_src=torch.maximum(a.hll_src, b.hll_src),
        hll_dst=torch.maximum(a.hll_dst, b.hll_dst),
        hll_links=torch.maximum(a.hll_links, b.hll_links),
        hh_link_src=hl_src, hh_link_dst=hl_dst, hh_link_count=hl_count,
        hh_link_offset=hl_off,
        hh_src_key=hs_key, hh_src_count=hs_count, hh_src_offset=hs_off,
        n_packets=a.n_packets + b.n_packets,
        n_batches=a.n_batches + b.n_batches,
        seed=a.seed,
    )


# -----------------------------------------------------------------------------
# queries over the state
# -----------------------------------------------------------------------------

def _cms_estimate(cms: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return cms.gather(1, rows.long()).min(dim=0).values


def estimate_link_packets(state: SketchState, src: torch.Tensor,
                          dst: torch.Tensor) -> torch.Tensor:
    """CMS point estimate of per-link packet counts (never underestimates)."""
    rows = _link_rows(src.to(torch.int32), dst.to(torch.int32), state.seed,
                      state.cms_depth, state.cms_width)
    return _cms_estimate(state.cms_links, rows)


def estimate_source_packets(state: SketchState,
                            src: torch.Tensor) -> torch.Tensor:
    """CMS point estimate of per-source packet counts (never underestimates)."""
    rows = _src_rows(src.to(torch.int32), state.seed, state.cms_depth,
                     state.cms_width)
    return _cms_estimate(state.cms_sources, rows)


def hll_cardinality(registers: torch.Tensor) -> torch.Tensor:
    """HyperLogLog estimate (float32) with the linear-counting small-range
    correction; the large-range correction binds only past ~2^32/30
    distinct keys and is omitted, as in the reference."""
    m = registers.shape[0]
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1.0 + 1.079 / m))
    raw = alpha * m * m / torch.exp2(-registers).sum()
    v = (registers == 0).sum(dtype=torch.int32)
    log_m = torch.log(torch.tensor(float(m), dtype=torch.float32,
                                   device=registers.device))
    small = m * (log_m - torch.log(torch.clamp(v, min=1).to(torch.float32)))
    return torch.where((raw <= 2.5 * m) & (v > 0), small, raw)


def heavy_links(state: SketchState):
    """Space-saving top links ``(src, dst, estimate, n_live)`` in descending
    estimate order; ``estimate = count + offset`` never underestimates."""
    live = state.hh_link_count > 0
    est = torch.where(live, state.hh_link_count + state.hh_link_offset, 0)
    return (state.hh_link_src, state.hh_link_dst, est,
            live.sum(dtype=torch.int32))


def heavy_talkers(state: SketchState):
    """Space-saving top sources ``(src, estimate, n_live)``."""
    live = state.hh_src_count > 0
    est = torch.where(live, state.hh_src_count + state.hh_src_offset, 0)
    return state.hh_src_key, est, live.sum(dtype=torch.int32)


def sketch_scalars(state: SketchState) -> Dict[str, torch.Tensor]:
    """The scalar suite as estimates.  ``valid_packets`` is an exact
    counter, the cardinalities HLL estimates; each maximum takes, per stored
    heavy-hitter key, the tighter of the space-saving and CMS estimates
    (neither underestimates), then the max over stored keys:
    ``true_max - offset <= est <= true_max + εN``."""
    hl_src, hl_dst, hl_est, hl_n = heavy_links(state)
    hs_key, hs_est, hs_n = heavy_talkers(state)
    link_bound = torch.minimum(hl_est,
                               estimate_link_packets(state, hl_src, hl_dst))
    src_bound = torch.minimum(hs_est, estimate_source_packets(state, hs_key))
    top_link = torch.where(state.hh_link_count > 0, link_bound, 0).max()
    top_src = torch.where(state.hh_src_count > 0, src_bound, 0).max()
    return {
        "valid_packets": state.n_packets,
        "n_unique_sources": hll_cardinality(state.hll_src),
        "n_unique_destinations": hll_cardinality(state.hll_dst),
        "unique_links": hll_cardinality(state.hll_links),
        "max_link_packets": torch.where(hl_n > 0, top_link, 0),
        "max_source_packets": torch.where(hs_n > 0, top_src, 0),
    }


def error_bounds(state: SketchState, hll_sigma: float = 4.0) -> Dict[str, float]:
    """The configured theoretical bounds at the current traffic volume."""
    n = float(int(state.n_packets))
    return {
        "cms_epsilon_n": (math.e / state.cms_width) * n,
        "cms_delta": math.exp(-state.cms_depth),
        "hll_rel_tolerance": hll_sigma * 1.04 / math.sqrt(state.hll_m),
        "heavy_offset_bound": n / (state.heavy_capacity + 1),
        "heavy_link_offset": float(int(state.hh_link_offset)),
        "heavy_src_offset": float(int(state.hh_src_offset)),
    }


@dataclasses.dataclass
class SketchSnapshot:
    """Point-in-time sketch-tier answers (host values); ``overflow`` is 0
    by construction, the cost is the error bounds in ``bounds``."""

    n_packets: int
    n_batches: int
    unique_sources: float          # HLL estimates
    unique_destinations: float
    unique_links: float
    max_link_packets: float        # min(space-saving, CMS) upper bounds
    max_source_packets: float
    top_link_src: np.ndarray       # descending-estimate heavy hitters
    top_link_dst: np.ndarray
    top_link_packets: np.ndarray
    n_top_links: int
    top_talker_src: np.ndarray
    top_talker_packets: np.ndarray
    n_top_talkers: int
    bounds: Dict[str, float]
    overflow: int = 0


def snapshot_sketch(state: SketchState, k: Optional[int] = None,
                    hll_sigma: float = 4.0) -> SketchSnapshot:
    """Answer the sketch-tier query suite from the accumulated state."""
    k = state.heavy_capacity if k is None else min(k, state.heavy_capacity)
    scalars = sketch_scalars(state)
    hl_src, hl_dst, hl_est, hl_n = heavy_links(state)
    hs_key, hs_est, hs_n = heavy_talkers(state)
    host = lambda t: t.cpu().numpy()
    return SketchSnapshot(
        n_packets=int(state.n_packets),
        n_batches=int(state.n_batches),
        unique_sources=float(scalars["n_unique_sources"]),
        unique_destinations=float(scalars["n_unique_destinations"]),
        unique_links=float(scalars["unique_links"]),
        max_link_packets=float(scalars["max_link_packets"]),
        max_source_packets=float(scalars["max_source_packets"]),
        top_link_src=host(hl_src)[:k],
        top_link_dst=host(hl_dst)[:k],
        top_link_packets=host(hl_est)[:k],
        n_top_links=min(int(hl_n), k),
        top_talker_src=host(hs_key)[:k],
        top_talker_packets=host(hs_est)[:k],
        n_top_talkers=min(int(hs_n), k),
        bounds=error_bounds(state, hll_sigma=hll_sigma),
    )
