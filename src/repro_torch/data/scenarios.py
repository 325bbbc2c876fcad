"""Seeded adversarial traffic scenarios beyond RMAT — the port's copy of
``repro/data/scenarios.py`` (NumPy only, on the port's ``data/rmat``).

:mod:`repro_torch.data.rmat` models *background* traffic — stationary power-law
endpoints.  Network sensing is about what breaks stationarity: attacks and
rhythms.  Each generator here produces a packet table with the exact
``synthetic_packets`` schema (``ts`` uint64, ``src``/``dst`` uint32,
``length`` uint16, optional ``sport``/``dport`` uint16 + ``proto`` uint8)
so everything downstream — capture ingest, the streaming engine, both
analytics tiers — runs unchanged.  All randomness flows from a single
``np.random.default_rng(seed)`` per call: same arguments, bit-identical
table, the reference's table column for column.

Scenarios and the signal each one plants:

  * :func:`ddos_fanin` — many spoofed sources flood one victim; the victim's
    in-degree and packet share dominate.  The adversarial case for the
    exact tier's capacity (unbounded distinct sources) and the easy case
    for the sketch tier (one heavy destination).
  * :func:`port_scan` — one scanner sweeps ports/hosts at low per-flow
    volume; a fan-*out* spike with near-unique destination ports.
  * :func:`botnet_beacon` — a small botnet phones home on a fixed period
    with jitter; low rate, high regularity (inter-arrival periodicity).
  * :func:`diurnal` — sinusoidal day/night load over background traffic;
    the time-window mass profile, not the endpoint histogram, carries it.

Every generator mixes its foreground over an RMAT background at a
configurable ratio, so detectors are tested against the power-law noise
floor rather than a clean signal.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .rmat import rmat_edges

__all__ = [
    "SCENARIOS",
    "ddos_fanin",
    "port_scan",
    "botnet_beacon",
    "diurnal",
    "scenario_packets",
]


def _finish(
    rng: np.random.Generator,
    ts: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    with_ports: bool,
    sport: Optional[np.ndarray] = None,
    dport: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Assemble the packet table: sort by timestamp, attach ports/sizes.

    Sorting makes the interleave of foreground and background a genuine
    arrival stream (argsort is stable, so equal timestamps keep generation
    order — determinism survives ties).
    """
    order = np.argsort(ts, kind="stable")
    n = len(ts)
    cols = {
        "ts": ts[order].astype(np.uint64),
        "src": src[order].astype(np.uint32),
        "dst": dst[order].astype(np.uint32),
        "length": rng.integers(64, 1500, n).astype(np.uint16),
    }
    if with_ports:
        sp = rng.integers(1024, 65535, n).astype(np.uint16) if sport is None \
            else sport[order].astype(np.uint16)
        dp = rng.choice(np.array([53, 80, 443, 8080, 22], np.uint16), n) \
            if dport is None else dport[order].astype(np.uint16)
        cols["sport"] = sp
        cols["dport"] = dp
        cols["proto"] = rng.choice(np.array([6, 17], np.uint8), n)
    return cols


def _background(
    rng: np.random.Generator, n: int, scale: int, horizon: int
) -> tuple:
    """RMAT background: power-law endpoints, uniform arrivals over horizon."""
    src, dst = rmat_edges(scale, n, seed=int(rng.integers(0, 2**31 - 1)))
    ts = np.sort(rng.integers(0, horizon, n).astype(np.uint64))
    return ts, src.astype(np.uint32), dst.astype(np.uint32)


def ddos_fanin(
    n_packets: int,
    scale: int = 14,
    seed: int = 0,
    attack_fraction: float = 0.6,
    n_attackers: Optional[int] = None,
    with_ports: bool = True,
) -> Dict[str, np.ndarray]:
    """DDoS fan-in burst: many (spoofed) sources flood one victim.

    ``attack_fraction`` of packets target a single victim drawn from the
    vertex space, from ``n_attackers`` distinct sources (default: one per
    attack packet — fully spoofed, the worst case for exact per-source
    state).  Attack packets concentrate in the middle third of the time
    horizon (a burst, not a level shift).
    """
    rng = np.random.default_rng(seed)
    n_attack = int(n_packets * attack_fraction)
    n_bg = n_packets - n_attack
    n_nodes = 1 << scale
    horizon = 1000 * n_packets

    victim = int(rng.integers(0, n_nodes))
    if n_attackers is None:
        n_attackers = max(n_attack, 1)
    a_src = rng.integers(0, n_nodes, n_attack).astype(np.uint32) if \
        n_attackers >= n_attack else \
        rng.integers(0, n_nodes, n_attackers)[
            rng.integers(0, n_attackers, n_attack)
        ].astype(np.uint32)
    a_dst = np.full(n_attack, victim, np.uint32)
    a_ts = rng.integers(horizon // 3, 2 * horizon // 3, n_attack).astype(np.uint64)

    b_ts, b_src, b_dst = _background(rng, n_bg, scale, horizon)
    return _finish(
        rng,
        np.concatenate([a_ts, b_ts]),
        np.concatenate([a_src, b_src]),
        np.concatenate([a_dst, b_dst]),
        with_ports,
    )


def port_scan(
    n_packets: int,
    scale: int = 14,
    seed: int = 0,
    scan_fraction: float = 0.3,
    n_targets: int = 256,
    with_ports: bool = True,
) -> Dict[str, np.ndarray]:
    """Port scan: one scanner sweeps ``n_targets`` hosts across the port
    space at one packet per (host, port) probe — a fan-out spike whose
    destination ports are near-unique (sequential sweep)."""
    rng = np.random.default_rng(seed)
    n_scan = int(n_packets * scan_fraction)
    n_bg = n_packets - n_scan
    n_nodes = 1 << scale
    horizon = 1000 * n_packets

    scanner = int(rng.integers(0, n_nodes))
    targets = rng.choice(n_nodes, size=min(n_targets, n_nodes), replace=False)
    s_src = np.full(n_scan, scanner, np.uint32)
    s_dst = targets[np.arange(n_scan) % len(targets)].astype(np.uint32)
    s_dport = (1 + np.arange(n_scan) % 65535).astype(np.uint16)  # sweep
    s_ts = np.sort(rng.integers(0, horizon, n_scan).astype(np.uint64))

    b_ts, b_src, b_dst = _background(rng, n_bg, scale, horizon)
    b_dport = rng.choice(np.array([53, 80, 443, 8080, 22], np.uint16), n_bg)
    return _finish(
        rng,
        np.concatenate([s_ts, b_ts]),
        np.concatenate([s_src, b_src]),
        np.concatenate([s_dst, b_dst]),
        with_ports,
        dport=np.concatenate([s_dport, b_dport]) if with_ports else None,
    )


def botnet_beacon(
    n_packets: int,
    scale: int = 14,
    seed: int = 0,
    n_bots: int = 16,
    period: int = 60_000,
    jitter: float = 0.02,
    with_ports: bool = True,
) -> Dict[str, np.ndarray]:
    """Botnet beaconing: ``n_bots`` compromised hosts phone one C2 server
    every ``period`` ticks with ±``jitter``·period Gaussian slop — low rate
    (drowned in background volume) but metronome-regular inter-arrivals,
    the signature the periodicity test keys on."""
    rng = np.random.default_rng(seed)
    n_nodes = 1 << scale
    horizon = 1000 * n_packets
    # the returned table holds exactly n_packets rows (the size contract
    # shared with synthetic_packets): the beacon schedule is truncated
    # per bot when a small period would overflow it, never the reverse
    if n_packets // n_bots < 2:
        raise ValueError(
            f"n_packets={n_packets} cannot hold the 2-beacon minimum for "
            f"each of n_bots={n_bots} bots; raise n_packets or lower n_bots"
        )
    n_beacons_per_bot = min(max(horizon // period, 2), n_packets // n_bots)
    n_beacon = n_bots * n_beacons_per_bot
    n_bg = n_packets - n_beacon

    c2 = int(rng.integers(0, n_nodes))
    bots = rng.choice(n_nodes, size=n_bots, replace=False).astype(np.uint32)
    phase = rng.integers(0, period, n_bots)
    ticks = np.arange(n_beacons_per_bot, dtype=np.int64) * period
    slop = rng.normal(0.0, jitter * period, (n_bots, n_beacons_per_bot))
    t = np.maximum(phase[:, None] + ticks[None, :] + slop, 0).astype(np.uint64)
    bt_ts = t.reshape(-1)
    bt_src = np.repeat(bots, n_beacons_per_bot)
    bt_dst = np.full(n_beacon, c2, np.uint32)

    b_ts, b_src, b_dst = _background(rng, n_bg, scale, horizon)
    return _finish(
        rng,
        np.concatenate([bt_ts, b_ts]),
        np.concatenate([bt_src, b_src]),
        np.concatenate([bt_dst, b_dst]),
        with_ports,
    )


def diurnal(
    n_packets: int,
    scale: int = 14,
    seed: int = 0,
    n_cycles: float = 2.0,
    depth: float = 0.8,
    with_ports: bool = True,
) -> Dict[str, np.ndarray]:
    """Diurnal load: RMAT endpoints whose arrival *rate* follows
    ``1 + depth·sin`` over ``n_cycles`` day/night cycles — endpoints look
    like plain background; only the time-window mass profile carries the
    rhythm.  Arrival times are drawn by inverse-transform sampling from the
    sinusoidal rate's CDF."""
    rng = np.random.default_rng(seed)
    if not 0.0 <= depth < 1.0:
        raise ValueError("depth must be in [0, 1)")
    horizon = 1000 * n_packets
    src, dst = rmat_edges(scale, n_packets, seed=int(rng.integers(0, 2**31 - 1)))
    # CDF of rate 1 + depth*sin(2*pi*f*t) on a fine grid, inverted at
    # uniform quantiles — exact enough at 4096 knots for the window test
    grid = np.linspace(0.0, 1.0, 4097)
    omega = 2.0 * np.pi * n_cycles
    cdf = grid + depth * (1.0 - np.cos(omega * grid)) / omega
    cdf /= cdf[-1]
    u = rng.random(n_packets)
    ts = (np.interp(u, cdf, grid) * horizon).astype(np.uint64)
    return _finish(rng, ts, src.astype(np.uint32), dst.astype(np.uint32),
                   with_ports)


SCENARIOS = {
    "ddos": ddos_fanin,
    "portscan": port_scan,
    "beacon": botnet_beacon,
    "diurnal": diurnal,
}


def scenario_packets(
    name: str,
    n_packets: int,
    scale: int = 14,
    seed: int = 0,
    with_ports: bool = True,
    **kwargs,
) -> Dict[str, np.ndarray]:
    """Dispatch by scenario name (the CLI/bench entry point)."""
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; choose from {sorted(SCENARIOS)}"
        )
    return SCENARIOS[name](
        n_packets, scale=scale, seed=seed, with_ports=with_ports, **kwargs
    )
