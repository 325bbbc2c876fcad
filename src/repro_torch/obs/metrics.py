"""Process-global metrics registry: counters, gauges, fixed-bucket histograms
— the port's copy of ``repro/obs/metrics.py``.

The stream/serve layers accumulated health state in half a dozen ad-hoc
places — ``IngestHealth`` tallies, ``StreamSnapshot.overflow``,
checkpoint/restore walls on ``ServiceReport``, degradation transitions —
each with its own printing and JSON spelling.  This module gives them one
home with Prometheus-shaped semantics:

* :class:`Counter` — monotonically increasing (``*_total`` naming).
* :class:`Gauge` — last-write-wins level (links, ips, overflow, tier).
* :class:`Histogram` — **fixed buckets**, so p50/p99 are computable from
  ~30 integers without ever storing samples: ``quantile(q)`` walks the
  cumulative bucket counts and linearly interpolates inside the landing
  bucket, exactly the ``histogram_quantile`` estimator Prometheus uses.
  Default bounds are exponential from 10µs to 60s — right for both a
  ~100µs micro-batch fold and a multi-second restore.

Everything lives in a :class:`MetricsRegistry`; the process-global one
(:func:`get_registry`) is what the wired layers use, and
:func:`reset_registry` gives tests/serve a clean slate.  Export paths:
``as_dict()`` (BENCH JSON), ``to_jsonl_records()`` (the same
schema-versioned record stream as ``obs.trace``), ``to_prometheus()``
(text exposition format, dumped by serve on SIGUSR1/exit).

Stdlib only; thread-safe via one registry-wide lock (these are host-side
bookkeeping updates, never on the device).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .trace import SCHEMA_VERSION, run_context

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "reset_registry",
    "DEFAULT_LATENCY_BUCKETS",
]

Number = Union[int, float]


def _exp_buckets(lo: float, hi: float, per_decade: int) -> Tuple[float, ...]:
    out: List[float] = []
    v = lo
    ratio = 10.0 ** (1.0 / per_decade)
    while v < hi * (1.0 + 1e-12):
        out.append(v)
        v *= ratio
    return tuple(out)


# 10µs .. 60s, 4 buckets per decade: 28 bounds — fine-grained enough that
# linear interpolation inside one bucket bounds the quantile error at
# ~78% of the bucket width (10^(1/4)), coarse enough to ship as a JSON row.
DEFAULT_LATENCY_BUCKETS = _exp_buckets(1e-5, 60.0, 4)


class Counter:
    """Monotonically increasing count.  Name convention: ``*_total``."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", lock: Optional[threading.Lock] = None):
        self.name = name
        self.help = help
        self._lock = lock or threading.Lock()
        self._value: float = 0

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        with self._lock:
            return self._value

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins level."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", lock: Optional[threading.Lock] = None):
        self.name = name
        self.help = help
        self._lock = lock or threading.Lock()
        self._value: float = 0

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: Number = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> Number:
        with self._lock:
            return self._value

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Fixed-bucket histogram with Prometheus-style interpolated quantiles.

    ``buckets`` are the inclusive upper bounds of each bucket; observations
    above the last bound land in the implicit +Inf bucket.  State is just
    ``len(buckets)+1`` counts plus a running sum — p50/p99 never require
    the samples themselves.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                 lock: Optional[threading.Lock] = None):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be sorted, non-empty")
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._lock = lock or threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf bucket
        self._sum: float = 0.0
        self._count: int = 0

    def observe(self, v: Number) -> None:
        v = float(v)
        # binary search for the first bound >= v
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.buckets[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        with self._lock:
            self._counts[lo] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0 <= q <= 1) from bucket counts.

        Prometheus ``histogram_quantile`` semantics: find the bucket where
        the cumulative count crosses ``q * total`` and interpolate linearly
        between its lower and upper bound (the first bucket's lower bound
        is 0; a crossing in the +Inf bucket returns the last finite bound).
        Returns NaN when empty.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return float("nan")
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank:
                if i >= len(self.buckets):       # +Inf bucket
                    return self.buckets[-1]
                lower = self.buckets[i - 1] if i > 0 else 0.0
                upper = self.buckets[i]
                if c == 0:
                    return upper
                return lower + (upper - lower) * (rank - prev_cum) / c
        return self.buckets[-1]

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        return {
            "kind": self.kind,
            "count": n,
            "sum": s,
            "buckets": list(self.buckets),
            "bucket_counts": counts,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Flat namespace of metrics; one per process via :func:`get_registry`.

    The ``counter``/``gauge``/``histogram`` methods are get-or-create, so
    call sites never coordinate registration order — but re-registering a
    name as a different kind is a bug and raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- export --------------------------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.as_dict() for name, m in sorted(metrics.items())}

    def to_jsonl_records(self) -> List[Dict[str, Any]]:
        """One schema-versioned ``kind="metric"`` record per metric —
        the same record stream shape as ``obs.trace`` spans, so a single
        JSONL file can interleave both."""
        now = time.time()
        ctx = run_context()
        recs = []
        for name, d in self.as_dict().items():
            recs.append({
                "schema_version": SCHEMA_VERSION,
                "kind": "metric",
                "name": name,
                "t_wall": now,
                "metric": d,
                "git_sha": ctx["git_sha"],
                "device": ctx["device"],
                "torch_version": ctx["torch_version"],
            })
        return recs

    def to_prometheus(self) -> str:
        """Text exposition format (the ``# TYPE``/``_bucket`` dialect)."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{name} {m.value}")
            else:
                d = m.as_dict()
                cum = 0
                for bound, c in zip(d["buckets"], d["bucket_counts"]):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{bound}"}} {cum}')
                cum += d["bucket_counts"][-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{name}_sum {d['sum']}")
                lines.append(f"{name}_count {d['count']}")
        return "\n".join(lines) + "\n"


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL


def reset_registry() -> MetricsRegistry:
    """Fresh registry (tests and serve entrypoints start clean)."""
    global _GLOBAL
    _GLOBAL = MetricsRegistry()
    return _GLOBAL
