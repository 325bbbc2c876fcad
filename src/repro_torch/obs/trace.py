"""Structured spans — the port's copy of ``repro/obs/trace.py``.

A :class:`Span` is one timed region: nestable (a thread-local stack tracks
the parent), exception-safe (the record is emitted even when the body
raises, with the error noted), and carrying both clocks — ``time.time()``
for correlation across processes and ``time.perf_counter()`` for durations.
Records land in a bounded in-memory ring and, optionally, stream through a
per-tracer ``sink`` callable as they close.  Every exported record is
schema-versioned and stamped with the run context.  The reference's counter
events are not copied: nothing in the port uses them yet.

The one change from the reference: :func:`run_context` stamps the torch
version, the CUDA version torch was built with and the device name in place
of JAX's backend and version.  The span clock does not synchronize the
device; callers that time device work end the span after
``torch.cuda.synchronize()`` (``challenge/pipeline.py`` does).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, IO, Iterable, List, Optional, Union

__all__ = [
    "SCHEMA_VERSION",
    "Span",
    "Tracer",
    "get_tracer",
    "reset_tracer",
    "span",
    "run_context",
    "export_jsonl",
    "read_jsonl",
]

SCHEMA_VERSION = 1

_JSON_SCALARS = (str, int, float, bool, type(None))


def _jsonable(v: Any) -> Any:
    """Coerce one attribute value to something ``json.dumps`` accepts:
    0-d tensors/arrays become Python numbers, small 1-d ones lists,
    anything else its ``repr``."""
    if isinstance(v, _JSON_SCALARS):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    item = getattr(v, "item", None)
    shape = getattr(v, "shape", None)
    if item is not None and shape is not None:
        if len(shape) == 0:
            return item()
        if len(shape) == 1 and shape[0] <= 64:
            return [_jsonable(x) for x in v.tolist()]
    return repr(v)


_RUN_CONTEXT: Optional[Dict[str, Any]] = None


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def run_context(refresh: bool = False) -> Dict[str, Any]:
    """The per-process provenance stamp every exported record carries.

    Computed once and cached.  ``device`` is the name of CUDA device 0, or
    ``"cpu"`` where torch sees no card.
    """
    global _RUN_CONTEXT
    if _RUN_CONTEXT is None or refresh:
        import torch

        cuda = torch.cuda.is_available()
        _RUN_CONTEXT = {
            "git_sha": _git_sha(),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": torch.cuda.get_device_name(0) if cuda else "cpu",
            "python": sys.version.split()[0],
            "pid": os.getpid(),
        }
    return dict(_RUN_CONTEXT)


@dataclasses.dataclass
class Span:
    """One timed region.  Live while open; frozen into a record on close."""

    name: str
    attrs: Dict[str, Any]
    t_wall: float            # epoch seconds at open (time.time)
    t_mono: float            # monotonic seconds at open (perf_counter)
    parent: Optional[str]    # dotted ancestor path, None at top level
    depth: int
    seq: int                 # per-tracer monotonically increasing id
    duration_s: Optional[float] = None   # set on close
    error: Optional[str] = None          # exception type name, if any

    @property
    def path(self) -> str:
        return f"{self.parent}/{self.name}" if self.parent else self.name

    def record(self) -> Dict[str, Any]:
        return {
            "schema_version": SCHEMA_VERSION,
            "kind": "span",
            "name": self.name,
            "path": self.path,
            "seq": self.seq,
            "t_wall": self.t_wall,
            "t_mono": self.t_mono,
            "duration_s": self.duration_s,
            "parent": self.parent,
            "depth": self.depth,
            "error": self.error,
            "attrs": {k: _jsonable(v) for k, v in self.attrs.items()},
        }


class Tracer:
    """A bounded ring of closed span records + the open-span stack.

    The stack is thread-local, the ring is shared and lock-guarded.
    ``sink``, when set, receives each record dict as it is emitted.
    """

    def __init__(self, capacity: int = 4096,
                 sink: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.capacity = capacity
        self.sink = sink
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seq = 0

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _emit(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(rec)
        if self.sink is not None:
            try:
                self.sink(rec)
            except Exception:
                pass  # a broken sink must never take down the traced program

    def span(self, name: str, **attrs: Any) -> "_SpanContext":
        return _SpanContext(self, name, attrs)

    def open_span(self, name: str, attrs: Dict[str, Any]) -> Span:
        st = self._stack()
        with self._lock:
            seq = self._seq
            self._seq += 1
        sp = Span(
            name=name, attrs=dict(attrs),
            t_wall=time.time(), t_mono=time.perf_counter(),
            parent=st[-1].path if st else None, depth=len(st), seq=seq,
        )
        st.append(sp)
        return sp

    def close_span(self, sp: Span, exc: Optional[BaseException] = None) -> Span:
        sp.duration_s = time.perf_counter() - sp.t_mono
        if exc is not None:
            sp.error = type(exc).__name__
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:          # closed out of order: drop the suffix
            del st[st.index(sp):]
        self._emit(sp.record())
        return sp

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


class _SpanContext:
    """Context manager handed out by :meth:`Tracer.span`."""

    def __init__(self, tracer: Tracer, name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self.span: Optional[Span] = None

    def __enter__(self) -> Span:
        self.span = self._tracer.open_span(self._name, self._attrs)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer.close_span(self.span, exc)
        return False  # never swallow


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


def reset_tracer(capacity: int = 4096,
                 sink: Optional[Callable[[Dict[str, Any]], None]] = None
                 ) -> Tracer:
    """Replace the global tracer (tests; serve's ``--metrics-out`` sink)."""
    global _GLOBAL
    _GLOBAL = Tracer(capacity=capacity, sink=sink)
    return _GLOBAL


def span(name: str, **attrs: Any) -> _SpanContext:
    """``with span("analyze", n=n) as sp: ...`` on the global tracer."""
    return _GLOBAL.span(name, **attrs)


def export_jsonl(
    out: Union[str, IO[str]],
    records: Optional[Iterable[Dict[str, Any]]] = None,
    *,
    append: bool = False,
) -> int:
    """Write records (default: the global tracer's ring) as JSONL.

    The first line is a ``kind="run"`` header carrying the full
    :func:`run_context`; every following line is one span/counter record
    re-stamped with the git sha, torch version and device.  Returns the
    number of lines written.
    """
    ctx = run_context()
    if records is None:
        records = _GLOBAL.records()
    header = {"schema_version": SCHEMA_VERSION, "kind": "run",
              "t_wall": time.time(), **ctx}
    lines = [header]
    for rec in records:
        lines.append({**rec, "git_sha": ctx["git_sha"],
                      "torch_version": ctx["torch_version"],
                      "device": ctx["device"]})
    text = "".join(json.dumps(ln, sort_keys=True) + "\n" for ln in lines)
    if isinstance(out, str):
        with open(out, "a" if append else "w") as f:
            f.write(text)
    else:
        out.write(text)
    return len(lines)


def read_jsonl(path_or_text: str) -> List[Dict[str, Any]]:
    """Parse a JSONL export (a path, or the raw text itself)."""
    if "\n" not in path_or_text and os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    return [json.loads(line) for line in text.splitlines() if line.strip()]
