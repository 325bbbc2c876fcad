"""Background prefetch of host batches — the port's copy of
``Prefetcher`` from ``repro/data/pipeline.py`` (the rest of that module
serves training and is not ported).

A producer thread keeps ``depth`` batches ahead of the consumer, so host
reads overlap device work; a producer's exception is re-raised in the
consumer on its next ``__next__``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

__all__ = ["Prefetcher"]


class Prefetcher:
    """Wrap a batch-producing iterator with a depth-N background thread.

    Error contract (fail fast): if the producer raises, the exception is
    re-raised on the *next* ``__next__`` call — queued-but-unconsumed batches
    are dropped.  The naive design (error sentinel at the queue tail) only
    surfaced the failure after up to ``depth`` already-prefetched batches
    drained, so a consumer could keep training on stale data for several
    steps after its input pipeline had already died.  ``_err`` is published
    before the ``_done`` sentinel is enqueued, so once the producer thread
    has failed, every subsequent ``__next__`` raises deterministically.

    Teardown contract (fault paths): ``close()`` is idempotent and safe to
    call from any state — it tells the producer to stop, drains the queue so
    a blocked ``put`` releases, and joins the thread.  Use the context
    manager protocol so a crash in the consumer (a supervised service loop
    aborting mid-stream, a test timing out) can never leak the background
    thread; before ``close()`` existed the only tool was ``join(timeout)``,
    which on a full queue simply timed out and leaked.
    """

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._done = object()
        self._stop = threading.Event()
        self._closed = False

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        break
                    # bounded-wait put so a close() can always interrupt a
                    # producer blocked on a full queue
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.05)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        break
            except BaseException as e:  # surfaced on next() — see class doc
                self._err = e
            finally:
                sent = False
                # Clean exit: block (bounded) so queued batches survive —
                # the consumer is still draining them.
                while self._err is None and not self._stop.is_set():
                    try:
                        self._q.put(self._done, timeout=0.05)
                        sent = True
                        break
                    except queue.Full:
                        continue
                if not sent:
                    # Error or close(): the fail-fast/teardown contract
                    # drops queued items anyway; a blocking put here could
                    # leave this thread stuck forever on a full queue (the
                    # failed consumer never drains it).  Discard queued
                    # items until the sentinel fits.
                    while True:
                        try:
                            self._q.put_nowait(self._done)
                            break
                        except queue.Full:
                            try:
                                self._q.get_nowait()
                            except queue.Empty:
                                pass

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()
        self._exhausted = False

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the producer thread to finish (tests / orderly shutdown)."""
        self._t.join(timeout)

    def close(self) -> None:
        """Stop the producer and join its thread.  Idempotent; never raises
        the producer's pending error (teardown must always succeed)."""
        if self._closed:
            return
        self._closed = True
        self._exhausted = True
        self._stop.set()
        # drain so a producer blocked on put() can reach the stop check
        while self._t.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(0.05)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._err is not None:  # fail fast: don't drain queued items
            raise self._err
        if self._exhausted:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._exhausted = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
