"""Host batches — the port's copies of ``Prefetcher``, ``lm_batches`` and
``recsys_batches`` from ``repro/data/pipeline.py``, and ``PinnedStager``,
which carries them to the card.

A ``Prefetcher``'s producer thread keeps ``depth`` batches ahead of the
consumer, so host reads overlap device work; a producer's exception is
re-raised in the consumer on its next ``__next__``.  ``lm_batches`` is the
deterministic synthetic LM stream and ``recsys_batches`` the synthetic CTR
stream, each bit-equal to the reference's for every ``(seed, step,
shard)``.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PinnedStager", "Prefetcher", "lm_batches", "recsys_batches"]


class PinnedStager:
    """Host batches to ``device`` through two pinned host buffers that take
    turns, each copied with ``non_blocking=True``: the host fills batch i+1
    while the card still reads batch i, and no copy waits for the host.

    ``take(shapes)`` returns the next slot's buffers by name, as numpy
    arrays for the host to fill, once the copy that last read that slot is
    done (the event recorded after it); ``send()`` queues their copies to
    the device, records that event and returns the device tensors.  Off
    the card the buffers are plain host memory and ``send`` returns them
    (``Tensor.to`` of a tensor already there), to be used before the slot
    comes round again.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._buffers: List[Dict[str, torch.Tensor]] = [{}, {}]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._slot = 0
        self._names: Sequence[str] = ()

    def take(self, shapes: Dict[str, Tuple[Tuple[int, ...], np.dtype]]
             ) -> Dict[str, np.ndarray]:
        if self._copied[self._slot] is not None:
            self._copied[self._slot].synchronize()  # the copy that read it is done
        buffers = self._buffers[self._slot]
        for name, (shape, dtype) in shapes.items():
            buf = buffers.get(name)
            if (buf is None or buf.shape != tuple(shape)
                    or buf.numpy().dtype != np.dtype(dtype)):
                buf = torch.from_numpy(np.empty(shape, dtype))
                buffers[name] = buf.pin_memory() if self._pin else buf
        self._names = list(shapes)
        return {name: buffers[name].numpy() for name in self._names}

    def send(self, wait: bool = False) -> Dict[str, torch.Tensor]:
        """The taken buffers on the device; ``wait=True`` waits for the
        copies (to time them alone)."""
        slot, self._slot = self._slot, self._slot ^ 1
        buffers = self._buffers[slot]
        out = {name: buffers[name].to(self.device, non_blocking=True)
               for name in self._names}
        if self._pin:
            self._copied[slot] = torch.cuda.Event()
            self._copied[slot].record()
            if wait:
                self._copied[slot].synchronize()
        return out


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


def lm_batches(
    batch: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
    shard_id: int = 0,
    n_shards: int = 1,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic LM stream: batch(step, shard) is reproducible.

    Tokens follow a Zipfian marginal (realistic softmax pressure) with a
    shifted-copy structure so the LM objective has learnable signal.
    ``n_shards`` is the reference's, which no draw reads.
    """
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step, shard_id))
        z = rng.zipf(1.3, size=(batch, seq_len + 1))
        toks = (z % vocab).astype(np.int32)
        # plant learnable structure: every other token repeats its predecessor
        toks[:, 2::2] = toks[:, 1:-1:2]
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               "step": np.int64(step), "shard": np.int64(shard_id)}
        step += 1


def recsys_batches(
    batch: int,
    n_sparse: int,
    vocab_sizes,
    seed: int = 0,
    shard_id: int = 0,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic CTR stream with a planted logistic teacher (learnable):
    Zipfian ids modulo each field's vocabulary, labels drawn from the
    teacher's probability."""
    vocab_sizes = np.asarray(vocab_sizes, np.int64)
    teacher_rng = np.random.default_rng(seed + 7919)
    field_w = teacher_rng.standard_normal(n_sparse).astype(np.float32)
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step, shard_id))
        ids = (rng.zipf(1.2, size=(batch, n_sparse)) % vocab_sizes[None, :]).astype(np.int32)
        score = ((ids % 97) / 97.0 - 0.5) @ field_w
        labels = (rng.random(batch) < 1 / (1 + np.exp(-score))).astype(np.float32)
        yield {"sparse_ids": ids, "labels": labels, "step": np.int64(step)}
        step += 1
