"""Host-side hot paths of the data pipeline, in numpy and threads.

Port of deepspeed_tpu/runtime/host_ops.py: ``flatten``/``unflatten_into``
(bytes of many arrays as one buffer), ``gather_rows`` (row gather for
array datasets), ``shuffled_indices`` (the seeded epoch permutation) and
``make_prefetch_queue`` (a bounded background producer).

Every function here is numpy or a ``queue.Queue`` thread, so the port runs
from a plain source checkout with no extension to build.
``shuffled_indices`` is the data order: a checkpointed run's resume
replays it, so it gives the JAX package's permutation (splitmix64 sort
keys) for every ``n`` and seed, negative seeds included.
"""

import logging
import queue
import threading
import time

import numpy as np


def flatten(arrays):
    """Concatenate array bytes into one 1-D uint8 numpy array."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if not arrays:
        return np.empty((0,), np.uint8)
    return np.concatenate([a.view(np.uint8).reshape(-1) for a in arrays])


def unflatten_into(flat, arrays):
    """Scatter ``flat`` bytes back into the (writable, C-contiguous)
    arrays in order."""
    flat = np.ascontiguousarray(flat).view(np.uint8).reshape(-1)
    off = 0
    for a in arrays:
        n = a.nbytes
        a.view(np.uint8).reshape(-1)[:] = flat[off : off + n]
        off += n
    if off != flat.nbytes:
        raise ValueError("flat buffer size does not match target buffers")


def gather_rows(src, indices, out=None):
    """out[i] = src[indices[i]] for C-contiguous ``src``."""
    src = np.ascontiguousarray(src)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if out is None:
        out = np.empty((indices.shape[0],) + src.shape[1:], src.dtype)
    np.take(src, indices, axis=0, out=out)
    return out


def _splitmix64(x):
    """Vectorized splitmix64 over uint64 arrays (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def shuffled_indices(n, seed):
    """Deterministic permutation of range(n): per-index splitmix64 sort
    keys, the seed wrapped to 64 bits: the JAX package's permutation."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    s0 = _splitmix64(np.asarray(seed, np.uint64))
    keys = _splitmix64(s0 ^ _splitmix64(np.arange(n, dtype=np.uint64)))
    return np.argsort(keys, kind="stable").astype(np.int64)


class _PrefetchQueue:
    """A bounded queue filled by a producer thread."""

    def __init__(self, producer, capacity=4):
        self._q = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._sentinel = object()
        self._producer_error = None

        def run():
            while not self._stop.is_set():
                try:
                    item = producer()
                except StopIteration:
                    self._put(self._sentinel)
                    return
                except Exception as exc:  # surface from get(), don't swallow
                    logging.getLogger("DeepSpeed").exception(
                        "prefetch producer raised; stream terminated"
                    )
                    self._producer_error = exc
                    self._put(self._sentinel)
                    return
                self._put(item)

        self._thread = threading.Thread(
            target=run, daemon=True, name="ds-prefetch")
        self._thread.start()

    def _put(self, item):
        # bounded waits, so that stop() can always end the thread
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def get(self, timeout=60.0):
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("PrefetchQueue.get timed out") from None
        if item is self._sentinel:
            if self._producer_error is not None:
                raise self._producer_error
            raise StopIteration("producer exhausted")
        return item

    def alive(self):
        """True while the producer thread runs (a consumer tells a slow
        producer from a dead one with it)."""
        return self._thread.is_alive()

    def qsize(self):
        return self._q.qsize()

    def stop(self):
        """Stop the producer and join it, for at most a second: a producer
        stuck in a slow ``__getitem__`` is a daemon thread and leaks
        nothing past the process."""
        self._stop.set()
        deadline = time.monotonic() + 1.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


def make_prefetch_queue(producer, capacity=4):
    """Bounded background prefetcher: calls ``producer()`` from a worker
    thread until StopIteration."""
    return _PrefetchQueue(producer, capacity)
