"""Overlapped window staging: a double-buffered input pipeline on a copy
stream.

Port of deepspeed_tpu/runtime/staging.py. While accumulation window N
computes on the card, a background worker pulls window N+1's
``accum`` micro-batches from the data source, copies them into pinned
host slots and issues their host-to-device copies (``non_blocking``) on a
dedicated ``torch.cuda.Stream``, then records an event. The consumer
makes the compute stream wait on that event (:meth:`StagedWindow.wait`)
before it reads the window, so the pull, the host copy and the transfer
leave the critical path. On the CPU (the caller asked for it) placement
is the identity and the worker only pulls ahead.

Two rules of the copy stream:

- a pinned slot is refilled only after its last copy has finished: the
  worker waits on the slot's event before it writes the slot again;
- the window's device tensors are allocated on the copy stream and read
  on the compute stream, so :meth:`StagedWindow.wait` marks them
  (``record_stream``); the caching allocator then keeps their memory
  until the compute stream's work on them is done.

Determinism contract, as in the JAX package: the stager owns the engine's
dropout-seed chain while it is attached. Window N+1's per-micro-step
seeds are drawn at staging time from the stager's copy of the engine's
generator, in exactly the order the unstaged path draws them at forward
time, and the generator's state after the draw rides each window back to
the engine, which adopts it when it consumes the window. Staged and
unstaged runs therefore give the same seeds, losses and parameters bit
for bit, and leave the generator in the same state.

Shutdown contract: ``close()`` stops the worker (bounded waits only),
drops staged-but-unconsumed windows and joins the thread. Windows pulled
from the source but never consumed are dropped; for the preemption drain
that is right, because the restart replays the data order from the
checkpointed step.
"""

import queue
import threading
import time

import torch

from ..utils.device import resolve_device
from ..utils.logging import logger


def ragged_window_error(collected, accum):
    """The one place the mid-window-dry message is built: the unstaged
    ``train_batch`` loop and the stager raise the identical error."""
    err = RuntimeError(
        f"data iterator ran dry mid-window: collected {collected} of "
        f"gradient_accumulation_steps={accum} micro-batches. Size the "
        "dataset/loader so full accumulation windows divide it (the "
        "loader's drop_last does this), or stop at the previous window "
        "boundary."
    )
    # data exhaustion is the caller's sizing bug, not a transient fault:
    # the run supervisor must surface it, not roll back and re-train old
    # windows until its budget drains (resilience/supervisor.py)
    err.ds_unrecoverable = True
    return err


def _leaves(tree):
    """The tensor-like leaves of nested tuples/lists, in order."""
    if isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in order."""
    if isinstance(tree, (tuple, list)):
        return tuple(_rebuild(x, it) for x in tree)
    return next(it)


class _End:
    """Sentinel: the source raised StopIteration at a window boundary."""


class _Failure:
    """Sentinel: staging failed; the consumer re-raises ``exc``."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class StagedWindow:
    """One staged accumulation window: ``arrays`` (its micro-batches, each
    a tuple), ``keys`` (the micro-steps' dropout seeds, or None),
    ``rng_after`` (the seed generator's state after the draw), and the
    copy's ``event`` (None on the CPU)."""

    __slots__ = (
        "arrays", "keys", "rng_after", "stage_ms", "nbytes", "placed",
        "event",
    )

    def __init__(self, arrays, keys, rng_after, stage_ms, nbytes, placed,
                 event=None):
        self.arrays = arrays
        self.keys = keys
        self.rng_after = rng_after
        self.stage_ms = stage_ms
        self.nbytes = nbytes
        self.placed = placed
        self.event = event

    def wait(self):
        """Make the calling thread's current stream wait for the window's
        copy, and mark its tensors as used there (``record_stream``)."""
        if self.event is None:
            return
        stream = torch.cuda.current_stream()
        stream.wait_event(self.event)
        for t in _leaves(self.arrays):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)
        self.event = None


class WindowStager:
    """Background worker staging ``accum``-micro-batch windows from an
    iterator onto ``device``, ``buffers`` windows deep.

    Parameters
    ----------
    source: iterator yielding micro-batches (tuples, or bare arrays that
        are 1-tuple-wrapped). Pulled only from the worker thread.
    accum: micro-batches per window.
    device: where the windows go, the card unless the caller passes
        ``"cpu"``; a CUDA device copies through pinned slots on a copy
        stream, the CPU keeps them in place.
    rng / split_fn: optional seed plumbing; ``split_fn(rng, accum)``
        returns ``(rng, keys)`` and draws exactly what the unstaged path
        draws (see the module docstring). ``rng`` is the stager's own
        ``torch.Generator``. Without it the windows carry ``keys=None``.
    buffers: max staged-but-unconsumed windows (2 = double buffering),
        and the number of pinned slots.
    stage_to_device: copy on the worker; False defers the copy to the
        consuming thread (the pull still overlaps).
    telemetry: the engine's Telemetry facade (or any object with the
        observe/set/count hooks; absent hooks are skipped).
    fault_fn: ``fault_fn(site)``, the fault-injection hook: called with
        ``"staging.worker"`` once per window on the worker thread, and with
        ``"staging.device_put"`` at each window's placement, on the thread
        that places it.
    """

    def __init__(self, source, accum, device=None, rng=None, split_fn=None,
                 buffers=2, stage_to_device=True, telemetry=None,
                 name="train_batch", fault_fn=None):
        if accum < 1:
            raise ValueError(f"accum must be >= 1, got {accum}")
        if buffers < 1:
            raise ValueError(f"staging_buffers must be >= 1, got {buffers}")
        self._source = source
        self._accum = int(accum)
        # micro-batches pulled from the source, windows handed over: their
        # difference at close is the data a torn-down stream discards
        self.pulled_micro_batches = 0
        self.windows_served = 0
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._rng = rng
        self._split_fn = split_fn
        self._stage_to_device = bool(stage_to_device)
        self._telemetry = telemetry
        self._fault_fn = fault_fn
        self._buffers = int(buffers)
        # the copy stream, the pinned slots and each slot's last copy
        self._copy_stream = (torch.cuda.Stream(device=self._device)
                             if self._cuda else None)
        self._pinned = [None] * self._buffers
        self._slot_events = [None] * self._buffers
        self._placed_windows = 0
        self._stop = threading.Event()
        self._closed = False
        # slots bound the staged-but-unconsumed windows to ``buffers``: the
        # worker takes one before it pulls, the consumer gives it back
        self._slots = threading.Semaphore(self._buffers)
        self._queue = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"ds-window-stager-{name}"
        )
        self._thread.start()

    def _tel(self, method, *args):
        fn = getattr(self._telemetry, method, None)
        if fn is not None:
            try:
                fn(*args)
            except Exception:  # telemetry must never kill the pipeline
                logger.exception("window-stager telemetry hook failed")

    # -- placement ------------------------------------------------------
    def _place(self, batches):
        """The window's micro-batches on the device: ``(arrays, event,
        nbytes)``. On CUDA each leaf goes into the next pinned slot (after
        that slot's last copy finished), then to the card on the copy
        stream, and an event marks the copy."""
        if self._fault_fn is not None:
            self._fault_fn("staging.device_put")
        leaves = [x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
                  for x in _leaves(batches)]
        if not self._cuda:
            leaves = [t.detach().cpu() for t in leaves]
            nbytes = sum(t.numel() * t.element_size() for t in leaves)
            return _rebuild(batches, iter(leaves)), None, nbytes
        # leaves already on the card stay where they are
        moved = [i for i, t in enumerate(leaves) if t.device != self._device]
        host = [leaves[i].detach().cpu() for i in moved]
        nbytes = sum(t.numel() * t.element_size() for t in host)
        k = self._placed_windows % self._buffers
        self._placed_windows += 1
        if self._slot_events[k] is not None:
            # the slot's last host-to-device copy must be done before the
            # slot is written again
            self._slot_events[k].synchronize()
        slot = self._pinned[k]
        if slot is None or [(t.shape, t.dtype) for t in slot] != [
                (t.shape, t.dtype) for t in host]:
            slot = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in host]
            self._pinned[k] = slot
        for dst, src in zip(slot, host):
            dst.copy_(src)
        with torch.cuda.stream(self._copy_stream):
            for i, src in zip(moved, slot):
                leaves[i] = src.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._slot_events[k] = event
        return _rebuild(batches, iter(leaves)), event, nbytes

    # -- worker ---------------------------------------------------------
    def _run(self):
        if self._cuda:
            # the worker thread's CUDA calls go to the engine's device
            torch.cuda.set_device(self._device)
        while not self._stop.is_set():
            if not self._slots.acquire(timeout=0.1):
                continue
            if self._stop.is_set():
                return
            t0 = time.monotonic()
            batches = []
            try:
                if self._fault_fn is not None:
                    self._fault_fn("staging.worker")
                try:
                    for _ in range(self._accum):
                        # re-checked between pulls: a close() mid-window
                        # must not keep draining the live iterator
                        if self._stop.is_set():
                            return
                        batch = next(self._source)
                        self.pulled_micro_batches += 1
                        if not isinstance(batch, (tuple, list)):
                            batch = (batch,)
                        batches.append(tuple(batch))
                except StopIteration:
                    if batches:
                        self._queue.put(_Failure(
                            ragged_window_error(len(batches), self._accum)
                        ))
                    else:
                        self._queue.put(_End)
                    return
                if self._stop.is_set():  # closed while pulling: drop
                    return
                keys = rng_after = None
                if self._rng is not None and self._split_fn is not None:
                    self._rng, keys = self._split_fn(self._rng, self._accum)
                    rng_after = self._rng.get_state()
                arrays, event, nbytes = batches, None, 0
                if self._stage_to_device:
                    arrays, event, nbytes = self._place(batches)
                    self._tel("count_h2d_bytes", nbytes)
                window = StagedWindow(
                    arrays=arrays, keys=keys, rng_after=rng_after,
                    stage_ms=(time.monotonic() - t0) * 1000.0,
                    nbytes=nbytes, placed=self._stage_to_device, event=event,
                )
            except Exception as exc:  # surfaced at get_window, not lost
                self._queue.put(_Failure(exc))
                return
            if self._stop.is_set():
                # closed while staging: drop the window (its device
                # memory frees now)
                return
            self._queue.put(window)
            self._tel("observe_staging_time", window.stage_ms)
            self._tel("set_staging_occupancy", self._queue.qsize())

    # -- consumer -------------------------------------------------------
    def get_window(self, timeout=60.0):
        """Next staged window; blocks until one is ready.

        Raises StopIteration when the source is cleanly exhausted (and
        closes the stager), re-raises staging failures (the ragged final
        window's RuntimeError included), and detects a dead worker
        instead of hanging: each wait is bounded by ``timeout``, and a
        worker that is gone with nothing queued raises."""
        t0 = time.monotonic()
        while True:
            try:
                item = self._queue.get(timeout=timeout)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.qsize() == 0:
                    raise RuntimeError(
                        "window-staging worker died without signalling "
                        "end-of-stream"
                    ) from None
                # a slow source is not an error while the worker lives
        wait_ms = (time.monotonic() - t0) * 1000.0
        if item is _End:
            self.close()
            raise StopIteration
        if isinstance(item, _Failure):
            self.close()
            raise item.exc
        self._slots.release()
        self.windows_served += 1
        self._tel("observe_staging_wait", wait_ms)
        self._tel("set_staging_occupancy", self._queue.qsize())
        if not item.placed:
            item.arrays, item.event, item.nbytes = self._place(item.arrays)
            item.placed = True
            self._tel("count_h2d_bytes", item.nbytes)
        return item

    def occupancy(self):
        return self._queue.qsize()

    def unconsumed_micro_batches(self):
        """Micro-batches pulled from the source but never handed to the
        consumer: what a close() now would discard."""
        return max(
            0, self.pulled_micro_batches - self.windows_served * self._accum
        )

    def alive(self):
        return self._thread.is_alive()

    @property
    def closed(self):
        return self._closed

    def close(self, timeout=5.0):
        """Stop the worker, drop staged-but-unconsumed windows and join
        the thread (at most ``timeout`` seconds). Idempotent; safe from the
        preemption drain."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # unblock a worker parked on a slot (the extra permit is harmless:
        # the stop flag is re-checked after every acquire)
        self._slots.release()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():  # pragma: no cover - defensive
                logger.warning(
                    "window-stager thread did not stop within %.1fs "
                    "(daemon; it cannot block process exit)", timeout,
                )
        self._tel("set_staging_occupancy", 0)
