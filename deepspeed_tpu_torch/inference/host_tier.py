"""Host-memory spill tier: device ↔ host ↔ peer paging for KV prefix
pages and LoRA adapter rows.

Port of deepspeed_tpu/inference/host_tier.py. Device memory is the
cache, host RAM the backing store. A refcount-0 prefix page evicted by
:class:`~deepspeed_tpu_torch.inference.paging.BlockPool`'s LRU — or an
adapter row evicted by :class:`~deepspeed_tpu_torch.adapters.pool.AdapterPool`
— is copied to the host into this tier instead of dropped, keyed by its
content-committed identity (the chain hash for KV pages,
``adapter/<name>`` for adapter rows). A later chain-hash / name hit
promotes it back to the device, so the working set is bounded by
``host_tier.max_bytes`` of host RAM instead of device memory.

Entries are CPU tensors: the engine parks its pages and rows in pinned
memory on CUDA, so the promotion copy can run asynchronously on a copy
stream. Three properties the engine leans on:

* **Integrity over availability.** Every entry carries a sha1 digest of
  its tensors' bytes, in order, computed at spill time and re-verified
  at promotion (the JAX package's digest over the same bytes); a
  mismatch (bit rot, a chaos-armed ``host_tier.copy`` garble) drops the
  entry and reads as a miss — the caller re-prefills from tokens, it
  never serves wrong pages.
* **Asynchronous promotion.** A daemon worker drains a queue under a
  ``Semaphore(buffers)`` bound and runs the injectable ``place_fn`` (the
  engine's: the host-to-device copy on a copy stream, ordered by an
  event the compute stream waits on, as ``runtime/staging.py`` does).
  ``fetch_async`` resolves hit/miss/corrupt *synchronously* (the engine
  decides the promoted chain before allocating device pages) and returns
  a handle whose ``result()`` blocks only on placement.
* **Peer sharing.** :meth:`HostTier.shared` keeps one tier per share
  group per process, so co-hosted engines that opt in
  (``host_tier.peer_sharing``) park into — and promote from — the same
  tier. Entries record their ``origin`` engine so a cross-engine
  promotion counts as a ``peer_fetch``. Tiers are refcounted
  (:meth:`retain` / :meth:`release`): the last engine out closes the
  worker and retires the group.

The default ``place_fn`` is the identity; the clock is injectable, for
LRU-recency tests.
"""

import hashlib
import queue
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..utils.logging import logger


class _Entry:
    __slots__ = ("key", "arrays", "meta", "origin", "nbytes", "digest",
                 "pins", "last_used")

    def __init__(self, key, arrays, meta, origin, nbytes, digest, now):
        self.key = key
        self.arrays = arrays
        self.meta = meta
        self.origin = origin
        self.nbytes = nbytes
        self.digest = digest
        self.pins = 0
        self.last_used = now


def _host_tensor(a):
    """A CPU tensor holding ``a`` (a tensor, or a numpy array, whose
    memory it then shares)."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.from_numpy(np.ascontiguousarray(a))


def _bytes(t):
    """The tensor's raw bytes as a uint8 numpy view (no copy for a
    contiguous tensor)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _digest(arrays):
    h = hashlib.sha1()
    for a in arrays:
        h.update(_bytes(a))
    return h.hexdigest()


class _End:
    pass


class PromotionHandle:
    """One in-flight promotion. ``meta`` / ``origin`` / ``peer`` are
    available immediately (resolved synchronously at fetch);
    :meth:`result` blocks until the worker placed the arrays."""

    def __init__(self, tier, key, meta, origin, peer):
        self._tier = tier
        self.key = key
        self.meta = meta
        self.origin = origin
        self.peer = peer
        self._event = threading.Event()
        self._placed = None
        self._error = None

    def _resolve(self, placed, error):
        self._placed = placed
        self._error = error
        self._event.set()

    def result(self, timeout=30.0):
        """The placed arrays (``place_fn``'s output), or raises the
        placement failure. Either way the entry is unpinned."""
        if not self._event.wait(timeout):
            self._tier._unpin(self.key)
            raise TimeoutError(
                f"host-tier promotion of {self.key!r} timed out"
            )
        self._tier._unpin(self.key)
        if self._error is not None:
            raise self._error
        return self._placed


_SHARED_LOCK = threading.Lock()
_SHARED = {}  # group name -> HostTier


class HostTier:
    """Byte-budgeted host-RAM LRU of spilled device pages/rows."""

    DEFAULT_MAX_BYTES = 1 << 28  # 256 MiB

    def __init__(self, max_bytes=DEFAULT_MAX_BYTES, clock=None,
                 place_fn=None, stage_buffers=2):
        if max_bytes <= 0:
            raise ValueError("host_tier max_bytes must be > 0")
        self.max_bytes = int(max_bytes)
        self._clock = clock if clock is not None else time.monotonic
        self._place_fn = place_fn if place_fn is not None else (
            lambda arrays: arrays
        )
        self._lock = threading.RLock()
        self._entries = OrderedDict()  # key -> _Entry, LRU order
        self._occupancy = 0
        self._refs = 0
        self._group = None  # set by shared()
        # counters (tier-global; engines keep their own per-engine view)
        self.spills = 0
        self.promotions = 0
        self.peer_fetches = 0
        self.evictions = 0
        self.checksum_drops = 0
        # promotion worker: started lazily, Semaphore(stage_buffers)
        # bounds the placements in flight
        self._stage_buffers = int(stage_buffers)
        self._slots = threading.Semaphore(self._stage_buffers)
        self._queue = queue.Queue()
        self._worker = None
        self._closed = False

    # -- peer share-groups ----------------------------------------------
    @classmethod
    def shared(cls, group, max_bytes=DEFAULT_MAX_BYTES, **kwargs):
        """The process-level tier for ``group``, created on first use.
        Later callers get the existing tier regardless of differing
        kwargs (the first engine in wins — co-hosted engines share one
        budget). Pair with :meth:`retain` / :meth:`release`."""
        with _SHARED_LOCK:
            tier = _SHARED.get(group)
            if tier is None:
                tier = cls(max_bytes=max_bytes, **kwargs)
                tier._group = group
                _SHARED[group] = tier
            return tier

    def retain(self):
        with self._lock:
            self._refs += 1
        return self

    def release(self):
        """Drop one engine's reference; the last release closes the
        worker and retires the tier from its share group (so the next
        engine build gets a fresh tier)."""
        with self._lock:
            self._refs = max(0, self._refs - 1)
            last = self._refs == 0
        if last:
            if self._group is not None:
                with _SHARED_LOCK:
                    if _SHARED.get(self._group) is self:
                        del _SHARED[self._group]
            self.close()

    # -- spill (park on the host) ---------------------------------------
    def put(self, key, arrays, meta=None, origin=None, corrupt=False):
        """Park ``arrays`` (CPU tensors or numpy arrays; kept as CPU
        tensors, not copied) under ``key``. Returns True when stored. The
        digest is computed over the *clean* payload; ``corrupt=True`` (the
        chaos hook for the ``host_tier.copy`` garble mode) then flips
        bytes in a copy of the first tensor, so the promotion-time verify
        catches it exactly like real bit rot would."""
        arrays = tuple(_host_tensor(a) for a in arrays)
        nbytes = sum(a.numel() * a.element_size() for a in arrays)
        if nbytes > self.max_bytes:
            return False
        digest = _digest(arrays)
        if corrupt and arrays and arrays[0].numel():
            bad = arrays[0].clone()
            _bytes(bad)[:8] ^= 0xFF
            arrays = (bad,) + arrays[1:]
        with self._lock:
            if self._closed:
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._occupancy -= old.nbytes
            entry = _Entry(key, arrays, dict(meta or {}), origin, nbytes,
                           digest, self._clock())
            self._entries[key] = entry
            self._occupancy += nbytes
            self.spills += 1
            self._evict_to_budget_locked()
        return True

    def _evict_to_budget_locked(self):
        # oldest first, skipping pinned entries (pins are transient:
        # promotions in flight); a fully pinned overflow rides until the
        # pins drop
        while self._occupancy > self.max_bytes:
            victim = None
            for entry in self._entries.values():
                if entry.pins == 0:
                    victim = entry
                    break
            if victim is None:
                return
            del self._entries[victim.key]
            self._occupancy -= victim.nbytes
            self.evictions += 1

    # -- promote ----------------------------------------------------------
    def fetch_async(self, key, requester=None):
        """Resolve ``key`` synchronously — None on a miss or on a digest
        mismatch (the entry is dropped: corrupt data must read as cold,
        never serve) — and enqueue placement on the worker. Returns a
        :class:`PromotionHandle` on a hit."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or self._closed:
                return None
            if _digest(entry.arrays) != entry.digest:
                del self._entries[key]
                self._occupancy -= entry.nbytes
                self.checksum_drops += 1
                logger.warning(
                    "host-tier entry %r failed checksum verification; "
                    "dropped (promotion reads as a cold miss)", key
                )
                return None
            self._entries.move_to_end(key)
            entry.last_used = self._clock()
            entry.pins += 1
            self.promotions += 1
            peer = (entry.origin is not None and requester is not None
                    and entry.origin != requester)
            if peer:
                self.peer_fetches += 1
            handle = PromotionHandle(self, key, dict(entry.meta),
                                     entry.origin, peer)
            arrays = entry.arrays
        self._ensure_worker()
        self._slots.acquire()
        self._queue.put((arrays, handle))
        return handle

    def fetch(self, key, requester=None, timeout=30.0):
        """Synchronous convenience: ``(placed_arrays, meta, origin)`` or
        None."""
        handle = self.fetch_async(key, requester=requester)
        if handle is None:
            return None
        return handle.result(timeout), handle.meta, handle.origin

    def _unpin(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.pins > 0:
                entry.pins -= 1
            self._evict_to_budget_locked()

    def _ensure_worker(self):
        with self._lock:
            if self._worker is None and not self._closed:
                self._worker = threading.Thread(
                    target=self._worker_loop,
                    name="host-tier-stager",
                    daemon=True,
                )
                self._worker.start()

    def _worker_loop(self):
        while True:
            item = self._queue.get()
            if isinstance(item, _End):
                return
            arrays, handle = item
            try:
                placed = self._place_fn(arrays)
                handle._resolve(placed, None)
            except Exception as exc:  # surfaces at handle.result()
                handle._resolve(None, exc)
            finally:
                self._slots.release()

    # -- bookkeeping ----------------------------------------------------
    def contains(self, key):
        with self._lock:
            return key in self._entries

    def discard(self, key):
        """Drop ``key`` if present (explicit unload / stale entry after
        a fresh-weights reload). Returns True when an entry was
        dropped."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self._occupancy -= entry.nbytes
            return True

    def keys(self):
        with self._lock:
            return list(self._entries)

    @property
    def occupancy_bytes(self):
        with self._lock:
            return self._occupancy

    @property
    def entries(self):
        with self._lock:
            return len(self._entries)

    def snapshot(self):
        with self._lock:
            return {
                "occupancy_bytes": self._occupancy,
                "entries": len(self._entries),
                "max_bytes": self.max_bytes,
                "spills": self.spills,
                "promotions": self.promotions,
                "peer_fetches": self.peer_fetches,
                "evictions": self.evictions,
                "checksum_drops": self.checksum_drops,
            }

    def close(self, timeout=5.0):
        """Stop the worker and drop every entry. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            worker = self._worker
        if worker is not None:
            self._queue.put(_End())
            worker.join(timeout)
        with self._lock:
            self._entries.clear()
            self._occupancy = 0
