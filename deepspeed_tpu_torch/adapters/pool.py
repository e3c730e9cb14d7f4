"""Host-side adapter pool registry: name -> slot index, refcounts, LRU.

Port of deepspeed_tpu/adapters/pool.py (the module has no device code;
the port keeps its own copy). The device side of multi-tenant LoRA
serving is a dumb slab — per-target ``[layers, n_adapters + 1, ...]``
A/B stacks with row 0 the all-zeros IDENTITY (id 0 = no adapter) —
indexed by per-slot int32 adapter ids. Everything that makes it a
managed POOL lives here, on the host, mirroring the KV ``BlockPool``
discipline (inference/paging.py):

  assignment — pool indices (1..n_slots) handed out from a free list;
               loading a new adapter under pressure evicts the least-
               recently-used IDLE adapter (zero live requests) first.
  refcounts  — every decode slot serving adapter X holds one reference
               for its lifetime (``acquire`` at slot join, ``release``
               at slot free), so an adapter whose weights a live request
               is decoding against can never be evicted under it.
  identity   — index 0 is never assigned: its zero rows make the
               delta exactly zero, the no-adapter path.

Unlike the KV BlockPool (one scheduler thread by contract), this
registry IS touched from several threads — acquire/release on the
scheduler's thread, resolve on submit threads, assign/remove on whatever
thread calls load/unload_adapter — so every method serializes on one
internal lock: an eviction scanning the idle LRU must never interleave
with an acquire that is about to pin the same adapter (that interleaving
would hand a slot another tenant's weights).
"""

import collections
import threading

IDENTITY_ADAPTER = 0  # pool row 0: all-zeros A/B — the no-adapter id


class AdapterPoolFull(RuntimeError):
    """Every pool slot holds an adapter with live requests — nothing is
    evictable, so the load must fail loudly (or wait for traffic)."""

    def __init__(self, n_slots):
        super().__init__(
            f"adapter pool full: all {n_slots} slots hold adapters with "
            "live requests (raise adapters.pool_slots or retry when "
            "traffic drains)"
        )


class AdapterUnavailable(ValueError):
    """The named adapter is not (or no longer) loaded in this engine's
    pool. A ``ValueError`` — a single engine can never serve it — but
    TYPED so a fleet router can fall through to a replica that does hold
    the adapter instead of failing the submission."""


class AdapterPool:
    """``n_slots`` loadable adapters (pool indices 1..n_slots; 0 is the
    identity). Tracks per-adapter live-request counts and an LRU over
    idle adapters for eviction under load pressure."""

    def __init__(self, n_slots):
        if int(n_slots) < 1:
            raise ValueError(
                f"AdapterPool needs >= 1 loadable slot, got {n_slots}"
            )
        self.n_slots = int(n_slots)
        self._lock = threading.Lock()
        self._free = collections.deque(range(1, self.n_slots + 1))
        self._index = {}       # name -> pool index
        self._active = {}      # name -> live decode-slot references
        self._idle_lru = collections.OrderedDict()  # idle names, LRU order
        # per-name load generation: salts the prefix-cache hash chain so
        # pages cached under an adapter's OLD weights never match after a
        # reload with new weights (inference/engine.py)
        self._generation = {}
        self._next_gen = 1
        self.loads = 0
        self.evictions = 0
        self.requests = {}  # name -> submissions carrying this adapter

    # -- introspection --------------------------------------------------
    @property
    def loaded(self):
        """Loaded adapter names, sorted (snapshot/JSON friendly)."""
        with self._lock:
            return sorted(self._index)

    @property
    def used_slots(self):
        with self._lock:
            return len(self._index)

    def index_of(self, name):
        """Pool index of ``name``; raises KeyError when not loaded."""
        with self._lock:
            return self._index[name]

    def generation_of(self, name):
        with self._lock:
            return self._generation[name]

    def active_count(self, name):
        with self._lock:
            return self._active.get(name, 0)

    # -- load / evict ---------------------------------------------------
    def assign(self, name, generation=None):
        """Slot index for (re)loading ``name``: its current index when
        already loaded (a reload — new generation, same row), else a free
        slot, else the LRU idle adapter's slot (evicting it). Raises
        :class:`AdapterPoolFull` when every slot is pinned by live
        requests. Returns ``(index, evicted_name_or_None)``.

        ``generation`` restores a specific load generation instead of
        minting a fresh one — the host-tier auto-load re-installs a
        spilled adapter's ORIGINAL weights, so its original generation
        (and therefore its salted prefix pages) must stay valid. The
        counter fast-forwards past any restored value so a later true
        reload still mints a strictly newer generation."""
        with self._lock:
            evicted = None
            if name in self._index:
                idx = self._index[name]
                self._idle_lru.pop(name, None)
                if self._active.get(name, 0) == 0:
                    self._idle_lru[name] = None
            elif self._free:
                idx = self._free.popleft()
            elif self._idle_lru:
                evicted, _ = self._idle_lru.popitem(last=False)
                idx = self._index.pop(evicted)
                self._generation.pop(evicted, None)
                self.evictions += 1
            else:
                raise AdapterPoolFull(self.n_slots)
            self._index[name] = idx
            if generation is None:
                generation = self._next_gen
                self._next_gen += 1
            else:
                generation = int(generation)
                self._next_gen = max(self._next_gen, generation + 1)
            self._generation[name] = generation
            if name not in self._idle_lru and self._active.get(name, 0) == 0:
                self._idle_lru[name] = None
            self.loads += 1
            return idx, evicted

    def remove(self, name):
        """Explicit unload. Refuses while live requests decode against
        the adapter (evicting under them would serve the next tenant's
        weights mid-generation). Returns the freed index."""
        with self._lock:
            if name not in self._index:
                raise KeyError(f"adapter {name!r} is not loaded")
            if self._active.get(name, 0) > 0:
                raise RuntimeError(
                    f"adapter {name!r} has {self._active[name]} live "
                    "request(s); drain before unloading"
                )
            idx = self._index.pop(name)
            self._idle_lru.pop(name, None)
            self._generation.pop(name, None)
            self._free.append(idx)
            return idx

    # -- per-request references -----------------------------------------
    def count_request(self, name):
        """Per-adapter submission counter (must be loaded)."""
        with self._lock:
            if name not in self._index:
                raise KeyError(f"adapter {name!r} is not loaded")
            self.requests[name] = self.requests.get(name, 0) + 1

    def acquire(self, name):
        """Pin ``name`` for one decode slot's lifetime; returns its pool
        index. KeyError when the adapter is not (or no longer) loaded —
        it may have been evicted between submit and slot join."""
        with self._lock:
            idx = self._index[name]
            self._active[name] = self._active.get(name, 0) + 1
            self._idle_lru.pop(name, None)
            return idx

    def release(self, name):
        """Drop one slot's pin; an adapter going idle parks in the
        eviction LRU (most-recently-used last). Double release raises —
        a refcount bug must never silently free a hot adapter."""
        with self._lock:
            count = self._active.get(name, 0)
            if count <= 0:
                raise ValueError(
                    f"release of adapter {name!r} with no live references"
                )
            if count > 1:
                self._active[name] = count - 1
                return
            del self._active[name]
            if name in self._index:  # still loaded: now evictable
                self._idle_lru[name] = None
