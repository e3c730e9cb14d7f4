"""Host-side KV block pool: allocation, prefix hashing, refcounts, LRU.

The device side of the paged KV cache (decode.py:KVPool) is a dumb slab
of fixed-size pages; everything that makes it a CACHE lives here, on the
host, where the scheduler's single driver thread runs it without device
syncs:

  allocation   — physical page ids handed out from a free list; page 0
                 is the NULL page (never allocated — unassigned block-
                 table entries point at it, absorbing dead-slot writes).
  prefix hash  — every FULL page of a prompt is content-hashed with the
                 vLLM chain scheme: ``hash(page) = H(hash(parent page),
                 page's tokens)``, so a hash identifies the page's
                 tokens AND everything before them. A registry maps
                 chain hashes to physical pages.
  refcounts    — pages are shared across requests (a fleet-wide system
                 prompt is ONE set of physical pages however many slots
                 decode against it). ``release`` decrefs; a registered
                 page at refcount 0 is not freed but parked in an LRU of
                 evictable cached pages — the next request with that
                 prefix re-acquires it for free.
  eviction     — allocation under pool pressure reclaims cached pages
                 LRU-first (``reclaimed`` counts them); only when free +
                 cached still can't cover a request does
                 :class:`PoolExhausted` surface, which the scheduler
                 turns into the typed ``REJECT_CAPACITY`` rejection.

By default decode-time appends never touch this class mid-flight: the
scheduler reserves a request's worst case (``blocks_for(prompt +
max_new)``) at slot-join, so a running request can never hit pool
exhaustion between tokens — admission is the only gate. With the host
tier's ``lazy_alloc`` mode the engine instead grows a slot's pages one
at a time between decode steps and the scheduler preempts under
pressure — a preempted request's registered pages park here (and spill
to host RAM on eviction via ``spill_fn``) so it resumes suffix-only
(docs/inference.md "Host-memory spill tier").

No torch imports — unit-testable refcount exactness (test_paged_kv.py).
"""

import collections
import hashlib

NULL_BLOCK = 0  # physical page 0: the never-allocated garbage sink


class PoolExhausted(RuntimeError):
    """The pool cannot supply a requested allocation even after evicting
    every cached (refcount-0) page. Carries ``needed``/``available`` so
    the admission gate can report exactly how short the pool fell."""

    def __init__(self, needed, available):
        super().__init__(
            f"KV block pool exhausted: need {needed} pages, "
            f"{available} free or evictable"
        )
        self.needed = int(needed)
        self.available = int(available)


def hash_full_blocks(prompt_tokens, block_size, salt=None):
    """Chain hashes for every FULL page of ``prompt_tokens``: entry i
    covers tokens [0, (i+1)*block_size) — the hash commits to the whole
    prefix, not just the page's own tokens, so two prompts share a page
    only when they agree on EVERYTHING up to its end. sha1 over token
    bytes: deterministic across processes (unlike Python's salted
    ``hash``) and collision-safe at cache scale.

    ``salt`` seeds the chain root: cached k/v are a function of the
    WEIGHTS that produced them, not just the tokens, so requests served
    under different LoRA adapters must never share pages — the engine
    salts with the slot's adapter identity (name + load generation, so a
    reloaded adapter's new weights also never match its old pages)."""
    out = []
    parent = b"kv-prefix-root"
    if salt is not None:
        parent = parent + b"#" + str(salt).encode()
    n_full = len(prompt_tokens) // block_size
    for i in range(n_full):
        page = prompt_tokens[i * block_size:(i + 1) * block_size]
        h = hashlib.sha1(
            parent + b"|" + ",".join(str(int(t)) for t in page).encode()
        ).hexdigest()
        out.append(h)
        parent = h.encode()
    return out


class BlockPool:
    """Physical page allocator with prefix-hash sharing.

    ``num_blocks`` usable pages (ids 1..num_blocks; 0 is NULL_BLOCK).
    Not thread-safe by design: the continuous-batching scheduler's single
    driver thread is the only caller (same contract as the slot table).
    """

    def __init__(self, num_blocks, block_size, spill_fn=None):
        if int(num_blocks) < 1:
            raise ValueError(
                f"BlockPool needs >= 1 usable page, got {num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = collections.deque(range(1, self.num_blocks + 1))
        self._refcount = {}  # block_id -> live references (> 0)
        self._registry = {}  # chain hash -> block_id
        self._hash_of = {}  # block_id -> chain hash (registered pages)
        # refcount-0 registered pages, insertion order = LRU order
        self._cached = collections.OrderedDict()
        self.reclaimed = 0  # cached pages evicted to satisfy allocations
        # host-tier seam: called as spill_fn(block_id, chain_hash) while
        # the page's device content is still intact — BEFORE the id
        # returns to the free list. The callback owns its own error
        # handling (the engine's absorbs host_tier.copy faults); a leak
        # through it must not corrupt the pool mid-allocation, so it is
        # contained here and counted.
        self._spill_fn = spill_fn
        self.spill_errors = 0

    # -- introspection --------------------------------------------------
    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def cached_blocks(self):
        return len(self._cached)

    @property
    def available_blocks(self):
        """Pages an allocation could obtain right now: free + evictable."""
        return len(self._free) + len(self._cached)

    @property
    def used_blocks(self):
        """Pages pinned by live references (the occupancy gauge; cached
        refcount-0 pages are NOT in use — they are reclaimable value)."""
        return len(self._refcount)

    def refcount(self, block_id):
        return self._refcount.get(block_id, 0)

    # -- allocation -----------------------------------------------------
    def blocks_for(self, num_tokens):
        """Pages needed to hold ``num_tokens`` cache rows."""
        return -(-int(num_tokens) // self.block_size)

    def alloc(self, n):
        """Allocate ``n`` private pages (refcount 1 each), evicting
        cached pages LRU-first under pressure. All-or-nothing: raises
        :class:`PoolExhausted` without side effects when short."""
        n = int(n)
        if n > self.available_blocks:
            raise PoolExhausted(n, self.available_blocks)
        while len(self._free) < n:
            self._evict_one()
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._refcount[b] = 1
        return out

    def _evict_one(self):
        block_id = next(iter(self._cached))
        h = self._hash_of[block_id]
        if self._spill_fn is not None:
            try:
                self._spill_fn(block_id, h)
            except Exception:
                self.spill_errors += 1
        del self._cached[block_id]
        del self._hash_of[block_id]
        del self._registry[h]
        self._free.append(block_id)
        self.reclaimed += 1

    # -- prefix cache ---------------------------------------------------
    def match_prefix(self, prompt_tokens, hashes=None):
        """Longest cached full-page prefix of ``prompt_tokens`` that
        still leaves >= 1 suffix token to compute (the last prompt
        token's logits seed generation, so the whole prompt can never be
        served from cache). Acquires a reference on every matched page
        and returns ``(prefix_len, [block_ids])`` — (0, []) on a miss.
        ``hashes`` lets the caller reuse a precomputed
        :func:`hash_full_blocks` chain (the admission path hashes once
        and shares it with :meth:`register_prefix`)."""
        if hashes is None:
            hashes = hash_full_blocks(prompt_tokens, self.block_size)
        # a prompt that is exactly N full pages may reuse at most N-1
        if hashes and len(prompt_tokens) == len(hashes) * self.block_size:
            hashes = hashes[:-1]
        blocks = []
        for h in hashes:
            block_id = self._registry.get(h)
            if block_id is None:
                break
            blocks.append(block_id)
        for block_id in blocks:
            self._acquire(block_id)
        return len(blocks) * self.block_size, blocks

    def _acquire(self, block_id):
        count = self._refcount.get(block_id, 0)
        if count == 0:
            # was parked in the evictable LRU; pin it again
            self._cached.pop(block_id, None)
        self._refcount[block_id] = count + 1

    def register_prefix(self, prompt_tokens, block_ids, hashes=None):
        """Publish a cold-prefilled prompt's FULL pages into the registry
        so later requests can share them. ``block_ids`` covers the prompt
        in order (full pages first); pages already registered under the
        same hash (another request published between this request's
        admission and now) are left alone — the earlier copy wins and
        this request's private duplicate simply frees on release.
        ``hashes``: optional precomputed chain (see match_prefix)."""
        if hashes is None:
            hashes = hash_full_blocks(prompt_tokens, self.block_size)
        for h, block_id in zip(hashes, block_ids):
            if h in self._registry:
                continue
            if block_id in self._hash_of:
                continue  # already published (shared prefix re-register)
            self._registry[h] = block_id
            self._hash_of[block_id] = h

    # -- release --------------------------------------------------------
    def release(self, block_ids):
        """Drop one reference per page. Unregistered pages at refcount 0
        return to the free list; registered pages park in the evictable
        LRU, keeping their cached prefix warm until pressure reclaims
        them. Releasing an unreferenced page is a refcount bug — raise,
        never silently corrupt a shared page."""
        for block_id in block_ids:
            count = self._refcount.get(block_id, 0)
            if count <= 0:
                raise ValueError(
                    f"release of page {block_id} with refcount 0 "
                    "(double free)"
                )
            if count > 1:
                self._refcount[block_id] = count - 1
                continue
            del self._refcount[block_id]
            if block_id in self._hash_of:
                self._cached[block_id] = None  # newest = evicted last
            else:
                self._free.append(block_id)
