"""Continuous batching: slot-managed admission over a fixed decode width.

The Orca-style iteration-level scheduler (PAPERS.md): instead of batching
whole requests (a batch lives until its LONGEST member finishes, leaving
finished rows as dead compute), requests are admitted into per-sequence
KV-cache SLOTS at every decode-step boundary. A slot frees the moment its
request hits EOS / max_new_tokens / the length cap, and the next queued
request joins the running batch one step later — the decode step's
shapes never change, so joins and leaves never resize a device tensor.
This is the JAX package's scheduler (deepspeed_tpu/inference/
scheduler.py) with its imports redirected; its behaviour is unchanged.

The front door is a bounded queue: ``submit`` rejects with
:class:`RequestRejected` once ``queue_depth`` submissions are waiting
(after ``queue_timeout_secs`` of grace), so overload sheds at admission
instead of growing host memory. Everything here is host-side
orchestration — device work happens through the two engine hooks
(``prefill_request`` / ``decode_tokens``), keeping this module free of
torch imports and independently testable.

Slot lifecycle (docs/inference.md has the diagram):

    FREE -> (admit: prefill writes cache rows 0..P-1, first token
             sampled from the prompt's last logit row = TTFT)
         -> DECODING (one token per step, position P, P+1, ...)
         -> (EOS | max_new_tokens | position cap | deadline) -> FREE

Self-healing (docs/inference.md "Self-healing serving"): per-request
deadlines (unmeetable at admission => finished with reason "deadline"
without ever taking a slot; expired in flight => the slot is reclaimed
within one decode step), a health-state machine (healthy -> degraded ->
draining; degraded sheds priority > 0 submissions at the front door),
and decode-driver auto-restart from the engine's pinned params within a
configured budget instead of fail-finishing everything on the first
crash.
"""

import collections
import itertools
import os
import queue
import threading
import time
import uuid

from ..adapters.pool import AdapterPoolFull
from ..telemetry.registry import DEFAULT_TIME_BUCKETS_MS, histogram_quantile
from ..telemetry.tracing import NOOP_TRACER, TraceContext
from ..utils.logging import logger
from .paging import PoolExhausted


# Machine-readable rejection reason codes carried by RequestRejected (and
# its fleet-tier subclasses in deepspeed_tpu/serving/): routers and tests
# branch on ``exc.reason``, never on the prose message.
REJECT_OVERLOAD = "overload"      # queue full / degraded shedding / fleet full
REJECT_DEADLINE = "deadline"      # deadline unmeetable at an admission gate
REJECT_RATE_LIMIT = "rate_limit"  # per-tenant token bucket empty
REJECT_DRAINING = "draining"      # draining or shut-down front door
REJECT_CAPACITY = "capacity"      # KV page pool exhausted (paged cache)
REJECT_FENCED = "fenced_out"      # stale router incarnation standing down
REJECT_REASONS = (
    REJECT_OVERLOAD, REJECT_DEADLINE, REJECT_RATE_LIMIT, REJECT_DRAINING,
    REJECT_CAPACITY, REJECT_FENCED,
)


class RequestRejected(RuntimeError):
    """The front door shed this request (queue full past the timeout,
    degraded-health priority shedding, or a draining scheduler).

    ``reason`` is one of the REJECT_* codes above — the machine-readable
    classification the serving tier routes and retries on."""

    def __init__(self, message, reason=REJECT_OVERLOAD):
        if reason not in REJECT_REASONS:
            raise ValueError(
                f"unknown rejection reason {reason!r}; valid: "
                f"{REJECT_REASONS}"
            )
        super().__init__(message)
        self.reason = reason


_FINISH_EOS = "eos"
_FINISH_MAX_NEW = "max_new_tokens"
_FINISH_LENGTH = "length"
_FINISH_CANCELLED = "cancelled"
_FINISH_DEADLINE = "deadline"
_FINISH_ERROR = "error"

# infer/health_state gauge values (docs/observability.md)
HEALTH_HEALTHY = 0
HEALTH_DEGRADED = 1
HEALTH_DRAINING = 2


class InferenceRequest:
    """One generation request. ``result()`` blocks until the scheduler
    finishes it and returns the generated token ids (prompt excluded).

    ``request_id`` is a replica-prefixed GLOBALLY unique string minted by
    the scheduler (``{replica}-{instance token}-{seq}``): a process-local
    integer counter collides across replicas (and across one replica's
    driver restarts) the moment ids reach fleet telemetry, so the id
    carries the replica AND a per-scheduler random token. It rides the
    request's trace as the root attr (docs/observability.md)."""

    _ids = itertools.count()  # fallback for direct construction only

    def __init__(self, prompt_tokens, max_new_tokens, temperature,
                 eos_token_id, deadline_secs=None, priority=0,
                 adapter=None, request_id=None):
        self.request_id = (
            request_id if request_id is not None
            else f"req-{os.getpid():x}-{next(self._ids)}"
        )
        self.prompt_tokens = [int(t) for t in prompt_tokens]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.priority = int(priority)
        # LoRA adapter NAME (docs/adapters.md); resolved to its pool row
        # at slot join so a hot-reload between submit and join serves the
        # adapter's newest weights
        self.adapter = adapter
        self.tokens = []
        self.finish_reason = None
        self.submitted_at = time.monotonic()
        # absolute monotonic deadline; a request past it finishes with
        # reason "deadline" (tokens so far are the partial answer)
        self.deadline = (
            self.submitted_at + float(deadline_secs)
            if deadline_secs is not None else None
        )
        self.first_token_at = None
        self._done = threading.Event()
        self._cancelled = False
        # distributed-tracing state (telemetry/tracing.py): trace_ctx is
        # the request's own span context (phases parent to it), set by
        # the scheduler when tracing is armed; trace_spans collects the
        # request's sampled spans so remote callers (the worker RPC) can
        # ship them back to the router's trace file
        self.trace_ctx = None
        self.trace_spans = []
        self._trace_parent = None
        self._tracer = None

    @property
    def done(self):
        return self._done.is_set()

    def cancel(self):
        """Withdraw this request: still-queued it finishes with reason
        ``"cancelled"`` the next time the scheduler reaches it instead of
        occupying a slot; already DECODING its slot (and its KV pages)
        are reclaimed at the next step boundary — an abandoned stream
        (HTTP client disconnect, serving/http.py) frees its capacity
        within one decode step instead of generating for nobody."""
        self._cancelled = True

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished after {timeout}s"
            )
        return self.tokens

    def _finish(self, reason):
        already = self._done.is_set()
        self.finish_reason = reason
        if not already and self._tracer is not None and (
            self.trace_ctx is not None
        ):
            # the request's container span (queue/prefill spans are its
            # children), closed retroactively with the pre-allocated
            # span id — every finish path (EOS, deadline, crash, cancel)
            # lands here. Recorded BEFORE _done is set: the worker's
            # done-poller ships trace_spans the moment done reads True,
            # and a finished event without the container span would
            # orphan the phase spans in the router's trace.
            attrs = {
                "request_id": self.request_id,
                "finish_reason": reason,
                "tokens": len(self.tokens),
            }
            if self.adapter is not None:
                attrs["adapter"] = self.adapter
            span = self._tracer.record(
                "sched.request", self.submitted_at, time.monotonic(),
                ctx=self._trace_parent, span_id=self.trace_ctx.span_id,
                attrs=attrs,
            )
            if span is not None and span["sampled"]:
                self.trace_spans.append(span)
        self._done.set()


class ContinuousBatchingScheduler:
    """Admission queue + slot table driving an InferenceEngine's
    prefill/decode hooks. Thread-safety: ``submit`` may be called from any
    thread; ``step``/``run_until_idle`` must run on one driver thread
    (``serve_forever`` provides one)."""

    def __init__(self, engine, *, num_slots, max_seq_len, queue_depth,
                 queue_timeout, eos_token_id, temperature, registry,
                 telemetry=None, export_interval=16, deadline_secs=None,
                 driver_restart_budget=0, degraded_queue_ratio=0.75,
                 tracer=None):
        self._engine = engine
        # request tracer (telemetry/tracing.py): the NOOP passthrough
        # unless the engine's telemetry.tracing block armed one — every
        # hot-path hook below is gated on one attribute check
        self._tracer = tracer if tracer is not None else NOOP_TRACER
        # per-driver trace the batch-level decode-step spans parent to
        # (they belong to no single request)
        self._driver_ctx = None
        # globally-unique request ids: replica prefix (set_id_prefix)
        # + a per-instance random token (driver restarts rebuild the
        # scheduler — the token keeps post-restart ids distinct) + seq
        self._id_token = uuid.uuid4().hex[:8]
        self._id_prefix = f"p{os.getpid():x}-{self._id_token}"
        self._id_seq = itertools.count()
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len)
        self._queue = queue.Queue(maxsize=int(queue_depth))
        self._queue_timeout = float(queue_timeout)
        self._eos_token_id = eos_token_id
        self._default_temperature = float(temperature)
        self._default_deadline = deadline_secs
        self._restart_budget = int(driver_restart_budget)
        self.restarts_used = 0
        # flipped when a serve_forever driver dies PAST the restart budget
        # (never by a requested shutdown/drain) — the fleet tier's
        # eviction signal (deepspeed_tpu/serving/replica.py)
        self.driver_failed = False
        self._degraded_ratio = float(degraded_queue_ratio)
        self._draining = False
        self._slots = [None] * self.num_slots
        # requests popped from the queue whose page allocation came up
        # short (paged engines only): they hold no slot and no pages, and
        # re-enter admission FIRST at the next step boundary, once a
        # finishing request has released pages
        self._deferred = collections.deque()
        # admission-order stamp per slot: preemption (lazy page growth,
        # engine.ensure_decode_capacity) victims the MOST recently
        # admitted request — it has the least sunk prefill/decode work
        self._slot_admit_seq = [0] * self.num_slots
        self._admit_seq = 0
        self._registry = registry
        self._telemetry = telemetry
        self._export_interval = max(1, int(export_interval))
        self._steps = 0
        self._tokens_since_rate = 0
        self._rate_anchor = None
        self._stop = threading.Event()
        self._thread = None
        # serializes DRIVERS (run_until_idle / the serve thread): two
        # concurrent generate() calls must take turns, not race the slot
        # table, the PRNG key, and the donated cache buffers
        self._drive_lock = threading.Lock()

        reg = registry
        self._ttft_ms = reg.histogram(
            "infer/ttft_ms", buckets=DEFAULT_TIME_BUCKETS_MS
        )
        self._token_latency_ms = reg.histogram(
            "infer/token_latency_ms", buckets=DEFAULT_TIME_BUCKETS_MS
        )
        self._prefill_ms = reg.histogram(
            "infer/prefill_time_ms", buckets=DEFAULT_TIME_BUCKETS_MS
        )
        self._queue_wait_ms = reg.histogram(
            "infer/queue_wait_ms", buckets=DEFAULT_TIME_BUCKETS_MS
        )
        self._tokens_per_sec = reg.gauge("infer/tokens_per_sec")
        self._queue_depth = reg.gauge("infer/queue_depth")
        self._occupancy = reg.gauge("infer/slot_occupancy")
        self._admitted = reg.counter("infer/requests_admitted")
        self._rejected = reg.counter("infer/requests_rejected")
        self._completed = reg.counter("infer/requests_completed")
        self._tokens_generated = reg.counter("infer/tokens_generated")
        self._deadline_misses = reg.counter("infer/deadline_misses")
        self._health_gauge = reg.gauge("infer/health_state")
        self._driver_restarts = reg.counter("infer/driver_restarts")
        self._shed = reg.counter("infer/requests_shed")

    # -- tracing helpers -------------------------------------------------
    def set_id_prefix(self, replica_id):
        """Adopt the serving tier's replica id as the request-id prefix
        (the per-instance token stays, so a restarted driver on the same
        replica still mints globally unique ids)."""
        self._id_prefix = f"r{replica_id}-{self._id_token}"

    def _trace_id(self, req):
        """The request's trace id for histogram exemplars (None when the
        trace is unsampled or tracing is off)."""
        ctx = req.trace_ctx
        return ctx.trace_id if ctx is not None and ctx.sampled else None

    def _trace_phase(self, req, name, t0, t1, attrs=None):
        """Record one request-phase span under the request's container
        span; sampled spans also collect on the request for RPC
        shipping. Call sites gate on ``self._tracer.enabled``."""
        if req.trace_ctx is None:
            return None
        span = self._tracer.record(
            name, t0, t1, ctx=req.trace_ctx, attrs=attrs
        )
        if span is not None and span["sampled"]:
            req.trace_spans.append(span)
        return span

    def _reject_event(self, reason):
        """Admission-verdict breadcrumb for the flight recorder."""
        if self._tracer.enabled:
            self._tracer.event("sched.reject", attrs={"reason": reason})

    # -- health-state machine -------------------------------------------
    @property
    def health(self):
        """Current health state (module constants HEALTH_*)."""
        return self._update_health()

    def _waiting_depth(self):
        """Requests waiting for a slot: the bounded queue PLUS the
        deferred line (popped but parked on page pressure) — the one
        number every queue_depth gauge write and the degraded-health
        threshold use, so the reported backlog never flickers between
        definitions."""
        return self._queue.qsize() + len(self._deferred)

    def _update_health(self):
        """healthy -> degraded -> draining, from queue pressure and the
        drain/stop flags; mirrors onto the infer/health_state gauge."""
        if self._draining or self._stop.is_set():
            h = HEALTH_DRAINING
        elif (
            self._queue.maxsize > 0
            and self._waiting_depth()
            >= self._degraded_ratio * self._queue.maxsize
        ):
            h = HEALTH_DEGRADED
        else:
            h = HEALTH_HEALTHY
        self._health_gauge.set(h)
        return h

    def drain(self):
        """Stop admitting new requests; everything queued or in flight
        runs to completion (the graceful shutdown ramp — ``shutdown``
        afterwards is instant)."""
        self._draining = True
        self._update_health()

    def load_snapshot(self):
        """Cheap router-facing load/health view (host-side counters only —
        no device sync, no locks beyond the queue's own): what a fleet
        placement policy scores replicas by (docs/serving.md). Sampling
        the queue here also refreshes the infer/queue_depth gauge, so an
        IDLE replica reports a live value instead of whatever the last
        drive-loop iteration left behind."""
        depth = self._waiting_depth()
        self._queue_depth.set(depth)
        active = len(self.active_slots)
        decode_n = self._token_latency_ms.count
        snap = {
            "queue_depth": depth,
            "queue_capacity": self._queue.maxsize,
            "active_slots": active,
            "free_slots": self.num_slots - active,
            "num_slots": self.num_slots,
            "health": self._update_health(),
            "mean_prefill_ms": (
                self._prefill_ms.sum / self._prefill_ms.count
                if self._prefill_ms.count else 0.0
            ),
            "mean_decode_ms": (
                self._token_latency_ms.sum / decode_n if decode_n else 0.0
            ),
            # per-phase tails for the fleet autoscaler's cost model
            # (serving/autoscaler.py): the request-phase span breakdown's
            # histogram view, interpolated host-side so prediction needs
            # no extra RPC
            "p99_prefill_ms": (
                histogram_quantile(self._prefill_ms, 0.99)
                if self._prefill_ms.count else 0.0
            ),
            "mean_queue_wait_ms": (
                self._queue_wait_ms.sum / self._queue_wait_ms.count
                if self._queue_wait_ms.count else 0.0
            ),
            "requests_shed": self._shed.value,
            "restarts_used": self.restarts_used,
            # completion-progress markers (JSON-safe ints): what the
            # router's zombie detection watches — active slots whose
            # completions/tokens stop moving mean a wedged decode path
            # even when the snapshot RPC itself still answers
            "requests_completed": int(self._completed.value),
            "tokens_generated": int(self._tokens_generated.value),
            "driving": self.driving,
            "stopped": self._stop.is_set(),
            "driver_failed": self.driver_failed,
        }
        kv = getattr(self._engine, "kv_snapshot", None)
        if kv is not None:
            # paged engines add pool/prefix-cache state (kv_blocks_free,
            # prefix_hit_rate, ...) — what capacity-aware placement and
            # the per-replica fleet gauges read (docs/serving.md)
            snap.update(kv())
        adapters = getattr(self._engine, "adapter_snapshot", None)
        if adapters is not None:
            # multi-LoRA engines add loaded-adapter ids + pool occupancy
            # — what adapter-affinity placement reads (docs/adapters.md)
            snap.update(adapters())
        return snap

    # -- front door -----------------------------------------------------
    def submit(self, prompt_tokens, max_new_tokens=32, temperature=None,
               eos_token_id=None, timeout=None, deadline_secs=None,
               priority=0, adapter=None, trace_ctx=None):
        """Enqueue a request; returns the :class:`InferenceRequest`
        handle. Raises :class:`RequestRejected` when the bounded queue
        stays full past ``timeout`` (default: the config's
        ``queue_timeout_secs``), when the scheduler is draining, or when
        degraded health sheds this ``priority`` (> 0 = sheddable; 0 =
        always admitted while healthy capacity exists). Raises
        ``ValueError`` for prompts the engine can never serve (longer
        than the prefill window, or leaving no room to generate) and for
        ``deadline_secs <= 0``. ``deadline_secs`` (default: the config's
        ``inference.deadline_secs``) bounds the request end to end: an
        unmeetable deadline finishes it with reason ``"deadline"`` at
        admission, an expired one frees its slot within one decode
        step. ``adapter`` names a LoRA adapter loaded into the engine's
        pool (docs/adapters.md); unloaded names raise ``ValueError`` —
        a request for an unknown tenant adapter can never be served."""
        if self._stop.is_set():
            self._rejected.inc()
            raise RequestRejected(
                "scheduler is shut down", reason=REJECT_DRAINING
            )
        if deadline_secs is None:
            deadline_secs = self._default_deadline
        if deadline_secs is not None and float(deadline_secs) <= 0:
            raise ValueError(
                f"deadline_secs must be > 0 seconds (or None for no "
                f"deadline), got {deadline_secs!r}"
            )
        health = self._update_health()
        if health == HEALTH_DRAINING:
            self._rejected.inc()
            self._reject_event(REJECT_DRAINING)
            raise RequestRejected(
                "scheduler is draining; not admitting new requests",
                reason=REJECT_DRAINING,
            )
        if health == HEALTH_DEGRADED and int(priority) > 0:
            self._shed.inc()
            self._rejected.inc()
            self._reject_event(REJECT_OVERLOAD)
            raise RequestRejected(
                f"degraded (queue {self._queue.qsize()}/"
                f"{self._queue.maxsize}): shedding priority-{priority} "
                "submission (priority 0 is never shed at this gate)",
                reason=REJECT_OVERLOAD,
            )
        if adapter is not None:
            resolve = getattr(self._engine, "resolve_adapter", None)
            if resolve is None:
                raise ValueError(
                    f"adapter {adapter!r} requested but this engine has "
                    'no adapter pool (enable the "adapters" config '
                    "block)"
                )
            resolve(adapter)  # ValueError on an unloaded name; counts it
        resolved_temp = (
            self._default_temperature
            if temperature is None else float(temperature)
        )
        if resolved_temp > 0 and getattr(
            self._engine, "speculative", False
        ):
            raise ValueError(
                f"temperature={resolved_temp} on a speculative engine: "
                "speculative decoding preserves exact output for GREEDY "
                "requests only (every committed token is the target's "
                "argmax); submit with temperature 0"
            )
        n = len(prompt_tokens)
        if n == 0:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens!r} "
                "(prefill always samples the first token)"
            )
        if n > self._engine.prefill_len:
            raise ValueError(
                f"prompt of {n} tokens exceeds prefill_len="
                f"{self._engine.prefill_len}; raise inference.prefill_len "
                f"(or max_seq_len)"
            )
        if n >= self.max_seq_len:
            raise ValueError(
                f"prompt of {n} tokens leaves no room to generate under "
                f"max_seq_len={self.max_seq_len}"
            )
        if getattr(self._engine, "paged", False):
            # KV page-pool capacity gate: a request the pool cannot hold
            # RIGHT NOW sheds with the typed "capacity" reason so a fleet
            # router can distinguish "replica out of KV pages" from
            # "replica overloaded" and place elsewhere. (A request racing
            # in behind this check simply defers at the slot-join
            # boundary until pages free — the gate is load shedding, not
            # the correctness mechanism.)
            needed = self._engine.kv_blocks_needed(n, int(max_new_tokens))
            total = self._engine.kv_pool_total_blocks()
            if needed > total:
                # worst case stays the feasibility bound even under lazy
                # growth: a request that can NEVER fit whole would only
                # thrash the preemption path without ever completing
                raise ValueError(
                    f"request needs {needed} KV pages (prompt {n} + "
                    f"max_new_tokens {max_new_tokens}) but the pool holds "
                    f"only {total}; raise inference.kv_pool_blocks or "
                    f"lower the generation budget"
                )
            # under lazy allocation (host_tier.lazy_alloc) admission only
            # reserves the PROMPT's pages; decode-time growth is backed by
            # preemption, so the shed gate sizes against that smaller
            # footprint instead of the worst case
            needed_now_fn = getattr(self._engine, "kv_blocks_needed_now", None)
            gate_needed = (
                needed_now_fn(n, int(max_new_tokens))
                if needed_now_fn is not None else needed
            )
            available = self._engine.kv_blocks_available()
            if gate_needed > available:
                self._rejected.inc()
                self._reject_event(REJECT_CAPACITY)
                raise RequestRejected(
                    f"KV page pool exhausted: request needs {gate_needed} "
                    f"pages, {available} free or evictable (of {total})",
                    reason=REJECT_CAPACITY,
                )
        req = InferenceRequest(
            prompt_tokens,
            max_new_tokens=max_new_tokens,
            temperature=(
                self._default_temperature
                if temperature is None else temperature
            ),
            eos_token_id=(
                self._eos_token_id if eos_token_id is None else eos_token_id
            ),
            deadline_secs=deadline_secs,
            priority=priority,
            adapter=adapter,
            request_id=f"{self._id_prefix}-{next(self._id_seq)}",
        )
        if self._tracer.enabled:
            # join the caller's trace (router root over the RPC) or start
            # a fresh one; the request's own span id is pre-allocated so
            # phase spans parent to it before it closes at finish time
            parent = TraceContext.from_wire(trace_ctx)
            ctx = self._tracer.child_of(parent)
            req.trace_ctx = ctx
            req._trace_parent = parent or TraceContext(
                ctx.trace_id, None, ctx.sampled
            )
            req._tracer = self._tracer
        wait = self._queue_timeout if timeout is None else float(timeout)
        try:
            if wait > 0:
                self._queue.put(req, timeout=wait)
            else:
                self._queue.put_nowait(req)
        except queue.Full:
            self._rejected.inc()
            self._reject_event(REJECT_OVERLOAD)
            raise RequestRejected(
                f"request queue full ({self._queue.maxsize} waiting); "
                f"rejected after {wait:.3f}s",
                reason=REJECT_OVERLOAD,
            ) from None
        if self._stop.is_set():
            # raced shutdown's outstanding-request drain: nobody will
            # service this — fail it now so result() cannot hang
            req.cancel()
            req._finish(_FINISH_CANCELLED)
            self._rejected.inc()
            self._reject_event(REJECT_DRAINING)
            raise RequestRejected(
                "scheduler is shut down", reason=REJECT_DRAINING
            )
        self._admitted.inc()
        self._queue_depth.set(self._waiting_depth())
        return req

    # -- scheduling -----------------------------------------------------
    @property
    def active_slots(self):
        return [i for i, r in enumerate(self._slots) if r is not None]

    def _free_slot(self, slot):
        """Vacate ``slot`` and hand its KV pages back to a paged engine
        (shared prefix pages decref, private ones free; the block-table
        row nulls so the dead slot's ride-along writes stay harmless).
        The request's final token sequence rides along so the engine can
        register the slot's FULL decode blocks as shareable prefix pages
        (docs/inference.md: decode-page chain hashing) before they
        release — engines without that signature get the bare call."""
        req = self._slots[slot]
        self._slots[slot] = None
        release = getattr(self._engine, "release_slot", None)
        if release is None:
            return
        if req is not None:
            try:
                release(
                    slot,
                    final_tokens=list(req.prompt_tokens) + list(req.tokens),
                )
                return
            except TypeError:
                pass  # duck-typed engine with the old 1-arg signature
        release(slot)

    def _ensure_decode_capacity(self):
        """Lazy KV page growth (host_tier.lazy_alloc): before the decode
        step, ask the engine to top up every active slot's block list for
        the tokens this step can commit. A shortfall PREEMPTS the most
        recently admitted request — its slot frees (parking its full
        blocks in the reclaimable prefix cache, spillable to the host
        tier), it re-enters the deferred line, and it later resumes
        suffix-only with zero lost tokens — then the top-up retries. A
        lone active request always succeeds: admission's worst-case
        ``> total`` bound guarantees the whole pool can hold it."""
        ensure = getattr(self._engine, "ensure_decode_capacity", None)
        if ensure is None:
            return
        count_preempt = getattr(self._engine, "count_preemption", None)
        prefill_len = getattr(self._engine, "prefill_len", None)
        while True:
            active = self.active_slots
            if not active:
                return
            try:
                ensure(active)
                return
            except PoolExhausted:
                pass
            # victim selection is priority-classed: the lowest class
            # (highest numeric ``priority`` — 0 is the most protected)
            # parks first, and WITHIN a class the most recently admitted
            # request goes — so a burst of sheddable traffic can never
            # evict a protected tenant's generation. Only resumable
            # victims (prompt + committed tokens re-prefill in one
            # window); anything grown past the prefill window is
            # unresumable and only fail-finished as a last resort
            def _resumable(s):
                req = self._slots[s]
                return prefill_len is None or (
                    len(req.prompt_tokens) + len(req.tokens)
                ) <= prefill_len
            order = sorted(
                active,
                key=lambda s: (
                    self._slots[s].priority, self._slot_admit_seq[s]
                ),
                reverse=True,
            )
            victim = next((s for s in order if _resumable(s)), None)
            if victim is None:
                slot = order[0]
                req = self._slots[slot]
                self._free_slot(slot)
                req._finish(_FINISH_ERROR)
                logger.warning(
                    "lazy KV growth: no resumable preemption victim; "
                    "fail-finished request %s to free pages",
                    req.request_id,
                )
                continue
            req = self._slots[victim]
            if count_preempt is not None:
                count_preempt()
            self._free_slot(victim)
            self._deferred.appendleft(req)
            if self._tracer.enabled:
                self._tracer.event(
                    "sched.preempt", ctx=req.trace_ctx,
                    attrs={
                        "request_id": req.request_id,
                        "committed_tokens": len(req.tokens),
                    },
                )
            logger.info(
                "preempted request %s (%d committed tokens) for KV page "
                "pressure; it will resume suffix-only",
                req.request_id, len(req.tokens),
            )

    def _prefill_estimate_secs(self):
        """Observed mean prefill wall time — the admission-time lower
        bound on time-to-first-token (0 before any prefill ran)."""
        count = self._prefill_ms.count
        return (self._prefill_ms.sum / count) / 1e3 if count else 0.0

    def _deadline_unmeetable(self, req):
        """True when ``req`` cannot meet its deadline even if admitted
        right now: already expired, or less time remains than prefill
        alone is observed to take (reject-on-admission)."""
        if req.deadline is None:
            return False
        remaining = req.deadline - time.monotonic()
        return remaining <= 0 or remaining < self._prefill_estimate_secs()

    def _expire_deadlines(self):
        """Finish every request past its deadline — in flight (the slot
        is reclaimed) AND still queued (the waiter gets its "deadline"
        answer now, not when a slot eventually frees) — and reap
        in-flight CANCELLED requests the same way. Runs at each step
        boundary, so both land within one decode step."""
        now = time.monotonic()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            if req._cancelled:
                # an in-flight cancel (client disconnect) reclaims the
                # slot and its KV pages within one decode step — decode
                # work for an abandoned waiter is pure waste
                self._free_slot(slot)
                req._finish(_FINISH_CANCELLED)
                continue
            if req.deadline is not None and now >= req.deadline:
                self._free_slot(slot)
                self._deadline_misses.inc()
                req._finish(_FINISH_DEADLINE)
        # queued/deferred requests: finish in place (state only — no
        # structural mutation); _admit pops and discards already-finished
        # entries
        for req in list(self._deferred):
            if (
                req.deadline is not None
                and not req.done
                and now >= req.deadline
            ):
                self._deadline_misses.inc()
                req._finish(_FINISH_DEADLINE)
        with self._queue.mutex:
            for req in self._queue.queue:
                if (
                    req.deadline is not None
                    and not req.done
                    and now >= req.deadline
                ):
                    self._deadline_misses.inc()
                    req._finish(_FINISH_DEADLINE)

    def _next_admission_candidate(self):
        """Next request to try admitting: deferred (pages came up short
        at an earlier step) before freshly queued."""
        if self._deferred:
            return self._deferred.popleft()
        try:
            req = self._queue.get_nowait()
        except queue.Empty:
            return None
        self._queue_depth.set(self._waiting_depth())
        return req

    def _admit(self):
        """Fill free slots from the queue: prefill each admitted request
        and sample its first token (TTFT ends here). Requests whose
        deadline is unmeetable finish with reason ``"deadline"`` without
        taking the slot. On a paged engine the slot join first reserves
        the request's worst-case KV pages; a shortfall DEFERS the request
        (no slot, no pages) until a finishing request frees pages."""
        reserve = getattr(self._engine, "reserve_request", None)
        for slot, occupant in enumerate(self._slots):
            if occupant is not None:
                continue
            req = None
            while req is None:
                req = self._next_admission_candidate()
                if req is None:
                    break
                if req.done:
                    # already finished in the queue (deadline sweep):
                    # just discard the husk
                    req = None
                elif req._cancelled:
                    req._finish(_FINISH_CANCELLED)
                    req = None  # withdrawn: keep the slot for the next one
                elif self._deadline_unmeetable(req):
                    self._deadline_misses.inc()
                    req._finish(_FINISH_DEADLINE)
                    req = None  # never takes the slot
            if req is None:
                break
            t0 = time.monotonic()
            # the request OWNS the slot before prefill runs: a prefill
            # that raises (device OOM, injected chaos) then leaves it in
            # the slot table, where the crash-recovery / fail-finish
            # sweeps reach it — popped-but-unplaced requests would hang
            # their result() waiters forever
            self._slots[slot] = req
            self._slot_admit_seq[slot] = self._admit_seq
            self._admit_seq += 1
            # a PREEMPTED request re-enters here with committed tokens in
            # req.tokens: it resumes suffix-only — the effective prompt is
            # everything already served (original prompt + committed
            # tokens, whose full KV blocks were registered at park time,
            # so the re-prefill mostly hits the prefix cache / host tier)
            # and only the remaining generation budget is re-reserved
            eff_prompt = list(req.prompt_tokens) + list(req.tokens)
            eff_budget = max(1, int(req.max_new_tokens) - len(req.tokens))
            assign = getattr(self._engine, "assign_slot_adapter", None)
            if assign is not None:
                try:
                    joined = assign(slot, getattr(req, "adapter", None))
                except AdapterPoolFull:
                    # the adapter is parked in the host tier but every
                    # pool row is pinned by live requests: defer exactly
                    # like a KV page shortfall — a finishing request
                    # unpins a row and the auto-load lands next step
                    self._free_slot(slot)
                    self._deferred.appendleft(req)
                    if self._tracer.enabled:
                        self._tracer.event(
                            "sched.defer", ctx=req.trace_ctx,
                            attrs={
                                "request_id": req.request_id,
                                "reason": "adapter_pool",
                            },
                        )
                    break
                if not joined:
                    # the adapter was evicted between submit and slot
                    # join (and is not recoverable from the host tier):
                    # fail the request loudly rather than decode it
                    # against the identity (or another tenant's) weights;
                    # the slot refills at the next step boundary
                    self._free_slot(slot)
                    req._finish(_FINISH_ERROR)
                    continue
            if reserve is not None:
                try:
                    reserve(slot, eff_prompt, eff_budget)
                except PoolExhausted:
                    # no pages right now: park the request at the head of
                    # the deferred line and stop admitting this step —
                    # an active request's release is what unblocks it.
                    # _free_slot (not a bare table clear): the slot
                    # already pinned its adapter above, and leaking that
                    # reference would make the adapter un-evictable (and
                    # leave a stale prefix-cache salt on the slot)
                    self._free_slot(slot)
                    self._deferred.appendleft(req)
                    if self._tracer.enabled:
                        self._tracer.event(
                            "sched.defer", ctx=req.trace_ctx,
                            attrs={"request_id": req.request_id},
                        )
                    break
            if self._tracer.enabled:
                self._trace_phase(req, "sched.queue", req.submitted_at, t0)
            self._queue_wait_ms.observe(
                (t0 - req.submitted_at) * 1e3, trace_id=self._trace_id(req)
            )
            first = self._engine.prefill_request(
                slot, eff_prompt, req.temperature
            )
            now = time.monotonic()
            if self._tracer.enabled:
                # prefix-hit/cold, suffix bucket, adapter name — the
                # engine owns those facts; the hook keeps this module
                # torch-free (and stub-engine friendly)
                attrs_fn = getattr(
                    self._engine, "prefill_trace_attrs", None
                )
                self._trace_phase(
                    req, "sched.prefill", t0, now,
                    attrs=attrs_fn(slot) if attrs_fn is not None else None,
                )
            self._prefill_ms.observe(
                (now - t0) * 1e3, trace_id=self._trace_id(req)
            )
            req.first_token_at = now
            self._ttft_ms.observe(
                (now - req.submitted_at) * 1e3,
                trace_id=self._trace_id(req),
            )
            # a 1-token request (or instant EOS) frees the slot right here
            self._count_token(req, first)
        self._occupancy.set(len(self.active_slots))

    def _count_token(self, req, token):
        """Record one generated token for ``req`` (slot state lives in the
        engine's arrays); free the slot when the request is finished."""
        req.tokens.append(int(token))
        self._tokens_generated.inc()
        self._tokens_since_rate += 1
        reason = None
        if req.eos_token_id is not None and int(token) == int(req.eos_token_id):
            reason = _FINISH_EOS
        elif len(req.tokens) >= req.max_new_tokens:
            reason = _FINISH_MAX_NEW
        elif len(req.prompt_tokens) + len(req.tokens) >= self.max_seq_len:
            reason = _FINISH_LENGTH
        if reason is not None:
            self._free_slot(self._slots.index(req))
            self._completed.inc()
            req._finish(reason)

    def step(self):
        """One scheduler iteration: admit into free slots, then one decode
        step for every active slot. Returns the number of active slots
        decoded (0 = idle)."""
        # anchor the rate window BEFORE this step's work so its tokens
        # divide by the time that produced them (anchoring after the fact
        # inflated the gauge arbitrarily for sub-window runs)
        if self._rate_anchor is None:
            self._rate_anchor = time.monotonic()
            self._tokens_since_rate = 0
        # reclaim past-deadline slots FIRST: the freed slots are
        # admittable in this same step
        self._expire_deadlines()
        self._admit()
        self._ensure_decode_capacity()
        active = self.active_slots
        if not active:
            self._flush_rate()  # settle the window's tail tokens
            self._rate_anchor = None  # idle: don't dilute the next window
            return 0
        t0 = time.monotonic()
        next_tokens = self._engine.decode_tokens(active)
        t1 = time.monotonic()
        if self._tracer.enabled:
            # batch-level span: one decode step serves EVERY active slot,
            # so it parents to the driver's trace, not any one request
            if self._driver_ctx is None:
                self._driver_ctx = self._tracer.child_of(None)
            self._tracer.record(
                "sched.decode_step", t0, t1, ctx=self._driver_ctx,
                attrs={"active_slots": len(active), "step": self._steps},
            )
            # speculative engines report the step's draft/verify/commit
            # phase split (docs/observability.md): three sibling spans
            # under the driver trace, so flight-recorder dumps and the
            # bench's per-phase breakdown attribute the decode-step time
            stats = getattr(self._engine, "spec_step_stats", None)
            if stats is not None:
                self._tracer.record(
                    "sched.spec_draft", stats["draft_t0"],
                    stats["draft_t1"], ctx=self._driver_ctx,
                    attrs={"proposed": stats["proposed"]},
                )
                self._tracer.record(
                    "sched.spec_verify", stats["verify_t0"],
                    stats["verify_t1"], ctx=self._driver_ctx,
                    attrs={
                        "proposed": stats["proposed"],
                        "accepted": stats["accepted"],
                    },
                )
                self._tracer.record(
                    "sched.spec_commit", stats["commit_t0"],
                    stats["commit_t1"], ctx=self._driver_ctx,
                    attrs={"committed": stats["committed"]},
                )
        self._token_latency_ms.observe((t1 - t0) * 1e3)
        for slot, token in zip(active, next_tokens):
            req = self._slots[slot]
            if req is None:
                continue
            if isinstance(token, (list, tuple)):
                # speculative burst: the accepted draft prefix plus the
                # target's correction commit in order; tokens past a
                # finish (EOS / max_new / length cap) are discarded —
                # the freed slot's engine-side state resets at reuse
                for t in token:
                    if req.done:
                        break
                    self._count_token(req, t)
            else:
                self._count_token(req, token)
        self._occupancy.set(len(self.active_slots))
        self._update_health()
        self._steps += 1
        self._update_rate()
        if (
            self._telemetry is not None
            and self._telemetry.enabled
            and self._steps % self._export_interval == 0
        ):
            self._telemetry.export(step=self._steps)
        return len(active)

    def _update_rate(self):
        if self._rate_anchor is None:
            return
        now = time.monotonic()
        elapsed = now - self._rate_anchor
        if elapsed >= 0.25:  # smooth over at least a quarter second
            self._tokens_per_sec.set(self._tokens_since_rate / elapsed)
            self._tokens_since_rate = 0
            self._rate_anchor = now

    def _recover_driver_crash(self):
        """Post-decode-crash recovery (call under the drive lock): the
        in-flight requests' KV rows died with the crashed step, so they
        fail-finish with reason ``"error"``; the queue survives, and the
        engine rebuilds its decode state from the pinned params — the
        weights never left device, so recovery is a cache re-init, not a
        reload."""
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._free_slot(slot)
                req._finish(_FINISH_ERROR)
        reset = getattr(self._engine, "reset_decode_state", None)
        if reset is not None:
            reset()
        self._occupancy.set(0)

    def _step_recovering(self):
        """One driver step with crash auto-restart inside the configured
        budget; re-raises when the budget is exhausted (or zero — the
        legacy fail-fast behavior)."""
        try:
            return self.step()
        except Exception:
            # decode-driver crash: dump the flight recorder's last-N
            # spans/events BEFORE recovery scrambles the scene (no-op
            # when tracing is off)
            self._tracer.dump_flight("decode_driver_crash")
            if self._stop.is_set() or self.restarts_used >= self._restart_budget:
                raise
            self.restarts_used += 1
            self._driver_restarts.inc()
            logger.exception(
                "decode driver crashed; auto-restarting from pinned "
                "params (%d/%d restarts used; in-flight requests "
                "fail-finished, queue preserved)",
                self.restarts_used, self._restart_budget,
            )
            self._recover_driver_crash()
            return 0

    def run_until_idle(self):
        """Drive steps until no request is active or queued (the
        synchronous ``generate()`` path). Serialized: concurrent callers
        take turns as the driver instead of racing the slot table. Decode
        crashes auto-restart within ``driver_restart_budget``."""
        with self._drive_lock:
            while not self._stop.is_set() and (
                self._step_recovering()
                or not self._queue.empty()
                or self._deferred
            ):
                pass
            self._flush_rate()

    def _flush_rate(self):
        now = time.monotonic()
        if self._rate_anchor is not None and self._tokens_since_rate:
            elapsed = max(now - self._rate_anchor, 1e-9)
            self._tokens_per_sec.set(self._tokens_since_rate / elapsed)
            self._tokens_since_rate = 0
            self._rate_anchor = now

    # -- background serving ---------------------------------------------
    @property
    def driving(self):
        """True while a LIVE ``serve_forever`` thread owns the step loop
        (other threads must then WAIT on requests, never call step()). A
        crashed driver reads as not driving — its requests were already
        fail-finished."""
        return self._thread is not None and self._thread.is_alive()

    def serve_forever(self, idle_sleep=0.005):
        """Drive the scheduler on a daemon thread until :meth:`shutdown`
        (the long-running server mode; ``submit`` from any thread). A
        step that raises (device OOM, runtime error) auto-restarts the
        decode driver from the engine's pinned params while the
        ``driver_restart_budget`` lasts; past it the server stops,
        health goes draining, and everything outstanding fail-finishes —
        ``result()`` waiters get their answer instead of hanging on a
        dead loop."""
        if self.driving:
            return self._thread

        def loop():
            try:
                while not self._stop.is_set():
                    with self._drive_lock:
                        n = self._step_recovering()
                    if n == 0:
                        time.sleep(idle_sleep)
            except Exception:
                logger.exception(
                    "inference scheduler driver crashed (restart budget "
                    "%d/%d spent); rejecting new submissions and "
                    "cancelling outstanding requests",
                    self.restarts_used, self._restart_budget,
                )
                self.driver_failed = True
                self._stop.set()
                self._draining = True
                self._update_health()
                self._fail_finish_outstanding()

        self._stop.clear()
        self._thread = threading.Thread(
            target=loop, name="ds-infer-scheduler", daemon=True
        )
        self._thread.start()
        return self._thread

    def shutdown(self, timeout=5.0):
        """Stop the driver thread and FAIL-FINISH everything outstanding
        (reason ``"cancelled"``) — a ``result()`` waiter must never hang
        on a request the stopped loop will no longer advance. Subsequent
        ``submit`` calls raise :class:`RequestRejected`."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        # under the drive lock: a step that outlived join(timeout) (e.g.
        # a first-step compile) must not race the slot clear — waiters
        # would tear-read tokens the live step still appends to
        with self._drive_lock:
            self._fail_finish_outstanding()
        self._flush_rate()
        self._update_health()  # gauge lands on draining

    def _fail_finish_outstanding(self):
        while self._deferred:
            self._deferred.popleft()._finish(_FINISH_CANCELLED)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req._finish(_FINISH_CANCELLED)
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._free_slot(slot)
                req._finish(_FINISH_CANCELLED)
        self._queue_depth.set(0)
        self._occupancy.set(0)
