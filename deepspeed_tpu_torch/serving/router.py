"""FleetRouter: placement, admission, and lifecycle over N replicas.

Port of deepspeed_tpu/serving/router.py. The serving tier's brain (docs/serving.md). A submission passes
three gates, in order, before any replica queue is touched:

  1. admission  — per-tenant token bucket (admission.py): RateLimited.
  2. pressure   — fleet-wide queue fill past ``shed_queue_ratio`` sheds
                  priority > 0 classes: FleetOverloaded.
  3. placement  — a pluggable policy scores the routable replicas' load
                  snapshots and picks one; a replica that rejects at its
                  own door (queue full, raced a drain) is dropped from
                  the candidate set and placement retries the rest.

Placement policies (PLACEMENT_POLICIES): ``least_loaded`` scores
``queue_depth + active_slots`` (deterministic: ties break toward the
lower replica index), ``round_robin`` ignores load, and
``prefix_affinity`` hashes the prompt's first K tokens and sticks to the
replica that last served that prefix — the seam a cross-request prefix
cache (ROADMAP item 1) plugs into: affinity makes the cached prefill HOT
on exactly one replica instead of cold on all of them.

Lifecycle: ``drain`` steers traffic away while in-flight slots finish;
``rolling_restart`` drains and restarts replicas ONE at a time, refusing
to start if taking one replica out would drop routable capacity below
``ceil(capacity_floor * fleet)``; a replica whose decode driver fails
past its restart budget is EVICTED by the monitor and every request that
died with it is re-routed (bounded by ``max_reroutes``) — the fleet
answer for a request is delivered exactly once or failed loudly, never
duplicated and never silently dropped.

A background monitor thread (one per router) watches outstanding
requests, detects replica corpses, performs re-routes, and refreshes the
fleet/* telemetry streams through the same registry/exporter machinery
the engines use.
"""

import itertools
import math
import os
import signal
import threading
import time

from ..adapters.pool import AdapterUnavailable
from ..inference.scheduler import (
    REJECT_DEADLINE,
    REJECT_DRAINING,
    REJECT_FENCED,
    RequestRejected,
)
from ..resilience.faults import NULL_INJECTOR
from ..telemetry.registry import (
    DEFAULT_TIME_BUCKETS_MS,
    count_suppressed,
    histogram_quantile,
)
from ..telemetry.tracing import NOOP_TRACER, TraceContext
from ..utils.logging import logger
from .admission import AdmissionController, FleetOverloaded, RateLimited  # noqa: F401  (re-exported)
from .breaker import BREAKER_CLOSED, BREAKER_OPEN, build_breaker
from .replica import ReplicaRPCError

_FINISH_ERROR = "error"
_FINISH_CANCELLED = "cancelled"
# inner finish reasons that are a terminal ANSWER for the fleet request
# (everything else means "the replica died under it" and is re-routable)
_TERMINAL_REASONS = ("eos", "max_new_tokens", "length", "deadline")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def _load_score(snapshot):
    """Queue depth + busy slots: the cheapest proxy for 'how long until
    this replica gets to a new request'."""
    return snapshot["queue_depth"] + snapshot["active_slots"]


class LeastLoaded:
    """Deterministic least-loaded: min load score, ties to the earliest
    candidate (registration order) — the property the placement tests
    pin."""

    name = "least_loaded"

    def choose(self, candidates, prompt_tokens, context=None):
        del prompt_tokens, context
        best_i = min(
            range(len(candidates)),
            key=lambda i: (_load_score(candidates[i][1]), i),
        )
        return candidates[best_i][0]

    def forget(self, replica_id):
        pass


class RoundRobin:
    """Load-blind rotation over the candidate list."""

    name = "round_robin"

    def __init__(self):
        self._turn = itertools.count()

    def choose(self, candidates, prompt_tokens, context=None):
        del prompt_tokens, context
        return candidates[next(self._turn) % len(candidates)][0]

    def forget(self, replica_id):
        pass


class PrefixAffinity:
    """Prompt-prefix-hash affinity over a least-loaded base: identical
    templated prefixes (system prompts, few-shot headers) land on the
    replica that already served them — which, on paged replicas with the
    cross-request prefix cache (docs/inference.md "Paged KV cache"),
    means the prefix's pages are physically resident there and the
    request prefills only its unique suffix. ``last_hit`` reports whether
    the most recent choice was an affinity hit (the router's counter
    reads it). The affinity map is an LRU bounded at ``max_entries`` —
    high-cardinality traffic must not grow router memory without bound,
    and affinity only pays off for recently-hot prefixes anyway.

    Capacity-aware: a sticky replica whose snapshot reports an exhausted
    KV page pool (``kv_blocks_free == 0``) is SKIPPED for this placement
    — stickiness would bounce off its typed ``capacity`` rejection and
    fall through anyway; better to re-pin to a replica that can actually
    hold the request (the affinity entry moves with it)."""

    name = "prefix_affinity"

    def __init__(self, prefix_tokens=16, base=None, max_entries=65536):
        import collections

        self.prefix_tokens = int(prefix_tokens)
        self.max_entries = int(max_entries)
        self._base = base or LeastLoaded()
        self._affinity = collections.OrderedDict()
        self.last_hit = False

    def _key(self, prompt_tokens):
        return hash(tuple(prompt_tokens[: self.prefix_tokens]))

    def choose(self, candidates, prompt_tokens, context=None):
        del context
        key = self._key(prompt_tokens)
        sticky = self._affinity.get(key)
        for rid, snap in candidates:
            if rid == sticky:
                if snap.get("kv_blocks_free", 1) <= 0:
                    break  # out of KV pages: re-pin below
                self._affinity.move_to_end(key)
                self.last_hit = True
                return rid
        self.last_hit = False
        rid = self._base.choose(candidates, prompt_tokens)
        self._affinity[key] = rid
        self._affinity.move_to_end(key)
        while len(self._affinity) > self.max_entries:
            self._affinity.popitem(last=False)
        return rid

    def forget(self, replica_id):
        """Drop affinity entries for an evicted/departed replica so its
        traffic re-pins to a live one instead of falling back forever."""
        for key in [
            k for k, v in self._affinity.items() if v == replica_id
        ]:
            del self._affinity[key]


class AdapterAffinity:
    """Adapter-resident placement (docs/adapters.md): a request carrying
    ``adapter=name`` routes to a replica whose snapshot already reports
    that adapter in its device pool (``adapters_loaded``), least-loaded
    among the holders — landing where the weights are resident avoids a
    per-replica cold load and keeps the adapter's salted prefix pages
    hot on the same replica. Requests without an adapter (and adapters
    no replica holds) fall back to plain least-loaded; ``last_hit``
    mirrors PrefixAffinity's counted-on-placement contract."""

    name = "adapter_affinity"

    def __init__(self, base=None):
        self._base = base or LeastLoaded()
        self.last_hit = False

    def choose(self, candidates, prompt_tokens, context=None):
        adapter = (context or {}).get("adapter")
        if adapter is not None:
            holders = [
                c for c in candidates
                if adapter in (c[1].get("adapters_loaded") or ())
            ]
            if holders:
                self.last_hit = True
                return self._base.choose(holders, prompt_tokens)
        self.last_hit = False
        return self._base.choose(candidates, prompt_tokens)

    def forget(self, replica_id):
        pass


PLACEMENT_POLICIES = {
    "least_loaded": lambda cfg: LeastLoaded(),
    "round_robin": lambda cfg: RoundRobin(),
    "prefix_affinity": lambda cfg: PrefixAffinity(
        prefix_tokens=cfg.get("affinity_prefix_tokens", 16)
    ),
    "adapter_affinity": lambda cfg: AdapterAffinity(),
}


# moved to telemetry/registry.py (bench.py --infer shares it); the old
# name stays importable for existing callers
_histogram_quantile = histogram_quantile


# ---------------------------------------------------------------------------
# fleet request
# ---------------------------------------------------------------------------
class FleetRequest:
    """The router-side handle a fleet caller holds. Unlike an engine's
    InferenceRequest it can survive its replica: on a replica failure the
    router re-places the prompt (fresh decode — partial tokens from the
    dead replica are discarded, so the delivered answer is always one
    replica's complete generation)."""

    _ids = itertools.count()

    def __init__(self, prompt_tokens, tenant, kwargs):
        self.request_id = next(self._ids)
        self.prompt_tokens = [int(t) for t in prompt_tokens]
        self.tenant = tenant
        self.kwargs = dict(kwargs)
        # the fleet request's ROOT trace context (telemetry/tracing.py):
        # set by the router when tracing is armed; every replica-side
        # span for this request descends from its span_id
        self.trace_ctx = None
        self.tokens = []
        self.finish_reason = None
        self.replica_id = None
        self.reroutes = 0
        self.submitted_at = time.monotonic()
        # absolute end-to-end deadline: re-routes charge the time already
        # spent instead of restarting the clock on the new replica
        deadline_secs = self.kwargs.get("deadline_secs")
        self.deadline_at = (
            self.submitted_at + float(deadline_secs)
            if deadline_secs is not None else None
        )
        self._done = threading.Event()

    @property
    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block for the fleet answer. Raises RuntimeError when the fleet
        could not finish the request (its replicas died past the re-route
        budget, or the router shut down) — partial tokens never
        masquerade as an answer. A "deadline" finish returns the partial
        tokens, same contract as the single-engine path."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"fleet request {self.request_id} not finished after "
                f"{timeout}s"
            )
        if self.finish_reason in (_FINISH_ERROR, _FINISH_CANCELLED):
            raise RuntimeError(
                f"fleet request {self.request_id} {self.finish_reason} "
                f"after {self.reroutes} re-route(s)"
            )
        return self.tokens

    def _finish(self, tokens, reason):
        self.tokens = list(tokens)
        self.finish_reason = reason
        self._done.set()

    @classmethod
    def _reseed_ids(cls, floor):
        """Continue the door's request-id sequence past a recovered
        journal's high-water mark — adopted ids and new ids must never
        collide (the journal's in-flight table and the door's
        idempotency index both key on them)."""
        cls._ids = itertools.count(int(floor) + 1)

    @classmethod
    def _restore(cls, request_id, entry):
        """Rebuild a fleet request from its journaled descriptor (the
        adoption path): the EXPLICIT journaled id instead of a minted
        one, re-route budget already charged, and the end-to-end
        deadline re-anchored from its journaled wall-clock form."""
        req = cls.__new__(cls)
        req.request_id = int(request_id)
        req.prompt_tokens = [int(t) for t in entry.get("prompt") or ()]
        req.tenant = entry.get("tenant", "default")
        req.kwargs = dict(entry.get("kwargs") or {})
        req.trace_ctx = None
        req.tokens = []
        req.finish_reason = None
        req.replica_id = entry.get("replica")
        req.reroutes = int(entry.get("reroutes", 0))
        req.submitted_at = time.monotonic()
        deadline_unix = entry.get("deadline_unix")
        req.deadline_at = (
            time.monotonic() + (float(deadline_unix) - time.time())
            if deadline_unix is not None else None
        )
        req._done = threading.Event()
        return req


class _OrphanHandle:
    """Stand-in inner handle for a journaled in-flight request whose
    replica could NOT be adopted (dead node, replica left the roster):
    already dead-on-arrival, so the monitor's outstanding sweep re-places
    it through the ordinary re-route budget — the same path a replica
    death in THIS life takes."""

    done = True
    finish_reason = _FINISH_ERROR
    first_token_at = None

    def __init__(self):
        self.tokens = []


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
class FleetRouter:
    """Routes submissions over ``replicas`` (a list of Replica objects,
    replica.py). Construct directly for programmatic fleets or through
    :func:`deepspeed_tpu_torch.serving.init_fleet` for config-driven ones."""

    def __init__(self, replicas, *, placement="least_loaded",
                 affinity_prefix_tokens=16, capacity_floor=0.5,
                 shed_queue_ratio=0.75, max_reroutes=2,
                 rate_limit=(None, 1), per_tenant_limits=None,
                 registry=None, telemetry=None, clock=time.monotonic,
                 monitor_interval=0.002, telemetry_refresh_secs=0.25,
                 tracer=None, breaker_failure_threshold=3,
                 breaker_backoff_secs=0.5, breaker_backoff_max_secs=30.0,
                 zombie_secs=0.0, zombie_restart_budget=2,
                 brownout_queue_ratio=None, brownout_max_new_tokens=16,
                 fault_injector=None, autoscaler=None, hub=None,
                 journal=None, recovered=None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        from ..telemetry.manager import register_serving_metrics
        from ..telemetry.registry import MetricsRegistry

        self._replicas = {r.replica_id: r for r in replicas}
        if len(self._replicas) != len(replicas):
            raise ValueError("replica ids must be unique")
        self._order = [r.replica_id for r in replicas]
        self._routable = set()
        self._evicted = set()
        self._outstanding = {}  # request_id -> (FleetRequest, inner, rid)
        self._lock = threading.RLock()
        self._clock = clock
        self.capacity_floor = float(capacity_floor)
        self.shed_queue_ratio = float(shed_queue_ratio)
        self.max_reroutes = int(max_reroutes)
        # chaos sites the router itself hosts (router.place); NULL unless
        # the config armed one (resilience/faults.py)
        self._faults = (
            fault_injector if fault_injector is not None else NULL_INJECTOR
        )
        # durable control plane (journal.py, docs/serving.md
        # "Control-plane durability"): None = feature off, no journal
        # files, zero write-path work. ``recovered`` is an AdoptionPlan
        # from plan_adoption(); start() completes it — until the first
        # full telemetry refresh after that, readiness() reports
        # "recovering" so an external LB holds traffic off a fleet whose
        # adopted state is still settling.
        self._journal = journal
        self._recovered = recovered
        self._recovering = recovered is not None
        self._last_autoscaler_snap = None
        # door idempotency: key -> live FleetRequest, so a retried POST
        # attaches to the in-flight generation instead of re-running it
        # (terminal results replay from the door's own LRU, http.py)
        self._idem_index = {}
        if recovered is not None and recovered.state is not None:
            # adopted ids and freshly minted ids share one sequence
            FleetRequest._reseed_ids(
                recovered.state.get("request_seq", -1)
            )
            # the journaled fleet-wide adapter registry replays into the
            # restart/add_replica paths — adopted node engines still hold
            # their weights; a replica REBUILT after adoption must re-hear
            # the loads exactly as in the previous life
            self._adapter_registry_seed = dict(
                recovered.state.get("adapters") or {}
            )
        else:
            self._adapter_registry_seed = {}
        # per-replica circuit breakers (breaker.py): fed by submit-path
        # outcomes, filtered on in _candidates — an open replica costs
        # placement nothing instead of a doomed submit + re-route.
        # (kwargs kept: add_replica builds late-joining replicas'
        # breakers from the same recipe)
        self._breaker_kwargs = dict(
            failure_threshold=breaker_failure_threshold,
            backoff_secs=breaker_backoff_secs,
            backoff_max_secs=breaker_backoff_max_secs,
            clock=clock,
        )
        self._breakers = {
            rid: build_breaker(rid, **self._breaker_kwargs)
            for rid in self._order
        }
        # zombie detection (monitor loop): rid -> (progress marker, stamp)
        self.zombie_secs = float(zombie_secs)
        self.zombie_restart_budget = int(zombie_restart_budget)
        self._progress = {}
        # the sweep costs one snapshot RPC per routable replica: pace it
        # well under the detection window instead of every monitor tick
        self._zombie_sweep_secs = max(
            self.zombie_secs / 5.0, float(monitor_interval)
        )
        self._last_zombie_sweep = 0.0
        self._zombie_restarts_used = {rid: 0 for rid in self._order}
        # replicas the router itself condemned (restart loop exhausted,
        # zombie budget spent): swept by _sweep_failed_replicas exactly
        # like a dead decode driver
        self._force_failed = set()
        # epoch fencing (docs/serving.md "Epoch fencing"): latched when
        # any node rejects this router's incarnation epoch — a NEWER
        # incarnation owns the fleet, and this one stands down loudly
        # (readiness "fenced_out", submit refusals) instead of
        # double-executing requests the live router is also running
        self._fenced = False
        # brownout degradation state (docs/serving.md "Brownout"):
        # None = feature off; active state flips on the fleet queue fill
        self.brownout_queue_ratio = (
            None if brownout_queue_ratio is None
            else float(brownout_queue_ratio)
        )
        self.brownout_max_new_tokens = int(brownout_max_new_tokens)
        self._brownout = False
        # transitions are check-then-act + a per-replica toggle fan-out,
        # raced by submit threads and the monitor's refresh: serialized
        # on a dedicated lock so state/gauge/replica toggles can't end
        # up mutually inconsistent (a latched half-transition would skip
        # prefix registration fleet-wide until the next crossing)
        self._brownout_lock = threading.Lock()
        if isinstance(placement, str):
            if placement not in PLACEMENT_POLICIES:
                raise ValueError(
                    f"unknown placement policy {placement!r}; valid: "
                    f"{sorted(PLACEMENT_POLICIES)}"
                )
            placement = PLACEMENT_POLICIES[placement](
                {"affinity_prefix_tokens": affinity_prefix_tokens}
            )
        self.placement = placement
        # serializes placement-state access: choose() + the last_hit read
        # in _place (concurrent submit threads), and forget() from the
        # monitor's eviction sweep — policies keep mutable affinity maps
        self._placement_lock = threading.Lock()
        self._admission = AdmissionController(
            default_limit=tuple(rate_limit),
            per_tenant=per_tenant_limits, clock=clock,
        )
        self.routed_counts = {rid: 0 for rid in self._order}
        # fleet adapter registry: adapters loaded FLEET-WIDE are recorded
        # (name -> load kwargs) and replayed onto every replica a restart
        # rebuilds — a rolling restart must not silently shed the tenants'
        # weights (docs/adapters.md). Targeted loads (replica_ids=...)
        # stay the caller's business.
        self._adapter_registry = dict(self._adapter_registry_seed)
        self._draining = False
        self._stop = threading.Event()
        self._monitor = None
        self._monitor_interval = float(monitor_interval)
        self._telemetry = telemetry
        # fleet-level request tracer (telemetry/tracing.py): the router
        # opens each fleet request's root span, records admission /
        # placement / re-route children, and INGESTS the replica-side
        # spans shipped back over the worker RPC so one trace file holds
        # the whole request. NOOP passthrough unless armed.
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self._telemetry_refresh_secs = float(telemetry_refresh_secs)
        # anchored at construction so the monitor's FIRST tick does not
        # race start()'s explicit refresh with a redundant snapshot
        # sweep of its own — the cadence means "every N seconds", not
        # "and once immediately"
        self._last_refresh = float(clock())
        self._refreshes = 0
        # refreshes run from the monitor thread AND lifecycle/test
        # callers; the exporters' atomic tmp+rename writes must not race
        self._refresh_lock = threading.Lock()
        self._preemption = None

        self.metrics = register_serving_metrics(
            registry if registry is not None else MetricsRegistry()
        )
        reg = self.metrics
        self._ttft = reg.histogram(
            "fleet/ttft_ms", buckets=DEFAULT_TIME_BUCKETS_MS
        )
        self._ttft_p50 = reg.gauge("fleet/ttft_p50_ms")
        self._ttft_p99 = reg.gauge("fleet/ttft_p99_ms")
        self._shed_total = reg.gauge("fleet/requests_shed")
        self._routed = reg.counter("fleet/requests_routed")
        self._rerouted = reg.counter("fleet/requests_rerouted")
        self._completed = reg.counter("fleet/requests_completed")
        self._rate_limited = reg.counter("fleet/requests_rate_limited")
        self._rejected = reg.counter("fleet/requests_rejected")
        self._affinity_hits = reg.counter("fleet/affinity_hits")
        self._restarts = reg.counter("fleet/replica_restarts")
        self._evictions = reg.counter("fleet/replicas_evicted")
        self._adapter_loads = reg.counter("fleet/adapter_loads")
        self._breaker_opens = reg.counter("fleet/breaker_opens")
        self._breaker_probes = reg.counter("fleet/breaker_probes")
        self._zombie_restarts = reg.counter("fleet/zombie_restarts")
        self._brownout_gauge = reg.gauge("fleet/brownout")
        self._browned_out = reg.counter("fleet/requests_browned_out")
        self._adopted_gauge = reg.gauge("fleet/adopted_replicas")
        # the SLO autoscaler (autoscaler.py): None = feature off, zero
        # overhead, no new threads — the monitor tick checks and moves on
        self._autoscaler = autoscaler
        if autoscaler is not None:
            autoscaler.attach(self)
        # the fleet observability plane (telemetry/hub.py): same
        # discipline — None = no scrape threads, no ring, and the HTTP
        # door's /metrics //statz //dashboard routes 404
        self.hub = hub
        if hub is not None:
            hub.attach(self)

    # -- lifecycle ------------------------------------------------------
    def start(self):
        """Start every replica (engines build, drivers spin up) and the
        monitor thread; returns self. A router built over an adoption
        plan (``recovered``) completes the adoption here: the replica
        starts above resumed their journaled node sessions, so their
        pre-registered in-flight handles bind into the outstanding table
        before the monitor's first sweep can look."""
        for rid in self._order:
            self._replicas[rid].start()
        with self._lock:
            self._routable.update(self._order)
        self._complete_adoption()
        if self._journal is not None:
            # write-ahead the live memberships: each replica's session
            # descriptor (client token, rpc high-water mark) is what the
            # NEXT router life presents to resume the node session
            for rid in self._order:
                self._journal_replica(rid)
            if self._brownout:
                self._journal.set_brownout(True)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="ds-fleet-monitor", daemon=True
        )
        self._monitor.start()
        self.refresh_telemetry()
        return self

    def _complete_adoption(self):
        """Finish the crash-recovery adoption (docs/serving.md
        "Control-plane durability"): probation-arm the adopted replicas'
        breakers, bind the nodes' resumed in-flight handles to restored
        fleet requests, park un-adoptable descriptors as dead-on-arrival
        orphans for the re-route sweep, and replay journaled brownout /
        autoscaler state. Runs once, from start(), after the replicas
        resumed their node sessions."""
        plan, self._recovered = self._recovered, None
        if plan is None:
            return
        state = plan.state or {}
        # brownout replays FIRST: the adopted node engines kept serving
        # while the router was dead and must re-hear the degrade toggle
        # before traffic lands (the next refresh recomputes the real
        # fill ratio and exits the band if the queue drained meanwhile)
        if state.get("brownout") and self.brownout_queue_ratio is not None:
            with self._brownout_lock:
                self._brownout = True
                self._brownout_gauge.set(1.0)
            for rid in self._order:
                if rid not in self._evicted:
                    self._set_replica_brownout(rid, True)
        # adopted replicas re-earn trust through the half-open probation
        # window: journaled breaker counts are deliberately NOT restored
        # (the new life's first request IS the probe)
        adopted = [
            rid for rid in plan.adopted_ids if rid in self._replicas
        ]
        for rid in adopted:
            breaker = self._breakers.get(rid)
            if breaker is not None:
                breaker.begin_probation()
        self._adopted_gauge.set(len(adopted))
        # bind each adopted replica's pre-registered handles into the
        # outstanding table: completions that finished while the router
        # was dead DELIVER from the node outbox on the first sweep;
        # requests the node forgot fail-finished at resume and re-route
        bound = set()
        for replica in plan.replicas:
            rid = replica.replica_id
            if rid not in self._replicas:
                continue
            handles = replica.adopted_handles()
            for req_id, entry in sorted(plan.inflight.items()):
                if str(entry.get("replica")) != str(rid):
                    continue
                inner = handles.get(entry.get("rpc_id"))
                if inner is None:
                    continue
                fleet_req = FleetRequest._restore(req_id, entry)
                with self._lock:
                    self._outstanding[req_id] = (fleet_req, inner, rid)
                    if entry.get("idem"):
                        self._idem_index[entry["idem"]] = fleet_req
                bound.add(req_id)
        # descriptors with no adopted handle (dead node, replica left
        # the roster): dead-on-arrival — the monitor's sweep re-places
        # them under the ordinary ``max_reroutes`` budget
        orphans = 0
        for req_id, entry in sorted(plan.inflight.items()):
            if req_id in bound:
                continue
            fleet_req = FleetRequest._restore(req_id, entry)
            with self._lock:
                self._outstanding[req_id] = (
                    fleet_req, _OrphanHandle(), entry.get("replica")
                )
                if entry.get("idem"):
                    self._idem_index[entry["idem"]] = fleet_req
            orphans += 1
        for rid, reason in plan.lost_replicas:
            logger.warning(
                "fleet journal: membership %s NOT adopted (%s); its "
                "in-flight requests re-place", rid, reason,
            )
            if self._journal is not None:
                self._journal.forget_replica(rid)
        if self._autoscaler is not None and state.get("autoscaler"):
            self._autoscaler.restore_journal(state["autoscaler"])
        logger.info(
            "fleet journal: adopted %d replica session(s), restored %d "
            "in-flight request(s) (%d orphaned to re-route)",
            len(adopted), len(bound) + orphans, orphans,
        )

    def _journal_replica(self, rid):
        """Write-ahead one replica's membership + live session handle
        (client token, rpc-id high-water mark) — what the next router
        life presents to resume the node session. Replicas without a
        socket address journal as non-adoptable memberships."""
        if self._journal is None:
            return
        replica = self._replicas.get(rid)
        if replica is None:
            return
        self._journal.record_replica(
            rid,
            node=getattr(replica, "node_id", None),
            address=getattr(replica, "address", None),
            remote_name=getattr(replica, "remote_name", None),
            client=getattr(replica, "client_token", None),
            rpc_seq=getattr(replica, "rpc_seq", 0),
        )

    def find_inflight(self, idempotency_key):
        """The fleet request holding ``idempotency_key`` — the door's
        attach path for a retried POST: a live request means "attach to
        the in-flight generation", a finished one means "replay its
        terminal result" (the crash-recovery case where the first
        attempt completed before the client retried), None means the key
        was never seen (or aged out) and the POST runs fresh."""
        with self._lock:
            return self._idem_index.get(str(idempotency_key))

    def shutdown(self, timeout=30.0):
        """Stop the monitor, shut every replica down, and fail-finish
        outstanding fleet requests — a waiter never hangs on a dead
        fleet."""
        self._stop.set()
        if self._autoscaler is not None:
            # wait out an in-flight scale op BEFORE tearing replicas
            # down: a spawn landing mid-teardown would leak its engine
            self._autoscaler.close(timeout)
        if self.hub is not None:
            # stop scraping before nodes disappear under the hub (a
            # scrape racing teardown is just noise in the failure
            # counters)
            self.hub.close(timeout)
        if self._monitor is not None:
            self._monitor.join(timeout)
            if self._monitor.is_alive():
                # a join that times out is NOT a clean shutdown: the
                # monitor is wedged (stuck RPC, hung restart) and may
                # still touch replicas while we tear them down — say so
                # and count it instead of returning as if clean
                logger.warning(
                    "fleet: monitor thread still alive after the %.1fs "
                    "shutdown join; proceeding with teardown around it",
                    timeout,
                )
                count_suppressed("serving.router.monitor_join_timeout")
            self._monitor = None
        for rid in list(self._order):
            if rid not in self._evicted:
                replica = self._replicas.get(rid)
                if replica is not None:
                    replica.shutdown()
        with self._lock:
            orphans = [fr for fr, _inner, _rid in self._outstanding.values()]
            self._outstanding.clear()
        for fr in orphans:
            if self._journal is not None:
                # a graceful shutdown's cancellations are terminal: the
                # next life must not adopt (and re-run) them
                self._journal.close_request(fr.request_id)
            self._trace_finish_root(fr, _FINISH_CANCELLED)
            fr._finish(fr.tokens, _FINISH_CANCELLED)
        if self._preemption is not None:
            self._preemption.uninstall()
            self._preemption = None
        self.refresh_telemetry()
        if self._telemetry is not None and self._telemetry.enabled:
            self._telemetry.export(step=self._refreshes)
            self._telemetry.close()
        # idempotent: the telemetry close above already closed a tracer
        # it owns; a standalone-built tracer closes here
        self.tracer.close()

    def install_preemption_drain(self, signals=("SIGTERM", "SIGINT")):
        """Reuse the resilience PreemptionHandler (resilience/preemption.py)
        as the fleet's drain trigger: the signal ARMS a flag, the monitor
        thread notices at its next tick and drains the whole fleet —
        in-flight requests finish, new submissions shed with reason
        "draining" — instead of dying mid-decode. Returns the handler
        (cooperative ``arm()`` works when handlers cannot install)."""
        from ..resilience.preemption import PreemptionHandler

        self._preemption = PreemptionHandler(
            signals=signals, exit_after_save=False
        )
        self._preemption.install()
        return self._preemption

    def drain_fleet(self):
        """Stop admitting fleet-wide; every replica finishes what it
        holds (the graceful ramp before shutdown())."""
        self._draining = True
        for rid in list(self._routable_ids()):
            self.drain(rid)

    def drain(self, replica_id):
        """Steer new traffic away from ``replica_id`` and let its queued
        and in-flight requests run to completion. One-way: a drained
        replica rejoins service through :meth:`restart_replica`."""
        replica = self._replicas[replica_id]
        with self._lock:
            self._routable.discard(replica_id)
        replica.drain()

    def restart_replica(self, replica_id, wait_timeout=60.0,
                        restart_attempts=3):
        """Drain ``replica_id``, wait for it to go idle, rebuild it, and
        return it to the routable set. A rebuild that RAISES (flapping
        replica: chaos site ``replica.flap``, OOM-on-init, bad worker
        spec) is retried with backoff up to ``restart_attempts`` times;
        exhausting them condemns the replica to the monitor's eviction
        sweep instead of leaving it in an unroutable limbo. Returns True
        when the replica rejoined."""
        replica = self._replicas[replica_id]
        self.drain(replica_id)
        if not replica.wait_idle(wait_timeout):
            logger.warning(
                "fleet: replica %s did not drain within %.1fs; restarting "
                "anyway (outstanding requests will re-route)",
                replica_id, wait_timeout,
            )
        restarted = False
        for attempt in range(max(int(restart_attempts), 1)):
            try:
                replica.restart()
                restarted = True
                break
            except Exception as e:
                logger.warning(
                    "fleet: replica %s restart attempt %d/%d failed: %r",
                    replica_id, attempt + 1, restart_attempts, e,
                )
                count_suppressed("serving.replica_restart_failed", e)
                time.sleep(0.05 * (2.0 ** attempt))
        if not restarted:
            logger.error(
                "fleet: replica %s failed every restart attempt; "
                "condemning it to eviction", replica_id,
            )
            self.tracer.event(
                "router.restart_failed", attrs={"replica": replica_id}
            )
            with self._lock:
                self._force_failed.add(replica_id)
            return False
        # a rebuilt replica starts with an EMPTY adapter pool: replay the
        # fleet-wide registry before traffic routes back to it, so tenant
        # requests never bounce off a restarted replica
        for name, kwargs in list(self._adapter_registry.items()):
            try:
                replica.load_adapter(name, **kwargs)
                self._adapter_loads.inc()
            except Exception as e:
                logger.exception(
                    "fleet: reloading adapter %r onto restarted replica "
                    "%s failed; its requests will fail on this replica",
                    name, replica_id,
                )
                count_suppressed("serving.adapter_replay_failed", e)
        self._restarts.inc()
        # a rebuilt replica is a fresh start for its breaker too
        self._breakers[replica_id].record_success()
        # and it must re-hear the current brownout state (a worker
        # restart forgets the toggle)
        if self._brownout:
            self._set_replica_brownout(replica_id, True)
        with self._lock:
            self._evicted.discard(replica_id)
            self._routable.add(replica_id)
            self._force_failed.discard(replica_id)
        self._progress.pop(replica_id, None)
        # a rebuilt socket replica minted a FRESH session (new client
        # token, rpc ids from 1): the journal must carry the new handle
        self._journal_replica(replica_id)
        self.refresh_telemetry()
        return True

    def rolling_restart(self, wait_timeout=60.0):
        """Drain + restart every live replica, ONE at a time, never
        letting routable capacity drop below ``ceil(capacity_floor *
        fleet_size)``. Raises RuntimeError up front when the floor makes
        a rolling restart impossible (the config error should surface
        loudly, not as a fleet that silently skipped its restart)."""
        ids = [rid for rid in self._order if rid not in self._evicted]
        floor = math.ceil(self.capacity_floor * len(ids))
        if len(ids) - 1 < floor:
            raise RuntimeError(
                f"rolling restart impossible: {len(ids)} replicas with a "
                f"capacity floor of {floor} leaves no replica free to "
                f"drain (lower serving.capacity_floor or add replicas)"
            )
        for rid in ids:
            while len(self._routable_ids()) - 1 < floor:
                # another drain (operator, preemption) is holding capacity
                # down — wait for it rather than breach the floor; a
                # fleet-wide drain empties _routable permanently, so bail
                # out instead of spinning forever
                if self._stop.is_set() or self._draining:
                    return
                time.sleep(self._monitor_interval)
            if self._stop.is_set() or self._draining:
                return
            self.restart_replica(rid, wait_timeout=wait_timeout)
        self.refresh_telemetry()

    # -- elastic capacity (docs/serving.md "SLO autoscaling") -----------
    def live_replica_ids(self):
        """Registered, non-evicted replica ids — the autoscaler's live
        capacity count (draining replicas still count until removed)."""
        with self._lock:
            return [rid for rid in self._order if rid not in self._evicted]

    def add_replica(self, replica, *, probation=True):
        """Register a replica built AFTER construction — the
        autoscaler's scale-up / re-provision path (also usable
        directly for operator-driven capacity adds). ``replica`` must
        already be started (engine serving).

        The fleet-wide adapter registry replays onto it BEFORE it joins
        placement (a tenant's request must never bounce off the new
        capacity), the current brownout state propagates, and with
        ``probation`` (the default) its circuit breaker arms the
        half-open probe gate: the first submission is the window's one
        probe, so a half-built or misconfigured replica costs the fleet
        at most one request instead of a queue of them."""
        rid = replica.replica_id
        with self._lock:
            if rid in self._replicas and rid not in self._evicted:
                raise ValueError(
                    f"replica id {rid!r} is already registered"
                )
        for name, kwargs in list(self._adapter_registry.items()):
            try:
                replica.load_adapter(name, **kwargs)
                self._adapter_loads.inc()
            except Exception as e:
                logger.exception(
                    "fleet: replaying adapter %r onto new replica %s "
                    "failed; its requests will fail on this replica",
                    name, rid,
                )
                count_suppressed("serving.adapter_replay_failed", e)
        breaker = build_breaker(rid, **self._breaker_kwargs)
        if probation:
            breaker.begin_probation()
        with self._lock:
            self._replicas[rid] = replica
            if rid not in self._order:
                self._order.append(rid)
            self._breakers[rid] = breaker
            self._zombie_restarts_used.setdefault(rid, 0)
            self.routed_counts.setdefault(rid, 0)
            self._evicted.discard(rid)
            self._force_failed.discard(rid)
            self._routable.add(rid)
        self._progress.pop(rid, None)
        if self._brownout:
            self._set_replica_brownout(rid, True)
        self._journal_replica(rid)
        logger.info(
            "fleet: replica %s registered%s (%d live)", rid,
            " behind its half-open probation probe" if probation else "",
            len(self.live_replica_ids()),
        )
        self.refresh_telemetry()
        return replica

    def remove_replica(self, replica_id, *, wait_idle_timeout=30.0):
        """Drain + deregister one replica — the autoscaler's scale-down
        path: traffic steers away, queued and in-flight work finishes
        (bounded by ``wait_idle_timeout``; stragglers fail-finish at the
        replica's shutdown and the sweep re-routes them), then the
        replica pops from every router structure and its
        ``fleet/replica{id}/*`` gauges retire. Returns the popped
        Replica — the caller (the autoscaler's provider) owns its
        shutdown and any node-side engine teardown. Refuses to empty
        the fleet."""
        with self._lock:
            if replica_id not in self._replicas:
                raise ValueError(f"no replica {replica_id!r} registered")
            live = [r for r in self._order if r not in self._evicted]
            if replica_id in live and len(live) <= 1:
                raise RuntimeError(
                    "cannot remove the last live replica — a fleet "
                    "needs at least one"
                )
        self.drain(replica_id)
        replica = self._replicas[replica_id]
        if not replica.wait_idle(wait_idle_timeout):
            logger.warning(
                "fleet: replica %s did not drain within %.1fs; removing "
                "anyway (outstanding requests will re-route)",
                replica_id, wait_idle_timeout,
            )
        if self._journal is not None:
            # write-ahead: the membership leaves the journal BEFORE the
            # router forgets it — a crash mid-removal must not adopt a
            # replica the autoscaler already owns the teardown of
            self._journal.forget_replica(replica_id)
        with self._lock:
            self._replicas.pop(replica_id, None)
            if replica_id in self._order:
                self._order.remove(replica_id)
            self._routable.discard(replica_id)
            self._evicted.discard(replica_id)
            self._force_failed.discard(replica_id)
            self._breakers.pop(replica_id, None)
            self._zombie_restarts_used.pop(replica_id, None)
            self.routed_counts.pop(replica_id, None)
        self._progress.pop(replica_id, None)
        with self._placement_lock:
            self.placement.forget(replica_id)
        self._retire_replica_gauges(replica_id)
        logger.info(
            "fleet: replica %s removed (%d live)", replica_id,
            len(self.live_replica_ids()),
        )
        self.refresh_telemetry()
        return replica

    def _retire_replica_gauges(self, replica_id):
        """Drop every ``fleet/replica{id}/*`` stream from the registry:
        a replica that left the fleet (eviction, scale-down) must stop
        exporting its stale last values — a dashboard reading a dead
        replica's frozen queue depth as live data is worse than a gap.
        Serialized against the monitor's refresh: a refresh that read
        this replica's snapshot before removal would otherwise re-mint
        the gauges AFTER the retire, resurrecting the dead streams."""
        with self._refresh_lock:
            self.metrics.remove_prefix(f"fleet/replica{replica_id}/")

    # -- adapter registry (docs/adapters.md) ----------------------------
    def load_adapter(self, name, replica_ids=None, **kwargs):
        """Install LoRA adapter ``name`` on the named (default: every
        non-evicted) replicas — the fleet's adapter registry write path.
        ``kwargs`` pass to the replica's ``load_adapter`` (``load_dir``
        for checkpoint-backed loads — the only cross-process form;
        ``adapter_state`` additionally works in-process). Returns
        ``{replica_id: pool row}``; a per-replica failure aborts with the
        partial result attached (``exc.partial``) so the caller can
        retry or roll back the replicas that did load. Fleet-wide loads
        register so restarts REPLAY them onto rebuilt replicas."""
        fleet_wide = replica_ids is None
        if replica_ids is None:
            replica_ids = [
                rid for rid in self._order if rid not in self._evicted
            ]
        results = {}
        for rid in replica_ids:
            try:
                results[rid] = self._replicas[rid].load_adapter(
                    name, **kwargs
                )
            except Exception as e:
                e.partial = dict(results)
                raise
        if fleet_wide:
            if self._journal is not None:
                # write-ahead: a crash between the journal commit and the
                # registry write re-registers on recovery (idempotent);
                # the reverse order would silently shed tenants' weights
                self._journal.record_adapter(name, kwargs)
            self._adapter_registry[name] = dict(kwargs)
        self._adapter_loads.inc(len(results))
        self.refresh_telemetry()
        return results

    def unload_adapter(self, name, replica_ids=None):
        """Evict adapter ``name`` from the named (default: all
        non-evicted) replicas; replicas refusing (live requests) raise.
        Returns ``{replica_id: freed pool row}``."""
        if replica_ids is None:
            if self._journal is not None:
                self._journal.forget_adapter(name)
            self._adapter_registry.pop(name, None)
            replica_ids = [
                rid for rid in self._order if rid not in self._evicted
            ]
        results = {}
        for rid in replica_ids:
            try:
                results[rid] = self._replicas[rid].unload_adapter(name)
            except Exception as e:
                e.partial = dict(results)
                raise
        self.refresh_telemetry()
        return results

    # -- submission -----------------------------------------------------
    def submit(self, prompt_tokens, tenant="default", priority=0,
               idempotency_key=None, **kwargs):
        """Admit + place one request; returns a :class:`FleetRequest`.

        ``idempotency_key`` (the door's ``Idempotency-Key`` header)
        registers the request in the router's in-flight index so a
        retried POST can attach to the live generation via
        :meth:`find_inflight`, and rides the journal descriptor so the
        attach survives a router crash.

        Raises :class:`RateLimited` (tenant bucket empty),
        :class:`FleetOverloaded` (no replica can take it / pressure shed
        of priority > 0), or :class:`RequestRejected` with reason
        ``"draining"`` (fleet draining or shut down) or ``"deadline"``
        (the request's ``deadline_secs`` is shorter than even the
        fastest candidate's observed prefill — no replica could answer
        in time, so it is rejected at the ROUTER's door instead of
        burning a replica queue slot on a guaranteed miss). ``kwargs``
        pass through to the replica scheduler's submit (max_new_tokens,
        temperature, deadline_secs, ...)."""
        if self._fenced:
            # stand-down is absolute: a stale incarnation that kept
            # serving would double-execute requests the live router is
            # also running (docs/serving.md "Epoch fencing")
            self._rejected.inc()
            self._trace_reject(REJECT_FENCED, tenant)
            raise RequestRejected(
                "router incarnation fenced out: a newer incarnation "
                "owns this fleet; this router is standing down",
                reason=REJECT_FENCED,
            )
        if self._stop.is_set() or self._draining:
            self._rejected.inc()
            self._trace_reject(REJECT_DRAINING, tenant)
            raise RequestRejected(
                "fleet is draining; not admitting new requests",
                reason=REJECT_DRAINING,
            )
        try:
            self._admission.admit(tenant)
        except RateLimited:
            self._rate_limited.inc()
            self._rejected.inc()
            self._trace_reject("rate_limit", tenant)
            raise
        fleet_req = FleetRequest(prompt_tokens, tenant, kwargs)
        fleet_req.kwargs.setdefault("priority", priority)
        if self.tracer.enabled:
            # root trace: the span id pre-allocated here is what every
            # admission/placement child — and, over the RPC, the serving
            # replica's scheduler spans — parent to
            fleet_req.trace_ctx = self.tracer.child_of(None)
        candidates = self._candidates()
        if not candidates:
            self._rejected.inc()
            self._trace_reject("overload", tenant)
            raise FleetOverloaded(
                "no routable replica (all draining, restarting, or "
                "evicted)"
            )
        deadline = kwargs.get("deadline_secs")
        if deadline is not None and float(deadline) > 0:
            fastest = min(s["mean_prefill_ms"] for _rid, s in candidates)
            if fastest > 0 and float(deadline) * 1e3 <= fastest:
                self._rejected.inc()
                self._trace_reject(REJECT_DEADLINE, tenant)
                raise RequestRejected(
                    f"deadline {float(deadline) * 1e3:.0f}ms is below the "
                    f"fastest candidate's observed prefill "
                    f"({fastest:.0f}ms): unmeetable fleet-wide",
                    reason=REJECT_DEADLINE,
                )
        fill = sum(s["queue_depth"] for _rid, s in candidates)
        cap = sum(s["queue_capacity"] for _rid, s in candidates)
        if priority > 0 and cap > 0 and fill >= self.shed_queue_ratio * cap:
            self._rejected.inc()
            self._trace_reject("overload", tenant)
            raise FleetOverloaded(
                f"fleet queue fill {fill}/{cap} past the shed ratio "
                f"{self.shed_queue_ratio}: shedding priority-"
                f"{priority} submission"
            )
        # brownout band (docs/serving.md): between brownout_queue_ratio
        # and the shed ratio the fleet DEGRADES sheddable traffic instead
        # of growing the queue toward the cliff — the generation budget
        # clamps to the configured floor (and replicas skip prefix-miss
        # registration work), so throughput bends rather than cliffs
        brownout = self._update_brownout(fill / cap if cap > 0 else 0.0)
        if brownout and priority > 0:
            requested = int(fleet_req.kwargs.get("max_new_tokens", 32))
            if requested > self.brownout_max_new_tokens:
                fleet_req.kwargs["max_new_tokens"] = (
                    self.brownout_max_new_tokens
                )
                self._browned_out.inc()
        if self.tracer.enabled and fleet_req.trace_ctx is not None:
            # admission verdict span: rate-limit + pressure + deadline
            # gates all passed (rejections record flight-recorder events
            # instead — they have no replica-side continuation)
            self.tracer.record(
                "router.admission", fleet_req.submitted_at,
                time.monotonic(), ctx=fleet_req.trace_ctx,
                attrs={"tenant": tenant, "priority": int(priority),
                       "verdict": "admitted"},
            )
        inner, rid = self._place(fleet_req, candidates)
        if inner is None:
            self._rejected.inc()
            self._trace_reject("overload", tenant)
            raise FleetOverloaded(
                "every routable replica rejected the request at its own "
                "door (queues full)"
            )
        if self._journal is not None:
            # write-ahead the placement BEFORE the outstanding insert: a
            # crash from here on finds the descriptor and adopts (or
            # re-places) the request; a crash before here never admitted
            # it, so the client's retry re-runs it — exactly-once either
            # way. Never per token: this is the request's one open write.
            self._journal.open_request(
                fleet_req.request_id,
                prompt=fleet_req.prompt_tokens,
                tenant=fleet_req.tenant,
                kwargs=fleet_req.kwargs,
                replica_id=rid,
                rpc_id=getattr(inner, "rpc_id", None),
                idempotency_key=idempotency_key,
                deadline_unix=(
                    time.time()
                    + (fleet_req.deadline_at - time.monotonic())
                    if fleet_req.deadline_at is not None else None
                ),
            )
        with self._lock:
            self._outstanding[fleet_req.request_id] = (fleet_req, inner, rid)
            if idempotency_key is not None:
                if len(self._idem_index) >= 4096:
                    # lazy bound: drop finished entries before growing
                    # (the door's LRU owns terminal replay; this index
                    # only needs the LIVE attach targets)
                    self._idem_index = {
                        k: r for k, r in self._idem_index.items()
                        if not r.done
                    }
                self._idem_index[str(idempotency_key)] = fleet_req
        if self._stop.is_set():
            # raced shutdown's outstanding sweep: the monitor is gone and
            # nobody will ever sweep this entry — fail it NOW so result()
            # cannot hang on a dead fleet (same contract as the
            # scheduler's own raced-shutdown path)
            with self._lock:
                self._outstanding.pop(fleet_req.request_id, None)
            if self._journal is not None:
                self._journal.close_request(fleet_req.request_id)
            fleet_req._finish(fleet_req.tokens, _FINISH_CANCELLED)
            self._rejected.inc()
            raise RequestRejected(
                "fleet is draining; not admitting new requests",
                reason=REJECT_DRAINING,
            )
        self._routed.inc()
        return fleet_req

    def cancel(self, fleet_req):
        """Withdraw an outstanding fleet request (the HTTP door's
        client-disconnect path, serving/http.py): its replica-side slot
        frees within one decode step and the request finishes
        ``"cancelled"``. Popped from the outstanding table FIRST so the
        monitor's sweep can never mistake the cancelled inner for a
        replica death and re-route it. Returns True when this call
        withdrew it; False when it already finished (or was never
        outstanding) — the answer was (or will be) delivered normally."""
        with self._lock:
            entry = self._outstanding.pop(fleet_req.request_id, None)
        if entry is None:
            return False
        if self._journal is not None:
            self._journal.close_request(fleet_req.request_id)
        _fr, inner, rid = entry
        replica = self._replicas.get(rid)
        do_cancel = getattr(replica, "cancel_request", None)
        if do_cancel is not None:
            try:
                do_cancel(inner)
            except Exception as e:
                # the replica may be mid-death; its EOF sweep reaps the
                # inner request either way — never fail the withdrawal
                count_suppressed("serving.cancel_request", e)
        self._trace_finish_root(
            fleet_req, _FINISH_CANCELLED, inner=inner, rid=rid
        )
        fleet_req._finish(inner.tokens, _FINISH_CANCELLED)
        return True

    def inner_handle(self, fleet_req):
        """The replica-side handle currently serving ``fleet_req`` (None
        once finished or not yet placed). Its ``tokens`` list grows as
        the scheduler finishes each token — the HTTP door's incremental
        SSE source; a re-route swaps the handle, so streaming callers
        re-read per poll instead of caching it."""
        with self._lock:
            entry = self._outstanding.get(fleet_req.request_id)
        return entry[1] if entry is not None else None

    def _trace_reject(self, reason, tenant):
        """Router-door rejection breadcrumb for the flight recorder."""
        if self.tracer.enabled:
            self.tracer.event(
                "router.reject", attrs={"reason": reason, "tenant": tenant}
            )

    def _trace_finish_root(self, fleet_req, reason, inner=None, rid=None):
        """Close the fleet request's root span with its terminal
        ``reason`` — on EVERY finish path, including error/deadline
        finishes out of the re-route loop and shutdown cancellation:
        the failing requests are exactly the traces worth having whole.
        Adopts the replica-side spans first (``inner``) so the file
        carries the serving half too; idempotent via the ctx reset."""
        ctx = fleet_req.trace_ctx
        if not self.tracer.enabled or ctx is None:
            return
        fleet_req.trace_ctx = None
        if inner is not None:
            self.tracer.ingest(getattr(inner, "trace_spans", None) or ())
        self.tracer.record(
            "fleet.request", fleet_req.submitted_at, time.monotonic(),
            ctx=TraceContext(ctx.trace_id, None, ctx.sampled),
            span_id=ctx.span_id,
            attrs={
                "fleet_request_id": fleet_req.request_id,
                "request_id": getattr(inner, "request_id", None),
                "tenant": fleet_req.tenant,
                "finish_reason": reason,
                "replica": rid,
                "reroutes": fleet_req.reroutes,
                "tokens": len(
                    inner.tokens if inner is not None else fleet_req.tokens
                ),
            },
        )

    def _candidates(self):
        """(replica_id, snapshot) pairs for the currently routable,
        healthy-or-degraded replicas, in registration order (placement
        determinism depends on stable ordering). Replicas behind an OPEN
        circuit breaker are excluded up front — every placement policy
        sees the same filtered set, so none of them can burn a submit
        (and a re-route) on a replica known to be failing its RPCs."""
        routable = self._routable_ids()
        out = []
        with self._lock:
            order = tuple(self._order)
        for rid in order:
            if rid not in routable:
                continue
            replica = self._replicas.get(rid)
            breaker = self._breakers.get(rid)
            if replica is None or breaker is None:
                continue  # removed (scale-down) mid-pass
            if not breaker.routable():
                continue
            snap = replica.load_snapshot()
            if snap.get("failed") or not snap.get("alive"):
                continue
            out.append((rid, snap))
        return out

    def _routable_ids(self):
        with self._lock:
            return set(self._routable)

    def _place(self, fleet_req, candidates):
        """Run placement over ``candidates``, falling through replicas
        that reject at their own door. Returns (inner_handle, replica_id)
        or (None, None)."""
        candidates = list(candidates)
        context = {
            "adapter": fleet_req.kwargs.get("adapter"),
            "tenant": fleet_req.tenant,
        }
        t_place = time.monotonic()
        attempts = 0
        submit_kwargs = fleet_req.kwargs
        if self.tracer.enabled and fleet_req.trace_ctx is not None:
            # context propagation to the replica: a wire dict riding the
            # ordinary kwargs channel, so it crosses the subprocess
            # worker's JSON RPC untouched and the replica's scheduler
            # spans join THIS trace. Not stored on fleet_req.kwargs — a
            # re-route re-derives it.
            submit_kwargs = dict(
                fleet_req.kwargs,
                trace_ctx=fleet_req.trace_ctx.to_wire(),
            )
        while candidates:
            with self._placement_lock:
                try:
                    # fault site: a raising placement policy (chaos) or
                    # a genuinely buggy custom policy — the submission
                    # must not die with it
                    self._faults.maybe_raise("router.place")
                    rid = self.placement.choose(
                        candidates, fleet_req.prompt_tokens,
                        context=context,
                    )
                    was_hit = getattr(self.placement, "last_hit", False)
                except Exception as e:
                    logger.warning(
                        "fleet: placement policy %s raised (%r); falling "
                        "back to registration order",
                        getattr(self.placement, "name",
                                type(self.placement).__name__), e,
                    )
                    count_suppressed("serving.router_place", e)
                    rid = candidates[0][0]
                    was_hit = False
            replica = self._replicas.get(rid)
            breaker = self._breakers.get(rid)
            if replica is None or breaker is None:
                # removed (scale-down) between the candidate snapshot
                # and this placement pass: not a failure, just gone
                candidates = [c for c in candidates if c[0] != rid]
                continue
            probing = breaker.state == BREAKER_OPEN
            if not breaker.allow_request():
                # raced another submit into the window's single half-open
                # probe ticket (or the window has not elapsed): this
                # replica is not available to THIS request
                candidates = [c for c in candidates if c[0] != rid]
                continue
            if probing:
                # this submit IS the window's one half-open probe
                self._breaker_probes.inc()
                if self.tracer.enabled:
                    self.tracer.event(
                        "router.circuit",
                        attrs={"replica": rid, "state": "half_open"},
                    )
            attempts += 1
            try:
                inner = replica.submit(
                    fleet_req.prompt_tokens, **submit_kwargs
                )
            except ReplicaRPCError as e:
                # the TRANSPORT failed (timeout, dead/corrupt pipe):
                # breaker food — N consecutive of these open the circuit
                self._note_breaker_failure(rid, e)
                candidates = [c for c in candidates if c[0] != rid]
                continue
            except (RequestRejected, AdapterUnavailable):
                # a healthy door rejection (queue full, raced a drain,
                # missing adapter): the replica ANSWERED, so its breaker
                # resets — AdapterUnavailable is per-REPLICA, not
                # per-request: drop it from the set and fall through to
                # a replica that can serve
                self._note_breaker_success(rid)
                candidates = [c for c in candidates if c[0] != rid]
                continue
            except Exception as e:
                # an UNCLASSIFIED submit failure (bad kwargs, unknown
                # worker error type) propagates to the caller — but a
                # half-open probe ticket must not leak with it, or the
                # breaker wedges HALF_OPEN and the replica never rejoins:
                # count it as an unanswered probe (the next window
                # re-probes)
                if probing:
                    self._note_breaker_failure(rid, e)
                raise
            self._note_breaker_success(rid)
            if was_hit:
                # counted only on a PLACED hit: a sticky replica that
                # rejected at its door and fell through to another one
                # must not inflate the affinity-effectiveness metric
                self._affinity_hits.inc()
            if self.tracer.enabled and fleet_req.trace_ctx is not None:
                self.tracer.record(
                    "router.place", t_place, time.monotonic(),
                    ctx=fleet_req.trace_ctx,
                    attrs={
                        "replica": rid,
                        "policy": getattr(
                            self.placement, "name",
                            type(self.placement).__name__,
                        ),
                        "affinity_hit": bool(was_hit),
                        "attempts": attempts,
                        "reroute": fleet_req.reroutes,
                    },
                )
            fleet_req.replica_id = rid
            with self._lock:
                self.routed_counts[rid] = self.routed_counts.get(rid, 0) + 1
            return inner, rid
        return None, None

    # -- circuit breakers (docs/serving.md "Circuit breakers") ----------
    def _note_breaker_failure(self, rid, exc):
        breaker = self._breakers.get(rid)
        if breaker is None:
            return  # removed (scale-down) mid-placement
        before = breaker.state
        breaker.record_failure()
        if breaker.state == BREAKER_OPEN:
            if before != BREAKER_OPEN:
                self._breaker_opens.inc()
                logger.warning(
                    "fleet: circuit OPEN for replica %s after %d "
                    "consecutive RPC failure(s) (last: %r); next probe "
                    "in %.2fs", rid, breaker.consecutive_failures, exc,
                    breaker.open_window_remaining,
                )
            if self.tracer.enabled and before != BREAKER_OPEN:
                self.tracer.event(
                    "router.circuit",
                    attrs={"replica": rid, "state": "open",
                           "failures": breaker.consecutive_failures},
                )

    def _note_breaker_success(self, rid):
        breaker = self._breakers.get(rid)
        if breaker is None:
            return  # removed (scale-down) mid-placement
        before = breaker.state
        breaker.record_success()
        if before != BREAKER_CLOSED:
            logger.warning(
                "fleet: circuit CLOSED for replica %s (probe answered); "
                "rejoining placement with state intact", rid,
            )
            if self.tracer.enabled:
                self.tracer.event(
                    "router.circuit",
                    attrs={"replica": rid, "state": "closed"},
                )

    def breaker_state(self, replica_id):
        """The replica's circuit state (breaker.py constants) — what the
        fleet/replica{i}/circuit_state gauge exports."""
        return self._breakers[replica_id].state

    # -- brownout (docs/serving.md "Brownout degradation") --------------
    def _update_brownout(self, queue_ratio):
        """Flip the fleet brownout state from the current queue-fill
        ratio; transitions export the gauge, record a flight-recorder
        instant event, and propagate the toggle to every live replica
        (engines then skip prefix-miss registration work). Returns the
        active state."""
        if self.brownout_queue_ratio is None:
            return False
        active = queue_ratio >= self.brownout_queue_ratio
        with self._brownout_lock:
            if active == self._brownout:
                return active
            self._brownout = active
            return self._brownout_transition(active, queue_ratio)

    def _brownout_transition(self, active, queue_ratio):
        """(under self._brownout_lock) export + propagate one brownout
        edge; transitions are rare, so holding the lock across the
        replica toggle RPCs keeps every observer consistent."""
        if self._journal is not None:
            # write-ahead: a router that dies mid-brownout restarts
            # degraded instead of serving full budgets into a full queue
            self._journal.set_brownout(active)
        self._brownout_gauge.set(1.0 if active else 0.0)
        logger.warning(
            "fleet: brownout %s (queue fill ratio %.3f vs threshold "
            "%.3f) — sheddable traffic %s",
            "ENTERED" if active else "EXITED", queue_ratio,
            self.brownout_queue_ratio,
            "degrades instead of growing the queue" if active
            else "serves at full budget again",
        )
        if self.tracer.enabled:
            self.tracer.event(
                "router.brownout",
                attrs={"state": int(active),
                       "queue_ratio": round(float(queue_ratio), 4)},
            )
        for rid in self._order:
            if rid not in self._evicted:
                self._set_replica_brownout(rid, active)
        return active

    def _set_replica_brownout(self, rid, on):
        replica = self._replicas.get(rid)
        if replica is None:
            return  # removed (scale-down) racing the brownout edge
        hook = getattr(replica, "set_brownout", None)
        if hook is None:
            return
        try:
            hook(on)
        except Exception as e:
            # a replica that cannot hear the toggle is already in worse
            # trouble than a missed brownout; count, don't crash the tick
            count_suppressed("serving.brownout_toggle", e)

    @property
    def brownout(self):
        """True while the fleet is in the brownout band."""
        return self._brownout

    # -- monitor --------------------------------------------------------
    def _monitor_loop(self):
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:
                logger.exception("fleet monitor tick failed")
                count_suppressed("serving.monitor_tick", e)
            self._stop.wait(self._monitor_interval)

    def _tick(self):
        if self._faults.enabled and (
            self._faults.fire("router.crash") is not None
        ):
            # chaos site router.crash: the router HOST dies — not an
            # exception, a SIGKILL, so no finally block or atexit runs
            # and only the journal + the nodes' durable sessions remain
            logger.warning(
                "FAULT router.crash: SIGKILLing the router process "
                "(pid %d)", os.getpid(),
            )
            os.kill(os.getpid(), signal.SIGKILL)
        if (
            self._preemption is not None
            and self._preemption.armed
            and not self._draining
        ):
            logger.warning(
                "fleet: preemption signal received — draining all replicas"
            )
            self.drain_fleet()
        self._sweep_zombies()
        self._sweep_failed_replicas()
        self._sweep_outstanding()
        if self._autoscaler is not None:
            try:
                self._autoscaler.tick()
                if self._journal is not None:
                    # journal-on-change: the autoscaler's durable half
                    # (target / cooldown / flap evidence) commits only
                    # when it actually moved — ticks are hot, scales rare
                    snap = self._autoscaler.journal_snapshot()
                    if snap != self._last_autoscaler_snap:
                        self._last_autoscaler_snap = snap
                        self._journal.set_autoscaler(snap)
            except Exception as e:
                # a broken autoscaler must not take the zombie/eviction
                # sweeps down with it
                logger.exception("fleet autoscaler tick failed")
                count_suppressed("serving.autoscale_tick", e)
        if self.hub is not None:
            try:
                # rate-limited internally; scrape I/O runs on the hub's
                # own short-lived thread, never on this monitor thread
                self.hub.tick()
            except Exception as e:
                logger.exception("telemetry hub tick failed")
                count_suppressed("telemetry.hub_tick", e)
        now = self._clock()
        if now - self._last_refresh >= self._telemetry_refresh_secs:
            self.refresh_telemetry()

    def _sweep_zombies(self):
        """Zombie detection (docs/serving.md): a replica whose snapshot
        shows work in flight but whose completion counters have not
        moved for ``zombie_secs`` — or whose live process has stopped
        answering snapshot RPCs altogether — is drained-then-restarted
        under ``zombie_restart_budget``; past the budget it is condemned
        to the eviction sweep. Each detection dumps the flight recorder
        (the wedged state IS the debugging moment)."""
        if self.zombie_secs <= 0:
            return
        now = self._clock()
        if now - self._last_zombie_sweep < self._zombie_sweep_secs:
            return
        self._last_zombie_sweep = now
        for rid in list(self._routable_ids()):
            if rid in self._evicted:
                continue
            replica = self._replicas.get(rid)
            if replica is None:
                continue  # removed (scale-down) mid-sweep
            snap = replica.load_snapshot()
            unresponsive = bool(snap.get("unresponsive"))
            stuck = unresponsive or (
                snap.get("alive") and snap.get("active_slots", 0) > 0
            )
            marker = (
                snap.get("requests_completed"),
                snap.get("tokens_generated"),
            )
            prev = self._progress.get(rid)
            if not stuck or prev is None or (
                not unresponsive and marker != prev[0]
            ):
                # idle, first sighting, or real progress: re-anchor
                self._progress[rid] = (marker, now)
                continue
            if now - prev[1] < self.zombie_secs:
                continue
            used = self._zombie_restarts_used[rid]
            logger.warning(
                "fleet: replica %s is a ZOMBIE (%s for %.1fs; restart "
                "%d/%d)", rid,
                "unresponsive RPC" if unresponsive
                else "active slots with frozen completion counters",
                now - prev[1], used + 1, self.zombie_restart_budget,
            )
            self.tracer.dump_flight(f"zombie_replica_{rid}")
            if self.tracer.enabled:
                self.tracer.event(
                    "router.zombie",
                    attrs={"replica": rid,
                           "unresponsive": unresponsive,
                           "restarts_used": used},
                )
            self._progress.pop(rid, None)
            if used >= self.zombie_restart_budget:
                logger.error(
                    "fleet: replica %s zombie past its restart budget "
                    "(%d); evicting", rid, self.zombie_restart_budget,
                )
                with self._lock:
                    self._force_failed.add(rid)
                continue
            self._zombie_restarts_used[rid] = used + 1
            self._zombie_restarts.inc()
            # the zombie never goes idle by definition: skip the drain
            # wait and rebuild now — its in-flight requests fail-finish
            # and the outstanding sweep re-routes them
            self.restart_replica(rid, wait_timeout=0.0)

    def _sweep_failed_replicas(self):
        with self._lock:
            force_failed = set(self._force_failed)
            order = tuple(self._order)
        for rid in order:
            if rid in self._evicted:
                continue
            replica = self._replicas.get(rid)
            if replica is None:
                continue  # removed (scale-down) mid-sweep
            if getattr(replica, "fenced", False) and not self._fenced:
                # the node rejected this router's incarnation epoch: a
                # newer incarnation owns the fleet. Latch the stand-down
                # BEFORE the eviction below so the operator sees WHY the
                # fleet is emptying — and so submit/readiness refuse from
                # this tick on, not after the last replica is gone
                self._fenced = True
                logger.critical(
                    "fleet: replica %s FENCED OUT — this router's "
                    "incarnation epoch is stale (a newer router owns the "
                    "fleet); standing down: refusing new submissions and "
                    "reporting not-ready", rid,
                )
                self.tracer.event(
                    "router.fenced_out", attrs={"replica": rid},
                )
                self.tracer.dump_flight("router_fenced_out")
            if replica.failed or rid in force_failed:
                logger.warning(
                    "fleet: evicting replica %s (decode driver dead past "
                    "its restart budget, a failed restart, or a zombie "
                    "past its budget); re-routing its requests", rid,
                )
                # eviction is a debugging moment: dump the flight
                # recorder's last-N spans/events (no-op when tracing off)
                self.tracer.dump_flight(f"replica_eviction_{rid}")
                with self._lock:
                    self._routable.discard(rid)
                    self._evicted.add(rid)
                self._evictions.inc()
                with self._placement_lock:
                    self.placement.forget(rid)
                # a dead replica's per-replica gauges must not keep
                # exporting their stale last values (docs/serving.md) —
                # restart_replica re-creates them on a resurrection
                self._retire_replica_gauges(rid)
                # reap the corpse: in-process this fail-finishes anything
                # still parked on its queue (the monitor re-routes those
                # on the next sweep); subprocess it just waits the pid
                replica.shutdown()

    def _sweep_outstanding(self):
        with self._lock:
            entries = list(self._outstanding.items())
        for req_id, (fleet_req, inner, rid) in entries:
            if not inner.done:
                continue
            if inner.finish_reason in _TERMINAL_REASONS:
                with self._lock:
                    self._outstanding.pop(req_id, None)
                if self._journal is not None:
                    # terminal BEFORE delivery: a crash between this
                    # close and _finish re-delivers from the node outbox
                    # (idempotent), never re-runs the generation
                    self._journal.close_request(req_id)
                ctx = fleet_req.trace_ctx
                traced = self.tracer.enabled and ctx is not None
                first = getattr(inner, "first_token_at", None)
                if first is not None:
                    # no first token (e.g. a deadline finish with zero
                    # tokens) = no TTFT sample; a sweep-time anchor would
                    # poison the fleet p50/p99 with fake latencies
                    self._ttft.observe(
                        max(first - fleet_req.submitted_at, 0.0) * 1e3,
                        trace_id=(
                            ctx.trace_id if traced and ctx.sampled
                            else None
                        ),
                    )
                self._completed.inc()
                # adopt the replica-side spans (the worker shipped them
                # back with the finished event; in-process replicas
                # share this tracer, so ingest dedupes by pid) and close
                # the root span
                self._trace_finish_root(
                    fleet_req, inner.finish_reason, inner=inner, rid=rid
                )
                fleet_req._finish(inner.tokens, inner.finish_reason)
            else:
                # "error"/"cancelled": the replica died under it (crash
                # past restart budget, eviction, worker exit) — re-place
                # on a live replica, or fail the fleet request loudly.
                # But FIRST re-check the table: this sweep iterates a
                # pre-pop snapshot, and a concurrent cancel() (HTTP
                # client disconnect) may have withdrawn the entry after
                # the snapshot was taken — rerouting it now would decode
                # a full generation for nobody and double-finish the
                # fleet request
                with self._lock:
                    still = self._outstanding.get(req_id)
                if still is None or still[1] is not inner:
                    continue
                self._reroute(req_id, fleet_req, inner)

    def _reroute(self, req_id, fleet_req, inner=None):
        if fleet_req.reroutes >= self.max_reroutes:
            with self._lock:
                self._outstanding.pop(req_id, None)
            if self._journal is not None:
                self._journal.close_request(req_id)
            self._trace_finish_root(fleet_req, _FINISH_ERROR, inner=inner)
            fleet_req._finish(fleet_req.tokens, _FINISH_ERROR)
            return
        if fleet_req.deadline_at is not None:
            remaining = fleet_req.deadline_at - time.monotonic()
            if remaining <= 0:
                # the end-to-end deadline expired while its replica was
                # dying: a "deadline" finish (the caller's contract), not
                # a fresh full-budget generation somewhere else
                with self._lock:
                    self._outstanding.pop(req_id, None)
                if self._journal is not None:
                    self._journal.close_request(req_id)
                self._trace_finish_root(
                    fleet_req, "deadline", inner=inner
                )
                fleet_req._finish(fleet_req.tokens, "deadline")
                return
            fleet_req.kwargs["deadline_secs"] = remaining
        candidates = self._candidates()
        if not candidates:
            with self._lock:
                fleet_dead = len(self._evicted) >= len(self._order)
            if self._stop.is_set() or self._draining or fleet_dead:
                with self._lock:
                    self._outstanding.pop(req_id, None)
                if self._journal is not None:
                    self._journal.close_request(req_id)
                self._trace_finish_root(
                    fleet_req, _FINISH_ERROR, inner=inner
                )
                fleet_req._finish(fleet_req.tokens, _FINISH_ERROR)
            return  # nothing routable right now; retry next tick
        fleet_req.reroutes += 1
        t0 = time.monotonic()
        inner, rid = self._place(fleet_req, candidates)
        if inner is None:
            return  # burned one attempt; retry next tick
        logger.warning(
            "fleet: re-routed request %d to replica %s (attempt %d/%d)",
            fleet_req.request_id, rid, fleet_req.reroutes,
            self.max_reroutes,
        )
        if self.tracer.enabled and fleet_req.trace_ctx is not None:
            # re-routes ride the root span as children, so the trace
            # shows exactly which replica death cost the request time
            self.tracer.record(
                "router.reroute", t0, time.monotonic(),
                ctx=fleet_req.trace_ctx,
                attrs={"replica": rid, "attempt": fleet_req.reroutes},
            )
        self._rerouted.inc()
        if self._journal is not None:
            # the descriptor follows the request to its new placement:
            # a crash after this adopts the NEW session's rpc id
            self._journal.move_request(
                req_id, replica_id=rid,
                rpc_id=getattr(inner, "rpc_id", None),
                reroutes=fleet_req.reroutes,
            )
        with self._lock:
            # a cancel() can land between placement and this re-insert:
            # the fleet request is already finished "cancelled" then, so
            # withdraw the fresh inner instead of decoding for nobody
            stale = fleet_req.done
            if not stale:
                self._outstanding[req_id] = (fleet_req, inner, rid)
        if stale:
            replica = self._replicas.get(rid)
            do_cancel = getattr(replica, "cancel_request", None)
            if do_cancel is not None:
                try:
                    do_cancel(inner)
                except Exception as e:
                    count_suppressed("serving.cancel_request", e)

    # -- telemetry ------------------------------------------------------
    def refresh_telemetry(self):
        """Mirror per-replica snapshots and fleet aggregates onto the
        fleet/* streams (and export, when a telemetry sink is attached).
        The monitor calls this on a cadence; tests and bench call it
        directly before asserting."""
        with self._refresh_lock:
            self._refresh_telemetry_locked()

    def _refresh_telemetry_locked(self):
        reg = self.metrics
        total_queue = 0
        total_active = 0
        total_capacity = 0
        routable_queue = 0
        available = 0
        prefix_hits = 0
        prefix_lookups = 0
        adapters_resident = set()
        total_shed = 0.0
        routable = self._routable_ids()
        with self._lock:
            order = tuple(self._order)
        for rid in order:
            if rid in self._evicted:
                # an evicted replica's gauges were RETIRED at eviction
                # (remove_prefix) — recreating them here would resurrect
                # stale streams; restart_replica's refresh re-mints them
                continue
            replica = self._replicas.get(rid)
            breaker = self._breakers.get(rid)
            if replica is None or breaker is None:
                continue  # removed (scale-down) mid-refresh
            snap = replica.load_snapshot()
            alive_val = 1.0 if snap.get("alive") else 0.0
            prefix = f"fleet/replica{rid}"
            reg.gauge(f"{prefix}/circuit_state").set(float(breaker.state))
            reg.gauge(f"{prefix}/queue_depth").set(snap["queue_depth"])
            reg.gauge(f"{prefix}/slot_occupancy").set(
                snap["active_slots"]
            )
            reg.gauge(f"{prefix}/health_state").set(snap["health"])
            reg.gauge(f"{prefix}/requests_shed").set(
                snap["requests_shed"]
            )
            total_shed += float(snap.get("requests_shed", 0.0))
            if "prefix_hit_rate" in snap:
                # paged replicas report their REAL prefix-cache
                # effectiveness — the ground truth behind the
                # router-side affinity_hits counter (a placement hit
                # only pays off when the replica actually reuses the
                # pages)
                reg.gauge(f"{prefix}/prefix_hit_rate").set(
                    snap["prefix_hit_rate"]
                )
                reg.gauge(f"{prefix}/kv_blocks_free").set(
                    snap.get("kv_blocks_free", 0)
                )
                prefix_hits += snap.get("prefix_hits", 0)
                prefix_lookups += (
                    snap.get("prefix_hits", 0)
                    + snap.get("prefix_misses", 0)
                )
            if "host_tier_occupancy_bytes" in snap:
                # host-tier replicas mirror their spill-tier counters so
                # the fleet view shows WHERE warm pages live (and whether
                # peer promotion is actually saving prefill compute on
                # the co-hosted replicas) without scraping each door
                reg.gauge(f"{prefix}/host_tier_occupancy_bytes").set(
                    snap.get("host_tier_occupancy_bytes", 0)
                )
                reg.gauge(f"{prefix}/host_tier_spills").set(
                    snap.get("host_tier_spills", 0)
                )
                reg.gauge(f"{prefix}/host_tier_promotions").set(
                    snap.get("host_tier_promotions", 0)
                )
                reg.gauge(f"{prefix}/host_tier_peer_fetches").set(
                    snap.get("host_tier_peer_fetches", 0)
                )
                reg.gauge(f"{prefix}/host_tier_preemptions").set(
                    snap.get("host_tier_preemptions", 0)
                )
            if "adapters_loaded" in snap:
                # multi-LoRA replicas report their resident adapters
                # — the per-replica gauge adapter-affinity placement
                # is effectively acting on
                loaded = snap.get("adapters_loaded") or []
                reg.gauge(f"{prefix}/adapters_loaded").set(len(loaded))
                adapters_resident.update(loaded)
            total_queue += snap["queue_depth"]
            total_active += snap["active_slots"]
            if rid in routable and snap.get("alive"):
                # degraded replicas still take priority-0 traffic, so
                # they count as available; draining/stopped do not —
                # and ONLY routable replicas feed the brownout ratio
                # (both terms: a draining replica's backlog is not
                # pressure on the replicas actually taking traffic,
                # matching the submit path's candidate-based ratio)
                available += 1
                total_capacity += snap["queue_capacity"]
                routable_queue += snap["queue_depth"]
            reg.gauge(f"{prefix}/alive").set(alive_val)
        # brownout state follows the fill ratio DOWN too: the monitor's
        # refresh cadence is what ends a brownout window once the queue
        # drains (submissions alone would leave the last state latched)
        self._update_brownout(
            routable_queue / total_capacity if total_capacity > 0 else 0.0
        )
        reg.gauge("fleet/queue_depth").set(total_queue)
        reg.gauge("fleet/slot_occupancy").set(total_active)
        self._shed_total.set(total_shed)
        reg.gauge("fleet/replicas_total").set(
            len(self._order) - len(self._evicted)
        )
        reg.gauge("fleet/replicas_available").set(available)
        reg.gauge("fleet/prefix_hit_rate").set(
            prefix_hits / prefix_lookups if prefix_lookups else 0.0
        )
        reg.gauge("fleet/adapters_loaded").set(len(adapters_resident))
        self._ttft_p50.set(histogram_quantile(self._ttft, 0.50))
        self._ttft_p99.set(histogram_quantile(self._ttft, 0.99))
        self._last_refresh = self._clock()
        self._refreshes += 1
        if self._recovering and self._recovered is None:
            # first FULL refresh after adoption completed: every adopted
            # replica answered a live snapshot above, so the fleet's
            # load picture is real again — stop advertising "recovering"
            self._recovering = False
        if self._telemetry is not None and self._telemetry.enabled:
            self._telemetry.export(step=self._refreshes)

    # -- introspection --------------------------------------------------
    def readiness(self):
        """``(ready, reasons)`` — the external-load-balancer view the
        door's ``GET /readyz`` answers (docs/serving.md): NOT ready
        while the fleet is draining, browned out, without a routable
        replica, or with every routable replica reporting degraded
        health — an LB should stop routing here BEFORE requests shed.
        Liveness is ``/healthz``'s job; this is about taking traffic."""
        reasons = []
        if self._fenced:
            # a newer router incarnation owns the fleet (a node refused
            # this one's epoch): NO traffic belongs here, ever again —
            # split-brain safety beats availability
            reasons.append("fenced_out")
        if self._recovering:
            # crash-recovery adoption in progress (or not yet refreshed):
            # the adopted fleet's load picture is stale — an LB should
            # let the previous traffic settle before routing here
            reasons.append("recovering")
        if self._stop.is_set() or self._draining:
            reasons.append("draining")
        if self._brownout:
            reasons.append("brownout")
        candidates = self._candidates()
        if not candidates:
            reasons.append("no_routable_replicas")
        elif all(s.get("health", 0) > 0 for _rid, s in candidates):
            reasons.append("degraded")
        return (not reasons, reasons)

    def no_capacity_cause(self):
        """Why zero replicas are routable RIGHT NOW — the ``cause``
        object the door folds into a 503 ``/readyz`` body when the
        reason is ``no_routable_replicas`` (docs/serving.md). Bucket
        counts an operator can act on without grepping logs: a fleet
        that is all ``evicted`` needs reprovisioning, all
        ``breaker_open`` needs the failing dependency fixed, and
        ``fenced`` means this router must be retired, not healed."""
        with self._lock:
            order = tuple(self._order)
            routable = set(self._routable)
            evicted = set(self._evicted)
        breaker_open = 0
        dead = 0
        for rid in order:
            if rid in evicted or rid not in routable:
                continue
            breaker = self._breakers.get(rid)
            if breaker is not None and not breaker.routable():
                breaker_open += 1
                continue
            replica = self._replicas.get(rid)
            if replica is None:
                continue
            snap = replica.load_snapshot()
            if snap.get("failed") or not snap.get("alive"):
                dead += 1
        return {
            "replicas_total": len(order),
            "evicted": len(evicted),
            # restarting or replica-level draining: registered but
            # pulled out of the routable set
            "not_routable": sum(
                1 for rid in order
                if rid not in routable and rid not in evicted
            ),
            "breaker_open": breaker_open,
            "dead": dead,
            "fenced": self._fenced,
            "draining": self._stop.is_set() or self._draining,
        }

    @property
    def autoscaler(self):
        """The attached SLO autoscaler (autoscaler.py), or None when
        the feature is off (zero-overhead passthrough)."""
        return self._autoscaler

    @property
    def journal(self):
        """The attached fleet-state journal (journal.py), or None when
        serving.journal is off (no files, zero write-path work)."""
        return self._journal

    @property
    def recovering(self):
        """True from adoption start until the first full telemetry
        refresh after it — mirrored as readiness() reason "recovering"."""
        return self._recovering

    @property
    def fenced(self):
        """True once any node rejected this router's incarnation epoch
        (a newer incarnation owns the fleet) — latched permanently;
        mirrored as readiness() reason "fenced_out" and a submit-path
        refusal with reason ``fenced_out``."""
        return self._fenced

    @property
    def replica_ids(self):
        return list(self._order)

    @property
    def evicted_ids(self):
        with self._lock:
            return set(self._evicted)

    @property
    def outstanding_count(self):
        with self._lock:
            return len(self._outstanding)
