"""SLO-driven predictive autoscaler: elastic capacity ahead of the cliff.

Port of deepspeed_tpu/serving/autoscaler.py.

The brownout band and priority shedding (docs/serving.md "Brownout
degradation") are REACTIVE — they fire when queues are already deep, and
capacity lost to evictions or node deaths stays lost. This module is the
proactive half (docs/serving.md "SLO autoscaling"): because iteration-
level scheduling makes per-replica throughput *predictable* from the
observed per-phase costs (the PR-9 queue/prefill/decode span breakdown,
surfaced through ``load_snapshot``), the fleet can know a load level is
SLO-unmeetable BEFORE requests degrade — and change capacity instead of
degrading them.

Three layers, deliberately separable:

  :class:`PhaseCostModel`
      an online EWMA fit of the fleet's per-phase costs (mean/p99
      prefill ms, decode-step ms, queue wait ms, tokens per request)
      from ordinary load snapshots; ``predict`` converts a snapshot set
      plus the observed arrival rate into predicted TTFT / token
      latency / utilization. Pure arithmetic — no clocks, no RPCs.
  :class:`AutoscalerPolicy`
      the decision function. ``decide`` is a PURE function of
      (snapshots, prediction, state, now): same inputs, same
      :class:`Decision` — pinned in tests with synthetic snapshots and
      an injectable clock. Scale-up when predicted load is
      SLO-unmeetable or utilization crosses the threshold or queue fill
      approaches the brownout band (degradation must never fire first);
      scale-down by drain-then-retire after a sustained-headroom
      hysteresis window; re-provision when live capacity sits below the
      target (chaos took a replica). All of it clamped by min/max
      replicas, a scale cooldown, and a flap budget (direction
      reversals inside a sliding window).
  :class:`Autoscaler`
      the executor: ticks on the router monitor's cadence, feeds the
      model, exports the ``fleet/slo_*`` / ``fleet/autoscale_*``
      streams, runs SLO error-budget accounting, and executes decisions
      through a :class:`ReplicaProvider` on a one-op-at-a-time worker
      thread (an engine build must not stall zombie sweeps). Every
      executed transition records a ``router.autoscale``
      flight-recorder instant event.

Providers bind the executor to a backend: in-process engines
(:class:`InProcessReplicaProvider`), worker subprocesses
(:class:`SubprocessReplicaProvider`), or remote node agents
(:class:`SocketNodeProvider` — spawn/retire ride the node control
session, transport.py's :class:`~.transport.NodeControlClient`). A new
replica registers with the router BEHIND its circuit breaker's
half-open probation gate (breaker.py ``begin_probation``): the first
submission is the window's single probe, so a half-built replica can
cost the fleet at most one request.

Disabled config = no Autoscaler object at all: the router's monitor
tick sees ``None`` and the serving tier runs exactly as before — zero
overhead, zero new threads.
"""

import itertools
import threading
import time
from collections import deque, namedtuple

from ..telemetry.registry import count_suppressed, histogram_quantile
from ..utils.logging import logger

# Decision actions (Decision.action / the router.autoscale event's kind)
AUTOSCALE_HOLD = "hold"
AUTOSCALE_UP = "scale_up"
AUTOSCALE_DOWN = "scale_down"
AUTOSCALE_REPROVISION = "reprovision"

# Decision.refused_code / the reason label on the per-reason refusal
# counters (``fleet/autoscale_refusals/<code>``)
REFUSE_MAX_REPLICAS = "max_replicas"
REFUSE_MIN_REPLICAS = "min_replicas"
REFUSE_COOLDOWN = "cooldown"
REFUSE_FLAP_BUDGET = "flap_budget"
REFUSE_NO_VICTIM = "no_victim"
REFUSE_NO_CAPACITY = "no_placeable_capacity"


class NoPlaceableCapacity(RuntimeError):
    """A spawn found ZERO placeable capacity: every node is dead (inside
    its failure backoff) or at its per-node replica ceiling, and no
    provisioner can mint more. Typed so the executor surfaces it as a
    counted, flight-recorded REFUSAL (``fleet/autoscale_refusals`` with
    the ``no_placeable_capacity`` reason) instead of a generic op
    failure re-decided silently every tick."""

    def __init__(self, message, *, reason=REFUSE_NO_CAPACITY):
        super().__init__(message)
        self.reason = str(reason)

# scale up when queue fill reaches this fraction of the brownout
# threshold: degradation is the mechanism of last resort, so elastic
# capacity must engage with headroom to spare, not at the band's edge
BROWNOUT_HEADROOM = 0.8

# the saturation clamp for the queueing amplifier: utilization is capped
# here inside 1/(1-rho) so predictions stay finite (an over-saturated
# fleet predicts a huge — not infinite — wait)
_RHO_CAP = 0.995


class SLOTargets(namedtuple(
        "SLOTargets", "ttft_p99_ms token_p99_ms eval_window_secs")):
    """The ``serving.slo`` block (docs/serving.md): latency targets the
    fleet promises (``None`` = no target on that axis) and the sliding
    window error-budget accounting evaluates over."""

    __slots__ = ()

    def __new__(cls, ttft_p99_ms=None, token_p99_ms=None,
                eval_window_secs=60.0):
        return super().__new__(
            cls,
            None if ttft_p99_ms is None else float(ttft_p99_ms),
            None if token_p99_ms is None else float(token_p99_ms),
            float(eval_window_secs),
        )


Prediction = namedtuple(
    "Prediction",
    "ttft_ms wait_ms token_ms utilization sustainable_rps queue_ratio "
    "service_ms fitted",
)
Prediction.__doc__ = (
    "One cost-model forecast. ``ttft_ms = wait_ms + prefill tail``: the "
    "split matters because added capacity shrinks ONLY the queueing "
    "term — the scale-up predicate uses it to tell loads capacity can "
    "fix from base service latency it cannot."
)


class PhaseCostModel:
    """Online EWMA fit of the fleet's per-phase serving costs.

    ``observe`` folds each tick's live snapshots into the fit (snapshots
    carry the PR-9 phase breakdown: ``mean_prefill_ms``,
    ``p99_prefill_ms``, ``mean_decode_ms``, ``mean_queue_wait_ms``, and
    the completion totals that yield tokens-per-request).

    ``predict`` is pure arithmetic over (snapshots, arrival_rps):

        service_ms       = prefill + tokens_per_request * decode_step
        sustainable_rps  = Σ slots * 1000 / service_ms
        utilization      = arrival_rps / sustainable_rps
        backlog_ms       = Σ queue_depth * service_ms / Σ slots
        wait_ms          = backlog_ms / (1 - min(utilization, 0.995))
        ttft_ms          = wait_ms + p99 prefill
        token_ms         = decode_step (observed at real occupancy)

    The 1/(1-rho) amplifier is the classic single-queue saturation
    curve: as arrival approaches the sustainable rate, the same backlog
    predicts an exploding wait — the property that lets the autoscaler
    act while queues are still shallow."""

    def __init__(self, alpha=0.3, default_tokens_per_request=32.0):
        self.alpha = float(alpha)
        self.default_tokens_per_request = float(default_tokens_per_request)
        self.prefill_ms = None
        self.prefill_p99_ms = None
        self.decode_step_ms = None
        self.queue_wait_ms = None
        self.tokens_per_request = None

    @property
    def fitted(self):
        """True once both critical phases have been observed — before
        that, predictions report zero utilization (the policy then acts
        only on the queue-fill/brownout-proximity signal)."""
        return self.prefill_ms is not None and self.decode_step_ms is not None

    def _ewma(self, old, new):
        return new if old is None else old + self.alpha * (new - old)

    def observe(self, snapshots):
        """Fold one tick's ``(replica_id, snapshot)`` pairs into the
        fit; replicas that have not served yet (zero means) contribute
        nothing."""
        live = [s for _rid, s in snapshots if s.get("alive")]

        def fold(attr, key, fallback_key=None):
            vals = [
                s.get(key) or (s.get(fallback_key) if fallback_key else 0)
                for s in live
            ]
            vals = [float(v) for v in vals if v and v > 0]
            if vals:
                setattr(self, attr,
                        self._ewma(getattr(self, attr),
                                   sum(vals) / len(vals)))

        fold("prefill_ms", "mean_prefill_ms")
        fold("prefill_p99_ms", "p99_prefill_ms", "mean_prefill_ms")
        fold("decode_step_ms", "mean_decode_ms")
        fold("queue_wait_ms", "mean_queue_wait_ms")
        tokens = sum(int(s.get("tokens_generated", 0)) for s in live)
        requests = sum(int(s.get("requests_completed", 0)) for s in live)
        if requests > 0:
            self.tokens_per_request = self._ewma(
                self.tokens_per_request, tokens / requests
            )

    def service_ms(self):
        """Fitted per-request service time (prefill + full decode)."""
        if not self.fitted:
            return 0.0
        tokens = (
            self.tokens_per_request
            if self.tokens_per_request else self.default_tokens_per_request
        )
        return self.prefill_ms + tokens * self.decode_step_ms

    def predict(self, snapshots, arrival_rps):
        """Predicted fleet latency/utilization for ``snapshots`` under
        ``arrival_rps``. Deterministic: same inputs, same numbers."""
        live = [s for _rid, s in snapshots if s.get("alive")]
        slots = sum(int(s.get("num_slots", 0)) for s in live)
        queue = sum(int(s.get("queue_depth", 0)) for s in live)
        cap = sum(int(s.get("queue_capacity", 0)) for s in live)
        queue_ratio = queue / cap if cap > 0 else 0.0
        service = self.service_ms()
        if not self.fitted or slots <= 0 or service <= 0:
            return Prediction(0.0, 0.0, 0.0, 0.0, 0.0, queue_ratio,
                              service, False)
        sustainable_rps = slots * 1000.0 / service
        utilization = max(float(arrival_rps), 0.0) / sustainable_rps
        rho = min(utilization, _RHO_CAP)
        backlog_ms = queue * service / slots
        wait_ms = backlog_ms / max(1.0 - rho, 1.0 - _RHO_CAP)
        ttft_ms = wait_ms + (
            self.prefill_p99_ms
            if self.prefill_p99_ms is not None else self.prefill_ms
        )
        return Prediction(
            ttft_ms, wait_ms, self.decode_step_ms, utilization,
            sustainable_rps, queue_ratio, service, True,
        )


class ErrorBudget:
    """Sliding-window SLO compliance accounting: each evaluation sample
    is (stamp, violated); ``remaining`` is the fraction of in-window
    samples that met the SLO (1.0 with no samples — an idle fleet has a
    full budget). Exported as ``fleet/slo_error_budget_remaining``."""

    def __init__(self, window_secs=60.0):
        self.window_secs = float(window_secs)
        self._samples = deque()

    def _prune(self, now):
        horizon = now - self.window_secs
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def record(self, now, violated):
        self._prune(now)
        self._samples.append((float(now), bool(violated)))

    def remaining(self, now):
        self._prune(now)
        if not self._samples:
            return 1.0
        violations = sum(1 for _t, v in self._samples if v)
        return 1.0 - violations / len(self._samples)


Decision = namedtuple(
    "Decision", "action reason replica_id refused refused_code"
)
Decision.__new__.__defaults__ = (None,)
Decision.__doc__ = (
    "One autoscale verdict: ``action`` (hold/scale_up/scale_down/"
    "reprovision), a human-readable ``reason``, the ``replica_id`` a "
    "scale-down would retire, ``refused`` — the action a clamp "
    "(cooldown, flap budget, min/max) blocked this tick (None when "
    "nothing was blocked) — and ``refused_code``, the machine-readable "
    "REFUSE_* label the per-reason refusal counter carries."
)


def _hold(reason, refused=None, code=None):
    return Decision(AUTOSCALE_HOLD, reason, None, refused, code)


class AutoscaleState:
    """The mutable half the executor owns; ``decide`` reads it, never
    writes it. ``transitions`` is an append-only tuple of (stamp,
    direction) pairs — the flap budget's evidence."""

    __slots__ = ("target", "last_scale_at", "headroom_since",
                 "op_in_flight", "transitions")

    def __init__(self, target=1):
        self.target = int(target)
        self.last_scale_at = None
        self.headroom_since = None
        self.op_in_flight = False
        self.transitions = ()


class AutoscalerPolicy:
    """The decision table (docs/serving.md "SLO autoscaling").

    ``decide`` is a pure function of its arguments: snapshots feed the
    prediction, ``state`` carries the executor's clamp bookkeeping, and
    ``now`` is whatever clock the caller injects — tests pin that the
    same inputs always yield the same :class:`Decision`."""

    def __init__(self, *, slo=None, min_replicas=1, max_replicas=4,
                 cooldown_secs=30.0, hysteresis_secs=60.0, flap_budget=4,
                 flap_window_secs=600.0, scale_up_utilization=0.85,
                 scale_down_utilization=0.3, brownout_queue_ratio=None):
        self.slo = slo if slo is not None else SLOTargets()
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas!r}..{max_replicas!r}"
            )
        self.cooldown_secs = float(cooldown_secs)
        self.hysteresis_secs = float(hysteresis_secs)
        self.flap_budget = int(flap_budget)
        self.flap_window_secs = float(flap_window_secs)
        self.scale_up_utilization = float(scale_up_utilization)
        self.scale_down_utilization = float(scale_down_utilization)
        if not (0 < self.scale_down_utilization
                < self.scale_up_utilization):
            raise ValueError(
                "need 0 < scale_down_utilization < scale_up_utilization, "
                f"got {scale_down_utilization!r} vs {scale_up_utilization!r}"
            )
        self.brownout_queue_ratio = (
            None if brownout_queue_ratio is None
            else float(brownout_queue_ratio)
        )

    # -- predicates ------------------------------------------------------
    def overloaded(self, prediction):
        """(bool, reason): is the predicted load SLO-unmeetable at the
        current capacity? Fires BEFORE the brownout band by design."""
        slo = self.slo
        if (
            slo.ttft_p99_ms is not None and prediction.fitted
            and prediction.ttft_ms > slo.ttft_p99_ms
            # capacity shrinks ONLY the queueing term: a fleet whose
            # BASE latency (prefill tail alone — e.g. a first-compile
            # outlier pinning the cumulative p99, or a model simply too
            # slow for the target) busts the SLO cannot be scaled into
            # compliance, so it must not read as a permanent overload
            and prediction.ttft_ms - prediction.wait_ms <= slo.ttft_p99_ms
        ):
            return True, (
                f"predicted TTFT {prediction.ttft_ms:.0f}ms exceeds the "
                f"{slo.ttft_p99_ms:.0f}ms p99 SLO"
            )
        if (
            slo.token_p99_ms is not None and prediction.fitted
            and prediction.token_ms > slo.token_p99_ms
        ):
            return True, (
                f"predicted token latency {prediction.token_ms:.1f}ms "
                f"exceeds the {slo.token_p99_ms:.1f}ms p99 SLO"
            )
        if prediction.utilization >= self.scale_up_utilization:
            return True, (
                f"predicted utilization {prediction.utilization:.2f} at "
                f"the {self.scale_up_utilization:.2f} scale-up threshold"
            )
        if (
            self.brownout_queue_ratio is not None
            and prediction.queue_ratio
            >= BROWNOUT_HEADROOM * self.brownout_queue_ratio
        ):
            return True, (
                f"queue fill {prediction.queue_ratio:.2f} approaching "
                f"the brownout band at {self.brownout_queue_ratio:.2f} "
                "(capacity must grow before degradation engages)"
            )
        return False, ""

    def has_headroom(self, prediction, live_replicas):
        """True while the fleet could lose one replica and stay inside
        the scale-up region with margin — the hysteresis clock's input
        (the EXECUTOR tracks since-when; this predicate stays pure)."""
        if live_replicas <= self.min_replicas:
            return False
        if not prediction.fitted:
            return False
        if prediction.queue_ratio > 0.05:
            return False
        if prediction.utilization > self.scale_down_utilization:
            return False
        shrunk = prediction.utilization * live_replicas / max(
            live_replicas - 1, 1
        )
        return shrunk < self.scale_up_utilization

    def _flap_refused(self, state, now, direction):
        """Would appending ``direction`` exceed the reversal budget
        inside the flap window? (A reversal = two consecutive
        transitions in opposite directions.)"""
        horizon = now - self.flap_window_secs
        recent = [d for t, d in state.transitions if t >= horizon]
        recent.append(direction)
        reversals = sum(
            1 for a, b in zip(recent, recent[1:]) if a != b
        )
        return reversals > self.flap_budget

    # -- the decision function ------------------------------------------
    def decide(self, *, live_replicas, candidates, prediction, state, now):
        """One verdict from one consistent read of the fleet. Pure:
        mutates nothing, same inputs ⇒ same Decision."""
        if state.op_in_flight:
            return _hold("scale operation in flight")
        # re-provision FIRST: capacity chaos took is not a scaling
        # oscillation — restoring the target is exempt from the
        # cooldown/flap clamps (but never exceeds max_replicas)
        if live_replicas < min(state.target, self.max_replicas):
            return Decision(
                AUTOSCALE_REPROVISION,
                f"live capacity {live_replicas} below the target "
                f"{state.target} (evicted or dead replicas)",
                None, None,
            )
        overloaded, why = self.overloaded(prediction)
        if overloaded:
            if live_replicas >= self.max_replicas:
                return _hold(
                    f"overloaded ({why}) but at max_replicas "
                    f"{self.max_replicas}", refused=AUTOSCALE_UP,
                    code=REFUSE_MAX_REPLICAS,
                )
            if (
                state.last_scale_at is not None
                and now - state.last_scale_at < self.cooldown_secs
            ):
                return _hold(
                    f"overloaded ({why}) but inside the "
                    f"{self.cooldown_secs:.1f}s cooldown",
                    refused=AUTOSCALE_UP, code=REFUSE_COOLDOWN,
                )
            if self._flap_refused(state, now, "up"):
                return _hold(
                    f"overloaded ({why}) but the flap budget "
                    f"({self.flap_budget} reversals per "
                    f"{self.flap_window_secs:.0f}s) is spent",
                    refused=AUTOSCALE_UP, code=REFUSE_FLAP_BUDGET,
                )
            return Decision(AUTOSCALE_UP, why, None, None)
        if (
            state.headroom_since is not None
            and now - state.headroom_since >= self.hysteresis_secs
        ):
            if live_replicas <= self.min_replicas:
                return _hold(
                    f"sustained headroom but at min_replicas "
                    f"{self.min_replicas}", refused=AUTOSCALE_DOWN,
                    code=REFUSE_MIN_REPLICAS,
                )
            if (
                state.last_scale_at is not None
                and now - state.last_scale_at < self.cooldown_secs
            ):
                return _hold(
                    "sustained headroom but inside the cooldown",
                    refused=AUTOSCALE_DOWN, code=REFUSE_COOLDOWN,
                )
            if self._flap_refused(state, now, "down"):
                return _hold(
                    "sustained headroom but the flap budget is spent",
                    refused=AUTOSCALE_DOWN, code=REFUSE_FLAP_BUDGET,
                )
            victim = self._scale_down_victim(candidates)
            if victim is None:
                return _hold(
                    "sustained headroom but no routable replica to "
                    "retire", refused=AUTOSCALE_DOWN,
                    code=REFUSE_NO_VICTIM,
                )
            return Decision(
                AUTOSCALE_DOWN,
                f"headroom sustained {now - state.headroom_since:.1f}s "
                f"(utilization {prediction.utilization:.2f} under the "
                f"{self.scale_down_utilization:.2f} threshold)",
                victim, None,
            )
        return _hold("within band")

    @staticmethod
    def _scale_down_victim(candidates):
        """Deterministic drain target: the least-loaded candidate, ties
        to the LATEST-registered (autoscaler-spawned capacity retires
        before the configured baseline)."""
        if not candidates:
            return None
        best = min(
            range(len(candidates)),
            key=lambda i: (
                candidates[i][1].get("queue_depth", 0)
                + candidates[i][1].get("active_slots", 0),
                -i,
            ),
        )
        return candidates[best][0]


# ---------------------------------------------------------------------------
# providers: how a backend spawns and retires capacity
# ---------------------------------------------------------------------------
def _mint_replica_id(seq, taken, prefix="as"):
    """Next collision-free autoscaler-minted name (``as0``, ``as1``,
    ...): monotonic within a provider's lifetime, skipping anything the
    fleet already knows (evicted ids included — names never recycle)."""
    while True:
        rid = f"{prefix}{next(seq)}"
        if rid not in taken:
            return rid


class InProcessReplicaProvider:
    """Elastic capacity for the ``in_process`` backend: a spawn is one
    more engine from the same factory, in this process."""

    name = "in_process"

    def __init__(self, engine_factory, *, tracer=None, fault_injector=None):
        self._factory = engine_factory
        self._tracer = tracer
        self._faults = fault_injector
        self._seq = itertools.count()

    def spawn(self, existing_ids):
        from .replica import InProcessReplica

        return InProcessReplica(
            _mint_replica_id(self._seq, set(existing_ids)),
            self._factory,
            tracer=self._tracer, fault_injector=self._faults,
        ).start()

    def retire(self, replica):
        replica.shutdown()


class SubprocessReplicaProvider:
    """Elastic capacity for the ``subprocess`` backend: a spawn is one
    more worker process from the same spec."""

    name = "subprocess"

    def __init__(self, worker_spec, *, rpc_timeout=10.0, rpc_retries=2,
                 rpc_backoff_secs=0.05, fault_injector=None):
        self._spec = dict(worker_spec)
        self._rpc = dict(
            rpc_timeout=rpc_timeout, rpc_retries=rpc_retries,
            rpc_backoff_secs=rpc_backoff_secs,
        )
        self._faults = fault_injector
        self._seq = itertools.count()

    def spawn(self, existing_ids):
        from .replica import SubprocessReplica

        return SubprocessReplica(
            _mint_replica_id(self._seq, set(existing_ids)), self._spec,
            fault_injector=self._faults, **self._rpc,
        ).start()

    def retire(self, replica):
        replica.shutdown()


class SocketNodeProvider:
    """Elastic capacity for the ``socket`` backend: a spawn asks a node
    agent (node.py) to build one more engine over the control session,
    then attaches a :class:`~.transport.SocketReplica` to it; a retire
    shuts the transport down and frees the node's engine.

    Node choice is deterministic: the reachable node hosting the fewest
    live replicas, ties to the lexicographically first name. A node
    whose control op failed (connect refused — SIGKILLed host) is
    skipped for ``node_retry_secs`` so re-provisioning converges on the
    survivors instead of re-dialing the corpse every tick.

    The NODE tier (docs/serving.md "Node failure domain"): with a
    ``provisioner`` (serving/provisioner.py) attached, a spawn that
    finds zero placeable capacity escalates from replicas to nodes —
    a node inside its failure backoff is RE-PROVISIONED under the same
    name (fresh process, new address; its replacement replicas rejoin
    behind the breaker's half-open probation like any spawn), and a
    replica target past every node's ``max_replicas_per_node`` ceiling
    mints a brand-new node (``pn0``, ``pn1``, ... up to ``max_nodes``).
    A retire that empties a provisioner-owned node terminates the node
    whole. Without a provisioner, zero placeable capacity raises the
    typed :class:`NoPlaceableCapacity` the executor records as a
    refusal."""

    name = "socket"

    def __init__(self, nodes, *, engine_spec=None, rpc_timeout=10.0,
                 rpc_retries=2, rpc_backoff_secs=0.05,
                 connect_timeout=10.0, connect_retries=3, lease_secs=10.0,
                 reconnect_attempts=3, reconnect_backoff_secs=0.1,
                 registry=None, fault_injector=None, spawn_timeout=180.0,
                 node_retry_secs=30.0, clock=time.monotonic, epoch=None,
                 provisioner=None, max_replicas_per_node=None,
                 max_nodes=None):
        self._addresses = {
            str(name): block["address"] for name, block in nodes.items()
        }
        if not self._addresses and provisioner is None:
            raise ValueError(
                "SocketNodeProvider needs at least one node (or a "
                "provisioner that can mint one)"
            )
        self._engine_spec = (
            dict(engine_spec) if engine_spec is not None else None
        )
        self.epoch = None if epoch is None else int(epoch)
        self._replica_kw = dict(
            rpc_timeout=rpc_timeout, rpc_retries=rpc_retries,
            rpc_backoff_secs=rpc_backoff_secs,
            connect_timeout=connect_timeout,
            connect_retries=connect_retries, lease_secs=lease_secs,
            reconnect_attempts=reconnect_attempts,
            reconnect_backoff_secs=reconnect_backoff_secs,
            epoch=self.epoch,
        )
        self._registry = registry
        self._faults = fault_injector
        self._spawn_timeout = float(spawn_timeout)
        self.node_retry_secs = float(node_retry_secs)
        self._clock = clock
        self._node_failed_at = {}
        self._seq = itertools.count()
        self.provisioner = provisioner
        self.max_replicas_per_node = (
            None if max_replicas_per_node is None
            else int(max_replicas_per_node)
        )
        self.max_nodes = None if max_nodes is None else int(max_nodes)
        self._node_seq = itertools.count()
        self._live_ids = None

    def note_live_ids(self, live_ids):
        """The router's live (non-evicted) replica view, refreshed by
        the autoscaler ahead of each spawn. Capacity counting must not
        charge a node for replicas the router already evicted — a
        SIGKILLed node would look forever full and re-provisioning
        could never target it — while id-minting still avoids every id
        the router has ever seen (the ``existing_ids`` spawn arg)."""
        self._live_ids = {str(rid) for rid in live_ids}

    def _replica_counts(self, existing_ids):
        ids = self._live_ids if self._live_ids is not None else existing_ids
        counts = {name: 0 for name in self._addresses}
        for rid in ids:
            node, _, _rest = str(rid).partition(":")
            if node in counts:
                counts[node] += 1
        return counts

    def _pick_node(self, existing_ids):
        now = self._clock()
        counts = self._replica_counts(existing_ids)
        reachable = [
            name for name in sorted(self._addresses)
            if now - self._node_failed_at.get(name, -1e18)
            >= self.node_retry_secs
            and (
                self.max_replicas_per_node is None
                or counts[name] < self.max_replicas_per_node
            )
        ]
        if not reachable:
            return None
        return min(reachable, key=lambda n: (counts[n], n))

    def _provision_node(self, existing_ids):
        """Zero placeable replica capacity: escalate to the node tier.
        Deterministic order — re-provision the lexicographically first
        dead (backed-off) node under its own name; with no corpse to
        replace, mint a new node name if ``max_nodes`` allows; else
        raise the typed refusal."""
        if self.provisioner is None:
            raise NoPlaceableCapacity(
                "no placeable node to spawn on (every node dead inside "
                f"its {self.node_retry_secs:.0f}s failure backoff or at "
                f"its {self.max_replicas_per_node} replicas-per-node "
                "ceiling) and no provisioner is configured"
            )
        now = self._clock()
        dead = sorted(
            name for name in self._addresses
            if now - self._node_failed_at.get(name, -1e18)
            < self.node_retry_secs
        )
        if dead:
            node = dead[0]
            logger.warning(
                "fleet autoscaler: re-provisioning dead node %s through "
                "the provisioner", node,
            )
        else:
            if (
                self.max_nodes is not None
                and len(self._addresses) >= self.max_nodes
            ):
                raise NoPlaceableCapacity(
                    f"every live node is at its replica ceiling and the "
                    f"fleet is at max_nodes={self.max_nodes}"
                )
            node = _mint_replica_id(
                self._node_seq, set(self._addresses), prefix="pn"
            )
            logger.warning(
                "fleet autoscaler: replica target exceeds live-node "
                "capacity — provisioning new node %s", node,
            )
        try:
            handle = self.provisioner.launch_node(node)
        except Exception as e:
            self._node_failed_at[node] = self._clock()
            raise NoPlaceableCapacity(
                f"provisioning node {node!r} failed: {e}"
            ) from e
        self._addresses[node] = handle.address
        self._node_failed_at.pop(node, None)
        return node

    def spawn(self, existing_ids):
        from .transport import NodeControlClient, SocketReplica

        node = self._pick_node(existing_ids)
        if node is None:
            node = self._provision_node(existing_ids)
        address = self._addresses[node]
        name = _mint_replica_id(self._seq, {
            str(rid).partition(":")[2] for rid in existing_ids
            if str(rid).startswith(f"{node}:")
        })
        try:
            NodeControlClient(
                address, op_timeout=self._spawn_timeout,
                epoch=self.epoch,
            ).spawn_replica(name, spec=self._engine_spec)
        except (OSError, ConnectionError, TimeoutError, RuntimeError):
            self._node_failed_at[node] = self._clock()
            raise
        self._node_failed_at.pop(node, None)
        return SocketReplica(
            f"{node}:{name}", address, remote_name=name,
            registry=self._registry, fault_injector=self._faults,
            **self._replica_kw,
        ).start()

    def retire(self, replica):
        from .transport import NodeControlClient

        replica.shutdown()
        node, _, name = str(replica.replica_id).partition(":")
        address = self._addresses.get(node)
        if address is None:
            return
        remaining = None
        try:
            reply = NodeControlClient(
                address, epoch=self.epoch,
            ).retire_replica(getattr(replica, "remote_name", name))
            remaining = reply.get("replicas")
        except Exception as e:
            # the node may be dead — the transport shutdown already
            # freed the router side; never fail a scale-down on it
            count_suppressed("serving.autoscale_node_retire", e)
        if (
            remaining == []
            and self.provisioner is not None
            and node in self.provisioner.list_nodes()
        ):
            # drain-then-terminate: the retire above was the node's last
            # replica, and the provisioner owns the process — release
            # the whole host instead of idling an empty agent forever
            try:
                self.provisioner.terminate_node(node)
            except Exception as e:
                count_suppressed("serving.autoscale_node_terminate", e)
            else:
                # back off the address until a future escalation
                # re-provisions it — _pick_node must not dial the corpse
                self._node_failed_at[node] = self._clock()
                logger.warning(
                    "fleet autoscaler: scale_down emptied node %s — "
                    "terminated it through the provisioner", node,
                )

    def close(self):
        """Shutdown sweep: release every provisioner-owned node (their
        processes belong to this router's life)."""
        if self.provisioner is not None:
            self.provisioner.close()


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
class Autoscaler:
    """Ticks on the router monitor's cadence; one scale operation in
    flight at a time, executed on a short-lived worker thread so an
    engine build never stalls the monitor's sweeps. Construct via
    :func:`deepspeed_tpu_torch.serving.init_fleet` (the ``serving.autoscale``
    block) or directly for programmatic fleets; the router calls
    :meth:`attach` when it takes ownership."""

    def __init__(self, provider, *, slo=None, min_replicas=1,
                 max_replicas=4, cooldown_secs=30.0, hysteresis_secs=60.0,
                 flap_budget=4, flap_window_secs=600.0,
                 scale_up_utilization=0.85, scale_down_utilization=0.3,
                 interval_secs=1.0, drain_timeout_secs=30.0,
                 brownout_queue_ratio=None, cost_model=None,
                 clock=time.monotonic):
        self.provider = provider
        self.policy = AutoscalerPolicy(
            slo=slo, min_replicas=min_replicas, max_replicas=max_replicas,
            cooldown_secs=cooldown_secs, hysteresis_secs=hysteresis_secs,
            flap_budget=flap_budget, flap_window_secs=flap_window_secs,
            scale_up_utilization=scale_up_utilization,
            scale_down_utilization=scale_down_utilization,
            brownout_queue_ratio=brownout_queue_ratio,
        )
        self.model = cost_model if cost_model is not None else (
            PhaseCostModel()
        )
        self.budget = ErrorBudget(self.policy.slo.eval_window_secs)
        self.state = AutoscaleState()
        self.interval_secs = float(interval_secs)
        self.drain_timeout_secs = float(drain_timeout_secs)
        self._clock = clock
        self._router = None
        self._last_eval = None
        self._last_routed = None
        self._last_routed_at = None
        self._last_completed = 0
        self._arrival_rps = 0.0
        self._op_thread = None
        self._closed = False
        self._last_refused = None

    # -- wiring ----------------------------------------------------------
    def attach(self, router):
        """Adopt ``router``: register the slo/autoscale gauge handles on
        its registry and anchor the target at the live fleet size
        (clamped into [min, max] — a fleet built below min_replicas
        re-provisions up to it on the first tick)."""
        self._router = router
        reg = router.metrics
        self._g_target = reg.gauge("fleet/autoscale_target_replicas")
        self._g_slo_ttft = reg.gauge("fleet/slo_ttft_p99_ms")
        self._g_slo_token = reg.gauge("fleet/slo_token_p99_ms")
        self._g_pred_ttft = reg.gauge("fleet/slo_predicted_ttft_ms")
        self._g_pred_token = reg.gauge("fleet/slo_predicted_token_ms")
        self._g_util = reg.gauge("fleet/slo_utilization")
        self._g_budget = reg.gauge("fleet/slo_error_budget_remaining")
        self._c_violations = reg.counter("fleet/slo_violations")
        # paired with violations so any windowed reader (the telemetry
        # hub's burn-rate windows) can form the violation FRACTION from
        # two counter deltas
        self._c_samples = reg.counter("fleet/slo_samples")
        self._c_ups = reg.counter("fleet/autoscale_ups")
        self._c_downs = reg.counter("fleet/autoscale_downs")
        self._c_reprovisions = reg.counter("fleet/autoscale_reprovisions")
        self._c_refusals = reg.counter("fleet/autoscale_refusals")
        self._c_failures = reg.counter("fleet/autoscale_failures")
        self._registry = reg
        if self.policy.brownout_queue_ratio is None:
            self.policy.brownout_queue_ratio = router.brownout_queue_ratio
        live = len(router.live_replica_ids())
        self.state.target = min(
            max(live, self.policy.min_replicas), self.policy.max_replicas
        )
        self._g_target.set(self.state.target)
        self._g_slo_ttft.set(self.policy.slo.ttft_p99_ms or 0.0)
        self._g_slo_token.set(self.policy.slo.token_p99_ms or 0.0)
        self._g_budget.set(1.0)
        return self

    # -- durable control plane (journal.py) ------------------------------
    def journal_snapshot(self):
        """The autoscaler's durable half for the fleet journal: target,
        cooldown anchor, hysteresis anchor, and the flap-budget evidence
        — every monotonic stamp converted to wall clock, because a
        monotonic reading is meaningless in the next process.
        ``op_in_flight`` is deliberately transient: the op thread dies
        with the router, and recovery re-provisions through the normal
        tick instead of trusting a journaled promise."""
        now_m = self._clock()
        now_w = time.time()

        def to_wall(stamp):
            return (
                None if stamp is None
                else now_w - (now_m - float(stamp))
            )

        return {
            "target": int(self.state.target),
            "last_scale_unix": to_wall(self.state.last_scale_at),
            "headroom_since_unix": to_wall(self.state.headroom_since),
            "transitions": [
                [to_wall(t), str(d)] for t, d in self.state.transitions
            ],
        }

    def restore_journal(self, snap):
        """Re-adopt a journaled snapshot (the reverse wall→monotonic
        conversion) — the router's adoption completion calls this AFTER
        :meth:`attach` anchored the target at the live count, so the
        journaled target wins (re-clamped into [min, max]): a crash
        mid-cooldown stays in cooldown, and flap evidence keeps
        counting against the budget instead of resetting free."""
        now_m = self._clock()
        now_w = time.time()

        def to_mono(stamp):
            return (
                None if stamp is None
                else now_m - (now_w - float(stamp))
            )

        snap = dict(snap or {})
        if "target" in snap:
            self.state.target = min(
                max(int(snap["target"]), self.policy.min_replicas),
                self.policy.max_replicas,
            )
        self.state.last_scale_at = to_mono(snap.get("last_scale_unix"))
        self.state.headroom_since = to_mono(
            snap.get("headroom_since_unix")
        )
        self.state.transitions = tuple(
            (to_mono(t), str(d))
            for t, d in (snap.get("transitions") or ())
        )
        self.state.op_in_flight = False
        gauge = getattr(self, "_g_target", None)
        if gauge is not None:
            gauge.set(self.state.target)
        return self

    # -- the tick --------------------------------------------------------
    def tick(self, now=None):
        """One evaluation, rate-limited to ``interval_secs``; returns
        the :class:`Decision` (None when the interval has not elapsed).
        Called from the router's monitor thread.

        Cost note: each evaluation takes its own snapshot pass
        (``router._candidates()`` — one RPC per remote replica), on top
        of the passes the monitor's zombie sweep and telemetry refresh
        already make. At the default 1s interval that is one extra
        round per second; raise ``interval_secs`` on large socket
        fleets, or unify the monitor's snapshot plumbing if this ever
        shows up in profiles."""
        router = self._router
        if router is None or self._closed:
            return None
        now = self._clock() if now is None else float(now)
        if (
            self._last_eval is not None
            and now - self._last_eval < self.interval_secs
        ):
            return None
        self._last_eval = now
        live_ids = router.live_replica_ids()
        candidates = router._candidates()
        self.model.observe(candidates)
        arrival = self._update_arrival(router, now)
        prediction = self.model.predict(candidates, arrival)
        self._account_slo(router, prediction, now)
        headroom = self.policy.has_headroom(prediction, len(live_ids))
        if headroom:
            if self.state.headroom_since is None:
                self.state.headroom_since = now
        else:
            self.state.headroom_since = None
        decision = self.policy.decide(
            live_replicas=len(live_ids), candidates=candidates,
            prediction=prediction, state=self.state, now=now,
        )
        self._g_target.set(self.state.target)
        if decision.refused is not None:
            self._record_refusal(
                decision.refused_code, decision.refused, decision.reason,
            )
        elif decision.action == AUTOSCALE_HOLD:
            # a healthy hold ends any refusal streak; a launched op's
            # outcome (success resets, NoPlaceableCapacity extends)
            # settles on the op thread
            self._last_refused = None
        if decision.action != AUTOSCALE_HOLD:
            self._launch(decision)
        return decision

    def _record_refusal(self, code, refused_action, reason):
        """One refused transition: the aggregate counter, the per-reason
        labeled counter, and — on the transition INTO this refusal
        state, not on every spinning tick — a warning plus a
        flight-recorder instant so postmortems see exactly when the
        fleet started wanting capacity it could not get."""
        self._c_refusals.inc()
        if code:
            self._registry.counter(
                f"fleet/autoscale_refusals/{code}",
                help="autoscale refusals, labeled by reason",
            ).inc()
        if reason != self._last_refused:
            self._last_refused = reason
            logger.warning(
                "fleet autoscaler: refusing %s — %s",
                refused_action, reason,
            )
            self._event("refused", reason, replica=None)

    def _update_arrival(self, router, now):
        hub = getattr(router, "hub", None)
        if hub is not None:
            # the telemetry hub retains fleet/requests_routed in its
            # time-series ring: read the observed windowed rate from the
            # shared plane instead of keeping private bookkeeping — the
            # same number /statz and the alert rules see. Falls through
            # to the private EWMA until the ring holds two points (hub
            # just started) so early ticks behave exactly like a
            # hub-less fleet.
            rate = hub.observed_rate(
                "fleet/requests_routed", self.policy.slo.eval_window_secs,
            )
            if rate is not None:
                self._arrival_rps = float(rate)
                return self._arrival_rps
        routed = int(router.metrics.counter("fleet/requests_routed").value)
        if self._last_routed is None:
            self._last_routed, self._last_routed_at = routed, now
            return self._arrival_rps
        dt = now - self._last_routed_at
        if dt <= 0:
            return self._arrival_rps
        inst = (routed - self._last_routed) / dt
        self._arrival_rps += 0.5 * (inst - self._arrival_rps)
        self._last_routed, self._last_routed_at = routed, now
        return self._arrival_rps

    def _account_slo(self, router, prediction, now):
        """Export the prediction + run the error-budget bookkeeping
        against the OBSERVED fleet TTFT p99 (a sample is recorded only
        on ticks where new completions landed — an idle fleet neither
        spends nor earns budget)."""
        self._g_pred_ttft.set(prediction.ttft_ms)
        self._g_pred_token.set(prediction.token_ms)
        self._g_util.set(prediction.utilization)
        slo = self.policy.slo
        completed = int(
            router.metrics.counter("fleet/requests_completed").value
        )
        if slo.ttft_p99_ms is not None and completed > self._last_completed:
            observed = histogram_quantile(
                router.metrics.histogram("fleet/ttft_ms"), 0.99
            )
            violated = observed > slo.ttft_p99_ms
            self.budget.record(now, violated)
            self._c_samples.inc()
            if violated:
                self._c_violations.inc()
        self._last_completed = completed
        hub = getattr(router, "hub", None)
        if hub is not None:
            # prefer the hub's windowed budget (computed from the
            # retained slo_violations/slo_samples counter rings — the
            # number /statz serves); the private deque stays authoritative
            # until the ring warms up, and for hub-less fleets forever
            remaining = hub.error_budget_remaining(
                slo.eval_window_secs, now=None,
            )
            if remaining is not None:
                self._g_budget.set(remaining)
                return
        self._g_budget.set(self.budget.remaining(now))

    # -- execution -------------------------------------------------------
    def _launch(self, decision):
        if self._closed:
            # close() landed between this tick's decision and its
            # launch: a spawn during fleet teardown would leak an engine
            return
        self.state.op_in_flight = True
        self._op_thread = threading.Thread(
            target=self._execute, args=(decision,),
            name="ds-autoscale-op", daemon=True,
        )
        self._op_thread.start()

    def _event(self, action, reason, replica=None):
        tracer = self._router.tracer
        if tracer.enabled:
            tracer.event(
                "router.autoscale",
                attrs={"action": action, "reason": reason,
                       "replica": replica,
                       "target": int(self.state.target)},
            )

    def _execute(self, decision):
        router = self._router
        try:
            if decision.action in (AUTOSCALE_UP, AUTOSCALE_REPROVISION):
                existing = set(router.replica_ids) | router.evicted_ids
                note = getattr(self.provider, "note_live_ids", None)
                if note is not None:
                    # node-tier providers count capacity from the LIVE
                    # view (evicted replicas hold no slots) while still
                    # minting ids clear of everything ever registered
                    note(router.live_replica_ids())
                replica = self.provider.spawn(existing)
                try:
                    router.add_replica(replica, probation=True)
                except Exception:
                    try:
                        self.provider.retire(replica)
                    except Exception as e:
                        count_suppressed("serving.autoscale_retire", e)
                    raise
                now = self._clock()
                if decision.action == AUTOSCALE_UP:
                    self.state.target += 1
                    self.state.last_scale_at = now
                    self.state.transitions += ((now, "up"),)
                    self._c_ups.inc()
                else:
                    self._c_reprovisions.inc()
                logger.warning(
                    "fleet autoscaler: %s — replica %s joined behind its "
                    "half-open probe (%s)", decision.action,
                    replica.replica_id, decision.reason,
                )
                self._event(decision.action, decision.reason,
                            replica=replica.replica_id)
            elif decision.action == AUTOSCALE_DOWN:
                replica = router.remove_replica(
                    decision.replica_id,
                    wait_idle_timeout=self.drain_timeout_secs,
                )
                try:
                    self.provider.retire(replica)
                except Exception as e:
                    count_suppressed("serving.autoscale_retire", e)
                now = self._clock()
                self.state.target -= 1
                self.state.last_scale_at = now
                self.state.transitions += ((now, "down"),)
                self._c_downs.inc()
                logger.warning(
                    "fleet autoscaler: scale_down — replica %s drained "
                    "and retired (%s)", decision.replica_id,
                    decision.reason,
                )
                self._event(AUTOSCALE_DOWN, decision.reason,
                            replica=decision.replica_id)
            self._last_refused = None
        except NoPlaceableCapacity as e:
            # not a failure — a typed refusal: the fleet WANTS capacity
            # and structurally cannot place it; counted with its reason
            # label and flight-recorded on the transition instead of
            # spinning silently through _c_failures every tick
            self._record_refusal(e.reason, decision.action, str(e))
            count_suppressed("serving.autoscale_no_capacity", e)
        except Exception as e:
            self._c_failures.inc()
            logger.warning(
                "fleet autoscaler: %s failed (%r); will re-evaluate next "
                "tick", decision.action, e,
            )
            count_suppressed("serving.autoscale_op", e)
        finally:
            # prune the flap evidence outside the window while we hold
            # the op slot (keeps the tuple bounded on long-lived fleets)
            horizon = self._clock() - self.policy.flap_window_secs
            self.state.transitions = tuple(
                (t, d) for t, d in self.state.transitions if t >= horizon
            )
            self.state.op_in_flight = False

    def close(self, timeout=30.0):
        """Stop evaluating and wait out any in-flight scale operation
        (the router calls this from shutdown()); then release whatever
        the provider owns (provisioned node processes)."""
        self._closed = True
        t = self._op_thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._op_thread = None
        provider_close = getattr(self.provider, "close", None)
        if provider_close is not None:
            try:
                provider_close()
            except Exception as e:
                count_suppressed("serving.autoscale_provider_close", e)
