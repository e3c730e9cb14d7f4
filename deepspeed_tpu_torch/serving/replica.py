"""Replica: one serving engine behind a uniform lifecycle surface.

Port of deepspeed_tpu/serving/replica.py. The fleet router (router.py)
never touches an ``InferenceEngine`` directly — it speaks to
:class:`InProcessReplica` / :class:`SubprocessReplica` /
:class:`SocketReplica` (transport.py), all exposing the same contract:

    submit(prompt, **kw) -> request handle   (.done/.tokens/.finish_reason
                                              /.first_token_at/.result())
    load_snapshot() -> dict                  (the scheduler's router-facing
                                              load/health view, plus
                                              "alive"/"failed" flags)
    drain() / wait_idle() / restart() / shutdown()

``InProcessReplica`` wraps an engine built by a caller-supplied factory —
N replicas in one process, zero-copy, sharing the host's devices.
``SubprocessReplica`` runs one engine per worker process (worker.py)
speaking newline-JSON RPC over stdin/stdout, so a replica that segfaults
or OOMs cannot take the router (or its sibling replicas) down — the
process exit IS the failure signal, and the router re-routes.
The JAX package's ``SocketReplica`` (its serving/transport.py) speaks
the SAME newline-JSON protocol over TCP to a node agent hosting N
replicas on another host — the multi-host form of the same contract.

The remote transports share :class:`RpcReplicaBase`: rpc-id bookkeeping,
reply waiting with late-reply discard, idempotent-control-op retry,
lost-completion reconciliation, and the protocol-version handshake — the
pipe and the socket differ only in how bytes move.

Failure semantics: ``failed`` is True only when the replica died WITHOUT
being asked (decode driver past its restart budget in-process; unexpected
process exit for subprocess; a dead, reconnect-exhausted connection for
sockets). A drained or shut-down replica is not routable but not failed —
eviction is for corpses, not for lifecycle.
"""

import json
import os
import subprocess
import sys
import threading
import time

from ..inference.scheduler import (
    REJECT_DRAINING,
    REJECT_REASONS,
    RequestRejected,
)
from ..resilience.faults import NULL_INJECTOR
from ..telemetry.registry import count_suppressed
from ..utils.logging import logger

_FINISH_ERROR = "error"
_FINISH_CANCELLED = "cancelled"

# The replica RPC's wire protocol version (pipes AND sockets — one
# protocol, two transports). Bumped on any frame-schema change; both
# ends announce theirs at the handshake (the worker's ``ready`` event,
# the node's ``welcome`` frame) and a mismatch fail-fasts with a typed
# :class:`ReplicaProtocolError` naming both versions instead of counting
# undecodable frames until a circuit breaker opens.
RPC_PROTOCOL_VERSION = 1


class ReplicaRPCError(RequestRejected):
    """The replica's TRANSPORT failed — a dead/closed pipe or socket, a
    corrupted or missing ack, an RPC timeout — as opposed to the engine
    answering with a real rejection. Subclasses RequestRejected (reason
    ``"draining"``) so every existing fall-through keeps working, while
    the router's circuit breakers can count exactly these as replica
    failures (docs/serving.md "Circuit breakers")."""

    def __init__(self, message, reason=REJECT_DRAINING):
        super().__init__(message, reason=reason)


class ReplicaProtocolError(ReplicaRPCError):
    """Protocol-version mismatch caught at the handshake: the two ends
    speak different frame schemas, so every subsequent line would be
    noise. Raised ONCE, naming both versions — never diagnosed one
    undecodable frame at a time."""


class FencedOut(ReplicaRPCError):
    """The node rejected this session's incarnation epoch: a NEWER
    router has since presented a higher epoch, so this side is a stale
    incarnation that must stand down instead of double-driving sessions
    a live router already owns (docs/serving.md "Epoch fencing").
    Terminal — the transport never retries or reconnects through it."""

    def __init__(self, message, *, epoch=None, high_water=None):
        super().__init__(message)
        self.epoch = epoch
        self.high_water = high_water


class ReplicaBase:
    """Shared lifecycle helpers; subclasses implement the transport.

    ``fault_injector`` (resilience/faults.py) arms the serving-tier
    chaos sites on this replica: ``snapshot.stale`` here in the shared
    :meth:`load_snapshot`, ``replica.flap`` at the subclasses' start(),
    the ``rpc.*`` pipe sites in the subprocess transport, and the
    ``net.*``/``conn.*``/``frame.corrupt`` socket sites in the socket
    transport."""

    def __init__(self, replica_id, fault_injector=None):
        self.replica_id = str(replica_id)
        self.faults = (
            fault_injector if fault_injector is not None else NULL_INJECTOR
        )
        self._stale_snapshot = None

    def load_snapshot(self):
        """The router-facing load/health view. Fault site
        ``snapshot.stale``: an armed traversal returns the PREVIOUS
        call's frozen values — the router must survive scoring (and
        zombie-sweeping) on stale load data."""
        if (
            self.faults.enabled
            and self._stale_snapshot is not None
            and self.faults.fire("snapshot.stale") is not None
        ):
            return dict(self._stale_snapshot)
        snap = self._snapshot_now()
        if self.faults.enabled:
            self._stale_snapshot = dict(snap)
        return snap

    def _snapshot_now(self):  # pragma: no cover - interface
        raise NotImplementedError

    def wait_idle(self, timeout=30.0, poll=0.005):
        """Block until the replica has nothing queued and nothing in a
        slot (the drain barrier before a restart). Returns True when
        idle; False on timeout or a replica that died while draining."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            snap = self.load_snapshot()
            if snap.get("failed"):
                return False
            if snap.get("unresponsive"):
                time.sleep(poll)
                continue  # alive but not answering: neither idle nor dead
            if not snap.get("alive"):
                return True  # already stopped: nothing can be in flight
            if snap["queue_depth"] == 0 and snap["active_slots"] == 0:
                return True
            time.sleep(poll)
        return False


class InProcessReplica(ReplicaBase):
    """One engine in this process, rebuilt from ``engine_factory`` on
    every (re)start — a restart is a fresh KV cache, fresh scheduler,
    fresh driver thread over freshly-pinned params, exactly what a
    process restart would give, minus the process."""

    def __init__(self, replica_id, engine_factory, tracer=None,
                 fault_injector=None):
        super().__init__(replica_id, fault_injector=fault_injector)
        self._factory = engine_factory
        # fleet-owned tracer injected into every engine this replica
        # builds, so in-process scheduler spans land in the router's
        # trace file (telemetry/tracing.py); None leaves the engine's
        # own (usually NOOP) tracer alone
        self._tracer = tracer
        self.engine = None
        self._shutdown_requested = False

    def start(self):
        if self.engine is not None:
            return self
        # fault site: a replica that crashes every time it is brought
        # (back) up — the router's restart path must absorb the flap
        self.faults.maybe_raise("replica.flap")
        self._shutdown_requested = False
        self.engine = self._factory()
        if self._tracer is not None:
            use = getattr(self.engine, "use_tracer", None)
            if use is not None:
                use(self._tracer)
        # replica-prefixed globally-unique request ids (fleet telemetry
        # must never see two replicas minting the same id)
        sched = getattr(self.engine, "scheduler", None)
        set_prefix = getattr(sched, "set_id_prefix", None)
        if set_prefix is not None:
            set_prefix(self.replica_id)
        self.engine.serve_forever()
        return self

    # -- serving --------------------------------------------------------
    # every method captures self.engine ONCE: a concurrent restart()/
    # shutdown() nulling the attribute between a check and a use must
    # read as a rejection/dead snapshot, never an AttributeError leaking
    # through the router's RequestRejected handling
    def submit(self, prompt_tokens, **kwargs):
        engine = self.engine
        if engine is None:
            raise RequestRejected(
                f"replica {self.replica_id} is not running",
                reason=REJECT_DRAINING,
            )
        return engine.submit(prompt_tokens, **kwargs)

    def cancel_request(self, handle):
        """Withdraw ``handle`` (an InferenceRequest): queued it never
        takes a slot; decoding its slot frees within one decode step —
        the HTTP door's client-disconnect path (docs/serving.md)."""
        cancel = getattr(handle, "cancel", None)
        if cancel is not None:
            cancel()

    def _snapshot_now(self):
        engine = self.engine
        if engine is None:
            return _dead_snapshot(failed=False)
        snap = engine.load_snapshot()
        snap["alive"] = not snap["stopped"]
        snap["failed"] = bool(snap["driver_failed"])
        return snap

    def set_brownout(self, on):
        """Brownout propagation (docs/serving.md): the engine skips
        prefix-miss registration work while the fleet is browned out.
        Best-effort — engines without the hook are left alone."""
        engine = self.engine
        hook = getattr(engine, "set_brownout", None)
        if hook is not None:
            hook(bool(on))

    def load_adapter(self, name, **kwargs):
        """Install a LoRA adapter into this replica's device pool
        (docs/adapters.md); accepts the engine's ``adapter_state`` /
        ``load_dir`` / ``tag`` kwargs."""
        engine = self.engine
        if engine is None:
            raise RuntimeError(
                f"replica {self.replica_id} is not running"
            )
        return engine.load_adapter(name, **kwargs)

    def unload_adapter(self, name):
        engine = self.engine
        if engine is None:
            raise RuntimeError(
                f"replica {self.replica_id} is not running"
            )
        return engine.unload_adapter(name)

    # -- lifecycle ------------------------------------------------------
    def drain(self):
        engine = self.engine
        if engine is not None:
            engine.scheduler.drain()

    def restart(self):
        """Tear the engine down (outstanding requests fail-finish — the
        router drains first on the graceful path) and rebuild it from the
        factory."""
        self.shutdown()
        return self.start()

    def shutdown(self):
        engine = self.engine
        if engine is not None:
            self._shutdown_requested = True
            self.engine = None
            engine.close()

    @property
    def alive(self):
        engine = self.engine
        return (
            engine is not None
            and not engine.scheduler._stop.is_set()
        )

    @property
    def failed(self):
        engine = self.engine
        return engine is not None and engine.scheduler.driver_failed


# ---------------------------------------------------------------------------
# remote backends: the shared newline-JSON RPC state machine
# ---------------------------------------------------------------------------
class RemoteRequest:
    """Parent-side handle mirroring InferenceRequest's result surface for
    a request running inside a worker process or on a remote node.
    Completed by the replica's reader thread when the remote side reports
    ``finished``; ``token`` events stream tokens in incrementally (the
    HTTP door's SSE source for remote replicas)."""

    def __init__(self, rpc_id, prompt_tokens, max_new_tokens):
        self.rpc_id = rpc_id
        self.prompt_tokens = list(prompt_tokens)
        self.max_new_tokens = int(max_new_tokens)
        self.created_at = time.monotonic()
        self.tokens = []
        self.finish_reason = None
        self.first_token_at = None
        # worker-side trace spans shipped back with the finished event
        # (telemetry/tracing.py): the router ingests them so the fleet
        # request's trace is whole in one file
        self.trace_spans = []
        self._done = threading.Event()

    @property
    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"remote request {self.rpc_id} not finished after {timeout}s"
            )
        return self.tokens

    def _append_token(self, index, token):
        """One streamed token. ``index`` is the token's absolute position
        so re-emits after a reconnect-with-resume (transport.py) are
        idempotent: duplicates and already-seen prefixes are dropped, a
        gap waits for the authoritative ``finished`` list."""
        if token is None:
            return
        if index is None or int(index) == len(self.tokens):
            self.tokens.append(int(token))

    def _finish(self, tokens, reason):
        self.tokens = list(tokens)
        self.finish_reason = reason
        self._done.set()


class RpcReplicaBase(ReplicaBase):
    """The transport-agnostic half of a remote replica: rpc-id minting,
    reply waiting with late-reply discard, idempotent-control-op retry
    with backoff, the submit/adapter/snapshot ops, lost-completion
    reconciliation, and the protocol handshake check. Subclasses provide
    the byte movement:

        _send(msg)           one JSON-safe dict to the remote side
        _transport_alive()   is the pipe/socket still usable?

    and feed inbound messages to :meth:`_dispatch` from their reader
    thread, calling :meth:`_on_transport_eof` when the stream ends."""

    def __init__(self, replica_id, *, rpc_timeout=10.0, rpc_retries=2,
                 rpc_backoff_secs=0.05, fault_injector=None):
        super().__init__(replica_id, fault_injector=fault_injector)
        self._rpc_timeout = float(rpc_timeout)
        # idempotent control ops (snapshot / drain / adapter management)
        # retry transient transport failures with exponential backoff;
        # generate submissions NEVER retry — a duplicate submit is a
        # duplicate generation (docs/serving.md "RPC retries")
        self._rpc_retries = int(rpc_retries)
        self._rpc_backoff_secs = float(rpc_backoff_secs)
        self.rpc_retries_used = 0
        # after an unresponsive verdict, snapshot calls inside this
        # window answer from the verdict instead of burning another
        # (retries+1) x timeout — one hung worker must not stall every
        # placement pass for the full retry budget
        self._unresponsive_until = 0.0
        self._write_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._rpc_ids = iter(range(1, 1 << 62)).__next__
        # high-water mark of minted rpc ids: the fleet journal records
        # it with the session descriptor so a restarted router can
        # re-base above every id this incarnation ever used
        self._rpc_seq = 0
        self._outstanding = {}   # rpc_id -> RemoteRequest
        self._replies = {}       # rpc_id -> reply payload
        self._expected = set()   # rpc_ids with a live reply waiter
        self._reply_cond = threading.Condition()
        self._ready = threading.Event()
        # the remote side's protocol version, captured at the handshake
        # (None until it announces; pre-handshake peers read as v0)
        self._remote_proto = None
        self._shutdown_requested = False

    # -- transport hooks -------------------------------------------------
    def _send(self, msg):  # pragma: no cover - interface
        raise NotImplementedError

    def _transport_alive(self):  # pragma: no cover - interface
        raise NotImplementedError

    def _transport_recovering(self):
        """True while the transport is down but may still heal on its
        own (the socket transport's reconnect-with-resume window): the
        replica then reads UNRESPONSIVE — steered around, zombie-watched
        — instead of failed-and-evicted. Pipes never recover."""
        return False

    def _transport_dead_exc(self, detail):
        """The exception for an op against a dead transport. A REQUESTED
        shutdown/drain classifies as an ordinary ``"draining"`` rejection
        (the router's breakers treat it as an answered door, resetting
        the failure streak); anything else is :class:`ReplicaRPCError` —
        breaker food."""
        if self._shutdown_requested:
            return RequestRejected(
                f"replica {self.replica_id} is shut down ({detail})",
                reason=REJECT_DRAINING,
            )
        return ReplicaRPCError(f"replica {self.replica_id} {detail}")

    def _mint_rpc_id(self):
        """Mint the next rpc id and advance the high-water mark (the
        journal's re-base evidence). Atomic under the GIL — both the
        iterator step and the monotone hwm write are single ops."""
        rpc_id = self._rpc_ids()
        self._rpc_seq = rpc_id
        return rpc_id

    def _rebase_rpc_ids(self, base):
        """Restart id minting ABOVE ``base``: an adopted node session
        still tracks the previous incarnation's rpc ids, and a new
        submit reusing one would cross-wire the node's in-flight table
        onto the wrong request."""
        base = int(base)
        self._rpc_ids = iter(range(base + 1, 1 << 62)).__next__
        self._rpc_seq = base

    @property
    def rpc_seq(self):
        """Highest rpc id minted by this incarnation (journal surface)."""
        return self._rpc_seq

    def _reset_rpc_state(self):
        """Called at (re)start: stale RPC state from a previous
        incarnation must not leak into (or slowly grow across)
        restarts."""
        self._ready.clear()
        self._remote_proto = None
        with self._reply_cond:
            self._replies.clear()
            self._expected.clear()
        with self._state_lock:
            self._outstanding.clear()
        self._unresponsive_until = 0.0

    def _check_protocol(self):
        """Handshake gate: raise a typed error naming BOTH versions when
        the remote side speaks a different frame schema. A peer that
        never announced a version is v0 — the pre-handshake protocol."""
        remote = 0 if self._remote_proto is None else int(self._remote_proto)
        if remote != RPC_PROTOCOL_VERSION:
            self.shutdown()
            raise ReplicaProtocolError(
                f"replica {self.replica_id}: RPC protocol version "
                f"mismatch — this router speaks v{RPC_PROTOCOL_VERSION}, "
                f"the remote side answered v{remote}; upgrade the older "
                f"side before routing traffic through it"
            )

    # -- inbound ---------------------------------------------------------
    def _dispatch(self, msg):
        event = msg.get("event")
        if event == "ready":
            self._remote_proto = msg.get("proto", 0)
            self._ready.set()
        elif event == "reply":
            with self._reply_cond:
                # drop replies nobody waits for anymore (the caller timed
                # out): storing them would grow _replies forever against
                # a periodically-slow worker
                if msg["id"] in self._expected:
                    self._replies[msg["id"]] = msg
                    self._reply_cond.notify_all()
        elif event == "first_token":
            with self._state_lock:
                req = self._outstanding.get(msg["id"])
            if req is not None and req.first_token_at is None:
                req.first_token_at = time.monotonic()
        elif event == "token":
            # incremental token stream (worker watch loop / node watcher):
            # what the HTTP door's SSE path reads between TTFT and finish
            with self._state_lock:
                req = self._outstanding.get(msg["id"])
            if req is not None:
                if req.first_token_at is None:
                    req.first_token_at = time.monotonic()
                req._append_token(msg.get("i"), msg.get("t"))
        elif event == "finished":
            with self._state_lock:
                req = self._outstanding.pop(msg["id"], None)
            if req is not None:
                if req.first_token_at is None and msg.get("tokens"):
                    req.first_token_at = time.monotonic()
                req.trace_spans = msg.get("spans") or []
                req._finish(msg.get("tokens", []), msg.get("reason"))
        elif not self._dispatch_extra(msg):
            logger.warning(
                "replica %s: unknown remote event %r",
                self.replica_id, event,
            )
            count_suppressed("serving.rpc_unknown_event")

    def _dispatch_extra(self, msg):
        """Subclass hook for transport-level events (pong, welcome, ...);
        return True when the message was handled."""
        del msg
        return False

    def _on_transport_eof(self, graceful):
        """The inbound stream ended: fail everything still outstanding so
        the router's monitor re-routes instead of waiting forever. A
        GRACEFUL end (requested shutdown/drain) finishes orphans
        ``"cancelled"`` quietly; a killed transport finishes them
        ``"error"`` and counts the event — clean shutdowns must not read
        like crashes in the diagnostics (or feed breaker streaks via the
        woken waiters, which classify through
        :meth:`_transport_dead_exc`)."""
        with self._state_lock:
            orphans = list(self._outstanding.values())
            self._outstanding.clear()
        if orphans and not graceful:
            # diagnostics BEFORE the finishes below wake any waiters: a
            # caller observing a request fail must already see the death
            # counted, not race the counter on another thread
            logger.warning(
                "replica %s: transport died with %d request(s) in flight; "
                "failing them for re-route", self.replica_id, len(orphans),
            )
            count_suppressed("serving.transport_died_inflight")
        for req in orphans:
            req._finish(req.tokens, _FINISH_CANCELLED if graceful
                        else _FINISH_ERROR)
        with self._reply_cond:
            self._reply_cond.notify_all()

    # -- outbound --------------------------------------------------------
    def _await_reply(self, rpc_id, timeout, make_exc):
        """Wait for ``rpc_id``'s reply; raises ``make_exc()`` on timeout
        or transport death (a graceful shutdown races classify as
        ``"draining"`` instead — see :meth:`_transport_dead_exc`). The
        waiter registers in ``_expected`` around the wait so a reply
        landing AFTER the timeout is dropped by the reader instead of
        leaking in ``_replies`` forever."""
        deadline = time.monotonic() + timeout
        with self._reply_cond:
            try:
                while rpc_id not in self._replies:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._transport_alive():
                        if (
                            self._shutdown_requested
                            and not self._transport_alive()
                        ):
                            raise self._transport_dead_exc(
                                "shut down mid-call"
                            )
                        raise make_exc()
                    self._reply_cond.wait(min(remaining, 0.1))
                return self._replies.pop(rpc_id)
            finally:
                self._expected.discard(rpc_id)
                self._replies.pop(rpc_id, None)

    def _call(self, msg, timeout=None):
        """Send an op expecting a ``reply`` event; returns the reply."""
        rpc_id = self._mint_rpc_id()
        msg = dict(msg, id=rpc_id)
        with self._reply_cond:
            self._expected.add(rpc_id)
        try:
            self._send(msg)
        except Exception:
            with self._reply_cond:
                self._expected.discard(rpc_id)
            raise
        return self._await_reply(
            rpc_id,
            self._rpc_timeout if timeout is None else timeout,
            lambda: TimeoutError(
                f"replica {self.replica_id}: no reply to {msg.get('op')!r}"
            ),
        )

    def _call_retrying(self, msg, timeout=None):
        """:meth:`_call` with retry-and-backoff for IDEMPOTENT control
        ops (snapshot, drain, adapter management): a transient transport
        failure — one corrupted line, one slow op-loop pass — costs a
        retry, not a replica marked unresponsive. Submit ops must never
        ride this path: re-sending a generate is a duplicate
        generation."""
        attempt = 0
        while True:
            try:
                return self._call(msg, timeout=timeout)
            except (TimeoutError, ReplicaRPCError) as e:
                if attempt >= self._rpc_retries or (
                    not self._transport_alive()
                ):
                    raise
                # swallowed-and-retried: never silently (docs/resilience.md)
                count_suppressed("serving.rpc_retry", e)
                self.rpc_retries_used += 1
                logger.debug(
                    "replica %s: retrying %r after %r (attempt %d/%d)",
                    self.replica_id, msg.get("op"), e, attempt + 1,
                    self._rpc_retries,
                )
                time.sleep(self._rpc_backoff_secs * (2.0 ** attempt))
                attempt += 1

    # -- serving --------------------------------------------------------
    def _frame_submit(self, msg, kwargs):
        """Transport hook: final shaping of the submit frame. The socket
        transport lifts ``deadline_secs`` out of the app kwargs into the
        frame header (``dl_ms``) so the deadline rides the TRANSPORT and
        the node re-derives the engine deadline from it."""
        del kwargs
        return msg

    def submit(self, prompt_tokens, max_new_tokens=32, **kwargs):
        rpc_id = self._mint_rpc_id()
        req = RemoteRequest(rpc_id, prompt_tokens, max_new_tokens)
        with self._state_lock:
            self._outstanding[rpc_id] = req
        with self._reply_cond:
            self._expected.add(rpc_id)
        try:
            msg = {
                "op": "submit", "id": rpc_id,
                "prompt": [int(t) for t in prompt_tokens],
                "max_new_tokens": int(max_new_tokens),
                "kwargs": kwargs,
            }
            self._send(self._frame_submit(msg, kwargs))
            reply = self._await_reply(
                rpc_id, self._rpc_timeout,
                lambda: ReplicaRPCError(
                    f"replica {self.replica_id}: worker did not "
                    f"acknowledge the submission"
                ),
            )
        except Exception:
            with self._state_lock:
                self._outstanding.pop(rpc_id, None)
            with self._reply_cond:
                self._expected.discard(rpc_id)
            raise
        if reply.get("error"):
            with self._state_lock:
                self._outstanding.pop(rpc_id, None)
            reason = reply.get("reason")
            if reason in REJECT_REASONS:
                raise RequestRejected(reply["error"], reason=reason)
            if reply.get("error_type") == "AdapterUnavailable":
                from ..adapters.pool import AdapterUnavailable

                # typed across the pipe: the router drops THIS replica
                # from the candidate set instead of failing the request
                raise AdapterUnavailable(reply["error"])
            raise ValueError(reply["error"])
        return req

    def cancel_request(self, handle):
        """Best-effort remote cancel (the HTTP door's client-disconnect
        path): the remote scheduler reclaims the slot within one decode
        step and its ``finished`` event completes the handle. A dead
        transport is ignored — its requests fail-finish at EOF anyway."""
        try:
            self._send({"op": "cancel", "id": handle.rpc_id})
        except RequestRejected as e:
            count_suppressed("serving.cancel_rpc", e)

    def load_adapter(self, name, load_dir=None, tag=None, timeout=60.0,
                     **kwargs):
        """Install a LoRA adapter on the remote engine. Only
        checkpoint-backed loads cross the process boundary
        (``load_dir``/``tag`` — adapter trees are weights, not JSON;
        commit them with the training engine's save_checkpoint and load
        by directory). A generous timeout: the remote side reads +
        verifies + device-puts the rows."""
        if kwargs:
            raise ValueError(
                "remote replicas load adapters from checkpoint "
                f"directories only (load_dir=...); got {sorted(kwargs)}"
            )
        if load_dir is None:
            raise ValueError("load_dir is required")
        reply = self._call_retrying(
            {"op": "load_adapter", "name": str(name),
             "load_dir": str(load_dir), "tag": tag},
            timeout=timeout,
        )
        if reply.get("error"):
            raise RuntimeError(reply["error"])
        return int(reply["index"])

    def unload_adapter(self, name, timeout=30.0):
        reply = self._call_retrying(
            {"op": "unload_adapter", "name": str(name)}, timeout=timeout
        )
        if reply.get("error"):
            raise RuntimeError(reply["error"])
        return int(reply["index"])

    def _snapshot_now(self):
        if not self._transport_alive():
            if self._transport_recovering():
                snap = _dead_snapshot(failed=False)
                snap["unresponsive"] = True
                return snap
            return _dead_snapshot(failed=not self._shutdown_requested)
        if time.monotonic() < self._unresponsive_until:
            snap = _dead_snapshot(failed=False)
            snap["unresponsive"] = True
            return snap
        try:
            reply = self._call_retrying({"op": "snapshot"})
        except (TimeoutError, RequestRejected):
            if self._transport_alive():
                # the transport is UP but not answering past the retry
                # budget: an unresponsive replica, not a corpse — the
                # router steers traffic away and lets zombie detection
                # (docs/serving.md) decide on a restart, instead of
                # mistaking one long GC pause for a death sentence. The
                # verdict is cached for one timeout window so callers
                # don't re-pay the retry budget per placement pass.
                self._unresponsive_until = (
                    time.monotonic() + self._rpc_timeout
                )
                snap = _dead_snapshot(failed=False)
                snap["unresponsive"] = True
                return snap
            if self._transport_recovering():
                # the connection dropped mid-RPC but reconnect-with-
                # resume is still in play: steer around, don't evict
                snap = _dead_snapshot(failed=False)
                snap["unresponsive"] = True
                return snap
            # genuinely died between the aliveness check and the RPC —
            # a dead replica IS a dead snapshot
            return _dead_snapshot(failed=not self._shutdown_requested)
        self._unresponsive_until = 0.0
        snap = reply["snapshot"]
        snap.setdefault("alive", not snap.get("stopped", False))
        snap.setdefault("failed", bool(snap.get("driver_failed")))
        self._reconcile_orphans(snap)
        return snap

    def _reconcile_orphans(self, snap):
        """A remote side reporting fully idle while this parent still
        holds outstanding requests older than the RPC timeout means their
        ``finished`` events were LOST in transit (dropped line, reader
        hiccup, a reconnect the node no longer remembers them across).
        Fail-finish them so the router re-routes: the remote answer never
        reached any caller, so re-deriving it elsewhere keeps
        exactly-once delivery."""
        if not (
            snap.get("alive")
            and snap.get("queue_depth") == 0
            and snap.get("active_slots") == 0
        ):
            return
        horizon = time.monotonic() - 2.0 * self._rpc_timeout
        orphans = []
        with self._state_lock:
            for rpc_id, req in list(self._outstanding.items()):
                if req.created_at < horizon:
                    orphans.append(self._outstanding.pop(rpc_id))
        for req in orphans:
            logger.warning(
                "replica %s: request %s finished remotely but its "
                "completion event never arrived; failing it for re-route",
                self.replica_id, req.rpc_id,
            )
            count_suppressed("serving.rpc_lost_completion")
            req._finish(req.tokens, _FINISH_ERROR)

    def set_brownout(self, on):
        """Fire-and-forget brownout toggle (docs/serving.md); a dead
        transport is ignored — a replica that cannot hear the toggle is
        not serving traffic either."""
        try:
            self._send({"op": "brownout", "on": bool(on)})
        except RequestRejected as e:
            count_suppressed("serving.brownout_toggle", e)

    # -- lifecycle ------------------------------------------------------
    def drain(self):
        try:
            self._send({"op": "drain"})
        except RequestRejected as e:
            # _send only fails on a dead transport — which does not heal
            # within this incarnation, so a retry buys nothing: the
            # replica is drained by definition, but never silently
            # (docs/resilience.md "no silent swallows")
            count_suppressed("serving.drain_rpc", e)

    def shutdown(self):  # pragma: no cover - interface
        raise NotImplementedError


# ---------------------------------------------------------------------------
# subprocess backend: newline-JSON RPC over the worker's stdin/stdout
# ---------------------------------------------------------------------------
class SubprocessReplica(RpcReplicaBase):
    """One engine per worker process (serving/worker.py), talked to over
    newline-JSON on the worker's stdin/stdout (stderr passes through for
    logs). ``worker_spec`` is the JSON the worker builds its model and
    engine from — see worker.py's module docstring for the schema."""

    def __init__(self, replica_id, worker_spec, *, python=None,
                 start_timeout=120.0, rpc_timeout=10.0, rpc_retries=2,
                 rpc_backoff_secs=0.05, fault_injector=None):
        super().__init__(
            replica_id, rpc_timeout=rpc_timeout, rpc_retries=rpc_retries,
            rpc_backoff_secs=rpc_backoff_secs, fault_injector=fault_injector,
        )
        self.worker_spec = dict(worker_spec)
        self._python = python or sys.executable
        self._start_timeout = float(start_timeout)
        self._proc = None
        self._reader = None

    def start(self):
        if self._proc is not None and self._proc.poll() is None:
            return self
        # fault site: crash-on-(re)start (see InProcessReplica.start)
        self.faults.maybe_raise("replica.flap")
        self._shutdown_requested = False
        self._reset_rpc_state()
        # the worker inherits the parent's environment verbatim: forcing
        # a device here would silently downgrade GPU fleets (a CPU worker
        # asks for it with the spec's "device" key)
        self._proc = subprocess.Popen(
            [self._python, "-m", "deepspeed_tpu_torch.serving.worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=None,
            text=True, env=dict(os.environ),
        )
        self._reader = threading.Thread(
            target=self._read_loop, args=(self._proc,),
            name=f"ds-replica-{self.replica_id}-reader", daemon=True,
        )
        self._reader.start()
        # the spec carries this replica's id so the worker's scheduler
        # mints replica-prefixed request ids (and its spans say which
        # replica served them); ``proto`` is this side's handshake half
        self._send({
            "op": "init", "proto": RPC_PROTOCOL_VERSION,
            "spec": dict(self.worker_spec, replica_id=self.replica_id),
        })
        if not self._ready.wait(self._start_timeout):
            self.shutdown()
            raise RuntimeError(
                f"replica {self.replica_id} worker did not become ready "
                f"within {self._start_timeout}s"
            )
        # fail-fast on a version skew, with both versions named — never
        # one undecodable line at a time until the breaker opens
        self._check_protocol()
        return self

    # -- transport ------------------------------------------------------
    def _transport_alive(self):
        proc = self._proc
        return proc is not None and proc.poll() is None

    def _send(self, msg):
        proc = self._proc
        if proc is None or proc.poll() is not None:
            raise self._transport_dead_exc("worker process is not running")
        line = json.dumps(msg)
        # fault site rpc.send: drop / corrupt / delay this line before it
        # reaches the worker (a dropped op simply never gets its reply —
        # exactly what a torn pipe write looks like from here)
        line = self.faults.mangle_line("rpc.send", line)
        if line is None:
            return
        with self._write_lock:
            try:
                proc.stdin.write(line + "\n")
                proc.stdin.flush()
            except (BrokenPipeError, OSError, ValueError):
                raise self._transport_dead_exc(
                    "worker pipe is closed"
                ) from None

    def _read_loop(self, proc):
        for line in proc.stdout:
            line = line.strip()
            if not line:
                continue
            # fault site rpc.recv: the worker's event is dropped,
            # garbled, or delivered late
            line = self.faults.mangle_line("rpc.recv", line)
            if line is None:
                continue
            try:
                msg = json.loads(line)
            except ValueError as e:
                logger.warning(
                    "replica %s: undecodable worker line %r",
                    self.replica_id, line[:200],
                )
                count_suppressed("serving.rpc_undecodable_line", e)
                continue
            self._dispatch(msg)
        # EOF: a REQUESTED shutdown/drain reads as a clean goodbye (the
        # orphan sweep below stays quiet and nothing feeds a breaker
        # streak); an unrequested EOF is a killed pipe — fail loudly
        self._on_transport_eof(graceful=self._shutdown_requested)

    # -- lifecycle ------------------------------------------------------
    def restart(self):
        self.shutdown()
        return self.start()

    def shutdown(self, grace=10.0):
        proc = self._proc
        if proc is None:
            return
        self._shutdown_requested = True
        try:
            self._send({"op": "shutdown"})
        except RequestRejected as e:
            # the worker died before the goodbye; the kill below reaps it
            count_suppressed("serving.shutdown_rpc", e)
        try:
            proc.wait(grace)
        except subprocess.TimeoutExpired:
            logger.warning(
                "replica %s worker ignored shutdown; killing pid %d",
                self.replica_id, proc.pid,
            )
            proc.kill()
            proc.wait(grace)
        if self._reader is not None:
            self._reader.join(grace)
            if self._reader.is_alive():
                logger.warning(
                    "replica %s: reader thread outlived its %.1fs join "
                    "grace (daemon thread; it dies with the process)",
                    self.replica_id, grace,
                )
                count_suppressed("serving.reader_join_timeout")
            self._reader = None
        self._proc = None

    @property
    def alive(self):
        return self._proc is not None and self._proc.poll() is None

    @property
    def failed(self):
        return (
            self._proc is not None
            and self._proc.poll() is not None
            and not self._shutdown_requested
        )


def _dead_snapshot(failed):
    """The snapshot shape load-scoring code expects, for a replica with
    no live engine behind it."""
    return {
        "queue_depth": 0, "queue_capacity": 0, "active_slots": 0,
        "free_slots": 0, "num_slots": 0, "health": 2,
        "mean_prefill_ms": 0.0, "mean_decode_ms": 0.0,
        "p99_prefill_ms": 0.0, "mean_queue_wait_ms": 0.0,
        "requests_shed": 0.0, "restarts_used": 0,
        "requests_completed": 0, "tokens_generated": 0,
        "driving": False, "stopped": True, "driver_failed": failed,
        "alive": False, "failed": failed, "unresponsive": False,
    }
