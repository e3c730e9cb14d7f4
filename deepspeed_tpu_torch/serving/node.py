"""Node agent: N replicas on one host behind a TCP listener.

Port of deepspeed_tpu/serving/node.py.
``python -m deepspeed_tpu_torch.serving.node --spec '<json>' [--host H]
[--port P]`` hosts one engine per named replica and serves the replica
RPC (worker.py's frame schema, transport.py's framing) to SocketReplica
clients — the multi-host form of the serving tier: a router on another
machine drives these replicas exactly like local ones.

The node spec::

    {
      "node_id": "n0",
      "replicas": {"r0": {engine spec}, "r1": {engine spec}},
      "lease_secs": 10.0,          // half-open connection guard
      "resume_grace_secs": 10.0,   // disconnected-session retention
      "config": {...}              // node-side chaos (accept.drop) etc.
    }

Each ``{engine spec}`` is worker.py's init spec (``{"model": ...,
"init_seed": ..., "config": ...}`` — or ``{"stub": ...}`` for the
plain-Python protocol-testing engine). Engines build at node start, BEFORE
the listener opens: a connecting client never races an initializing
model. Request ids carry the ``{node_id}/{replica}`` prefix, so ids
stay globally unique across hosts.

## Sessions and resume

A connection's first frame must be a ``hello`` naming the client token
and target replica. Sessions key on ``(client, replica)``: the session
— not the connection — owns the in-flight request table and an event
outbox. Events (first_token / token / finished / replies) append to the
outbox and flush to the live connection; with no connection they wait.
A reconnecting client (same token) re-binds the session: the node
answers ``welcome`` with the session's in-flight rpc ids (the client
fail-finishes anything missing for re-route) and flushes the outbox —
nothing is lost, nothing re-runs. A session with no connection past
``resume_grace_secs`` is reaped: its in-flight requests cancel (slots
free within one decode step) and the next hello starts fresh.

Chaos: the spec config's ``resilience.fault_injection`` block arms the
node-side injector; ``accept.drop`` fires in the accept loop (the
overloaded-listener failure mode — the client's connect retry absorbs
it).

## Elastic capacity (docs/serving.md "SLO autoscaling")

A hello naming :data:`transport.NODE_CONTROL_NAME` opens a CONTROL
session bound to no engine; on it (and only meaningfully on it) the
lifecycle ops run: ``spawn_replica`` builds a new engine from the op's
spec (default: the node spec's ``spawn_spec``, falling back to the
first declared replica's spec) OFF the connection thread and replies
only once it serves — a caller never races a half-built replica;
``retire_replica`` drains + closes one engine and reaps its sessions;
``node_info`` lists the live roster. ``max_replicas`` in the node spec
caps hosted engines. The router-side autoscaler drives these through
``transport.NodeControlClient``.
"""

import argparse
import collections
import gc
import json
import os
import signal
import socket
import struct
import sys
import threading
import time

import torch

from ..inference.scheduler import RequestRejected
from ..resilience.faults import NULL_INJECTOR, build_fault_injector_from_dict
from ..telemetry.registry import count_suppressed, wire_snapshot
from ..telemetry.tracing import NOOP_TRACER, SpanTracer
from ..utils.device import resolve_device
from ..utils.logging import logger
from .replica import RPC_PROTOCOL_VERSION
from .transport import (
    NODE_CONTROL_NAME,
    FrameError,
    corrupt_frame,  # noqa: F401  (re-exported for chaos tooling)
    decode_frame,
    encode_frame,
    read_frame_line,
)
from .worker import (
    build_engine_from_spec,
    kernel_launches,
    poll_tracked_requests,
)

# a session's outbox past this is a client that stopped reading events
# faster than its requests generate them — reap it (the disconnect path)
# rather than grow node memory without bound
OUTBOX_MAX_EVENTS = 65536


class _Session:
    """One client's lease on one hosted replica: the in-flight request
    table plus the event outbox that survives reconnects."""

    __slots__ = ("client", "replica_name", "engine", "tracked", "outbox",
                 "conn", "last_seen", "lock", "dead", "faults")

    def __init__(self, client, replica_name, engine, faults=NULL_INJECTOR):
        self.client = client
        self.replica_name = replica_name
        self.engine = engine
        self.tracked = {}  # rpc_id -> (request, announced, tokens_sent)
        self.outbox = collections.deque()
        self.conn = None   # the bound socket (exactly 0 or 1)
        self.last_seen = time.monotonic()
        self.lock = threading.Lock()
        self.dead = False
        self.faults = faults

    def emit(self, msg):
        """Queue one event and flush what the live connection will take.
        With no connection the outbox holds it for the resume; a write
        failure unbinds (the reaper owns the session's fate)."""
        with self.lock:
            self.outbox.append(msg)
            self._flush_locked()

    def flush(self):
        with self.lock:
            self._flush_locked()

    def _flush_locked(self):
        conn = self.conn
        if conn is None:
            return
        while self.outbox:
            # fault site node.partition: the node-side mirror of the
            # client's net.partition — the network black-holes one
            # outbound event frame AFTER the node considers it sent. The
            # client's reply timeout / token-index gap / lease expiry
            # notices; the finished event's authoritative token list (or
            # an idempotent-RPC retry) repairs the loss.
            if (
                self.faults.enabled
                and self.faults.fire("node.partition") is not None
            ):
                count_suppressed("serving.node_partition_drop")
                self.outbox.popleft()
                continue
            data = encode_frame(self.outbox[0])
            try:
                conn.sendall(data)
            except OSError as e:
                count_suppressed("serving.node_event_write", e)
                self.conn = None  # unbind; the event stays queued
                return
            self.outbox.popleft()

    def bind(self, conn):
        """Adopt ``conn`` as the session's live connection, closing any
        predecessor (latest hello wins), and flush the backlog."""
        with self.lock:
            old, self.conn = self.conn, conn
            self.last_seen = time.monotonic()
        if old is not None and old is not conn:
            try:
                old.close()
            except OSError:
                pass
        self.flush()

    def unbind(self, conn):
        with self.lock:
            if self.conn is conn:
                self.conn = None
                self.last_seen = time.monotonic()


def _cuda_memory():
    """The process's CUDA memory for the node's log ("" before any CUDA
    use): what its tensors hold, and what PyTorch's allocator keeps."""
    if not torch.cuda.is_initialized():
        return ""
    return (f"; {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
            f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")


class NodeServer:
    """The agent: engines + listener + watcher/reaper threads.

    ``engine_builder`` maps an engine spec dict to an engine exposing
    the InferenceEngine surface (default: worker.py's
    ``build_engine_from_spec``, which also understands the plain-Python
    ``{"stub": ...}`` form) — injectable so tests host stub engines
    in-process without a subprocess spawn.

    An engine spec's ``"device"`` defaults to the GPU, and without one
    the default builder raises unless the spec says ``"cpu"``. The
    default builder names the CUDA device explicitly: a spawned replica
    builds on a thread of its own, whose current CUDA device need not be
    the one the node started on."""

    def __init__(self, spec, host="127.0.0.1", port=0, *,
                 engine_builder=None, poll_interval=0.002):
        spec = dict(spec)
        self.node_id = str(spec.get("node_id", "node"))
        replica_specs = spec.get("replicas") or {}
        if not replica_specs and spec.get("spawn_spec") is None:
            raise ValueError(
                "node spec needs a non-empty 'replicas' map (or a "
                "'spawn_spec' template for a node that starts empty and "
                "is populated by the autoscaler's spawn_replica ops)"
            )
        self._replica_specs = {
            str(name): dict(rspec) for name, rspec in replica_specs.items()
        }
        self.lease_secs = float(spec.get("lease_secs", 10.0))
        self.resume_grace_secs = float(spec.get("resume_grace_secs", 10.0))
        # elastic capacity (docs/serving.md "SLO autoscaling"): the spec
        # an op-supplied-spec-less spawn_replica builds from (default:
        # the first declared replica's spec — a homogeneous node), and a
        # hard ceiling on hosted engines (None = the router's autoscaler
        # is the only bound)
        template = spec.get("spawn_spec")
        if template is None and self._replica_specs:
            template = self._replica_specs[sorted(self._replica_specs)[0]]
        self._spawn_template = dict(template or {})
        self.max_replicas = spec.get("max_replicas")
        if self.max_replicas is not None:
            self.max_replicas = int(self.max_replicas)
        # serializes spawn/retire against each other (engine builds are
        # slow; two concurrent spawns of one name must not both win)
        self._elastic_lock = threading.Lock()
        # epoch fencing (docs/serving.md "Epoch fencing"): the highest
        # router-incarnation epoch any hello has presented. A hello
        # below it is a STALE router (an old journal's incarnation
        # restarted after a newer one adopted this node) — rejected
        # with a typed fenced_out error so it stands down instead of
        # double-driving sessions the live router owns. Epoch-less
        # hellos (tests, pre-epoch clients) fence nothing.
        self._epoch_lock = threading.Lock()
        self._epoch_high_water = 0
        self._host = str(host)
        self._port = int(port)
        self._build = engine_builder or self._build_on_node_device
        self._cuda_index = (
            torch.cuda.current_device() if torch.cuda.is_available() else 0
        )
        self._poll = float(poll_interval)
        fi = (
            (spec.get("config") or {}).get("resilience") or {}
        ).get("fault_injection") or {}
        self._faults = build_fault_injector_from_dict(fi)
        # node-side tracer (spec config's telemetry.tracing block, read
        # raw — the node runs without a validated DeepSpeedConfig): no
        # local export file, no local dump dir — the telemetry hub
        # pulls sampled spans (and, on demand, the flight ring) home
        # over drain_telemetry, so one router-side trace covers the
        # fleet. flush_every is effectively infinite because flush()
        # with no export_path would DISCARD the pending batch.
        tr = (
            (spec.get("config") or {}).get("telemetry") or {}
        ).get("tracing") or {}
        if tr.get("enabled"):
            self.tracer = SpanTracer(
                sample_rate=float(tr.get("sample_rate", 1.0)),
                ring_events=int(tr.get("ring_events", 512)),
                export_path=None, dump_dir=None,
                flush_every=1_000_000_000,
            )
        else:
            self.tracer = NOOP_TRACER
        self.engines = {}
        self._sessions = {}  # (client, replica_name) -> _Session
        self._sessions_lock = threading.Lock()
        self._listener = None
        self._threads = []
        self._stop = threading.Event()

    def _build_on_node_device(self, spec):
        """``build_engine_from_spec`` with the spec's device made
        explicit: the GPU (this node's CUDA device, whatever thread
        builds) unless the spec names another."""
        if spec.get("stub") is None:
            spec = dict(spec)
            device = resolve_device(spec.get("device"))
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", self._cuda_index)
            spec["device"] = str(device)
        return build_engine_from_spec(spec)

    # -- lifecycle ------------------------------------------------------
    def start(self):
        """Build every engine, open the listener, start the service
        threads. Returns ``(host, port)`` — port resolves the ephemeral
        0."""
        for name, rspec in self._replica_specs.items():
            engine = self._build(rspec)
            # node-prefixed request ids: two hosts must never mint
            # colliding ids into fleet telemetry
            sched = getattr(engine, "scheduler", None)
            set_prefix = getattr(sched, "set_id_prefix", None)
            if set_prefix is not None:
                set_prefix(f"{self.node_id}/{name}")
            engine.serve_forever()
            self.engines[name] = engine
        self._listener = socket.create_server(
            (self._host, self._port), reuse_port=False
        )
        self._listener.settimeout(0.2)
        self._host, self._port = self._listener.getsockname()[:2]
        for target, name in (
            (self._accept_loop, "accept"),
            (self._watch_loop, "watch"),
            (self._reap_loop, "reap"),
        ):
            t = threading.Thread(
                target=target, name=f"ds-node-{self.node_id}-{name}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        logger.info(
            "node %s: serving %d replica(s) on %s:%d%s",
            self.node_id, len(self.engines), self._host, self._port,
            _cuda_memory(),
        )
        return self._host, self._port

    @property
    def address(self):
        return self._host, self._port

    def shutdown(self, grace=5.0):
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._sessions_lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for session in sessions:
            self._reap_session(session, "node shutdown")
        for t in self._threads:
            t.join(grace)
        self._threads = []
        for engine in self.engines.values():
            try:
                engine.close()
            except Exception as e:
                count_suppressed("serving.node_engine_close", e)
        self.engines = {}

    def run_forever(self):
        self._stop.wait()

    # -- accept / per-connection protocol -------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed: shutting down
            # fault site accept.drop: the overloaded-listener /
            # SYN-flood-guard failure mode — accept, then slam the door;
            # the client's connect retry absorbs it
            if self._faults.fire("accept.drop") is not None:
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            conn.settimeout(None)
            # bound SENDS only (SO_SNDTIMEO, not settimeout — reads must
            # block indefinitely between a quiet client's heartbeats): a
            # zero-window client would otherwise park sendall inside
            # session.lock forever, wedging the shared watch/reap loops
            # — and with them every session on the node. A timed-out
            # send raises OSError, the flush unbinds, the event stays
            # queued, and the reaper owns the session's fate. Kept TIGHT
            # (well under the lease): the shared watch loop stalls for
            # at most this long on one wedged client before unbinding
            # it, and a healthy peer acks a frame orders of magnitude
            # faster.
            try:
                secs = max(min(self.lease_secs, 2.0), 0.5)
                conn.setsockopt(
                    socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                    struct.pack("ll", int(secs),
                                int((secs % 1.0) * 1e6)),
                )
            except (OSError, ValueError):  # pragma: no cover - platform
                pass
            threading.Thread(
                target=self._serve_conn, args=(conn, addr),
                name=f"ds-node-{self.node_id}-conn", daemon=True,
            ).start()

    def _serve_conn(self, conn, addr):
        session = None
        rfile = conn.makefile("rb")
        try:
            session = self._handshake(conn, rfile, addr)
            if session is None:
                return
            for line in iter(lambda: read_frame_line(rfile), b""):
                try:
                    msg = decode_frame(line)
                except FrameError as e:
                    # one garbled frame costs exactly its op: count it,
                    # resync at the next newline, let the client's
                    # idempotent-RPC retry re-ask
                    logger.warning(
                        "node %s: dropped corrupt frame from %s (%s)",
                        self.node_id, session.client, e,
                    )
                    count_suppressed("serving.net_frame_corrupt", e)
                    continue
                with session.lock:
                    session.last_seen = time.monotonic()
                if msg.get("op") == "bye":
                    # an explicit goodbye: no resume is coming — reap now
                    # instead of waiting out the grace window
                    self._drop_session(session, "client said bye")
                    return
                self._handle_op(session, msg)
        except (OSError, FrameError, ValueError) as e:
            count_suppressed("serving.node_conn_error", e)
        finally:
            if session is not None:
                session.unbind(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handshake(self, conn, rfile, addr):
        line = read_frame_line(rfile)
        if not line:
            return None
        try:
            hello = decode_frame(line)
        except FrameError as e:
            count_suppressed("serving.net_frame_corrupt", e)
            return None
        if hello.get("op") != "hello":
            logger.warning(
                "node %s: first frame from %s is %r, not hello; closing",
                self.node_id, addr, hello.get("op"),
            )
            return None
        name = str(hello.get("replica"))
        client = str(hello.get("client"))
        epoch = hello.get("epoch")
        if epoch is not None and not self._admit_epoch(
            int(epoch), client, name, conn
        ):
            return None
        if name == NODE_CONTROL_NAME:
            # control-plane session (transport.py NodeControlClient):
            # binds to NO engine — only the lifecycle ops are valid on it
            engine = None
        else:
            engine = self.engines.get(name)
            if engine is None:
                conn.sendall(encode_frame({
                    "event": "error",
                    "error": f"node {self.node_id} hosts no replica "
                             f"{name!r} (valid: {sorted(self.engines)})",
                }))
                return None
        key = (client, name)
        with self._sessions_lock:
            session = self._sessions.get(key)
            if session is None or session.dead:
                session = _Session(client, name, engine,
                                   faults=self._faults)
                self._sessions[key] = session
        with session.lock:
            if hello.get("replay"):
                # adoption resume (docs/serving.md "Control-plane
                # durability"): a RESTARTED router presents the
                # journaled client token with empty request handles —
                # rewind every tracked request's sent counter so the
                # watch loop re-emits the committed token prefix from
                # index 0 (absolute indices make the re-emit idempotent
                # for an ordinary client; for the adopted one it IS the
                # prefix)
                session.tracked = {
                    rpc_id: (req, announced, 0)
                    for rpc_id, (req, announced, _sent)
                    in session.tracked.items()
                }
            # the authoritative "node remembers these" list: in-flight
            # requests PLUS anything that finished while the client was
            # away — its ``finished`` event still sits in the outbox, and
            # the resume flush will deliver it; omitting those ids would
            # make the client fail-finish a completed answer for re-route
            # (burning a duplicate generation) one frame before the
            # buffered result arrives
            resumed = sorted(
                set(session.tracked)
                | {ev["id"] for ev in session.outbox
                   if ev.get("event") == "finished"}
            )
        # welcome FIRST (node identity + protocol + the authoritative
        # in-flight list the client reconciles against), then ready;
        # both carry the version — the handshake's node half
        conn.sendall(encode_frame({
            "event": "welcome", "proto": RPC_PROTOCOL_VERSION,
            "node": self.node_id, "replica": name, "inflight": resumed,
        }))
        conn.sendall(encode_frame({
            "event": "ready", "proto": RPC_PROTOCOL_VERSION,
        }))
        session.bind(conn)
        if resumed:
            logger.info(
                "node %s: client %s resumed session on %s with %d "
                "in-flight request(s)", self.node_id, client, name,
                len(resumed),
            )
        return session

    def _admit_epoch(self, epoch, client, name, conn):
        """The split-brain gate: admit a hello at-or-above the node's
        high-water epoch (raising it), reject one below it with a typed
        ``fenced_out`` error frame. Returns True when admitted."""
        with self._epoch_lock:
            high_water = self._epoch_high_water
            if epoch >= high_water:
                self._epoch_high_water = epoch
                return True
        logger.warning(
            "node %s: FENCED OUT client %s (session %r): presented "
            "epoch %d is below this node's high-water epoch %d — a "
            "newer router incarnation owns this fleet",
            self.node_id, client, name, epoch, high_water,
        )
        count_suppressed("serving.node_fenced_out")
        if self.tracer.enabled:
            self.tracer.event(
                "node.fenced_out",
                attrs={"node": self.node_id, "client": client,
                       "epoch": epoch, "high_water": high_water},
            )
        try:
            conn.sendall(encode_frame({
                "event": "error", "code": "fenced_out",
                "error": f"node {self.node_id}: epoch {epoch} is fenced "
                         f"out (high-water epoch {high_water})",
                "epoch": epoch, "high_water": high_water,
            }))
        except OSError:
            pass
        return False

    # -- ops -------------------------------------------------------------
    def _handle_op(self, session, msg):
        op = msg.get("op")
        # fault site node.crash: SIGKILL the whole agent at the
        # op-dispatch seam — the host-death failure mode. Every hosted
        # replica's sessions orphan at once; the router's eviction /
        # re-route machinery and the provisioner's re-provision path
        # (serving/provisioner.py) must absorb it end to end.
        if (
            self._faults.enabled
            and self._faults.fire("node.crash") is not None
        ):
            logger.warning(
                "node %s: injected node.crash — SIGKILLing the agent",
                self.node_id,
            )
            os.kill(os.getpid(), signal.SIGKILL)
        # fault site replica.hang (the worker op loop's site, node form):
        # every RPC on this connection waits out the stall while the
        # process stays alive — the unresponsive-replica failure mode
        self._faults.maybe_stall("replica.hang")
        if op == "ping":
            session.emit({"event": "pong"})
        elif op in ("spawn_replica", "retire_replica", "node_info",
                    "metrics_snapshot", "drain_telemetry"):
            # control-plane ops (docs/serving.md "SLO autoscaling" and
            # docs/observability.md "fleet-wide view"): valid on any
            # session, but a control session is their home
            if op == "node_info":
                session.emit({
                    "event": "reply", "id": msg.get("id"),
                    "node": self.node_id,
                    "replicas": sorted(self.engines),
                    "epoch_high_water": self._epoch_high_water,
                })
            elif op == "metrics_snapshot":
                self._op_metrics_snapshot(session, msg)
            elif op == "drain_telemetry":
                self._op_drain_telemetry(session, msg)
            elif op == "spawn_replica":
                self._op_spawn(session, msg)
            else:
                self._op_retire(session, msg)
        elif session.engine is None:
            # a control session asked for an engine op: answer the typed
            # error instead of an AttributeError killing the connection
            session.emit({
                "event": "reply", "id": msg.get("id"),
                "error": f"op {op!r} needs a replica session, not the "
                         f"control session",
            })
        elif op == "submit":
            self._op_submit(session, msg)
        elif op == "cancel":
            with session.lock:
                entry = session.tracked.get(msg.get("id"))
            if entry is not None:
                cancel = getattr(entry[0], "cancel", None)
                if cancel is not None:
                    cancel()
        elif op == "snapshot":
            session.emit({
                "event": "reply", "id": msg["id"],
                "snapshot": session.engine.load_snapshot(),
            })
        elif op == "load_adapter":
            self._op_adapter(
                session, msg,
                lambda: session.engine.load_adapter(
                    msg["name"], load_dir=msg.get("load_dir"),
                    tag=msg.get("tag"),
                ),
            )
        elif op == "unload_adapter":
            self._op_adapter(
                session, msg,
                lambda: session.engine.unload_adapter(msg["name"]),
            )
        elif op == "brownout":
            hook = getattr(session.engine, "set_brownout", None)
            if hook is not None:
                hook(bool(msg.get("on")))
        elif op == "drain":
            session.engine.scheduler.drain()
        else:
            logger.warning(
                "node %s: unknown op %r from client %s",
                self.node_id, op, session.client,
            )
            count_suppressed("serving.node_unknown_op")

    def _op_submit(self, session, msg):
        rpc_id = msg["id"]
        kwargs = dict(msg.get("kwargs") or {})
        # the deadline rode the frame HEADER (transport.py
        # _frame_submit): re-derive the engine deadline from it, so the
        # budget the engine enforces is the one the wire carried
        dl_ms = msg.get("dl_ms")
        if dl_ms is not None:
            kwargs["deadline_secs"] = max(float(dl_ms) / 1e3, 1e-3)
        # same contract as the worker: never block the op path on queue
        # room — a full queue rejects NOW and the router falls through
        kwargs.setdefault("timeout", 0.0)
        t0 = time.monotonic()
        try:
            req = session.engine.submit(
                msg["prompt"],
                max_new_tokens=msg.get("max_new_tokens", 32),
                **kwargs,
            )
            if self.tracer.enabled:
                # the node's own view of the accept (joins the request's
                # fleet trace via the propagated context); shipped home
                # by the hub's drain_telemetry pulls
                self.tracer.record(
                    "node.submit", t0, time.monotonic(),
                    ctx=kwargs.get("trace_ctx"),
                    attrs={"node": self.node_id,
                           "replica": session.replica_name,
                           "rpc_id": rpc_id},
                )
        except RequestRejected as e:
            session.emit({
                "event": "reply", "id": rpc_id,
                "error": str(e), "reason": e.reason,
            })
            return
        except (ValueError, TypeError) as e:
            session.emit({
                "event": "reply", "id": rpc_id, "error": str(e),
                "error_type": type(e).__name__,
            })
            return
        with session.lock:
            session.tracked[rpc_id] = (req, False, 0)
        session.emit({"event": "reply", "id": rpc_id})

    # -- fleet observability (docs/observability.md "fleet-wide view") --
    def _op_metrics_snapshot(self, session, msg):
        """The telemetry hub's scrape: every live engine's registry as
        JSON-safe wire entries, keyed by replica name. Engines without
        a ``metrics`` registry contribute nothing (the hub merges what
        exists rather than erroring). The engines dict is copied first
        — a concurrent spawn/retire must not blow up the iteration."""
        replicas = {}
        for name, engine in sorted(list(self.engines.items())):
            reg = getattr(engine, "metrics", None)
            if reg is not None:
                try:
                    replicas[name] = wire_snapshot(reg)
                except Exception as e:
                    # a half-retired engine's registry must cost its
                    # own entry, not the whole scrape
                    count_suppressed("serving.node_metrics_snapshot", e)
        session.emit({
            "event": "reply", "id": msg.get("id"),
            "node": self.node_id, "replicas": replicas,
            "ts": time.time(),
        })

    def _op_drain_telemetry(self, session, msg):
        """Ship the node tracer's telemetry home: the sampled-span batch
        accumulated since the last drain, plus — when the op asks for a
        ``flight`` — the full flight-recorder ring, so the router folds
        this node into ONE fleet-wide trace file / flight dump instead
        of the dumps stranding on the node host."""
        tracer = self.tracer
        want_flight = bool(msg.get("flight"))
        reply = {
            "event": "reply", "id": msg.get("id"), "node": self.node_id,
        }
        if tracer.enabled and want_flight:
            # breadcrumb INSIDE the shipped ring: when/why this node's
            # flight was pulled
            tracer.event(
                "node.flight_drain",
                attrs={"node": self.node_id,
                       "reason": msg.get("reason") or "fleet"},
            )
        reply["spans"] = tracer.drain_sampled() if tracer.enabled else []
        if want_flight:
            reply["flight_events"] = (
                tracer.flight_snapshot() if tracer.enabled else []
            )
        session.emit(reply)

    def _op_adapter(self, session, msg, fn):
        """Adapter ops run OFF the connection thread: a load_adapter is
        tens of seconds of read + verify + device-put, and running it
        inline would starve the read loop's pong replies past
        lease_secs — the client would tear the connection down and the
        op could never complete. Replies match by rpc id, so the caller
        doesn't care which thread answers."""
        def run():
            try:
                idx = fn()
            except Exception as e:
                session.emit({
                    "event": "reply", "id": msg["id"], "error": str(e),
                })
                return
            session.emit({
                "event": "reply", "id": msg["id"], "index": int(idx),
            })

        threading.Thread(
            target=run, name=f"ds-node-{self.node_id}-adapter",
            daemon=True,
        ).start()

    # -- elastic replica lifecycle (docs/serving.md "SLO autoscaling") ---
    def _op_spawn(self, session, msg):
        """Build + serve a new replica: the scale-up / re-provision op.
        The engine builds OFF the connection thread (same discipline as
        adapter loads — a multi-second model build must not starve pong
        replies past the lease), and the reply lands only once the
        engine is serving: the caller never races a half-built replica."""
        rpc_id = msg.get("id")
        name = str(msg.get("name") or "")
        spec = msg.get("spec")
        prefix_ids = bool(msg.get("prefix_ids", True))

        def run():
            with self._elastic_lock:
                if not name or name == NODE_CONTROL_NAME:
                    session.emit({
                        "event": "reply", "id": rpc_id,
                        "error": f"invalid replica name {name!r}",
                    })
                    return
                if name in self.engines:
                    session.emit({
                        "event": "reply", "id": rpc_id,
                        "error": f"node {self.node_id} already hosts "
                                 f"replica {name!r}",
                    })
                    return
                if (
                    self.max_replicas is not None
                    and len(self.engines) >= self.max_replicas
                ):
                    session.emit({
                        "event": "reply", "id": rpc_id,
                        "error": f"node {self.node_id} at its "
                                 f"max_replicas ceiling "
                                 f"({self.max_replicas})",
                    })
                    return
                engine = None
                try:
                    engine = self._build(
                        dict(spec) if spec else dict(self._spawn_template)
                    )
                    sched = getattr(engine, "scheduler", None)
                    set_prefix = getattr(sched, "set_id_prefix", None)
                    if prefix_ids and set_prefix is not None:
                        set_prefix(f"{self.node_id}/{name}")
                    engine.serve_forever()
                except Exception as e:
                    if engine is not None:
                        # built but never served: free it, or retried
                        # spawns compound the leak until the node OOMs
                        try:
                            engine.close()
                        except Exception as e2:
                            count_suppressed(
                                "serving.node_engine_close", e2
                            )
                    logger.exception(
                        "node %s: spawn of replica %r failed",
                        self.node_id, name,
                    )
                    count_suppressed("serving.node_spawn_failed", e)
                    session.emit({
                        "event": "reply", "id": rpc_id,
                        "error": f"spawn failed: {e}",
                    })
                    return
                self.engines[name] = engine
            logger.info(
                "node %s: spawned replica %r (%d hosted)%s",
                self.node_id, name, len(self.engines), _cuda_memory(),
            )
            if self.tracer.enabled:
                self.tracer.event(
                    "node.spawn_replica",
                    attrs={"node": self.node_id, "replica": name},
                )
            session.emit({
                "event": "reply", "id": rpc_id, "replica": name,
                "replicas": sorted(self.engines),
            })

        threading.Thread(
            target=run, name=f"ds-node-{self.node_id}-spawn", daemon=True,
        ).start()

    def _op_retire(self, session, msg):
        """Drain + close one hosted replica and free its engine: the
        scale-down op. Sessions bound to the retired replica are reaped
        (their in-flight requests cancel and the clients re-route) —
        the router drains first on the graceful path, so a well-ordered
        retire finds them already idle."""
        rpc_id = msg.get("id")
        name = str(msg.get("name") or "")

        def run():
            with self._elastic_lock:
                engine = self.engines.pop(name, None)
                if engine is None:
                    session.emit({
                        "event": "reply", "id": rpc_id,
                        "error": f"node {self.node_id} hosts no replica "
                                 f"{name!r}",
                    })
                    return
                with self._sessions_lock:
                    doomed = [
                        s for (client, rname), s in self._sessions.items()
                        if rname == name
                    ]
                for s in doomed:
                    self._drop_session(
                        s, f"replica {name!r} retired by the control plane"
                    )
                try:
                    engine.close()
                except Exception as e:
                    count_suppressed("serving.node_engine_close", e)
                # the engine and its scheduler refer to each other: collect
                # the cycle now, and hand the freed blocks of PyTorch's
                # caching allocator back to the card, so that a retire
                # frees the engine's memory for the next spawn and for
                # other processes
                engine = doomed = None
                gc.collect()
                if torch.cuda.is_initialized():
                    torch.cuda.empty_cache()
            logger.info(
                "node %s: retired replica %r (%d hosted)%s",
                self.node_id, name, len(self.engines), _cuda_memory(),
            )
            if self.tracer.enabled:
                self.tracer.event(
                    "node.retire_replica",
                    attrs={"node": self.node_id, "replica": name},
                )
            session.emit({
                "event": "reply", "id": rpc_id, "replica": name,
                "replicas": sorted(self.engines),
            })

        threading.Thread(
            target=run, name=f"ds-node-{self.node_id}-retire", daemon=True,
        ).start()

    # -- request watching (worker.py's poller, per session) --------------
    def _watch_loop(self):
        while not self._stop.is_set():
            with self._sessions_lock:
                sessions = list(self._sessions.values())
            for session in sessions:
                if session.dead:
                    continue
                poll_tracked_requests(
                    session.tracked, session.lock, session.emit
                )
            self._stop.wait(self._poll)

    # -- session reaping --------------------------------------------------
    def _reap_loop(self):
        interval = max(
            min(self.resume_grace_secs, self.lease_secs) / 4.0, 0.01
        )
        while not self._stop.wait(interval):
            now = time.monotonic()
            with self._sessions_lock:
                sessions = list(self._sessions.items())
            for key, session in sessions:
                with session.lock:
                    conn = session.conn
                    idle = now - session.last_seen
                    backlog = len(session.outbox)
                if conn is None and idle > self.resume_grace_secs:
                    self._drop_session(
                        session,
                        "no reconnect within the "
                        f"{self.resume_grace_secs:.1f}s resume grace",
                    )
                elif backlog > OUTBOX_MAX_EVENTS:
                    self._drop_session(
                        session,
                        f"event backlog {backlog} past the "
                        f"{OUTBOX_MAX_EVENTS} ceiling (client stopped "
                        "reading)",
                    )
                elif conn is not None and idle > 2.0 * self.lease_secs:
                    # half-open guard: a bound connection that went
                    # silent past two leases is a peer that vanished
                    # without an RST — kill it; the session keeps its
                    # resume grace
                    logger.warning(
                        "node %s: closing silent connection for client "
                        "%s (%.1fs without a frame)",
                        self.node_id, session.client, idle,
                    )
                    count_suppressed("serving.node_halfopen_close")
                    session.unbind(conn)
                    try:
                        conn.close()
                    except OSError:
                        pass

    def _drop_session(self, session, reason):
        with self._sessions_lock:
            self._sessions.pop((session.client, session.replica_name), None)
        self._reap_session(session, reason)

    def _reap_session(self, session, reason):
        """Cancel everything the session still tracks (slots free within
        one decode step) and mark it dead. The client, if it ever
        returns, gets a fresh session whose welcome lists nothing — its
        reconcile fail-finishes the orphans for re-route, so the answer
        is re-derived exactly once elsewhere."""
        with session.lock:
            session.dead = True
            orphans = list(session.tracked.values())
            session.tracked.clear()
            conn, session.conn = session.conn, None
        if orphans:
            logger.warning(
                "node %s: reaping session %s/%s with %d in-flight "
                "request(s): %s", self.node_id, session.client,
                session.replica_name, len(orphans), reason,
            )
            count_suppressed("serving.node_session_reaped")
        for req, _announced, _sent in orphans:
            cancel = getattr(req, "cancel", None)
            if cancel is not None:
                cancel()
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="deepspeed_tpu_torch serving node agent (docs/serving.md "
                    "'Networked fleet')"
    )
    parser.add_argument(
        "--spec", help="node spec as inline JSON", default=None
    )
    parser.add_argument(
        "--spec-file", help="node spec as a JSON file path", default=None
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0,
                        help="0 = ephemeral (announced on stdout)")
    args = parser.parse_args(argv)
    if (args.spec is None) == (args.spec_file is None):
        parser.error("pass exactly one of --spec / --spec-file")
    if args.spec is not None:
        spec = json.loads(args.spec)
    else:
        with open(args.spec_file) as f:
            spec = json.load(f)
    # the launcher contract: stdout carries EXACTLY one JSON line
    # announcing where the node listens (ephemeral ports resolve here).
    # Same fd discipline as worker.main: dup a private handle for the
    # announcement, then point fd 1 at stderr so loggers, stray prints,
    # torch and CUDA warnings cannot corrupt the launcher's readline.
    # The engines build (and a first kernel call may compile the CUDA
    # sources) only after the redirect, so nothing they print reaches
    # the announcement.
    announce = os.fdopen(os.dup(sys.stdout.fileno()), "w", buffering=1)
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())

    def on_term(signum, frame):
        raise KeyboardInterrupt

    # SIGTERM (a provisioner's terminate, a test's teardown) shuts the
    # node down through the same path as an interrupt, so the launch
    # line below is written
    signal.signal(signal.SIGTERM, on_term)
    node = NodeServer(spec, host=args.host, port=args.port)
    t0 = time.time()
    host, port = node.start()
    announce.write(json.dumps({
        "event": "listening", "node": node.node_id,
        "host": host, "port": port,
        "replicas": sorted(node.engines),
        "proto": RPC_PROTOCOL_VERSION,
    }) + "\n")
    try:
        node.run_forever()
    except KeyboardInterrupt:
        pass
    finally:
        node.shutdown()
        # the process's kernel launches, for a caller that checks that
        # the node's engines served through the kernels
        print(f"node: kernel launches {json.dumps(kernel_launches())}",
              file=sys.stderr, flush=True)
        print(f"node: exiting after {time.time() - t0:.1f}s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
