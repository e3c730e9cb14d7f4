"""Socket transport: the replica RPC over real TCP (docs/serving.md
"Networked fleet").

Port of deepspeed_tpu/serving/transport.py.

Two halves share this module's frame codec:

  :class:`SocketReplica`  the router-side backend — the same replica
                          surface as SubprocessReplica (replica.py's
                          RpcReplicaBase carries the RPC state machine),
                          but the bytes cross a network instead of a
                          pipe, so the transport adds what networks
                          demand: heartbeat leases, deadline propagation
                          in the frame header, reconnect-with-resume,
                          and a connect-retry absorbing a dropped
                          accept.
  serving/node.py         the host-side node agent speaking the same
                          frames from the other end.

## Framing

One frame = one line: ``b"<len> <json>\\n"`` where ``<len>`` is the
decimal byte length of the JSON payload. The receiver accepts bare
newline-JSON too (``b"{...}\\n"`` — the pipe protocol's frames are valid
socket frames), but frames SENT here always carry the length header: a
torn write or a chaos-garbled line then fails the length check instead
of parsing as a shorter-but-valid JSON document. An undecodable frame
costs exactly itself — the receiver counts ``fleet/net_frames_corrupt``
and resynchronizes at the next newline; idempotent-RPC retry re-asks.

## Failure semantics

A transient disconnect (peer RST, lease expiry on a half-open link) is
NOT a replica death: the reader reconnects with backoff under
``reconnect_attempts``, presenting the same ``client`` token, and the
node re-attaches the session — in-flight requests keep streaming, buffered
events flush, and re-emitted token events are idempotent (RemoteRequest
checks the token index). Only a reconnect budget exhausted (or a node
refusing the resume) marks the replica ``failed`` — at which point the
router's existing breaker/eviction/re-route machinery takes over, with
the lost requests fail-finished for exactly-once re-derivation
elsewhere. While a reconnect is pending the replica reads
``unresponsive`` (steered around, zombie-watched), never ``failed``.

## Chaos sites (resilience/faults.py)

``conn.stall`` / ``net.partition`` / ``conn.reset`` / ``frame.corrupt``
arm the CLIENT send seam in :meth:`SocketReplica._send`;
``accept.drop`` arms the node's accept loop (node.py). Heartbeat pings
bypass the fault seam on purpose: sites fire per deterministic
traversal count, and a timer-driven ping racing op traffic would make
which op eats the fault nondeterministic — chaos runs must reproduce
byte-for-byte (docs/resilience.md).
"""

import os
import json
import socket
import struct
import threading
import time
import uuid

from ..telemetry.registry import MetricsRegistry, count_suppressed
from ..utils.logging import logger
from .replica import (
    RPC_PROTOCOL_VERSION,
    FencedOut,
    RemoteRequest,
    ReplicaRPCError,
    RpcReplicaBase,
    _FINISH_ERROR,
)

# one frame's hard ceiling: a length header past this is corruption (or
# an attack), not a request — the connection resynchronizes
FRAME_MAX_BYTES = 8 << 20

# the hello's pseudo-replica name for a CONTROL-plane session on a node
# agent (node.py): spawn/retire replica lifecycle ops ride the same
# frame schema but bind to no engine — the autoscaler's elasticity seam
NODE_CONTROL_NAME = "__node__"

# appended by the frame.corrupt chaos mutation: greppable, un-JSON-able
_CORRUPT_MARKER = b'#CHAOS-FRAME-CORRUPT#{"'


class FrameError(ValueError):
    """A frame that failed the length check or JSON decode — the
    receiver drops it (counting ``fleet/net_frames_corrupt``) and
    resynchronizes at the next newline."""


def encode_frame(msg):
    """dict -> one length-prefixed wire line (bytes, newline-terminated).
    The payload must be newline-free — ``json.dumps`` guarantees it."""
    payload = json.dumps(msg).encode("utf-8")
    return b"%d %b\n" % (len(payload), payload)


def decode_frame(line):
    """One received line (with or without the trailing newline) ->
    dict. Accepts the length-prefixed form (validated) and bare
    newline-JSON (the pipe protocol's frames); anything else raises
    :class:`FrameError`."""
    line = line.rstrip(b"\r\n")
    if not line:
        raise FrameError("empty frame")
    body = line
    if line[:1].isdigit():
        head, sep, rest = line.partition(b" ")
        if sep:
            try:
                declared = int(head)
            except ValueError:
                raise FrameError(
                    f"unparsable length header {head[:32]!r}"
                ) from None
            if declared > FRAME_MAX_BYTES:
                raise FrameError(
                    f"declared frame length {declared} exceeds the "
                    f"{FRAME_MAX_BYTES}-byte ceiling"
                )
            if declared != len(rest):
                raise FrameError(
                    f"frame length mismatch: header says {declared}, "
                    f"payload is {len(rest)} bytes (torn or garbled "
                    "write)"
                )
            body = rest
    try:
        msg = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise FrameError(f"undecodable frame payload: {e}") from None
    if not isinstance(msg, dict):
        raise FrameError(
            f"frame payload is {type(msg).__name__}, expected an object"
        )
    return msg


def corrupt_frame(data):
    """The ``frame.corrupt`` chaos mutation: garble an encoded frame
    beyond both the length check and JSON repair while keeping it ONE
    line, so the receiver's framing resynchronizes immediately after
    dropping it."""
    keep = data.rstrip(b"\n")[: max(len(data) // 2, 1)]
    return keep.replace(b"\n", b" ") + _CORRUPT_MARKER + b"\n"


def read_frame_line(rfile):
    """One raw line from a socket file, bounded at the frame ceiling.
    Returns ``b""`` at EOF; raises :class:`FrameError` when no newline
    arrives within the ceiling (a desynchronized or hostile peer)."""
    line = rfile.readline(FRAME_MAX_BYTES + 64)
    if line and not line.endswith(b"\n") and len(line) > FRAME_MAX_BYTES:
        raise FrameError(
            f"no frame boundary within {FRAME_MAX_BYTES} bytes"
        )
    return line


class SocketReplica(RpcReplicaBase):
    """The router's handle on one replica hosted by a remote node agent
    (serving/node.py), speaking the replica RPC over TCP.

    ``address`` is ``(host, port)`` or ``"host:port"``; ``remote_name``
    names the replica on the node (default: ``replica_id``). The
    ``replica_id`` seen by the router should be globally unique across
    nodes (convention: ``"<node>:<name>"``) — request ids minted by the
    node's schedulers carry the ``{node_id}/{name}`` prefix, so fleet
    telemetry never sees two hosts minting the same id.

    Lease/heartbeat: the replica pings every ``lease_secs / 3``; a
    connection silent past ``lease_secs`` is torn down
    (``fleet/net_lease_expiries``) and the reader reconnects — the
    half-open-connection detector. Reconnects (``reconnect_attempts``
    with exponential backoff) resume the node session in place:
    ``fleet/net_reconnects`` counts each successful re-attach.
    """

    def __init__(self, replica_id, address, remote_name=None, *,
                 rpc_timeout=10.0, rpc_retries=2, rpc_backoff_secs=0.05,
                 connect_timeout=10.0, connect_retries=3,
                 lease_secs=10.0, reconnect_attempts=3,
                 reconnect_backoff_secs=0.1, registry=None,
                 fault_injector=None, epoch=None):
        super().__init__(
            replica_id, rpc_timeout=rpc_timeout, rpc_retries=rpc_retries,
            rpc_backoff_secs=rpc_backoff_secs,
            fault_injector=fault_injector,
        )
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            address = (host or "127.0.0.1", int(port))
        self.address = (str(address[0]), int(address[1]))
        self.remote_name = (
            str(remote_name) if remote_name is not None else self.replica_id
        )
        self._connect_timeout = float(connect_timeout)
        self._connect_retries = int(connect_retries)
        # this router incarnation's fencing epoch (the fleet journal's
        # incarnation number): the hello presents it, the node compares
        # it against its high-water mark, and a lower epoch is rejected
        # with a typed fenced_out error — the split-brain guard. None
        # (the default, and every pre-epoch client) fences nothing.
        self.epoch = None if epoch is None else int(epoch)
        self.lease_secs = float(lease_secs)
        self._reconnect_attempts = int(reconnect_attempts)
        self._reconnect_backoff = float(reconnect_backoff_secs)
        reg = registry if registry is not None else MetricsRegistry()
        self._net_reconnects = reg.counter(
            "fleet/net_reconnects",
            help="socket transport reconnect-with-resume successes",
        )
        self._net_lease_expiries = reg.counter(
            "fleet/net_lease_expiries",
            help="connections torn down after a silent lease window",
        )
        self._net_frames_corrupt = reg.counter(
            "fleet/net_frames_corrupt",
            help="received frames dropped for failing the length check "
                 "or JSON decode",
        )
        self._sock = None
        self._rfile = None
        self._reader = None
        self._heartbeat = None
        self._hb_stop = threading.Event()
        self._started = False
        # reconnect budget exhausted (or resume refused): the terminal
        # "this connection will not heal" state — the ONLY state where
        # the replica reads failed
        self._gone = False
        # the node fenced this incarnation's epoch out: terminal like
        # _gone, but diagnosable — the router stands the whole fleet
        # down instead of treating it as one more dead replica
        self._fenced = False
        self._last_pong = 0.0
        self._client = None
        self.node_id = None
        # armed by adopt_session (journal.py recovery): the next start()
        # resumes a previous incarnation's node session instead of
        # minting a fresh client token
        self._adopted = None
        self._adopted_handles = {}
        self._replay_on_connect = False

    # -- adoption (journal.py "Control-plane durability") ----------------
    def adopt_session(self, client, *, rpc_base, entries=()):
        """Arm the next :meth:`start` to RESUME a previous incarnation's
        node session: present the journaled ``client`` token (the
        node's session key), re-base rpc-id minting above ``rpc_base``
        (the journaled incarnation's block — a new submit must never
        collide with an id the node still tracks), and pre-register a
        :class:`~.replica.RemoteRequest` per journaled in-flight entry
        (``{"rpc_id", "prompt", "max_new_tokens"}``) so the node's
        outbox replay lands in real handles the moment the session
        re-binds. Entries the node no longer remembers fail-finish at
        the welcome reconcile — the router re-routes them."""
        self._adopted = {
            "client": str(client),
            "rpc_base": int(rpc_base),
            "entries": [dict(e) for e in entries],
        }
        return self

    def adopted_handles(self):
        """``{rpc_id: RemoteRequest}`` for the entries the last adopted
        start() pre-registered (the router binds these into its
        outstanding table)."""
        return dict(self._adopted_handles)

    @property
    def client_token(self):
        """The live session's client token — what the journal records
        and a restarted router presents to resume this node session."""
        return self._client

    # -- connection management ------------------------------------------
    def start(self, start_timeout=None):
        if self._transport_alive():
            return self
        # fault site: crash-on-(re)start (see InProcessReplica.start)
        self.faults.maybe_raise("replica.flap")
        self._shutdown_requested = False
        self._gone = False
        self._fenced = False
        self._reset_rpc_state()
        adopted, self._adopted = self._adopted, None
        self._adopted_handles = {}
        if adopted is not None:
            # adoption: resume the journaled session under its own
            # client token; the node replays tracked tokens from index
            # 0 (the idempotent absolute-index append dedups) and
            # flushes buffered finished events — completions that
            # finished while the router was dead DELIVER, not re-run
            self._client = adopted["client"]
            self._rebase_rpc_ids(adopted["rpc_base"])
            with self._state_lock:
                for entry in adopted["entries"]:
                    req = RemoteRequest(
                        entry["rpc_id"], entry.get("prompt") or (),
                        entry.get("max_new_tokens", 32),
                    )
                    self._outstanding[entry["rpc_id"]] = req
                    self._adopted_handles[entry["rpc_id"]] = req
            self._replay_on_connect = True
            self._connect(resume=True)
        else:
            # a fresh incarnation mints a fresh client token: rpc ids
            # restart from 1, so resuming a PREVIOUS incarnation's node
            # session would cross-wire its orphan events onto new
            # requests
            self._client = f"{os.getpid():x}-{uuid.uuid4().hex[:8]}"
            self._connect(resume=False)
        timeout = (
            self._connect_timeout if start_timeout is None
            else float(start_timeout)
        )
        if not self._ready.wait(timeout):
            self.shutdown()
            raise RuntimeError(
                f"replica {self.replica_id}: node {self.address} did not "
                f"answer the hello within {timeout}s"
            )
        # fail-fast on version skew, both versions named (never one
        # undecodable frame at a time until the breaker opens)
        self._check_protocol()
        self._started = True
        self._hb_stop.clear()
        self._heartbeat = threading.Thread(
            target=self._heartbeat_loop,
            name=f"ds-socket-{self.replica_id}-lease", daemon=True,
        )
        self._heartbeat.start()
        return self

    def _connect(self, resume):
        """Dial the node, send the hello, and consume frames until the
        ``ready`` — leaving the socket positioned at the op stream.
        Connect failures retry ``connect_retries`` times (an overloaded
        listener dropping an accept costs a retry, not a replica)."""
        last_exc = None
        for attempt in range(max(self._connect_retries, 1)):
            sock = None
            try:
                sock = socket.create_connection(
                    self.address, timeout=self._connect_timeout
                )
                sock.settimeout(self._connect_timeout)
                hello = {
                    "op": "hello", "proto": RPC_PROTOCOL_VERSION,
                    "client": self._client, "replica": self.remote_name,
                    "resume": bool(resume),
                }
                if self.epoch is not None:
                    hello["epoch"] = self.epoch
                if self._replay_on_connect:
                    # adoption resume: ask the node to re-emit every
                    # tracked request's tokens from index 0 — this
                    # incarnation's handles start empty, and the
                    # committed prefix must stream again (absolute
                    # indices make the re-emit idempotent)
                    hello["replay"] = True
                sock.sendall(encode_frame(hello))
                rfile = sock.makefile("rb")
                deadline = time.monotonic() + self._connect_timeout
                got_ready = False
                while time.monotonic() < deadline:
                    line = read_frame_line(rfile)
                    if not line:
                        raise ConnectionError(
                            "node closed the connection during the "
                            "handshake (accept dropped?)"
                        )
                    try:
                        msg = decode_frame(line)
                    except FrameError as e:
                        self._count_corrupt(e)
                        continue
                    if (
                        msg.get("event") == "error"
                        and msg.get("code") == "fenced_out"
                    ):
                        # the node knows a newer incarnation: this
                        # router must stand down, not retry its way in
                        self._fenced = True
                        self._gone = True
                        try:
                            sock.close()
                        except OSError:
                            pass
                        raise FencedOut(
                            f"replica {self.replica_id}: node "
                            f"{self.address[0]}:{self.address[1]} fenced "
                            f"out epoch {self.epoch} (node high-water "
                            f"epoch {msg.get('high_water')}) — a newer "
                            "router incarnation owns this fleet",
                            epoch=self.epoch,
                            high_water=msg.get("high_water"),
                        )
                    self._dispatch(msg)
                    if msg.get("event") == "ready":
                        got_ready = True
                        break
                if not got_ready:
                    raise ConnectionError(
                        "handshake did not complete within the connect "
                        "timeout"
                    )
                sock.settimeout(None)
                # bound SENDS only (reads must block between events): a
                # frozen node / zero-window link would otherwise park a
                # sendall inside _write_lock forever — and the heartbeat
                # needs that lock to ping, so the lease detector could
                # never tear down the very connection it watches
                try:
                    secs = max(self.lease_secs, 1.0)
                    sock.setsockopt(
                        socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                        struct.pack("ll", int(secs),
                                    int((secs % 1.0) * 1e6)),
                    )
                except (OSError, ValueError):  # pragma: no cover
                    pass
                with self._write_lock:
                    self._sock, self._rfile = sock, rfile
                self._last_pong = time.monotonic()
                # replay is a one-shot adoption ask: ordinary reconnects
                # resume from the session's own sent counters
                self._replay_on_connect = False
                if self._reader is None or not self._reader.is_alive():
                    self._reader = threading.Thread(
                        target=self._read_loop,
                        name=f"ds-socket-{self.replica_id}-reader",
                        daemon=True,
                    )
                    self._reader.start()
                return
            except (OSError, ConnectionError, socket.timeout) as e:
                last_exc = e
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                count_suppressed("serving.net_connect_retry", e)
                time.sleep(self._reconnect_backoff * (2.0 ** attempt))
        raise ReplicaRPCError(
            f"replica {self.replica_id}: cannot reach node "
            f"{self.address[0]}:{self.address[1]} after "
            f"{self._connect_retries} attempts ({last_exc!r})"
        )

    def _abort_connection(self, reason):
        """Kill the current socket (the reader's blocked read returns,
        entering the reconnect path). Safe from any thread."""
        with self._write_lock:
            sock, self._sock, self._rfile = self._sock, None, None
        if sock is not None:
            logger.warning(
                "replica %s: dropping socket to %s:%d (%s)",
                self.replica_id, self.address[0], self.address[1], reason,
            )
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _read_loop(self):
        """Reader + reconnect driver: one thread for the replica's whole
        incarnation. A stream ending WITHOUT a requested shutdown enters
        reconnect-with-resume; only an exhausted budget fails the
        replica (and everything it carried) for the router's
        breaker/eviction/re-route path."""
        while True:
            rfile = self._rfile
            if rfile is not None:
                try:
                    for line in iter(lambda: read_frame_line(rfile), b""):
                        try:
                            msg = decode_frame(line)
                        except FrameError as e:
                            self._count_corrupt(e)
                            continue
                        self._dispatch(msg)
                except (OSError, ValueError, FrameError) as e:
                    # a reset/closed socket mid-read lands here; a
                    # FrameError from a missing boundary means a
                    # desynchronized peer — reconnect cleans both up
                    count_suppressed("serving.net_read_error", e)
            if self._shutdown_requested:
                self._on_transport_eof(graceful=True)
                return
            self._abort_connection("stream ended")
            if not self._reconnect():
                if self._shutdown_requested:
                    # shutdown() landed mid-reconnect: that's a requested
                    # exit, not an exhausted budget — clean shutdowns
                    # must not read like crashes (no died-in-flight
                    # diagnostics, no breaker food)
                    self._on_transport_eof(graceful=True)
                    return
                self._gone = True
                logger.warning(
                    "replica %s: reconnect budget (%d) exhausted; "
                    "marking the replica failed for eviction/re-route",
                    self.replica_id, self._reconnect_attempts,
                )
                self._on_transport_eof(graceful=False)
                return

    def _reconnect(self):
        for attempt in range(max(self._reconnect_attempts, 0)):
            if self._shutdown_requested:
                return False
            time.sleep(self._reconnect_backoff * (2.0 ** attempt))
            try:
                self._connect(resume=True)
            except FencedOut as e:
                # terminal by design: retrying a fence-out would be the
                # exact split-brain the epoch exists to prevent
                logger.error(
                    "replica %s: %s — standing down", self.replica_id, e
                )
                count_suppressed("serving.net_fenced_out", e)
                return False
            except (ReplicaRPCError, OSError) as e:
                count_suppressed("serving.net_reconnect_attempt", e)
                continue
            self._net_reconnects.inc()
            logger.warning(
                "replica %s: reconnected to node %s:%d (attempt %d); "
                "resuming the in-flight session",
                self.replica_id, self.address[0], self.address[1],
                attempt + 1,
            )
            return True
        return False

    def _count_corrupt(self, exc):
        self._net_frames_corrupt.inc()
        logger.warning(
            "replica %s: dropped corrupt frame (%s)", self.replica_id, exc
        )
        count_suppressed("serving.net_frame_corrupt", exc)

    def _heartbeat_loop(self):
        """Ping on a lease_secs/3 cadence and tear down connections
        whose pongs stop — the half-open link detector. Pings bypass the
        chaos seam (see module docstring) via the raw writer."""
        interval = max(self.lease_secs / 3.0, 0.01)
        while not self._hb_stop.wait(interval):
            if self._shutdown_requested or self._gone:
                return
            sock = self._sock
            if sock is None:
                continue  # reconnect in progress; the lease restarts then
            try:
                with self._write_lock:
                    if self._sock is sock:
                        sock.sendall(encode_frame({"op": "ping"}))
            except OSError as e:
                count_suppressed("serving.net_ping_failed", e)
                self._abort_connection("ping write failed")
                continue
            if time.monotonic() - self._last_pong > self.lease_secs:
                self._net_lease_expiries.inc()
                count_suppressed("serving.net_lease_expired")
                self._abort_connection(
                    f"lease expired (no pong in {self.lease_secs:.1f}s)"
                )

    # -- RpcReplicaBase transport hooks ---------------------------------
    def _transport_alive(self):
        return self._sock is not None and not self._gone

    def _transport_recovering(self):
        return (
            self._started and not self._gone
            and not self._shutdown_requested
        )

    def _send(self, msg):
        sock = self._sock
        if sock is None or self._gone:
            raise self._transport_dead_exc("socket is not connected")
        if self.faults.enabled:
            # the socket chaos seams, in escalation order: a stalled
            # link, a black-holed frame, a peer RST (docs/resilience.md)
            self.faults.maybe_stall("conn.stall")
            if self.faults.fire("net.partition") is not None:
                # the network ate it; the connection looks fine — only a
                # reply timeout or lease expiry will notice
                count_suppressed("serving.net_partition_drop")
                return
            try:
                self.faults.maybe_raise("conn.reset")
            except ConnectionResetError:
                self._abort_connection("injected connection reset")
                raise self._transport_dead_exc(
                    "connection reset by peer"
                ) from None
        data = encode_frame(msg)
        if self.faults.enabled and (
            self.faults.fire("frame.corrupt") is not None
        ):
            data = corrupt_frame(data)
        with self._write_lock:
            if self._sock is not sock:
                raise self._transport_dead_exc(
                    "socket closed mid-call"
                )
            try:
                sock.sendall(data)
            except OSError:
                pass_exc = self._transport_dead_exc("socket send failed")
            else:
                return
        self._abort_connection("send failed")
        raise pass_exc from None

    def _frame_submit(self, msg, kwargs):
        """Deadline propagation in the frame header: ``deadline_secs``
        leaves the app kwargs and rides as ``dl_ms`` — the node
        re-derives the engine deadline from it, so the deadline is a
        TRANSPORT fact both ends enforce, not an opaque kwarg."""
        del kwargs
        dl = msg.get("kwargs", {}).pop("deadline_secs", None)
        if dl is not None:
            msg["dl_ms"] = max(int(float(dl) * 1e3), 1)
        return msg

    def _dispatch_extra(self, msg):
        event = msg.get("event")
        if event == "welcome":
            self.node_id = msg.get("node")
            self._remote_proto = msg.get("proto", 0)
            self._reconcile_resume(msg.get("inflight") or ())
            return True
        if event == "pong":
            self._last_pong = time.monotonic()
            return True
        return False

    def _reconcile_resume(self, inflight):
        """The welcome's authoritative in-flight list: outstanding
        requests the node does NOT remember (its session expired past
        the resume grace, or the submit frame never arrived) will never
        complete here — fail-finish them now so the router re-routes
        instead of waiting for the slower snapshot-based lost-completion
        sweep."""
        known = set(inflight)
        with self._state_lock:
            if not self._outstanding:
                return
            orphans = [
                self._outstanding.pop(rpc_id)
                for rpc_id in list(self._outstanding)
                if rpc_id not in known
            ]
        for req in orphans:
            logger.warning(
                "replica %s: request %s not in the node's resumed "
                "session; failing it for re-route",
                self.replica_id, req.rpc_id,
            )
            count_suppressed("serving.rpc_lost_completion")
            req._finish(req.tokens, _FINISH_ERROR)

    # -- lifecycle ------------------------------------------------------
    def restart(self):
        self.shutdown()
        return self.start()

    def shutdown(self, grace=5.0):
        self._shutdown_requested = True
        self._started = False
        self._hb_stop.set()
        sock = self._sock
        if sock is not None:
            try:
                with self._write_lock:
                    sock.sendall(encode_frame({"op": "bye"}))
            except OSError:
                pass
        self._abort_connection("shutdown requested")
        for t in (self._heartbeat, self._reader):
            if t is not None:
                t.join(grace)
        self._heartbeat = None
        self._reader = None
        # the reader may have exited before the socket dropped (never
        # started, or died earlier): its EOF sweep then cannot run, so
        # make the orphan sweep unconditional — it is idempotent
        self._on_transport_eof(graceful=True)

    @property
    def alive(self):
        return self._started and not self._gone

    @property
    def failed(self):
        return self._gone and not self._shutdown_requested

    @property
    def fenced(self):
        """True once the node rejected this incarnation's epoch: the
        router checks this on its failed-replica sweep and stands the
        whole incarnation down (a fenced replica is evidence of a newer
        router, not of a dead node)."""
        return self._fenced


class NodeControlClient:
    """Short-lived synchronous control-plane client for a node agent
    (serving/node.py): dial, hello as the :data:`NODE_CONTROL_NAME`
    pseudo-replica, one op, one reply, bye. Built per call — control
    ops are rare (autoscale transitions), so persistent-connection
    machinery (leases, reconnect-with-resume) buys nothing here; a
    dead node answers as a connect/read failure the caller absorbs.

    ``spawn_replica`` is generously timed out by default: the node
    builds the new engine (model init or checkpoint load + device put)
    before replying."""

    def __init__(self, address, *, connect_timeout=10.0,
                 op_timeout=180.0, epoch=None):
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            address = (host or "127.0.0.1", int(port))
        self.address = (str(address[0]), int(address[1]))
        self._connect_timeout = float(connect_timeout)
        self._op_timeout = float(op_timeout)
        # control ops fence exactly like data sessions: a stale router's
        # spawn/retire would mutate a fleet a newer incarnation owns
        self.epoch = None if epoch is None else int(epoch)

    def spawn_replica(self, name, spec=None, node_prefix_ids=True):
        """Ask the node to build + serve a new replica ``name`` (engine
        constructed OFF the connection thread — see node.py). ``spec``
        defaults to the node's own spawn template. Returns the node's
        reply dict; raises RuntimeError on a node-side refusal (name
        collision, max_replicas, builder failure)."""
        op = {"op": "spawn_replica", "name": str(name)}
        if spec is not None:
            op["spec"] = dict(spec)
        if not node_prefix_ids:
            op["prefix_ids"] = False
        return self._roundtrip(op)

    def retire_replica(self, name):
        """Ask the node to drain + close replica ``name`` and free its
        engine (the scale-down counterpart of :meth:`spawn_replica`)."""
        return self._roundtrip({"op": "retire_replica", "name": str(name)})

    def node_info(self):
        """The node's live replica roster (``{"node": ..., "replicas":
        [...]}``) — what a provider verifies a spawn/retire against."""
        return self._roundtrip({"op": "node_info"})

    def metrics_snapshot(self):
        """Scrape the node: one JSON-safe wire snapshot per live
        replica registry (``{"node": ..., "replicas": {name:
        [wire entries]}, "ts": ...}``) — the telemetry hub's pull op
        (telemetry/hub.py)."""
        return self._roundtrip({"op": "metrics_snapshot"})

    def drain_telemetry(self, flight=False, reason=None):
        """Ship the node tracer's sampled-span batch home (``{"node":
        ..., "spans": [...]}``); with ``flight=True`` the reply also
        carries the node's full flight-recorder ring so the router can
        fold it into one fleet-wide dump."""
        op = {"op": "drain_telemetry"}
        if flight:
            op["flight"] = True
        if reason is not None:
            op["reason"] = str(reason)
        return self._roundtrip(op)

    def _roundtrip(self, op):
        sock = socket.create_connection(
            self.address, timeout=self._connect_timeout
        )
        try:
            sock.settimeout(self._op_timeout)
            hello = {
                "op": "hello", "proto": RPC_PROTOCOL_VERSION,
                "client": f"ctl-{os.getpid():x}-{uuid.uuid4().hex[:8]}",
                "replica": NODE_CONTROL_NAME,
            }
            if self.epoch is not None:
                hello["epoch"] = self.epoch
            sock.sendall(encode_frame(hello))
            rfile = sock.makefile("rb")
            self._await_event(rfile, "ready")
            sock.sendall(encode_frame(dict(op, id=1)))
            reply = self._await_event(rfile, "reply")
            try:
                sock.sendall(encode_frame({"op": "bye"}))
            except OSError:
                pass
            if reply.get("error"):
                raise RuntimeError(
                    f"node {self.address[0]}:{self.address[1]} refused "
                    f"{op.get('op')}: {reply['error']}"
                )
            return reply
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _await_event(self, rfile, event):
        deadline = time.monotonic() + self._op_timeout
        while time.monotonic() < deadline:
            line = read_frame_line(rfile)
            if not line:
                raise ConnectionError(
                    f"node {self.address[0]}:{self.address[1]} closed the "
                    f"control connection before answering"
                )
            try:
                msg = decode_frame(line)
            except FrameError:
                continue
            if msg.get("event") == "error":
                if msg.get("code") == "fenced_out":
                    raise FencedOut(
                        f"node {self.address[0]}:{self.address[1]} fenced "
                        f"out control epoch {self.epoch} (node high-water "
                        f"epoch {msg.get('high_water')})",
                        epoch=self.epoch,
                        high_water=msg.get("high_water"),
                    )
                raise RuntimeError(str(msg.get("error")))
            if msg.get("event") == event:
                return msg
        raise TimeoutError(
            f"node {self.address[0]}:{self.address[1]}: no {event!r} "
            f"within {self._op_timeout}s"
        )
