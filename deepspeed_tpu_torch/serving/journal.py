"""Durable control plane: the write-ahead fleet-state journal.

Port of deepspeed_tpu/serving/journal.py.

The node agents are already durable workers — each keeps per-session
in-flight tables and event outboxes with absolute token indices
(node.py "Sessions and resume") and keeps decoding while a client is
away. The router host was the remaining single point of failure: a
SIGKILL lost the adapter registry, autoscaler state, brownout flag and
every in-flight placement, even though the answers kept being computed
underneath. This module makes the router RESTARTABLE state over those
durable workers (docs/serving.md "Control-plane durability").

## The journal

:class:`FleetJournal` holds the fleet's control-plane state — node
addresses, replica memberships (with each socket session's client token
and rpc-id high-water mark), the fleet adapter registry, brownout
state, the autoscaler's durable half (target / cooldown / flap
evidence, wall-clock converted), and a BOUNDED table of in-flight
request descriptors keyed by the door's request ids — and commits a
full snapshot through the PR-2 atomic protocol (resilience/atomic_io:
tmp + fsync + ``os.replace``, then the ``latest`` pointer) on every
mutation, BEFORE the mutation takes effect. Each segment embeds a
sha256 over its canonical payload, so recovery classifies segments
with the manifest verdicts (VALID / CORRUPT / MISSING) instead of
trusting whatever bytes a torn write left behind.

Commit cost is bounded by design: writes happen only on control-plane
mutations and request open / terminal transitions — never per token —
and a disabled ``serving.journal`` config builds no journal, no files,
zero extra work (the hub/autoscaler disabled contract).

## Recovery

:func:`load_journal_state` reads the ``latest`` pointer and walks
segments newest-first until one verifies: a torn write, truncated
segment, stale ``latest`` or malformed JSON costs exactly the bad
segment (counted on ``fleet/journal_corruptions``), and the newest
VALID snapshot is adopted whole (``fleet/journal_recoveries``) — never
a half-adopt. With nothing valid the fleet starts cold with a loud
counted warning.

:func:`plan_adoption` turns a recovered snapshot into live replicas: it
re-dials each journaled node's control session, confirms the replica
roster via ``node_info``, and arms a :class:`~.transport.SocketReplica`
per surviving replica to RESUME the journaled session (same client
token, rpc ids re-based above the journaled incarnation so a new
submit can never collide with an adopted one, journaled in-flight rpc
ids pre-registered so the node's outbox replay lands in real request
handles). The router then adopts the plan (``FleetRouter`` ``journal``
/ ``recovered`` kwargs): completions that finished while the router
was dead DELIVER from the node outbox instead of re-running, orphans
the node forgot re-place bounded by ``max_reroutes``, every adopted
replica's breaker re-arms in half-open probation, and telemetry gauges
re-mint (``fleet/adopted_replicas``).

What is deliberately NOT journaled: breaker failure counts and load
snapshots (probation-on-adopt re-derives trust from live traffic),
telemetry series (monotonic counters cannot survive a process swap
honestly), and per-token progress (the node outbox already owns it).
"""

import hashlib
import itertools
import json
import os
import threading
import time

from ..resilience import atomic_io
from ..resilience.faults import NULL_INJECTOR
from ..telemetry.registry import count_suppressed
from ..utils.logging import logger

JOURNAL_FORMAT_VERSION = 1
LATEST_FILE = "latest"
_SEGMENT_PREFIX = "journal-"
_SEGMENT_SUFFIX = ".json"

# segment verdicts — the manifest protocol's vocabulary (resilience/
# manifest.py), reused so corruption postmortems read the same fleet-wide
JOURNAL_VALID = "VALID"
JOURNAL_CORRUPT = "CORRUPT"
JOURNAL_MISSING = "MISSING"

# adopted incarnations re-base rpc ids in blocks of this size: a resumed
# node session still tracks the OLD incarnation's rpc ids, and a new
# submit minting a colliding id would cross-wire the node's in-flight
# table — one block per incarnation keeps the id spaces disjoint unless
# a single router life mints > 4e9 RPCs
RPC_ID_INCARNATION_BLOCK = 1 << 32


def _segment_name(seq):
    return f"{_SEGMENT_PREFIX}{int(seq):08d}{_SEGMENT_SUFFIX}"


def _parse_segment_seq(name):
    """Segment sequence number, or None for a non-segment filename."""
    if (
        not name.startswith(_SEGMENT_PREFIX)
        or not name.endswith(_SEGMENT_SUFFIX)
    ):
        return None
    body = name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]
    try:
        return int(body)
    except ValueError:
        return None


def _canonical(payload):
    """The byte form the segment checksum covers. Canonical (sorted
    keys, no whitespace) so a JSON round-trip re-verifies bitwise."""
    return json.dumps(
        payload, sort_keys=True, separators=(",", ":")
    ).encode("utf-8")


def _encode_segment(payload):
    digest = hashlib.sha256(_canonical(payload)).hexdigest()
    return json.dumps({
        "format_version": JOURNAL_FORMAT_VERSION,
        "sha256": digest,
        "payload": payload,
    }, sort_keys=True).encode("utf-8")


def verify_segment(path):
    """Classify one journal segment: ``(verdict, payload_or_None,
    reason)``. Only a checksum-verified, version-matched segment is
    VALID — a torn write, truncation, or malformed JSON is CORRUPT,
    never a silently-partial adoption."""
    try:
        data = atomic_io.read_bytes(path)
    except FileNotFoundError:
        return JOURNAL_MISSING, None, "segment file absent"
    except OSError as e:
        return JOURNAL_MISSING, None, f"segment unreadable: {e}"
    try:
        env = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        return JOURNAL_CORRUPT, None, f"undecodable segment: {e}"
    if not isinstance(env, dict) or "payload" not in env:
        return JOURNAL_CORRUPT, None, "segment missing payload envelope"
    if env.get("format_version") != JOURNAL_FORMAT_VERSION:
        return (
            JOURNAL_CORRUPT, None,
            f"format_version {env.get('format_version')!r} != "
            f"{JOURNAL_FORMAT_VERSION}",
        )
    payload = env["payload"]
    digest = hashlib.sha256(_canonical(payload)).hexdigest()
    if digest != env.get("sha256"):
        return JOURNAL_CORRUPT, None, "payload checksum mismatch"
    if not isinstance(payload, dict):
        return JOURNAL_CORRUPT, None, "payload is not an object"
    return JOURNAL_VALID, payload, "ok"


def list_segments(journal_dir):
    """Segment filenames newest-first (by sequence number)."""
    try:
        names = os.listdir(journal_dir)
    except OSError:
        return []
    seqs = [
        (seq, name) for name in names
        if (seq := _parse_segment_seq(name)) is not None
    ]
    return [name for _seq, name in sorted(seqs, reverse=True)]


def load_journal_state(journal_dir, registry=None):
    """Recover the newest valid fleet snapshot from ``journal_dir``.

    Returns ``(payload_or_None, info)`` where ``info`` carries
    ``status`` (``"missing"`` — no journal at all, ``"recovered"`` — a
    valid snapshot adopted, ``"cold"`` — a journal existed but nothing
    verified), the adopted ``segment`` name, and the list of
    ``corrupt`` segments skipped on the way. The walk is latest-pointer
    first, then every remaining segment newest-first: a stale or torn
    ``latest`` costs a fallback scan, never a half-adopt.
    """
    corrupt = []
    c_corrupt = c_recover = None
    if registry is not None:
        c_corrupt = registry.counter(
            "fleet/journal_corruptions",
            help="journal segments skipped as torn/truncated/malformed "
                 "during recovery",
        )
        c_recover = registry.counter(
            "fleet/journal_recoveries",
            help="successful fleet-state recoveries from the journal",
        )
    segments = list_segments(journal_dir)
    latest_path = os.path.join(journal_dir, LATEST_FILE)
    ordered = []
    try:
        latest = atomic_io.read_text(latest_path).strip()
    except OSError:
        latest = None
    if latest is not None:
        if os.path.basename(latest) == latest and latest in segments:
            ordered.append(latest)
        else:
            # stale latest: points outside the surviving segment set
            corrupt.append(LATEST_FILE)
    ordered.extend(name for name in segments if name not in ordered)
    if not ordered and latest is None:
        return None, {"status": "missing", "segment": None, "corrupt": []}
    for name in ordered:
        verdict, payload, reason = verify_segment(
            os.path.join(journal_dir, name)
        )
        if verdict == JOURNAL_VALID:
            if corrupt:
                logger.warning(
                    "fleet journal: adopted %s after skipping %d bad "
                    "entr%s (%s)", name, len(corrupt),
                    "y" if len(corrupt) == 1 else "ies",
                    ", ".join(corrupt),
                )
            if c_corrupt is not None and corrupt:
                c_corrupt.inc(len(corrupt))
            if c_recover is not None:
                c_recover.inc()
            return payload, {
                "status": "recovered", "segment": name, "corrupt": corrupt,
            }
        corrupt.append(name)
        logger.warning(
            "fleet journal: segment %s is %s (%s) — falling back",
            name, verdict, reason,
        )
    # a journal directory existed but nothing verified: start cold,
    # LOUDLY — silent amnesia here would read as a healthy empty fleet
    logger.error(
        "fleet journal: no valid snapshot in %s (%d corrupt entr%s) — "
        "starting cold; in-flight requests from the previous life will "
        "re-run when clients retry", journal_dir, len(corrupt),
        "y" if len(corrupt) == 1 else "ies",
    )
    if c_corrupt is not None and corrupt:
        c_corrupt.inc(len(corrupt))
    return None, {"status": "cold", "segment": None, "corrupt": corrupt}


def _blank_state():
    return {
        "format_version": JOURNAL_FORMAT_VERSION,
        "seq": 0,
        "incarnation": 1,
        "written_unix": 0.0,
        "nodes": {},      # node name -> [host, port]
        "replicas": {},   # replica id -> membership + session descriptor
        "adapters": {},   # adapter name -> fleet-wide load kwargs
        "brownout": False,
        "autoscaler": None,
        "request_seq": -1,  # high-water mark of door request ids
        "inflight": {},   # str(request id) -> descriptor
    }


class FleetJournal:
    """The write-ahead half: every mutator updates the in-memory state
    and commits the full snapshot atomically BEFORE returning, so the
    caller applies the mutation only once it is durable. Thread-safe
    (the router mutates from the submit path, the monitor thread, and
    shutdown)."""

    def __init__(self, journal_dir, *, registry=None, fault_injector=None,
                 fsync=True, keep_segments=3, max_inflight=256,
                 state=None, incarnation=None):
        self.journal_dir = str(journal_dir)
        os.makedirs(self.journal_dir, exist_ok=True)
        self._fsync = bool(fsync)
        self._keep = max(int(keep_segments), 1)
        self.max_inflight = max(int(max_inflight), 1)
        self._faults = fault_injector or NULL_INJECTOR
        self._lock = threading.Lock()
        self._state = _blank_state()
        if state is not None:
            # recovery: adopt the snapshot whole, then advance the
            # incarnation — the new life's rpc-id block must sit above
            # every id the journaled sessions ever minted
            for key in self._state:
                if key in state:
                    self._state[key] = state[key]
            self._state["incarnation"] = int(state.get("incarnation", 1)) + 1
        if incarnation is not None:
            self._state["incarnation"] = int(incarnation)
        # continue the segment sequence past anything on disk (including
        # corrupt leftovers): recovery history stays inspectable until
        # pruning ages it out
        disk_seqs = [
            _parse_segment_seq(n) for n in list_segments(self.journal_dir)
        ]
        self._state["seq"] = max(
            [self._state["seq"]] + [s for s in disk_seqs if s is not None]
        )
        self._c_writes = self._c_evicted = None
        if registry is not None:
            self._c_writes = registry.counter(
                "fleet/journal_writes",
                help="atomic fleet-journal snapshot commits",
            )
            self._c_evicted = registry.counter(
                "fleet/journal_inflight_evicted",
                help="in-flight descriptors evicted by the journal's "
                     "max_inflight bound",
            )

    # -- introspection (tests / recovery assertions) ---------------------
    @property
    def incarnation(self):
        return self._state["incarnation"]

    @property
    def seq(self):
        with self._lock:
            return self._state["seq"]

    def state(self):
        """A deep-ish copy of the live state (test surface)."""
        with self._lock:
            return json.loads(json.dumps(self._state))

    def latest_path(self):
        return os.path.join(self.journal_dir, LATEST_FILE)

    # -- the commit ------------------------------------------------------
    def _commit_locked(self):
        self._state["seq"] += 1
        self._state["written_unix"] = time.time()
        name = _segment_name(self._state["seq"])
        path = os.path.join(self.journal_dir, name)
        data = _encode_segment(self._state)
        # chaos site journal.torn: the torn-write failure mode — a crash
        # mid-write leaves a truncated segment on disk with ``latest``
        # already (about to be) pointing at it; recovery must classify
        # it CORRUPT and fall back to the previous valid snapshot
        spec = self._faults.fire("journal.torn")
        if spec is not None:
            frac = float(spec.args.get("keep_fraction", 0.5))
            atomic_io.torn_write_bytes(path, data, keep_fraction=frac)
        else:
            atomic_io.atomic_write_bytes(path, data, fsync=self._fsync)
        atomic_io.atomic_write_text(
            self.latest_path(), name + "\n", fsync=self._fsync
        )
        if self._c_writes is not None:
            self._c_writes.inc()
        self._prune_locked()

    def _prune_locked(self):
        for name in list_segments(self.journal_dir)[self._keep:]:
            try:
                os.unlink(os.path.join(self.journal_dir, name))
            except OSError as e:
                count_suppressed("serving.journal_prune", e)

    def _mutate(self, fn):
        with self._lock:
            fn(self._state)
            self._commit_locked()

    # -- fleet membership -----------------------------------------------
    def record_node(self, name, address):
        if isinstance(address, str):
            # same "host:port" form the nodes map / transport accept
            host, _, port = address.rpartition(":")
            address = (host or "127.0.0.1", int(port))
        host, port = address
        self._mutate(lambda st: st["nodes"].__setitem__(
            str(name), [str(host), int(port)]
        ))

    def record_replica(self, replica_id, *, node=None, address=None,
                       remote_name=None, client=None, rpc_seq=0):
        """One replica's membership + session descriptor. ``client`` and
        ``rpc_seq`` name the live socket session (the resume handle a
        restarted router presents); in-process/subprocess replicas
        journal with ``address=None`` — they die with the router and
        recovery rebuilds them cold."""
        entry = {
            "node": None if node is None else str(node),
            "address": None if address is None else
            [str(address[0]), int(address[1])],
            "remote_name": None if remote_name is None else
            str(remote_name),
            "client": None if client is None else str(client),
            "rpc_seq": int(rpc_seq),
        }
        self._mutate(lambda st: st["replicas"].__setitem__(
            str(replica_id), entry
        ))

    def forget_replica(self, replica_id):
        self._mutate(lambda st: st["replicas"].pop(str(replica_id), None))

    # -- control-plane state --------------------------------------------
    def record_adapter(self, name, kwargs):
        self._mutate(lambda st: st["adapters"].__setitem__(
            str(name), dict(kwargs)
        ))

    def forget_adapter(self, name):
        self._mutate(lambda st: st["adapters"].pop(str(name), None))

    def set_brownout(self, on):
        self._mutate(lambda st: st.__setitem__("brownout", bool(on)))

    def set_autoscaler(self, snapshot):
        self._mutate(lambda st: st.__setitem__(
            "autoscaler", None if snapshot is None else dict(snapshot)
        ))

    # -- the in-flight table --------------------------------------------
    def open_request(self, request_id, *, prompt, tenant, kwargs,
                     replica_id, rpc_id, idempotency_key=None,
                     deadline_unix=None, reroutes=0):
        """Journal one placed request BEFORE it enters the router's
        outstanding table. Bounded: past ``max_inflight`` the oldest
        descriptor evicts (counted) — an evicted request still finishes
        normally in THIS life; it just cannot be adopted across a crash.
        """
        def fn(st):
            st["request_seq"] = max(st["request_seq"], int(request_id))
            table = st["inflight"]
            while len(table) >= self.max_inflight:
                evicted = next(iter(table))
                table.pop(evicted)
                if self._c_evicted is not None:
                    self._c_evicted.inc()
                logger.warning(
                    "fleet journal: in-flight table at its "
                    "max_inflight=%d bound — evicted request %s "
                    "(still served, no longer crash-adoptable)",
                    self.max_inflight, evicted,
                )
            table[str(request_id)] = {
                "prompt": [int(t) for t in prompt],
                "tenant": str(tenant),
                "kwargs": dict(kwargs),
                "replica": str(replica_id),
                "rpc_id": rpc_id,
                "idem": None if idempotency_key is None
                else str(idempotency_key),
                "deadline_unix": None if deadline_unix is None
                else float(deadline_unix),
                "reroutes": int(reroutes),
            }
        self._mutate(fn)

    def move_request(self, request_id, *, replica_id, rpc_id, reroutes):
        """A re-route: the descriptor follows the request to its new
        placement (no-op for requests the bound already evicted)."""
        def fn(st):
            entry = st["inflight"].get(str(request_id))
            if entry is None:
                return
            entry["replica"] = str(replica_id)
            entry["rpc_id"] = rpc_id
            entry["reroutes"] = int(reroutes)
        self._mutate(fn)

    def close_request(self, request_id):
        def fn(st):
            st["inflight"].pop(str(request_id), None)
        self._mutate(fn)

    def close(self):
        """Final snapshot flush (the state is already durable — every
        mutator committed); kept for symmetry with hub/autoscaler."""


# ---------------------------------------------------------------------------
# recovery: journal snapshot -> live adopted fleet
# ---------------------------------------------------------------------------

class AdoptionPlan:
    """What :func:`plan_adoption` found: replicas armed to resume their
    journaled node sessions, the in-flight descriptors each carries,
    and the memberships that could NOT be adopted (dead node, replica
    gone from the roster) whose in-flight requests must re-place."""

    def __init__(self):
        self.replicas = []          # SocketReplica, armed via adopt_session
        self.inflight = {}          # request_id (int) -> descriptor dict
        self.lost_replicas = []     # (replica_id, reason)
        self.state = None           # the recovered journal payload

    @property
    def adopted_ids(self):
        return [r.replica_id for r in self.replicas]


def plan_adoption(state, *, registry=None, fault_injector=None,
                  socket_kwargs=None, control_timeout=10.0,
                  node_control_client=None, socket_replica=None):
    """Turn a recovered journal payload into an adoption plan.

    For every journaled socket replica: dial the node's control session,
    confirm via ``node_info`` that the node still hosts the replica,
    then build a :class:`~.transport.SocketReplica` armed (NOT yet
    started) to resume the journaled client session — rpc ids re-based
    one :data:`RPC_ID_INCARNATION_BLOCK` above the journaled
    incarnation, the journaled in-flight rpc ids pre-registered so the
    node's outbox replay (token events with absolute indices, finished
    events with full token lists) lands in real request handles the
    moment the session re-binds. Replicas whose node is unreachable or
    whose name left the roster are reported as lost — their in-flight
    requests re-place through the normal re-route budget.

    ``node_control_client`` / ``socket_replica`` are injectable for
    tests; they default to the production transport classes.
    """
    from .transport import NodeControlClient, SocketReplica

    ctl_cls = node_control_client or NodeControlClient
    rep_cls = socket_replica or SocketReplica
    plan = AdoptionPlan()
    plan.state = state
    rosters = {}   # node name -> set of replica names (None = dead node)
    addresses = {
        name: tuple(addr) for name, addr in (state.get("nodes") or {}).items()
    }
    rpc_base = (
        int(state.get("incarnation", 1)) * RPC_ID_INCARNATION_BLOCK
    )
    # group the journaled in-flight descriptors by owning replica
    by_replica = {}
    for rid_str, entry in (state.get("inflight") or {}).items():
        by_replica.setdefault(entry.get("replica"), []).append(
            (int(rid_str), entry)
        )
        plan.inflight[int(rid_str)] = entry
    for replica_id, member in sorted(
        (state.get("replicas") or {}).items()
    ):
        address = member.get("address")
        if address is None:
            plan.lost_replicas.append(
                (replica_id, "not a socket replica (dies with the router)")
            )
            continue
        node = member.get("node")
        address = (str(address[0]), int(address[1]))
        if node not in rosters:
            try:
                # the confirm dial carries the NEW incarnation's fencing
                # epoch (socket_kwargs["epoch"], transport.py): adoption
                # is exactly the moment each node's high-water mark must
                # advance, so the incarnation we just superseded is
                # fenced out of every node we re-adopt
                info = ctl_cls(
                    addresses.get(node, address),
                    connect_timeout=control_timeout,
                    op_timeout=control_timeout,
                    epoch=(socket_kwargs or {}).get("epoch"),
                ).node_info()
                rosters[node] = set(info.get("replicas") or ())
            except (OSError, RuntimeError, ValueError) as e:
                count_suppressed("serving.journal_adopt_dial", e)
                logger.warning(
                    "fleet journal: node %s unreachable during adoption "
                    "(%s) — its replicas are lost", node, e,
                )
                rosters[node] = None
        roster = rosters[node]
        remote = member.get("remote_name")
        if roster is None:
            plan.lost_replicas.append((replica_id, f"node {node} dead"))
            continue
        if remote not in roster:
            plan.lost_replicas.append(
                (replica_id, f"replica {remote!r} left node {node}'s roster")
            )
            continue
        kwargs = dict(socket_kwargs or {})
        replica = rep_cls(
            replica_id, address, remote_name=remote,
            registry=registry, fault_injector=fault_injector, **kwargs
        )
        entries = [
            {"rpc_id": entry["rpc_id"],
             "prompt": entry.get("prompt") or [],
             "max_new_tokens": int(
                 (entry.get("kwargs") or {}).get("max_new_tokens", 32)
             )}
            for _rid, entry in sorted(by_replica.get(replica_id, ()))
        ]
        replica.adopt_session(
            member.get("client"), rpc_base=rpc_base, entries=entries,
        )
        plan.replicas.append(replica)
    return plan
