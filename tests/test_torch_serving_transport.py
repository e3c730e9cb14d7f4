"""Port parity for the socket transport (serving/transport.py) against
the JAX package's.

The codec: ``encode_frame`` gives the same bytes for one message set,
``decode_frame`` refuses over-long, bad-length and bad-JSON frames with
the same ``FrameError`` texts, and ``corrupt_frame`` and
``read_frame_line`` give equal results.

The session: each package's own ``SocketReplica`` talks to its own
``NodeServer`` (stub engines, in a thread, over a loopback socket)
through one scripted scenario — hello and welcome with a streamed submit
and a snapshot, ``conn.reset`` once with a reconnect that resumes,
``frame.corrupt`` once, a session reaped past ``resume_grace_secs`` and a
protocol-version mismatch. Every frame the replica receives is recorded
(wall-clock fields left out), and the records and outcomes must be equal.
"""

import io

import pytest

from torch_fleet import (
    error_of,
    expected_answer,
    package,
    socket_replica,
    stub_node,
    wait,
)
from torch_test_env import jax_compile_cache  # noqa: F401

MESSAGES = [
    {"op": "submit", "id": 3, "prompt": [1, 2], "max_new_tokens": 4,
     "kwargs": {"tenant": "t", "priority": 1}},
    {"op": "hello", "client": "tok-1", "replica": "r0", "proto": 1,
     "epoch": 2},
    {"event": "token", "id": 7, "i": 0, "t": 42},
    {"event": "finished", "id": 7, "tokens": [1, 2, 3],
     "reason": "max_new_tokens"},
    {"event": "welcome", "node": "n0", "proto": 1, "inflight": [4, 5]},
    {"op": "snapshot", "id": 1, "text": "ünïcode ✓"},
    {},
]

BAD_LINES = [
    b"",
    b"\r\n",
    b'12 {"a": 1}',
    b"notjson at all",
    b"999999999999 {}",
    b"7 [1,2,3]",
    b"2x {}",
    b'{"a": 1',
    b"\xff\xfe",
    b"3 \xff\xfe\xfd",
]


def _both():
    return package("jax"), package("torch")


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_encode_frame_bytes_and_decode_equal(i):
    J, T = _both()
    msg = MESSAGES[i]
    data = T.transport.encode_frame(msg)
    assert data == J.transport.encode_frame(msg)
    assert T.transport.decode_frame(data) == J.transport.decode_frame(data)
    assert T.transport.decode_frame(data) == msg


@pytest.mark.parametrize("line", BAD_LINES, ids=repr)
def test_frame_errors_have_the_same_text(line):
    J, T = _both()
    got = error_of(lambda: T.transport.decode_frame(line))
    assert got is not None and got[0] == "FrameError"
    assert got == error_of(lambda: J.transport.decode_frame(line))


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_corrupt_frame_equal_and_undecodable(i):
    J, T = _both()
    data = T.transport.encode_frame(MESSAGES[i])
    bad = T.transport.corrupt_frame(data)
    assert bad == J.transport.corrupt_frame(data)
    assert bad.endswith(b"\n") and bad.count(b"\n") == 1
    assert error_of(lambda: T.transport.decode_frame(bad)) == error_of(
        lambda: J.transport.decode_frame(bad))


def test_read_frame_line_equal():
    J, T = _both()
    ceiling = T.transport.FRAME_MAX_BYTES
    assert ceiling == J.transport.FRAME_MAX_BYTES
    stream = b"".join(T.transport.encode_frame(m) for m in MESSAGES)
    stream += b'{"bare": true}\n' + b"tail-without-newline"
    lines = {}
    for P in _both():
        rfile, out = io.BytesIO(stream), []
        while True:
            line = P.transport.read_frame_line(rfile)
            if not line:
                break
            out.append(line)
        lines[P.name] = out
    assert lines["torch"] == lines["jax"] and len(lines["torch"]) == 9
    # no boundary within the ceiling: the same error
    huge = b"x" * (ceiling + 100) + b"\n"
    errors = [error_of(lambda P=P: P.transport.read_frame_line(
        io.BytesIO(huge))) for P in _both()]
    assert errors[0] == errors[1] and errors[0][0] == "FrameError"


# ---------------------------------------------------------------------------
# one scripted session per package
# ---------------------------------------------------------------------------
_TIME_FIELDS = ("ts", "t0", "at", "elapsed_ms", "wall", "first_token_at")


def _record(replica, log):
    """Record every frame the replica's reader dispatches, in order."""
    inner = replica._dispatch

    def dispatch(msg):
        log.append({k: v for k, v in msg.items()
                    if k not in _TIME_FIELDS and k != "spans"})
        inner(msg)

    replica._dispatch = dispatch


def _streams(log):
    """The frames of a log in a canonical form: the token stream of each
    request in arrival order, and every other frame kind counted (the
    node's watcher and its op thread interleave them)."""
    tokens, others = {}, {}
    for msg in log:
        if msg.get("event") == "token":
            tokens.setdefault(msg["id"], []).append((msg["i"], msg["t"]))
        else:
            key = msg.get("event")
            if key == "reply":
                key = "reply:" + ",".join(sorted(
                    k for k in msg if k not in ("event", "id")))
            elif key in ("welcome", "finished"):
                key = repr(sorted((k, v) for k, v in msg.items()
                                  if k != "id"))
            others[key] = others.get(key, 0) + 1
    return tokens, sorted(others.items())


def _hello_submit_snapshot(P):
    node = stub_node(P, ("r0", "r1"), delay=0.0, token_delay=0.01)
    node.start()
    replica = socket_replica(P, node, "r0")
    log, out = [], []
    _record(replica, log)
    try:
        replica.start()
        out.append(("node_id", replica.node_id))
        snap = replica.load_snapshot()
        out.append(("snapshot", sorted(snap), snap["alive"],
                    snap["failed"], snap["num_slots"]))
        req = replica.submit([10, 20], max_new_tokens=5)
        out.append(("result", req.result(30.0), req.finish_reason,
                    req.first_token_at is not None))
        out.append(("engine", node.engines["r0"].load_snapshot()[
            "requests_completed"]))
    finally:
        replica.shutdown()
        node.shutdown()
    return out, _streams(log)


def _reset_and_resume(P):
    # sends: the post-start snapshot (1), the submit (2), the snapshot
    # that takes the injected reset while the stub still generates (3)
    faults = P.faults.FaultInjector(
        [P.faults.FaultSpec("conn.reset", after=2, times=1, seed=0)], seed=0)
    node = stub_node(P, delay=0.0, token_delay=0.1)
    node.start()
    replica = socket_replica(P, node, faults=faults)
    log, out = [], []
    _record(replica, log)
    try:
        replica.start()
        out.append(("alive", replica.load_snapshot()["alive"]))
        req = replica.submit([7], max_new_tokens=6)
        replica.load_snapshot()
        out.append(("injected", faults.injected["conn.reset"]))
        out.append(("result", req.result(30.0), req.finish_reason))
        out.append(("reconnected", replica._net_reconnects.value >= 1,
                    replica.failed, replica.alive))
        # nothing doubled: the node admitted and finished one request
        out.append(("engine", node.engines["r0"].load_snapshot()[
            "requests_completed"]))
    finally:
        replica.shutdown()
        node.shutdown()
    tokens, _ = _streams(log)
    # a resumed stream may re-send a prefix; the request keeps each index
    # once, in order
    seen = sorted(set(tokens.get(2, [])))
    return out, [t for _, t in seen]


def _corrupt_once(P):
    faults = P.faults.FaultInjector(
        [P.faults.FaultSpec("frame.corrupt", times=1, seed=0)], seed=0)
    node = stub_node(P)
    node.start()
    replica = socket_replica(P, node, faults=faults, rpc_timeout=0.3,
                             rpc_retries=2)
    out = []
    try:
        replica.start()
        snap = replica.load_snapshot()
        out.append(("snapshot", snap["alive"], snap.get("unresponsive")))
        out.append(("retried", replica.rpc_retries_used >= 1,
                    faults.injected["frame.corrupt"]))
        req = replica.submit([9], max_new_tokens=3)
        out.append(("result", req.result(30.0), req.finish_reason))
    finally:
        replica.shutdown()
        node.shutdown()
    return out


def _reaped_past_grace(P):
    node = stub_node(P, delay=30.0, resume_grace_secs=0.3, lease_secs=0.2)
    node.start()
    replica = socket_replica(P, node)
    out = []
    try:
        replica.start()
        req = replica.submit([5], max_new_tokens=2)
        out.append(("pending", req.done))
        # the client vanishes; its reconnect waits past the grace
        replica._hb_stop.set()
        replica._reconnect_backoff = 1.5
        replica._abort_connection("test: simulated client vanish")

        def reaped():
            with node._sessions_lock:
                return not node._sessions
        out.append(("reaped", wait(reaped, 10.0)))
        out.append(("slot freed", wait(
            lambda: node.engines["r0"].load_snapshot()["active_slots"] == 0,
            10.0)))
        req.result(15.0)
        out.append(("rerouteable", req.finish_reason, list(req.tokens)))
    finally:
        # the stopped heartbeat thread is not joined: no grace to wait
        replica.shutdown(grace=0.2)
        node.shutdown()
    return out


def _protocol_mismatch(P, monkeypatch):
    monkeypatch.setattr(P.node, "RPC_PROTOCOL_VERSION", 99)
    node = stub_node(P)
    node.start()
    replica = socket_replica(P, node, rid="n0:r0")
    try:
        got = error_of(replica.start)
    finally:
        replica.shutdown()
        node.shutdown()
    # the address's port differs between the two nodes
    host, port = node.address
    return got[0], got[1].replace(f"{host}:{port}", "ADDR")


SCENARIOS = {
    "hello_submit_snapshot": _hello_submit_snapshot,
    "conn_reset_resume": _reset_and_resume,
    "frame_corrupt": _corrupt_once,
    "reaped_past_grace": _reaped_past_grace,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_session_scenario_equals_the_jax_package(scenario):
    J, T = _both()
    ref = SCENARIOS[scenario](J)
    got = SCENARIOS[scenario](T)
    assert got == ref


def test_session_outcomes_are_right():
    """The scenarios' own facts, on the port: answered once, with the
    stub's answer, through a reset and a corrupt frame."""
    T = package("torch")
    out, streams = _hello_submit_snapshot(T)
    assert ("node_id", "n0") in out
    assert out[2] == ("result", expected_answer([10, 20], 5),
                      "max_new_tokens", True)
    tokens, _ = streams
    assert [t for _, t in tokens[2]] == expected_answer([10, 20], 5)
    out, resumed = _reset_and_resume(T)
    assert out[1] == ("injected", 1)
    assert out[2] == ("result", expected_answer([7], 6), "max_new_tokens")
    assert out[3] == ("reconnected", True, False, True)
    assert out[4] == ("engine", 1)
    assert resumed == expected_answer([7], 6)


def test_protocol_mismatch_raises_the_same_typed_error(monkeypatch):
    J, T = _both()
    ref = _protocol_mismatch(J, monkeypatch)
    got = _protocol_mismatch(T, monkeypatch)
    assert got == ref
    assert got[0] == "ReplicaProtocolError"
    assert "v1" in got[1] and "v99" in got[1]
