"""Port parity for the fleet journal (serving/journal.py) against the
JAX package's.

- The same mutation sequence writes the same segments: with the journal
  module's wall clock pinned (the one time field, ``written_unix``) every
  segment and the ``latest`` pointer are equal byte for byte; on the
  real clock the payloads are equal apart from that field.
- Each package loads a journal directory the other wrote to the same
  state and recovery info, torn and stale entries included.
- ``journal.torn`` tears the same commit, and recovery falls back alike.
- ``plan_adoption`` gives equal plans over injected transport fakes.
- One ``router.crash`` recovery cycle end to end on stub nodes, and an
  adopted session's prefix replay, give equal records in both packages.
"""

import json
import os
import time
from types import SimpleNamespace

import pytest

from torch_fleet import (
    expected_answer,
    package,
    socket_replica,
    stub_node,
    wait,
)
from torch_test_env import jax_compile_cache  # noqa: F401

SOCKET_KW = dict(rpc_timeout=2.0, rpc_retries=1, rpc_backoff_secs=0.01,
                 reconnect_backoff_secs=0.02, reconnect_attempts=3)


def _both():
    return package("jax"), package("torch")


class _Clock:
    """A journal module's ``time`` with a wall clock that counts."""

    def __init__(self, real):
        self._real = real
        self.t = 1_700_000_000.0

    def time(self):
        self.t += 1.25
        return self.t

    def __getattr__(self, name):
        return getattr(self._real, name)


def _mutations(j):
    return [
        lambda: j.record_node("n0", ("127.0.0.1", 1000)),
        lambda: j.record_node("n1", "10.0.0.9:7001"),
        lambda: j.record_replica("n0:r0", node="n0",
                                 address=("127.0.0.1", 1000),
                                 remote_name="r0", client="c1", rpc_seq=3),
        lambda: j.record_adapter("fr", {"rank": 8, "alpha": 16.0}),
        lambda: j.set_brownout(True),
        lambda: j.set_autoscaler({"target": 2, "last_scale_unix": 12.5}),
        lambda: j.open_request(5, prompt=[1, 2], tenant="t",
                               kwargs={"max_new_tokens": 4},
                               replica_id="n0:r0", rpc_id=7,
                               idempotency_key="k5"),
        lambda: j.open_request(6, prompt=[3], tenant="u", kwargs={},
                               replica_id="n0:r0", rpc_id=8,
                               deadline_unix=2e9),
        lambda: j.move_request(5, replica_id="n0:r1", rpc_id=9, reroutes=1),
        lambda: j.open_request(7, prompt=[4], tenant="t", kwargs={},
                               replica_id="n0:r0", rpc_id=10),
        lambda: j.close_request(5),
        lambda: j.forget_adapter("fr"),
        lambda: j.set_autoscaler(None),
        lambda: j.forget_replica("n0:r0"),
    ]


def _write(P, path, *, pinned, keep=4, max_inflight=2, state=None):
    if pinned:
        P.journal.time = _Clock(P.journal.time)
    try:
        reg = P.registry.MetricsRegistry()
        j = P.journal.FleetJournal(str(path), fsync=False, registry=reg,
                                   keep_segments=keep,
                                   max_inflight=max_inflight, state=state)
        states = []
        for mutate in _mutations(j):
            mutate()
            states.append(j.state())
        j.close()
    finally:
        if pinned:
            P.journal.time = P.journal.time._real
    counters = {k: v for k, v in reg.snapshot().items()
                if k.startswith("fleet/journal")}
    return states, counters


def _files(path):
    return {name: (path / name).read_bytes()
            for name in sorted(os.listdir(path))}


def _no_time(payload):
    return {k: v for k, v in payload.items() if k != "written_unix"}


def test_segments_equal_byte_for_byte_on_a_pinned_clock(tmp_path):
    J, T = _both()
    ref = _write(J, tmp_path / "jax", pinned=True)
    got = _write(T, tmp_path / "torch", pinned=True)
    assert got == ref
    files = _files(tmp_path / "torch")
    assert files == _files(tmp_path / "jax")
    assert sorted(files) == ["journal-00000011.json", "journal-00000012.json",
                             "journal-00000013.json", "journal-00000014.json",
                             "latest"]
    assert ref[1]["fleet/journal_writes"] == 14
    assert ref[1]["fleet/journal_inflight_evicted"] == 1


def test_segments_equal_apart_from_time_on_the_real_clock(tmp_path):
    J, T = _both()
    ref, _ = _write(J, tmp_path / "jax", pinned=False)
    got, _ = _write(T, tmp_path / "torch", pinned=False)
    assert [_no_time(s) for s in got] == [_no_time(s) for s in ref]
    assert all(s["written_unix"] > 0 for s in got + ref)
    for name in os.listdir(tmp_path / "torch"):
        if name == "latest":
            continue
        verdicts = [P.journal.verify_segment(str(tmp_path / P.name / name))
                    for P in (J, T)]
        assert verdicts[0][0] == verdicts[1][0] == "VALID"
        assert _no_time(verdicts[0][1]) == _no_time(verdicts[1][1])


def _damage(path, how):
    names = sorted(n for n in os.listdir(path) if n.startswith("journal-"))
    newest = path / names[-1]
    if how == "torn_newest":
        newest.write_bytes(newest.read_bytes()[:40])
    elif how == "tampered_newest":
        env = json.loads(newest.read_bytes())
        env["payload"]["brownout"] = not env["payload"]["brownout"]
        newest.write_bytes(json.dumps(env).encode())
    elif how == "stale_latest":
        (path / "latest").write_text("journal-00000099.json\n")
    elif how == "all_corrupt":
        for name in names:
            (path / name).write_bytes(b"{}")
    elif how == "version_mismatch":
        env = json.loads(newest.read_bytes())
        env["format_version"] = 99
        newest.write_bytes(json.dumps(env).encode())


@pytest.mark.parametrize("how", ["intact", "torn_newest", "tampered_newest",
                                 "stale_latest", "all_corrupt",
                                 "version_mismatch"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_loads_the_others_journal_alike(tmp_path, writer, how):
    J, T = _both()
    W = package(writer)
    _write(W, tmp_path, pinned=True)
    _damage(tmp_path, how)
    loaded = []
    for P in (J, T):
        reg = P.registry.MetricsRegistry()
        state, info = P.journal.load_journal_state(str(tmp_path),
                                                   registry=reg)
        loaded.append((state, info, {
            k: v for k, v in reg.snapshot().items()
            if k.startswith("fleet/journal")}))
    assert loaded[1] == loaded[0]
    expect = "cold" if how == "all_corrupt" else "recovered"
    assert loaded[1][1]["status"] == expect


def test_missing_journal_loads_alike(tmp_path):
    J, T = _both()
    got = [P.journal.load_journal_state(str(tmp_path / "none"))
           for P in (J, T)]
    assert got[0] == got[1] == (None, {"status": "missing", "segment": None,
                                       "corrupt": []})


def _torn(P, path):
    faults = P.faults.FaultInjector(
        [P.faults.FaultSpec("journal.torn", after=1, times=1,
                            args={"keep_fraction": 0.3}, seed=0)], seed=0)
    P.journal.time = _Clock(P.journal.time)
    try:
        j = P.journal.FleetJournal(str(path), fsync=False,
                                   fault_injector=faults)
        j.set_brownout(True)
        j.set_brownout(False)
        j.record_adapter("a", {"rank": 2})
    finally:
        P.journal.time = P.journal.time._real
    torn = P.journal.verify_segment(str(path / "journal-00000002.json"))
    state, info = P.journal.load_journal_state(str(path))
    return (faults.injected["journal.torn"], torn[0], torn[2], state, info,
            _files(path))


def test_journal_torn_equals_the_jax_package(tmp_path):
    J, T = _both()
    ref = _torn(J, tmp_path / "jax")
    got = _torn(T, tmp_path / "torch")
    assert got == ref
    assert got[0] == 1 and got[1] == "CORRUPT"
    # the newest segment (commit 3) carries commit 2's change as well
    assert got[3]["adapters"] == {"a": {"rank": 2}}
    assert got[3]["brownout"] is False


# ---------------------------------------------------------------------------
# plan_adoption over injected transport fakes
# ---------------------------------------------------------------------------
def _fake_ctl(rosters, dials):
    class _Ctl:
        def __init__(self, address, **kw):
            self.address = tuple(address)
            dials.append((self.address, kw.get("epoch")))

        def node_info(self):
            roster = rosters.get(self.address)
            if roster is None:
                raise OSError("connection refused")
            if roster == "reset":
                raise ConnectionResetError("peer died mid-handshake")
            return {"replicas": list(roster)}
    return _Ctl


class _FakeReplica:
    def __init__(self, replica_id, address, *, remote_name=None,
                 registry=None, fault_injector=None, **kw):
        self.replica_id = replica_id
        self.address = tuple(address)
        self.remote_name = remote_name
        self.kw = kw
        self.adopt = None

    def adopt_session(self, client, *, rpc_base, entries=()):
        self.adopt = {"client": client, "rpc_base": rpc_base,
                      "entries": list(entries)}
        return self


def _membership(node="n0", port=7000, remote="r0", client="tok-1"):
    return {"node": node, "address": ["127.0.0.1", port],
            "remote_name": remote, "client": client, "rpc_seq": 5}


def _entry(replica, rpc_id, prompt, **kw):
    return {"prompt": prompt, "kwargs": kw, "tenant": "t",
            "replica": replica, "rpc_id": rpc_id, "idem": None,
            "deadline_unix": None, "reroutes": 0}


ADOPTION_STATES = {
    "survivors": dict(
        nodes={"n0": ["127.0.0.1", 7000]},
        replicas={"n0:r0": _membership(), "n0:r1": _membership(remote="r1")},
        inflight={"10": _entry("n0:r0", 4, [3], max_new_tokens=6),
                  "11": _entry("n0:r0", 5, [5])}),
    "dead_node": dict(replicas={"n0:r0": _membership()}),
    "left_roster": dict(replicas={"n0:r0": _membership(),
                                  "n0:r9": _membership(remote="r9")}),
    "not_socket": dict(replicas={"local": {"node": None, "address": None}}),
    "journaled_address": dict(
        nodes={"n0": ["127.0.0.1", 7000]},
        replicas={"n0:r0": _membership(port=6999)}),
    "reset_mid_plan": dict(
        nodes={"n0": ["127.0.0.1", 7000], "n1": ["127.0.0.1", 7001]},
        replicas={"n0:r0": _membership(), "n0:r1": _membership(remote="r1"),
                  "n1:r0": _membership(node="n1", port=7001)},
        inflight={"7": _entry("n1:r0", 3, [5], max_new_tokens=4)}),
}
ROSTERS = {("127.0.0.1", 7000): ["r0", "r1"],
           ("127.0.0.1", 7001): "reset"}


def _plan(P, case):
    state = {"format_version": 1, "seq": 4, "incarnation": 2,
             "written_unix": 0.0, "nodes": {}, "replicas": {},
             "adapters": {}, "brownout": False, "autoscaler": None,
             "request_seq": -1, "inflight": {}}
    state.update(ADOPTION_STATES[case])
    rosters = {} if case == "dead_node" else ROSTERS
    dials = []
    plan = P.journal.plan_adoption(
        state, socket_kwargs={"rpc_timeout": 9.0, "epoch": 3},
        node_control_client=_fake_ctl(rosters, dials),
        socket_replica=_FakeReplica)
    return (plan.adopted_ids, plan.lost_replicas, plan.inflight,
            [(r.replica_id, r.address, r.remote_name, r.kw, r.adopt)
             for r in plan.replicas], sorted(dials), plan.state is state)


@pytest.mark.parametrize("case", sorted(ADOPTION_STATES))
def test_plan_adoption_equals_the_jax_package(case):
    J, T = _both()
    got = _plan(T, case)
    assert got == _plan(J, case)
    if case == "survivors":
        rpc_base = 2 * T.journal.RPC_ID_INCARNATION_BLOCK
        assert got[0] == ["n0:r0", "n0:r1"]
        assert got[3][0][4] == {"client": "tok-1", "rpc_base": rpc_base,
                                "entries": [
                                    {"rpc_id": 4, "prompt": [3],
                                     "max_new_tokens": 6},
                                    {"rpc_id": 5, "prompt": [5],
                                     "max_new_tokens": 32}]}
    if case == "reset_mid_plan":
        assert got[1] == [("n1:r0", "node n1 dead")]


# ---------------------------------------------------------------------------
# a router crash and its recovery, on stub nodes in threads
# ---------------------------------------------------------------------------
def _crash_replica(replica):
    """Sever a socket replica as a killed router would: no bye frame, no
    reconnect; the node's session survives into its resume grace."""
    replica._shutdown_requested = True
    replica._hb_stop.set()
    replica._abort_connection("simulated router crash")
    for t in (replica._heartbeat, replica._reader):
        if t is not None:
            t.join(5.0)


def _node_scalars(P, node, name="r0"):
    snap = P.transport.NodeControlClient(node.address).metrics_snapshot()
    return P.registry.wire_scalars(snap["replicas"][name])


# A stub token every TOKEN_DELAY s: the crash comes right after the first
# token is seen, so 20 or 30 tokens leave 1.9 s or more before the last.
TOKEN_DELAY = 0.1


def _wait_mid_stream(node, timeout=20.0):
    """Block until one of the node's tracked requests has streamed a token
    and is not finished: the state both packages' runs crash in."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with node._sessions_lock:
            sessions = list(node._sessions.values())
        for session in sessions:
            for req, _, _ in list(session.tracked.values()):
                if req.tokens and not req.done:
                    return
        time.sleep(0.002)
    raise AssertionError("no request streamed a token in time")


def _recovery_cycle(P, path):
    node = stub_node(P, token_delay=TOKEN_DELAY, node_id="nA",
                     resume_grace_secs=10.0)
    node.start()
    router2 = None
    out = []
    try:
        j1 = P.journal.FleetJournal(str(path), fsync=False)
        j1.record_node("nA", node.address)
        rep1 = socket_replica(P, node, rid="nA:r0")
        router1 = P.router.FleetRouter([rep1], monitor_interval=0.02,
                                       journal=j1)
        router1.start()
        req = router1.submit([5], max_new_tokens=20,
                             idempotency_key="cycle-key")

        def relative(ids):
            # request ids come from a process-wide counter, which the
            # other tests of a worker advance unequally in the two
            # packages: each id as its distance from this request's
            return sorted(int(i) - req.request_id for i in ids)

        inflight = j1.state()["inflight"]
        out.append(("journaled", relative(inflight),
                    sorted(inflight[str(req.request_id)])))
        _wait_mid_stream(node)
        # the crash: the monitor stops cold and the socket is severed
        router1._stop.set()
        router1._monitor.join(5.0)
        _crash_replica(rep1)

        state, info = P.journal.load_journal_state(str(path))
        out.append(("loaded", info["status"], state["incarnation"],
                    sorted(state["replicas"]), relative(state["inflight"])))
        epoch = int(state["incarnation"]) + 1
        plan = P.journal.plan_adoption(
            state, socket_kwargs=dict(SOCKET_KW, epoch=epoch))
        out.append(("plan", plan.adopted_ids, plan.lost_replicas))
        j2 = P.journal.FleetJournal(str(path), fsync=False, state=state)
        out.append(("incarnation", j2.incarnation, epoch))
        router2 = P.router.FleetRouter(plan.replicas, monitor_interval=0.02,
                                       journal=j2, recovered=plan)
        ready, reasons = router2.readiness()
        out.append(("recovering", router2.recovering, ready,
                    "recovering" in reasons))
        router2.start()
        out.append(("started", router2.recovering,
                    router2.metrics.gauge("fleet/adopted_replicas").value))
        adopted = router2.find_inflight("cycle-key")
        out.append(("adopted", adopted.request_id == req.request_id,
                    adopted.result(30.0), adopted.finish_reason))
        out.append(("journal clean", j2.state()["inflight"]))
        # the old router's late op is fenced out by the new epoch
        try:
            P.transport.NodeControlClient(node.address,
                                          epoch=epoch - 1).node_info()
            out.append(("late op", None))
        except P.replica.FencedOut as e:
            out.append(("late op", "FencedOut", e.epoch, e.high_water))
        new = router2.submit([8], max_new_tokens=3)
        out.append(("new request", new.result(30.0),
                    new.request_id > req.request_id))
        scalars = _node_scalars(P, node)
        out.append(("node ran", scalars["infer/requests_submitted"],
                    scalars["infer/requests_completed"]))
    finally:
        if router2 is not None:
            router2.shutdown()
        node.shutdown()
    return out


def test_router_crash_recovery_cycle_equals_the_jax_package(tmp_path):
    J, T = _both()
    ref = _recovery_cycle(J, tmp_path / "jax")
    got = _recovery_cycle(T, tmp_path / "torch")
    assert got == ref
    assert ("adopted", True, expected_answer([5], 20),
            "max_new_tokens") in got
    assert ("plan", ["nA:r0"], []) in got
    assert ("incarnation", 2, 2) in got
    assert ("late op", "FencedOut", 1, 2) in got
    assert ("node ran", 2, 2) in got


def _prefix_replay(P):
    node = stub_node(P, token_delay=0.03)
    node.start()
    rep1 = socket_replica(P, node)
    rep2 = None
    out = []
    try:
        rep1.start()
        req1 = rep1.submit([7], max_new_tokens=12)
        assert wait(lambda: len(req1.tokens) >= 3, 10.0)
        client = rep1.client_token
        _crash_replica(rep1)
        rep2 = socket_replica(P, node)
        rep2.adopt_session(
            client, rpc_base=2 * P.journal.RPC_ID_INCARNATION_BLOCK,
            entries=[{"rpc_id": req1.rpc_id, "prompt": [7],
                      "max_new_tokens": 12}])
        rep2.start()
        handle = rep2.adopted_handles()[req1.rpc_id]
        out.append((handle.result(20.0), handle.finish_reason))
        scalars = _node_scalars(P, node)
        out.append((scalars["infer/requests_submitted"],
                    scalars["infer/requests_completed"]))
        # a new submit after adoption mints ids above the block
        new = rep2.submit([1], max_new_tokens=2)
        out.append((new.result(10.0),
                    new.rpc_id > 2 * P.journal.RPC_ID_INCARNATION_BLOCK))
    finally:
        if rep2 is not None:
            rep2.shutdown()
        node.shutdown()
    return out


def test_adopted_session_replays_prefix_equals_the_jax_package():
    J, T = _both()
    got = _prefix_replay(T)
    assert got == _prefix_replay(J)
    assert got[0] == (expected_answer([7], 12), "max_new_tokens")
    assert got[1] == (1, 1)


def test_init_fleet_recovers_the_journal_alike(tmp_path):
    """``init_fleet`` over a journal another life left: epoch + 1 rides
    the hellos, the live session is adopted, and ``recovered=`` reaches
    the router, in both packages."""
    out = {}
    for P in _both():
        node = stub_node(P, token_delay=TOKEN_DELAY, node_id="nB")
        node.start()
        path = tmp_path / P.name
        host, port = node.address
        nodes = {"nB": {"address": f"{host}:{port}", "replicas": ["r0"]}}
        cfg = {"train_batch_size": 1, "serving": {
            "backend": "socket", "journal": {"enabled": True,
                                             "dir": str(path),
                                             "fsync": False}}}
        rec = []
        try:
            r1 = P.serving.init_fleet(nodes=nodes, config=cfg)
            rec.append(r1.submit([4], max_new_tokens=3).result(30.0))
            req = r1.submit([6], max_new_tokens=30,
                            idempotency_key="k")
            _wait_mid_stream(node)
            r1._stop.set()
            r1._monitor.join(5.0)
            for rep in r1._replicas.values():
                _crash_replica(rep)
            r2 = P.serving.init_fleet(nodes=nodes, config=cfg)
            try:
                rec.append(("epoch", r2._journal.incarnation,
                            sorted(r2._replicas)))
                adopted = r2.find_inflight("k")
                rec.append(adopted.result(30.0))
                rec.append(_node_scalars(P, node)[
                    "infer/requests_submitted"])
            finally:
                r2.shutdown()
        finally:
            node.shutdown()
        out[P.name] = rec
    assert out["torch"] == out["jax"]
    assert out["torch"] == [expected_answer([4], 3), ("epoch", 2, ["nB:r0"]),
                            expected_answer([6], 30), 2]


def test_disabled_journal_builds_nothing(tmp_path, monkeypatch):
    T = package("torch")
    monkeypatch.chdir(tmp_path)
    router = T.serving.init_fleet(
        engine_factory=lambda: SimpleNamespace(),
        config={"serving": {"journal": {"dir": "jrnl"}}}, start=False)
    assert router._journal is None and not (tmp_path / "jrnl").exists()
