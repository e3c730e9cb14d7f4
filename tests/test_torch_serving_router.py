"""Port parity for the fleet router, admission and breakers on stub
replicas: one scripted scenario, in parts, through deepspeed_tpu's
FleetRouter and deepspeed_tpu_torch's, each behind a stub subclass of
its own package's ReplicaBase (the stub of tests/unit/test_serving.py).

Each part records its outcomes (placements, answers, typed rejections
with their reason codes and texts, breaker states and windows on an
injected clock, reroute and restart counts) and ends with the router's
``fleet/*`` snapshot. The port's sequence and snapshot must equal the
JAX package's. Streams that hold wall-clock times (TTFT sums and
quantiles) are compared by their counts only.
"""

import threading
import time
import types

import pytest

import deepspeed_tpu.inference.scheduler as jsched
import deepspeed_tpu.serving as jserving
import deepspeed_tpu.serving.replica as jreplica
import deepspeed_tpu_torch.inference.scheduler as tsched
import deepspeed_tpu_torch.serving as tserving
import deepspeed_tpu_torch.serving.replica as treplica
from torch_test_env import jax_compile_cache  # noqa: F401


def _package(serving, replica, sched):
    return types.SimpleNamespace(
        serving=serving, ReplicaBase=replica.ReplicaBase,
        RequestRejected=sched.RequestRejected,
        ReplicaRPCError=replica.ReplicaRPCError,
    )


PACKAGES = {
    "jax": _package(jserving, jreplica, jsched),
    "torch": _package(tserving, treplica, tsched),
}

_IDLE_SNAP = {
    "queue_depth": 0, "queue_capacity": 8, "active_slots": 0,
    "free_slots": 2, "num_slots": 2, "health": 0,
    "mean_prefill_ms": 1.0, "mean_decode_ms": 1.0, "requests_shed": 0.0,
    "restarts_used": 0, "requests_completed": 0, "tokens_generated": 0,
    "driving": True, "stopped": False,
    "driver_failed": False, "alive": True, "failed": False,
}


class StubHandle:
    def __init__(self, prompt_tokens):
        self.prompt_tokens = list(prompt_tokens)
        self.tokens = []
        self.finish_reason = None
        self.first_token_at = None
        self._done = threading.Event()

    @property
    def done(self):
        return self._done.is_set()

    def _finish(self, tokens, reason):
        self.tokens = list(tokens)
        self.finish_reason = reason
        self.first_token_at = time.monotonic()
        self._done.set()


def _stub_class(base):
    """tests/unit/test_serving.py's StubReplica over ``base``."""

    class StubReplica(base):
        def __init__(self, replica_id, snapshot=None, autofinish=None,
                     reject_with=None, heal_on_restart=False,
                     restart_autofinish=None):
            super().__init__(replica_id)
            self.snap = dict(_IDLE_SNAP, **(snapshot or {}))
            self.autofinish = autofinish
            self.reject_with = reject_with
            self.heal_on_restart = heal_on_restart
            self.restart_autofinish = restart_autofinish
            self.handles = []
            self.submit_calls = 0
            self.submit_kwargs = []
            self.brownouts = []
            self.failed = False
            self.drained = False
            self.shutdowns = 0
            self.restarts = 0

        def start(self):
            return self

        def submit(self, prompt_tokens, **kwargs):
            self.submit_calls += 1
            self.submit_kwargs.append(dict(kwargs))
            if self.reject_with is not None:
                raise self.reject_with
            handle = StubHandle(prompt_tokens)
            self.handles.append(handle)
            if self.autofinish is not None:
                handle._finish(self.autofinish, "max_new_tokens")
            return handle

        def load_snapshot(self):
            snap = dict(self.snap)
            snap["failed"] = self.failed
            snap["alive"] = snap["alive"] and not self.failed
            return snap

        def set_brownout(self, on):
            self.brownouts.append(bool(on))

        def drain(self):
            self.drained = True

        def restart(self):
            for handle in self.handles:
                if not handle.done:
                    handle._finish([], "error")
            self.restarts += 1
            self.failed = False
            if self.heal_on_restart:
                self.snap["active_slots"] = 0
                self.snap["unresponsive"] = False
            if self.restart_autofinish is not None:
                self.autofinish = self.restart_autofinish
            return self

        def shutdown(self):
            self.shutdowns += 1
            for handle in self.handles:
                if not handle.done:
                    handle._finish([], "error")

    return StubReplica


class Run:
    """One package's run of a part: the outcomes in order and the
    routers whose ``fleet/*`` snapshots close it."""

    def __init__(self, pkg):
        self.P = pkg
        self.Stub = _stub_class(pkg.ReplicaBase)
        self.out = []
        self.routers = []

    def rec(self, *item):
        self.out.append(item)

    def router(self, replicas, **kw):
        kw.setdefault("monitor_interval", 0.001)
        router = self.P.serving.FleetRouter(replicas, **kw).start()
        self.routers.append(router)
        return router

    def expect_reject(self, tag, fn):
        """Record the rejection ``fn`` (a submit) raises, or, if it
        admits the request, its answer: the router counts a completion
        on its monitor's sweep, so every admitted request is awaited
        before the part's snapshots."""
        try:
            req = fn()
        except self.P.RequestRejected as e:
            self.rec(tag, type(e).__name__, e.reason, str(e),
                     getattr(e, "retry_after_secs", None))
        else:
            self.rec(tag, "admitted", req.result(5.0))

    def snapshots(self):
        snaps = []
        for router in self.routers:
            router.refresh_telemetry()
            snap = router.metrics.snapshot()
            snaps.append({
                k: v for k, v in sorted(snap.items())
                if k.startswith("fleet/")
                and not (("ttft" in k or "_ms" in k)
                         and not k.endswith("/count"))
            })
        return snaps


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    assert cond()


# ---------------------------------------------------------------------------
# the scenario's parts
# ---------------------------------------------------------------------------
def part_placement(r):
    S = r.P.serving
    snap = dict(_IDLE_SNAP)
    cands = [("0", dict(snap, queue_depth=3, active_slots=1)),
             ("1", dict(snap, queue_depth=0, active_slots=2)),
             ("2", dict(snap, queue_depth=1, active_slots=0))]
    r.rec("least_loaded", [S.LeastLoaded().choose(cands, [1]) for _ in "ab"])
    rr = S.RoundRobin()
    r.rec("round_robin", [rr.choose(cands[:2], []) for _ in range(4)])
    aff = S.PrefixAffinity(prefix_tokens=4)
    heavy0 = [("0", dict(snap, queue_depth=9, kv_blocks_free=8)),
              ("1", dict(snap, queue_depth=0, kv_blocks_free=8))]
    heavy1 = [("0", dict(snap, queue_depth=0, kv_blocks_free=8)),
              ("1", dict(snap, queue_depth=9, kv_blocks_free=0))]
    for cands_, prompt in ((heavy0, [7, 7, 7, 7, 1]),
                           (heavy1, [7, 7, 7, 7, 2]),
                           (heavy1, [7, 7, 7, 7, 3]),
                           (heavy1, [5, 5, 5, 5, 3])):
        r.rec("affinity", aff.choose(cands_, prompt), aff.last_hit)
    aff.forget("0")
    r.rec("affinity_forgot", aff.choose(heavy0, [7, 7, 7, 7, 4]),
          aff.last_hit)
    a = r.Stub("0", autofinish=[1], snapshot={
        "prefix_hits": 3, "prefix_misses": 1, "prefix_hit_rate": 0.75,
        "kv_blocks_free": 5, "kv_blocks_total": 8, "kv_blocks_used": 3})
    b = r.Stub("1", autofinish=[2])
    router = r.router([a, b], placement="prefix_affinity",
                      affinity_prefix_tokens=4)
    for tail in (1, 2, 3):
        req = router.submit([9, 9, 9, 9, tail], max_new_tokens=1)
        r.rec("routed", req.result(2.0), req.replica_id)
    sticky = router._replicas[req.replica_id]
    sticky.reject_with = r.P.RequestRejected("full", reason="overload")
    req = router.submit([9, 9, 9, 9, 4], max_new_tokens=1)
    r.rec("sticky_rejects", req.result(2.0), req.replica_id)


def part_admission(r):
    S = r.P.serving
    clock = [0.0]
    bucket = S.TokenBucket(rate=2.0, burst=2, clock=lambda: clock[0])
    seq = []
    for dt in (0, 0, 0, 0.5, 0, 10.0, 0, 0, 0):
        clock[0] += dt
        seq.append((bucket.try_acquire(), bucket.retry_after()))
    r.rec("bucket", seq)
    a = r.Stub("0", autofinish=[1])
    router = r.router(
        [a], rate_limit=(1.0, 1), clock=lambda: clock[0],
        per_tenant_limits={"gold": {"requests_per_sec": 100.0, "burst": 3}})
    r.expect_reject("free_first", lambda: router.submit(
        [1, 2], tenant="free", max_new_tokens=1))
    r.expect_reject("free_over", lambda: router.submit(
        [1, 2], tenant="free", max_new_tokens=1))
    for _ in range(3):
        r.expect_reject("gold_burst", lambda: router.submit(
            [1, 2], tenant="gold", max_new_tokens=1))
    r.expect_reject("gold_over", lambda: router.submit(
        [1, 2], tenant="gold", max_new_tokens=1))
    clock[0] += 1.1
    r.expect_reject("free_refilled", lambda: router.submit(
        [1, 2], tenant="free", max_new_tokens=1))
    r.rec("queued_at_replica", len(a.handles))
    full = r.Stub("0", snapshot={"queue_depth": 7, "queue_capacity": 8},
                  autofinish=[1])
    router = r.router([full], shed_queue_ratio=0.75)
    r.expect_reject("shed_priority1", lambda: router.submit(
        [1], priority=1, max_new_tokens=1))
    r.expect_reject("keep_priority0", lambda: router.submit(
        [1], priority=0, max_new_tokens=1))
    rej = r.P.RequestRejected("queue full", reason="overload")
    router = r.router([r.Stub("0", reject_with=rej),
                       r.Stub("1", reject_with=rej)])
    r.expect_reject("all_reject", lambda: router.submit(
        [1], max_new_tokens=1))


def part_drain_and_deadlines(r):
    slow = r.Stub("0", snapshot={"mean_prefill_ms": 50.0}, autofinish=[1])
    fast = r.Stub("1", snapshot={"queue_depth": 3, "mean_prefill_ms": 40.0},
                  autofinish=[2])
    router = r.router([slow, fast])
    r.expect_reject("unmeetable", lambda: router.submit(
        [1, 2], max_new_tokens=1, deadline_secs=0.01))
    req = router.submit([1, 2], max_new_tokens=1, deadline_secs=5.0)
    r.rec("meetable", req.result(2.0), req.replica_id)
    router.drain("0")
    req = router.submit([3], max_new_tokens=1)
    r.rec("drained_one", req.result(2.0), req.replica_id, slow.drained)
    router.drain_fleet()
    r.expect_reject("drained_fleet", lambda: router.submit(
        [1], max_new_tokens=1))
    r.rec("readiness", router.readiness())


def part_reroute(r):
    flaky = r.Stub("0")
    backup = r.Stub("1", snapshot={"queue_depth": 5}, autofinish=[42])
    router = r.router([flaky, backup], max_reroutes=2)
    req = router.submit([1, 2, 3], max_new_tokens=1, deadline_secs=30.0)
    r.rec("placed", req.replica_id)
    flaky.failed = True
    flaky.handles[0]._finish([], "error")
    r.rec("rerouted", req.result(5.0), req.replica_id, req.reroutes,
          req.finish_reason, req.kwargs["deadline_secs"] < 30.0)
    _wait(lambda: "0" in router.evicted_ids)
    r.rec("evicted", sorted(router.evicted_ids), flaky.shutdowns,
          len(backup.handles))
    dead_a, dead_b = r.Stub("0"), r.Stub("1", snapshot={"queue_depth": 1})
    router = r.router([dead_a, dead_b], max_reroutes=1)
    req = router.submit([1], max_new_tokens=1)
    r.rec("first_home", req.replica_id)
    for replica in (dead_a, dead_b):
        replica.failed = True
        for handle in replica.handles:
            handle._finish([], "error")
        _wait(lambda: req.done or replica is dead_b
              or len(dead_b.handles) == 1)
    _wait(lambda: req.done)
    try:
        req.result(0)
    except RuntimeError as e:
        # the message names the request's id, a per-process sequence
        r.rec("budget_spent", req.finish_reason, req.reroutes,
              str(e).split(" ", 3)[3])


def part_breakers(r):
    S = r.P.serving
    clock = [0.0]
    br = S.CircuitBreaker(failure_threshold=2, backoff_secs=1.0,
                          backoff_max_secs=8.0, clock=lambda: clock[0],
                          seed=3)
    trail = []

    def note(what):
        trail.append((what, br.state, br.routable(),
                      br.open_window_remaining))

    for step in ("failure", "success", "failure", "failure", "failure"):
        getattr(br, f"record_{step}")()
        note(step)
    clock[0] += 1.2
    trail.append(("probe", br.allow_request(), br.allow_request()))
    br.record_failure()
    note("probe_failed")
    clock[0] += 2.3
    trail.append(("probe", br.allow_request()))
    br.record_success()
    note("probe_succeeded")
    r.rec("state_machine", trail, br.consecutive_failures)
    for seed in (0, 9, 12345):
        clock[0] = 0.0
        br = S.CircuitBreaker(failure_threshold=1, backoff_secs=1.0,
                              backoff_max_secs=4.0,
                              clock=lambda: clock[0], seed=seed)
        windows = []
        for _ in range(6):
            br.record_failure()
            windows.append(br.open_window_remaining)
            clock[0] += br.open_window_remaining + 0.01
            br.allow_request()
        r.rec("jitter", seed, windows)
    r.rec("replica_seeded", [
        S.breaker.build_breaker(rid, clock=lambda: 0.0)._rng.random()
        for rid in ("0", "1", "node-a:r3")])
    flaky = r.Stub("0", reject_with=r.P.ReplicaRPCError("pipe torn"))
    healthy = r.Stub("1", autofinish=[5])
    router = r.router([flaky, healthy], clock=lambda: clock[0],
                      breaker_failure_threshold=2,
                      breaker_backoff_secs=1.0)
    clock[0] = 0.0
    for step in range(9):
        if step == 5:
            clock[0] += 1.2
        if step == 7:
            flaky.reject_with = None
            flaky.autofinish = [7]
            clock[0] += 3.0
        req = router.submit([1], max_new_tokens=1)
        r.rec("breaker_submit", step, req.result(5.0), req.replica_id,
              router.breaker_state("0"), flaky.submit_calls)
    r.rec("rejoined", flaky.restarts, flaky.shutdowns,
          sorted(router.evicted_ids))


def part_zombies(r):
    zombie = r.Stub("0", snapshot={"active_slots": 1},
                    heal_on_restart=True, restart_autofinish=[99])
    backup = r.Stub("1", snapshot={"queue_depth": 9}, autofinish=[3])
    router = r.router([zombie, backup], zombie_secs=0.05,
                      monitor_interval=0.005)
    req = router.submit([1, 2], max_new_tokens=1)
    r.rec("zombie_placed", req.replica_id)
    r.rec("zombie_answer", req.result(10.0), req.reroutes,
          zombie.restarts, zombie.drained, sorted(router.evicted_ids))
    zombie = r.Stub("0", snapshot={"active_slots": 1})  # never heals
    backup = r.Stub("1", snapshot={"queue_depth": 9}, autofinish=[3])
    router = r.router([zombie, backup], zombie_secs=0.04,
                      zombie_restart_budget=1, monitor_interval=0.005)
    req = router.submit([1], max_new_tokens=1)
    r.rec("survivor", req.result(10.0))
    _wait(lambda: router.evicted_ids == {"0"})
    r.rec("zombie_evicted", zombie.restarts, sorted(router.evicted_ids))


def part_brownout(r):
    full = r.Stub("0", snapshot={"queue_depth": 4}, autofinish=[1])
    router = r.router([full], shed_queue_ratio=0.75,
                      brownout_queue_ratio=0.5, brownout_max_new_tokens=4)

    def submit(tag, priority, new):
        try:
            req = router.submit([1], priority=priority, max_new_tokens=new)
            r.rec(tag, req.result(5.0), full.submit_kwargs[-1][
                "max_new_tokens"], router.brownout, full.brownouts[-1:])
        except r.P.RequestRejected as e:
            r.rec(tag, type(e).__name__, e.reason)

    submit("band_p1", 1, 32)
    submit("band_p0", 0, 32)
    submit("band_small", 1, 2)
    full.snap["queue_depth"] = 7
    submit("shed_p1", 1, 32)
    submit("shed_p0", 0, 32)
    r.rec("readiness_browned", router.readiness())
    full.snap["queue_depth"] = 0
    router.refresh_telemetry()
    submit("cleared_p1", 1, 32)
    off = r.Stub("0", snapshot={"queue_depth": 4}, autofinish=[1])
    router = r.router([off], shed_queue_ratio=0.75)
    req = router.submit([1], priority=1, max_new_tokens=32)
    r.rec("unarmed", req.result(5.0), off.submit_kwargs[-1][
        "max_new_tokens"], router.brownout)


PARTS = {f.__name__[5:]: f for f in (
    part_placement, part_admission, part_drain_and_deadlines, part_reroute,
    part_breakers, part_zombies, part_brownout)}


def _run(pkg, part):
    r = Run(pkg)
    try:
        PARTS[part](r)
        return r.out, r.snapshots()
    finally:
        for router in r.routers:
            router.shutdown()


@pytest.mark.parametrize("part", sorted(PARTS))
def test_router_scenario_matches_jax(part):
    want = _run(PACKAGES["jax"], part)
    got = _run(PACKAGES["torch"], part)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert want[0]  # the part recorded outcomes


def test_serving_metrics_catalog_equals_jax():
    from deepspeed_tpu.telemetry.manager import SERVING_METRICS as J
    from deepspeed_tpu_torch.telemetry.manager import SERVING_METRICS as T

    assert T == J
