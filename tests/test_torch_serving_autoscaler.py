"""Port parity for the SLO autoscaler (serving/autoscaler.py) against the
JAX package's.

The decisions: each package's ``Autoscaler`` (its ``PhaseCostModel``,
``ErrorBudget`` and ``AutoscalerPolicy``) ticks through one scripted load
trace on an injected clock, against a scripted fleet (snapshots, routed
and completed counts, TTFT observations, a replica lost to chaos). Every
tick's decision (action, reason, victim, refused action and code), the
target, the prediction and the SLO gauges must be equal, and the trace
must reach scale-up, scale-down, re-provision and the cooldown, flap
budget and max holds (the min hold has a case of its own).

End to end: a surge scales the fleet up and idle scales it down again,
through the in-process provider (each package's own scheduler behind a
plain-Python decode hook) and through the socket provider (``init_fleet``
over a stub node agent in a thread, which spawns and retires the engine
over its control session). The outcomes must be equal and the answers
exact.
"""

import threading

import pytest

from torch_fleet import (
    expected_answer,
    host_engine,
    package,
    stub_node,
    wait,
)
from torch_test_env import jax_compile_cache  # noqa: F401


def _both():
    return package("jax"), package("torch")


def _snap(**kw):
    base = {
        "alive": True, "failed": False, "queue_depth": 0,
        "queue_capacity": 8, "active_slots": 0, "free_slots": 2,
        "num_slots": 2, "health": 0, "mean_prefill_ms": 10.0,
        "p99_prefill_ms": 20.0, "mean_decode_ms": 3.0,
        "mean_queue_wait_ms": 1.0, "requests_shed": 0.0,
        "restarts_used": 0, "requests_completed": 10,
        "tokens_generated": 320, "driving": True, "stopped": False,
        "driver_failed": False,
    }
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# the cost model and the error budget alone
# ---------------------------------------------------------------------------
SNAPSHOT_SETS = {
    "calm": [("0", _snap())],
    "saturated": [("0", _snap(queue_depth=6, active_slots=2))],
    "unfitted": [("0", _snap(mean_prefill_ms=0.0, mean_decode_ms=0.0,
                             queue_depth=4))],
    "base_latency": [("0", _snap(p99_prefill_ms=5000.0))],
    "mixed": [("0", _snap(queue_depth=2, active_slots=1)),
              ("1", _snap(mean_prefill_ms=30.0, mean_decode_ms=4.5,
                          requests_completed=3, tokens_generated=50)),
              ("2", _snap(alive=False, queue_depth=5))],
}


@pytest.mark.parametrize("case", sorted(SNAPSHOT_SETS))
def test_cost_model_predictions_equal(case):
    out = []
    for P in _both():
        model = P.autoscaler.PhaseCostModel()
        preds = []
        for rps in (0.0, 1.0, 5.0, 50.0, 500.0):
            model.observe(SNAPSHOT_SETS[case])
            preds.append(tuple(model.predict(SNAPSHOT_SETS[case], rps)))
        out.append((model.fitted, model.service_ms(), preds))
    assert out[1] == out[0]


def test_error_budget_equal():
    out = []
    for P in _both():
        budget = P.autoscaler.ErrorBudget(window_secs=10.0)
        rec = [budget.remaining(now=0.0)]
        for t in range(30):
            budget.record(float(t) * 0.7, violated=(t % 3 == 0))
            rec.append(budget.remaining(now=float(t) * 0.7))
        rec.append(budget.remaining(now=100.0))
        out.append(rec)
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# one scripted trace through the whole Autoscaler
# ---------------------------------------------------------------------------
class _Replica:
    def __init__(self, rid):
        self.replica_id = rid


class _Provider:
    def __init__(self):
        self.n = 0
        self.retired = []

    def spawn(self, existing):
        rid = f"as{self.n}"
        self.n += 1
        assert rid not in existing
        return _Replica(rid)

    def retire(self, replica):
        self.retired.append(replica.replica_id)


class _Fleet:
    """The router surface the autoscaler reads, driven by a script."""

    brownout_queue_ratio = 0.5
    hub = None

    def __init__(self, P):
        self.metrics = P.registry.MetricsRegistry()
        self.tracer = P.tracing.NOOP_TRACER
        self.replica_ids = ["0"]
        self.evicted_ids = set()
        self.load = {}

    def live_replica_ids(self):
        return [r for r in self.replica_ids if r not in self.evicted_ids]

    def _candidates(self):
        return [(rid, _snap(**self.load)) for rid in self.live_replica_ids()]

    def add_replica(self, replica, probation=True):
        self.replica_ids.append(replica.replica_id)

    def remove_replica(self, rid, wait_idle_timeout=None):
        self.replica_ids.remove(rid)
        return _Replica(rid)


def _phase(t):
    """(requests routed a second, TTFT observed ms, snapshot load)."""
    if t < 10:
        return 1, 40.0, {}
    if t < 40:                       # the surge
        return 40, 400.0, {"queue_depth": 6, "active_slots": 2}
    if t < 90:                       # idle
        return 0, None, {}
    if t < 100:                      # a second surge: a reversal
        return 40, 400.0, {"queue_depth": 6, "active_slots": 2}
    if t < 140:                      # idle again
        return 0, None, {}
    if t < 150:                      # a queue near the brownout band
        return 0, 60.0, {"queue_depth": 4, "queue_capacity": 10,
                         "mean_prefill_ms": 0.0, "mean_decode_ms": 0.0}
    return 0, None, {}


def _trace(P):
    clock = {"t": 0.0}
    fleet = _Fleet(P)
    provider = _Provider()
    scaler = P.autoscaler.Autoscaler(
        provider,
        slo=P.autoscaler.SLOTargets(ttft_p99_ms=250.0, eval_window_secs=20.0),
        min_replicas=1, max_replicas=3, cooldown_secs=8.0,
        hysteresis_secs=12.0, flap_budget=2, flap_window_secs=120.0,
        scale_up_utilization=0.85, scale_down_utilization=0.3,
        interval_secs=1.0, clock=lambda: clock["t"])
    scaler.attach(fleet)
    routed = fleet.metrics.counter("fleet/requests_routed")
    completed = fleet.metrics.counter("fleet/requests_completed")
    ttft = fleet.metrics.histogram("fleet/ttft_ms")
    record = []
    for step in range(170):
        t = float(step)
        clock["t"] = t
        rps, observed, load = _phase(t)
        routed.inc(rps)
        if observed is not None:
            completed.inc(max(rps, 1))
            ttft.observe(observed)
        fleet.load = load
        if step == 60:
            # chaos takes the newest replica: live drops under the target
            fleet.evicted_ids.add(fleet.replica_ids[-1])
        decision = scaler.tick(now=t)
        if scaler._op_thread is not None:
            scaler._op_thread.join(5.0)
        snap = fleet.metrics.snapshot()
        record.append((
            step, None if decision is None else tuple(decision),
            scaler.state.target, len(fleet.live_replica_ids()),
            tuple(scaler.model.predict(fleet._candidates(),
                                       scaler._arrival_rps)),
            {k: v for k, v in sorted(snap.items())
             if k.startswith(("fleet/slo", "fleet/autoscale"))},
        ))
    return record, provider.retired, scaler.journal_snapshot()["target"]


def test_scripted_trace_decisions_equal_the_jax_package():
    J, T = _both()
    ref = _trace(J)
    got = _trace(T)
    assert got[0] == ref[0]
    assert got[1:] == ref[1:]
    decisions = [d for _s, d, *_ in got[0] if d is not None]
    actions = {d[0] for d in decisions}
    assert {"hold", "scale_up", "scale_down", "reprovision"} <= actions
    codes = {d[4] for d in decisions if d[4] is not None}
    assert {"cooldown", "max_replicas", "flap_budget"} <= codes, codes
    assert any("brownout" in d[1] for d in decisions)
    assert got[1], "nothing was retired"


def test_flap_budget_hold_equals_the_jax_package():
    """The flap budget: a reversal past the budget is refused, and
    allowed again once the old transitions leave the window; and the
    min_replicas clamp on sustained headroom."""
    out = []
    for P in _both():
        snaps = [("0", _snap(queue_depth=6))]
        model = P.autoscaler.PhaseCostModel()
        model.observe(snaps)
        prediction = model.predict(snaps, arrival_rps=50.0)
        policy = P.autoscaler.AutoscalerPolicy(
            slo=P.autoscaler.SLOTargets(ttft_p99_ms=250.0),
            flap_budget=1, flap_window_secs=600.0, cooldown_secs=1.0)
        state = P.autoscaler.AutoscaleState(target=1)
        state.transitions = ((10.0, "up"), (20.0, "down"))
        rec = [tuple(policy.decide(
            live_replicas=1, candidates=snaps, prediction=prediction,
            state=state, now=now)) for now in (100.0, 700.0)]
        calm = [("0", _snap())]
        state = P.autoscaler.AutoscaleState(target=1)
        state.headroom_since = 0.0
        rec.append(tuple(policy.decide(
            live_replicas=1, candidates=calm,
            prediction=model.predict(calm, arrival_rps=0.0), state=state,
            now=100.0)))
        out.append(rec)
    assert out[1] == out[0]
    assert out[1][0][4] == "flap_budget" and out[1][1][0] == "scale_up"
    assert out[1][2][4] == "min_replicas"


# ---------------------------------------------------------------------------
# end to end: a surge scales up, idle scales down
# ---------------------------------------------------------------------------
def _in_process_surge(P):
    def factory():
        return host_engine(P, step_secs=0.02)

    scaler = P.autoscaler.Autoscaler(
        P.autoscaler.InProcessReplicaProvider(factory),
        slo=P.autoscaler.SLOTargets(ttft_p99_ms=150.0, eval_window_secs=5.0),
        min_replicas=1, max_replicas=2, cooldown_secs=0.2,
        hysteresis_secs=0.3, flap_budget=8, interval_secs=0.02,
        scale_up_utilization=0.5, scale_down_utilization=0.3,
        drain_timeout_secs=10.0)
    router = P.router.FleetRouter(
        [P.replica.InProcessReplica("0", factory)], monitor_interval=0.005,
        autoscaler=scaler).start()
    out = []
    try:
        prompts = [[10 + i] for i in range(8)]
        reqs = [router.submit(p, max_new_tokens=20) for p in prompts]
        out.append(("up", wait(lambda: len(router.live_replica_ids()) == 2,
                               30.0), sorted(router.live_replica_ids())))
        out.append(("answers", [r.result(60.0) for r in reqs]
                    == [expected_answer(p, 20) for p in prompts]))
        out.append(("down", wait(lambda: len(router.live_replica_ids())
                                 == 1, 60.0),
                    sorted(router.live_replica_ids())))
        out.append(("counted", wait(lambda: router.metrics.counter(
            "fleet/autoscale_downs").value >= 1, 10.0)))
        snap = router.metrics.snapshot()
        out.append(("stale", [k for k in snap
                              if k.startswith("fleet/replicaas0/")]))
        out.append(("shed", snap["fleet/requests_shed"],
                    snap["fleet/requests_browned_out"]))
        out.append(("after", router.submit([77], max_new_tokens=3)
                    .result(30.0)))
    finally:
        router.shutdown()
    return out


def _socket_surge(P):
    node = stub_node(P, delay=0.0, token_delay=0.01, max_replicas=3)
    node.start()
    host, port = node.address
    out = []
    router = P.serving.init_fleet(
        nodes={"n0": {"address": f"{host}:{port}", "replicas": ["r0"]}},
        config={"train_batch_size": 1, "serving": {
            "backend": "socket", "placement": "least_loaded",
            "autoscale": {"enabled": True, "min_replicas": 1,
                          "max_replicas": 2, "interval_secs": 0.05,
                          "cooldown_secs": 0.2, "hysteresis_secs": 0.4,
                          "scale_up_utilization": 0.02,
                          "scale_down_utilization": 0.01}}})
    try:
        stop = threading.Event()
        answers = []

        def client(i):
            k = 0
            while not stop.is_set():
                p = [100 * i + k % 50]
                answers.append(router.submit(p, max_new_tokens=4)
                               .result(30.0) == expected_answer(p, 4))
                k += 1

        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(4)]
        for c in clients:
            c.start()
        up = wait(lambda: len(router.live_replica_ids()) == 2, 30.0)
        out.append(("up", up, sorted(router.live_replica_ids())))
        out.append(("spawned on the node", sorted(node.engines)))
        stop.set()
        for c in clients:
            c.join(30.0)
        out.append(("answers", bool(answers) and all(answers)))
        out.append(("down", wait(lambda: len(router.live_replica_ids())
                                 == 1, 60.0),
                    sorted(router.live_replica_ids())))
        out.append(("retired on the node", wait(
            lambda: sorted(node.engines) == ["r0"], 10.0)))
        out.append(("counted", router.metrics.counter(
            "fleet/autoscale_ups").value >= 1, wait(
            lambda: router.metrics.counter(
                "fleet/autoscale_downs").value >= 1, 10.0)))
        out.append(("after", router.submit([7], max_new_tokens=3)
                    .result(30.0)))
    finally:
        router.shutdown()
        node.shutdown()
    return out


@pytest.mark.parametrize("provider", ["in_process", "socket"])
def test_surge_up_idle_down_equals_the_jax_package(provider):
    run = {"in_process": _in_process_surge, "socket": _socket_surge}[provider]
    J, T = _both()
    ref = run(J)
    got = run(T)
    assert got == ref
    assert got[0][1] is True
    assert ("after", expected_answer([77 if provider == "in_process" else 7],
                                     3)) in got
    if provider == "socket":
        assert got[1] == ("spawned on the node", ["as0", "r0"])
        assert ("retired on the node", True) in got
