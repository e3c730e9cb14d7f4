"""Port parity for the fleet hub (telemetry/hub.py) and its time-series
store (telemetry/timeseries.py) against the JAX package's.

- ``TimeSeriesStore``: the same records give the same retention, windows,
  rates, stats and sparklines.
- ``TelemetryHub`` scrapes two stub node agents (in threads, over
  loopback sockets) on an injected clock: the retained series keys, the
  ``statz`` body and the Prometheus text's sample names and labels equal
  the JAX package's (the process-wide suppressed-error counts, which
  other tests move, are left out of the comparison).
- The burn-rate, breaker-flood and suppressed-growth alerts fire and
  resolve at the same ticks over one scripted counter trace.
- The HTTP door's hub routes answer 200 when ``serving.hub`` arms the
  hub through ``init_fleet`` and 404 when it is off, in both packages.
"""

import http.client
import json
import re

import pytest

from torch_fleet import package, socket_replica, stub_node
from torch_test_env import jax_compile_cache  # noqa: F401


def _both():
    return package("jax"), package("torch")


def _store_ops(P):
    store = P.timeseries.TimeSeriesStore(retention_points=4,
                                         clock=lambda: 0.0)
    out = []
    for i in range(10):
        store.record("c", float(i), now=float(i))
    out.append(store.window("c", window_secs=100.0, now=9.0))
    out.append((store.latest("c"), store.latest("unknown"), len(store)))
    wide = P.timeseries.TimeSeriesStore(retention_points=64)
    for i in range(6):
        wide.record("reqs", 10.0 * i, now=100.0 + i)
    wide.record_many({"a": 1.0, "b": 2.0}, now=106.0)
    wide.record("reset", 100.0, now=1.0)
    wide.record("reset", 3.0, now=2.0)
    for w in (100.0, 2.0, 0.5):
        out.append((wide.window_delta("reqs", w, now=105.0),
                    wide.window_rate("reqs", w, now=105.0),
                    wide.window_stats("reqs", w, now=105.0)))
    out.append((wide.window_rate("empty", 10.0, now=105.0),
                wide.sparkline("reqs", points=3),
                wide.window_delta("reset", 10.0, now=2.0),
                wide.names(),
                len(wide)))
    return out


def test_timeseries_store_equals_the_jax_package():
    J, T = _both()
    got = _store_ops(T)
    assert got == _store_ops(J)
    assert got[0] == [(6.0, 6.0), (7.0, 7.0), (8.0, 8.0), (9.0, 9.0)]


def test_timeseries_degenerate_retention_refused_alike():
    out = []
    for P in _both():
        try:
            P.timeseries.TimeSeriesStore(retention_points=1)
        except ValueError as e:
            out.append(str(e))
    assert len(out) == 2 and out[0] == out[1]


class _Router:
    """The slice of FleetRouter the hub touches."""

    def __init__(self, P):
        self.metrics = P.registry.MetricsRegistry()
        self.tracer = P.tracing.NOOP_TRACER
        self.hub = None


def _hub(P, router, clock, **kw):
    kw.setdefault("interval_secs", 1.0)
    kw.setdefault("slo_target", 0.99)
    kw.setdefault("alert_fast_window_secs", 10.0)
    kw.setdefault("alert_slow_window_secs", 30.0)
    hub = P.hub.TelemetryHub(clock=clock, **kw)
    hub.attach(router)
    router.hub = hub
    return hub


def _samples(text):
    """A Prometheus text's sample names with their label sets, and its
    HELP/TYPE lines; the process-wide diagnostics left out."""
    out = []
    for line in text.splitlines():
        if "internal_" in line or "suppressed" in line:
            continue
        if line.startswith("#"):
            out.append(line)
        elif line:
            out.append(re.sub(r" \S+$", "", line))
    return out


def _scrape_two_nodes(P):
    t = {"now": 1000.0}
    nodes = [stub_node(P, ("r0",), node_id="n0", delay=0.0),
             stub_node(P, ("r0", "r1"), node_id="n1", delay=0.0)]
    for node in nodes:
        node.start()
    router = _Router(P)
    addrs = {n.node_id: "{}:{}".format(*n.address) for n in nodes}
    hub = _hub(P, router, lambda: t["now"], nodes=addrs)
    out = []
    try:
        for node, name, prompts in ((nodes[0], "r0", 2), (nodes[1], "r1", 3)):
            rep = socket_replica(P, node, name)
            rep.start()
            for i in range(prompts):
                rep.submit([i], max_new_tokens=2).result(10.0)
            rep.shutdown()
        routed = router.metrics.counter("fleet/requests_routed")
        for _ in range(4):
            routed.inc(5)
            out.append(hub.scrape_once())
            t["now"] += 1.0
        out.append([k for k in hub.store.names()
                    if not k.startswith("internal/")])
        statz = hub.statz()
        statz.pop("suppressed_errors")
        statz["fleet"] = {k: v for k, v in statz["fleet"].items()
                          if not k.startswith("internal/")}
        out.append(json.loads(json.dumps(statz)))
        out.append(_samples(hub.prometheus_text()))
        out.append((hub.observed_rate("fleet/requests_routed", 10.0),
                    hub.error_budget_remaining(10.0)))
    finally:
        for node in nodes:
            node.shutdown()
    return out


def test_hub_scrapes_two_nodes_alike():
    J, T = _both()
    got = _scrape_two_nodes(T)
    ref = _scrape_two_nodes(J)
    assert got[:4] == ref[:4] == [2, 2, 2, 2]
    assert got[4] == ref[4]
    assert got[5] == ref[5]
    assert got[6] == ref[6]
    assert got[7] == ref[7]
    keys = got[4]
    assert "infer/requests_completed{node=n1,replica=r1}" in keys
    assert "infer/requests_completed{node=n0,replica=r0}" in keys
    assert sorted(got[5]["replicas"]) == ["n0/r0", "n1/r0", "n1/r1"]
    assert got[5]["nodes_up"] == 2
    assert 'infer_requests_completed{node="n1",replica="r1"}' in got[6]


def _alert_trace(P, monkeypatch):
    t = {"now": 0.0}
    diag = P.registry.MetricsRegistry()
    suppressed = diag.counter("internal/suppressed_errors")
    monkeypatch.setattr(P.hub, "diagnostics_registry", lambda: diag)
    router = _Router(P)
    hub = _hub(P, router, lambda: t["now"], alert_breaker_flood=3,
               alert_suppressed_growth=10)
    reg = router.metrics
    samples = reg.counter("fleet/slo_samples")
    violations = reg.counter("fleet/slo_violations")
    opens = reg.counter("fleet/breaker_opens")
    record = []
    for tick in range(90):
        samples.inc(4)
        if 10 <= tick < 25:
            violations.inc(2)        # burning: half the samples violate
        if 30 <= tick < 34 or 60 <= tick < 63:
            opens.inc(2)             # two breaker floods
        if 45 <= tick < 50:
            suppressed.inc(5)        # suppressed errors growing
        hub.scrape_once()
        record.append((tick, sorted(hub._active_alerts),
                       {k: v for k, v in sorted(reg.snapshot().items())
                        if k.startswith("fleet/alerts_")},
                       hub.error_budget_remaining(10.0),
                       hub.observed_rate("fleet/slo_samples", 10.0)))
        t["now"] += 1.0
    return record


def test_alerts_fire_at_the_same_ticks(monkeypatch):
    J, T = _both()
    ref = _alert_trace(J, monkeypatch)
    got = _alert_trace(T, monkeypatch)
    assert got == ref
    fired = {}
    for tick, active, _c, _b, _r in got:
        for rule in active:
            fired.setdefault(rule, tick)
    assert set(fired) == {"slo_burn", "breaker_flood", "suppressed_growth"}
    final = got[-1][2]
    assert final["fleet/alerts_breaker_flood"] == 2
    assert final["fleet/alerts_slo_burn"] == 1
    assert final["fleet/alerts_suppressed_growth"] == 1


def _get(host, port, path, method="GET"):
    conn = http.client.HTTPConnection(host, port, timeout=30.0)
    try:
        conn.request(method, path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _door_routes(P, armed):
    node = stub_node(P, ("r0",), node_id="dn", delay=0.0)
    node.start()
    host, port = node.address
    serving = {"backend": "socket"}
    if armed:
        serving["hub"] = {"enabled": True, "interval_secs": 0.05}
    router = P.serving.init_fleet(
        nodes={"dn": {"address": f"{host}:{port}", "replicas": ["r0"]}},
        config={"train_batch_size": 1, "serving": serving})
    door = P.http.HTTPDoor(router)
    dhost, dport = door.start()
    out = []
    try:
        out.append(router.submit([4], max_new_tokens=2).result(10.0))
        if armed:
            router.hub.scrape_once()
        for path in sorted(P.hub.HUB_HTTP_PATHS):
            if path.endswith("/stream"):
                continue
            status, ctype, body = _get(dhost, dport, path)
            text = body.decode(errors="replace")
            out.append((path, status, (ctype or "").split(";")[0],
                        'node="dn",replica="r0"' in text
                        or "dn/r0" in text))
        out.append(("POST /metrics", _get(dhost, dport, "/metrics",
                                          "POST")[0]))
    finally:
        door.shutdown()
        router.shutdown()
        node.shutdown()
    return out


@pytest.mark.parametrize("armed", [True, False], ids=["armed", "off"])
def test_door_hub_routes_alike(armed):
    J, T = _both()
    got = _door_routes(T, armed)
    assert got == _door_routes(J, armed)
    statuses = {row[0]: row[1] for row in got[1:]}
    if armed:
        assert statuses["/metrics"] == statuses["/statz"] == 200
        assert statuses["/dashboard"] == 200
        assert statuses["POST /metrics"] == 405
        assert ("/metrics", 200, "text/plain", True) in got
        assert ("/statz", 200, "application/json", True) in got
    else:
        assert all(s == 404 for p, s in statuses.items()
                   if not p.startswith("POST")), statuses
