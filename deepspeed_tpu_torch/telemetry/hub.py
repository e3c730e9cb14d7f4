"""TelemetryHub: the fleet-wide observability plane on the router host.

Port of deepspeed_tpu/telemetry/hub.py. The serving tier is a networked
fleet, and telemetry without the hub stays process-local — every node
agent exports to its own disk and flight dumps strand on the node host. The hub closes that gap with the
Borgmon/Prometheus pull model (PAPERS.md) over the control-plane
machinery that already exists:

- **scrape**: on the router monitor's cadence, pull every node agent's
  per-replica registry over the ``metrics_snapshot`` control op
  (transport.NodeControlClient), label the samples ``{node, replica}``,
  and merge them with the router's own registry into one fleet view —
  what ``GET /metrics`` on the HTTP door serves (serving/http.py).
- **retain**: append every scalar to a fixed-size in-memory time-series
  ring (timeseries.TimeSeriesStore), backing the sliding-window
  rate/burn queries behind ``GET /statz``, the dashboard sparklines,
  the alert evaluator, and the autoscaler's observed-arrival-rate read.
- **collect traces**: pull sampled span batches (and, on demand, the
  flight-recorder ring) home over the ``drain_telemetry`` control op
  and ingest them into the router's tracer — one Perfetto file and one
  flight-dump directory cover the whole fleet (the Dapper-lineage
  cross-host story, PAPERS.md).
- **alert**: evaluate SLO burn-rate fast/slow windows, breaker-open
  floods, and suppressed-error growth over the ring; a rule's rising
  edge bumps a ``fleet/alerts_*`` counter and drops a flight-recorder
  instant event, so the autoscaler and a human tailing the dashboard
  see the same signal.

Zero-overhead when disabled: ``init_fleet`` builds no hub unless the
``serving.hub`` block is enabled — no threads, no per-tick work, and
the door's observability routes 404.

Scrapes run on a short-lived, one-in-flight background thread
(``ds-hub-scrape``): a dead node costs its connect timeout on that
thread, never on the router monitor's sweeps. ``scrape_once()`` /
``drain_once()`` are the synchronous forms tests and the bench drive.
"""

import json
import threading
import time

from ..utils.logging import logger
from .exporters import render_prometheus
from .registry import (
    count_suppressed,
    diagnostics_registry,
    suppressed_errors_snapshot,
    wire_scalars,
    wire_snapshot,
)
from .timeseries import TimeSeriesStore

# paths the door routes to the hub (serving/http.py imports these so the
# route list and the config validator never drift)
HUB_HTTP_PATHS = ("/metrics", "/statz", "/statz/stream", "/dashboard")

# alert rule names (-> fleet/alerts_{rule} counters)
ALERT_SLO_BURN = "slo_burn"
ALERT_BREAKER_FLOOD = "breaker_flood"
ALERT_SUPPRESSED_GROWTH = "suppressed_growth"


def _series_key(name, node, replica):
    """Ring key for a remote series: ``infer/ttft_ms{node=n0,replica=r0}``
    (display form, not Prometheus syntax — the ring is name-keyed, not
    label-aware)."""
    return f"{name}{{node={node},replica={replica}}}"


class TelemetryHub:
    """Construct via :func:`deepspeed_tpu_torch.serving.init_fleet` (the
    ``serving.hub`` config block) or directly for programmatic fleets;
    the router calls :meth:`attach` when it takes ownership and
    :meth:`tick` from its monitor thread.

    ``nodes`` maps node name -> ``"host:port"`` control address (the
    same addresses the socket backend dials); an empty map is a valid
    single-host hub — the router's own registry is still retained,
    windowed, alerted on, and served."""

    def __init__(self, *, nodes=None, interval_secs=2.0,
                 retention_points=512, drain_interval_secs=10.0,
                 op_timeout_secs=5.0, node_backoff_secs=10.0,
                 auth_exempt=(), slo_target=0.99,
                 alert_fast_window_secs=60.0, alert_slow_window_secs=600.0,
                 alert_fast_burn=14.4, alert_slow_burn=6.0,
                 alert_breaker_flood=3, alert_suppressed_growth=10,
                 clock=time.time):
        self.nodes = {
            str(name): addr for name, addr in (nodes or {}).items()
        }
        self.interval_secs = float(interval_secs)
        self.drain_interval_secs = float(drain_interval_secs)
        self.op_timeout_secs = float(op_timeout_secs)
        self.node_backoff_secs = float(node_backoff_secs)
        self.auth_exempt = tuple(str(p) for p in auth_exempt)
        self.slo_target = float(slo_target)
        self.alert_fast_window_secs = float(alert_fast_window_secs)
        self.alert_slow_window_secs = float(alert_slow_window_secs)
        self.alert_fast_burn = float(alert_fast_burn)
        self.alert_slow_burn = float(alert_slow_burn)
        self.alert_breaker_flood = float(alert_breaker_flood)
        self.alert_suppressed_growth = float(alert_suppressed_growth)
        self._clock = clock
        self.store = TimeSeriesStore(retention_points, clock=clock)
        self._router = None
        self._lock = threading.Lock()
        # (node, replica) -> (scrape ts, [wire entries]): the latest
        # remote view, what /metrics renders with {node, replica} labels
        self._remote = {}
        self._node_failed_at = {}
        self._nodes_up = 0
        self._active_alerts = set()
        self._thread = None
        self._last_tick = None
        self._last_drain = None
        self._closed = False

    # -- wiring ----------------------------------------------------------
    def attach(self, router):
        """Adopt ``router``: register the hub's own health counters on
        its registry (the hub observes itself through the same pipe it
        serves)."""
        self._router = router
        reg = router.metrics
        self._c_scrapes = reg.counter(
            "fleet/hub_scrapes", help="successful node metric scrapes",
        )
        self._c_scrape_failures = reg.counter(
            "fleet/hub_scrape_failures",
            help="node scrape/drain round-trips that failed",
        )
        self._c_drains = reg.counter(
            "fleet/hub_drains", help="drain_telemetry sweeps completed",
        )
        self._c_spans = reg.counter(
            "fleet/hub_spans_ingested",
            help="remote spans folded into the router trace",
        )
        self._g_nodes_up = reg.gauge(
            "fleet/hub_nodes_up",
            help="nodes that answered the most recent scrape",
        )
        self._g_series = reg.gauge(
            "fleet/hub_series", help="series retained in the hub ring",
        )
        return self

    def _make_client(self, address):
        # imported lazily: telemetry must stay importable without the
        # serving tier (and its transitive torch imports)
        from ..serving.transport import NodeControlClient

        return NodeControlClient(
            address, connect_timeout=self.op_timeout_secs,
            op_timeout=self.op_timeout_secs,
        )

    # -- the tick (router monitor cadence) -------------------------------
    def tick(self, now=None):
        """Rate-limited to ``interval_secs``; kicks one background
        scrape (+ cadenced span drain) unless the previous one is still
        in flight. Called from the router's monitor thread — never
        blocks it on a node's socket."""
        if self._router is None or self._closed:
            return False
        now = self._clock() if now is None else float(now)
        if (
            self._last_tick is not None
            and now - self._last_tick < self.interval_secs
        ):
            return False
        t = self._thread
        if t is not None and t.is_alive():
            return False  # one scrape in flight at a time
        self._last_tick = now
        self._thread = threading.Thread(
            target=self._tick_bg, name="ds-hub-scrape", daemon=True,
        )
        self._thread.start()
        return True

    def _tick_bg(self):
        try:
            self.scrape_once()
            now = self._clock()
            if (
                self.drain_interval_secs > 0
                and (self._last_drain is None
                     or now - self._last_drain >= self.drain_interval_secs)
            ):
                self._last_drain = now
                self.drain_once()
        except Exception as e:  # a scrape bug must not kill the cadence
            count_suppressed("telemetry.hub_tick", e)

    # -- scraping --------------------------------------------------------
    def scrape_once(self, now=None):
        """One synchronous fleet scrape: the router's registry, the
        process diagnostics counters, and every reachable node's
        per-replica registries — all appended to the ring; the remote
        views cached for /metrics. Returns the number of nodes that
        answered."""
        router = self._router
        if router is None:
            return 0
        now = self._clock() if now is None else float(now)
        try:
            self.store.record_many(
                wire_scalars(wire_snapshot(router.metrics)), now=now,
            )
            diag = diagnostics_registry().snapshot()
            self.store.record(
                "internal/suppressed_errors",
                diag.get("internal/suppressed_errors", 0.0), now=now,
            )
        except Exception as e:
            count_suppressed("telemetry.hub_local_scrape", e)
        up = 0
        for node, address in sorted(self.nodes.items()):
            failed_at = self._node_failed_at.get(node)
            if (
                failed_at is not None
                and now - failed_at < self.node_backoff_secs
            ):
                continue
            try:
                reply = self._make_client(address).metrics_snapshot()
            except Exception as e:
                self._node_failed_at[node] = now
                self._c_scrape_failures.inc()
                count_suppressed("telemetry.hub_scrape", e)
                continue
            self._node_failed_at.pop(node, None)
            self._c_scrapes.inc()
            up += 1
            node_name = str(reply.get("node") or node)
            replicas = reply.get("replicas") or {}
            with self._lock:
                stale = [
                    key for key in self._remote
                    if key[0] == node_name and key[1] not in replicas
                ]
                for key in stale:
                    del self._remote[key]
                for rep, entries in replicas.items():
                    self._remote[(node_name, str(rep))] = (now, entries)
            samples = {}
            for rep, entries in replicas.items():
                for k, v in wire_scalars(entries).items():
                    samples[_series_key(k, node_name, rep)] = v
            if samples:
                self.store.record_many(samples, now=now)
        self._nodes_up = up
        self._g_nodes_up.set(up)
        self._g_series.set(len(self.store))
        self._evaluate_alerts(now)
        return up

    # -- cross-host trace collection -------------------------------------
    def drain_once(self, flight=False, reason=None, now=None):
        """Pull every node's sampled-span batch home and ingest it into
        the router's tracer (one fleet trace file). With ``flight=True``
        the nodes also ship their flight-recorder rings and the router
        dumps ONE combined ``flight-fleet-*`` file. Returns
        ``(spans_ingested, dump_path_or_None)``."""
        router = self._router
        if router is None:
            return 0, None
        now = self._clock() if now is None else float(now)
        tracer = router.tracer
        total = 0
        for node, address in sorted(self.nodes.items()):
            failed_at = self._node_failed_at.get(node)
            if (
                failed_at is not None
                and now - failed_at < self.node_backoff_secs
            ):
                continue
            try:
                reply = self._make_client(address).drain_telemetry(
                    flight=flight, reason=reason,
                )
            except Exception as e:
                self._node_failed_at[node] = now
                self._c_scrape_failures.inc()
                count_suppressed("telemetry.hub_drain", e)
                continue
            if not tracer.enabled:
                continue
            total += tracer.ingest(reply.get("spans") or [])
            if flight:
                # ring events land in the router ring (instant events
                # carry sampled=False, so they stay out of trace.json)
                tracer.ingest(reply.get("flight_events") or [])
        self._c_drains.inc()
        if total:
            self._c_spans.inc(total)
        path = None
        if tracer.enabled:
            if flight:
                path = tracer.dump_flight(
                    f"fleet-{reason or 'manual'}",
                    extra={"nodes": sorted(self.nodes)},
                )
            tracer.flush()  # ingested remote spans -> trace.json now
        return total, path

    # -- alert rules ------------------------------------------------------
    def _burn_rate(self, window_secs, now):
        """Multi-window SLO burn rate (Prometheus SRE-workbook form):
        observed error rate over the window divided by the error budget
        rate ``1 - slo_target``. None until the window holds two SLO
        accounting points."""
        violations = self.store.window_delta(
            "fleet/slo_violations", window_secs, now,
        )
        samples = self.store.window_delta(
            "fleet/slo_samples", window_secs, now,
        )
        if violations is None or not samples:
            return None
        return (violations / samples) / max(1.0 - self.slo_target, 1e-9)

    def error_budget_remaining(self, window_secs=None, now=None):
        """Windowed error budget: the fraction of SLO accounting samples
        that did NOT violate over the trailing window (the hub-side
        replacement for the autoscaler's private in-memory deque — same
        semantics, but computed from the retained ring, so /statz, the
        alert rules, and the autoscaler read one number). None until
        the window holds two points."""
        now = self._clock() if now is None else float(now)
        window = (
            self.alert_slow_window_secs if window_secs is None
            else float(window_secs)
        )
        violations = self.store.window_delta(
            "fleet/slo_violations", window, now,
        )
        samples = self.store.window_delta("fleet/slo_samples", window, now)
        if violations is None or not samples:
            return None
        return max(0.0, 1.0 - violations / samples)

    def observed_rate(self, name, window_secs, now=None):
        """Counter rate over the trailing window (None until the ring
        holds two points) — the autoscaler's arrival-rate read."""
        return self.store.window_rate(name, window_secs, now)

    def _evaluate_alerts(self, now):
        router = self._router
        active = set()
        fast = self._burn_rate(self.alert_fast_window_secs, now)
        slow = self._burn_rate(self.alert_slow_window_secs, now)
        if (
            fast is not None and slow is not None
            and fast >= self.alert_fast_burn
            and slow >= self.alert_slow_burn
        ):
            active.add(ALERT_SLO_BURN)
        opens = self.store.window_delta(
            "fleet/breaker_opens", self.alert_fast_window_secs, now,
        )
        if opens is not None and opens >= self.alert_breaker_flood:
            active.add(ALERT_BREAKER_FLOOD)
        growth = self.store.window_delta(
            "internal/suppressed_errors", self.alert_fast_window_secs, now,
        )
        if growth is not None and growth >= self.alert_suppressed_growth:
            active.add(ALERT_SUPPRESSED_GROWTH)
        for rule in sorted(active - self._active_alerts):
            # rising edge: one counter bump + one flight breadcrumb per
            # firing, not one per evaluation tick
            router.metrics.counter(
                f"fleet/alerts_{rule}",
                help=f"alert rule {rule} firings (rising edges)",
            ).inc()
            logger.warning(
                "telemetry hub: alert %s FIRING (burn fast=%s slow=%s, "
                "breaker_opens=%s, suppressed_growth=%s)",
                rule, fast, slow, opens, growth,
            )
            if router.tracer.enabled:
                router.tracer.event(
                    "hub.alert",
                    attrs={"rule": rule, "burn_fast": fast,
                           "burn_slow": slow},
                )
        for rule in sorted(self._active_alerts - active):
            logger.info("telemetry hub: alert %s resolved", rule)
        self._active_alerts = active

    # -- serving views (the door's GET handlers call these) ---------------
    def prometheus_text(self):
        """The fleet as Prometheus 0.0.4 text: the router registry and
        the process diagnostics unlabeled, every cached remote replica
        registry with ``{node, replica}`` labels — one scrape answers
        for the whole fleet."""
        router = self._router
        entries = []
        if router is not None:
            entries.extend(wire_snapshot(router.metrics))
        entries.extend(wire_snapshot(diagnostics_registry()))
        with self._lock:
            remote = sorted(self._remote.items())
        for (node, rep), (_ts, rentries) in remote:
            for e in rentries:
                labeled = dict(e)
                labeled["labels"] = {"node": node, "replica": rep}
                entries.append(labeled)
        return render_prometheus(entries)

    def statz(self, now=None):
        """JSON fleet snapshot + recent windows: the ``GET /statz``
        body and the SSE dashboard frame."""
        router = self._router
        now = self._clock() if now is None else float(now)
        fast_w = self.alert_fast_window_secs
        slow_w = self.alert_slow_window_secs
        with self._lock:
            replicas = {
                f"{node}/{rep}": {
                    "age_secs": round(now - ts, 3),
                    "stale": (now - ts) > max(self.interval_secs * 3, 5.0),
                }
                for (node, rep), (ts, _e) in sorted(self._remote.items())
            }
        def _windows(window):
            return {
                "request_rate": self.store.window_rate(
                    "fleet/requests_routed", window, now),
                "completion_rate": self.store.window_rate(
                    "fleet/requests_completed", window, now),
                "slo_violations": self.store.window_delta(
                    "fleet/slo_violations", window, now),
                "slo_samples": self.store.window_delta(
                    "fleet/slo_samples", window, now),
                "burn_rate": self._burn_rate(window, now),
                "error_budget_remaining": self.error_budget_remaining(
                    window, now),
            }
        return {
            "ts": now,
            "nodes": sorted(self.nodes),
            "nodes_up": self._nodes_up,
            "replicas": replicas,
            "fleet": (
                router.metrics.snapshot() if router is not None else {}
            ),
            "suppressed_errors": suppressed_errors_snapshot(),
            "windows": {
                f"{int(fast_w)}s": _windows(fast_w),
                f"{int(slow_w)}s": _windows(slow_w),
            },
            "alerts": {
                "active": sorted(self._active_alerts),
                "rules": {
                    ALERT_SLO_BURN: {
                        "fast_window_secs": fast_w,
                        "slow_window_secs": slow_w,
                        "fast_burn": self.alert_fast_burn,
                        "slow_burn": self.alert_slow_burn,
                        "slo_target": self.slo_target,
                    },
                    ALERT_BREAKER_FLOOD: {
                        "window_secs": fast_w,
                        "threshold": self.alert_breaker_flood,
                    },
                    ALERT_SUPPRESSED_GROWTH: {
                        "window_secs": fast_w,
                        "threshold": self.alert_suppressed_growth,
                    },
                },
            },
            "series_retained": len(self.store),
        }

    def dashboard_state(self, now=None):
        """The SSE frame: statz plus sparkline tails for the dashboard's
        canvases."""
        state = self.statz(now=now)
        state["spark"] = {
            "ttft_p99_ms": self.store.sparkline("fleet/ttft_p99_ms"),
            "utilization": self.store.sparkline("fleet/slo_utilization"),
            "queue_depth": self.store.sparkline("fleet/queue_depth"),
            "budget_remaining": self.store.sparkline(
                "fleet/slo_error_budget_remaining"
            ),
        }
        return state

    def dashboard_html(self):
        """One self-contained page (no external assets — it must render
        inside an airgapped pod): subscribes to ``/statz/stream`` and
        draws the four sparklines + the per-node replica table."""
        initial = json.dumps(self.dashboard_state())
        return _DASHBOARD_HTML.replace("__INITIAL_STATE__", initial)

    def close(self, timeout=5.0):
        """Stop ticking and wait out an in-flight scrape (the router
        calls this from shutdown())."""
        self._closed = True
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None


_DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>fleet dashboard</title>
<style>
 body{font-family:ui-monospace,Menlo,monospace;background:#111;color:#ddd;
      margin:1.5em}
 h1{font-size:1.1em} .cards{display:flex;flex-wrap:wrap;gap:1em}
 .card{background:#1b1b1b;border:1px solid #333;border-radius:6px;
       padding:.8em;min-width:260px}
 .card h2{font-size:.8em;margin:0 0 .4em;color:#9ad}
 .big{font-size:1.4em} canvas{display:block;margin-top:.4em}
 table{border-collapse:collapse;margin-top:1em;font-size:.85em}
 td,th{border:1px solid #333;padding:.25em .6em;text-align:left}
 .ok{color:#6c6} .bad{color:#e66}
 #alerts span{background:#611;border:1px solid #a33;border-radius:4px;
              padding:.1em .5em;margin-right:.4em}
</style></head><body>
<h1>fleet dashboard <small id="ts"></small></h1>
<div id="alerts"></div>
<div class="cards">
 <div class="card"><h2>SLO budget remaining</h2>
  <div class="big" id="v-budget">&ndash;</div>
  <canvas id="c-budget" width="240" height="48"></canvas></div>
 <div class="card"><h2>TTFT p99 (ms)</h2>
  <div class="big" id="v-ttft">&ndash;</div>
  <canvas id="c-ttft" width="240" height="48"></canvas></div>
 <div class="card"><h2>utilization</h2>
  <div class="big" id="v-util">&ndash;</div>
  <canvas id="c-util" width="240" height="48"></canvas></div>
 <div class="card"><h2>queue depth</h2>
  <div class="big" id="v-queue">&ndash;</div>
  <canvas id="c-queue" width="240" height="48"></canvas></div>
</div>
<table id="replicas"><thead><tr><th>node/replica</th><th>age (s)</th>
<th>health</th></tr></thead><tbody></tbody></table>
<script>
function spark(id, pts){
  var c=document.getElementById(id), g=c.getContext('2d');
  g.clearRect(0,0,c.width,c.height);
  if(!pts||pts.length<2)return;
  var mn=Math.min.apply(null,pts), mx=Math.max.apply(null,pts);
  var span=(mx-mn)||1; g.strokeStyle='#6ad'; g.beginPath();
  pts.forEach(function(v,i){
    var x=i/(pts.length-1)*(c.width-2)+1;
    var y=c.height-2-((v-mn)/span)*(c.height-4);
    i?g.lineTo(x,y):g.moveTo(x,y);});
  g.stroke();
}
function fmt(v,d){return v==null?'\\u2013':Number(v).toFixed(d)}
function render(s){
  document.getElementById('ts').textContent=
    new Date(s.ts*1000).toISOString();
  var f=s.fleet||{}, sp=s.spark||{};
  var w=s.windows?s.windows[Object.keys(s.windows)[0]]:{};
  document.getElementById('v-budget').textContent=
    fmt(w&&w.error_budget_remaining,3);
  document.getElementById('v-ttft').textContent=
    fmt(f['fleet/ttft_p99_ms'],1);
  document.getElementById('v-util').textContent=
    fmt(f['fleet/slo_utilization'],2);
  document.getElementById('v-queue').textContent=
    fmt(f['fleet/queue_depth'],0);
  spark('c-budget',sp.budget_remaining); spark('c-ttft',sp.ttft_p99_ms);
  spark('c-util',sp.utilization); spark('c-queue',sp.queue_depth);
  var al=document.getElementById('alerts'); al.innerHTML='';
  (s.alerts&&s.alerts.active||[]).forEach(function(a){
    var e=document.createElement('span'); e.textContent=a;
    al.appendChild(e);});
  var tb=document.querySelector('#replicas tbody'); tb.innerHTML='';
  Object.keys(s.replicas||{}).forEach(function(k){
    var r=s.replicas[k], tr=document.createElement('tr');
    tr.innerHTML='<td>'+k+'</td><td>'+fmt(r.age_secs,1)+'</td>'+
      '<td class="'+(r.stale?'bad':'ok')+'">'+
      (r.stale?'stale':'live')+'</td>';
    tb.appendChild(tr);});
}
render(__INITIAL_STATE__);
try{
  var es=new EventSource('/statz/stream');
  es.addEventListener('statz',function(ev){
    render(JSON.parse(ev.data));});
}catch(e){/* SSE unavailable: the initial frame still renders */}
</script></body></html>
"""
