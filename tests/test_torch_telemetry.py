"""Port parity: the telemetry core (deepspeed_tpu_torch/telemetry/ and
utils/timers.py) against the JAX package's.

The same inputs go through both packages' pure-Python modules: the
training catalog (the reference's minus its ``jax/*`` rows, absent by
design), ``render_prometheus`` (byte for byte), the JSONL and Prometheus
exporters, ``Telemetry``'s interval and flush semantics, the watchdog on
a fake clock, the config-armed profiler window on the CPU, and the
timers on the host clock. No tolerance is needed: nothing here is
floating-point arithmetic beyond copying values.
"""

import json
import logging
import os

import pytest
import torch

from deepspeed_tpu.telemetry import exporters as jexporters
from deepspeed_tpu.telemetry import manager as jmanager
from deepspeed_tpu.telemetry import registry as jregistry
from deepspeed_tpu.telemetry import watchdog as jwatchdog
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.telemetry import exporters as texporters
from deepspeed_tpu_torch.telemetry import manager as tmanager
from deepspeed_tpu_torch.telemetry import registry as tregistry
from deepspeed_tpu_torch.telemetry import watchdog as twatchdog
from deepspeed_tpu_torch.telemetry.profiling import ProfilerWindow
from deepspeed_tpu_torch.utils.timers import (
    SynchronizedWallClockTimer,
    ThroughputTimer,
    device_fence,
)
from torch_test_env import jax_compile_cache  # noqa: F401

ABSENT_BY_DESIGN = {"jax/recompiles", "jax/compile_cache_hits",
                    "jax/compile_cache_misses"}


# ---------------------------------------------------------------------------
# catalogs
# ---------------------------------------------------------------------------
def test_training_catalog_is_the_reference_minus_its_jax_rows():
    want = [(k, n) for k, n, _ in jmanager.ENGINE_METRICS
            if n not in ABSENT_BY_DESIGN]
    got = [(k, n) for k, n, _ in tmanager.ENGINE_METRICS]
    assert got == want
    assert ABSENT_BY_DESIGN <= {n for _, n, _ in jmanager.ENGINE_METRICS}


def test_inference_and_adapter_catalogs_match_the_reference():
    for name in ("INFERENCE_METRICS", "ADAPTER_METRICS"):
        assert [(k, n) for k, n, _ in getattr(tmanager, name)] == [
            (k, n) for k, n, _ in getattr(jmanager, name)], name


def test_enabled_telemetry_registers_the_golden_set():
    t = tmanager.Telemetry(enabled=True)
    names = {n for n, _ in t.registry.snapshot().items()}
    for kind, name, _ in tmanager.ENGINE_METRICS:
        if kind == "histogram":
            assert f"{name}/count" in names, name
        else:
            assert name in names, name
    t.close()


# ---------------------------------------------------------------------------
# Prometheus text: the same bytes
# ---------------------------------------------------------------------------
def _fill(registry_mod):
    reg = registry_mod.MetricsRegistry()
    reg.counter("train/steps", help="optimizer updates").inc(3)
    reg.gauge("train/loss", help='mean "loss"\\ of\nthe window').set(2.5)
    reg.gauge("a.b").set(float("nan"))
    reg.gauge("a/b").set(1.0)  # collides with a.b on a_b: dropped
    reg.gauge("9lives").set(float("inf"))
    h = reg.histogram("infer/ttft_ms", buckets=(1.0, 10.0, 100.0),
                      help="time to first token")
    for v, trace in ((0.5, None), (5.0, "abc123"), (50.0, None),
                     (500.0, "def456"), (7.0, None)):
        h.observe(v, trace_id=trace)
    return reg


def test_render_prometheus_gives_the_same_bytes_on_the_same_registry():
    jtext = jexporters.render_prometheus(
        jregistry.metric_to_wire(m) for m in _fill(jregistry).collect())
    ttext = texporters.render_prometheus(
        tregistry.metric_to_wire(m) for m in _fill(tregistry).collect())
    # the exemplars' unix timestamps are the only run-dependent field
    strip = [l for l in jtext.splitlines() if not l.startswith("# EXEMPLAR")]
    assert [l for l in ttext.splitlines()
            if not l.startswith("# EXEMPLAR")] == strip
    assert ttext.count("# EXEMPLAR") == jtext.count("# EXEMPLAR") == 2
    assert "train_loss 2.5" in ttext and "a_b NaN" in ttext


@pytest.mark.parametrize("entries", [
    [{"name": "fleet/q", "kind": "gauge", "value": 3.0, "help": "depth",
      "labels": {"node": 'n"0', "replica": "r\\1\nx"}},
     {"name": "fleet/q", "kind": "gauge", "value": 4.0,
      "labels": {"node": "n1"}}],
    [{"name": "h", "kind": "histogram", "count": 3, "sum": 6.5,
      "thresholds": [1.0, 2.0], "bucket_counts": [1, 1, 1],
      "exemplars": {"0": [0.5, "t0", 1700000000.25],
                    2: [9.0, "t2", 1700000001.5]},
      "labels": {"le_ok": "x"}}],
    [{"name": "x", "kind": "counter", "value": 1.0},
     {"name": "x", "kind": "gauge", "value": 2.0}],  # kind mismatch
    [],
])
def test_render_prometheus_gives_the_same_bytes_on_the_same_entries(entries):
    assert texporters.render_prometheus(entries) == \
        jexporters.render_prometheus(entries)


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def _records(path):
    out = []
    for line in open(path).read().splitlines():
        rec = json.loads(line)
        rec.pop("wall_time")
        # an exemplar's unix timestamp is the one run-dependent field
        for bucket, ex in rec.get("exemplars", {}).items():
            rec["exemplars"][bucket] = ex[:2]
        out.append(rec)
    return out


def test_jsonl_and_prometheus_exporters_write_what_the_reference_writes(
        tmp_path):
    for pkg, exp, reg_mod in (("jax", jexporters, jregistry),
                              ("torch", texporters, tregistry)):
        metrics = _fill(reg_mod).collect()
        jsonl = exp.build_exporter("jsonl", str(tmp_path / pkg), "job")
        prom = exp.build_exporter("prometheus", str(tmp_path / pkg), "job")
        for e in (jsonl, prom):
            e.export(metrics, 7)
            e.close()
    assert _records(tmp_path / "torch" / "metrics.jsonl") == _records(
        tmp_path / "jax" / "metrics.jsonl")
    strip = lambda p: [l for l in open(p).read().splitlines()  # noqa: E731
                       if not l.startswith("# EXEMPLAR")]
    assert strip(tmp_path / "torch" / "metrics.prom") == strip(
        tmp_path / "jax" / "metrics.prom")
    with pytest.raises(ValueError, match="unknown telemetry exporter"):
        texporters.build_exporter("statsd", str(tmp_path), "job")


def test_summary_writer_exporter_writes_count_and_sum(tmp_path):
    class Writer:
        def __init__(self):
            self.rows = []

        def add_scalar(self, tag, value, global_step=None):
            self.rows.append((tag, value, global_step))

        def flush(self):
            pass

        def close(self):
            pass

    rows = []
    for exp, reg_mod in ((jexporters, jregistry), (texporters, tregistry)):
        w = Writer()
        exp.SummaryWriterExporter(writer=w).export(
            _fill(reg_mod).collect(), 4)
        rows.append([r for r in w.rows if r[0] != "a.b"])  # NaN != NaN
    assert rows[0] == rows[1]
    assert ("infer/ttft_ms/count", 5, 4) in rows[1]


# ---------------------------------------------------------------------------
# Telemetry: interval, trailing windows, no host sync between exports
# ---------------------------------------------------------------------------
class _Capture:
    def __init__(self):
        self.steps = []
        self.values = []

    def export(self, metrics, step):
        self.steps.append(step)
        self.values.append({m.name: getattr(m, "value", None)
                            for m in metrics if m.kind != "histogram"})

    def flush(self):
        pass

    def close(self):
        pass


class _DeviceValue:
    """A stand-in for a device tensor: counts its host reads."""

    reads = 0

    def __init__(self, v):
        self.v = v

    def __float__(self):
        _DeviceValue.reads += 1
        return self.v


@pytest.mark.parametrize("interval,windows", [(3, 4), (2, 4), (1, 3),
                                              (4, 9)])
def test_interval_and_flush_export_like_the_reference(interval, windows):
    """Exports land at the same windows in both packages, and flush()
    settles the trailing windows past the last boundary (once)."""
    sinks = []
    for mgr in (jmanager, tmanager):
        sink = _Capture()
        t = mgr.Telemetry(enabled=True, interval=interval, exporters=[sink])
        for step in range(1, windows + 1):
            t.on_window_start()
            t.count_batch(32, 4)
            t.on_window_end(loss=0.5 * step, grad_norm=0.25 * step,
                            loss_scale=1.0, lr=1e-3 * step,
                            global_steps=step, skipped_steps=0,
                            micro_steps=2 * step)
        t.flush()
        t.flush()  # nothing pending: no duplicate export
        sinks.append(sink)
        t.close()
    jsink, tsink = sinks
    assert tsink.steps == jsink.steps
    assert tsink.steps[-1] == windows
    keys = ("train/loss", "train/grad_norm", "train/learning_rate",
            "train/loss_scale", "train/global_steps", "train/skipped_steps",
            "train/micro_steps")
    for got, want in zip(tsink.values, jsink.values):
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert set(tsink.values[0]) == set(jsink.values[0]) - ABSENT_BY_DESIGN


def test_device_values_are_read_only_at_export_boundaries():
    """on_window_end holds the window's loss as a device value and reads
    it (one host sync) only when an export boundary settles it."""
    _DeviceValue.reads = 0
    t = tmanager.Telemetry(enabled=True, interval=3, exporters=[_Capture()])
    for step in (1, 2):
        t.on_window_start()
        t.on_window_end(loss=_DeviceValue(1.0), global_steps=step)
    assert _DeviceValue.reads == 0
    t.on_window_start()
    t.on_window_end(loss=_DeviceValue(3.0), global_steps=3)
    assert _DeviceValue.reads == 1
    t.on_window_start()
    t.on_window_end(loss=_DeviceValue(4.0), global_steps=4)
    assert _DeviceValue.reads == 1
    t.flush()
    assert _DeviceValue.reads == 2
    assert t.registry.snapshot()["train/loss"] == 4.0
    t.close()


def test_disabled_telemetry_is_inert():
    t = tmanager.Telemetry(enabled=False)
    t.on_window_start()
    t.on_window_end(loss=_DeviceValue(1.0), global_steps=1)
    t.heartbeat()
    t.flush()
    t.close()
    assert t.registry.snapshot() == {}


def test_window_time_and_rates_follow_the_reference_formula(monkeypatch):
    """train/window_time_ms observes start -> end only; tokens/s,
    samples/s and model TFLOPS (6 N tokens/s) over the export interval."""
    now = [100.0]
    monkeypatch.setattr(tmanager.time, "time", lambda: now[0])
    t = tmanager.Telemetry(enabled=True, interval=1, n_params=1000)
    t.on_window_end(global_steps=1)  # no start: no window sample
    hist = t.registry.histogram("train/window_time_ms")
    assert hist.count == 0
    t.on_window_start()
    t.count_batch(4096, 4)
    now[0] += 2.0
    t.on_window_end(global_steps=2)
    assert hist.count == 1 and hist.sum == pytest.approx(2000.0)
    snap = t.registry.snapshot()
    assert snap["train/tokens_per_sec"] == pytest.approx(4096 / 2.0)
    assert snap["train/samples_per_sec"] == pytest.approx(2.0)
    assert snap["train/model_tflops"] == pytest.approx(
        6.0 * 1000 * 2048 / 1e12)
    t.close()


def test_hbm_peak_is_none_on_the_cpu():
    assert tmanager.hbm_peak_bytes("cpu") is None
    assert tmanager.hbm_peak_bytes(None) is None


# ---------------------------------------------------------------------------
# build_telemetry from the config
# ---------------------------------------------------------------------------
def _cfg(block, **extra):
    return DeepSpeedConfig(
        None, param_dict={"train_batch_size": 8, "telemetry": block, **extra},
        world_size=1)


def test_build_telemetry_wires_the_configured_sinks(tmp_path):
    cfg = _cfg({"enabled": True, "output_path": str(tmp_path),
                "job_name": "job", "interval": 2,
                "exporters": ["jsonl", "prometheus"],
                "profile": {"start_step": 1, "num_steps": 2},
                "watchdog": {"timeout": 30.0},
                "tracing": {"enabled": True, "sample_rate": 0.5}})
    t = tmanager.build_telemetry(cfg, n_params=10, device="cpu")
    try:
        assert t.enabled and t.interval == 2 and t.n_params == 10
        kinds = [type(e).__name__ for e in t.exporters]
        assert kinds == ["JsonlExporter", "PrometheusTextfileExporter"]
        assert t.exporters[1].path == str(tmp_path / "job" / "metrics.prom")
        assert t.profiler.start_step == 1 and t.profiler.num_steps == 2
        assert t.profiler.trace_path == str(
            tmp_path / "job" / "profile" / "trace.json")
        assert t.watchdog.timeout == 30.0 and t.watchdog._thread.is_alive()
        assert t.tracer.enabled and t.tracer.sample_rate == 0.5
        assert t.tracer.export_path == str(tmp_path / "job" / "trace.json")
    finally:
        t.close()
    assert not t.enabled and t.watchdog._thread is None
    off = tmanager.build_telemetry(
        DeepSpeedConfig(None, param_dict={"train_batch_size": 8},
                        world_size=1))
    assert not off.enabled and off.watchdog is None


# ---------------------------------------------------------------------------
# watchdog (fake clock): both packages give the same reports
# ---------------------------------------------------------------------------
def _watchdog_script(mod):
    """Drive one watchdog through the first-window grace, a stall, a
    recovery, pause/resume and a liveness-only beat; return what it
    reported, what its listeners heard and what check() answered."""
    now = [0.0]
    reports, heard, answers = [], [], []
    wd = mod.StepHeartbeatWatchdog(
        timeout=30.0, poll_interval=1.0, clock=lambda: now[0],
        context_fn=lambda: {"device_memory": "fake"},
        report_fn=lambda waited, step, ctx: reports.append(
            (round(waited, 6), step, ctx)),
    )
    wd.add_stall_listener(lambda waited, step: heard.append(
        (round(waited, 6), step)))

    def tick(dt):
        now[0] += dt
        answers.append(wd.check())

    wd.beat()  # a step=None beat never arms: the first window's grace
    tick(1000.0)
    wd.beat(step=1)
    tick(29.0)
    tick(2.0)  # stall
    tick(5.0)  # one report per stall
    wd.beat(step=2)
    wd.pause()
    tick(1000.0)  # paused: no stall
    wd.pause()
    wd.resume()
    tick(100.0)  # still paused (nested)
    wd.resume()
    tick(29.0)
    tick(2.0)  # stall again, clock restarted at resume
    wd.beat(step=3)
    tick(25.0)
    wd.beat()  # liveness keeps an armed watchdog alive
    tick(25.0)
    tick(6.0)
    return reports, heard, answers, wd.stall_count


def test_watchdog_matches_the_reference_on_a_fake_clock():
    want = _watchdog_script(jwatchdog)
    got = _watchdog_script(twatchdog)
    assert got == want
    reports, heard, answers, count = got
    assert answers[0] is False  # the first window's grace
    assert [r[1] for r in reports] == [1, 2, 3] and count == 3
    assert heard == [(r[0], r[1]) for r in reports]


def test_watchdog_failing_listener_and_reporter_are_counted_not_raised():
    now = [0.0]
    wd = twatchdog.StepHeartbeatWatchdog(
        timeout=1.0, poll_interval=1.0, clock=lambda: now[0],
        report_fn=lambda *a: 1 / 0)
    wd.add_stall_listener(lambda *a: [][1])
    before = tregistry.suppressed_errors_snapshot()
    wd.beat(step=1)
    now[0] = 5.0
    assert wd.check()
    after = tregistry.suppressed_errors_snapshot()
    for site in ("watchdog.report_fn", "watchdog.stall_listener"):
        key = f"internal/suppressed_errors/{site}"
        assert after.get(key, 0) == before.get(key, 0) + 1


def test_watchdog_default_report_is_rank_tagged():
    from deepspeed_tpu_torch.utils.logging import logger

    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = Capture(level=logging.ERROR)
    logger.addHandler(handler)
    try:
        now = [0.0]
        wd = twatchdog.StepHeartbeatWatchdog(
            timeout=5.0, poll_interval=1.0, clock=lambda: now[0],
            context_fn=lambda: {"metrics": {"train/loss": 1.0}})
        wd.beat(step=1)
        now[0] = 10.0
        assert wd.check()
    finally:
        logger.removeHandler(handler)
    assert any("STEP HEARTBEAT STALL" in r.getMessage()
               and "[Rank 0]" in r.getMessage() for r in records)


def test_watchdog_thread_and_bad_arguments():
    wd = twatchdog.StepHeartbeatWatchdog(timeout=60.0, poll_interval=0.05)
    wd.start()
    assert wd._thread.is_alive()
    wd.start()  # idempotent
    wd.stop()
    assert wd._thread is None
    for kw in ({"timeout": 0}, {"timeout": 60.0, "poll_interval": -1}):
        with pytest.raises(ValueError):
            twatchdog.StepHeartbeatWatchdog(**kw)


def test_liveness_exempt_pauses_the_watchdog():
    now = [0.0]
    wd = twatchdog.StepHeartbeatWatchdog(
        timeout=30.0, poll_interval=1.0, clock=lambda: now[0],
        report_fn=lambda *a: None)
    t = tmanager.Telemetry(enabled=True, watchdog=wd)
    wd.stop()  # the fake clock is driven by hand
    t.on_window_end(global_steps=1)
    with t.liveness_exempt():
        now[0] += 1000.0
        assert not wd.check()
    assert not wd.check()  # the stall clock restarted on exit
    t.close()


# ---------------------------------------------------------------------------
# profiler window on the CPU
# ---------------------------------------------------------------------------
def test_profiler_window_traces_windows_start_to_end_on_the_cpu(tmp_path):
    fenced = []
    pw = ProfilerWindow(start_step=1, num_steps=2,
                        output_path=str(tmp_path / "prof"),
                        fence=lambda: fenced.append(pw.tracing),
                        device="cpu")
    x = torch.randn(64, 64)
    for i in range(4):
        pw.on_window_start()
        pw.on_window_start()  # idempotent within a window
        assert pw.tracing == (i in (1, 2))
        with torch.profiler.record_function("window_fwd_bwd"):
            x = torch.tanh(x @ x)
        pw.on_window_end()
    assert fenced == [True]  # once, before the trace stopped
    assert not pw.tracing and not pw.enabled
    events = json.load(open(pw.trace_path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"train_window#1", "train_window#2", "window_fwd_bwd"} <= names
    assert "train_window#0" not in names and "train_window#3" not in names


def test_profiler_window_close_stops_an_open_trace(tmp_path):
    pw = ProfilerWindow(start_step=0, num_steps=5,
                        output_path=str(tmp_path / "p"), device="cpu")
    pw.on_window_start()
    torch.ones(3).sum()
    pw.close()
    assert not pw.tracing and os.path.exists(pw.trace_path)
    never = ProfilerWindow(start_step=-1, num_steps=3,
                           output_path=str(tmp_path / "q"))
    never.on_window_start()
    never.on_window_end()
    assert not never.enabled and not os.path.exists(never.trace_path)


# ---------------------------------------------------------------------------
# timers (host clock on the CPU)
# ---------------------------------------------------------------------------
def test_wall_clock_timers_on_the_host_clock(monkeypatch):
    from deepspeed_tpu_torch.utils import timers as tt

    now = [10.0]
    monkeypatch.setattr(tt.time, "time", lambda: now[0])
    timers = SynchronizedWallClockTimer(device="cpu")
    timers("forward").start()
    now[0] += 0.25
    timers("forward").stop()
    timers("forward").start()
    now[0] += 0.5
    assert timers.snapshot() == {"forward": pytest.approx(0.75)}
    timers("forward").stop()
    assert timers.has_timer("forward") and not timers.has_timer("step")
    with pytest.raises(RuntimeError, match="not started"):
        timers("step").stop()
    timers("step").start()
    with pytest.raises(RuntimeError, match="already been started"):
        timers("step").start()
    now[0] += 1.0
    assert timers("forward").elapsed(reset=False) == pytest.approx(0.75)
    lines = []
    monkeypatch.setattr(tt, "log_dist", lambda msg, ranks=None: lines.append(
        msg))
    timers.log(["forward", "step"], normalizer=2.0)
    assert lines == ["time (ms) | forward: 375.00 | step: 500.00"]
    assert timers("forward").elapsed() == 0.0  # reset by log()
    with pytest.raises(ValueError):
        timers.log(["forward"], normalizer=0.0)


def test_cuda_timers_and_fences_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        SynchronizedWallClockTimer(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_fence("cuda")
    assert device_fence("cpu")() is None
    assert "n/a" in SynchronizedWallClockTimer.memory_usage("cpu")


def test_throughput_timer_matches_the_reference():
    from deepspeed_tpu.utils.timers import ThroughputTimer as JTimer

    rates = []
    for cls in (JTimer, ThroughputTimer):
        lines = []
        t = cls(batch_size=8, num_workers=1, start_step=2,
                steps_per_output=2, monitor_memory=False,
                logging_fn=lines.append, fence_fn=lambda: None)
        assert t.avg_samples_per_sec() == 0.0
        for _ in range(6):
            t.start()
            t.stop()
        rates.append((t.total_step_count, t.local_step_count,
                      t.avg_samples_per_sec() > 0))
    assert rates[0] == rates[1] == (6, 6, True)
