"""Port parity: the span tracer (deepspeed_tpu_torch/telemetry/tracing.py)
against the JAX package's.

Both packages' tracers are driven with the same calls, with their
random ids and sampling dice fed from one seeded ``random.Random`` and
their clocks' offsets pinned, so the recorded spans, the sampling
decisions, the flight-recorder ring, ``ingest`` and the Chrome export
can be compared exactly. Each package's ``load_chrome_trace`` reads the
other's file. ``build_tracer`` takes the same config dicts.
"""

import json
import os
import random

import pytest

import deepspeed_tpu
from deepspeed_tpu.telemetry import tracing as jtracing
from deepspeed_tpu_torch import DeepSpeedConfig
from deepspeed_tpu_torch.telemetry import tracing as ttracing
from deepspeed_tpu_torch.telemetry.manager import Telemetry
from torch_test_env import jax_compile_cache  # noqa: F401


def _pinned(mod, monkeypatch, tracer_kwargs, seed=0):
    """A tracer of ``mod`` whose ids, sampling dice and clock offset are
    deterministic."""
    ids = random.Random(seed)
    monkeypatch.setattr(mod, "_new_id", lambda: "%016x" % ids.getrandbits(64))
    t = mod.SpanTracer(rng=random.Random(seed + 1), **tracer_kwargs)
    t._mono_offset = 1000.0
    t._pid = 4242
    return t


def _drive(mod, t):
    """The same calls on either package's tracer; returns the span dicts
    the calls returned (threads and wall-clock events left out)."""
    out = []
    root = t.child_of(None)
    out.append(t.record("request", 1.0, 4.0,
                        ctx=mod.TraceContext(root.trace_id, None,
                                             root.sampled),
                        span_id=root.span_id, attrs={"prompt_tokens": 7}))
    out.append(t.record("queue", 1.0, 1.5, ctx=root))
    out.append(t.record("prefill", 1.5, 2.0, ctx=root.to_wire(),
                        attrs={"prefix_hit": False}))
    for i in range(6):
        out.append(t.record(f"decode_step{i}", 2.0 + i, 2.5 + i))
    return out


def _strip(span):
    span = dict(span)
    span.pop("tid")  # the recording thread
    return span


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.0])
def test_sampling_and_spans_match_the_reference(rate, monkeypatch, tmp_path):
    got, ring, files = [], [], []
    for mod in (jtracing, ttracing):
        path = str(tmp_path / f"{mod.__name__}.json")
        t = _pinned(mod, monkeypatch, dict(sample_rate=rate, ring_events=5,
                                           export_path=path))
        got.append([_strip(s) for s in _drive(mod, t)])
        ring.append([_strip(s) for s in t.flight_snapshot()])
        t.close()
        files.append(path)
    assert got[1] == got[0]
    assert ring[1] == ring[0] and len(ring[1]) == 5  # the ring's bound
    if rate == 0.0:
        assert not any(os.path.exists(p) for p in files)
        return
    # each package reads the other's export
    for reader in (jtracing, ttracing):
        events = [reader.load_chrome_trace(p) for p in files]
        for e in events:
            for x in e:
                x.pop("tid")
        assert events[1] == events[0]
    sampled = [s["name"] for s in got[1] if s["sampled"]]
    assert [e["name"] for e in ttracing.load_chrome_trace(files[1])] == \
        sampled
    if rate == 1.0:
        assert len(sampled) == 9


def test_child_of_parents_and_the_wire_form_round_trips():
    t = ttracing.SpanTracer(ring_events=16)
    root = t.child_of(None)
    child = t.record("child", 1.0, 2.0, ctx=root)
    assert child["trace_id"] == root.trace_id
    assert child["parent_id"] == root.span_id
    assert child["dur_ms"] == pytest.approx(1000.0)
    closed = t.record("root", 0.5, 3.0,
                      ctx=ttracing.TraceContext(root.trace_id, None,
                                                root.sampled),
                      span_id=root.span_id)
    assert closed["span_id"] == root.span_id and closed["parent_id"] is None
    grand = t.child_of(t.child_of(root).to_wire())
    assert grand.trace_id == root.trace_id and grand.sampled == root.sampled
    ctx = ttracing.TraceContext("t" * 16, "s" * 16, sampled=False)
    back = ttracing.TraceContext.from_wire(json.loads(json.dumps(
        ctx.to_wire())))
    assert (back.trace_id, back.span_id, back.sampled) == (
        ctx.trace_id, ctx.span_id, False)
    assert ttracing.TraceContext.from_wire({"junk": 1}) is None
    # the JAX package's wire form is the same dict
    jctx = jtracing.TraceContext("t" * 16, "s" * 16, sampled=False)
    assert jctx.to_wire() == ctx.to_wire()


def test_span_context_manager_records_the_block_and_errors():
    t = ttracing.SpanTracer(ring_events=16)
    with t.span("blk", attrs={"a": 1}) as h:
        h.set_attr("b", 2)
    with pytest.raises(KeyError):
        with t.span("bad"):
            raise KeyError("x")
    blk, bad = t.flight_snapshot()
    assert blk["name"] == "blk" and blk["attrs"] == {"a": 1, "b": 2}
    assert bad["attrs"]["error"] == "KeyError('x')"


def test_ring_keeps_the_newest_in_order():
    t = ttracing.SpanTracer(ring_events=4, sample_rate=0.0)
    for i in range(10):
        t.record(f"s{i}", 0.0, 1.0)
    assert [s["name"] for s in t.flight_snapshot()] == [
        "s6", "s7", "s8", "s9"]


def test_ingest_adopts_foreign_pids_only_and_drain_takes_the_batch():
    t = ttracing.SpanTracer(ring_events=8, flush_every=1000)
    mine = t.record("local", 0.0, 1.0)
    foreign = dict(mine, pid=mine["pid"] + 1, name="remote")
    unsampled = dict(foreign, name="quiet", sampled=False)
    assert t.ingest([mine, foreign, unsampled, "junk", None]) == 2
    assert [s["name"] for s in t.flight_snapshot()] == [
        "local", "remote", "quiet"]
    assert [s["name"] for s in t.drain_sampled()] == ["local", "remote"]
    assert t.drain_sampled() == []
    # a span the JAX package recorded in another process is adopted too
    j = jtracing.SpanTracer(ring_events=4).record("jax_side", 0.0, 1.0)
    j["pid"] = mine["pid"] + 2
    assert t.ingest([j]) == 1


def test_flight_dump_is_a_complete_chrome_trace_both_loaders_read(tmp_path):
    t = ttracing.SpanTracer(ring_events=8, dump_dir=str(tmp_path))
    ctx = t.child_of(None)
    t.record("a", 0.0, 1.0, ctx=ctx)
    t.event("boom", attrs={"reason": "test"}, ctx=ctx)
    path = t.dump_flight("unit_test", extra={"k": "v"})
    payload = json.load(open(path))
    assert [e["name"] for e in payload["traceEvents"]] == ["a", "boom"]
    assert payload["metadata"]["reason"] == "unit_test"
    assert payload["metadata"]["k"] == "v"
    assert "suppressed_errors" in payload["metadata"]
    for loader in (jtracing.load_chrome_trace, ttracing.load_chrome_trace):
        events = loader(path)
        assert [e["ph"] for e in events] == ["X", "i"]
    assert t.dump_flight("unit_test") != path


def test_an_unterminated_export_still_loads(tmp_path):
    """A process that dies mid-run leaves the array open; both loaders
    take it. Timestamps are microseconds."""
    path = str(tmp_path / "trace.json")
    t = ttracing.SpanTracer(export_path=path, flush_every=1)
    t.record("s", 2.0, 2.5)
    t.flush()
    for loader in (jtracing.load_chrome_trace, ttracing.load_chrome_trace):
        (e,) = loader(path)
        assert e["dur"] == pytest.approx(500000.0)
        assert e["ts"] == pytest.approx((2.0 + t._mono_offset) * 1e6)
    t.close()
    assert len(json.load(open(path))) == 2  # the event and the null sentinel


def test_noop_tracer_is_a_zero_overhead_passthrough():
    noop = ttracing.NOOP_TRACER
    assert noop.enabled is False
    cm = noop.span("anything")
    assert cm is noop.span("something else")
    with cm as h:
        h.set_attr("ignored", 1)
    assert noop.record("x", 0.0, 1.0) is None
    assert noop.child_of(None) is None
    assert noop.dump_flight("nope") is None
    assert noop.flight_snapshot() == [] and noop.drain_sampled() == []
    assert noop.ingest([{"pid": 1}]) == 0
    assert Telemetry(enabled=False).tracer is noop


@pytest.mark.parametrize("telemetry", [
    None,
    {"enabled": True},
    {"enabled": False, "tracing": {"enabled": True}},
    {"enabled": True, "tracing": {"enabled": True}},
    {"enabled": True, "tracing": {"enabled": True, "sample_rate": 0.5,
                                  "ring_events": 99}},
    {"enabled": True, "job_name": "j",
     "tracing": {"enabled": True, "export": "none"}},
])
def test_build_tracer_from_the_same_config_dicts(telemetry, tmp_path):
    param = {"train_batch_size": 1}
    if telemetry is not None:
        param["telemetry"] = dict(telemetry, output_path=str(tmp_path))
    jt = jtracing.build_tracer(deepspeed_tpu.DeepSpeedConfig(
        None, param_dict=param, world_size=1))
    tt = ttracing.build_tracer(DeepSpeedConfig(
        None, param_dict=param, world_size=1))
    assert jt.enabled == tt.enabled
    if not tt.enabled:
        assert tt is ttracing.NOOP_TRACER
        return
    for attr in ("sample_rate", "ring_events", "export_path", "dump_dir"):
        assert getattr(tt, attr) == getattr(jt, attr), attr
    jt.close()
    tt.close()


def test_rejected_sample_rate_and_ring():
    for kw in ({"sample_rate": 1.5}, {"ring_events": 0}):
        with pytest.raises(ValueError):
            ttracing.SpanTracer(**kw)
