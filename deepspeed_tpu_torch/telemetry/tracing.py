"""Request and step tracing, and the always-on flight recorder.

Port of deepspeed_tpu/telemetry/tracing.py. A lock-cheap
:class:`SpanTracer` records (trace_id, span_id, parent) spans with
monotonic t0/t1 and free-form attributes; :class:`TraceContext` carries
a position across threads and processes as a plain dict (``to_wire`` /
``from_wire``). The port's integration points are the serving scheduler
(queue, prefill, decode-step and request spans, with the same names and
attributes as the JAX scheduler's) and the training engine's telemetry
(``train.window`` spans). Finished spans export as Chrome trace-event
JSON (``trace.json``, which Perfetto opens) beside the metric sinks.

Two consumers with different retention:

- **export buffer**: finished spans whose trace was SAMPLED
  (``sample_rate``) flush to ``trace.json`` in the telemetry output
  directory. Volume control for production.
- **flight recorder**: a bounded ring (``ring_events``) that records
  EVERY finished span and instant event regardless of sampling, dumped
  as a complete Chrome trace on watchdog stall reports and decode-driver
  crashes, i.e. exactly when someone starts debugging.

Tracing disabled is a zero-overhead passthrough: every integration point
holds :data:`NOOP_TRACER`, whose ``span()`` returns one shared no-op
context manager and whose ``record()`` is a bare ``return None``; the
hot paths pay a single attribute check (``tracer.enabled``).

Timestamps: callers pass ``time.monotonic()`` instants; each tracer
converts to wall-clock at record time via a per-process offset, so spans
from several processes land on one comparable timeline. Chrome traces
are in microseconds.
"""

import collections
import json
import os
import random
import threading
import time
import uuid

from ..utils.logging import logger
from .registry import count_suppressed, suppressed_errors_snapshot


def _new_id():
    """16-hex random id (trace and span ids share the generator)."""
    return uuid.uuid4().hex[:16]


class TraceContext:
    """Propagatable trace position: ``trace_id`` names the request's
    whole tree, ``span_id`` the node children parent to, ``sampled``
    whether the export buffer wants the tree (the flight-recorder ring
    takes it either way). ``to_wire()``/``from_wire()`` round-trip a
    plain JSON-safe dict — the RPC propagation format."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id, span_id=None, sampled=True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    def to_wire(self):
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "sampled": self.sampled,
        }

    @classmethod
    def from_wire(cls, obj):
        """None / TraceContext / wire dict -> TraceContext or None."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, dict) and obj.get("trace_id"):
            return cls(
                obj["trace_id"], obj.get("span_id"),
                obj.get("sampled", True),
            )
        return None

    def __repr__(self):
        return (
            f"TraceContext({self.trace_id}, {self.span_id}, "
            f"sampled={self.sampled})"
        )


class _SpanHandle:
    """Context manager returned by :meth:`SpanTracer.span`: times the
    block, records on exit, exposes ``ctx`` for children and
    ``set_attr`` for results discovered mid-block."""

    __slots__ = ("_tracer", "_name", "_parent", "_attrs", "_t0", "ctx")

    def __init__(self, tracer, name, parent, attrs):
        self._tracer = tracer
        self._name = name
        self._parent = parent
        self._attrs = dict(attrs) if attrs else {}
        self._t0 = None
        self.ctx = tracer.child_of(parent)

    def set_attr(self, key, value):
        self._attrs[key] = value

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._attrs.setdefault("error", repr(exc))
        self._tracer.record(
            self._name, self._t0, time.monotonic(),
            ctx=self._parent
            or TraceContext(self.ctx.trace_id, None, self.ctx.sampled),
            span_id=self.ctx.span_id, attrs=self._attrs,
        )
        return False


class _NoopSpan:
    """The one shared disabled-tracing context manager (identity pinned
    by the zero-overhead test): stateless, reentrant, allocation-free."""

    __slots__ = ()
    ctx = None

    def set_attr(self, key, value):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Disabled tracing: every method is a constant-time no-op and the
    integration points see ``enabled == False`` before doing any work.
    One process-wide instance (:data:`NOOP_TRACER`)."""

    enabled = False

    def record(self, name, t0, t1, ctx=None, attrs=None, span_id=None):
        return None

    def span(self, name, ctx=None, attrs=None):
        return _NOOP_SPAN

    def child_of(self, ctx):
        return None

    def event(self, name, attrs=None):
        return None

    def ingest(self, spans):
        return 0

    def drain_sampled(self):
        return []

    def flight_snapshot(self):
        return []

    def dump_flight(self, reason, extra=None):
        return None

    def flush(self):
        pass

    def close(self):
        pass


NOOP_TRACER = NoopTracer()


class SpanTracer:
    """The enabled tracer. Thread-safety: span records happen on router
    submit threads, scheduler driver threads, staging workers, and the
    watchdog's polling thread — the ring is a deque (atomic appends) and
    the export buffer takes one short lock per record; no span ever
    blocks on I/O except at explicit flush boundaries."""

    enabled = True

    def __init__(self, sample_rate=1.0, ring_events=512, export_path=None,
                 dump_dir=None, flush_every=256, rng=None):
        if not 0.0 <= float(sample_rate) <= 1.0:
            raise ValueError(
                f"sample_rate must be within [0, 1], got {sample_rate!r}"
            )
        if int(ring_events) < 1:
            raise ValueError(
                f"ring_events must be >= 1, got {ring_events!r}"
            )
        self.sample_rate = float(sample_rate)
        self.ring_events = int(ring_events)
        self.export_path = export_path
        self.dump_dir = dump_dir or (
            os.path.dirname(export_path) if export_path else None
        )
        self._ring = collections.deque(maxlen=self.ring_events)
        self._pending = []
        self._lock = threading.Lock()
        self._flush_every = max(1, int(flush_every))
        self._rng = rng or random.Random()
        self._pid = os.getpid()
        # monotonic -> wall-clock translation (per process, fixed at
        # construction): wall clocks agree across a host's processes,
        # monotonic clocks do not
        self._mono_offset = time.time() - time.monotonic()
        self._file = None
        self._dump_seq = 0
        self._closed = False

    # -- context ---------------------------------------------------------
    def _sample(self):
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        return self._rng.random() < self.sample_rate

    def child_of(self, ctx):
        """A fresh context UNDER ``ctx`` (its span_id pre-allocated, so
        the owning span can be recorded retroactively once its t1 is
        known, while children parent to it in the meantime). ``ctx``
        None starts a new trace, rolling the sampling dice."""
        ctx = TraceContext.from_wire(ctx)
        if ctx is None:
            return TraceContext(_new_id(), _new_id(), self._sample())
        return TraceContext(ctx.trace_id, _new_id(), ctx.sampled)

    # -- recording -------------------------------------------------------
    def record(self, name, t0, t1, ctx=None, attrs=None, span_id=None):
        """Record one finished span: ``t0``/``t1`` are monotonic seconds,
        ``ctx`` the PARENT context (None = new root trace), ``span_id``
        overrides the generated id (how a pre-allocated request span
        closes). Returns the span dict (always ring-buffered; appended
        to the export buffer only when the trace is sampled)."""
        ctx = TraceContext.from_wire(ctx)
        if ctx is None:
            trace_id, parent_id, sampled = _new_id(), None, self._sample()
        else:
            trace_id, parent_id, sampled = (
                ctx.trace_id, ctx.span_id, ctx.sampled
            )
        span = {
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id or _new_id(),
            "parent_id": parent_id,
            "ts": float(t0) + self._mono_offset,
            "dur_ms": max(float(t1) - float(t0), 0.0) * 1e3,
            "pid": self._pid,
            "tid": threading.get_ident(),
            "attrs": dict(attrs) if attrs else {},
            "sampled": bool(sampled),
        }
        self._ring.append(span)
        if sampled:
            with self._lock:
                self._pending.append(span)
                want_flush = len(self._pending) >= self._flush_every
            if want_flush:
                self.flush()
        return span

    def span(self, name, ctx=None, attrs=None):
        """Context-manager form for block-shaped phases (checkpoint
        commits, rollbacks): times the block and records at exit."""
        return _SpanHandle(self, name, TraceContext.from_wire(ctx), attrs)

    def event(self, name, attrs=None, ctx=None):
        """Instant event (admission verdicts, rejections, crashes):
        flight-recorder ring only — events are debugging breadcrumbs,
        not latency spans, so they skip the export buffer."""
        ctx = TraceContext.from_wire(ctx)
        evt = {
            "name": name,
            "trace_id": ctx.trace_id if ctx else None,
            "span_id": None,
            "parent_id": ctx.span_id if ctx else None,
            "ts": time.time(),
            "dur_ms": None,
            "pid": self._pid,
            "tid": threading.get_ident(),
            "attrs": dict(attrs) if attrs else {},
            "sampled": False,
        }
        self._ring.append(evt)
        return evt

    def ingest(self, spans):
        """Adopt finished spans recorded in ANOTHER process (a worker's
        per-request spans shipped back over the RPC) into this tracer's
        ring + export buffer, so one trace file holds the whole fleet
        request. Same-pid spans are skipped — they were recorded here
        already (the in-process replica path shares the tracer)."""
        n = 0
        for span in spans or ():
            if not isinstance(span, dict) or span.get("pid") == self._pid:
                continue
            self._ring.append(span)
            if span.get("sampled"):
                with self._lock:
                    self._pending.append(span)
            n += 1
        return n

    def drain_sampled(self):
        """Atomically take the sampled-span batch accumulated since the
        last flush/drain — the node agent's ``drain_telemetry`` reply
        body. A tracer with no ``export_path`` (node agents export
        nothing locally; the hub ships spans home instead) would
        otherwise discard the batch at its next auto-flush, so node
        tracers pair this with a large ``flush_every``. Returns the
        spans oldest first; the flight-recorder ring is untouched."""
        with self._lock:
            batch, self._pending = self._pending, []
        return batch

    # -- flight recorder -------------------------------------------------
    def flight_snapshot(self):
        """The ring's current contents, oldest first (bounded at
        ``ring_events``; older spans were overwritten)."""
        return list(self._ring)

    def dump_flight(self, reason, extra=None):
        """Dump the ring as a complete Chrome trace file (plus the
        suppressed-errors diagnostics registry — the swallowed
        exceptions surface at exactly the moment someone is debugging a
        stall). Returns the dump path, or None when no dump directory is
        configured (the summary still logs)."""
        snapshot = self.flight_snapshot()
        suppressed = suppressed_errors_snapshot()
        path = None
        if self.dump_dir:
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                self._dump_seq += 1
                path = os.path.join(
                    self.dump_dir,
                    f"flight-{reason}-{self._dump_seq}.trace.json",
                )
                payload = {
                    "traceEvents": [_chrome_event(s) for s in snapshot],
                    "metadata": {
                        "reason": reason,
                        "suppressed_errors": suppressed,
                        **(dict(extra) if extra else {}),
                    },
                }
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, path)
            except OSError as e:
                count_suppressed("tracing.flight_dump", e)
                path = None
        logger.error(
            "FLIGHT RECORDER dump (%s): %d spans/events -> %s; "
            "suppressed errors: %s",
            reason, len(snapshot), path or "<no dump dir>",
            suppressed or "none",
        )
        return path

    # -- export ----------------------------------------------------------
    def flush(self):
        """Append the sampled spans accumulated since the last flush to
        the Chrome trace file (Perfetto's 'JSON Array Format' tolerates
        the unterminated array, so a crash mid-run still leaves a
        loadable trace; close() writes the closing bracket)."""
        with self._lock:
            if not self._pending:
                return
            batch, self._pending = self._pending, []
            if self.export_path is None or self._closed:
                return
            try:
                if self._file is None:
                    d = os.path.dirname(self.export_path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    self._file = open(self.export_path, "w")
                    self._file.write("[\n")
                for span in batch:
                    self._file.write(json.dumps(_chrome_event(span)) + ",\n")
                self._file.flush()
            except OSError as e:
                count_suppressed("tracing.flush", e)

    def close(self):
        self.flush()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._file is not None:
                try:
                    # the trailing comma before ']' is tolerated by both
                    # json5-style readers and Perfetto; emit a null
                    # sentinel so strict json.loads works too
                    self._file.write("null\n]\n")
                    self._file.close()
                except OSError as e:
                    count_suppressed("tracing.close", e)
                self._file = None


def _chrome_event(span):
    """Span/event dict -> one Chrome trace-event object. Spans map to
    'X' (complete) events; instant events (dur_ms None) map to 'i'. The
    trace/span/parent ids ride ``args`` so a Perfetto query (or the
    bench's trace walker) can reconstruct the tree."""
    args = {
        "trace_id": span.get("trace_id"),
        "span_id": span.get("span_id"),
        "parent_id": span.get("parent_id"),
    }
    args.update(span.get("attrs") or {})
    evt = {
        "name": span.get("name"),
        "cat": "span" if span.get("dur_ms") is not None else "event",
        "ph": "X" if span.get("dur_ms") is not None else "i",
        "ts": float(span.get("ts", 0.0)) * 1e6,
        "pid": span.get("pid", 0),
        "tid": span.get("tid", 0),
        "args": args,
    }
    if span.get("dur_ms") is not None:
        evt["dur"] = float(span["dur_ms"]) * 1e3
    else:
        evt["s"] = "p"  # instant-event scope: process
    return evt


def load_chrome_trace(path):
    """Parse a trace file written by :meth:`SpanTracer.flush`/``close``
    (or a flight dump): returns the list of event dicts. Tolerates the
    unterminated-array form a crashed process leaves behind."""
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("{"):
        return json.loads(text)["traceEvents"]
    if not text.endswith("]"):
        text = text.rstrip().rstrip(",") + "\n]"
    return [e for e in json.loads(text) if e is not None]


def build_tracer(config, out_dir=None):
    """Construct the process's tracer from a validated DeepSpeedConfig's
    ``telemetry.tracing`` block; :data:`NOOP_TRACER` (the zero-overhead
    passthrough) unless the block — and telemetry itself — is enabled.
    ``out_dir`` defaults to the telemetry output directory, so
    ``trace.json`` and the flight dumps land beside the metric sinks."""
    if not getattr(config, "telemetry_tracing_enabled", False):
        return NOOP_TRACER
    if out_dir is None:
        base = config.telemetry_output_path or os.path.join(
            os.path.expanduser("~"), "telemetry"
        )
        out_dir = os.path.join(base, config.telemetry_job_name)
    os.makedirs(out_dir, exist_ok=True)
    export_path = None
    if config.telemetry_tracing_export == "chrome":
        export_path = os.path.join(out_dir, "trace.json")
    return SpanTracer(
        sample_rate=config.telemetry_tracing_sample_rate,
        ring_events=config.telemetry_tracing_ring_events,
        export_path=export_path,
        dump_dir=out_dir,
    )
