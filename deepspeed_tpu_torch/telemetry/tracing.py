"""Request-trace context and the disabled tracer.

Port of the part of deepspeed_tpu/telemetry/tracing.py that the
scheduler reaches with tracing off: :class:`TraceContext`, the
propagatable (trace_id, span_id, sampled) position a request may carry
in through ``submit(trace_ctx=...)``, and :data:`NOOP_TRACER`, whose
methods are constant-time no-ops behind one ``tracer.enabled`` check.
The engine refuses an enabled telemetry block, so the recording tracer
and its Chrome-trace export are not ported yet.
"""


class TraceContext:
    """Propagatable trace position: ``trace_id`` names the request's
    whole tree, ``span_id`` the node children parent to, ``sampled``
    whether the export buffer wants the tree. ``to_wire()``/``from_wire()``
    round-trip a plain JSON-safe dict — the RPC propagation format."""

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


class NoopTracer:
    """Disabled tracing: every method the scheduler calls is a
    constant-time no-op, and the scheduler sees ``enabled == False``
    before doing any work. One process-wide instance
    (:data:`NOOP_TRACER`)."""

    enabled = False

    def record(self, name, t0, t1, ctx=None, attrs=None, span_id=None):
        return None

    def child_of(self, ctx):
        return None

    def event(self, name, attrs=None):
        return None

    def dump_flight(self, reason, extra=None):
        return None


NOOP_TRACER = NoopTracer()
