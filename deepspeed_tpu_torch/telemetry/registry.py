"""Process-local metrics core: counters, gauges, fixed-bucket histograms.

The registry is the single source of truth for every telemetry stream the
engine emits; exporters (exporters.py) serialize point-in-time views of it.
Prometheus's data-model conventions are followed (monotonic counters,
cumulative histogram buckets with a +Inf catch-all) so the textfile
exporter is a direct mapping, but nothing here imports a metrics client —
the registry is a few dicts behind one lock, cheap enough to update from
the training loop's host thread and safe to snapshot from the watchdog
thread.

Metric names use ``component/metric_name`` form (e.g. ``train/loss``);
exporters that need a flat charset (Prometheus) sanitize on their side.
"""

import threading
import time

from ..utils.logging import logger


# Default histogram thresholds for per-window wall times, in milliseconds.
# Spans sub-10ms fused CPU windows to the minute-scale compiles that
# precede step 1; +Inf is implicit.
DEFAULT_TIME_BUCKETS_MS = (
    5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)


class Counter:
    """Monotonically non-decreasing count."""

    kind = "counter"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, n=1.0):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Point-in-time value; may move in either direction."""

    kind = "gauge"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, value):
        self._value = float(value)

    def inc(self, n=1.0):
        self._value += n

    @property
    def value(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram: per-bucket counts plus sum/count.

    ``buckets`` are upper-bound thresholds (ascending); an implicit +Inf
    bucket catches everything above the last threshold. ``bucket_counts``
    are NON-cumulative per-bucket counts; exporters compute the cumulative
    form Prometheus wants.

    ``observe(value, trace_id=...)`` additionally records an OpenMetrics
    EXEMPLAR for the value's bucket — the link from a latency histogram
    to the distributed trace that produced the observation
    (docs/observability.md "Request tracing & flight recorder"): the
    request tracer passes the active trace_id, and "what request landed
    in the p99 bucket" becomes a trace lookup instead of a guess.
    """

    kind = "histogram"

    def __init__(self, name, buckets, help=""):
        thresholds = tuple(float(b) for b in buckets)
        if not thresholds or list(thresholds) != sorted(thresholds):
            raise ValueError(
                f"histogram {name} buckets must be non-empty ascending, "
                f"got {buckets!r}"
            )
        self.name = name
        self.help = help
        self.thresholds = thresholds
        self._counts = [0] * (len(thresholds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._exemplars = {}  # bucket index -> (value, trace_id, unix ts)

    def observe(self, value, trace_id=None):
        v = float(value)
        self._sum += v
        self._count += 1
        for i, t in enumerate(self.thresholds):
            if v <= t:
                self._counts[i] += 1
                if trace_id is not None:
                    self._exemplars[i] = (v, str(trace_id), time.time())
                return
        self._counts[-1] += 1
        if trace_id is not None:
            self._exemplars[len(self.thresholds)] = (
                v, str(trace_id), time.time()
            )

    @property
    def exemplars(self):
        """``{bucket index: (value, trace_id, unix_ts)}`` — the last
        traced observation per bucket (the +Inf bucket is index
        ``len(thresholds)``)."""
        return dict(self._exemplars)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def bucket_counts(self):
        return tuple(self._counts)


def histogram_quantile(hist, q):
    """Linear-interpolated quantile from a fixed-bucket :class:`Histogram`
    (the Prometheus ``histogram_quantile`` estimate). 0.0 with no
    observations; observations in the +Inf bucket clamp to the last
    finite edge. Shared by the fleet router's TTFT p50/p99 gauges and
    ``bench.py --infer``'s p99 token latency."""
    counts = hist.bucket_counts
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    cumulative = 0
    lower = 0.0
    for i, upper in enumerate(hist.thresholds):
        prev = cumulative
        cumulative += counts[i]
        if cumulative >= rank:
            frac = (rank - prev) / max(counts[i], 1)
            return lower + (upper - lower) * frac
        lower = upper
    return hist.thresholds[-1]  # +Inf bucket: clamp to the last edge


class MetricsRegistry:
    """Thread-safe get-or-create registry of the three instrument kinds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, cls, name, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, requested {cls.kind}"
                    )
                return existing
            metric = cls(name, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help=help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help=help)

    def histogram(self, name, buckets=DEFAULT_TIME_BUCKETS_MS, help=""):
        return self._get_or_create(Histogram, name, buckets=buckets, help=help)

    def remove_prefix(self, prefix):
        """Retire every metric whose name starts with ``prefix`` —
        the fleet router's per-replica gauge cleanup when a replica is
        evicted or scaled away (docs/serving.md): a dead replica's
        ``fleet/replica{i}/*`` streams must stop exporting their stale
        last values, not freeze at them forever. Returns the retired
        names. Callers holding a retired instrument object keep a live
        (but orphaned) handle; re-registering the name mints a fresh
        zeroed instrument."""
        with self._lock:
            dead = [k for k in self._metrics if k.startswith(prefix)]
            for k in dead:
                del self._metrics[k]
        return dead

    def collect(self):
        """Consistent point-in-time list of live metric objects, sorted by
        name (exporters iterate this under no lock — instruments are only
        ever mutated by simple attribute writes, and a slightly torn
        histogram view is acceptable for monitoring output)."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self):
        """Flat ``{name: value}`` scalar view (histograms contribute
        ``name/count`` and ``name/sum``) — the watchdog's stall report and
        tests read this."""
        out = {}
        for m in self.collect():
            if m.kind == "histogram":
                out[m.name + "/count"] = m.count
                out[m.name + "/sum"] = m.sum
            else:
                out[m.name] = m.value
        return out


def metric_to_wire(m):
    """One instrument -> a JSON-safe dict (the ``metrics_snapshot``
    control-op payload and the telemetry hub's internal sample form).
    Scalars carry ``value``; histograms carry thresholds, NON-cumulative
    bucket counts, sum/count, and exemplars keyed by stringified bucket
    index (JSON objects cannot key on ints)."""
    if m.kind == "histogram":
        entry = {
            "name": m.name,
            "kind": "histogram",
            "help": m.help,
            "count": int(m.count),
            "sum": float(m.sum),
            "thresholds": list(m.thresholds),
            "bucket_counts": list(m.bucket_counts),
        }
        exemplars = getattr(m, "exemplars", None)
        if exemplars:
            entry["exemplars"] = {
                str(i): [float(e[0]), str(e[1]), float(e[2])]
                for i, e in exemplars.items()
            }
        return entry
    return {"name": m.name, "kind": m.kind, "help": m.help,
            "value": float(m.value)}


def wire_snapshot(registry):
    """The whole registry as a list of :func:`metric_to_wire` dicts,
    sorted by name — what a node agent returns for the hub's
    ``metrics_snapshot`` scrape. Safe to call concurrently with
    ``remove_prefix`` (``collect()`` takes the registry lock for the
    key list; instrument reads after that are lock-free attribute
    loads, and a retired instrument stays readable through the held
    reference)."""
    return [metric_to_wire(m) for m in registry.collect()]


def wire_scalars(entries):
    """Flatten wire entries into the registry's ``snapshot()`` scalar
    form (histograms -> ``name/count`` + ``name/sum``) — what the hub
    feeds its time-series rings."""
    out = {}
    for e in entries:
        if e.get("kind") == "histogram":
            out[e["name"] + "/count"] = float(e.get("count", 0))
            out[e["name"] + "/sum"] = float(e.get("sum", 0.0))
        else:
            out[e["name"]] = float(e.get("value", 0.0))
    return out


class WireHistogram:
    """Read-only :class:`Histogram` facade over a wire dict — gives
    :func:`histogram_quantile` (and anything else duck-typed on the
    instrument attributes) a remote histogram to chew on."""

    kind = "histogram"

    def __init__(self, entry):
        self.name = entry.get("name", "")
        self.help = entry.get("help", "")
        self.thresholds = tuple(
            float(t) for t in entry.get("thresholds", ())
        )
        self._counts = tuple(
            int(c) for c in entry.get("bucket_counts", ())
        )
        self._sum = float(entry.get("sum", 0.0))
        self._count = int(entry.get("count", 0))

    @property
    def bucket_counts(self):
        return self._counts

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum


# ---------------------------------------------------------------------------
# Suppressed-error accounting: best-effort probe paths deliberately
# swallow failures — but NEVER silently (the no-silent-swallows audit,
# docs/resilience.md). Each swallow debug-logs and counts here, on a
# process-global diagnostics registry that exists before any engine or
# telemetry block does, so "how often does this probe fail" is
# answerable from counters instead of grep.
# ---------------------------------------------------------------------------
_DIAGNOSTICS = MetricsRegistry()


def diagnostics_registry():
    """The process-global internal-health registry (suppressed-error
    counters); readable by tests and stall reports without any engine."""
    return _DIAGNOSTICS


def suppressed_errors_snapshot():
    """Nonzero suppressed-error counters as ``{name: count}`` — what
    stall reports, supervisor escalations, and flight-recorder dumps
    attach (empty dict = no swallows so far)."""
    return {k: v for k, v in _DIAGNOSTICS.snapshot().items() if v}


def count_suppressed(site, exc=None):
    """Account one deliberately swallowed exception at ``site``: a debug
    log plus a total and a per-site counter. Call this from every
    broad-except that intentionally continues — a swallow with no counter
    is invisible exactly when it starts happening every step."""
    logger.debug("suppressed error at %s: %r", site, exc)
    _DIAGNOSTICS.counter(
        "internal/suppressed_errors",
        help="deliberately swallowed exceptions across best-effort paths",
    ).inc()
    _DIAGNOSTICS.counter(f"internal/suppressed_errors/{site}").inc()


# The JAX package's recompile and persistent-compile-cache hooks
# (jax.monitoring listeners) have no counterpart here: PyTorch runs
# eagerly and the CUDA kernels are built once per process.
