"""Fixed-size in-memory time series: the retention layer under the
telemetry hub.

Port of deepspeed_tpu/telemetry/timeseries.py.

One :class:`TimeSeriesStore` holds a bounded ring of ``(wall_ts, value)``
points per series name (the Borgmon/Prometheus in-memory model at fleet
scale 1 — PAPERS.md): the hub appends one point per scrape for every
scalar it sees (router registry and remote ``{node, replica}`` series
alike), and the sliding-window queries here back everything time-shaped
the observability plane serves — ``/statz`` burn-rate windows, dashboard
sparklines, the alert evaluator's fast/slow SLO windows, and the
autoscaler's observed-arrival-rate read.

Deliberately tiny and dependency-free: a dict of deques behind one lock,
O(retention) memory per series, no interpolation, no persistence. A real
TSDB is a non-goal; surviving a router restart is what the Prometheus
textfile sink is for.
"""

import collections
import threading
import time


class SeriesRing:
    """One series: a bounded deque of ``(ts, value)`` points, oldest
    first. Appends are amortized O(1); the deque's maxlen evicts the
    oldest point once retention fills."""

    __slots__ = ("points",)

    def __init__(self, retention_points):
        self.points = collections.deque(maxlen=int(retention_points))

    def append(self, ts, value):
        self.points.append((float(ts), float(value)))

    def window(self, window_secs, now):
        """Points with ``ts >= now - window_secs``, oldest first."""
        horizon = float(now) - float(window_secs)
        return [(t, v) for t, v in self.points if t >= horizon]


class TimeSeriesStore:
    """Thread-safe map of series name -> :class:`SeriesRing`.

    ``retention_points`` bounds every ring (config:
    ``serving.hub.retention_points``); with the hub's scrape cadence
    that is the retention *duration* — 512 points at a 2s cadence is
    ~17 minutes of history, enough for a 10-minute slow burn window.
    """

    def __init__(self, retention_points=512, clock=time.time):
        if int(retention_points) < 2:
            raise ValueError(
                f"retention_points must be >= 2, got {retention_points!r}"
            )
        self.retention_points = int(retention_points)
        self._clock = clock
        self._lock = threading.Lock()
        self._series = {}

    def __len__(self):
        with self._lock:
            return len(self._series)

    def names(self, prefix=""):
        with self._lock:
            return sorted(k for k in self._series if k.startswith(prefix))

    def record(self, name, value, now=None):
        """Append one point to ``name``'s ring (creating it on first
        sight)."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                ring = self._series[name] = SeriesRing(self.retention_points)
            ring.append(now, value)

    def record_many(self, items, now=None):
        """Append ``{name: value}`` (or an iterable of pairs) with one
        shared timestamp — one scrape's worth of samples."""
        now = self._clock() if now is None else float(now)
        pairs = items.items() if isinstance(items, dict) else items
        with self._lock:
            for name, value in pairs:
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = SeriesRing(
                        self.retention_points
                    )
                ring.append(now, value)

    def latest(self, name):
        """Most recent ``(ts, value)`` point, or None for an unknown or
        empty series."""
        with self._lock:
            ring = self._series.get(name)
            if ring is None or not ring.points:
                return None
            return ring.points[-1]

    def window(self, name, window_secs, now=None):
        """Points of ``name`` within the trailing window, oldest first
        (empty list for unknown series)."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                return []
            return ring.window(window_secs, now)

    def window_delta(self, name, window_secs, now=None):
        """``last - first`` over the trailing window — the counter
        increase (clamped at 0 so a counter reset reads as "no growth",
        not negative growth). None when the window holds < 2 points."""
        pts = self.window(name, window_secs, now)
        if len(pts) < 2:
            return None
        return max(pts[-1][1] - pts[0][1], 0.0)

    def window_rate(self, name, window_secs, now=None):
        """Counter rate over the trailing window:
        ``(last - first) / (t_last - t_first)`` per second, the
        Prometheus ``rate()`` estimate without extrapolation. None when
        the window holds < 2 points or they share a timestamp."""
        pts = self.window(name, window_secs, now)
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return max(pts[-1][1] - pts[0][1], 0.0) / dt

    def window_stats(self, name, window_secs, now=None):
        """``{count, min, max, last}`` of the raw points in the window
        (gauge-shaped summary for /statz); None when the window is
        empty."""
        pts = self.window(name, window_secs, now)
        if not pts:
            return None
        values = [v for _, v in pts]
        return {
            "count": len(values),
            "min": min(values),
            "max": max(values),
            "last": values[-1],
        }

    def sparkline(self, name, points=32):
        """The most recent ``points`` values of ``name`` (oldest first)
        — the dashboard's sparkline feed."""
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                return []
            tail = list(ring.points)[-int(points):]
        return [v for _, v in tail]
