"""Per-replica circuit breakers for the fleet router (docs/serving.md).

Port of deepspeed_tpu/serving/breaker.py: the same states, windows and
jitter (a numpy generator seeded by the replica id's crc32), so a seeded
run backs off through the same sequence of windows in both packages.

A replica whose RPC surface starts failing (pipe corruption, worker
hangs, ack timeouts) must stop costing the router a doomed submit — and
a burned re-route — on every placement. The classic three-state breaker:

    CLOSED     every request flows; ``failure_threshold`` CONSECUTIVE
               RPC failures trip it open (any success resets the count —
               a replica that answers, even with a healthy rejection,
               is not broken).
    OPEN       the replica drops out of every placement policy's
               candidate set. The open window backs off exponentially
               (``backoff_secs * 2^(opens-1)``, capped at
               ``backoff_max_secs``) with deterministic jitter so a
               whole fleet's breakers never probe in lockstep.
    HALF_OPEN  when the window elapses, exactly ONE probe request is
               allowed through (``allow_request`` hands out a single
               ticket per window). Probe success closes the breaker —
               the replica rejoins with its affinity and adapter state
               untouched, because the router never evicted it. Probe
               failure re-opens with a doubled window.

The breaker is router-side state fed by router-observed outcomes: it
never talks to the replica itself, so it works identically over both
backends. Jitter draws from a generator seeded by the replica id —
breaker behavior under a seeded chaos schedule reproduces exactly.
"""

import threading
import time
import zlib

import numpy as np

# fleet/replica{i}/circuit_state gauge values (docs/observability.md)
BREAKER_CLOSED = 0
BREAKER_OPEN = 1
BREAKER_HALF_OPEN = 2

_STATE_NAMES = {
    BREAKER_CLOSED: "closed",
    BREAKER_OPEN: "open",
    BREAKER_HALF_OPEN: "half_open",
}


def breaker_state_name(state):
    return _STATE_NAMES[state]


class CircuitBreaker:
    """One replica's breaker. Thread-safe: the router's submit threads
    and monitor thread both feed it."""

    def __init__(self, failure_threshold=3, backoff_secs=0.5,
                 backoff_max_secs=30.0, jitter_ratio=0.1,
                 clock=time.monotonic, seed=0):
        if int(failure_threshold) < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold!r}"
            )
        self.failure_threshold = int(failure_threshold)
        self.backoff_secs = float(backoff_secs)
        self.backoff_max_secs = float(backoff_max_secs)
        self.jitter_ratio = float(jitter_ratio)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self.opens = 0           # total trips (backoff doubles per streak)
        self._streak_opens = 0   # trips since the last success
        self._probe_at = 0.0     # when the current open window elapses
        self._rng = np.random.default_rng((int(seed), 0x5EED))

    # -- placement-facing views -----------------------------------------
    def routable(self):
        """Non-mutating candidate-set filter: True when a request COULD
        flow right now (closed, or an open window that has elapsed and
        still holds its probe ticket). ``_candidates`` calls this; the
        actual ticket is taken by :meth:`allow_request` at submit time."""
        with self._lock:
            if self.state == BREAKER_CLOSED:
                return True
            if self.state == BREAKER_OPEN:
                return self._clock() >= self._probe_at
            return False  # half-open: the window's one probe is in flight

    def allow_request(self):
        """Take the submit ticket: True for closed breakers always; for
        an elapsed open window, True exactly once (the half-open probe);
        False otherwise. The caller MUST follow a True with
        record_success or record_failure — the probe ticket is what a
        half-open breaker is waiting on."""
        with self._lock:
            if self.state == BREAKER_CLOSED:
                return True
            if (
                self.state == BREAKER_OPEN
                and self._clock() >= self._probe_at
            ):
                self.state = BREAKER_HALF_OPEN
                return True
            return False

    def begin_probation(self):
        """Arm the half-open-probe gate for a replica that has never
        served — the autoscaler's freshly spawned capacity
        (docs/serving.md "SLO autoscaling"). State goes OPEN with an
        already-elapsed window, so the replica is a placement candidate
        whose FIRST submission is the window's single half-open probe:
        success closes the breaker and full traffic flows; failure
        re-opens with the base backoff. A half-built replica can cost
        the fleet at most one request. Not counted as a trip (``opens``
        stays put — probation is a birth certificate, not a failure)."""
        with self._lock:
            self.state = BREAKER_OPEN
            self.consecutive_failures = 0
            self._streak_opens = 0
            self._probe_at = self._clock()

    # -- outcome feedback -----------------------------------------------
    def record_success(self):
        """A request (or probe) got a real answer from the replica —
        including a healthy door rejection: responsive means not broken."""
        with self._lock:
            self.state = BREAKER_CLOSED
            self.consecutive_failures = 0
            self._streak_opens = 0

    def record_failure(self):
        """One RPC failure/timeout. A half-open probe failing re-opens
        immediately (with a doubled window); a closed breaker trips once
        the consecutive count reaches the threshold."""
        with self._lock:
            self.consecutive_failures += 1
            if self.state == BREAKER_HALF_OPEN or (
                self.state == BREAKER_CLOSED
                and self.consecutive_failures >= self.failure_threshold
            ):
                self._trip()

    def _trip(self):
        """(under self._lock) open with the streak's exponential window
        plus bounded jitter — deterministic for a fixed seed."""
        self.state = BREAKER_OPEN
        self.opens += 1
        self._streak_opens += 1
        window = min(
            self.backoff_secs * (2.0 ** (self._streak_opens - 1)),
            self.backoff_max_secs,
        )
        window *= 1.0 + self.jitter_ratio * float(self._rng.random())
        self._probe_at = self._clock() + window

    @property
    def open_window_remaining(self):
        """Seconds until the next probe is allowed (0 when not open)."""
        with self._lock:
            if self.state != BREAKER_OPEN:
                return 0.0
            return max(self._probe_at - self._clock(), 0.0)


def build_breaker(replica_id, *, failure_threshold=3, backoff_secs=0.5,
                  backoff_max_secs=30.0, clock=time.monotonic):
    """One breaker per replica, jitter-seeded by the replica id so a
    fleet's breakers are decorrelated but each run is reproducible."""
    return CircuitBreaker(
        failure_threshold=failure_threshold,
        backoff_secs=backoff_secs,
        backoff_max_secs=backoff_max_secs,
        clock=clock,
        seed=zlib.crc32(str(replica_id).encode()),
    )
