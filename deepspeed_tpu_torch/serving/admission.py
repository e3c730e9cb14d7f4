"""Fleet admission: per-tenant token buckets + priority shedding.

Port of deepspeed_tpu/serving/admission.py: the same buckets, exceptions
and ``reason`` codes.

The router's FIRST gate (docs/serving.md) — runs before placement ever
scores a replica, so a tenant hammering the fleet burns router CPU only,
never a replica queue slot. Two rejection layers:

  rate limit — a classic token bucket per tenant (``burst`` capacity,
               ``requests_per_sec`` refill). An empty bucket raises
               :class:`RateLimited` (reason ``"rate_limit"``).
  priority   — the router sheds priority > 0 submissions when fleet-wide
               queue fill crosses ``serving.shed_queue_ratio`` (the fleet
               analog of the per-replica degraded gate), raising
               :class:`FleetOverloaded` (reason ``"overload"``).

Both are subclasses of the scheduler's :class:`RequestRejected`, so a
caller written against a single engine's front door keeps working when a
router is put in front of it — one except clause, richer ``reason``.
"""

import threading
import time

from ..inference.scheduler import (
    REJECT_OVERLOAD,
    REJECT_RATE_LIMIT,
    RequestRejected,
)


class RateLimited(RequestRejected):
    """A tenant's token bucket is empty (reason ``"rate_limit"``).

    ``retry_after_secs`` carries the bucket's ACTUAL refill time — how
    long until one token exists again — so the HTTP door's 429 can send
    a ``Retry-After`` the client can trust instead of a constant
    (docs/serving.md). ``None`` when the rejecting layer cannot know."""

    def __init__(self, message, retry_after_secs=None):
        super().__init__(message, reason=REJECT_RATE_LIMIT)
        self.retry_after_secs = (
            None if retry_after_secs is None else float(retry_after_secs)
        )


class FleetOverloaded(RequestRejected):
    """No replica can take this request right now — every routable queue
    is full, or fleet pressure is shedding this priority class (reason
    ``"overload"``)."""

    def __init__(self, message):
        super().__init__(message, reason=REJECT_OVERLOAD)


class TokenBucket:
    """Monotonic-clock token bucket: ``burst`` capacity, ``rate`` tokens
    refilled per second. ``rate=None`` disables limiting (always admits).
    ``clock`` is injectable so tests control time instead of sleeping."""

    def __init__(self, rate, burst=1, clock=time.monotonic):
        if rate is not None and rate <= 0:
            raise ValueError(f"rate must be > 0 or None, got {rate!r}")
        if int(burst) < 1:
            raise ValueError(f"burst must be >= 1, got {burst!r}")
        self.rate = None if rate is None else float(rate)
        self.burst = int(burst)
        self._clock = clock
        self._tokens = float(self.burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n=1):
        """Take ``n`` tokens if available; never blocks."""
        if self.rate is None:
            return True
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._stamp) * self.rate
            )
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after(self, n=1):
        """Seconds until ``n`` tokens will have refilled (0.0 when they
        are already available, and for unlimited buckets) — the door's
        429 ``Retry-After`` source. Read-only: no tokens are taken."""
        if self.rate is None:
            return 0.0
        with self._lock:
            now = self._clock()
            tokens = min(
                self.burst, self._tokens + (now - self._stamp) * self.rate
            )
            if tokens >= n:
                return 0.0
            return (n - tokens) / self.rate


class AdmissionController:
    """Per-tenant rate limiting for the fleet front door.

    ``default_limit`` is a ``(requests_per_sec, burst)`` pair applied to
    tenants without an explicit entry in ``per_tenant`` (a dict of
    ``tenant -> {"requests_per_sec": ..., "burst": ...}``, the config's
    ``serving.rate_limit.per_tenant`` block). Buckets are created lazily
    per tenant so an unconfigured fleet costs nothing per submit."""

    def __init__(self, default_limit=(None, 1), per_tenant=None,
                 clock=time.monotonic):
        self._default = default_limit
        self._per_tenant = dict(per_tenant or {})
        self._clock = clock
        self._buckets = {}
        self._lock = threading.Lock()

    def _bucket(self, tenant):
        bucket = self._buckets.get(tenant)
        if bucket is None:
            with self._lock:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    rps, burst = self._default
                    override = self._per_tenant.get(tenant)
                    if override is not None:
                        rps = override.get("requests_per_sec", rps)
                        burst = override.get("burst", burst)
                    bucket = TokenBucket(rps, burst, clock=self._clock)
                    self._buckets[tenant] = bucket
        return bucket

    def admit(self, tenant):
        """Charge one request against ``tenant``'s bucket; raises
        :class:`RateLimited` when the bucket is empty."""
        bucket = self._bucket(tenant)
        if not bucket.try_acquire():
            raise RateLimited(
                f"tenant {tenant!r} over its rate limit "
                f"({bucket.rate}/s, burst {bucket.burst})",
                retry_after_secs=bucket.retry_after(),
            )
