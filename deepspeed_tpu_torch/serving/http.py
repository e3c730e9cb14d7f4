"""HTTP/SSE front door: the fleet's internet-facing edge.

Port of deepspeed_tpu/serving/http.py. The fleet hub's routes
(``/metrics``, ``/statz``, ``/dashboard``) answer 404 while no hub is
passed (telemetry/hub.py, armed by ``serving.hub``).

``HTTPDoor`` puts an asyncio HTTP server (stdlib only — no framework
import at serving time) in front of a :class:`FleetRouter`, streaming
each token as the scheduler finishes it (docs/serving.md "Networked
fleet"). The contract the door enforces:

  * **Streaming is genuinely incremental.** The first SSE ``token``
    event flushes at TTFT — when the replica's prefill samples the first
    token — not when the generation completes; every later token follows
    within one poll interval of its decode step.
  * **Typed rejections map to status codes.** The serving tier's
    machine-readable ``reason`` codes (inference/scheduler.py REJECT_*)
    become HTTP statuses — clients branch on the status, never on prose:

        reason        status
        rate_limit    429  (Retry-After: the token bucket's ACTUAL
                            refill time, ceiled to whole seconds)
        overload      503  (Retry-After: 1)
        draining      503
        capacity      503
        deadline      504
        ValueError    400  (malformed request — never retried)
        bad token     401  (``serving.http.auth_token`` mismatch;
                            WWW-Authenticate: Bearer)

  * **Auth is a bearer token, probes are exempt.** When
    ``serving.http.auth_token`` is set, every route except the probe
    endpoints demands ``Authorization: Bearer <token>`` — compared in
    constant time, answered 401 on mismatch, and NEVER logged (neither
    the configured token nor what the client sent). ``/healthz`` and
    ``/readyz`` stay open: external load balancers carry no tenant
    credentials.
  * **Readiness is not liveness.** ``GET /healthz`` answers 200 while
    the process serves at all; ``GET /readyz`` answers 503 the moment
    the fleet is draining, browned out, without a routable replica, or
    uniformly degraded — so an external load balancer stops routing
    BEFORE requests shed (``FleetRouter.readiness``).

  * **An abandoned stream frees its slot.** A client disconnect cancels
    the fleet request (``FleetRouter.cancel``): the replica scheduler
    reclaims the KV slot at the next step boundary — within one decode
    step — instead of generating for nobody (``door/client_disconnects``).
  * **Slow clients cannot hold the fleet.** Each connection's write
    buffer is bounded at ``max_buffer_bytes``; a client draining slower
    than its tokens arrive hits the ``overrun_policy``: ``"drop"``
    (default) cancels the request and closes the stream
    (``fleet/net_slow_client_drops``) — the slot frees like a
    disconnect; ``"block"`` awaits the drain, trading this stream's
    latency (and its slot's occupancy) for completeness.

API::

    POST /v1/generate        {"prompt": [ints], "max_new_tokens": 32,
                              "stream": true, "temperature": 0.0,
                              "deadline_secs": 5.0, "tenant": "free",
                              "priority": 1, "adapter": "tenant-a"}
      stream=true  -> text/event-stream:
                        event: token   data: {"i": K, "t": T}
                        event: done    data: {"tokens": [...],
                                              "finish_reason": "...",
                                              "usage": {...}}
      stream=false -> one application/json body at completion
    GET /healthz             fleet liveness + routable-capacity summary
    GET /readyz              readiness: 200 taking traffic, 503 not

Deadlines propagate end to end: ``deadline_secs`` rides the router
submit (charging re-routes), the socket transport's frame header
(transport.py), and the replica scheduler's admission gate — the door
adds nothing but the plumbing. ``door/*`` streams (open_streams,
stream_ttft_ms, client_disconnects, requests) ride the router's
registry and export through the same sinks (docs/observability.md).
"""

import asyncio
import collections
import hmac
import json
import math
import threading
import time
import uuid

from ..inference.scheduler import (
    REJECT_CAPACITY,
    REJECT_DEADLINE,
    REJECT_DRAINING,
    REJECT_FENCED,
    REJECT_OVERLOAD,
    REJECT_RATE_LIMIT,
    RequestRejected,
)
from ..telemetry.registry import DEFAULT_TIME_BUCKETS_MS, count_suppressed
from ..utils.logging import logger

STATUS_BY_REASON = {
    REJECT_RATE_LIMIT: 429,
    REJECT_OVERLOAD: 503,
    REJECT_DRAINING: 503,
    REJECT_CAPACITY: 503,
    REJECT_DEADLINE: 504,
    REJECT_FENCED: 503,
}
# statuses a client should back off and retry on
_RETRYABLE = (429, 503)

_REASONS_PHRASE = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 499: "Client Closed Request",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

# request bodies past this are hostile, not prompts
BODY_MAX_BYTES = 4 << 20

# same for a header block: a client streaming header lines forever must
# hit a ceiling, not grow the door's memory one line at a time
HEADERS_MAX_BYTES = 64 << 10

OVERRUN_POLICIES = ("drop", "block")


class _RequestTooLarge(Exception):
    """Body or header block past the door's ceilings — answered 413 (a
    client must see the non-retryable status, not a bare socket close
    it would mistake for a network fault and retry)."""


def _sse(event, payload, event_id=None):
    """One SSE frame. ``event_id`` (the absolute token index on
    ``token`` events) writes the ``id:`` field, which browsers and SSE
    clients echo back as ``Last-Event-ID`` on reconnect — the resume
    cursor the door's replay path consumes."""
    head = f"event: {event}\n"
    if event_id is not None:
        head += f"id: {int(event_id)}\n"
    return (
        head + f"data: {json.dumps(payload)}\n\n"
    ).encode("utf-8")


class HTTPDoor:
    """One door per router. ``start()`` spins the asyncio loop on a
    daemon thread and returns ``(host, port)`` (an ephemeral port 0
    resolves here); ``shutdown()`` closes the listener, cancels every
    open stream's fleet request, and joins the loop."""

    def __init__(self, router, host="127.0.0.1", port=0, *,
                 max_buffer_bytes=65536, overrun_policy="drop",
                 poll_interval=0.002, registry=None, auth_token=None,
                 hub=None, idempotency_cache_size=256):
        if overrun_policy not in OVERRUN_POLICIES:
            raise ValueError(
                f"unknown overrun_policy {overrun_policy!r}; valid: "
                f"{OVERRUN_POLICIES}"
            )
        self.router = router
        # the fleet observability plane (telemetry/hub.py): None means
        # no /metrics //statz //dashboard routes — they fall through to
        # 404 (the hub-disabled zero-overhead pin)
        self.hub = hub if hub is not None else getattr(router, "hub", None)
        # bearer secret (serving.http.auth_token): held privately, never
        # logged, never echoed into any response or repr
        self._auth_token = str(auth_token) if auth_token else None
        self._host = str(host)
        self._port = int(port)
        self.max_buffer_bytes = int(max_buffer_bytes)
        self.overrun_policy = overrun_policy
        self._poll = float(poll_interval)
        reg = registry if registry is not None else router.metrics
        self._m_requests = reg.counter(
            "door/requests", help="HTTP requests accepted by the door"
        )
        self._m_open = reg.gauge(
            "door/open_streams", help="SSE streams currently open"
        )
        self._m_ttft = reg.histogram(
            "door/stream_ttft_ms", buckets=DEFAULT_TIME_BUCKETS_MS,
            help="door-observed time to first streamed token event",
        )
        self._m_disconnects = reg.counter(
            "door/client_disconnects",
            help="streams abandoned by the client before completion "
                 "(their fleet requests cancel; slots free within one "
                 "decode step)",
        )
        self._m_slow_drops = reg.counter(
            "fleet/net_slow_client_drops",
            help="streams dropped by the overrun policy: the client "
                 "drained slower than its tokens arrived",
        )
        self._m_resumed = reg.counter(
            "door/streams_resumed",
            help="SSE streams resumed by a client retry "
                 "(Idempotency-Key attach, replaying from Last-Event-ID)",
        )
        self._m_idem_replays = reg.counter(
            "door/idempotent_replays",
            help="POSTs answered from the idempotency cache's terminal "
                 "result instead of re-running the generation",
        )
        # bounded terminal-result cache (Idempotency-Key dedup): the
        # door's half of exactly-once delivery — a retried POST whose
        # first attempt already finished replays the SAME result. Only
        # touched from the event-loop thread, so no lock.
        self.idempotency_cache_size = max(int(idempotency_cache_size), 1)
        self._idem_lru = collections.OrderedDict()
        # graceful restart (docs/serving.md "Control-plane durability"):
        # armed by graceful_restart() / SIGTERM — every open stream
        # emits a terminal ``restart`` event carrying its resume token
        # before the door closes, and /readyz flips to 503 "restarting"
        self._restart_event = asyncio.Event()
        self._restart_retry_after = 1
        self._loop = None
        self._server = None
        self._thread = None
        self._started = threading.Event()
        self._start_error = None

    # -- lifecycle ------------------------------------------------------
    def start(self, timeout=10.0):
        if self._thread is not None:
            return self._host, self._port
        self._thread = threading.Thread(
            target=self._run_loop, name="ds-http-door", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("HTTP door failed to start in time")
        if self._start_error is not None:
            raise self._start_error
        return self._host, self._port

    def _run_loop(self):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            self._server = loop.run_until_complete(
                asyncio.start_server(
                    self._handle_conn, self._host, self._port
                )
            )
            sockname = self._server.sockets[0].getsockname()
            self._host, self._port = sockname[0], sockname[1]
        except Exception as e:  # bind failure: surface on start()
            self._start_error = e
            self._started.set()
            return
        self._started.set()
        logger.info(
            "HTTP door serving on %s:%d (buffer %d bytes, overrun=%s)",
            self._host, self._port, self.max_buffer_bytes,
            self.overrun_policy,
        )
        try:
            loop.run_forever()
        finally:
            self._server.close()
            loop.run_until_complete(self._server.wait_closed())
            loop.close()

    def shutdown(self, timeout=10.0):
        loop = self._loop
        if loop is None:
            return

        async def _drain():
            # stop accepting, then cancel every live connection task —
            # each open stream's CancelledError handler cancels its
            # fleet request, so replicas stop decoding for connections
            # the door is tearing down — and only then stop the loop
            self._server.close()
            current = asyncio.current_task()
            tasks = [t for t in asyncio.all_tasks() if t is not current]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            asyncio.get_event_loop().stop()

        asyncio.run_coroutine_threadsafe(_drain(), loop)
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._loop = None

    # -- graceful restart (docs/serving.md) -----------------------------
    def graceful_restart(self, retry_after=1):
        """Arm the restart drain: ``/readyz`` answers 503 "restarting"
        immediately, and every open SSE stream emits one terminal
        ``restart`` event — carrying its resume token (the request's
        idempotency key + the last delivered event id) and a
        ``retry_after_secs`` hint — then closes WITHOUT cancelling its
        fleet request: the node keeps decoding, and the client's retry
        re-attaches (this life) or adopts through the journal (the
        next). The caller still owns the actual process exit."""
        self._restart_retry_after = max(int(retry_after), 1)
        loop = self._loop
        if loop is not None:
            loop.call_soon_threadsafe(self._restart_event.set)
        else:
            self._restart_event.set()
        return self

    def install_restart_signal(self, signals=("SIGTERM",),
                               retry_after=1):
        """Wire :meth:`graceful_restart` to process signals (main
        thread only — elsewhere the cooperative call still works).
        Returns self."""
        import signal as _signal

        def _on_signal(_signum, _frame):
            logger.warning(
                "door: restart signal received — draining open streams "
                "with resume tokens"
            )
            self.graceful_restart(retry_after=retry_after)

        for name in signals:
            sig = getattr(_signal, name, None)
            if sig is None:
                continue
            try:
                _signal.signal(sig, _on_signal)
            except ValueError as e:
                # not the main thread: the signal cannot install; the
                # cooperative graceful_restart() path remains
                count_suppressed("serving.door_restart_signal", e)
        return self

    @property
    def restarting(self):
        return self._restart_event.is_set()

    @property
    def address(self):
        return self._host, self._port

    # -- HTTP plumbing --------------------------------------------------
    async def _handle_conn(self, reader, writer):
        try:
            try:
                request = await self._read_request(reader)
            except ValueError as e:
                # malformed framing (a garbage Content-Length) is a
                # CLIENT error: the documented 400, not a 500 that
                # pollutes the server-fault diagnostics
                await self._respond_json(writer, 400, {"error": str(e)})
                return
            except _RequestTooLarge as e:
                await self._respond_json(writer, 413, {"error": str(e)})
                return
            if request is None:
                return
            method, target, headers, body = request
            self._m_requests.inc()
            if not self._authorized(target, headers):
                await self._respond_json(
                    writer, 401,
                    {"error": "missing or invalid bearer token"},
                    extra_headers=("WWW-Authenticate: Bearer",),
                )
                return
            if method == "GET" and target == "/healthz":
                await self._respond_json(writer, 200, self._health())
            elif method == "GET" and target == "/readyz":
                if self._restart_event.is_set():
                    # restarting: flip NOT-ready before the last stream
                    # closes, so the LB steers new traffic away first
                    await self._respond_json(
                        writer, 503,
                        {"ready": False, "reasons": ["restarting"]},
                    )
                    return
                # readiness costs per-replica snapshot RPCs: keep the
                # event loop (and every open stream) out of them
                ready, reasons = await asyncio.get_event_loop(
                ).run_in_executor(None, self.router.readiness)
                body = {"ready": bool(ready), "reasons": list(reasons)}
                if not ready and "no_routable_replicas" in reasons:
                    # the 503 alone tells the LB to back off; the CAUSE
                    # buckets tell the operator what to fix (all
                    # evicted vs breakers open vs fenced out)
                    cause = getattr(
                        self.router, "no_capacity_cause", None
                    )
                    if cause is not None:
                        body["cause"] = await asyncio.get_event_loop(
                        ).run_in_executor(None, cause)
                await self._respond_json(
                    writer, 200 if ready else 503, body,
                )
            elif method == "POST" and target == "/v1/generate":
                await self._generate(reader, writer, headers, body)
            elif (
                self.hub is not None and method == "GET"
                and target == "/metrics"
            ):
                # the fleet scrape renders from cached snapshots but
                # still walks every series: off the event loop, like
                # readyz
                text = await asyncio.get_event_loop().run_in_executor(
                    None, self.hub.prometheus_text
                )
                await self._respond_text(
                    writer, 200, text,
                    content_type="text/plain; version=0.0.4; "
                                 "charset=utf-8",
                )
            elif (
                self.hub is not None and method == "GET"
                and target == "/statz"
            ):
                payload = await asyncio.get_event_loop().run_in_executor(
                    None, self.hub.statz
                )
                await self._respond_json(writer, 200, payload)
            elif (
                self.hub is not None and method == "GET"
                and target == "/dashboard"
            ):
                html = await asyncio.get_event_loop().run_in_executor(
                    None, self.hub.dashboard_html
                )
                await self._respond_text(
                    writer, 200, html,
                    content_type="text/html; charset=utf-8",
                )
            elif (
                self.hub is not None and method == "GET"
                and target == "/statz/stream"
            ):
                await self._statz_stream(writer)
            elif target in ("/healthz", "/readyz", "/v1/generate") or (
                self.hub is not None and target in (
                    "/metrics", "/statz", "/statz/stream", "/dashboard",
                )
            ):
                await self._respond_json(
                    writer, 405, {"error": f"{method} not allowed here"}
                )
            else:
                await self._respond_json(
                    writer, 404, {"error": f"no route {target!r}"}
                )
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away mid-parse; nothing to answer
        except Exception as e:
            count_suppressed("serving.door_conn", e)
            try:
                await self._respond_json(
                    writer, 500, {"error": f"internal error: {e}"}
                )
            except Exception:
                pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader):
        """Minimal HTTP/1.1 request parse: request line, headers, and a
        Content-Length body. Returns (method, target, headers, body) or
        None for an empty connection."""
        line = await reader.readline()
        if not line.strip():
            return None
        try:
            method, target, _version = line.decode("latin-1").split(None, 2)
        except ValueError:
            raise ConnectionError("malformed request line") from None
        headers = {}
        header_bytes = 0
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            header_bytes += len(line)
            if header_bytes > HEADERS_MAX_BYTES:
                raise _RequestTooLarge(
                    f"header block past {HEADERS_MAX_BYTES} bytes refused"
                )
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        try:
            length = int(headers.get("content-length", 0) or 0)
        except ValueError:
            raise ValueError("malformed Content-Length header") from None
        if length < 0:
            raise ValueError("malformed Content-Length header")
        if length > BODY_MAX_BYTES:
            raise _RequestTooLarge(f"body of {length} bytes refused")
        body = await reader.readexactly(length) if length else b""
        return method.upper(), target, headers, body

    def _authorized(self, target, headers):
        """Bearer-token gate (``serving.http.auth_token``): the probe
        endpoints stay exempt — external load balancers carry no tenant
        credentials. The hub's observability endpoints default to
        PROTECTED and opt out per path via ``serving.hub.auth_exempt``
        (an internal scraper without credentials). Constant-time
        comparison; neither the configured token nor the client's
        attempt is ever logged."""
        if self._auth_token is None:
            return True
        if target in ("/healthz", "/readyz"):
            return True
        if self.hub is not None:
            for path in getattr(self.hub, "auth_exempt", ()):
                if target == path or target.startswith(path + "/"):
                    return True
        scheme, _, value = headers.get("authorization", "").partition(" ")
        if scheme.strip().lower() != "bearer":
            return False
        return hmac.compare_digest(value.strip(), self._auth_token)

    async def _respond_json(self, writer, status, payload,
                            extra_headers=(), retry_after_secs=None):
        body = json.dumps(payload).encode("utf-8")
        phrase = _REASONS_PHRASE.get(status, "")
        head = [
            f"HTTP/1.1 {status} {phrase}",
            "Content-Type: application/json",
            f"Content-Length: {len(body)}",
            "Connection: close",
        ]
        if status in _RETRYABLE:
            # the real backoff when the rejecting layer knows it (the
            # token bucket's refill time), the safe constant otherwise;
            # whole seconds — the header's only portable unit
            secs = 1
            if retry_after_secs is not None:
                secs = max(int(math.ceil(float(retry_after_secs))), 1)
            head.append(f"Retry-After: {secs}")
        head.extend(extra_headers)
        writer.write(
            ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body
        )
        await writer.drain()

    async def _respond_text(self, writer, status, text, *,
                            content_type="text/plain; charset=utf-8"):
        """Non-JSON bodies (Prometheus exposition, the dashboard HTML)."""
        body = text.encode("utf-8")
        phrase = _REASONS_PHRASE.get(status, "")
        head = [
            f"HTTP/1.1 {status} {phrase}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            "Connection: close",
        ]
        writer.write(
            ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body
        )
        await writer.drain()

    async def _statz_stream(self, writer):
        """SSE feed for the dashboard: one ``statz`` event per hub
        interval, each frame built off the event loop (statz walks the
        ring under its lock). Runs until the client disconnects or the
        door shuts down."""
        head = [
            "HTTP/1.1 200 OK",
            "Content-Type: text/event-stream",
            "Cache-Control: no-store",
            "Connection: close",
        ]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        await writer.drain()
        self._m_open.inc(1)
        try:
            while True:
                state = await asyncio.get_event_loop().run_in_executor(
                    None, self.hub.dashboard_state
                )
                writer.write(_sse("statz", state))
                await writer.drain()
                await asyncio.sleep(
                    max(float(self.hub.interval_secs), 0.25)
                )
        except (ConnectionError, OSError):
            pass  # dashboard tab closed; nothing to answer
        finally:
            self._m_open.inc(-1)

    def _health(self):
        snap = self.router.metrics.snapshot()
        return {
            "ok": True,
            "replicas_total": snap.get("fleet/replicas_total", 0),
            "replicas_available": snap.get("fleet/replicas_available", 0),
            "queue_depth": snap.get("fleet/queue_depth", 0),
            "open_streams": snap.get("door/open_streams", 0),
        }

    # -- /v1/generate ---------------------------------------------------
    @staticmethod
    def _parse_generate(body):
        try:
            payload = json.loads(body.decode("utf-8") or "{}")
        except (ValueError, UnicodeDecodeError):
            raise ValueError("body is not valid JSON") from None
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object")
        prompt = payload.get("prompt")
        if (
            not isinstance(prompt, list) or not prompt
            # bool is an int subclass: JSON true/false would silently
            # become token ids 1/0 without the explicit exclusion
            or not all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in prompt
            )
        ):
            raise ValueError(
                '"prompt" must be a non-empty list of token ids '
                "(tokenization happens client-side)"
            )
        kwargs = {}
        for key in ("max_new_tokens", "temperature", "deadline_secs",
                    "adapter"):
            if payload.get(key) is not None:
                kwargs[key] = payload[key]
        return (
            prompt,
            str(payload.get("tenant", "default")),
            int(payload.get("priority", 0)),
            bool(payload.get("stream", True)),
            kwargs,
        )

    async def _generate(self, reader, writer, headers, body):
        loop = asyncio.get_event_loop()
        try:
            prompt, tenant, priority, stream, kwargs = (
                self._parse_generate(body)
            )
        except ValueError as e:
            await self._respond_json(writer, 400, {"error": str(e)})
            return
        greedy = not kwargs.get("temperature")
        # resume headers (docs/serving.md "Control-plane durability"):
        # Idempotency-Key names the request across retries; Last-Event-ID
        # (the standard SSE reconnect cursor — the last ``id:`` the
        # client saw, i.e. the last absolute token index delivered) asks
        # the replay to start after it
        idem_key = headers.get("idempotency-key") or None
        start_at = 0
        last_event_id = headers.get("last-event-id")
        if last_event_id is not None:
            try:
                start_at = int(last_event_id) + 1
            except ValueError:
                await self._respond_json(writer, 400, {
                    "error": "malformed Last-Event-ID header "
                             "(expected the last token index)",
                })
                return
        fleet_req = None
        resumed = False
        if idem_key is not None:
            cached = self._idem_lru.get(idem_key)
            if cached is not None:
                # the first attempt already finished: replay the SAME
                # terminal result — never a second generation
                self._idem_lru.move_to_end(idem_key)
                self._m_idem_replays.inc()
                if stream:
                    await self._replay_terminal(writer, cached, start_at)
                else:
                    await self._respond_json(writer, 200, cached)
                return
            live = self.router.find_inflight(idem_key)
            if live is not None:
                # unknown-but-in-flight: attach to the live generation
                # (the crash-adoption case included — the journaled key
                # rode the descriptor into the restored fleet request)
                fleet_req = live
                resumed = True
        t_recv = time.monotonic()
        if fleet_req is None:
            submit_key = idem_key
            if submit_key is None and stream:
                # auto-mint a key for streams: it becomes the resume
                # token the graceful-restart event hands back, so even
                # clients that sent none can reconnect
                submit_key = f"auto-{uuid.uuid4().hex}"
            idem_key = submit_key
            try:
                # submit can block on a replica's bounded admission
                # queue: keep the event loop (and every other stream)
                # out of it
                fleet_req = await loop.run_in_executor(
                    None,
                    lambda: self.router.submit(
                        prompt, tenant=tenant, priority=priority,
                        idempotency_key=submit_key, **kwargs
                    ),
                )
            except RequestRejected as e:
                status = STATUS_BY_REASON.get(e.reason, 503)
                await self._respond_json(
                    writer, status, {"error": str(e), "reason": e.reason},
                    retry_after_secs=getattr(e, "retry_after_secs", None),
                )
                return
            except (ValueError, TypeError) as e:
                await self._respond_json(writer, 400, {"error": str(e)})
                return
        if resumed and not greedy and fleet_req.reroutes > 0:
            # a SAMPLED generation that re-placed (its replica died, or
            # it orphaned through a router crash) re-drew the sequence:
            # the prefix the client already holds cannot be resumed —
            # fail honestly instead of splicing two generations
            payload = {
                "error": "resumed a sampled stream that was re-routed; "
                         "the delivered prefix cannot be continued — "
                         "retry the request fresh",
                "finish_reason": "rerouted_sampling",
            }
            if stream:
                await self._respond_sse_error(writer, payload)
            else:
                await self._respond_json(writer, 502, payload)
            return
        if stream:
            await self._stream_response(
                writer, reader, fleet_req, t_recv, greedy=greedy,
                start_at=start_at, resumed=resumed, idem_key=idem_key,
            )
        else:
            await self._unary_response(
                writer, reader, fleet_req, idem_key=idem_key
            )

    async def _replay_terminal(self, writer, payload, start_at):
        """Stream-shaped replay of a cached terminal result: the token
        events after ``start_at`` (each with its ``id:``), then the same
        ``done`` frame the first attempt delivered."""
        writer.write((
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: text/event-stream\r\n"
            "Cache-Control: no-store\r\n"
            "Connection: close\r\n\r\n"
        ).encode("latin-1"))
        tokens = payload.get("tokens") or []
        for i in range(max(int(start_at), 0), len(tokens)):
            writer.write(_sse(
                "token", {"i": i, "t": int(tokens[i])}, event_id=i
            ))
        writer.write(_sse("done", payload))
        try:
            await writer.drain()
        except (ConnectionError, OSError):
            pass

    async def _respond_sse_error(self, writer, payload):
        """A stream that fails before any token: SSE-shaped so the
        client's event parser sees the typed error, not a broken
        connection it would blindly retry."""
        writer.write((
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: text/event-stream\r\n"
            "Cache-Control: no-store\r\n"
            "Connection: close\r\n\r\n"
        ).encode("latin-1"))
        writer.write(_sse("error", payload))
        try:
            await writer.drain()
        except (ConnectionError, OSError):
            pass

    def _note_terminal(self, idem_key, fleet_req):
        """Cache a successful terminal result under its idempotency key
        (bounded LRU): the replay source for retried POSTs. Error /
        cancelled finishes are NOT cached — the client's retry should
        re-run those."""
        if idem_key is None or fleet_req.finish_reason in (
            "error", "cancelled",
        ):
            return
        self._idem_lru[idem_key] = self._done_payload(fleet_req)
        self._idem_lru.move_to_end(idem_key)
        while len(self._idem_lru) > self.idempotency_cache_size:
            self._idem_lru.popitem(last=False)

    async def _unary_response(self, writer, reader, fleet_req,
                              idem_key=None):
        # same hangup watch as the stream path: an abandoned unary
        # request must free its slot within one decode step too, not
        # decode its whole budget for nobody
        hangup = asyncio.ensure_future(reader.read(64))
        try:
            while not fleet_req.done:
                if hangup.done():
                    try:
                        stray = hangup.result()
                    except (ConnectionError, OSError):
                        stray = b""  # a reset read side IS a hangup
                    if stray:
                        hangup = asyncio.ensure_future(reader.read(64))
                    else:
                        self._m_disconnects.inc()
                        self.router.cancel(fleet_req)
                        logger.info(
                            "door: client abandoned unary request "
                            "(fleet request %s); slot cancelled",
                            fleet_req.request_id,
                        )
                        return
                await asyncio.sleep(self._poll)
        except asyncio.CancelledError:
            self.router.cancel(fleet_req)
            raise
        finally:
            hangup.cancel()
        if fleet_req.finish_reason in ("error", "cancelled"):
            await self._respond_json(writer, 502, {
                "error": "the fleet could not finish the request "
                         f"(reason {fleet_req.finish_reason!r} after "
                         f"{fleet_req.reroutes} re-route(s))",
            })
            return
        self._note_terminal(idem_key, fleet_req)
        await self._respond_json(writer, 200, self._done_payload(fleet_req))

    @staticmethod
    def _done_payload(fleet_req):
        return {
            "tokens": list(fleet_req.tokens),
            "finish_reason": fleet_req.finish_reason,
            "usage": {
                "prompt_tokens": len(fleet_req.prompt_tokens),
                "completion_tokens": len(fleet_req.tokens),
            },
        }

    async def _stream_response(self, writer, reader, fleet_req, t_recv,
                               greedy=True, start_at=0, resumed=False,
                               idem_key=None):
        """The SSE loop: poll the replica-side handle and flush each new
        token the moment the scheduler finishes it. The exits: done
        (terminal event), client disconnect (cancel — the slot frees
        within one decode step), buffer overrun under the drop policy
        (cancel, same path), and a graceful restart (terminal
        ``restart`` event with the resume token; the fleet request is
        deliberately NOT cancelled — the node keeps decoding and the
        client's retry re-attaches). A resumed stream starts emitting at
        ``start_at`` (the client's Last-Event-ID + 1): earlier indices
        were already delivered."""
        transport = writer.transport
        try:
            transport.set_write_buffer_limits(high=self.max_buffer_bytes)
        except (AttributeError, RuntimeError):  # pragma: no cover
            pass
        writer.write((
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: text/event-stream\r\n"
            "Cache-Control: no-store\r\n"
            "Connection: close\r\n\r\n"
        ).encode("latin-1"))
        await writer.drain()
        # half-closed detection: the read side going EOF is the only
        # sign an SSE client hung up (it never sends again after the
        # request) — poll it as a task instead of blocking on it
        hangup = asyncio.ensure_future(reader.read(64))
        self._m_open.inc(1)
        if resumed:
            self._m_resumed.inc()
        sent = max(int(start_at), 0)
        first_at = None
        last_inner = None
        try:
            while True:
                if self._restart_event.is_set():
                    writer.write(_sse("restart", {
                        "finish_reason": "restart",
                        "retry_after_secs": self._restart_retry_after,
                        "resume": {
                            "idempotency_key": idem_key,
                            "last_event_id": (
                                sent - 1 if sent > 0 else None
                            ),
                        },
                    }))
                    try:
                        await writer.drain()
                    except (ConnectionError, OSError):
                        pass
                    logger.info(
                        "door: stream for fleet request %s handed its "
                        "resume token (restart drain)",
                        fleet_req.request_id,
                    )
                    return
                if hangup.done():
                    try:
                        stray = hangup.result()
                    except (ConnectionError, OSError):
                        stray = b""  # a reset read side IS a hangup
                    if stray:
                        # inbound BYTES are not a hangup (a trailing
                        # CRLF after the body, an eagerly-pipelined
                        # request on this Connection: close socket):
                        # ignore them and keep watching — only EOF
                        # means the client went away
                        hangup = asyncio.ensure_future(reader.read(64))
                    else:
                        self._m_disconnects.inc()
                        self.router.cancel(fleet_req)
                        logger.info(
                            "door: client abandoned stream (fleet "
                            "request %s); slot cancelled",
                            fleet_req.request_id,
                        )
                        return
                done = fleet_req.done
                # the CURRENT inner handle: a re-route swaps it (tokens
                # restart — greedy decode re-derives the same prefix)
                inner = self.router.inner_handle(fleet_req)
                if (
                    not greedy and sent > 0
                    and inner is not None and last_inner is not None
                    and inner is not last_inner
                ):
                    # a mid-stream re-route under SAMPLING re-draws the
                    # sequence: the new replica's tokens share no prefix
                    # with what already streamed, so splicing at `sent`
                    # would deliver a stream no generation produced.
                    # Fail the stream honestly; the client restarts.
                    self.router.cancel(fleet_req)
                    writer.write(_sse("error", {
                        "error": "re-routed mid-stream with sampling; "
                                 "the streamed prefix cannot be resumed "
                                 "— retry the request",
                        "finish_reason": "rerouted_sampling",
                    }))
                    try:
                        await writer.drain()
                    except (ConnectionError, OSError):
                        pass
                    return
                if inner is not None:
                    last_inner = inner
                tokens = (
                    list(fleet_req.tokens) if inner is None
                    else list(inner.tokens)
                )
                while sent < len(tokens):
                    if first_at is None:
                        first_at = time.monotonic()
                        if not resumed:
                            # a resumed stream's "first" token is a
                            # replay — it would poison the TTFT series
                            self._m_ttft.observe(
                                (first_at - t_recv) * 1e3
                            )
                    writer.write(_sse(
                        "token", {"i": sent, "t": int(tokens[sent])},
                        event_id=sent,
                    ))
                    sent += 1
                    if not await self._flush_stream(writer, fleet_req):
                        return
                if done:
                    if fleet_req.finish_reason in ("error", "cancelled"):
                        writer.write(_sse("error", {
                            "error": "the fleet could not finish the "
                                     "request",
                            "finish_reason": fleet_req.finish_reason,
                        }))
                    else:
                        self._note_terminal(idem_key, fleet_req)
                        writer.write(_sse(
                            "done", self._done_payload(fleet_req)
                        ))
                    try:
                        await writer.drain()
                    except (ConnectionError, OSError):
                        pass
                    return
                await asyncio.sleep(self._poll)
        except asyncio.CancelledError:
            # door shutdown with this stream open: free the slot — the
            # fleet must not keep decoding for a connection the door is
            # tearing down
            self.router.cancel(fleet_req)
            raise
        finally:
            self._m_open.inc(-1)
            hangup.cancel()

    async def _flush_stream(self, writer, fleet_req):
        """Apply the slow-client policy after each event write. Returns
        False when the stream ended (overrun drop or a dead client) —
        the request is already cancelled then."""
        transport = writer.transport
        try:
            pending = transport.get_write_buffer_size()
        except (AttributeError, RuntimeError):  # pragma: no cover
            pending = 0
        if pending <= self.max_buffer_bytes:
            return True
        if self.overrun_policy == "block":
            # backpressure the emit loop: this stream waits for its
            # client (its slot stays busy — the documented trade)
            try:
                await writer.drain()
            except (ConnectionError, OSError):
                self._m_disconnects.inc()
                self.router.cancel(fleet_req)
                return False
            return True
        self._m_slow_drops.inc()
        self.router.cancel(fleet_req)
        logger.warning(
            "door: dropping slow client (write buffer %d > %d bytes); "
            "fleet request %s cancelled", pending, self.max_buffer_bytes,
            fleet_req.request_id,
        )
        try:
            writer.write(_sse("error", {
                "error": "stream dropped: client reading too slowly",
                "finish_reason": "slow_client",
            }))
        except Exception:
            pass
        return False


def serve_http(router, config=None, **overrides):
    """Config-driven door construction (the ``serving.http`` block,
    docs/serving.md): build + start an :class:`HTTPDoor` for ``router``
    from a validated DeepSpeedConfig (or ``None`` for defaults), with
    keyword overrides winning. Returns the started door."""
    kwargs = {}
    if config is not None:
        kwargs = {
            "host": config.serving_http_host,
            "port": config.serving_http_port,
            "max_buffer_bytes": config.serving_http_max_buffer_bytes,
            "overrun_policy": config.serving_http_overrun_policy,
            "auth_token": config.serving_http_auth_token,
        }
    kwargs.update(overrides)
    door = HTTPDoor(router, **kwargs)
    door.start()
    return door
