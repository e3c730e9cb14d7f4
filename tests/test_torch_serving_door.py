"""Port parity for the HTTP/SSE door: each package's ``HTTPDoor`` in
front of its own router over one in-process replica, whose engine is
tests/unit/test_door.py's host harness around the package's REAL
``ContinuousBatchingScheduler`` (decode hooks in plain Python, paced by
``step_secs``). One request script runs against both doors; the status
codes, bodies, ``Retry-After`` headers and SSE event sequences must be
equal, request ids and timestamps aside.
"""

import json
import socket
import time
import types

import pytest

import deepspeed_tpu.inference.scheduler as jsched
import deepspeed_tpu.serving as jserving
import deepspeed_tpu.telemetry.registry as jregistry
import deepspeed_tpu_torch.inference.scheduler as tsched
import deepspeed_tpu_torch.serving as tserving
import deepspeed_tpu_torch.telemetry.registry as tregistry
from torch_test_env import jax_compile_cache  # noqa: F401

PACKAGES = {
    "jax": types.SimpleNamespace(serving=jserving, sched=jsched,
                                 registry=jregistry),
    "torch": types.SimpleNamespace(serving=tserving, sched=tsched,
                                   registry=tregistry),
}
# fields that carry request ids or clocks
VOLATILE = ("request_id", "id", "ttft_ms", "latency_ms", "elapsed_ms",
            "uptime_secs", "created", "timestamp")


class _HostEngine:
    """test_door.py's harness: each decode step yields ``prev + 1`` per
    active slot, ``step_secs`` apart."""

    prefill_len = 16
    paged = False
    speculative = False

    def __init__(self, step_secs):
        self.step_secs = float(step_secs)
        self._last = {}
        self.scheduler = None

    def prefill_request(self, slot, prompt_tokens, temperature):
        first = (int(prompt_tokens[-1]) + 1) % 1000
        self._last[slot] = first
        return first

    def decode_tokens(self, active_slots):
        time.sleep(self.step_secs)
        out = []
        for slot in active_slots:
            nxt = (self._last.get(slot, 0) + 1) % 1000
            self._last[slot] = nxt
            out.append(nxt)
        return out

    def submit(self, prompt_tokens, **kwargs):
        return self.scheduler.submit(prompt_tokens, **kwargs)

    def load_snapshot(self):
        return self.scheduler.load_snapshot()

    def serve_forever(self):
        self.scheduler.serve_forever(idle_sleep=0.001)

    def close(self):
        self.scheduler.shutdown()


def _fleet(P, step_secs=0.01, **router_kw):
    def factory():
        engine = _HostEngine(step_secs)
        engine.scheduler = P.sched.ContinuousBatchingScheduler(
            engine, num_slots=4, max_seq_len=512, queue_depth=16,
            queue_timeout=0.0, eos_token_id=None, temperature=0.0,
            registry=P.registry.MetricsRegistry(),
        )
        return engine

    return P.serving.FleetRouter(
        [P.serving.InProcessReplica("0", factory)], monitor_interval=0.005,
        **router_kw).start()


def _scrub(value):
    if isinstance(value, dict):
        return {k: _scrub(v) for k, v in value.items() if k not in VOLATILE}
    if isinstance(value, list):
        return [_scrub(v) for v in value]
    return value


def _http(host, port, method, target, payload=None, headers=None,
          raw=None):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=30.0)
    body = raw if raw is not None else (
        None if payload is None else json.dumps(payload))
    conn.request(method, target, body, headers or {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    try:
        parsed = json.loads(data) if data else None
    except ValueError:
        parsed = data.decode(errors="replace")
    return (resp.status, resp.getheader("Retry-After"),
            resp.getheader("WWW-Authenticate"), _scrub(parsed))


def _sse(host, port, payload, headers=b""):
    sock = socket.create_connection((host, port))
    body = json.dumps(payload).encode()
    sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: door\r\n" + headers
                 + b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
    sock.settimeout(30.0)
    buf = b""
    while b"event: done" not in buf and b"event: error" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            break
        buf += chunk
    sock.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    events = []
    for block in rest.split(b"\n\n"):
        name = data = None
        for line in block.split(b"\n"):
            if line.startswith(b"event: "):
                name = line[7:].decode()
            elif line.startswith(b"data: "):
                data = json.loads(line[6:])
        if name is not None:
            events.append((name, _scrub(data)))
    return status, events


def _door(P, router, **kw):
    door = P.serving.HTTPDoor(router, **kw)
    host, port = door.start()
    return door, host, port


def script_streams_and_codes(P):
    out = []
    router = _fleet(P, rate_limit=(0.001, 3))
    door, host, port = _door(P, router)
    try:
        out.append(_sse(host, port, {"prompt": [7], "max_new_tokens": 6,
                                     "stream": True}))
        out.append(_http(host, port, "POST", "/v1/generate",
                         {"prompt": [5], "max_new_tokens": 4,
                          "stream": False}))
        for bad in ({"prompt": "a string"}, {"prompt": []},
                    {"prompt": [1.5]}, {}, {"prompt": [1],
                                            "max_new_tokens": -1}):
            out.append(_http(host, port, "POST", "/v1/generate", bad))
        out.append(_http(host, port, "POST", "/v1/generate",
                         raw="{not json"))
        out.append(_http(host, port, "GET", "/nope"))
        out.append(_http(host, port, "GET", "/v1/generate"))
        for hub_route in ("/metrics", "/statz", "/dashboard"):
            out.append(_http(host, port, "GET", hub_route))
        out.append(_http(host, port, "GET", "/healthz")[:1])
        out.append(_http(host, port, "GET", "/readyz"))
        # the burst of 3 is spent by now: refused, with the bucket's
        # refill time (~1000 s at 0.001/s; whole seconds, which the
        # clock may round either way)
        for _ in range(2):
            status, retry, _, body = _http(
                host, port, "POST", "/v1/generate",
                {"prompt": [2], "max_new_tokens": 1, "stream": False})
            out.append((status, body))
            assert status == 429 and 900 <= int(retry) <= 1000, retry
        out.append(_sse(host, port, {"prompt": [3], "max_new_tokens": 2,
                                     "stream": True}))
        router.drain_fleet()
        out.append(_http(host, port, "POST", "/v1/generate",
                         {"prompt": [1], "max_new_tokens": 1,
                          "stream": False}))
        out.append(_http(host, port, "GET", "/readyz"))
        out.append(_http(host, port, "GET", "/healthz")[:1])
    finally:
        door.shutdown()
        router.shutdown()
    return out


def script_auth_and_deadline(P):
    out = []
    router = _fleet(P, step_secs=0.05)
    door, host, port = _door(P, router, auth_token="s3cret")
    try:
        req = {"prompt": [4], "max_new_tokens": 3, "stream": False}
        out.append(_http(host, port, "POST", "/v1/generate", req))
        out.append(_http(host, port, "POST", "/v1/generate", req,
                         headers={"Authorization": "Bearer wrong"}))
        out.append(_http(host, port, "POST", "/v1/generate", req,
                         headers={"Authorization": "Bearer s3cret"}))
        out.append(_http(host, port, "GET", "/healthz")[:1])
        out.append(_http(host, port, "GET", "/readyz"))
        out.append(_sse(host, port, {"prompt": [9], "max_new_tokens": 200,
                                     "stream": True, "deadline_secs": 0.3},
                        headers=b"Authorization: Bearer s3cret\r\n"))
    finally:
        door.shutdown()
        router.shutdown()
    return out


def _partial(events):
    """A deadline's stream: its event names, and the done event's reason
    and tokens that follow on from the prompt (how many arrive depends
    on the clock)."""
    names = [n for n, _ in events]
    done = dict(events[-1][1])
    tokens = done.pop("tokens")
    done.pop("usage", None)
    return (names[-1], set(names[:-1]), done,
            tokens == list(range(10, 10 + len(tokens))))


@pytest.mark.parametrize("script", ["streams_and_codes",
                                    "auth_and_deadline"])
def test_door_answers_equal_the_jax_door(script):
    fn = globals()[f"script_{script}"]
    want = fn(PACKAGES["jax"])
    got = fn(PACKAGES["torch"])
    if script == "auth_and_deadline":
        want[-1] = (want[-1][0], _partial(want[-1][1]))
        got[-1] = (got[-1][0], _partial(got[-1][1]))
    assert got == want
    statuses = [o[0] for o in want]
    assert 200 in statuses and len(set(statuses)) >= 2
