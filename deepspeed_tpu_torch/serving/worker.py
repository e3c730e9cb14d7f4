"""Replica worker: one inference engine per process, JSON-RPC over pipes.

Port of deepspeed_tpu/serving/worker.py: the same protocol, frame for
frame. ``python -m deepspeed_tpu_torch.serving.worker`` hosts a single
``InferenceEngine`` and speaks newline-delimited JSON on stdin/stdout
(stderr is left alone for logging), giving a SubprocessReplica real
isolation: a worker that segfaults or OOMs takes only its own engine.

Protocol (one JSON object per line; shared with the TCP node agent in
serving/node.py — RPC_PROTOCOL_VERSION in serving/replica.py names the
frame schema both transports speak):

  parent -> worker
    {"op": "init", "proto": V, "spec": {...}} build the engine (see below)
    {"op": "submit", "id": N, "prompt": [...],
     "max_new_tokens": M, "kwargs": {...}}   admit one request
    {"op": "cancel", "id": N}                withdraw request N (its slot
                                             frees within one decode step)
    {"op": "snapshot", "id": N}              router-facing load snapshot
    {"op": "load_adapter", "id": N,
     "name": "...", "load_dir": "...",
     "tag": ... }                            install a LoRA adapter from
                                             an adapter-only checkpoint
    {"op": "unload_adapter", "id": N,
     "name": "..."}                          evict a LoRA adapter
    {"op": "drain"}                          stop admitting, finish work
    {"op": "shutdown"}                       close the engine and exit

  worker -> parent
    {"event": "ready", "proto": V}           init finished, serving; V is
                                             the worker's protocol version
                                             (the handshake's other half —
                                             a mismatch fail-fasts in the
                                             parent with a typed error)
    {"event": "reply", "id": N, ...}         op ack (submit/snapshot);
                                             carries "error" + "reason"
                                             when the op was rejected
    {"event": "first_token", "id": N}        request N produced its TTFT
    {"event": "token", "id": N,
     "i": K, "t": T}                         request N's K-th generated
                                             token, streamed as the
                                             scheduler finishes it (the
                                             HTTP door's SSE source)
    {"event": "finished", "id": N,
     "tokens": [...], "reason": "...",
     "spans": [...]}                         request N's terminal answer;
                                             "spans" (present only when
                                             tracing sampled the request)
                                             carries the worker-side trace
                                             spans for the router's file

Trace-context propagation (docs/observability.md "Request tracing"):
the submit op's ``kwargs`` may carry ``trace_ctx`` — a JSON-safe
TraceContext wire dict — which the engine's scheduler adopts, so the
worker's spans parent to the router's fleet.request root. The init
spec's ``replica_id`` prefixes the scheduler's request ids.

The init ``spec``: ``{"model": {GPT2Config kwargs}, "init_seed": int,
"rng_seed": int, "config": {deepspeed config dict}, "device": str}``.
The weights load through the verified-checkpoint path when the config's
``inference.checkpoint.load_dir`` is set, the production route; else
they are drawn from ``init_seed``. The port cannot reproduce the JAX
package's ``jax.random`` draw, so ``init_seed`` gives the port's own:
GPT-2's initializers from a seeded ``torch.Generator`` on the CPU, the
same on every replica of a fleet and on every device. ``device``
(default: the GPU, as for every entry point of the port) is where the
engine serves; ``"cpu"`` runs the kernels' plain versions.

The server core is transport-agnostic (:class:`WorkerServer` takes any
file-like pair), so tests drive the full protocol in-process against a
stub engine without paying a process spawn + engine build per case.
"""

import json
import sys
import threading
import time

from ..inference.scheduler import RequestRejected
from ..resilience.faults import NULL_INJECTOR
from ..telemetry.registry import (
    DEFAULT_TIME_BUCKETS_MS, MetricsRegistry, wire_snapshot,
)
from .replica import RPC_PROTOCOL_VERSION


def poll_tracked_requests(tracked_map, lock, emit):
    """One pass over a ``{rpc_id: (request, first_token_announced,
    tokens_sent)}`` table: announce first tokens, stream each
    newly-decoded token the moment the scheduler finishes it (so the
    parent's handle — and the HTTP door's SSE stream behind it — grows
    incrementally instead of materializing at completion; ``i`` carries
    the absolute index so re-emits after a resume are idempotent), and
    pop + ship ``finished`` for done requests. Shared by the worker's
    stdin/stdout protocol and the node agent's per-session sockets
    (node.py) — one poller, two transports, no drift."""
    with lock:
        tracked = list(tracked_map.items())
    for rpc_id, (req, announced, sent) in tracked:
        if not announced and req.first_token_at is not None:
            announced = True
            emit({"event": "first_token", "id": rpc_id})
        tokens = list(req.tokens)
        for i in range(sent, len(tokens)):
            emit({
                "event": "token", "id": rpc_id, "i": i, "t": int(tokens[i]),
            })
        sent = max(sent, len(tokens))
        with lock:
            if rpc_id in tracked_map:
                tracked_map[rpc_id] = (req, announced, sent)
        if req.done:
            with lock:
                tracked_map.pop(rpc_id, None)
            msg = {
                "event": "finished", "id": rpc_id,
                "tokens": [int(t) for t in req.tokens],
                "reason": req.finish_reason,
            }
            # ship the request's sampled trace spans home with the
            # answer: the parent replica hands them to the router's
            # tracer, joining the remote spans to the fleet request's
            # trace in ONE file
            spans = getattr(req, "trace_spans", None)
            if spans:
                msg["spans"] = spans
            emit(msg)


class WorkerServer:
    """The worker's op loop over explicit streams. ``engine_builder`` maps
    the init spec to an engine exposing submit/load_snapshot/scheduler/
    close (the InferenceEngine surface the replica tier relies on)."""

    def __init__(self, stdin, stdout, engine_builder, poll_interval=0.002):
        self._stdin = stdin
        self._stdout = stdout
        self._build = engine_builder
        self._poll = float(poll_interval)
        self._engine = None
        self._write_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._tracked = {}  # rpc_id -> (request, first_token_announced)
        self._stop = threading.Event()
        # the engine's own fault injector (resilience/faults.py), adopted
        # at init so the "replica.hang" chaos site can stall THIS op loop
        # — the worker-side half of the serving seams
        self._faults = NULL_INJECTOR

    def _emit(self, msg):
        with self._write_lock:
            self._stdout.write(json.dumps(msg) + "\n")
            self._stdout.flush()

    # -- request watching (engine requests complete on the engine's
    # driver thread; this poller turns completion into pipe events) ----
    def _watch_loop(self):
        while not self._stop.is_set():
            poll_tracked_requests(
                self._tracked, self._state_lock, self._emit
            )
            self._stop.wait(self._poll)

    # -- ops -----------------------------------------------------------
    def _op_init(self, msg):
        self._engine = self._build(msg["spec"])
        resilience = getattr(self._engine, "resilience", None)
        self._faults = getattr(resilience, "faults", NULL_INJECTOR)
        # replica-prefixed request ids (inference/scheduler.py): two
        # workers (or one worker across a restart) must never emit
        # colliding ids into fleet telemetry
        replica_id = msg["spec"].get("replica_id")
        sched = getattr(self._engine, "scheduler", None)
        set_prefix = getattr(sched, "set_id_prefix", None)
        if replica_id is not None and set_prefix is not None:
            set_prefix(replica_id)
        self._engine.serve_forever()
        threading.Thread(
            target=self._watch_loop, name="ds-worker-watch", daemon=True
        ).start()
        # the handshake's worker half: announce which frame schema this
        # worker speaks; the parent fail-fasts on a mismatch with a typed
        # error naming both versions (replica.py _check_protocol)
        self._emit({"event": "ready", "proto": RPC_PROTOCOL_VERSION})

    def _op_submit(self, msg):
        rpc_id = msg["id"]
        kwargs = dict(msg.get("kwargs") or {})
        # never block the single-threaded op loop on queue room: a full
        # queue must reject NOW (the parent falls through to another
        # replica) — a blocking wait here would stall every other RPC
        # (snapshots, drains) past the parent's timeout and read as a
        # dead replica
        kwargs.setdefault("timeout", 0.0)
        try:
            req = self._engine.submit(
                msg["prompt"],
                max_new_tokens=msg.get("max_new_tokens", 32),
                **kwargs,
            )
        except RequestRejected as e:
            self._emit({
                "event": "reply", "id": rpc_id,
                "error": str(e), "reason": e.reason,
            })
            return
        except (ValueError, TypeError) as e:
            # error_type distinguishes "this replica lacks the adapter"
            # (AdapterUnavailable — the router falls through to a holder)
            # from a genuinely invalid request
            self._emit({
                "event": "reply", "id": rpc_id, "error": str(e),
                "error_type": type(e).__name__,
            })
            return
        with self._state_lock:
            # (request, first_token_announced, tokens_streamed)
            self._tracked[rpc_id] = (req, False, 0)
        self._emit({"event": "reply", "id": rpc_id})

    def _op_cancel(self, msg):
        """Withdraw request ``id`` (the HTTP door's client-disconnect
        path relayed over the RPC): its slot frees within one decode
        step and the watch loop ships the ``cancelled`` finish. Unknown
        ids are a no-op — the request may have finished (and untracked)
        while the cancel frame was in flight."""
        with self._state_lock:
            entry = self._tracked.get(msg.get("id"))
        if entry is not None:
            cancel = getattr(entry[0], "cancel", None)
            if cancel is not None:
                cancel()

    def _op_snapshot(self, msg):
        self._emit({
            "event": "reply", "id": msg["id"],
            "snapshot": self._engine.load_snapshot(),
        })

    def _op_metrics_snapshot(self, msg):
        """The telemetry hub's scrape, relayed by the node agent: the
        engine's registry as JSON-safe wire entries (engines without a
        registry answer empty — the hub treats that as 'nothing to
        merge', not an error)."""
        reg = getattr(self._engine, "metrics", None)
        self._emit({
            "event": "reply", "id": msg["id"],
            "metrics": wire_snapshot(reg) if reg is not None else [],
        })

    def _op_adapter(self, msg, fn):
        """Shared load/unload wrapper: adapter management failures are
        op-level errors (the replica raises them to its caller), never
        worker crashes."""
        try:
            idx = fn()
        except Exception as e:
            self._emit({
                "event": "reply", "id": msg["id"], "error": str(e),
            })
            return
        self._emit({"event": "reply", "id": msg["id"], "index": int(idx)})

    def run(self):
        """Serve ops until shutdown/EOF. Returns 0 (clean) or 1 (an op
        loop crash — the parent sees the exit either way)."""
        try:
            for line in self._stdin:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    # one corrupted line on the pipe must cost its op,
                    # not the whole worker (the parent's ack timeout +
                    # breaker absorb the lost op; mirrors the parent
                    # reader's tolerance)
                    print(
                        f"worker: undecodable line {line[:200]!r}",
                        file=sys.stderr, flush=True,
                    )
                    continue
                op = msg.get("op")
                # fault site: op-loop stall (args.duration_ms) — every
                # parent RPC, snapshots included, waits this out while
                # the PROCESS stays alive: the hung-worker failure mode
                # the parent's unresponsive-snapshot path absorbs
                self._faults.maybe_stall("replica.hang")
                if op == "init":
                    self._op_init(msg)
                elif op == "submit":
                    self._op_submit(msg)
                elif op == "cancel":
                    self._op_cancel(msg)
                elif op == "snapshot":
                    self._op_snapshot(msg)
                elif op == "metrics_snapshot":
                    self._op_metrics_snapshot(msg)
                elif op == "load_adapter":
                    self._op_adapter(
                        msg,
                        lambda: self._engine.load_adapter(
                            msg["name"], load_dir=msg.get("load_dir"),
                            tag=msg.get("tag"),
                        ),
                    )
                elif op == "unload_adapter":
                    self._op_adapter(
                        msg,
                        lambda: self._engine.unload_adapter(msg["name"]),
                    )
                elif op == "brownout":
                    # fleet brownout toggle (docs/serving.md): fire-and-
                    # forget like drain; engines without the hook ignore
                    hook = getattr(self._engine, "set_brownout", None)
                    if hook is not None:
                        hook(bool(msg.get("on")))
                elif op == "drain":
                    self._engine.scheduler.drain()
                elif op == "shutdown":
                    break
                else:
                    print(
                        f"worker: unknown op {op!r}", file=sys.stderr,
                        flush=True,
                    )
            return 0
        except Exception as e:  # op-loop crash: the exit code is the signal
            print(f"worker: fatal: {e!r}", file=sys.stderr, flush=True)
            return 1
        finally:
            self._stop.set()
            if self._engine is not None:
                self._engine.close()


class _StubRequest:
    """Request handle with the InferenceRequest result surface, finished
    by a timer (or never, in hang mode)."""

    def __init__(self, tokens):
        self._pending = list(tokens)
        self.tokens = []
        self.finish_reason = None
        self.first_token_at = None
        self._done = threading.Event()

    @property
    def done(self):
        return self._done.is_set()

    def cancel(self):
        """The InferenceRequest cancel surface: finish now with reason
        ``"cancelled"`` (tokens so far are the partial answer) — even in
        hang mode, so the RPC cancel path is testable against a wedged
        stub."""
        if not self._done.is_set():
            self.finish_reason = "cancelled"
            self._done.set()

    def _finish(self):
        if self._done.is_set():
            return  # cancelled first: the timer's answer is discarded
        self.tokens = self._pending
        self.first_token_at = time.monotonic()
        self.finish_reason = "max_new_tokens"
        self._done.set()


class StubWorkerEngine:
    """A plain-Python engine for exercising the replica RPC seam itself —
    chaos tests and the fault-site matrix drive REAL worker subprocesses
    without paying a model and engine build per case. Spec block::

        {"stub": {"delay_secs": 0.02, "hang": false}, "config": {...}}

    Answers are a pure function of the prompt (deterministic across
    replicas, so exactly-once re-routing is assertable bitwise);
    ``hang: true`` makes it accept requests and never finish them — the
    zombie-replica failure mode (active slots, frozen completion
    counters). The config's ``resilience.fault_injection`` block arms
    the worker-side sites (``replica.hang``) like the real engine's
    does."""

    def __init__(self, stub_spec, config):
        from ..resilience.faults import build_fault_injector_from_dict

        self.delay_secs = float(stub_spec.get("delay_secs", 0.0))
        # token_delay_secs > 0 switches to INCREMENTAL emission: one
        # token appended per interval, so streaming/resume paths (the
        # door's SSE, journal adoption's prefix replay) see a real
        # mid-generation window without paying a real decode
        self.token_delay_secs = float(stub_spec.get("token_delay_secs", 0.0))
        self.hang = bool(stub_spec.get("hang", False))
        fi = (config.get("resilience") or {}).get("fault_injection") or {}

        class _Res:
            faults = build_fault_injector_from_dict(fi)

        self.resilience = _Res()
        self.scheduler = self
        self.brownout = False
        self._lock = threading.Lock()
        self._active = []
        self._completed = 0
        self._tokens_out = 0
        self._draining = False
        # the same infer/* surface the real engine exports, so remote
        # stub nodes are scrapeable by the telemetry hub (the fleet
        # /metrics acceptance pin runs against stub node subprocesses)
        self.metrics = MetricsRegistry()
        self._m_submitted = self.metrics.counter(
            "infer/requests_submitted",
            help="requests accepted by this replica",
        )
        self._m_completed = self.metrics.counter(
            "infer/requests_completed",
            help="requests finished by this replica",
        )
        self._m_tokens = self.metrics.counter(
            "infer/tokens_generated", help="tokens emitted by this replica",
        )
        self._m_active = self.metrics.gauge(
            "infer/active_slots", help="requests currently in flight",
        )
        self._m_ttft = self.metrics.histogram(
            "infer/ttft_ms", buckets=DEFAULT_TIME_BUCKETS_MS,
            help="stub time-to-first-token (the configured delay)",
        )

    # -- scheduler surface the worker/replica tier drives ---------------
    def serve_forever(self):
        pass

    def set_id_prefix(self, replica_id):
        pass

    def drain(self):
        self._draining = True

    def set_brownout(self, on):
        self.brownout = bool(on)

    def submit(self, prompt, max_new_tokens=32, **kwargs):
        if self._draining:
            raise RequestRejected(
                "stub engine draining", reason="draining"
            )
        base = int(prompt[-1]) if prompt else 0
        req = _StubRequest(
            [(base + i + 1) % 1000 for i in range(int(max_new_tokens))]
        )
        with self._lock:
            self._active.append(req)
            self._m_submitted.inc()
            self._m_active.set(len(self._active))
        if not self.hang:
            if self.token_delay_secs > 0:
                t = threading.Thread(
                    target=self._stream_tokens, args=(req,),
                    name="ds-stub-stream", daemon=True,
                )
                t.start()
            else:
                timer = threading.Timer(
                    self.delay_secs, self._complete, args=(req,)
                )
                timer.daemon = True
                timer.start()
        return req

    def _stream_tokens(self, req):
        """Incremental mode: append one pending token per interval (the
        poller streams each the moment it lands), then finish. A cancel
        mid-stream stops the emission with the partial answer."""
        time.sleep(self.delay_secs)
        for token in list(req._pending):
            if req.done:
                return
            time.sleep(self.token_delay_secs)
            if req.done:
                return
            req.tokens.append(token)
            if req.first_token_at is None:
                req.first_token_at = time.monotonic()
        self._complete(req)

    def _complete(self, req):
        req._finish()
        with self._lock:
            if req in self._active:
                self._active.remove(req)
            self._completed += 1
            self._tokens_out += len(req.tokens)
            self._m_completed.inc()
            self._m_tokens.inc(len(req.tokens))
            self._m_active.set(len(self._active))
        self._m_ttft.observe(self.delay_secs * 1e3)

    def load_snapshot(self):
        with self._lock:
            # prune finished husks: a CANCELLED request left the slot the
            # moment it finished, even though its completion timer (which
            # normally reaps it) has not fired yet
            self._active = [r for r in self._active if not r.done]
            active = len(self._active)
            completed, tokens = self._completed, self._tokens_out
        return {
            "queue_depth": 0, "queue_capacity": 8,
            "active_slots": active, "free_slots": max(8 - active, 0),
            "num_slots": 8, "health": 2 if self._draining else 0,
            "mean_prefill_ms": 1.0, "mean_decode_ms": 1.0,
            "p99_prefill_ms": 1.0, "mean_queue_wait_ms": 0.0,
            "requests_shed": 0.0, "restarts_used": 0,
            "requests_completed": completed, "tokens_generated": tokens,
            "driving": True, "stopped": self._draining,
            "driver_failed": False,
        }

    def close(self):
        self._draining = True


def build_engine_from_spec(spec):
    """The production engine builder: a GPT-2 from the spec's model
    kwargs, weights from the config's verified checkpoint load (or drawn
    from ``init_seed``), behind ``init_inference`` on the spec's
    ``device``. A spec carrying a ``"stub"`` block builds the plain-Python
    :class:`StubWorkerEngine` instead (chaos/protocol testing of the RPC
    seam)."""
    if spec.get("stub") is not None:
        return StubWorkerEngine(spec["stub"], spec.get("config") or {})
    from ..inference.engine import init_inference
    from ..models.gpt2 import GPT2Config, GPT2LMHeadModel

    model_kw = dict(spec.get("model") or {})
    model_kw.setdefault("dropout", 0.0)
    # drawn on the CPU: a generator's stream depends on its device, and
    # the engine copies the weights to its own device anyway
    model = GPT2LMHeadModel(GPT2Config(**model_kw), device="cpu",
                            seed=int(spec.get("init_seed", 0)))
    model.requires_grad_(False)
    return init_inference(
        model=model,
        config=spec.get("config") or {},
        rng_seed=int(spec.get("rng_seed", 0)),
        device=spec.get("device"),
    )


def kernel_launches():
    """The launches of the port's kernel wrappers in this process
    (``flash_fwd``, ``paged_decode``, ``sgmv``; each wrapper counts where
    it launches its CUDA kernel). Empty where no kernel module was
    imported, as under a stub engine."""
    ops = __package__.rsplit(".", 1)[0] + ".ops"
    out = {}
    for module, name, attr in (
        ("attention", "flash_fwd", "flash_fwd"),
        ("decode_attention", "paged_decode", "paged_flash_decode"),
        ("decode_attention", "sgmv", "lora_sgmv"),
    ):
        mod = sys.modules.get(f"{ops}.{module}")
        if mod is not None:
            out[name] = int(getattr(mod, attr).launches)
    return out


def main():
    import os

    # The protocol owns fd 1 EXCLUSIVELY: dup a private handle for the
    # server, then point fd 1 at stderr so every other writer in the
    # process (logging handlers, stray prints, torch and CUDA warnings)
    # lands on stderr instead of corrupting the parent's JSON stream.
    proto_out = os.fdopen(os.dup(sys.stdout.fileno()), "w", buffering=1)
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    server = WorkerServer(sys.stdin, proto_out, build_engine_from_spec)
    t0 = time.time()
    code = server.run()
    # the process's kernel launches, for a caller that checks that the
    # worker's engine served through the kernels
    print(f"worker: kernel launches {json.dumps(kernel_launches())}",
          file=sys.stderr, flush=True)
    print(
        f"worker: exiting after {time.time() - t0:.1f}s (code {code})",
        file=sys.stderr, flush=True,
    )
    sys.exit(code)


if __name__ == "__main__":
    main()
