"""Shared pieces of the networked fleet's parity tests (not a test module).

The parity tests run one script through each package's own classes and
compare what comes out. :func:`package` gives the classes of one package
by the name ``"jax"`` (the reference, deepspeed_tpu) or ``"torch"`` (the
port, deepspeed_tpu_torch), so a script is written once.
"""

import importlib
import time
from types import SimpleNamespace

ROOTS = {"jax": "deepspeed_tpu", "torch": "deepspeed_tpu_torch"}

_MODULES = {
    "serving": "serving",
    "transport": "serving.transport",
    "node": "serving.node",
    "replica": "serving.replica",
    "worker": "serving.worker",
    "router": "serving.router",
    "journal": "serving.journal",
    "autoscaler": "serving.autoscaler",
    "provisioner": "serving.provisioner",
    "http": "serving.http",
    "faults": "resilience.faults",
    "registry": "telemetry.registry",
    "tracing": "telemetry.tracing",
    "hub": "telemetry.hub",
    "timeseries": "telemetry.timeseries",
    "scheduler": "inference.scheduler",
}

_cache = {}


def package(name):
    """The modules of one package as attributes (``P.node.NodeServer``,
    ``P.transport.SocketReplica``, ...), ``P.name`` its key."""
    if name not in _cache:
        root = ROOTS[name]
        mods = {attr: importlib.import_module(f"{root}.{path}")
                for attr, path in _MODULES.items()}
        _cache[name] = SimpleNamespace(name=name, root=root, **mods)
    return _cache[name]


def expected_answer(prompt, max_new):
    """The stub engine's answer (both packages' worker.py): a pure
    function of the prompt."""
    base = prompt[-1] if prompt else 0
    return [(base + i + 1) % 1000 for i in range(max_new)]


def wait(predicate, timeout=30.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def stub_node(P, replicas=("r0",), *, delay=0.02, hang=False, config=None,
              node_id="n0", lease_secs=5.0, resume_grace_secs=5.0,
              token_delay=None, **extra):
    """An in-process node agent of package ``P`` on stub engines, not
    started."""
    stub = {"delay_secs": delay, "hang": hang}
    if token_delay is not None:
        stub["token_delay_secs"] = token_delay
    spec = {
        "node_id": node_id,
        "replicas": {name: {"stub": dict(stub)} for name in replicas},
        "lease_secs": lease_secs,
        "resume_grace_secs": resume_grace_secs,
    }
    if config is not None:
        spec["config"] = config
    spec.update(extra)
    return P.node.NodeServer(spec)


def socket_replica(P, node_or_addr, name="r0", *, rid=None, faults=None,
                   rpc_timeout=2.0, rpc_retries=1, reconnect_attempts=3,
                   **kw):
    address = getattr(node_or_addr, "address", node_or_addr)
    node_id = getattr(node_or_addr, "node_id", "n0")
    return P.transport.SocketReplica(
        rid or f"{node_id}:{name}", tuple(address), remote_name=name,
        rpc_timeout=rpc_timeout, rpc_retries=rpc_retries,
        rpc_backoff_secs=0.01, reconnect_backoff_secs=0.02,
        reconnect_attempts=reconnect_attempts, fault_injector=faults, **kw,
    )


def control(P, node_or_addr, *, epoch=None, timeout=5.0):
    address = getattr(node_or_addr, "address", node_or_addr)
    return P.transport.NodeControlClient(
        tuple(address), connect_timeout=timeout, op_timeout=timeout,
        epoch=epoch,
    )


def error_of(fn):
    """``(type name, text)`` of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the comparison is the point
        return type(e).__name__, str(e)
    return None


class _HostEngine:
    """A real ContinuousBatchingScheduler behind plain-Python decode
    hooks: each decode step yields the slot's last token + 1."""

    prefill_len = 16
    paged = False
    speculative = False

    def __init__(self, step_secs):
        self.step_secs = float(step_secs)
        self._last = {}
        self.scheduler = None

    def prefill_request(self, slot, prompt_tokens, temperature):
        del temperature
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


def host_engine(P, step_secs=0.0, num_slots=2):
    """An in-process engine of package ``P``: its real scheduler behind
    :class:`_HostEngine`'s decode hooks (answers as the stub engine's)."""
    engine = _HostEngine(step_secs=step_secs)
    engine.scheduler = P.scheduler.ContinuousBatchingScheduler(
        engine, num_slots=num_slots, max_seq_len=512, queue_depth=64,
        queue_timeout=0.0, eos_token_id=None, temperature=0.0,
        registry=P.registry.MetricsRegistry())
    return engine
