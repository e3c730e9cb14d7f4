"""Multi-replica serving tier: a fleet router in front of N engines.

Port of deepspeed_tpu/serving/ (docs/serving.md), the fleet inside one
host: the in-process and subprocess backends, the router and everything
it does with such replicas, and the HTTP door in front of it.

  admission.py — per-tenant token buckets + typed rejections
                 (RateLimited / FleetOverloaded, machine-readable
                 ``reason`` codes).
  breaker.py   — per-replica circuit breakers with seeded jitter.
  replica.py   — the uniform submit/health/drain/restart surface:
                 InProcessReplica (N engines, one process) and
                 SubprocessReplica (one engine per worker process,
                 newline-JSON RPC over pipes).
  worker.py    — the subprocess engine host
                 (``python -m deepspeed_tpu_torch.serving.worker``).
  http.py      — the HTTP/SSE front door (HTTPDoor / serve_http):
                 token streaming at TTFT, typed-rejection status codes,
                 disconnect/backpressure handling.
  router.py    — FleetRouter: pluggable placement (least-loaded /
                 round-robin / prefix-affinity / adapter-affinity),
                 rolling restarts under a capacity floor, breakers,
                 zombie detection, brownout, failed-replica eviction +
                 re-route, elastic add/remove replica, fleet/* telemetry.

The networked fleet and its control plane (the socket transport, the
node agent, the provisioner, the journal, the autoscaler and the
telemetry hub) are ROADMAP A8b: :func:`init_fleet` refuses the
``socket`` backend and a config that arms ``serving.journal``,
``serving.autoscale`` or ``serving.hub``.

``init_fleet`` is the config-driven front door, the fleet analog of
``deepspeed_tpu_torch.init_inference``.
"""

from ..config.config import DeepSpeedConfig, not_ported
from .admission import (
    AdmissionController,
    FleetOverloaded,
    RateLimited,
    TokenBucket,
)
from .breaker import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
)
from .http import HTTPDoor, serve_http
from .replica import (
    RPC_PROTOCOL_VERSION,
    InProcessReplica,
    RemoteRequest,
    ReplicaProtocolError,
    ReplicaRPCError,
    SubprocessReplica,
)
from .router import (
    PLACEMENT_POLICIES,
    AdapterAffinity,
    FleetRequest,
    FleetRouter,
    LeastLoaded,
    PrefixAffinity,
    RoundRobin,
)


def _resolve_config(config):
    """dict / JSON path / DeepSpeedConfig -> validated DeepSpeedConfig."""
    if isinstance(config, DeepSpeedConfig):
        return config
    return DeepSpeedConfig(config if config is not None else {},
                           world_size=1)


def init_fleet(engine_factory=None, worker_spec=None, nodes=None,
               config=None, registry=None, start=True):
    """Build (and by default start) a :class:`FleetRouter` from the
    config's ``"serving"`` block (docs/serving.md).

    Exactly one replica source is required:

    ``engine_factory``
        zero-arg callable returning a fresh ``InferenceEngine`` — used
        for the ``in_process`` backend, and called again on every replica
        restart. Give the factory's engines a config WITHOUT a telemetry
        block (fleet-level telemetry is the router's; per-replica state
        surfaces through load snapshots).
    ``worker_spec``
        the worker.py init spec — used for the ``subprocess`` backend;
        each replica spawns one worker process from it
        (``"device": "cpu"`` in it serves on the CPU).
    ``nodes``
        the ``socket`` backend's fleet map: refused, with the backend
        itself, until ROADMAP A8b ports the networked fleet.

    The router's fleet/* streams export through the config's
    ``"telemetry"`` block when enabled, or live on a private registry
    otherwise.
    """
    cfg = _resolve_config(config)
    sources = [s for s in (engine_factory, worker_spec, nodes)
               if s is not None]
    if len(sources) != 1:
        raise ValueError(
            "pass exactly one of engine_factory (in_process backend), "
            "worker_spec (subprocess backend), or nodes (socket backend)"
        )
    backend = cfg.serving_backend
    if backend == "socket" or nodes is not None:
        raise not_ported("the socket backend (ROADMAP A8b)")
    for armed, block in ((cfg.serving_journal_enabled, "serving.journal"),
                         (cfg.serving_autoscale_enabled,
                          "serving.autoscale"),
                         (cfg.serving_hub_enabled, "serving.hub")):
        if armed:
            raise not_ported(f"{block} (ROADMAP A8b)")
    expected_by_backend = {
        "in_process": engine_factory, "subprocess": worker_spec,
    }
    if expected_by_backend[backend] is None:
        wanted = {"in_process": "engine_factory",
                  "subprocess": "worker_spec"}[backend]
        raise ValueError(
            f"serving.backend is {backend!r} but {wanted} was not "
            "passed (and another replica source was)"
        )

    telemetry = None
    if registry is None:
        from ..runtime.dist import process_index
        from ..telemetry.manager import build_telemetry

        telemetry = build_telemetry(cfg, rank=process_index())
        if telemetry.enabled:
            registry = telemetry.registry
        else:
            telemetry = None
    if registry is None:
        # one registry for the whole fleet, so that every replica's
        # streams and the router's metrics meet
        from ..telemetry.registry import MetricsRegistry

        registry = MetricsRegistry()

    # fleet request tracer (telemetry/tracing.py): telemetry's when one
    # was built, a standalone from the config otherwise (callers passing
    # their own registry still get tracing when the block arms it)
    if telemetry is not None:
        tracer = telemetry.tracer
    else:
        from ..telemetry.tracing import build_tracer

        tracer = build_tracer(cfg)

    # serving-tier chaos (docs/resilience.md "Fault injection"): ONE
    # injector shared by the router and every replica transport, so
    # traversal counting spans the whole parent-side serving tier.
    # (Worker processes arm their own injector from the spec's config —
    # the worker-side sites live there.)
    from ..resilience.faults import build_fault_injector

    faults = build_fault_injector(cfg, registry=registry)

    if engine_factory is not None:
        replicas = [
            InProcessReplica(
                str(i), engine_factory,
                # in-process engines share the fleet tracer so their
                # scheduler spans land in the router's trace file
                tracer=tracer if tracer.enabled else None,
                fault_injector=faults,
            )
            for i in range(cfg.serving_replicas)
        ]
    else:
        replicas = [
            SubprocessReplica(
                str(i), worker_spec,
                rpc_timeout=cfg.serving_rpc_timeout_secs,
                rpc_retries=cfg.serving_rpc_retries,
                rpc_backoff_secs=cfg.serving_rpc_backoff_secs,
                fault_injector=faults,
            )
            for i in range(cfg.serving_replicas)
        ]

    router = FleetRouter(
        replicas,
        placement=cfg.serving_placement,
        affinity_prefix_tokens=cfg.serving_affinity_prefix_tokens,
        capacity_floor=cfg.serving_capacity_floor,
        shed_queue_ratio=cfg.serving_shed_queue_ratio,
        max_reroutes=cfg.serving_max_reroutes,
        rate_limit=(
            cfg.serving_rate_limit_rps, cfg.serving_rate_limit_burst,
        ),
        per_tenant_limits=cfg.serving_rate_limit_per_tenant,
        registry=registry,
        telemetry=telemetry,
        tracer=tracer,
        breaker_failure_threshold=cfg.serving_cb_failure_threshold,
        breaker_backoff_secs=cfg.serving_cb_backoff_secs,
        breaker_backoff_max_secs=cfg.serving_cb_backoff_max_secs,
        zombie_secs=cfg.serving_zombie_secs,
        zombie_restart_budget=cfg.serving_zombie_restart_budget,
        brownout_queue_ratio=cfg.serving_brownout_queue_ratio,
        brownout_max_new_tokens=cfg.serving_brownout_max_new_tokens,
        fault_injector=faults,
    )
    if start:
        router.start()
        if cfg.serving_drain_on_preemption:
            router.install_preemption_drain(
                signals=cfg.resilience_preemption_signals
            )
    return router


__all__ = [
    "AdapterAffinity",
    "AdmissionController",
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "CircuitBreaker",
    "FleetOverloaded",
    "FleetRequest",
    "FleetRouter",
    "HTTPDoor",
    "InProcessReplica",
    "LeastLoaded",
    "PLACEMENT_POLICIES",
    "PrefixAffinity",
    "RPC_PROTOCOL_VERSION",
    "RateLimited",
    "RemoteRequest",
    "ReplicaProtocolError",
    "ReplicaRPCError",
    "RoundRobin",
    "SubprocessReplica",
    "TokenBucket",
    "init_fleet",
    "serve_http",
]
