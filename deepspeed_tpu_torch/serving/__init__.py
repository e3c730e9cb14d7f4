"""Multi-replica serving tier: a fleet router in front of N engines.

Port of deepspeed_tpu/serving/ (docs/serving.md):

  admission.py — per-tenant token buckets + typed rejections
                 (RateLimited / FleetOverloaded, machine-readable
                 ``reason`` codes).
  breaker.py   — per-replica circuit breakers with seeded jitter.
  replica.py   — the uniform submit/health/drain/restart surface:
                 InProcessReplica (N engines, one process),
                 SubprocessReplica (one engine per worker process,
                 newline-JSON RPC over pipes), and SocketReplica
                 (transport.py — the same RPC over TCP to a node agent
                 on another host).
  worker.py    — the subprocess engine host
                 (``python -m deepspeed_tpu_torch.serving.worker``).
  node.py      — the multi-replica TCP node agent
                 (``python -m deepspeed_tpu_torch.serving.node``).
  http.py      — the HTTP/SSE front door (HTTPDoor / serve_http):
                 token streaming at TTFT, typed-rejection status codes,
                 disconnect/backpressure handling.
  router.py    — FleetRouter: pluggable placement (least-loaded /
                 round-robin / prefix-affinity / adapter-affinity),
                 rolling restarts under a capacity floor, breakers,
                 zombie detection, brownout, failed-replica eviction +
                 re-route, elastic add/remove replica, fleet/* telemetry.
  journal.py   — the control plane's write-ahead journal: a restarted
                 router recovers the fleet and adopts its live node
                 sessions.
  autoscaler.py— the SLO-driven predictive autoscaler: a per-phase cost
                 model predicts SLO-unmeetable load and changes replica
                 capacity BEFORE the brownout/shed cliff (scale-up,
                 drain-then-retire scale-down, chaos re-provisioning).
  provisioner.py— the whole-node lifecycle seam (NodeProvisioner /
                 LocalSubprocessProvisioner): the autoscaler's node
                 tier — launch, re-provision, and terminate entire
                 node agents with a health-confirmed join.

The fleet hub (``serving.hub``) is telemetry/hub.py.

``init_fleet`` is the config-driven front door, the fleet analog of
``deepspeed_tpu_torch.init_inference``.
"""

from ..config.config import DeepSpeedConfig
from ..telemetry.hub import TelemetryHub
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
from .autoscaler import (
    AUTOSCALE_DOWN,
    AUTOSCALE_HOLD,
    AUTOSCALE_REPROVISION,
    AUTOSCALE_UP,
    Autoscaler,
    AutoscalerPolicy,
    InProcessReplicaProvider,
    NoPlaceableCapacity,
    PhaseCostModel,
    SLOTargets,
    SocketNodeProvider,
    SubprocessReplicaProvider,
)
from .provisioner import (
    LocalSubprocessProvisioner,
    NodeHandle,
    NodeProvisioner,
    ProvisionFailed,
    StaticProvisioner,
    wait_for_node,
)
from .http import HTTPDoor, serve_http
from .journal import (
    AdoptionPlan,
    FleetJournal,
    load_journal_state,
    plan_adoption,
)
from .replica import (
    RPC_PROTOCOL_VERSION,
    FencedOut,
    InProcessReplica,
    RemoteRequest,
    ReplicaProtocolError,
    ReplicaRPCError,
    SubprocessReplica,
)
from .transport import SocketReplica
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
        the ``socket`` backend's fleet map (docs/serving.md "Networked
        fleet"): ``{node_name: {"address": "host:port", "replicas":
        ["r0", ...]}}`` — one :class:`SocketReplica` per (node, replica)
        pair, named ``"{node}:{replica}"``. Each node must already be
        serving (``python -m deepspeed_tpu_torch.serving.node``); the
        ``serving.socket`` block tunes leases and reconnects, and
        ``serving.replicas`` is ignored (the map IS the fleet).

    The router's fleet/* streams export through the config's
    ``"telemetry"`` block when enabled (same sinks as the engines), or
    live on a private registry otherwise.
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
    expected_by_backend = {
        "in_process": engine_factory, "subprocess": worker_spec,
        "socket": nodes,
    }
    if expected_by_backend.get(backend) is None:
        wanted = {"in_process": "engine_factory",
                  "subprocess": "worker_spec",
                  "socket": "nodes"}[backend]
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
        # one registry for the whole fleet: the socket replicas count
        # their fleet/net_* streams on whatever registry they're handed,
        # and the router's metrics must see them — a None here would
        # silo each transport's reconnects/corrupt-frames on a private
        # registry nobody can read
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
    # traversal counting spans the whole parent-side serving tier. (Worker
    # processes and node agents arm their own injector from the spec's
    # config — the worker-side sites
    # live there.)
    from ..resilience.faults import build_fault_injector

    faults = build_fault_injector(cfg, registry=registry)

    # durable control plane (journal.py, docs/serving.md "Control-plane
    # durability"): disabled (the default) builds NOTHING — no journal
    # object, no directory on disk, zero work on any request path. When
    # armed and a prior incarnation left a journal behind, recover the
    # newest valid snapshot and turn it into an adoption plan BEFORE
    # replica construction so the router starts with the adopted
    # sessions instead of dialing fresh ones over live generations.
    journal = None
    recovered = None
    socket_kwargs = dict(
        rpc_timeout=cfg.serving_rpc_timeout_secs,
        rpc_retries=cfg.serving_rpc_retries,
        rpc_backoff_secs=cfg.serving_rpc_backoff_secs,
        connect_timeout=cfg.serving_socket_connect_timeout_secs,
        connect_retries=cfg.serving_socket_connect_retries,
        lease_secs=cfg.serving_socket_lease_secs,
        reconnect_attempts=cfg.serving_socket_reconnect_attempts,
        reconnect_backoff_secs=cfg.serving_socket_reconnect_backoff_secs,
    )
    epoch = None
    if cfg.serving_journal_enabled:
        from .journal import (
            FleetJournal,
            load_journal_state,
            plan_adoption,
        )

        state, _recovery_info = load_journal_state(
            cfg.serving_journal_dir, registry=registry
        )
        # epoch fencing (docs/serving.md "Epoch fencing"): this life's
        # incarnation — the number FleetJournal adopts below (old + 1 on
        # recovery, 1 cold) — rides every node hello via socket_kwargs,
        # so node agents fence out any incarnation this one supersedes.
        # Computed BEFORE plan_adoption: the adoption dials are exactly
        # where each node's high-water mark must advance.
        epoch = (
            int(state.get("incarnation", 1)) + 1 if state is not None
            else 1
        )
        socket_kwargs["epoch"] = epoch
        if state is not None:
            recovered = plan_adoption(
                state, registry=registry, fault_injector=faults,
                socket_kwargs=socket_kwargs,
                control_timeout=cfg.serving_socket_connect_timeout_secs,
            )
        journal = FleetJournal(
            cfg.serving_journal_dir, registry=registry,
            fault_injector=faults,
            fsync=cfg.serving_journal_fsync,
            keep_segments=cfg.serving_journal_keep_segments,
            max_inflight=cfg.serving_journal_max_inflight,
            state=state,
        )
        for node_name, block in (nodes or {}).items():
            journal.record_node(node_name, block["address"])

    # SLO autoscaler (autoscaler.py, docs/serving.md "SLO autoscaling"):
    # built only when the block arms it — the disabled path constructs
    # NOTHING (no threads, no cost model, no per-tick work)
    autoscaler = None
    if cfg.serving_autoscale_enabled:
        if engine_factory is not None:
            provider = InProcessReplicaProvider(
                engine_factory,
                tracer=tracer if tracer.enabled else None,
                fault_injector=faults,
            )
        elif worker_spec is not None:
            provider = SubprocessReplicaProvider(
                worker_spec,
                rpc_timeout=cfg.serving_rpc_timeout_secs,
                rpc_retries=cfg.serving_rpc_retries,
                rpc_backoff_secs=cfg.serving_rpc_backoff_secs,
                fault_injector=faults,
            )
        else:
            # node tier (provisioner.py, docs/serving.md "Node failure
            # domain"): when the block arms it, the provider can launch
            # whole node agents — scale-up past every live node's
            # ceiling mints a new node, a dead node re-provisions under
            # its own name, an emptied provisioner-owned node terminates
            provisioner = None
            if cfg.serving_provisioner_enabled:
                from .provisioner import LocalSubprocessProvisioner

                provisioner = LocalSubprocessProvisioner(
                    cfg.serving_provisioner_node_spec,
                    launch_timeout=(
                        cfg.serving_provisioner_launch_timeout_secs
                    ),
                    terminate_grace=(
                        cfg.serving_provisioner_terminate_grace_secs
                    ),
                    epoch=epoch, registry=registry,
                )
            provider = SocketNodeProvider(
                nodes,
                rpc_timeout=cfg.serving_rpc_timeout_secs,
                rpc_retries=cfg.serving_rpc_retries,
                rpc_backoff_secs=cfg.serving_rpc_backoff_secs,
                connect_timeout=cfg.serving_socket_connect_timeout_secs,
                connect_retries=cfg.serving_socket_connect_retries,
                lease_secs=cfg.serving_socket_lease_secs,
                reconnect_attempts=cfg.serving_socket_reconnect_attempts,
                reconnect_backoff_secs=(
                    cfg.serving_socket_reconnect_backoff_secs
                ),
                registry=registry,
                fault_injector=faults,
                epoch=epoch,
                provisioner=provisioner,
                max_replicas_per_node=(
                    cfg.serving_provisioner_max_replicas_per_node
                    if cfg.serving_provisioner_enabled else None
                ),
                max_nodes=(
                    cfg.serving_provisioner_max_nodes
                    if cfg.serving_provisioner_enabled else None
                ),
            )
        autoscaler = Autoscaler(
            provider,
            slo=SLOTargets(
                ttft_p99_ms=cfg.serving_slo_ttft_p99_ms,
                token_p99_ms=cfg.serving_slo_token_p99_ms,
                eval_window_secs=cfg.serving_slo_eval_window_secs,
            ),
            min_replicas=cfg.serving_autoscale_min_replicas,
            max_replicas=cfg.serving_autoscale_max_replicas,
            cooldown_secs=cfg.serving_autoscale_cooldown_secs,
            hysteresis_secs=cfg.serving_autoscale_hysteresis_secs,
            flap_budget=cfg.serving_autoscale_flap_budget,
            flap_window_secs=cfg.serving_autoscale_flap_window_secs,
            scale_up_utilization=cfg.serving_autoscale_up_utilization,
            scale_down_utilization=(
                cfg.serving_autoscale_down_utilization
            ),
            interval_secs=cfg.serving_autoscale_interval_secs,
            drain_timeout_secs=cfg.serving_autoscale_drain_timeout_secs,
        )

    # fleet observability plane (telemetry/hub.py, docs/observability.md
    # "fleet-wide view"): same zero-overhead discipline as the
    # autoscaler — disabled constructs NOTHING (no scrape thread, no
    # ring, and the HTTP door's /metrics //statz //dashboard routes 404)
    hub = None
    if cfg.serving_hub_enabled:
        hub = TelemetryHub(
            nodes={
                name: block["address"]
                for name, block in (nodes or {}).items()
            },
            interval_secs=cfg.serving_hub_interval_secs,
            retention_points=cfg.serving_hub_retention_points,
            drain_interval_secs=cfg.serving_hub_drain_interval_secs,
            op_timeout_secs=cfg.serving_hub_op_timeout_secs,
            node_backoff_secs=cfg.serving_hub_node_backoff_secs,
            auth_exempt=cfg.serving_hub_auth_exempt,
            slo_target=cfg.serving_hub_alerts_slo_target,
            alert_fast_window_secs=(
                cfg.serving_hub_alerts_fast_window_secs
            ),
            alert_slow_window_secs=(
                cfg.serving_hub_alerts_slow_window_secs
            ),
            alert_fast_burn=cfg.serving_hub_alerts_fast_burn,
            alert_slow_burn=cfg.serving_hub_alerts_slow_burn,
            alert_breaker_flood=cfg.serving_hub_alerts_breaker_flood,
            alert_suppressed_growth=(
                cfg.serving_hub_alerts_suppressed_growth
            ),
        )

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
    elif worker_spec is not None:
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
    else:
        adopted = {
            r.replica_id: r
            for r in (recovered.replicas if recovered is not None else ())
        }
        replicas = []
        for node_name, block in nodes.items():
            address = block["address"]
            for rname in block.get("replicas") or ():
                rid = f"{node_name}:{rname}"
                if rid in adopted:
                    # resume the prior incarnation's live node session
                    # instead of dialing a fresh one over its still-
                    # running generations
                    replicas.append(adopted.pop(rid))
                    continue
                replicas.append(SocketReplica(
                    rid, address, remote_name=rname,
                    registry=registry,
                    fault_injector=faults,
                    **socket_kwargs,
                ))
        # journaled memberships absent from the restart's nodes map
        # still carry live generations — adopt them rather than orphan
        # their in-flight requests
        replicas.extend(adopted.values())
        if not replicas:
            raise ValueError(
                "the socket backend's nodes map names no replicas "
                '(expected {node: {"address": ..., "replicas": [...]}})'
            )

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
        autoscaler=autoscaler,
        hub=hub,
        journal=journal,
        recovered=recovered,
    )
    if start:
        router.start()
        if cfg.serving_drain_on_preemption:
            router.install_preemption_drain(
                signals=cfg.resilience_preemption_signals
            )
    return router


__all__ = [
    "AUTOSCALE_DOWN",
    "AUTOSCALE_HOLD",
    "AUTOSCALE_REPROVISION",
    "AUTOSCALE_UP",
    "AdapterAffinity",
    "AdmissionController",
    "AdoptionPlan",
    "Autoscaler",
    "AutoscalerPolicy",
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "CircuitBreaker",
    "FencedOut",
    "FleetJournal",
    "FleetOverloaded",
    "FleetRequest",
    "FleetRouter",
    "HTTPDoor",
    "InProcessReplica",
    "InProcessReplicaProvider",
    "LeastLoaded",
    "LocalSubprocessProvisioner",
    "NoPlaceableCapacity",
    "NodeHandle",
    "NodeProvisioner",
    "PLACEMENT_POLICIES",
    "PhaseCostModel",
    "ProvisionFailed",
    "PrefixAffinity",
    "RPC_PROTOCOL_VERSION",
    "RateLimited",
    "RemoteRequest",
    "ReplicaProtocolError",
    "ReplicaRPCError",
    "RoundRobin",
    "SLOTargets",
    "SocketNodeProvider",
    "SocketReplica",
    "StaticProvisioner",
    "SubprocessReplica",
    "SubprocessReplicaProvider",
    "TelemetryHub",
    "TokenBucket",
    "init_fleet",
    "load_journal_state",
    "plan_adoption",
    "serve_http",
    "wait_for_node",
]
