"""Engine-facing telemetry facade: registry, exporters, profiler window,
watchdog and tracer, and the engines' metric catalogs.

Port of deepspeed_tpu/telemetry/manager.py. One ``Telemetry`` instance
per engine, built from the config's ``"telemetry"`` block by
:func:`build_telemetry`. The training engine calls ``on_window_start``
at each accumulation window's first micro-step, ``count_batch`` per
micro-batch, ``heartbeat`` for liveness, and ``on_window_end`` after the
update; everything else (metric materialization cadence, export fan-out,
the profiler window, heartbeats) happens here.

No host sync per window: ``on_window_end`` receives the loss as a raw
device tensor and materializes it (``float()``, one host sync) only at
an export boundary, every ``interval`` windows, or at ``flush()`` for the
trailing windows. With telemetry disabled no hook touches a device
value.

The catalogs carry the JAX package's names, so dashboards read one
stream set from either engine. Absent by design: the JAX engine's
``jax/recompiles``, ``jax/compile_cache_hits`` and
``jax/compile_cache_misses`` counters (``jax.monitoring`` listeners);
PyTorch runs eagerly and the CUDA kernels build once per process. The
``dataloader/*`` rows are fed by the data loader and the window stager
(runtime/dataloader.py, runtime/staging.py) through the hooks below; the
ZeRO-3 rows are registered (the catalog is a golden set) and stay 0 until
ZeRO-3 is ported.
"""

import atexit
import contextlib
import os
import time
import weakref

import torch

from ..utils.logging import logger, warn_once
from .exporters import build_exporter
from .profiling import ProfilerWindow
from .registry import (
    DEFAULT_TIME_BUCKETS_MS,
    MetricsRegistry,
    suppressed_errors_snapshot,
)
from .tracing import NOOP_TRACER, build_tracer
from .watchdog import StepHeartbeatWatchdog

# The training engine's metric catalog (docs/observability.md documents
# each). Instruments are pre-registered at construction so every export
# carries the full golden set: an absent stream means a broken emitter,
# not an idle one.
ENGINE_METRICS = (
    ("gauge", "train/loss", "mean unscaled loss of the last settled window"),
    ("gauge", "train/learning_rate", "learning rate applied to the last window"),
    ("gauge", "train/loss_scale", "dynamic loss scale (fp16) or 1.0"),
    ("gauge", "train/grad_norm", "post-unscale global gradient norm"),
    ("gauge", "train/tokens_per_sec", "tokens consumed per second over the last export interval"),
    ("gauge", "train/samples_per_sec", "samples consumed per second over the last export interval"),
    ("gauge", "train/model_tflops", "model TFLOPS (6*N*tokens/sec) over the last export interval"),
    # gauges, not counters: these mirror engine counts that are revised
    # DOWNWARD — deferred-overflow reconciliation decrements global_steps
    # one window late and an in-process load_checkpoint rolls all three
    # back. A Prometheus counter that decreases reads as a reset-to-zero,
    # so rate() would extrapolate a huge spike on every reconciliation.
    ("gauge", "train/global_steps", "optimizer updates applied"),
    ("gauge", "train/skipped_steps", "windows skipped by overflow/non-finite grad norm"),
    ("gauge", "train/micro_steps", "micro-steps (forward+backward) run"),
    ("gauge", "device/bytes_in_use", "device bytes allocated by PyTorch's caching allocator (torch.cuda.memory_allocated; 0 on the CPU)"),
    ("gauge", "device/peak_bytes_in_use", "peak device bytes allocated (torch.cuda.max_memory_allocated; 0 on the CPU)"),
    # per-WINDOW HBM high-water (vs device/* above, which samples at the
    # export cadence): micro_batch headroom becomes visible in the
    # trajectory instead of inferred from crash logs. 0 on the CPU.
    ("gauge", "train/hbm_peak_bytes", "per-device HBM high-water (torch.cuda.max_memory_allocated) sampled at every window boundary; 0 on the CPU"),
    # ZeRO-3 layout gauges (docs/performance.md "ZeRO-3 & collective
    # overlap"): set once at engine init, 0 below stage 3
    ("gauge", "train/zero3_param_shard_bytes", "per-chip persistent parameter bytes under ZeRO-3 dp sharding (sharded tree / dp + replicated leaves); 0 below stage 3"),
    ("gauge", "train/zero3_gather_bytes_per_window", "estimated per-chip all-gather traffic per window for ZeRO-3 just-in-time weight gathers (forward + backward re-gather); 0 below stage 3"),
    # dataloader/* is the data-pipeline namespace (docs/performance.md
    # "Input pipeline & compile cache"): the loader's prefetch queue and
    # the window stager (runtime/staging.py) export here together
    ("gauge", "dataloader/queue_depth", "prefetch queue depth (sampled at batch handoff AND from the producer, so epoch-boundary refill is visible)"),
    ("gauge", "dataloader/staging_occupancy", "staged-but-unconsumed windows in the staging buffers"),
    ("counter", "dataloader/h2d_bytes", "host->device bytes dispatched by the input-staging pipeline"),
    ("histogram", "dataloader/staging_wait_ms", "critical-path wait for a staged window at dispatch (near-zero = staging fully overlapped with device compute)"),
    ("histogram", "dataloader/staging_time_ms", "background wall time to assemble one window (pull + stack + device_put dispatch)"),
    ("histogram", "train/window_time_ms", "host wall time per accumulation window"),
    # resilience streams (deepspeed_tpu/resilience/, docs/resilience.md):
    # the ResilienceManager registers into this same registry, so retry
    # storms and corruption fallbacks export next to the loss curves
    ("counter", "resilience/io_retries", "transient checkpoint-I/O failures retried with backoff"),
    ("counter", "resilience/corruption_fallbacks", "corrupt/missing checkpoint candidates skipped on load"),
    ("counter", "resilience/preemption_saves", "final checkpoints committed by the preemption drain"),
    ("counter", "resilience/checkpoints_pruned", "checkpoint directories deleted by retention GC"),
    ("histogram", "resilience/save_time_ms", "wall time of save_checkpoint, end to end"),
    ("histogram", "resilience/load_time_ms", "wall time of load_checkpoint, end to end"),
    # self-healing run supervision + fault injection (resilience/faults.py,
    # resilience/supervisor.py, docs/resilience.md)
    ("counter", "resilience/rollbacks", "in-process rollbacks to the last committed checkpoint (run supervisor)"),
    ("counter", "resilience/anomalies", "anomalous windows detected by the run supervisor (non-finite loss, loss spike, stall escalation, window failure)"),
    ("counter", "resilience/faults_injected", "faults fired by the config-armed fault-injection registry"),
)




# The inference engine's metric catalog (docs/inference.md,
# docs/observability.md); the InferenceEngine registers these into its
# registry via register_inference_metrics().
INFERENCE_METRICS = (
    ("histogram", "infer/ttft_ms", "time to first token: request admission through prefill + first sampled token"),
    ("histogram", "infer/token_latency_ms", "wall time of one continuous-batching decode step (one token per active slot; up to k+1 under speculative decoding — divide by tokens_generated deltas for per-token latency)"),
    ("histogram", "infer/prefill_time_ms", "wall time of one request's prefill (cache write + first-token logits)"),
    ("histogram", "infer/queue_wait_ms", "time a request waited in the admission queue before a slot freed"),
    ("gauge", "infer/tokens_per_sec", "decode tokens generated per second over the last export interval"),
    ("gauge", "infer/queue_depth", "requests waiting in the admission queue"),
    ("gauge", "infer/slot_occupancy", "decode slots currently serving a request"),
    ("counter", "infer/requests_admitted", "requests accepted into the admission queue"),
    ("counter", "infer/requests_rejected", "requests shed at the front door (queue full past the timeout)"),
    ("counter", "infer/requests_completed", "requests finished (EOS, max_new_tokens, or length cap)"),
    ("counter", "infer/tokens_generated", "decode tokens sampled across all requests"),
    # self-healing serving (docs/inference.md "Self-healing serving")
    ("counter", "infer/deadline_misses", "requests finished with reason 'deadline' (unmeetable at admission, or expired in flight)"),
    ("gauge", "infer/health_state", "serving health: 0 healthy, 1 degraded (shedding priority > 0), 2 draining"),
    ("counter", "infer/driver_restarts", "decode-driver auto-restarts from pinned params after a decode crash"),
    ("counter", "infer/requests_shed", "priority > 0 submissions shed at the front door while degraded"),
    # paged KV cache + cross-request prefix caching (docs/inference.md
    # "Paged KV cache"; all four stay 0 on a contiguous-cache engine
    # except kv_cache_bytes, which reports the contiguous cache's size)
    ("gauge", "infer/kv_pool_occupancy", "KV pages pinned by live requests (paged cache; cached refcount-0 pages are not occupancy)"),
    ("gauge", "infer/kv_cache_bytes", "device bytes held by the decode KV cache or page pool (k + v)"),
    ("counter", "infer/prefix_hits", "admissions that reused cached prefix pages (only the unique suffix was prefilled)"),
    ("counter", "infer/prefix_misses", "admissions that found no cached prefix pages (cold full prefill)"),
    ("counter", "infer/kv_blocks_reclaimed", "cached refcount-0 pages evicted LRU-first to satisfy new allocations"),
    # fused decode attention + speculative decoding (docs/inference.md
    # "Fused decode attention" / "Speculative decoding"; the spec_*
    # streams stay 0 on a non-speculative engine, fused_decode reads 0)
    ("gauge", "infer/fused_decode", "1 while the fused paged decode-attention kernel path is active (inference.fused_decode), else 0"),
    ("counter", "infer/spec_proposed", "draft-model tokens proposed to target verification (k per speculative decode step per active slot)"),
    ("counter", "infer/spec_accepted", "proposed draft tokens the target's verify step accepted (committed without correction)"),
    ("gauge", "infer/spec_acceptance_rate", "cumulative spec_accepted / spec_proposed (0 before the first speculative step)"),
)


def register_inference_metrics(registry):
    """Pre-register the full infer/* catalog on ``registry`` so every
    inference export carries the golden set (an absent stream means a
    broken emitter, not an idle one)."""
    for kind, name, help_text in INFERENCE_METRICS:
        getattr(registry, kind)(name, help=help_text)
    return registry


# The fleet router's catalog (serving/router.py, docs/serving.md): the
# JAX package's golden set, the streams of the networked fleet, the
# autoscaler and the journal included (they stay 0 until those parts
# of the fleet are ported). Per-replica gauges ride dynamically as
# fleet/replica{i}/*.
SERVING_METRICS = (
    ("histogram", "fleet/ttft_ms", "fleet-level time to first token: router admission through the serving replica's first sampled token"),
    ("gauge", "fleet/ttft_p50_ms", "p50 TTFT interpolated from the fleet/ttft_ms buckets at the last telemetry refresh"),
    ("gauge", "fleet/ttft_p99_ms", "p99 TTFT interpolated from the fleet/ttft_ms buckets at the last telemetry refresh"),
    ("gauge", "fleet/replicas_total", "replicas registered with the router (evicted replicas leave this count)"),
    ("gauge", "fleet/replicas_available", "replicas currently routable (not draining, not restarting, not failed)"),
    ("gauge", "fleet/queue_depth", "requests waiting across every replica's admission queue"),
    ("gauge", "fleet/slot_occupancy", "decode slots serving a request across the fleet"),
    ("counter", "fleet/requests_routed", "requests placed onto a replica by the router"),
    ("counter", "fleet/requests_rerouted", "requests re-placed after their replica failed under them"),
    ("counter", "fleet/requests_completed", "fleet requests finished with a terminal answer"),
    ("counter", "fleet/requests_rate_limited", "submissions rejected by a tenant's token bucket (RateLimited)"),
    ("counter", "fleet/requests_rejected", "submissions rejected at the router door for any reason (rate limit, overload, draining)"),
    ("counter", "fleet/affinity_hits", "placements that landed on the prompt prefix's affinity replica"),
    ("counter", "fleet/replica_restarts", "replica restarts driven by the router (rolling_restart or explicit restart)"),
    ("counter", "fleet/replicas_evicted", "replicas evicted after their decode driver failed past its restart budget"),
    ("gauge", "fleet/prefix_hit_rate", "fleet-wide prefix-cache hit rate (sum of replica hits / lookups at the last refresh; 0 with no paged replicas)"),
    ("counter", "fleet/adapter_loads", "per-replica LoRA adapter installs driven through the router's load_adapter"),
    ("gauge", "fleet/adapters_loaded", "distinct LoRA adapters resident across the fleet at the last refresh"),
    # chaos hardening (docs/serving.md "Circuit breakers" / "Zombie
    # detection" / "Brownout degradation"); per-replica circuit_state
    # gauges ride dynamically as fleet/replica{i}/circuit_state
    ("counter", "fleet/breaker_opens", "circuit-breaker trips: a replica hit its consecutive-RPC-failure threshold and left every placement candidate set"),
    ("counter", "fleet/breaker_probes", "half-open probe submissions (exactly one per open backoff window)"),
    ("counter", "fleet/zombie_restarts", "replicas drained-then-restarted by zombie detection (active slots with frozen completion counters, or a live-but-unresponsive worker)"),
    ("gauge", "fleet/brownout", "1 while the fleet queue fill sits in the brownout band (sheddable requests degrade instead of queueing toward the shed cliff)"),
    ("counter", "fleet/requests_browned_out", "priority > 0 submissions admitted with max_new_tokens clamped to the brownout floor"),
    # networked fleet (docs/serving.md "Networked fleet"): the socket
    # transport's failure envelope + the HTTP/SSE door's stream health
    ("counter", "fleet/net_reconnects", "socket-transport reconnect-with-resume successes: a dropped connection re-attached to the node's in-flight session instead of burning a re-route"),
    ("counter", "fleet/net_lease_expiries", "socket connections torn down after a silent heartbeat-lease window (the half-open-link detector)"),
    ("counter", "fleet/net_frames_corrupt", "received socket frames dropped for failing the length check or JSON decode (idempotent-RPC retry re-asks; submits fall through placement)"),
    ("counter", "fleet/net_slow_client_drops", "HTTP streams dropped by the overrun policy: the client drained slower than its tokens arrived, so the request cancelled and the slot freed"),
    # SLO autoscaling (docs/serving.md "SLO autoscaling"): the predictive
    # cost-model view and the elastic-capacity transitions it drives
    ("gauge", "fleet/requests_shed", "requests shed at replica doors fleet-wide (sum of the live replicas' shed counters at the last refresh)"),
    ("gauge", "fleet/slo_ttft_p99_ms", "configured serving.slo.ttft_p99_ms target (0 = no TTFT SLO configured)"),
    ("gauge", "fleet/slo_token_p99_ms", "configured serving.slo.token_p99_ms target (0 = no token-latency SLO configured)"),
    ("gauge", "fleet/slo_predicted_ttft_ms", "cost-model-predicted TTFT under the current arrival rate and fleet capacity (the autoscaler's scale-up signal)"),
    ("gauge", "fleet/slo_predicted_token_ms", "cost-model-predicted per-token decode latency at the current occupancy"),
    ("gauge", "fleet/slo_utilization", "predicted fleet utilization: observed arrival rate over the cost model's sustainable request rate"),
    ("gauge", "fleet/slo_error_budget_remaining", "fraction of the serving.slo.eval_window_secs window's samples meeting the SLO (1.0 = full budget; decays as observed p99 breaches the target)"),
    ("counter", "fleet/slo_violations", "autoscaler evaluation samples where the observed fleet TTFT p99 exceeded the configured SLO target"),
    ("gauge", "fleet/autoscale_target_replicas", "the autoscaler's current desired replica count (live capacity below this triggers re-provisioning)"),
    ("counter", "fleet/autoscale_ups", "scale-up transitions executed (a new replica spawned and registered behind its half-open probe)"),
    ("counter", "fleet/autoscale_downs", "scale-down transitions executed (a replica drained, retired, and its gauges removed)"),
    ("counter", "fleet/autoscale_reprovisions", "replicas re-provisioned after chaos took capacity away (eviction, node death) — live count restored to the target"),
    ("counter", "fleet/autoscale_refusals", "autoscale decisions refused by a clamp or a typed capacity refusal: cooldown, flap budget, the min/max replica bounds, or zero placeable capacity (per-reason fleet/autoscale_refusals/<code> counters register dynamically)"),
    ("counter", "fleet/autoscale_failures", "scale operations that failed mid-execution (spawn raised, node unreachable, retire refused)"),
    ("counter", "fleet/nodes_provisioned", "node agents launched by the provisioner seam (fresh mints and re-provisions of a dead node under its own name alike)"),
    ("counter", "fleet/nodes_terminated", "provisioner-owned node agents terminated whole after scale-down drained their last replica"),
    ("counter", "door/requests", "HTTP requests accepted by the front door"),
    ("gauge", "door/open_streams", "SSE token streams currently open on the door"),
    ("histogram", "door/stream_ttft_ms", "door-observed time to first streamed token event (request receipt to the first SSE token flush)"),
    ("counter", "door/client_disconnects", "streams abandoned by the client before completion; their fleet requests cancel and the replica slot frees within one decode step"),
    # durable control plane (docs/serving.md "Control-plane
    # durability"): the fleet-state journal + crash-recovery envelope.
    # fleet/journal_* counters register dynamically when the journal
    # block arms (the disabled fleet builds no journal and exports
    # nothing): journal_writes (segments committed), journal_recoveries
    # (startups that adopted a prior incarnation's snapshot),
    # journal_corruptions (segments rejected by the checksum/decode
    # walk), journal_inflight_evicted (in-flight descriptors dropped
    # past serving.journal.max_inflight).
    ("gauge", "fleet/adopted_replicas", "replicas adopted from a prior router incarnation's journal at the last recovery (0 after a cold start)"),
    ("counter", "door/streams_resumed", "SSE streams re-attached by a reconnecting client via Idempotency-Key + Last-Event-ID (the committed prefix replayed from the event id forward)"),
    ("counter", "door/idempotent_replays", "requests answered from the door's idempotency cache without re-submitting to the fleet (terminal result replayed verbatim)"),
)


def register_serving_metrics(registry):
    """Pre-register the fleet-level fleet/* catalog on ``registry`` (the
    same golden-set contract ENGINE_METRICS / INFERENCE_METRICS give the
    engines: an absent stream means a broken emitter, not an idle
    fleet)."""
    for kind, name, help_text in SERVING_METRICS:
        getattr(registry, kind)(name, help=help_text)
    return registry


# Multi-tenant LoRA serving (adapters/). Registered by InferenceEngine
# ONLY when the adapters block is enabled — adapter-free engines keep
# their exports at the INFERENCE_METRICS set. Per-adapter request
# counters ride dynamically as adapters/requests/{name} (tenant names are
# runtime values, not catalog constants).
ADAPTER_METRICS = (
    ("gauge", "adapters/pool_occupancy", "adapter pool rows holding a loaded adapter (the identity row 0 is not counted)"),
    ("gauge", "adapters/pool_slots", "adapter pool capacity: loadable rows (adapters.pool_slots; identity row 0 rides extra)"),
    ("counter", "adapters/loads", "adapters installed into the in-HBM pool (hot reloads included)"),
    ("counter", "adapters/evictions", "adapters evicted from the pool (idle-LRU under load pressure, or explicit unload)"),
    ("counter", "adapters/requests", "submissions carrying an adapter (per-adapter counts ride adapters/requests/{name})"),
)


def register_adapter_metrics(registry):
    """Pre-register the adapters/* catalog on ``registry`` (same golden-
    set contract as the other catalogs: an absent stream means a broken
    emitter, not an idle pool)."""
    for kind, name, help_text in ADAPTER_METRICS:
        getattr(registry, kind)(name, help=help_text)
    return registry


# Host-memory spill tier (inference/host_tier.py). Registered by
# InferenceEngine ONLY when the inference.host_tier block is enabled —
# tier-free engines keep their exports at the INFERENCE_METRICS set.
# Counters are the ENGINE's view (its own spills/promotions); the
# occupancy/entries gauges mirror the (possibly peer-shared) tier itself.
HOST_TIER_METRICS = (
    ("gauge", "host_tier/occupancy_bytes", "host RAM held by parked KV pages and adapter rows in this engine's spill tier (shared across co-hosted engines under peer_sharing)"),
    ("gauge", "host_tier/entries", "entries parked in the spill tier (KV pages + adapter rows)"),
    ("counter", "host_tier/spills", "device-to-host parks by this engine: evicted prefix pages and adapter rows copied to host RAM instead of dropped"),
    ("counter", "host_tier/promotions", "host-to-device promotions by this engine: chain-hash / adapter-name hits served from the spill tier"),
    ("counter", "host_tier/peer_fetches", "promotions whose entry was parked by a DIFFERENT co-hosted engine (one tenant's warm template/adapter warming a peer)"),
    ("counter", "host_tier/preemptions", "requests preempted under page pressure (lazy_alloc): pages parked, request re-queued for suffix-only resume"),
    ("counter", "host_tier/copy_faults", "faults absorbed at the copy seam (host_tier.copy chaos + failed placements): the spill was skipped or the promotion fell back to a cold re-prefill"),
)


def register_host_tier_metrics(registry):
    """Pre-register the host_tier/* catalog on ``registry`` (same
    golden-set contract: an absent stream means a broken emitter, not an
    idle tier)."""
    for kind, name, help_text in HOST_TIER_METRICS:
        getattr(registry, kind)(name, help=help_text)
    return registry


def hbm_peak_bytes(device=None):
    """Per-device HBM high-water (``torch.cuda.max_memory_allocated``),
    or None on the CPU. The probe behind the ``train/hbm_peak_bytes``
    gauge."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


class Telemetry:
    def __init__(
        self,
        enabled=False,
        exporters=(),
        interval=1,
        n_params=0,
        profiler=None,
        watchdog=None,
        registry=None,
        tracer=None,
        device=None,
    ):
        self.enabled = enabled
        # the engine's device: memory gauges read it (None or the CPU:
        # they stay 0)
        self.device = device
        self.registry = registry or MetricsRegistry()
        self.exporters = list(exporters)
        self.interval = max(1, int(interval))
        self.n_params = int(n_params)
        self.profiler = profiler
        self.watchdog = watchdog
        # request/step tracer (tracing.py): the zero-overhead NOOP
        # passthrough unless the telemetry.tracing block armed one
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        # lazy per-run trace the training spans parent under (one
        # trace_id for the run's window/staging/checkpoint spans)
        self._train_ctx = None
        self._window_start_mono = None
        self._windows_ended = 0
        self._windows_since_export = 0
        self._pending_values = None
        self._window_start = None
        self._last_export_time = None
        self._tokens_since_export = 0
        self._samples_since_export = 0
        # per-window HBM sampling stops probing after the first "platform
        # reports no memory stats" answer (CPU backends)
        self._hbm_stats_absent = False
        if not enabled:
            return
        for kind, name, help_text in ENGINE_METRICS:
            getattr(self.registry, kind)(name, help=help_text)
        if self.watchdog is not None:
            self.watchdog.start()
            # the polling thread keeps the watchdog itself alive, so a
            # dropped engine (retry loop, notebook rebuild) would leak the
            # thread and fire a spurious stall report ~timeout later;
            # stop it as soon as this facade is collected (the bound
            # method references the watchdog, not self — no self-cycle)
            weakref.finalize(self, self.watchdog.stop)
        # Close at interpreter exit (weakly — engines created and dropped
        # in tests are not kept alive): stops the watchdog, terminates a
        # still-open trace window, and flushes/closes the sinks for jobs
        # that never call close() themselves. close() flips enabled off,
        # so an explicit close makes this a no-op.
        ref = weakref.ref(self)

        def _close_at_exit():
            t = ref()
            if t is not None and t.enabled:
                try:
                    t.close()
                except Exception as e:  # interpreter exit: log, go on
                    logger.warning("telemetry close at exit failed: %r", e)

        # kept so close() can unregister: a sweep/notebook that builds N
        # engines in one process must not accumulate N dead callbacks
        self._atexit_cb = _close_at_exit
        atexit.register(_close_at_exit)

    # -- engine hooks ---------------------------------------------------
    def on_window_start(self):
        if not self.enabled:
            return
        if self.profiler is not None:
            self.profiler.on_window_start()
        self._window_start = time.time()
        if self.tracer.enabled:
            self._window_start_mono = time.monotonic()

    def count_batch(self, tokens, samples):
        if not self.enabled:
            return
        self._tokens_since_export += int(tokens)
        self._samples_since_export += int(samples)

    def on_window_end(
        self,
        loss=None,
        grad_norm=None,
        loss_scale=None,
        lr=None,
        global_steps=0,
        skipped_steps=0,
        micro_steps=0,
    ):
        """Window bookkeeping; ``loss``/``grad_norm``/``loss_scale`` may be
        raw device tensors: they are only materialized at export
        boundaries (see module docstring)."""
        if not self.enabled:
            return
        if self.profiler is not None:
            self.profiler.on_window_end()
        now = time.time()
        # true window duration (first dispatch -> update dispatched), not
        # the end-to-end gap: the gap also counts dataloader wait and eval
        # phases between windows, which would poison the histogram
        if self._window_start is not None:
            hist = self.registry.histogram(
                "train/window_time_ms", buckets=DEFAULT_TIME_BUCKETS_MS
            )
            span = None
            if self.tracer.enabled and self._window_start_mono is not None:
                span = self._record_train_span(
                    "train.window", self._window_start_mono,
                    time.monotonic(),
                    attrs={
                        "window": self._windows_ended + 1,
                        "global_steps": int(global_steps),
                        "micro_steps": int(micro_steps),
                    },
                )
                self._window_start_mono = None
            hist.observe(
                (now - self._window_start) * 1000.0,
                # only SAMPLED traces reach the export file: an exemplar
                # pointing at an unsampled trace is a dead link
                trace_id=(
                    span["trace_id"] if span and span["sampled"] else None
                ),
            )
            self._window_start = None
        self._windows_ended += 1
        self._sample_hbm_peak()
        if self.watchdog is not None:
            self.watchdog.beat(step=self._windows_ended)
        self.registry.gauge("train/global_steps").set(global_steps)
        self.registry.gauge("train/skipped_steps").set(skipped_steps)
        self.registry.gauge("train/micro_steps").set(micro_steps)
        self._windows_since_export += 1
        if self._windows_since_export >= self.interval:
            self._materialize(loss, grad_norm, loss_scale, lr, now)
            self.export(step=global_steps)
            self._windows_since_export = 0
            self._pending_values = None
        else:
            # raw device refs only (no host sync): flush() settles these
            # so the trailing windows % interval are not lost when the
            # run ends between export boundaries
            self._pending_values = (loss, grad_norm, loss_scale, lr,
                                    global_steps)

    def heartbeat(self):
        """Non-window liveness beat: eval forwards call this so a long
        eval epoch is not read as a stall. Does not advance the
        last-completed-window index in stall reports."""
        if self.enabled and self.watchdog is not None:
            self.watchdog.beat()

    @contextlib.contextmanager
    def liveness_exempt(self):
        """Suspend stall detection for a phase with no step cadence of its
        own — a checkpoint save can legitimately outlast the watchdog
        timeout, and a single beat before/after it would not keep a
        LONGER-than-timeout save from firing a false stall mid-phase.
        The stall clock restarts when the phase exits."""
        if self.enabled and self.watchdog is not None:
            self.watchdog.pause()
            try:
                yield
            finally:
                self.watchdog.resume()
        else:
            yield

    def _sample_hbm_peak(self):
        """Per-window HBM high-water sample (train/hbm_peak_bytes): one
        cheap host call where the platform reports memory stats, a no-op
        (after the first probe) everywhere else."""
        if self._hbm_stats_absent:
            return
        peak = hbm_peak_bytes(self.device)
        if peak is None:
            self._hbm_stats_absent = True  # CPU etc.: stop probing
            return
        self.registry.gauge("train/hbm_peak_bytes").set(peak)

    def train_trace_ctx(self):
        """The run's lazily-started train trace context: window, staging,
        checkpoint, and rollback spans all parent here, so Perfetto shows
        the run as ONE connected track (None while tracing is off)."""
        if self._train_ctx is None:
            self._train_ctx = self.tracer.child_of(None)
        return self._train_ctx

    def _record_train_span(self, name, t0, t1, attrs=None):
        return self.tracer.record(
            name, t0, t1, ctx=self.train_trace_ctx(), attrs=attrs
        )

    def set_zero3_layout(self, shard_bytes, gather_bytes_per_window):
        """Static ZeRO-3 layout gauges (engine init, stage 3 only)."""
        if not self.enabled:
            return
        self.registry.gauge("train/zero3_param_shard_bytes").set(
            shard_bytes)
        self.registry.gauge("train/zero3_gather_bytes_per_window").set(
            gather_bytes_per_window)

    # -- data pipeline (runtime/dataloader.py, runtime/staging.py) -------
    def set_dataloader_depth(self, depth):
        if not self.enabled:
            return
        self.registry.gauge("dataloader/queue_depth").set(depth)

    def set_staging_occupancy(self, depth):
        if not self.enabled:
            return
        self.registry.gauge("dataloader/staging_occupancy").set(depth)

    def observe_staging_wait(self, ms):
        if not self.enabled:
            return
        self.registry.histogram(
            "dataloader/staging_wait_ms", buckets=DEFAULT_TIME_BUCKETS_MS
        ).observe(ms)

    def observe_staging_time(self, ms):
        if not self.enabled:
            return
        if self.tracer.enabled:
            # the staging worker just assembled one window: its span from
            # the measured duration (called from the worker thread; the
            # tracer is thread-safe)
            now = time.monotonic()
            self._record_train_span(
                "train.stage_window", now - ms / 1e3, now
            )
        self.registry.histogram(
            "dataloader/staging_time_ms", buckets=DEFAULT_TIME_BUCKETS_MS
        ).observe(ms)

    def count_h2d_bytes(self, nbytes):
        if not self.enabled:
            return
        self.registry.counter("dataloader/h2d_bytes").inc(nbytes)

    # -- internals ------------------------------------------------------
    def _materialize(self, loss, grad_norm, loss_scale, lr, now):
        """Resolve device values and derived rates into gauges. The
        float() calls below are the subsystem's only host syncs."""
        reg = self.registry
        if loss is not None:
            reg.gauge("train/loss").set(float(loss))
        if grad_norm is not None:
            gn = float(grad_norm)
            # -1.0 is the engine's non-finite sentinel (skipped update);
            # a skipped window keeps the previous finite norm on the gauge
            if gn >= 0.0:
                reg.gauge("train/grad_norm").set(gn)
        if loss_scale is not None:
            reg.gauge("train/loss_scale").set(float(loss_scale))
        if lr is not None:
            reg.gauge("train/learning_rate").set(float(lr))
        if self._last_export_time is not None:
            elapsed = now - self._last_export_time
            if elapsed > 0:
                tps = self._tokens_since_export / elapsed
                reg.gauge("train/tokens_per_sec").set(tps)
                reg.gauge("train/samples_per_sec").set(
                    self._samples_since_export / elapsed
                )
                # bench.py's model-flops accounting: 6*N per token
                # (fwd 2N + bwd 4N), the measured-throughput MFU numerator
                reg.gauge("train/model_tflops").set(
                    6.0 * self.n_params * tps / 1e12
                )
        self._last_export_time = now
        self._tokens_since_export = 0
        self._samples_since_export = 0
        self._set_memory_gauges()

    def _set_memory_gauges(self):
        device = self.device
        if device is None or torch.device(device).type != "cuda":
            return  # gauges stay 0 on the CPU
        self.registry.gauge("device/bytes_in_use").set(
            torch.cuda.memory_allocated(device)
        )
        self.registry.gauge("device/peak_bytes_in_use").set(
            torch.cuda.max_memory_allocated(device)
        )

    def export(self, step=None):
        if not self.enabled:
            return
        metrics = self.registry.collect()
        for exporter in self.exporters:
            try:
                exporter.export(metrics, step)
            except Exception as e:
                # once per exporter: a full disk fails EVERY export and
                # would bury the log at the default interval=1 cadence
                warn_once(
                    f"telemetry-exporter-{type(exporter).__name__}",
                    "telemetry exporter %s failed: %s",
                    type(exporter).__name__, e,
                )

    def flush(self):
        """Settle and export any windows past the last export boundary
        (one host sync), then flush the sinks — without this a run ending
        mid-interval would record state stale by up to interval-1
        windows."""
        if self.enabled and self._pending_values is not None:
            loss, grad_norm, loss_scale, lr, global_steps = (
                self._pending_values
            )
            self._materialize(loss, grad_norm, loss_scale, lr, time.time())
            self.export(step=global_steps)
            self._windows_since_export = 0
            self._pending_values = None
        for exporter in self.exporters:
            try:
                exporter.flush()
            except Exception as e:
                warn_once(
                    f"telemetry-exporter-flush-{type(exporter).__name__}",
                    "telemetry exporter %s flush failed: %s",
                    type(exporter).__name__, e,
                )
        self.tracer.flush()

    def close(self):
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.profiler is not None:
            self.profiler.close()
        self.flush()
        for exporter in self.exporters:
            try:
                exporter.close()
            except Exception as e:
                warn_once(
                    f"telemetry-exporter-close-{type(exporter).__name__}",
                    "telemetry exporter %s close failed: %s",
                    type(exporter).__name__, e,
                )
        self.tracer.close()
        self.enabled = False
        cb = getattr(self, "_atexit_cb", None)
        if cb is not None:
            atexit.unregister(cb)
            self._atexit_cb = None


def build_telemetry(config, rank=0, n_params=0, timers=None, fence_fn=None,
                    device=None):
    """Construct the engine's Telemetry from a validated DeepSpeedConfig.

    Rank policy: jsonl/tensorboard exporters and the profiler trace run on
    process 0 only (the reference's tensorboard convention); the
    Prometheus textfile is written by EVERY process (pod scrapers are
    per-host — the filename gains a ``.rank{N}`` suffix on multi-process
    meshes) and the watchdog runs everywhere, because the stalled rank is
    exactly the one rank-0 gating would silence. ``device`` is the
    engine's: the memory gauges and the profiler's CUDA activity follow
    it (the CPU when the caller asked for the CPU).
    """
    if not getattr(config, "telemetry_enabled", False):
        return Telemetry(enabled=False)

    base = config.telemetry_output_path or os.path.join(
        os.path.expanduser("~"), "telemetry"
    )
    out_dir = os.path.join(base, config.telemetry_job_name)
    os.makedirs(out_dir, exist_ok=True)

    process_count = config.world_size
    prometheus_path = config.telemetry_prometheus_path or os.path.join(
        out_dir, "metrics.prom"
    )
    if process_count > 1:
        # rank goes BEFORE the extension: textfile collectors glob
        # '*.prom', so 'metrics.prom.rank1' would never be scraped
        root, ext = os.path.splitext(prometheus_path)
        prometheus_path = f"{root}.rank{rank}{ext}"

    if (
        "tensorboard" in config.telemetry_exporters
        and getattr(config, "tensorboard_enabled", False)
        and rank == 0
    ):
        # both sinks are legitimate alone: the legacy block writes exact
        # per-step Train/* curves (overflow-settled indices), the exporter
        # samples registry gauges at the export cadence. Together they put
        # two near-duplicate stream families in tensorboard — flag it.
        logger.warning(
            "both the 'tensorboard' config block and the telemetry "
            "'tensorboard' exporter are enabled: expect duplicate "
            "Train/* (per-step) and train/* (sampled) scalar streams"
        )

    exporters = []
    for name in config.telemetry_exporters:
        if name != "prometheus" and rank != 0:
            continue
        exporters.append(
            build_exporter(
                name, out_dir, config.telemetry_job_name,
                prometheus_path=prometheus_path,
            )
        )

    profiler = None
    if config.telemetry_profile_start_step >= 0 and rank == 0:
        profiler = ProfilerWindow(
            start_step=config.telemetry_profile_start_step,
            num_steps=config.telemetry_profile_num_steps,
            output_path=config.telemetry_profile_output_path
            or os.path.join(out_dir, "profile"),
            fence=fence_fn,
            device=device,
        )

    registry = MetricsRegistry()
    # request tracing + flight recorder (tracing.py): NOOP unless the
    # telemetry.tracing block arms it; the trace file and flight dumps
    # land in the same output directory as the metric sinks
    tracer = build_tracer(config, out_dir=out_dir)
    watchdog = None
    if config.telemetry_watchdog_enabled:
        from ..utils.timers import SynchronizedWallClockTimer

        def _stall_context():
            context = {
                "device_memory": SynchronizedWallClockTimer.memory_usage(
                    device),
                "metrics": registry.snapshot(),
            }
            if timers is not None:
                context["timers_s"] = {
                    k: round(v, 3) for k, v in timers.snapshot().items()
                }
            # the suppressed-errors diagnostics registry rides every
            # stall report: deliberately swallowed exceptions surface at
            # exactly the moment someone is debugging a stall
            context["suppressed_errors"] = (
                suppressed_errors_snapshot() or "none"
            )
            if tracer.enabled:
                # dump the flight recorder's last-N spans/events next to
                # the sinks; the report carries the path
                context["flight_recorder"] = tracer.dump_flight(
                    "watchdog_stall"
                )
            return context

        watchdog = StepHeartbeatWatchdog(
            timeout=config.telemetry_watchdog_timeout,
            poll_interval=config.telemetry_watchdog_poll_interval,
            context_fn=_stall_context,
        )

    return Telemetry(
        enabled=True,
        exporters=exporters,
        interval=config.telemetry_interval,
        n_params=n_params,
        profiler=profiler,
        watchdog=watchdog,
        registry=registry,
        tracer=tracer,
        device=device,
    )
