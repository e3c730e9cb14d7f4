"""The serving engine's metric catalogs and their registration.

The ``infer/*`` and ``adapters/*`` catalogs of the JAX package's
telemetry manager (deepspeed_tpu/telemetry/manager.py), under the same
names, so dashboards read one stream set from either engine. The JAX engine also registers a
``jax/recompiles`` counter fed by a ``jax.monitoring`` listener; PyTorch
runs eagerly, so the port has no counterpart and leaves it out. The rest
of the JAX manager (exporters, profiler window, watchdog) waits for a
later slice.
"""

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
