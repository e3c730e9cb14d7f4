"""Config keys and defaults for the ported slices (serving, training).

The keys, defaults and comments of the blocks the port reads, copied
from the JAX package (deepspeed_tpu/config/constants.py) so the two
parsers accept and reject the same configs.
"""

#############################################
# Batch size (any two of the triangle determine the third:
# train == micro * accum * world_size)
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer and lr scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"
SCHEDULER = "scheduler"
SCHEDULER_PARAMS = "params"
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
SGD_OPTIMIZER = "sgd"
LION_OPTIMIZER = "lion"
FUSED_LAMB_OPTIMIZERS = ("fusedlamb", "fused_lamb")
# optimizers the port's engine builds by name: every one of the JAX
# package's
PORTED_OPTIMIZERS = (
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, SGD_OPTIMIZER,
    LION_OPTIMIZER, *FUSED_LAMB_OPTIMIZERS,
)

# the data loader's routes (deepspeed_io): a train loader shuffles
ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

#############################################
# FP16: loss scaling (0 = dynamic, > 0 static)
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1

BF16 = "bf16"
BF16_ENABLED = "enabled"
BF16_ENABLED_DEFAULT = False

#############################################
# data_types block: gradient-accumulation dtype ("fp32" accumulates
# exactly; reduced types halve the grad buffer), optimizer-moment storage
# and master-weight storage (the port takes fp32 only for the last two)
#############################################
DATA_TYPES = "data_types"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"
GRAD_ACCUM_DTYPE_DEFAULT = "fp32"
OPTIMIZER_STATE_DTYPE = "optimizer_state_dtype"
OPTIMIZER_STATE_DTYPE_DEFAULT = "fp32"
MASTER_DTYPE = "master_dtype"
MASTER_DTYPE_DEFAULT = "fp32"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

#############################################
# ZeRO optimization. At world size 1 every stage lays the state out as
# stage 0 does (the JAX engine's dp = 1 layout).
#############################################
ZERO_OPTIMIZATION = "zero_optimization"

ZERO_STAGE = "stage"
ZERO_STAGE_DEFAULT = 0

ZERO_OPTIMIZATION_DISABLED = 0
ZERO_OPTIMIZATION_OPTIMIZER_STATES = 1
ZERO_OPTIMIZATION_GRADIENTS = 2
ZERO_OPTIMIZATION_WEIGHTS = 3
MAX_STAGE_ZERO_OPTIMIZATION = ZERO_OPTIMIZATION_WEIGHTS

ZERO_ALLGATHER_PARTITIONS = "allgather_partitions"
ZERO_ALLGATHER_PARTITIONS_DEFAULT = True

ZERO_ALLGATHER_BUCKET_SIZE = "allgather_bucket_size"
ZERO_ALLGATHER_BUCKET_SIZE_DEFAULT = 500000000
ZERO_ALLGATHER_BUCKET_SIZE_DEPRECATED = "allgather_size"

ZERO_REDUCE_SCATTER = "reduce_scatter"
ZERO_REDUCE_SCATTER_DEFAULT = True

ZERO_REDUCE_BUCKET_SIZE = "reduce_bucket_size"
ZERO_REDUCE_BUCKET_SIZE_DEFAULT = 500000000

ZERO_OVERLAP_COMM = "overlap_comm"
ZERO_OVERLAP_COMM_DEFAULT = False

ZERO_CONTIGUOUS_GRADIENTS = "contiguous_gradients"
ZERO_CONTIGUOUS_GRADIENTS_DEFAULT = False

ZERO_LOAD_FROM_FP32_WEIGHTS = "load_from_fp32_weights"
ZERO_LOAD_FROM_FP32_WEIGHTS_DEFAULT = True

ZERO_MAX_ELEMENTS_PER_COMM = "max_elements_per_comm"
ZERO_MAX_ELEMENTS_PER_COMM_DEFAULT = 500000000

ZERO_MASTER_WEIGHTS = "master_weights"
ZERO_MASTER_WEIGHTS_DEFAULT = True

ZERO_OFFLOAD_OPTIMIZER = "offload_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False
ZERO_TESTED_OPTIMIZERS = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER)
ZERO_OFFLOAD_DEVICE = "device"
ZERO_OFFLOAD_DEVICE_DEFAULT = "none"

# stage-3 collective/compute overlap knobs (parsed and checked; the port
# runs no stage-3 layout until distributed ZeRO is ported)
ZERO_STAGE3_GATHER_BLOCK = "stage3_gather_block"
ZERO_STAGE3_GATHER_BLOCK_DEFAULT = 2
ZERO_STAGE3_LATENCY_HIDING = "stage3_latency_hiding"
ZERO_STAGE3_LATENCY_HIDING_DEFAULT = True

# every key the zero_optimization object accepts (anything else is
# refused: a typo'd knob must not silently mean its default)
ZERO_VALID_KEYS = (
    ZERO_STAGE,
    ZERO_ALLGATHER_PARTITIONS,
    ZERO_ALLGATHER_BUCKET_SIZE,
    ZERO_ALLGATHER_BUCKET_SIZE_DEPRECATED,
    ZERO_REDUCE_SCATTER,
    ZERO_REDUCE_BUCKET_SIZE,
    ZERO_OVERLAP_COMM,
    ZERO_CONTIGUOUS_GRADIENTS,
    ZERO_LOAD_FROM_FP32_WEIGHTS,
    ZERO_MAX_ELEMENTS_PER_COMM,
    ZERO_MASTER_WEIGHTS,
    ZERO_OFFLOAD_OPTIMIZER,
    ZERO_STAGE3_GATHER_BLOCK,
    ZERO_STAGE3_LATENCY_HIDING,
)
# knobs that configure stage-3-only machinery
ZERO_STAGE3_ONLY_KEYS = (
    ZERO_STAGE3_GATHER_BLOCK,
    ZERO_STAGE3_LATENCY_HIDING,
)

#############################################
# Activation checkpointing (read by checkpointing.configure)
#############################################
ACTIVATION_CHECKPOINTING = "activation_checkpointing"

ACT_CKPT_PARTITION_ACTIVATIONS = "partition_activations"
ACT_CKPT_PARTITION_ACTIVATIONS_DEFAULT = False

ACT_CKPT_NUMBER_CHECKPOINTS = "number_checkpoints"
ACT_CKPT_NUMBER_CHECKPOINTS_DEFAULT = None

ACT_CKPT_CONTIGUOUS_MEMORY_OPTIMIZATION = "contiguous_memory_optimization"
ACT_CKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT = False

ACT_CKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY = "synchronize_checkpoint_boundary"
ACT_CKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT = False

ACT_CKPT_CPU_CHECKPOINTING = "cpu_checkpointing"
ACT_CKPT_CPU_CHECKPOINTING_DEFAULT = False

ACT_CKPT_PROFILE = "profile"
ACT_CKPT_PROFILE_DEFAULT = False

# the deprecated spelling of gradient_clipping (warned about)
MAX_GRAD_NORM = "max_grad_norm"

#############################################
# Observability: the timers, the monitor and the telemetry block
#############################################
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedJobName"

TELEMETRY = "telemetry"
TELEMETRY_ENABLED = "enabled"
TELEMETRY_ENABLED_DEFAULT = False
TELEMETRY_OUTPUT_PATH = "output_path"
TELEMETRY_OUTPUT_PATH_DEFAULT = ""
TELEMETRY_JOB_NAME = "job_name"
TELEMETRY_JOB_NAME_DEFAULT = "DeepSpeedJobName"
# export every N accumulation windows: the one host sync that settles the
# loss, grad norm and loss scale happens at these boundaries only
TELEMETRY_INTERVAL = "interval"
TELEMETRY_INTERVAL_DEFAULT = 1
TELEMETRY_EXPORTERS = "exporters"
TELEMETRY_EXPORTERS_DEFAULT = ("jsonl", "prometheus")
TELEMETRY_VALID_EXPORTERS = ("jsonl", "prometheus", "tensorboard")
TELEMETRY_PROMETHEUS_PATH = "prometheus_path"
TELEMETRY_PROMETHEUS_PATH_DEFAULT = ""
# profiler window (torch.profiler), counted in accumulation windows
TELEMETRY_PROFILE = "profile"
TELEMETRY_PROFILE_START_STEP = "start_step"
TELEMETRY_PROFILE_START_STEP_DEFAULT = -1
TELEMETRY_PROFILE_NUM_STEPS = "num_steps"
TELEMETRY_PROFILE_NUM_STEPS_DEFAULT = 3
TELEMETRY_PROFILE_OUTPUT_PATH = "output_path"
TELEMETRY_PROFILE_OUTPUT_PATH_DEFAULT = ""
# step-heartbeat watchdog (rides the telemetry master switch)
TELEMETRY_WATCHDOG = "watchdog"
TELEMETRY_WATCHDOG_ENABLED = "enabled"
TELEMETRY_WATCHDOG_ENABLED_DEFAULT = True
TELEMETRY_WATCHDOG_TIMEOUT = "timeout"
TELEMETRY_WATCHDOG_TIMEOUT_DEFAULT = 600.0
TELEMETRY_WATCHDOG_POLL_INTERVAL = "poll_interval"
TELEMETRY_WATCHDOG_POLL_INTERVAL_DEFAULT = None  # => timeout / 4
# request/step tracing and the flight recorder
TELEMETRY_TRACING = "tracing"
TELEMETRY_TRACING_ENABLED = "enabled"
TELEMETRY_TRACING_ENABLED_DEFAULT = False
TELEMETRY_TRACING_SAMPLE_RATE = "sample_rate"
TELEMETRY_TRACING_SAMPLE_RATE_DEFAULT = 1.0
TELEMETRY_TRACING_RING_EVENTS = "ring_events"
TELEMETRY_TRACING_RING_EVENTS_DEFAULT = 512
TELEMETRY_TRACING_EXPORT = "export"
TELEMETRY_TRACING_EXPORT_DEFAULT = "chrome"
TELEMETRY_TRACING_VALID_EXPORTS = ("chrome", "none")

#############################################
# Crash-safe checkpointing / preemption resilience
# (deepspeed_tpu_torch/resilience/, docs/resilience.md): the JAX
# package's block, keys and defaults.
#############################################
RESILIENCE = "resilience"
# Master switch for the atomic commit protocol (tmp+fsync+rename writes,
# sha256 MANIFEST.json, verify-before-publish) and verified loads. Off =>
# the legacy bare-open() write path.
RESILIENCE_ENABLED = "enabled"
RESILIENCE_ENABLED_DEFAULT = True
# fsync files and directory entries on the commit path. Disable only for
# throwaway runs on local disk where save latency matters more than
# power-loss durability (kill-safety via rename atomicity still holds).
RESILIENCE_FSYNC = "fsync"
RESILIENCE_FSYNC_DEFAULT = True
# Deep-verify (sha256) the manifest before trusting a checkpoint on load.
RESILIENCE_VERIFY_ON_LOAD = "verify_on_load"
RESILIENCE_VERIFY_ON_LOAD_DEFAULT = True
# On corruption/missing files under a `latest`-driven load, walk back to
# the newest valid tag instead of failing the load.
RESILIENCE_FALLBACK_ON_CORRUPTION = "fallback_on_corruption"
RESILIENCE_FALLBACK_ON_CORRUPTION_DEFAULT = True
# Retention GC: keep the newest N loadable checkpoints, delete older ones
# after each successful save. 0 (default) keeps everything. The newest
# valid checkpoint and the `latest` target are never deleted.
RESILIENCE_KEEP_LAST_N = "keep_last_n"
RESILIENCE_KEEP_LAST_N_DEFAULT = 0
# Exponential-backoff-with-jitter retry for transient storage errors
# (GCS-FUSE/NFS flakes). max_attempts counts total tries (1 = no retry).
RESILIENCE_RETRY = "retry"
RESILIENCE_RETRY_MAX_ATTEMPTS = "max_attempts"
RESILIENCE_RETRY_MAX_ATTEMPTS_DEFAULT = 3
RESILIENCE_RETRY_BACKOFF_BASE = "backoff_base"
RESILIENCE_RETRY_BACKOFF_BASE_DEFAULT = 0.1
RESILIENCE_RETRY_BACKOFF_MAX = "backoff_max"
RESILIENCE_RETRY_BACKOFF_MAX_DEFAULT = 5.0
RESILIENCE_RETRY_JITTER = "jitter"
RESILIENCE_RETRY_JITTER_DEFAULT = 0.25
# Preemption drain: SIGTERM/SIGINT arms a save-at-next-step-boundary
# flag; the engine commits one final checkpoint and exits by re-raising
# the original signal. save_dir "" => the last directory the engine
# saved to or loaded from.
RESILIENCE_PREEMPTION = "preemption"
RESILIENCE_PREEMPTION_ENABLED = "enabled"
RESILIENCE_PREEMPTION_ENABLED_DEFAULT = False
RESILIENCE_PREEMPTION_SIGNALS = "signals"
RESILIENCE_PREEMPTION_SIGNALS_DEFAULT = ("SIGTERM", "SIGINT")
RESILIENCE_PREEMPTION_SAVE_DIR = "save_dir"
RESILIENCE_PREEMPTION_SAVE_DIR_DEFAULT = ""
RESILIENCE_PREEMPTION_TAG_PREFIX = "tag_prefix"
RESILIENCE_PREEMPTION_TAG_PREFIX_DEFAULT = "preempt"
RESILIENCE_PREEMPTION_EXIT_AFTER_SAVE = "exit_after_save"
RESILIENCE_PREEMPTION_EXIT_AFTER_SAVE_DEFAULT = True
# Fault-injection registry (resilience/faults.py, docs/resilience.md):
# seed-deterministic chaos at the stack's real seams. Each entry of
# "faults" names a site from faults.KNOWN_FAULT_SITES plus optional
# times / probability / after / args. Off by default — production runs
# arm it only for game days.
RESILIENCE_FAULT_INJECTION = "fault_injection"
RESILIENCE_FAULT_INJECTION_ENABLED = "enabled"
RESILIENCE_FAULT_INJECTION_ENABLED_DEFAULT = False
RESILIENCE_FAULT_INJECTION_SEED = "seed"
RESILIENCE_FAULT_INJECTION_SEED_DEFAULT = 0
RESILIENCE_FAULT_INJECTION_FAULTS = "faults"
RESILIENCE_FAULT_INJECTION_FAULTS_DEFAULT = ()
# Self-healing run supervisor (resilience/supervisor.py): step-boundary
# anomaly detectors + bounded in-process rollback to the last committed
# checkpoint. max_rollbacks is the retry budget before the typed
# terminal escalation; nonfinite_window is the consecutive-bad-window
# budget (beyond what the loss scaler's skip/adapt handles);
# spike_factor > 0 arms the relative loss-spike detector over a
# spike_window rolling mean (armed after min_history samples).
RESILIENCE_SUPERVISOR = "supervisor"
RESILIENCE_SUPERVISOR_ENABLED = "enabled"
RESILIENCE_SUPERVISOR_ENABLED_DEFAULT = False
RESILIENCE_SUPERVISOR_MAX_ROLLBACKS = "max_rollbacks"
RESILIENCE_SUPERVISOR_MAX_ROLLBACKS_DEFAULT = 2
RESILIENCE_SUPERVISOR_NONFINITE_WINDOW = "nonfinite_window"
RESILIENCE_SUPERVISOR_NONFINITE_WINDOW_DEFAULT = 3
RESILIENCE_SUPERVISOR_SPIKE_FACTOR = "spike_factor"
RESILIENCE_SUPERVISOR_SPIKE_FACTOR_DEFAULT = 0.0
RESILIENCE_SUPERVISOR_SPIKE_WINDOW = "spike_window"
RESILIENCE_SUPERVISOR_SPIKE_WINDOW_DEFAULT = 32
RESILIENCE_SUPERVISOR_MIN_HISTORY = "min_history"
RESILIENCE_SUPERVISOR_MIN_HISTORY_DEFAULT = 8

# Overlapped input staging (deepspeed_tpu_torch/runtime/staging.py). While
# window N computes on the card, a background worker pulls window N+1's
# micro-batches, copies them into pinned host slots and issues their
# host-to-device copies on a copy stream.
DATA_PIPELINE = "data_pipeline"
DATA_PIPELINE_ENABLED = "enabled"
DATA_PIPELINE_ENABLED_DEFAULT = False
# Max staged-but-unconsumed windows (2 = double buffering); also the number
# of pinned host slots the copy stream reads from.
DATA_PIPELINE_STAGING_BUFFERS = "staging_buffers"
DATA_PIPELINE_STAGING_BUFFERS_DEFAULT = 2
# Issue the host-to-device copy on the staging worker (true) or only
# overlap the host pull and copy on the consuming thread (false).
DATA_PIPELINE_STAGE_TO_DEVICE = "stage_to_device"
DATA_PIPELINE_STAGE_TO_DEVICE_DEFAULT = True

# The kernel build cache (deepspeed_tpu_torch/runtime/compile_cache.py):
# where ops/kernel_lib.py keeps its nvcc libraries, so that a restart reuses
# them. cache_dir "" => build/torch_kernels/ in the checkout.
COMPILE_CACHE = "compile_cache"
COMPILE_CACHE_ENABLED = "enabled"
COMPILE_CACHE_ENABLED_DEFAULT = False
COMPILE_CACHE_DIR = "cache_dir"
COMPILE_CACHE_DIR_DEFAULT = ""
# Validated as in the JAX package; no counterpart (every library is cached
# whole).
COMPILE_CACHE_MIN_COMPILE_SECS = "min_compile_time_secs"
COMPILE_CACHE_MIN_COMPILE_SECS_DEFAULT = 1.0

#############################################
# Inference serving (deepspeed_tpu_torch/inference/, docs/inference.md): the
# continuous-batching KV-cache decode engine behind init_inference().
# Absent from the reference, which stopped at training.
#############################################
INFERENCE = "inference"
# Decode slots: the fixed batch width of the decode step. Every
# admitted request occupies one slot until EOS/length; the KV cache is
# [layers, slots, heads, max_seq_len, head_dim], so slots * max_seq_len
# bounds cache device memory.
INFERENCE_MAX_BATCH_SLOTS = "max_batch_slots"
INFERENCE_MAX_BATCH_SLOTS_DEFAULT = 8
# Hard cap on prompt + generated tokens per request (the KV cache's
# position extent). 0 => the model's n_positions.
INFERENCE_MAX_SEQ_LEN = "max_seq_len"
INFERENCE_MAX_SEQ_LEN_DEFAULT = 0
# Fixed prefill width: prompts are right-padded to this length so every
# prefill has one shape (causality makes the padding columns inert). 0 =>
# max_seq_len. Smaller values trade prompt-length headroom for prefill
# FLOPs.
INFERENCE_PREFILL_LEN = "prefill_len"
INFERENCE_PREFILL_LEN_DEFAULT = 0
# Bounded admission queue (the serving front door): submissions beyond
# this depth are REJECTED (RequestRejected) rather than buffered without
# bound — overload sheds at the door, not in device memory.
INFERENCE_QUEUE_DEPTH = "queue_depth"
INFERENCE_QUEUE_DEPTH_DEFAULT = 64
# How long submit() may block waiting for queue room before rejecting.
# 0 => reject immediately when full.
INFERENCE_QUEUE_TIMEOUT = "queue_timeout_secs"
INFERENCE_QUEUE_TIMEOUT_DEFAULT = 0.0
# Token id that terminates a sequence (host-side check after each decode
# step). null/-1 => generation runs to max_new_tokens/max_seq_len.
INFERENCE_EOS_TOKEN_ID = "eos_token_id"
INFERENCE_EOS_TOKEN_ID_DEFAULT = None
# Param/cache storage dtype: "fp32" or "bf16" (bf16 halves weight+cache
# memory; fp32 is the parity tests' mode).
INFERENCE_DTYPE = "dtype"
INFERENCE_DTYPE_DEFAULT = "fp32"
# Sampling defaults (per-request temperature may override; top-k/top-p/
# greedy are engine-wide).
INFERENCE_SAMPLING = "sampling"
INFERENCE_SAMPLING_TEMPERATURE = "temperature"
INFERENCE_SAMPLING_TEMPERATURE_DEFAULT = 1.0
INFERENCE_SAMPLING_TOP_K = "top_k"
INFERENCE_SAMPLING_TOP_K_DEFAULT = 0  # 0 = disabled
INFERENCE_SAMPLING_TOP_P = "top_p"
INFERENCE_SAMPLING_TOP_P_DEFAULT = 1.0  # 1.0 = disabled
INFERENCE_SAMPLING_GREEDY = "greedy"
INFERENCE_SAMPLING_GREEDY_DEFAULT = False
# Default per-request deadline, seconds from submission (null = no
# deadline). A request is finished with reason "deadline" when it cannot
# be admitted before its deadline (reject-on-admission) or when a decode
# step finds it past-deadline in flight (slot reclaimed within one
# step). Per-request deadline_secs on submit() overrides.
INFERENCE_DEADLINE_SECS = "deadline_secs"
INFERENCE_DEADLINE_SECS_DEFAULT = None
# Decode-driver auto-restarts allowed after a decode crash before the
# scheduler gives up and fail-finishes everything (0 = legacy behavior:
# any crash drains the scheduler). A restart fails the in-flight
# requests (their KV rows died with the crashed step), rebuilds the
# decode state from the engine's pinned params, and keeps serving the
# queue.
INFERENCE_DRIVER_RESTART_BUDGET = "driver_restart_budget"
INFERENCE_DRIVER_RESTART_BUDGET_DEFAULT = 0
# Queue-pressure threshold (fraction of queue_depth) past which the
# health state degrades and priority > 0 submissions are shed at the
# front door (docs/inference.md "Self-healing serving").
INFERENCE_DEGRADED_QUEUE_RATIO = "degraded_queue_ratio"
INFERENCE_DEGRADED_QUEUE_RATIO_DEFAULT = 0.75
# Block-paged KV cache (PagedAttention — docs/inference.md "Paged KV
# cache"): page size in tokens. 0 => the legacy contiguous per-slot
# cache ([layers, slots, heads, max_seq_len, head_dim], every slot
# reserving max_seq_len rows). > 0 => a global pool of fixed-size pages
# indirected through per-slot block tables; max_seq_len must divide by
# it (the bitwise-parity contract needs identical logical cache
# extents).
INFERENCE_KV_BLOCK_SIZE = "kv_block_size"
INFERENCE_KV_BLOCK_SIZE_DEFAULT = 0
# Usable pages in the pool (excluding the null page). 0 => auto: slots *
# (max_seq_len / kv_block_size) — the contiguous cache's capacity plus
# ONE extra page (the never-allocated null page), so paging at the
# default is a fragmentation win at essentially the same memory. Set
# LOWER to serve more slots per byte: admission reserves only
# ceil((prompt + max_new) / kv_block_size) pages per request, so short
# traffic packs several requests into one contiguous slot's worth of
# pages.
INFERENCE_KV_POOL_BLOCKS = "kv_pool_blocks"
INFERENCE_KV_POOL_BLOCKS_DEFAULT = 0
# Cross-request prefix caching over the page pool: full prompt pages are
# content-hashed (vLLM chain scheme), reference-counted, and shared, so
# a templated prefix (system prompt, few-shot header) prefills ONCE
# fleet-wide and later requests compute only their unique suffix.
# "enabled" null => on whenever kv_block_size > 0; explicitly true
# REQUIRES the paged cache. "suffix_buckets" fixes the padded suffix
# widths the hit-path prefill pads to (null => a power-of-two ladder
# from kv_block_size up to prefill_len).
INFERENCE_PREFIX_CACHE = "prefix_cache"
INFERENCE_PREFIX_CACHE_ENABLED = "enabled"
INFERENCE_PREFIX_CACHE_ENABLED_DEFAULT = None
INFERENCE_PREFIX_CACHE_SUFFIX_BUCKETS = "suffix_buckets"
INFERENCE_PREFIX_CACHE_SUFFIX_BUCKETS_DEFAULT = None
# Fused decode attention (docs/inference.md "Fused decode attention"):
# swaps the paged decode step's gather-then-einsum attention for the
# single-query paged decode kernel
# (ops/decode_attention.py:paged_flash_decode) — the slot's live KV
# pages are read in place through the block table with an online
# softmax, no [slots, heads, max_len, hd] gathered temporary, and
# zero-length (dead) slots early-out. Requires the paged cache
# (kv_block_size > 0); the gather path stays the greedy-parity
# reference. On CPU tensors the kernel's plain PyTorch version runs.
INFERENCE_FUSED_DECODE = "fused_decode"
INFERENCE_FUSED_DECODE_DEFAULT = False
# Speculative decoding (docs/inference.md "Speculative decoding"): a
# small DRAFT model proposes k greedy tokens per scheduler step and the
# target verifies all of them in ONE fixed-shape batched step against
# the paged cache — the accepted prefix plus the target's correction
# token commit together, so a decode step yields up to k+1 tokens.
# Greedy output is bitwise-identical to the non-speculative path by
# construction (every committed token is the target's own argmax). k is
# static (acceptance length is data);
# draft_checkpoint optionally loads the draft's params through the
# verified-load path (the draft module itself is passed to
# init_inference as draft_model/draft_parameters). Requires the paged
# cache and greedy sampling.
INFERENCE_SPECULATIVE = "speculative"
INFERENCE_SPECULATIVE_K = "k"
INFERENCE_SPECULATIVE_K_DEFAULT = 4
INFERENCE_SPECULATIVE_DRAFT_CHECKPOINT = "draft_checkpoint"
INFERENCE_SPECULATIVE_DRAFT_CHECKPOINT_DEFAULT = ""
# Host-memory spill tier (docs/inference.md "Host-memory spill tier"):
# treats device memory as a cache over host DRAM. Refcount-0 prefix pages evicted
# by the BlockPool LRU — and adapter rows evicted by the AdapterPool —
# are copied D2H into a byte-budgeted host LRU instead of dropped, and
# promoted back H2D on a chain-hash / name hit (vLLM swap tier +
# S-LoRA host paging, PAPERS.md). Requires something spillable: the
# paged KV cache (kv_block_size > 0) and/or adapters.
INFERENCE_HOST_TIER = "host_tier"
INFERENCE_HOST_TIER_ENABLED = "enabled"
INFERENCE_HOST_TIER_ENABLED_DEFAULT = False
# Host-RAM byte budget for parked pages/rows; LRU past it.
INFERENCE_HOST_TIER_MAX_BYTES = "max_bytes"
INFERENCE_HOST_TIER_MAX_BYTES_DEFAULT = 1 << 28  # 256 MiB
# Share one tier across every engine in this process (the node agent
# hosts all its replicas' engines in one process, so this is same-host
# peer sharing: one tenant's warm template/adapter warms the fleet).
# False => a private tier per engine.
INFERENCE_HOST_TIER_PEER_SHARING = "peer_sharing"
INFERENCE_HOST_TIER_PEER_SHARING_DEFAULT = True
# Named share-group for peer sharing (engines sharing a group share a
# tier and its byte budget). Lets tests / co-hosted tenants isolate.
INFERENCE_HOST_TIER_SHARE_GROUP = "share_group"
INFERENCE_HOST_TIER_SHARE_GROUP_DEFAULT = "node"
# Lazy page growth + preemption (replaces worst-case admission
# reservation): admission reserves only the PROMPT's pages, decode grows
# a slot one page at a time, and under pool pressure the scheduler
# preempts the most-recently-admitted request — its full pages register
# (so they park in the LRU / spill to the host tier) and it resumes
# suffix-only with zero lost work. Requires the tier and the paged
# cache.
INFERENCE_HOST_TIER_LAZY_ALLOC = "lazy_alloc"
INFERENCE_HOST_TIER_LAZY_ALLOC_DEFAULT = False
# Optional checkpoint to serve from: loaded through the resilience
# verified-load path (manifest check + host-side parse + newest-valid
# fallback) before params move to the device.
INFERENCE_CHECKPOINT = "checkpoint"
INFERENCE_CHECKPOINT_LOAD_DIR = "load_dir"
INFERENCE_CHECKPOINT_LOAD_DIR_DEFAULT = ""
INFERENCE_CHECKPOINT_TAG = "tag"
INFERENCE_CHECKPOINT_TAG_DEFAULT = None  # None => the 'latest' pointer

#############################################
# Multi-tenant LoRA adapters (adapters/, docs/adapters.md): one base
# model, per-tenant rank-r A/B pairs. In initialize() the block freezes
# the base and trains ONLY the adapter factors; in init_inference() it
# allocates the device adapter pool that batched multi-LoRA decode reads
# per slot (the SGMV kernel under inference.fused_decode).
#############################################
ADAPTERS = "adapters"
ADAPTERS_ENABLED = "enabled"
ADAPTERS_ENABLED_DEFAULT = False
# Low-rank dimension r of every A [in, r] / B [r, out] pair.
ADAPTERS_RANK = "rank"
ADAPTERS_RANK_DEFAULT = 8
# Delta scaling numerator: delta = (alpha / rank) * x @ A @ B.
# 0 => alpha = rank (scaling 1.0).
ADAPTERS_ALPHA = "alpha"
ADAPTERS_ALPHA_DEFAULT = 0.0
# Projection matrices adapted (ops/transformer.py LORA_TARGETS).
# null => all four: attn_qkvw, attn_ow, inter_w, output_w.
ADAPTERS_TARGETS = "targets"
ADAPTERS_TARGETS_DEFAULT = None
# Serving only: loadable slots in the device adapter pool (id 0, the
# all-zeros identity, rides extra). Loading past this evicts the
# least-recently-used IDLE adapter; a pool whose every adapter has live
# requests rejects the load.
ADAPTERS_POOL_SLOTS = "pool_slots"
ADAPTERS_POOL_SLOTS_DEFAULT = 8

#############################################
# Multi-replica serving tier (serving/, docs/serving.md):
# a FleetRouter in front of N inference-engine replicas — placement,
# per-tenant admission, and rolling-restart lifecycle. The DeepSpeed-
# Inference "serving at scale" act on top of the per-replica Orca-style
# scheduler the "inference" block configures.
#############################################
SERVING = "serving"
# Engine replicas behind the router. Each replica is one full
# InferenceEngine (own KV cache, own scheduler, own driver thread).
SERVING_REPLICAS = "replicas"
SERVING_REPLICAS_DEFAULT = 1
# Replica isolation backend: "in_process" (N engines in this process —
# zero-copy, shares the host) or "subprocess" (one engine per worker
# process, newline-JSON RPC over pipes — a crashed replica cannot take
# the router down).
SERVING_BACKEND = "backend"
SERVING_BACKEND_DEFAULT = "in_process"
SERVING_VALID_BACKENDS = ("in_process", "subprocess", "socket")
# Placement policy: "least_loaded" scores queue depth + slot occupancy,
# "prefix_affinity" routes identical templated prompt prefixes to the
# replica that served them (the hook a cross-request prefix cache plugs
# into) falling back to least-loaded, "round_robin" ignores load.
SERVING_PLACEMENT = "placement"
SERVING_PLACEMENT_DEFAULT = "least_loaded"
SERVING_VALID_PLACEMENTS = (
    "least_loaded", "prefix_affinity", "round_robin", "adapter_affinity",
)
# Prompt tokens hashed for prefix affinity (the templated-system-prompt
# span; prompts shorter than this hash whole).
SERVING_AFFINITY_PREFIX_TOKENS = "affinity_prefix_tokens"
SERVING_AFFINITY_PREFIX_TOKENS_DEFAULT = 16
# Fraction of replicas that must stay routable during lifecycle
# operations: rolling_restart() refuses to start when draining one more
# replica would leave fewer than ceil(floor * replicas) serving.
SERVING_CAPACITY_FLOOR = "capacity_floor"
SERVING_CAPACITY_FLOOR_DEFAULT = 0.5
# Fleet-wide queue-fill fraction past which priority > 0 submissions are
# shed at the ROUTER's door (before any replica queue is touched).
SERVING_SHED_QUEUE_RATIO = "shed_queue_ratio"
SERVING_SHED_QUEUE_RATIO_DEFAULT = 0.75
# Re-route attempts for a request whose replica died under it before the
# router fails the request to its caller.
SERVING_MAX_REROUTES = "max_reroutes"
SERVING_MAX_REROUTES_DEFAULT = 2
# Install the resilience PreemptionHandler so SIGTERM/SIGINT drains the
# whole fleet gracefully (in-flight requests finish, new traffic sheds)
# instead of killing mid-decode.
SERVING_DRAIN_ON_PREEMPTION = "drain_on_preemption"
SERVING_DRAIN_ON_PREEMPTION_DEFAULT = False
# Per-tenant token-bucket admission. "rate_limit" sets the default
# bucket (requests_per_sec null = unlimited); "per_tenant" maps tenant
# name -> {requests_per_sec, burst} overrides.
SERVING_RATE_LIMIT = "rate_limit"
SERVING_RATE_LIMIT_RPS = "requests_per_sec"
SERVING_RATE_LIMIT_RPS_DEFAULT = None
SERVING_RATE_LIMIT_BURST = "burst"
SERVING_RATE_LIMIT_BURST_DEFAULT = 1
SERVING_RATE_LIMIT_PER_TENANT = "per_tenant"
SERVING_RATE_LIMIT_PER_TENANT_DEFAULT = None  # None => {} (no overrides)
# Subprocess-replica RPC transport: per-op timeout, and retry-with-
# backoff for IDEMPOTENT control ops (snapshot/drain/adapter management
# — generate submissions never retry; docs/serving.md "RPC retries").
SERVING_RPC_TIMEOUT_SECS = "rpc_timeout_secs"
SERVING_RPC_TIMEOUT_SECS_DEFAULT = 10.0
SERVING_RPC_RETRIES = "rpc_retries"
SERVING_RPC_RETRIES_DEFAULT = 2
SERVING_RPC_BACKOFF_SECS = "rpc_backoff_secs"
SERVING_RPC_BACKOFF_SECS_DEFAULT = 0.05
# Zombie detection (docs/serving.md): a replica with work in flight but
# frozen completion counters (or a live-but-unresponsive worker) for
# zombie_secs is drained-then-restarted, zombie_restart_budget times;
# 0 disables the sweep.
SERVING_ZOMBIE_SECS = "zombie_secs"
SERVING_ZOMBIE_SECS_DEFAULT = 0.0
SERVING_ZOMBIE_RESTART_BUDGET = "zombie_restart_budget"
SERVING_ZOMBIE_RESTART_BUDGET_DEFAULT = 2
# Per-replica circuit breakers (serving/breaker.py): N consecutive RPC
# failures open the circuit for an exponentially-backed-off window with
# a single half-open probe.
SERVING_CIRCUIT_BREAKER = "circuit_breaker"
SERVING_CB_FAILURE_THRESHOLD = "failure_threshold"
SERVING_CB_FAILURE_THRESHOLD_DEFAULT = 3
SERVING_CB_BACKOFF_SECS = "backoff_secs"
SERVING_CB_BACKOFF_SECS_DEFAULT = 0.5
SERVING_CB_BACKOFF_MAX_SECS = "backoff_max_secs"
SERVING_CB_BACKOFF_MAX_SECS_DEFAULT = 30.0
# Brownout degradation (docs/serving.md): between queue_ratio and the
# shed ratio the fleet clamps sheddable requests' max_new_tokens to the
# configured floor (and replicas skip prefix-miss registration work)
# instead of letting fill climb to the rejection cliff. queue_ratio
# null = feature off.
SERVING_BROWNOUT = "brownout"
SERVING_BROWNOUT_QUEUE_RATIO = "queue_ratio"
SERVING_BROWNOUT_QUEUE_RATIO_DEFAULT = None
SERVING_BROWNOUT_MAX_NEW_TOKENS = "max_new_tokens"
SERVING_BROWNOUT_MAX_NEW_TOKENS_DEFAULT = 16
# Socket replica transport (serving/transport.py + node.py,
# docs/serving.md "Networked fleet"): heartbeat lease window (a
# connection without a pong for lease_secs is torn down and
# reconnected), reconnect-with-resume budget + backoff, and the dial
# timeout/retry for the initial connect (a dropped accept costs a
# retry, not a replica).
SERVING_SOCKET = "socket"
SERVING_SOCKET_LEASE_SECS = "lease_secs"
SERVING_SOCKET_LEASE_SECS_DEFAULT = 10.0
SERVING_SOCKET_RECONNECT_ATTEMPTS = "reconnect_attempts"
SERVING_SOCKET_RECONNECT_ATTEMPTS_DEFAULT = 3
SERVING_SOCKET_RECONNECT_BACKOFF_SECS = "reconnect_backoff_secs"
SERVING_SOCKET_RECONNECT_BACKOFF_SECS_DEFAULT = 0.1
SERVING_SOCKET_CONNECT_TIMEOUT_SECS = "connect_timeout_secs"
SERVING_SOCKET_CONNECT_TIMEOUT_SECS_DEFAULT = 10.0
SERVING_SOCKET_CONNECT_RETRIES = "connect_retries"
SERVING_SOCKET_CONNECT_RETRIES_DEFAULT = 3
# HTTP/SSE front door (serving/http.py): bind address, the per-stream
# write-buffer bound, and the slow-client overrun policy ("drop" closes
# the stream and cancels the request — the slot frees like a
# disconnect; "block" backpressures the stream on the client's drain).
SERVING_HTTP = "http"
SERVING_HTTP_HOST = "host"
SERVING_HTTP_HOST_DEFAULT = "127.0.0.1"
SERVING_HTTP_PORT = "port"
SERVING_HTTP_PORT_DEFAULT = 0
SERVING_HTTP_MAX_BUFFER_BYTES = "max_buffer_bytes"
SERVING_HTTP_MAX_BUFFER_BYTES_DEFAULT = 65536
SERVING_HTTP_OVERRUN_POLICY = "overrun_policy"
SERVING_HTTP_OVERRUN_POLICY_DEFAULT = "drop"
SERVING_HTTP_VALID_OVERRUN_POLICIES = ("drop", "block")
# bearer secret for the door (docs/serving.md): every route except the
# /healthz and /readyz probes demands `Authorization: Bearer <token>`;
# None = open door. The resolved value is NEVER logged (config.print
# redacts it).
SERVING_HTTP_AUTH_TOKEN = "auth_token"
SERVING_HTTP_AUTH_TOKEN_DEFAULT = None

# "slo": the latency targets the fleet promises (docs/serving.md "SLO
# autoscaling") — p99 TTFT and per-token-latency ceilings in ms (None =
# no target on that axis) plus the sliding window the error budget
# (fleet/slo_error_budget_remaining) evaluates over.
SERVING_SLO = "slo"
SERVING_SLO_TTFT_P99_MS = "ttft_p99_ms"
SERVING_SLO_TTFT_P99_MS_DEFAULT = None
SERVING_SLO_TOKEN_P99_MS = "token_p99_ms"
SERVING_SLO_TOKEN_P99_MS_DEFAULT = None
SERVING_SLO_EVAL_WINDOW_SECS = "eval_window_secs"
SERVING_SLO_EVAL_WINDOW_SECS_DEFAULT = 60.0

# "autoscale": elastic replica capacity driven by the predictive cost
# model (serving/autoscaler.py) — scale up BEFORE the brownout cliff,
# drain-then-retire on sustained headroom, re-provision capacity chaos
# takes away; clamped by min/max replicas, a scale cooldown, and a
# direction-reversal flap budget. Disabled = zero-overhead passthrough.
SERVING_AUTOSCALE = "autoscale"
SERVING_AUTOSCALE_ENABLED = "enabled"
SERVING_AUTOSCALE_ENABLED_DEFAULT = False
SERVING_AUTOSCALE_MIN_REPLICAS = "min_replicas"
SERVING_AUTOSCALE_MIN_REPLICAS_DEFAULT = 1
SERVING_AUTOSCALE_MAX_REPLICAS = "max_replicas"
SERVING_AUTOSCALE_MAX_REPLICAS_DEFAULT = 4
SERVING_AUTOSCALE_COOLDOWN_SECS = "cooldown_secs"
SERVING_AUTOSCALE_COOLDOWN_SECS_DEFAULT = 30.0
SERVING_AUTOSCALE_HYSTERESIS_SECS = "hysteresis_secs"
SERVING_AUTOSCALE_HYSTERESIS_SECS_DEFAULT = 60.0
SERVING_AUTOSCALE_FLAP_BUDGET = "flap_budget"
SERVING_AUTOSCALE_FLAP_BUDGET_DEFAULT = 4
SERVING_AUTOSCALE_FLAP_WINDOW_SECS = "flap_window_secs"
SERVING_AUTOSCALE_FLAP_WINDOW_SECS_DEFAULT = 600.0
SERVING_AUTOSCALE_UP_UTILIZATION = "scale_up_utilization"
SERVING_AUTOSCALE_UP_UTILIZATION_DEFAULT = 0.85
SERVING_AUTOSCALE_DOWN_UTILIZATION = "scale_down_utilization"
SERVING_AUTOSCALE_DOWN_UTILIZATION_DEFAULT = 0.30
SERVING_AUTOSCALE_INTERVAL_SECS = "interval_secs"
SERVING_AUTOSCALE_INTERVAL_SECS_DEFAULT = 1.0
SERVING_AUTOSCALE_DRAIN_TIMEOUT_SECS = "drain_timeout_secs"
SERVING_AUTOSCALE_DRAIN_TIMEOUT_SECS_DEFAULT = 30.0

# "hub": the fleet observability plane (telemetry/hub.py,
# docs/observability.md "fleet-wide view") — the router-side
# TelemetryHub scrapes every node agent's registries over the
# metrics_snapshot control op on this cadence, retains each series in a
# fixed-size time-series ring, pulls sampled spans / flight rings home
# over drain_telemetry, evaluates the alert rules, and serves
# /metrics //statz //dashboard on the HTTP door. Disabled (the default)
# = zero-overhead passthrough: no hub object, no threads, the door
# routes 404.
SERVING_HUB = "hub"
SERVING_HUB_ENABLED = "enabled"
SERVING_HUB_ENABLED_DEFAULT = False
SERVING_HUB_INTERVAL_SECS = "interval_secs"
SERVING_HUB_INTERVAL_SECS_DEFAULT = 2.0
SERVING_HUB_RETENTION_POINTS = "retention_points"
SERVING_HUB_RETENTION_POINTS_DEFAULT = 512
SERVING_HUB_DRAIN_INTERVAL_SECS = "drain_interval_secs"
SERVING_HUB_DRAIN_INTERVAL_SECS_DEFAULT = 10.0
SERVING_HUB_OP_TIMEOUT_SECS = "op_timeout_secs"
SERVING_HUB_OP_TIMEOUT_SECS_DEFAULT = 5.0
SERVING_HUB_NODE_BACKOFF_SECS = "node_backoff_secs"
SERVING_HUB_NODE_BACKOFF_SECS_DEFAULT = 10.0
# door paths served WITHOUT the bearer token when serving.http.auth_token
# is set (an in-cluster Prometheus scraper carries no tenant
# credentials); empty default = everything hub-served is protected
SERVING_HUB_AUTH_EXEMPT = "auth_exempt"
SERVING_HUB_AUTH_EXEMPT_DEFAULT = ()
SERVING_HUB_VALID_AUTH_EXEMPT = (
    "/metrics", "/statz", "/dashboard",
)
# "alerts" sub-block: the rule thresholds the hub evaluates over its
# ring. slo_target + fast/slow burn multipliers follow the SRE-workbook
# multiwindow form (burn = observed error rate / (1 - slo_target));
# breaker_flood and suppressed_growth are windowed counter-delta floors.
SERVING_HUB_ALERTS = "alerts"
SERVING_HUB_ALERTS_SLO_TARGET = "slo_target"
SERVING_HUB_ALERTS_SLO_TARGET_DEFAULT = 0.99
SERVING_HUB_ALERTS_FAST_WINDOW_SECS = "fast_window_secs"
SERVING_HUB_ALERTS_FAST_WINDOW_SECS_DEFAULT = 60.0
SERVING_HUB_ALERTS_SLOW_WINDOW_SECS = "slow_window_secs"
SERVING_HUB_ALERTS_SLOW_WINDOW_SECS_DEFAULT = 600.0
SERVING_HUB_ALERTS_FAST_BURN = "fast_burn"
SERVING_HUB_ALERTS_FAST_BURN_DEFAULT = 14.4
SERVING_HUB_ALERTS_SLOW_BURN = "slow_burn"
SERVING_HUB_ALERTS_SLOW_BURN_DEFAULT = 6.0
SERVING_HUB_ALERTS_BREAKER_FLOOD = "breaker_flood"
SERVING_HUB_ALERTS_BREAKER_FLOOD_DEFAULT = 3
SERVING_HUB_ALERTS_SUPPRESSED_GROWTH = "suppressed_growth"
SERVING_HUB_ALERTS_SUPPRESSED_GROWTH_DEFAULT = 10

# "journal": the durable control plane (serving/journal.py,
# docs/serving.md "Control-plane durability") — a write-ahead
# fleet-state journal under ``dir``: node addresses, replica
# memberships, fleet adapter registry, autoscaler target/cooldown,
# brownout state, and a bounded in-flight request table, each mutation
# committed (atomic tmp+fsync+rename snapshot segment) BEFORE it takes
# effect. A restarting router finds the journal, re-dials node control
# sessions, and adopts still-running generations instead of dropping
# them. Disabled (the default) = zero-overhead passthrough: no journal
# object, no directory, no write on any request path.
SERVING_JOURNAL = "journal"
SERVING_JOURNAL_ENABLED = "enabled"
SERVING_JOURNAL_ENABLED_DEFAULT = False
SERVING_JOURNAL_DIR = "dir"
SERVING_JOURNAL_DIR_DEFAULT = "fleet_journal"
# fsync=False trades durability-across-power-loss for latency; the
# atomic rename still protects against torn segments either way
SERVING_JOURNAL_FSYNC = "fsync"
SERVING_JOURNAL_FSYNC_DEFAULT = True
SERVING_JOURNAL_KEEP_SEGMENTS = "keep_segments"
SERVING_JOURNAL_KEEP_SEGMENTS_DEFAULT = 3
# ceiling on the journaled in-flight request table (oldest evicted
# first) — bounds segment size under open-stream floods
SERVING_JOURNAL_MAX_INFLIGHT = "max_inflight"
SERVING_JOURNAL_MAX_INFLIGHT_DEFAULT = 256

# "provisioner": the whole-node lifecycle tier (serving/provisioner.py,
# docs/serving.md "Node failure domain"). Enabled gives the autoscaler's
# socket backend a node tier: a replica target past every live node's
# ceiling launches a NEW node agent (local subprocess), a dead node is
# re-provisioned under the same name, and a provisioner-owned node left
# empty by scale-down is terminated whole. Disabled (the default) =
# today's behavior: the nodes map IS the fleet; zero placeable capacity
# raises a typed refusal instead.
SERVING_PROVISIONER = "provisioner"
SERVING_PROVISIONER_ENABLED = "enabled"
SERVING_PROVISIONER_ENABLED_DEFAULT = False
# node.py spec template each launch instantiates (node_id is forced to
# the requested name; engines/replicas come from this template)
SERVING_PROVISIONER_NODE_SPEC = "node_spec"
SERVING_PROVISIONER_NODE_SPEC_DEFAULT = None
SERVING_PROVISIONER_MAX_NODES = "max_nodes"
SERVING_PROVISIONER_MAX_NODES_DEFAULT = 4
SERVING_PROVISIONER_MAX_REPLICAS_PER_NODE = "max_replicas_per_node"
SERVING_PROVISIONER_MAX_REPLICAS_PER_NODE_DEFAULT = 4
SERVING_PROVISIONER_LAUNCH_TIMEOUT_SECS = "launch_timeout_secs"
SERVING_PROVISIONER_LAUNCH_TIMEOUT_SECS_DEFAULT = 120.0
SERVING_PROVISIONER_TERMINATE_GRACE_SECS = "terminate_grace_secs"
SERVING_PROVISIONER_TERMINATE_GRACE_SECS_DEFAULT = 5.0

#############################################
# The process mesh (parallel/mesh.py): the pipe, data, sequence and
# model axes over the processes.
#############################################
MESH = "mesh"
MESH_DATA_PARALLEL_SIZE = "data_parallel_size"
MESH_MODEL_PARALLEL_SIZE = "model_parallel_size"
MESH_SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
MESH_PIPELINE_PARALLEL_SIZE = "pipeline_parallel_size"

#############################################
# Launcher / distributed rendezvous
#############################################
# the arguments add_config_arguments adds, as initialize(args=...) reads them
DEEPSPEED_CONFIG_ARG = "deepspeed_config"
DEEPSCALE_CONFIG_ARG = "deepscale_config"  # deprecated alias
# reference: deepspeed/pt/deepspeed_constants.py TORCH_DISTRIBUTED_DEFAULT_PORT
# (the torch.distributed TCP store's port, as upstream)
TORCH_DISTRIBUTED_DEFAULT_PORT = 29500
