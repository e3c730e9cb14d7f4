"""InferenceEngine: the serving façade behind ``init_inference``.

Port of deepspeed_tpu/inference/engine.py. It glues three layers
together:

  params     — the caller's GPT-2 weights, copied into the engine's own
               model in the serving dtype on the serving device (the
               caller's module is left as it was).
  decode     — prefill / decode-and-sample over inference/decode.py and
               inference/sampling.py; the KV cache (contiguous or paged)
               is updated in place.
  scheduling — the ContinuousBatchingScheduler (scheduler.py, unchanged
               from the JAX package) owning the bounded admission queue
               and the slot table; ``generate`` is the synchronous
               convenience over it, ``submit`` + ``serve_forever`` the
               server mode.

Ported: the contiguous KV cache (``kv_block_size: 0``), the paged KV
cache with the cross-request prefix cache, fused decode attention (the
paged decode kernel), greedy and sampled decoding, and multi-LoRA
serving (the ``adapters`` block): a device adapter pool
read per slot by adapter id, through the SGMV kernel in fused decode,
with ``load_adapter(name, adapter_state=...)``, per-slot pins, idle-LRU
eviction and prefix-cache pages salted by adapter identity.
The ``telemetry`` block (telemetry/manager.py): the ``infer/*`` catalog
in the telemetry's registry, its exporters fed by the scheduler every
``16 * telemetry.interval`` decode steps and at ``close()``, and the
request tracer (``telemetry.tracing``) handed to the scheduler, whose
request, queue, prefill and decode-step spans carry the JAX engine's
names and attributes. Without the block, metrics go to a private
registry and the tracer is the no-op one.
Serving from checkpoints (runtime/checkpointing.py): the weights come
from ``inference.checkpoint.load_dir``/``tag`` through the verified load
(manifest check, host-side parse, newest-valid fallback), and
``load_adapter(name, load_dir=...)`` reads an adapter-only checkpoint the
same way, its rank, scale and targets checked against the pool before a
row is written. The resilience instruments (``resilience/*``) live on the
engine's metrics registry, and the ``decode.step`` fault site fires at
each decode step, which the scheduler's driver auto-restart absorbs.
The host-memory spill tier (``inference.host_tier``,
inference/host_tier.py): evicted prefix pages and adapter rows park in
pinned host memory and promote back on a chain-hash or adapter-name hit,
through a copy stream ordered by events; ``lazy_alloc`` grows a slot's
pages during decode and preempts under pressure; engines of one
``share_group`` share one tier. Speculative decoding
(``inference.speculative`` with ``draft_model``): a small draft on its
own contiguous cache proposes k greedy tokens and the target verifies
them in one suffix-prefill step over the paged cache. The fleet's hooks
(serving/): :meth:`InferenceEngine.use_tracer` adopts the router's
tracer, and :meth:`InferenceEngine.set_brownout` stops prefix
registration (prefill's and decode's) while prefix hits go on serving
suffix-only.

Serving over the model axis (``mesh`` or a ``mesh`` block with a
``model_parallel_size`` above 1, one process per GPU of a world of that
many ranks, as the port's launcher starts them): every rank builds the
engine from the same model and config; the weights are cut to the rank's
Megatron shards by GPT-2's ``partition_specs`` (or ``param_specs``), the
KV cache or page pool holds the rank's heads and the adapter pool its
shards of every adapter (models/gpt2.py), and the blocks run on the
rank's heads through the same kernels (ops/transformer.py), with the
row-parallel all-reduces of the training blocks. Unlike the JAX engine,
which drops fused decode to its XLA path under a model axis, the port
keeps the paged decode and SGMV kernels: they run per rank. The
speculative draft is whole on every rank, with its own cache, as the JAX
engine replicates it.

Serving over a data axis (``data_parallel_size`` above 1 in the block,
or a mesh with a data axis): the JAX engine builds its serving mesh from
``data_parallel_size`` and ``model_parallel_size`` alone (an unset data
size takes every device the model axis leaves; a sequence or pipe size
in the block is not read) and replicates the weights and the KV pool
over every axis but ``model``; so does the port. Every data replica holds
the whole pool at its model shard and runs every plan, as each of the
JAX engine's data devices computes the replicated step. A ``ProcessMesh``
with a sequence or pipe axis above 1 is served the same way: those axes
replicate the engine too, as the JAX engine serves on such a mesh.

One controller: global rank 0 (the leader) owns the scheduler, the block
pool, the prefix registry, the adapter registry and the host tier's
decisions, and is the only rank that takes requests and samples. Before
each device operation (a prefill, a decode step, a speculative cycle, a
page or adapter row parked or promoted, an adapter's rows written, a
reset) it broadcasts that operation's plan (its kind and the host arrays
it reads: token ids, positions, block tables, slot adapter ids) to every
rank of the serving mesh over a gloo group of its own; the other ranks
(followers, of any data or model coordinate) run
:meth:`InferenceEngine.follow` (``serve_forever``), which executes each
plan until the leader closes the engine. So every rank issues the same
collectives in the same order, whatever the leader's clock and threads
decide. A follower's host tier is a store of its own heads' rows keyed
as the leader's tier keys them; the leader names what it parks, promotes
and drops. A model with MoE experts or pipeline stages is refused, with
the JAX engine's ``DeepSpeedConfigError``s: decode runs the dense stack.

Adapter pool rows are written IN PLACE (the JAX engine swaps in a new
pool between steps). ``load_adapter`` runs on a caller's thread while
the scheduler drives on its own, so one engine lock serializes the row
write with prefill and decode: a reload lands between two decode steps,
never between two layers of one.
"""

import dataclasses
import datetime
import threading
import time
import types
import typing
import uuid

import numpy as np
import torch

from ..config import constants as C
from ..config.config import DeepSpeedConfig, DeepSpeedConfigError
from ..config.config_utils import load_config_json
from ..adapters.lora import (
    adapter_host_template,
    adapter_layer_stacks,
    split_lora_params,
)
from ..adapters.pool import AdapterPool, AdapterPoolFull, AdapterUnavailable
from ..models.gpt2 import (
    GPT2LMHeadModel,
    adapter_pool_partition_specs,
    partition_specs,
)
from ..ops.decode_attention import SGMV_MAX_RANK
from ..ops.head_dims import check_head_dim, model_head_dim
from ..ops.transformer import lora_scaling, resolve_lora_targets
from ..parallel import tensor as tp_lib
from ..parallel.mesh import ProcessMesh, build_mesh
from ..runtime import dist as dist_lib
from ..resilience.manager import build_resilience
from ..runtime.checkpointing import load_module_state
from ..telemetry.manager import (
    build_telemetry,
    register_adapter_metrics,
    register_host_tier_metrics,
    register_inference_metrics,
)
from ..telemetry.registry import MetricsRegistry
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from .decode import (
    gpt2_decode_step,
    gpt2_decode_step_paged,
    gpt2_prefill,
    gpt2_prefill_suffix,
    init_adapter_pool,
    init_kv_cache,
    init_kv_pool,
    write_prefill_to_cache,
    write_prefill_to_pool,
)
from .host_tier import HostTier
from .paging import NULL_BLOCK, BlockPool, PoolExhausted, hash_full_blocks
from .sampling import mask_padded_vocab, sample_tokens
from .scheduler import ContinuousBatchingScheduler, RequestRejected  # noqa: F401  (re-exported)


class _Placed(typing.NamedTuple):
    """A host-tier promotion's device tensors and the event that marks
    their copy (on the tier's copy stream)."""

    arrays: tuple
    event: object


def _device_placer(device):
    """The host tier's ``place_fn`` for an engine on ``device``: on CUDA
    the host-to-device copies of a promoted entry (pinned memory, so
    they are asynchronous) run on a copy stream of their own and record
    an event, which the consumer's stream waits on before it reads them
    (:func:`_landed`) — as ``runtime/staging.py`` orders its windows. On
    the CPU the identity (None)."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device=device)

    def place(arrays):
        with torch.cuda.stream(stream):
            out = tuple(a.to(device, non_blocking=True) for a in arrays)
            event = torch.cuda.Event()
            event.record(stream)
        return _Placed(out, event)

    return place


def _landed(placed):
    """The placed arrays, ready for the current stream: it waits on the
    copy's event, and the tensors are marked as used on it (the caching
    allocator then keeps their memory until its work on them is done)."""
    if not isinstance(placed, _Placed):
        return tuple(placed)
    if not placed.arrays:
        return ()
    stream = torch.cuda.current_stream(placed.arrays[0].device)
    stream.wait_event(placed.event)
    for t in placed.arrays:
        t.record_stream(stream)
    return placed.arrays


#: The followers' parked rows per host-tier share group in this process,
#: shared as the leaders' tiers are (HostTier.shared)
_FOLLOWER_STORES = {}


def _is_gpt2_config(cfg):
    return cfg is not None and all(
        hasattr(cfg, a) for a in ("n_layer", "n_head", "n_embd",
                                  "n_positions", "layer_config")
    )


class InferenceEngine:
    def __init__(
        self,
        model=None,
        config=None,
        model_parameters=None,
        mesh=None,
        rng_seed=0,
        device=None,
        draft_model=None,
        draft_parameters=None,
        param_specs=None,
    ):
        mcfg = getattr(model, "config", None)
        if not _is_gpt2_config(mcfg):
            raise DeepSpeedConfigError(
                "init_inference serves the GPT-2 family: pass a "
                "GPT2LMHeadModel (a module whose .config carries "
                "n_layer/n_head/n_embd/n_positions)"
            )
        if getattr(mcfg, "moe_experts", 0) > 0:
            raise DeepSpeedConfigError(
                "KV-cache decode does not support MoE layers yet "
                "(moe_experts > 0)"
            )
        if getattr(mcfg, "pipeline_stages", 1) > 1:
            raise DeepSpeedConfigError(
                "KV-cache decode does not support the pipelined stack yet "
                "(pipeline_stages > 1)"
            )
        self.model_config = mcfg

        # ---- config ---------------------------------------------------
        if config is None:
            raw = {}
        elif isinstance(config, dict):
            raw = dict(config)
        else:  # JSON path
            raw = load_config_json(config)
        mesh_block = raw.get(C.MESH) or {}
        self.config = DeepSpeedConfig(None, param_dict=raw)
        cfg = self.config

        # ---- geometry -------------------------------------------------
        self.max_seq_len = cfg.inference_max_seq_len or mcfg.n_positions
        if self.max_seq_len > mcfg.n_positions:
            raise DeepSpeedConfigError(
                f"inference.max_seq_len={self.max_seq_len} exceeds the "
                f"model's n_positions={mcfg.n_positions}"
            )
        self.prefill_len = cfg.inference_prefill_len or self.max_seq_len
        if self.prefill_len > self.max_seq_len:
            raise DeepSpeedConfigError(
                f"inference.prefill_len={self.prefill_len} exceeds the "
                f"resolved max_seq_len={self.max_seq_len} (model "
                f"n_positions={mcfg.n_positions})"
            )
        self.num_slots = cfg.inference_max_batch_slots
        self.compute_dtype = (
            torch.bfloat16 if cfg.inference_dtype == "bf16" else torch.float32
        )

        # ---- paged-cache geometry (docs/inference.md "Paged KV cache") -
        self.kv_block_size = int(cfg.inference_kv_block_size)
        self.paged = self.kv_block_size > 0
        if self.paged:
            if self.max_seq_len % self.kv_block_size != 0:
                raise DeepSpeedConfigError(
                    f"resolved max_seq_len={self.max_seq_len} is not a "
                    f"multiple of inference.kv_block_size="
                    f"{self.kv_block_size} (model n_positions="
                    f"{mcfg.n_positions}); the paged cache's logical "
                    f"extent must equal the contiguous cache's"
                )
            self.blocks_per_slot = self.max_seq_len // self.kv_block_size
            self.kv_pool_blocks = (
                int(cfg.inference_kv_pool_blocks)
                or self.num_slots * self.blocks_per_slot
            )
            enabled = cfg.inference_prefix_cache_enabled
            self.prefix_cache_enabled = True if enabled is None else enabled
            buckets = cfg.inference_prefix_cache_suffix_buckets
            if buckets is None:
                # power-of-two ladder from one page up to the prefill
                # window
                buckets, b = [], self.kv_block_size
                while b < self.prefill_len:
                    buckets.append(b)
                    b *= 2
                buckets.append(self.prefill_len)
            self._suffix_buckets = sorted(
                {min(int(b), self.prefill_len) for b in buckets}
            )
        else:
            self.blocks_per_slot = 0
            self.kv_pool_blocks = 0
            self.prefix_cache_enabled = False
            self._suffix_buckets = []

        # ---- fused decode attention -----------------------------------
        self.fused_decode = bool(cfg.inference_fused_decode)
        if self.fused_decode and not self.paged:
            # config validation catches the explicit case; engine-derived
            # geometry re-checks here
            raise DeepSpeedConfigError(
                "inference.fused_decode requires the paged cache "
                "(kv_block_size > 0): the kernel streams KV pages "
                "through the block table"
            )

        # ---- speculative decoding geometry ----------------------------
        self.speculative = bool(cfg.inference_speculative_enabled)
        self.spec_k = int(cfg.inference_speculative_k)
        if self.speculative and self.fused_decode:
            # the speculative step's compute is the draft's contiguous
            # decode plus the target's multi-token verify: the
            # single-query paged decode kernel serves no token there, so
            # the flag (and its gauge) goes off
            log_dist(
                "inference.fused_decode is inert under speculative "
                "decoding (the verify step is a multi-token suffix "
                "prefill, the draft rides its own contiguous cache) — "
                "disabling the flag so telemetry reports what actually "
                "served",
                ranks=[0],
            )
            self.fused_decode = False
        dcfg = None
        if self.speculative:
            if not self.paged:
                raise DeepSpeedConfigError(
                    "inference.speculative requires the paged cache "
                    "(kv_block_size > 0): the batched verify step "
                    "writes through the block tables"
                )
            if draft_model is None:
                raise DeepSpeedConfigError(
                    'the "speculative" inference block is configured '
                    "but init_inference received no draft: pass "
                    "draft_model (a smaller GPT-2 module) and "
                    "draft_parameters (its param tree)"
                )
            if not cfg.inference_greedy and cfg.inference_temperature > 0:
                raise DeepSpeedConfigError(
                    "speculative decoding preserves exact output for "
                    "GREEDY decoding only (every committed token is the "
                    "target's own argmax); set inference.sampling.greedy "
                    "or temperature 0"
                )
            dcfg = getattr(draft_model, "config", None)
            if not _is_gpt2_config(dcfg):
                raise DeepSpeedConfigError(
                    "draft_model must be a GPT-2-family module (a "
                    ".config with n_layer/n_head/n_embd/n_positions)"
                )
            if getattr(dcfg, "vocab_size", None) != getattr(
                mcfg, "vocab_size", None
            ):
                raise DeepSpeedConfigError(
                    f"draft vocab_size={getattr(dcfg, 'vocab_size', None)}"
                    f" != target vocab_size="
                    f"{getattr(mcfg, 'vocab_size', None)}: proposals are "
                    "token ids — the vocabularies must match exactly"
                )
            if dcfg.n_positions < self.max_seq_len:
                raise DeepSpeedConfigError(
                    f"draft n_positions={dcfg.n_positions} < resolved "
                    f"max_seq_len={self.max_seq_len}: the draft must "
                    "reach every position the target serves"
                )
        self.draft_config = dcfg
        # what the card's kernels cannot take is refused here, not mid-step
        check_head_dim(model_head_dim(mcfg), mcfg.n_positions, device,
                       fused_decode=self.fused_decode)
        if dcfg is not None:
            check_head_dim(model_head_dim(dcfg), dcfg.n_positions, device)
        self.device = resolve_device(device)
        # ---- the serving mesh (one controller: global rank 0 leads) -----
        self.mesh = self._serving_mesh(mesh, mesh_block)
        self.mp_size = 1 if self.mesh is None else self.mesh.mp_size
        self.model_rank = 0 if self.mesh is None else self.mesh.model_rank
        self.rank = 0 if self.mesh is None else self.mesh.rank
        self.is_leader = self.rank == 0
        self._ctrl_group = None
        if self.mesh is not None:
            self._ctrl_src = 0
            # every rank of the mesh, whatever its coordinates; plans wait
            # as long as the leader idles
            self._ctrl_group = torch.distributed.new_group(
                list(range(self.mesh.topology.world_size)), backend="gloo",
                timeout=datetime.timedelta(days=365))
        # a follower's host tier: its own heads' rows under the leader's
        # keys; the keys the leader has had followers park (to drop them
        # when its tier does)
        self._store = (_FOLLOWER_STORES.setdefault(
            cfg.inference_host_tier_share_group, {})
            if cfg.inference_host_tier_enabled
            and cfg.inference_host_tier_peer_sharing else {})
        self._parked = set()

        # ---- params ---------------------------------------------------
        state = (
            model.state_dict() if model_parameters is None
            else model_parameters
        )

        # ---- telemetry + metrics --------------------------------------
        self.telemetry = build_telemetry(
            cfg, rank=0 if self.mesh is None else self.mesh.rank,
            n_params=sum(
                int(np.prod(t.shape)) for t in state.values()),
            device=self.device,
        )
        registry = (
            self.telemetry.registry
            if self.telemetry.enabled else MetricsRegistry()
        )
        self.metrics = register_inference_metrics(registry)
        # the resilience instruments share the inference registry, so a
        # corruption fallback on the serving load shows beside infer/*
        self.resilience = build_resilience(
            cfg, telemetry=types.SimpleNamespace(
                enabled=True, registry=self.metrics),
        )

        # ---- host-memory spill tier ------------------------------------
        # device memory as a cache over host RAM: evicted prefix pages and
        # adapter rows park on the host (keyed by chain hash / adapter
        # name) and promote back on a hit. peer_sharing joins the
        # process-level share-group tier, so co-hosted engines warm each
        # other.
        self.host_tier = None
        self.lazy_kv_alloc = False
        if cfg.inference_host_tier_enabled:
            self._tier_client_id = f"engine-{uuid.uuid4().hex[:8]}"
            kw = dict(max_bytes=cfg.inference_host_tier_max_bytes,
                      place_fn=_device_placer(self.device))
            if cfg.inference_host_tier_peer_sharing:
                self.host_tier = HostTier.shared(
                    cfg.inference_host_tier_share_group, **kw)
            else:
                self.host_tier = HostTier(**kw)
            self.host_tier.retain()
            self.lazy_kv_alloc = (
                bool(cfg.inference_host_tier_lazy_alloc) and self.paged
            )
            register_host_tier_metrics(self.metrics)

        # ---- params: the verified checkpoint load ----------------------
        self.loaded_tag = None
        if cfg.inference_checkpoint_load_dir:
            loaded, _, tag = load_module_state(
                cfg.inference_checkpoint_load_dir, state,
                tag=cfg.inference_checkpoint_tag,
                resilience=self.resilience,
            )
            if loaded is None:
                raise RuntimeError(
                    f"no loadable checkpoint under "
                    f"{cfg.inference_checkpoint_load_dir!r} (see the "
                    f"resilience/corruption_fallbacks counter and logs)"
                )
            state, self.loaded_tag = loaded, tag

        # ---- multi-tenant LoRA geometry -------------------------------
        self.multi_lora = bool(cfg.adapters_enabled)
        embedded = bool(split_lora_params(state)[1])
        serve_cfg = mcfg
        if getattr(mcfg, "lora_rank", 0) and not embedded:
            # a fine-tune engine armed the shared config, but these are base
            # parameters: serve the base model (adapters, if any, come
            # through the pool)
            serve_cfg = dataclasses.replace(
                mcfg, lora_rank=0, lora_alpha=0.0, lora_targets=()
            )
        if self.multi_lora:
            if embedded:
                # per-tenant adapters ride the pool; *_lora_* tensors in
                # the params would ALSO apply per-layer — a silent double
                # application
                raise DeepSpeedConfigError(
                    "multi-LoRA serving wants the BASE parameters: "
                    "model_parameters carries *_lora_* tensors — split "
                    "them out (adapters.split_lora_params) and load them "
                    "with engine.load_adapter() instead"
                )
            self.adapter_rank = int(cfg.adapters_rank)
            self.adapter_targets = resolve_lora_targets(cfg.adapters_targets)
            self.adapter_scale = lora_scaling(
                self.adapter_rank, float(cfg.adapters_alpha or 0.0)
            )
            self.adapter_pool_slots = int(cfg.adapters_pool_slots)
            if self.fused_decode and self.adapter_rank > SGMV_MAX_RANK:
                raise DeepSpeedConfigError(
                    f"adapters.rank={self.adapter_rank} exceeds the SGMV "
                    f"kernel's limit of {SGMV_MAX_RANK} (SGMV_MAX_RANK: its "
                    f"[rank] float32 vector lives in shared memory); lower "
                    f"the rank or turn inference.fused_decode off"
                )
        else:
            self.adapter_rank = 0
            self.adapter_targets = ()
            self.adapter_scale = 1.0
            self.adapter_pool_slots = 0

        # request tracer: the telemetry.tracing block's, or the no-op one
        # (a fleet swaps in its own: use_tracer)
        self.tracer = self.telemetry.tracer
        # fleet brownout (set_brownout): prefix registration stops
        self._brownout = False
        # per-slot span attrs captured at prefill time (prefix hit or
        # cold, suffix bucket, adapter) for the scheduler's prefill span
        self._slot_trace_attrs = {}

        # ---- params: copy into the serving dtype on the device --------
        self.model = GPT2LMHeadModel(
            serve_cfg, device=self.device, dtype=self.compute_dtype
        )
        self.model.load_state_dict(state)
        self.model.requires_grad_(False)
        self.model.eval()
        # the whole tensors' shapes (an adapter checkpoint's template)
        self._full_shapes = {n: tuple(t.shape)
                             for n, t in self.model.state_dict().items()}
        if self.mp_size > 1:
            self._shard_model(param_specs)

        # ---- KV cache + host-side allocator ---------------------------
        if self.paged:
            # page free list, prefix-hash registry, refcounts, eviction
            # LRU (inference/paging.py); with the host tier, an evicted
            # registered page spills to host RAM instead of dropping
            self.block_pool = self._new_block_pool()
            self._block_tables = np.zeros(
                (self.num_slots, self.blocks_per_slot), np.int32
            )
            self._slot_blocks = {}  # slot -> this request's page ids
            self._slot_prefix_len = {}  # slot -> cached-prefix tokens
            self._slot_hashes = {}  # slot -> prompt's full-page hash chain
        else:
            self.block_pool = None
        self._cache = self._init_cache()
        # held around prefill, decode and adapter-pool row writes
        self._device_lock = threading.RLock()

        # ---- device adapter pool + host registry ----------------------
        # {target: (A [L, n+1, in, r], B [L, n+1, r, out])}, row 0 the
        # permanent identity; the AdapterPool owns name -> row, per-slot
        # refcounts and idle-LRU eviction
        self._slot_adapter_names = {}  # slot -> adapter name
        self._adapter_template = None  # load_adapter(load_dir=)'s names
        # name -> load generation, mirrored at assign time: the registry
        # drops an evicted tenant's generation before assign returns, but
        # the host-tier spill parks the ORIGINAL generation with the rows
        # (the auto-load restore keeps its salted prefix pages valid)
        self._adapter_generations = {}
        if self.multi_lora:
            self._adapter_pool = init_adapter_pool(
                mcfg, self.adapter_pool_slots, self.adapter_rank,
                self.adapter_targets, self.compute_dtype, self.device,
                mp_size=self.mp_size,
            )
            self.adapter_registry = AdapterPool(self.adapter_pool_slots)
            self._slot_adapters = np.zeros(self.num_slots, np.int32)
        else:
            self._adapter_pool = None
            self.adapter_registry = None
            self._slot_adapters = None

        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(rng_seed))
        self._lengths = np.zeros(self.num_slots, np.int32)
        self._last_tokens = np.zeros(self.num_slots, np.int32)
        self._temps = np.full(
            self.num_slots,
            0.0 if cfg.inference_greedy else cfg.inference_temperature,
            np.float32,
        )
        self._sampling_statics = dict(
            vocab_size=getattr(mcfg, "vocab_size", None)
            or int(self.model.wte.shape[0]),
            top_k=int(cfg.inference_top_k),
            top_p=float(cfg.inference_top_p),
        )

        # ---- speculative decoding state -------------------------------
        # the draft rides its own CONTIGUOUS cache (it shares nothing)
        # and the target's slot/length bookkeeping: rejected proposals'
        # rows sit past the committed length, where the position mask
        # hides them until a later step overwrites them
        self.draft = None
        if self.speculative:
            draft_state = (
                draft_model.state_dict() if draft_parameters is None
                else draft_parameters
            )
            ckpt = cfg.inference_speculative_draft_checkpoint
            if ckpt:
                loaded, _, dtag = load_module_state(
                    ckpt, draft_state, resilience=self.resilience,
                )
                if loaded is None:
                    raise RuntimeError(
                        f"no loadable draft checkpoint under {ckpt!r} "
                        "(see the resilience/corruption_fallbacks "
                        "counter and logs)"
                    )
                draft_state = loaded
                log_dist(f"speculative draft serving checkpoint {dtag}",
                         ranks=[0])
            self.draft = GPT2LMHeadModel(
                dcfg, device=self.device, dtype=self.compute_dtype
            )
            self.draft.load_state_dict(draft_state)
            self.draft.requires_grad_(False)
            self.draft.eval()
            self._draft_cache = self._init_draft_cache()
            # per-slot token at index lengths-1 (the committed token
            # BEFORE the uncached last): the propose step's sync step
            # re-feeds it to close the full-acceptance cache hole
            self._spec_prev_tokens = np.zeros(self.num_slots, np.int32)
        # per-step draft/verify/commit phase stats, read by the
        # scheduler's sched.spec_* spans (None when the last step was not
        # speculative)
        self.spec_step_stats = None

        # ---- KV metric streams ----------------------------------------
        self._kv_occupancy = self.metrics.gauge("infer/kv_pool_occupancy")
        self._kv_bytes = self.metrics.gauge("infer/kv_cache_bytes")
        self._prefix_hits = self.metrics.counter("infer/prefix_hits")
        self._prefix_misses = self.metrics.counter("infer/prefix_misses")
        self._kv_reclaimed = self.metrics.counter("infer/kv_blocks_reclaimed")
        self._reclaimed_synced = 0
        self._kv_bytes.set(
            self._cache.k.numel() * self._cache.k.element_size() * 2
        )
        self.metrics.gauge("infer/fused_decode").set(
            1 if self.fused_decode else 0
        )
        self._spec_proposed = self.metrics.counter("infer/spec_proposed")
        self._spec_accepted = self.metrics.counter("infer/spec_accepted")
        self._spec_rate = self.metrics.gauge("infer/spec_acceptance_rate")
        if self.multi_lora:
            register_adapter_metrics(self.metrics)
            self._adapter_occupancy = self.metrics.gauge(
                "adapters/pool_occupancy"
            )
            self.metrics.gauge("adapters/pool_slots").set(
                self.adapter_pool_slots
            )
            self._adapter_loads = self.metrics.counter("adapters/loads")
            self._adapter_evictions = self.metrics.counter(
                "adapters/evictions"
            )
            self._adapter_requests = self.metrics.counter(
                "adapters/requests"
            )
        if self.host_tier is not None:
            self._ht_occupancy = self.metrics.gauge(
                "host_tier/occupancy_bytes")
            self._ht_entries = self.metrics.gauge("host_tier/entries")
            self._ht_spills = self.metrics.counter("host_tier/spills")
            self._ht_promotions = self.metrics.counter(
                "host_tier/promotions")
            self._ht_peer_fetches = self.metrics.counter(
                "host_tier/peer_fetches")
            self._ht_preemptions = self.metrics.counter(
                "host_tier/preemptions")
            self._ht_copy_faults = self.metrics.counter(
                "host_tier/copy_faults")

        # ---- scheduler ------------------------------------------------
        self.scheduler = ContinuousBatchingScheduler(
            self,
            num_slots=self.num_slots,
            max_seq_len=self.max_seq_len,
            queue_depth=cfg.inference_queue_depth,
            queue_timeout=cfg.inference_queue_timeout,
            eos_token_id=cfg.inference_eos_token_id,
            temperature=(
                0.0 if cfg.inference_greedy else cfg.inference_temperature
            ),
            registry=self.metrics,
            telemetry=self.telemetry,
            export_interval=getattr(self.telemetry, "interval", 1) * 16,
            deadline_secs=cfg.inference_deadline_secs,
            driver_restart_budget=cfg.inference_driver_restart_budget,
            degraded_queue_ratio=cfg.inference_degraded_queue_ratio,
            tracer=self.tracer,
        )
        log_dist(
            f"init_inference: {self.num_slots} decode slots x "
            f"max_seq_len {self.max_seq_len} (prefill window "
            f"{self.prefill_len}), dtype {cfg.inference_dtype} on "
            f"{self.device}, queue depth {cfg.inference_queue_depth}, "
            + (f"model axis {self.mp_size} x "
               f"{self.mesh.topology.world_size // self.mp_size} replicas "
               f"(rank 0 leads, "
               f"{self.model_config.n_head // self.mp_size} heads a rank), "
               if self.mesh is not None else "")
            + (
                f"paged KV cache ({self.kv_pool_blocks} pages x "
                f"{self.kv_block_size} tokens, prefix cache "
                f"{'on' if self.prefix_cache_enabled else 'off'}, fused "
                f"decode {'on' if self.fused_decode else 'off'})"
                if self.paged else "contiguous KV cache"
            )
            + (
                f", LoRA pool of {self.adapter_pool_slots} adapters at rank "
                f"{self.adapter_rank} on {list(self.adapter_targets)}"
                if self.multi_lora else ""
            )
            + (f", host tier of {self.host_tier.max_bytes} bytes"
               + (" (lazy page growth)" if self.lazy_kv_alloc else "")
               if self.host_tier is not None else "")
            + (f", speculative decoding (k={self.spec_k}, "
               f"{dcfg.n_layer}-layer draft)" if self.speculative else "")
            + (f", serving checkpoint {self.loaded_tag}"
               if self.loaded_tag else ""),
            ranks=[0],
        )

    def _serving_mesh(self, mesh, block):
        """The process mesh this engine serves over, or None in one
        process. A config ``mesh`` block gives the JAX engine's serving
        mesh: ``data_parallel_size`` and ``model_parallel_size`` alone
        (a sequence or pipe size there is not read, as the JAX engine
        reads none; an unset data size takes every rank the model axis
        leaves) over the torch.distributed world, which the launcher's
        environment starts; without a data or model size above 1 the
        engine serves in this process alone. A ``ProcessMesh`` is served
        as it is: every axis but ``model`` replicates the engine, as the
        JAX engine replicates weights and KV pool over them."""
        if mesh is None:
            dp = block.get(C.MESH_DATA_PARALLEL_SIZE)
            dp = None if dp is None else int(dp)
            mp = int(block.get(C.MESH_MODEL_PARALLEL_SIZE) or 1)
            if mp <= 1 and (dp is None or dp <= 1):
                return None
            dist_lib.init_distributed(device=self.device)
            mesh = build_mesh(data_parallel_size=dp, model_parallel_size=mp)
        elif not isinstance(mesh, ProcessMesh):
            raise DeepSpeedConfigError(
                f"serving over a {type(mesh).__name__} mesh: the port runs "
                "one process a rank and takes a deepspeed_tpu_torch."
                "parallel.ProcessMesh or a mesh config block (a "
                "jax.sharding.Mesh lays one process's arrays over its "
                "devices, which has no counterpart here)")
        return mesh if mesh.topology.world_size > 1 else None

    def _shard_model(self, param_specs):
        """Cut the served model's parameters to this rank's Megatron
        shards (``param_specs``, default GPT-2's ``partition_specs``; a
        name the specs leave out takes that rule) and arm its
        tensor-parallel seam, as the training engine does."""
        mp, rank = self.mesh.mp_size, self.mesh.model_rank
        heads = self.model_config.n_head
        if heads % mp:
            raise DeepSpeedConfigError(
                f"{heads} attention heads do not split over a model axis "
                f"of {mp}: tensor parallelism shards whole heads")
        own = partition_specs(self.model)
        specs = own if param_specs is None else param_specs
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                d = tp_lib.model_dim(specs.get(n, own.get(n)))
                if d is not None:
                    p.data = tp_lib.shard_for_rank(
                        n, p.data, d, mp, rank).contiguous().clone()
        self.model.configure_model_parallel(self.mesh.model_group, rank, mp)

    def _init_cache(self):
        """Fresh zeroed decode cache: the contiguous per-slot block or the
        paged page pool, per the engine's mode (this rank's heads)."""
        if self.paged:
            return init_kv_pool(
                self.model_config, self.kv_pool_blocks, self.kv_block_size,
                self.compute_dtype, self.device, mp_size=self.mp_size,
            )
        return init_kv_cache(
            self.model_config, self.num_slots, self.max_seq_len,
            self.compute_dtype, self.device, mp_size=self.mp_size,
        )

    def _init_draft_cache(self):
        return init_kv_cache(
            self.draft_config, self.num_slots, self.max_seq_len,
            self.compute_dtype, self.device,
        )

    def _new_block_pool(self):
        return BlockPool(
            self.kv_pool_blocks, self.kv_block_size,
            spill_fn=(self._spill_kv_page if self.host_tier is not None
                      else None),
        )

    # -- one controller: the leader's plans, the followers' loop ---------
    def _tell(self, name, *args):
        """Over a model axis, broadcast device operation ``name`` and its
        host arguments to the followers (with the keys they parked that
        the leader's tier has dropped since); a no-op in one process."""
        if self._ctrl_group is None:
            return
        drops = []
        if self._parked and self.host_tier is not None:
            drops = [k for k in self._parked if not self.host_tier.contains(k)]
            self._parked.difference_update(drops)
        torch.distributed.broadcast_object_list(
            [(name, args, drops)], src=self._ctrl_src,
            group=self._ctrl_group)

    def _run(self, name, *args):
        """Device operation ``name`` on every rank: its plan told to the
        followers, then run here; returns what it returns here."""
        self._tell(name, *args)
        return getattr(self, "_op_" + name)(*args)

    def follow(self):
        """A follower's loop: execute each plan the leader broadcasts,
        until it closes the engine (then close this rank's engine). The
        leader's ``serve_forever``/``generate`` drive it; a follower
        takes no requests."""
        if self.is_leader:
            raise RuntimeError("follow() runs on the ranks other than 0; "
                               "rank 0 serves")
        while True:
            box = [None]
            torch.distributed.broadcast_object_list(
                box, src=self._ctrl_src, group=self._ctrl_group)
            name, args, drops = box[0]
            for key in drops:
                self._store.pop(key, None)
            if name == "close":
                break
            with self._device_lock:
                getattr(self, "_op_" + name)(*args)
        self._close_local()

    def _require_leader(self):
        if not self.is_leader:
            raise RuntimeError(
                f"rank {self.rank} follows rank 0's plans: call "
                "serve_forever() (or follow()) on it; rank 0 takes the "
                "requests")

    def _lora_ids(self, ids):
        """The decode functions' adapter arguments for the slot adapter ids
        ``ids`` (a host array, or None on an adapter-free engine)."""
        if ids is None:
            return {}
        if not torch.is_tensor(ids):
            ids = self._to_device(ids)
        return dict(adapters=self._adapter_pool, adapter_ids=ids,
                    lora_scale=self.adapter_scale)

    def _slot_ids(self, slots):
        """A copy of the adapter ids of ``slots`` (None without adapters),
        for a plan."""
        if not self.multi_lora:
            return None
        return self._slot_adapters[slots].copy()

    # the device operations: run by the leader and, from its plans, by
    # every follower
    def _op_prefill(self, padded, slot, block_ids, offsets, ids):
        logits, ks, vs = gpt2_prefill(
            self.model, self._to_device(padded), **self._lora_ids(ids))
        if block_ids is not None:
            write_prefill_to_pool(
                self._cache, ks, vs, self._to_device(block_ids),
                self._to_device(offsets))
        else:
            write_prefill_to_cache(self._cache, slot, ks, vs)
        return logits

    def _op_suffix(self, padded, prefix_len, table, ids):
        logits, _ = gpt2_prefill_suffix(
            self.model, self._to_device(padded),
            self._to_device(np.full(1, prefix_len, np.int32)), self._cache,
            self._to_device(table), **self._lora_ids(ids))
        return logits

    def _op_draft_prefill(self, padded, slot):
        _, dks, dvs = gpt2_prefill(self.draft, self._to_device(padded))
        write_prefill_to_cache(self._draft_cache, slot, dks, dvs)

    def _op_decode(self, last_tokens, lengths, tables, ids):
        tokens = self._to_device(last_tokens)
        positions = self._to_device(lengths)
        lora = self._lora_ids(ids)
        if tables is not None:
            logits, _ = gpt2_decode_step_paged(
                self.model, tokens, positions, self._cache,
                self._to_device(tables), fused=self.fused_decode, **lora)
        else:
            logits, _ = gpt2_decode_step(
                self.model, tokens, positions, self._cache, **lora)
        return logits

    def _op_spill_kv(self, block_id, key):
        # a follower parks its heads' rows of the page
        self._store[key] = tuple(self._to_host(
            (self._cache.k[:, block_id], self._cache.v[:, block_id])))

    def _op_promote(self, pairs):
        # a follower writes back its parked rows of each promoted page
        with torch.no_grad():
            for page, key in pairs:
                k_rows, v_rows = self._store[key]
                self._cache.k[:, page] = k_rows.to(self._cache.k.device,
                                                   self._cache.k.dtype)
                self._cache.v[:, page] = v_rows.to(self._cache.v.device,
                                                   self._cache.v.dtype)

    def _op_adapter_rows(self, idx, stacks):
        self._write_adapter_rows(idx, self._shard_stacks(stacks))

    def _op_spill_adapter(self, name, idx):
        self._store[f"adapter/{name}"] = self._adapter_rows_to_host(idx)

    def _op_restore_adapter(self, name, idx):
        rows = self._store[f"adapter/{name}"]
        targets = sorted(self._adapter_pool)
        self._write_adapter_rows(idx, {
            t: (rows[2 * i], rows[2 * i + 1]) for i, t in enumerate(targets)})

    def _park(self, key):
        """The leader has had the followers park ``key``."""
        if self._ctrl_group is not None:
            self._parked.add(key)

    def _to_device(self, array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _to_host(self, tensors):
        """Host copies of device ``tensors`` (taken before the caller
        frees or overwrites their rows): on CUDA into pinned memory,
        every copy queued before one wait on the stream."""
        if self.device.type != "cuda":
            return [t.clone(memory_format=torch.contiguous_format)
                    for t in tensors]
        out = []
        for t in tensors:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            out.append(host)
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def _sample(self, logits, temperatures):
        return sample_tokens(
            logits, self._generator, self._to_device(temperatures),
            **self._sampling_statics,
        )

    # -- paged-pool accounting (scheduler admission hooks) --------------
    def kv_blocks_needed(self, prompt_len, max_new_tokens):
        """Worst-case pages one request reserves at admission: every
        token it may cache, prompt plus generation budget, capped at the
        sequence limit — decode never allocates mid-flight."""
        total = min(int(prompt_len) + int(max_new_tokens), self.max_seq_len)
        return self.block_pool.blocks_for(total)

    def kv_blocks_needed_now(self, prompt_len, max_new_tokens):
        """Pages admission actually reserves: the worst case by default;
        under ``host_tier.lazy_alloc`` only the PROMPT's pages — decode
        grows the slot one page at a time (ensure_decode_capacity) and
        the scheduler preempts under pressure instead of gating admission
        on tokens that may never be generated."""
        if self.lazy_kv_alloc:
            return self.block_pool.blocks_for(
                min(int(prompt_len), self.max_seq_len)
            )
        return self.kv_blocks_needed(prompt_len, max_new_tokens)

    def kv_blocks_available(self):
        """Pages an admission could obtain right now (free + evictable
        cached): the REJECT_CAPACITY gate's denominator."""
        return self.block_pool.available_blocks

    def kv_pool_total_blocks(self):
        return self.block_pool.num_blocks

    def reserve_request(self, slot, prompt_tokens, max_new_tokens):
        """Slot-join page allocation: look up the longest cached prefix
        (acquiring shared references on its pages), extend it with the
        contiguous run of pages parked in the host tier, then allocate
        private pages for everything else this request may write. Raises
        :class:`paging.PoolExhausted` — the scheduler defers the request
        — with no pages held. Returns the cached prefix length in tokens
        (0 = cold; always 0 on the contiguous cache)."""
        if not self.paged:
            return 0
        plen = len(prompt_tokens)
        needed = self.kv_blocks_needed_now(plen, max_new_tokens)
        # cheap pressure short-circuit before the O(prompt) hash chain
        min_private = needed - (plen - 1) // self.kv_block_size
        if self.block_pool.available_blocks < min_private:
            raise PoolExhausted(
                min_private, self.block_pool.available_blocks
            )
        hashes = None
        if self.prefix_cache_enabled:
            # salted by the slot's adapter identity: adapted prefills
            # write adapter-specific k/v, so pages never share across
            # adapters (or across reloads of one adapter's weights)
            hashes = hash_full_blocks(
                prompt_tokens, self.kv_block_size,
                salt=self._adapter_salt(slot),
            )
            prefix_len, shared = self.block_pool.match_prefix(
                prompt_tokens, hashes=hashes
            )
        else:
            prefix_len, shared = 0, []
        # host-tier promotion: the spilled pages that continue the device
        # match (possibly parked by a peer engine) land in freshly
        # allocated private pages — the tier saves the prefill COMPUTE,
        # not the allocation — then register so they share like any
        # cached prefix
        promoted = []
        if self.prefix_cache_enabled and self.host_tier is not None:
            promoted = self._promote_chain(hashes, len(shared), plen)
        while promoted:
            # the combined prefix still needs a suffix width; shrink the
            # promotion until one fits
            pl = (len(shared) + len(promoted)) * self.kv_block_size
            if self._suffix_bucket(plen - pl, pl) is not None:
                break
            promoted.pop()
        if not promoted and prefix_len and self._suffix_bucket(
            plen - prefix_len, prefix_len
        ) is None:
            # no suffix width fits this (suffix, prefix) pair: fall back
            # to the always-correct cold full prefill
            self.block_pool.release(shared)
            prefix_len, shared = 0, []
        try:
            private = self.block_pool.alloc(needed - len(shared))
        except Exception:
            if shared:
                self.block_pool.release(shared)
            raise
        if promoted:
            # the parked rows into the first promoted-count private pages
            # (their host-to-device copies were queued on the tier's copy
            # stream at fetch; each waits here on its own event), then
            # publish their hashes
            with self._device_lock, torch.no_grad():
                self._tell("promote", [(private[i], h) for i, (h, _, _)
                                       in enumerate(promoted)])
                for i, (_, (k_rows, v_rows), peer) in enumerate(promoted):
                    self._cache.k[:, private[i]] = k_rows.to(
                        self._cache.k.dtype)
                    self._cache.v[:, private[i]] = v_rows.to(
                        self._cache.v.dtype)
                    self._ht_promotions.inc()
                    if peer:
                        self._ht_peer_fetches.inc()
            self.block_pool.register_prefix(
                prompt_tokens,
                [private[i] for i in range(len(promoted))],
                hashes=[h for h, _, _ in promoted],
            )
            prefix_len = (len(shared) + len(promoted)) * self.kv_block_size
        if self.prefix_cache_enabled:
            (self._prefix_hits if prefix_len else self._prefix_misses).inc()
        blocks = shared + private
        self._slot_blocks[slot] = blocks
        self._slot_prefix_len[slot] = prefix_len
        self._slot_hashes[slot] = hashes
        row = np.zeros(self.blocks_per_slot, np.int32)
        row[: len(blocks)] = blocks
        self._block_tables[slot] = row
        self._sync_pool_metrics()
        return prefix_len

    # -- host-tier seams -------------------------------------------------
    def _ht_fault_mode(self):
        """Consult the ``host_tier.copy`` chaos site at a copy seam.
        Returns None (no fault), "oserror" (skip the copy — a spill is
        dropped, a promotion reads cold), or "garble" (park a corrupted
        payload for the checksum walk to catch). Counted either way."""
        spec = self.resilience.faults.fire("host_tier.copy")
        if spec is None:
            return None
        self._ht_copy_faults.inc()
        return spec.args.get("mode", "oserror")

    def _spill_kv_page(self, block_id, chain_hash):
        """BlockPool eviction seam: park the evicted registered page's
        k/v rows in the host tier while they are still intact (the
        allocator frees the id right after). Never raises — a failed
        spill degrades to the tier-less behaviour (the page drops)."""
        mode = self._ht_fault_mode()
        if mode is not None and mode != "garble":
            logger.warning(
                "host-tier spill of page %d skipped (injected "
                "host_tier.copy fault): the page drops as without the "
                "tier", block_id,
            )
            return
        with self._device_lock:
            self._tell("spill_kv", block_id, chain_hash)
            self._park(chain_hash)
            rows = self._to_host(
                (self._cache.k[:, block_id], self._cache.v[:, block_id]))
        stored = self.host_tier.put(
            chain_hash, rows, meta={"kind": "kv"},
            origin=self._tier_client_id, corrupt=(mode == "garble"),
        )
        if stored:
            self._ht_spills.inc()

    def _promote_chain(self, hashes, start, plen):
        """Fetch the contiguous run of spilled pages extending the device
        prefix match at page index ``start``. Every fetch is queued on
        the tier's worker first, then consumed in order, so page i+1's
        copy overlaps page i's. Returns a list of ``(chain_hash, (k_rows,
        v_rows), is_peer_fetch)`` with the rows on the device; any
        failure (chaos fault, checksum drop, raced eviction, geometry
        mismatch) truncates the run — the rest re-prefills cold, wrong
        pages are never served."""
        tier = self.host_tier
        eligible = hashes or []
        if eligible and plen == len(eligible) * self.kv_block_size:
            # same N-1 rule as match_prefix: the whole prompt can never
            # be served from cache
            eligible = eligible[:-1]
        handles = []
        for h in eligible[start:]:
            if not tier.contains(h):
                break
            if self._ht_fault_mode() is not None:
                logger.warning(
                    "host-tier promotion truncated (injected "
                    "host_tier.copy fault): the remaining prefix "
                    "re-prefills cold"
                )
                break
            handle = tier.fetch_async(h, requester=self._tier_client_id)
            if handle is None:
                break
            handles.append((h, handle))
        out, failed = [], False
        # one page's [L, bs, heads, hd] rows: the pool minus the page axis
        k_shape = (self._cache.k.shape[0],) + tuple(self._cache.k.shape[2:])
        for h, handle in handles:
            if failed:
                try:
                    handle.result()  # drain to unpin the tier entry
                except Exception:
                    pass
                continue
            try:
                k_rows, v_rows = _landed(handle.result())
            except Exception:
                self._ht_copy_faults.inc()
                logger.warning(
                    "host-tier promotion of %s failed at placement; "
                    "falling back to cold prefill", h,
                )
                failed = True
                continue
            if tuple(k_rows.shape) != k_shape:
                # a peer with a different pool geometry parked this entry
                failed = True
                continue
            out.append((h, (k_rows, v_rows), handle.peer))
        return out

    def ensure_decode_capacity(self, active_slots):
        """Lazy page growth (host_tier.lazy_alloc): before a decode step,
        extend every active slot's page list to cover the rows the step
        will write (one token, or the speculative burst). Raises
        :class:`paging.PoolExhausted` when the pool cannot grow a slot
        even after evicting every cached page — the scheduler preempts
        and retries."""
        if not (self.paged and self.lazy_kv_alloc):
            return
        budget = (self.spec_k + 1) if self.speculative else 1
        for slot in active_slots:
            blocks = self._slot_blocks.get(slot)
            if blocks is None:
                continue
            required = self.block_pool.blocks_for(
                min(int(self._lengths[slot]) + budget, self.max_seq_len)
            )
            while len(blocks) < required:
                new = self.block_pool.alloc(1)
                self._block_tables[slot][len(blocks)] = new[0]
                blocks.extend(new)
        self._sync_pool_metrics()

    def count_preemption(self):
        """Scheduler hook: one request preempted under page pressure (its
        pages parked, the request re-queued for suffix resume)."""
        if self.host_tier is not None:
            self._ht_preemptions.inc()

    def _register_decode_pages(self, slot, final_tokens):
        """Extend the prefix registry to the full pages this request
        completed during decode, so generated continuations become
        shareable (and spillable) prefixes — and a preempted request's
        resume matches everything but its final partial page. Runs before
        the slot's pages release and before its adapter pin drops (the
        chain salt needs the adapter identity). Skipped under fleet
        brownout (set_brownout)."""
        if not self.prefix_cache_enabled or self._brownout:
            return
        blocks = self._slot_blocks.get(slot)
        if not blocks:
            return
        # cache rows hold prompt + tokens[:-1] (the final sampled
        # token's k/v is never written): exactly the first _lengths rows
        valid = [int(t) for t in final_tokens][: int(self._lengths[slot])]
        n_full = len(valid) // self.kv_block_size
        if n_full <= 0:
            return
        self.block_pool.register_prefix(
            valid, blocks[:n_full],
            hashes=hash_full_blocks(
                valid, self.kv_block_size, salt=self._adapter_salt(slot)
            ),
        )

    def release_slot(self, slot, final_tokens=None):
        """Return a finished/evicted request's pages to the pool (shared
        prefix pages decref; full prompt pages stay cached for the next
        request with that prefix) and NULL its block-table row so the
        dead slot's ride-along decode writes sink into the sacrificial
        page. Also drops the slot's adapter pin; its id resets to the
        identity, so the dead slot's ride-along decode reads the zero
        rows, never another tenant's. ``final_tokens`` (prompt +
        generated) registers the request's full pages first, so they park
        in the LRU (and spill to the host tier) instead of dropping."""
        if self.paged and final_tokens is not None:
            self._register_decode_pages(slot, final_tokens)
        if self.multi_lora:
            name = self._slot_adapter_names.pop(slot, None)
            if name is not None:
                self.adapter_registry.release(name)
            self._slot_adapters[slot] = 0
        if not self.paged:
            return
        blocks = self._slot_blocks.pop(slot, None)
        self._slot_prefix_len.pop(slot, None)
        self._slot_hashes.pop(slot, None)
        if blocks:
            self.block_pool.release(blocks)
        self._block_tables[slot] = NULL_BLOCK
        self._sync_pool_metrics()

    def _sync_pool_metrics(self):
        pool = self.block_pool
        self._kv_occupancy.set(pool.used_blocks)
        if pool.reclaimed > self._reclaimed_synced:
            self._kv_reclaimed.inc(pool.reclaimed - self._reclaimed_synced)
            self._reclaimed_synced = pool.reclaimed
        if self.host_tier is not None:
            self._ht_occupancy.set(self.host_tier.occupancy_bytes)
            self._ht_entries.set(self.host_tier.entries)

    def kv_snapshot(self):
        """Pool/prefix-cache (and host-tier) state for
        ``load_snapshot()``."""
        if not self.paged:
            out = {}
        else:
            hits = self._prefix_hits.value
            misses = self._prefix_misses.value
            out = {
                "kv_blocks_total": self.block_pool.num_blocks,
                "kv_blocks_free": self.block_pool.available_blocks,
                "kv_blocks_used": self.block_pool.used_blocks,
                "prefix_hits": hits,
                "prefix_misses": misses,
                "prefix_hit_rate": (
                    hits / (hits + misses) if hits + misses else 0.0
                ),
            }
        if self.host_tier is not None:
            # the engine's own counters plus the (possibly peer-shared)
            # tier's occupancy
            out.update({
                "host_tier_occupancy_bytes": self.host_tier.occupancy_bytes,
                "host_tier_entries": self.host_tier.entries,
                "host_tier_spills": self._ht_spills.value,
                "host_tier_promotions": self._ht_promotions.value,
                "host_tier_peer_fetches": self._ht_peer_fetches.value,
                "host_tier_preemptions": self._ht_preemptions.value,
                "host_tier_copy_faults": self._ht_copy_faults.value,
            })
        return out

    # -- multi-tenant LoRA adapters --------------------------------------
    def _require_multi_lora(self):
        if not self.multi_lora:
            raise DeepSpeedConfigError(
                'this engine has no adapter pool; enable the "adapters" '
                "config block to serve LoRA adapters"
            )

    def _shard_stacks(self, stacks):
        """Adapter stacks ``{target: (A [L, in, r], B [L, r, out])}`` cut
        to this model rank's shards, the adapter pool's layout
        (models/gpt2.py:adapter_pool_partition_specs; the qkv B per q|k|v
        column group); the stacks themselves in one process."""
        if self.mesh is None:
            return stacks
        mp, rank = self.mp_size, self.model_rank
        specs = adapter_pool_partition_specs(self.adapter_targets)
        out = {}
        for t, (a, b) in stacks.items():
            # a stack has no adapter-row dim (the pool's dim 1)
            dims = [tp_lib.model_dim(spec[:1] + spec[2:]) for spec in specs[t]]
            out[t] = tuple(
                tp_lib.shard_for_rank(f"{t}_lora_{ab}", x, d, mp, rank)
                for ab, x, d in zip("ab", (a, b), dims))
        return out

    def _check_adapter_rows(self, name, stacks):
        """Refuse adapter stacks that do not fit the pool rows."""
        for t, (a, b) in stacks.items():
            la, lb = self._adapter_pool[t]
            want = (
                (la.shape[0], *la.shape[2:]), (lb.shape[0], *lb.shape[2:]),
            )
            if (tuple(a.shape), tuple(b.shape)) != want:
                raise ValueError(
                    f"adapter {name!r} target {t}: shapes "
                    f"{tuple(a.shape)}/{tuple(b.shape)} do not fit the "
                    f"pool rows {want[0]}/{want[1]} (model/rank mismatch?)"
                )

    def _write_adapter_rows(self, idx, stacks):
        with torch.no_grad():
            for t, (a, b) in stacks.items():
                la, lb = self._adapter_pool[t]
                la[:, idx].copy_(a)
                lb[:, idx].copy_(b)

    def load_adapter(self, name, adapter_state=None, load_dir=None,
                     tag=None):
        """Install (or hot-reload) tenant adapter ``name`` into the device
        pool and return its pool row index.

        ``adapter_state`` is an adapter state dict: per-layer
        ``h.<i>.<target>_lora_a`` [in, r] / ``_lora_b`` [r, out] tensors
        (a fine-tune engine's :meth:`DeepSpeedEngine.adapter_state_dict`,
        or :func:`deepspeed_tpu_torch.convert.adapters_from_jax`).
        ``load_dir`` (with ``tag``, default ``latest``) is instead an
        adapter-only checkpoint committed by a fine-tune engine's
        ``save_checkpoint``, read through the verified load (manifest
        check, host-side parse, newest-valid fallback) and checked against
        this pool's rank, scale and targets through the checkpoint's
        ``client_state["adapters"]`` before any row is written. Loading past
        ``adapters.pool_slots`` evicts the least-recently-used IDLE
        adapter (parked in the host tier when the engine has one); a pool
        whose every adapter has live requests raises
        :class:`~deepspeed_tpu_torch.adapters.AdapterPoolFull`. The row is
        written in place under the engine lock, between decode steps."""
        self._require_multi_lora()
        self._require_leader()
        if (adapter_state is None) == (load_dir is None):
            raise ValueError(
                "pass exactly one of adapter_state (an adapter state dict "
                "of h.<i>.<target>_lora_a/_lora_b tensors) or load_dir (an "
                "adapter-only checkpoint directory)"
            )
        if load_dir is not None:
            adapter_state = self._adapter_checkpoint(load_dir, tag)
        stacks = {t: (a.detach().cpu(), b.detach().cpu()) for t, (a, b) in
                  adapter_layer_stacks(adapter_state,
                                       self.adapter_targets).items()}
        self._check_adapter_rows(name, self._shard_stacks(stacks))
        with self._device_lock:
            idx, evicted = self.adapter_registry.assign(name)
            if evicted is not None:
                # park the outgoing tenant's rows while they are still in
                # the pool (the write below overwrites row idx); a later
                # submit for the evicted name auto-loads from the tier
                self._spill_adapter_row(evicted, idx)
            # an explicit (re)load carries FRESH weights under a NEW
            # generation: a tier copy of the old weights is stale
            if self.host_tier is not None:
                self.host_tier.discard(f"adapter/{name}")
            self._adapter_generations[name] = (
                self.adapter_registry.generation_of(name)
            )
            self._run("adapter_rows", idx, stacks)
        self._adapter_loads.inc()
        if evicted is not None:
            self._adapter_evictions.inc()
            log_dist(
                f"adapter pool full: evicted idle adapter {evicted!r} "
                f"for {name!r} (row {idx})", ranks=[0],
            )
        self._adapter_occupancy.set(self.adapter_registry.used_slots)
        log_dist(
            f"loaded adapter {name!r} into pool row {idx} "
            f"({self.adapter_registry.used_slots}/"
            f"{self.adapter_pool_slots} slots)", ranks=[0],
        )
        return idx

    def _adapter_checkpoint(self, load_dir, tag):
        """The adapter state dict of an adapter-only checkpoint, its
        geometry checked against the pool (DeepSpeedConfigError)."""
        if self._adapter_template is None:
            # names only, from the served model's (whole) shapes; cached:
            # the targets never change between loads
            self._adapter_template = adapter_host_template(
                {n: torch.empty(shape, device="meta")
                 for n, shape in self._full_shapes.items()},
                self.adapter_rank, self.adapter_targets,
            )
        state, client_state, ckpt_tag = load_module_state(
            load_dir, self._adapter_template, tag=tag,
            resilience=self.resilience,
        )
        if state is None:
            raise RuntimeError(
                f"no loadable adapter checkpoint under {load_dir!r} "
                "(see the resilience/corruption_fallbacks counter)"
            )
        meta = (client_state or {}).get("adapters")
        if meta is not None:
            # alpha compares as the RESOLVED scale (alpha 0 => rank): a
            # scale mismatch would silently rescale every delta
            ckpt_scale = lora_scaling(
                meta.get("rank", self.adapter_rank), meta.get("alpha", 0.0))
            if (int(meta.get("rank", self.adapter_rank)) != self.adapter_rank
                    or tuple(meta.get("targets", self.adapter_targets))
                    != tuple(self.adapter_targets)
                    or ckpt_scale != self.adapter_scale):
                raise DeepSpeedConfigError(
                    f"adapter checkpoint {ckpt_tag!r} was fine-tuned with "
                    f"rank={meta.get('rank')}/alpha={meta.get('alpha')}/"
                    f"targets={meta.get('targets')} but this pool serves "
                    f"rank={self.adapter_rank}/scale={self.adapter_scale}/"
                    f"targets={list(self.adapter_targets)}"
                )
        return state

    def unload_adapter(self, name):
        """Explicitly evict ``name`` (refused while live requests decode
        against it); frees its pool row for the next load. An explicit
        unload is intentional removal: any host-tier copy drops too, so
        the tenant cannot silently come back through auto-load."""
        self._require_multi_lora()
        self._require_leader()
        idx = self.adapter_registry.remove(name)
        self._adapter_generations.pop(name, None)
        if self.host_tier is not None:
            self.host_tier.discard(f"adapter/{name}")
        self._adapter_evictions.inc()
        self._adapter_occupancy.set(self.adapter_registry.used_slots)
        return idx

    def _spill_adapter_row(self, name, idx):
        """Park an evicted adapter's pool rows (still at row ``idx``) in
        the host tier, keyed ``adapter/<name>`` with its load generation —
        the auto-load restore re-installs the SAME weights under the SAME
        generation, so the tenant's salted prefix pages stay valid. Never
        raises (a chaos fault drops the park; the adapter is then simply
        gone, as without the tier)."""
        if self.host_tier is None:
            return
        mode = self._ht_fault_mode()
        if mode is not None and mode != "garble":
            logger.warning(
                "host-tier spill of adapter %r skipped (injected "
                "host_tier.copy fault)", name,
            )
            return
        targets = sorted(self._adapter_pool)
        self._tell("spill_adapter", name, idx)
        self._park(f"adapter/{name}")
        stored = self.host_tier.put(
            f"adapter/{name}",
            self._adapter_rows_to_host(idx),
            meta={
                "kind": "adapter",
                "generation": self._adapter_generations.get(name),
                "targets": targets,
            },
            origin=self._tier_client_id,
            corrupt=(mode == "garble"),
        )
        if stored:
            self._ht_spills.inc()

    def _adapter_rows_to_host(self, idx):
        """Host copies of every target's A and B rows at pool row ``idx``
        (the targets in sorted order)."""
        rows = []
        for t in sorted(self._adapter_pool):
            a, b = self._adapter_pool[t]
            rows.extend((a[:, idx], b[:, idx]))
        return tuple(self._to_host(rows))

    def _auto_load_adapter_from_tier(self, name):
        """Re-install a spilled adapter from the host tier. Returns
        "loaded" (now resident, original generation restored),
        "deferred" (the tier holds it but every pool slot is pinned by
        live requests — retry when traffic drains, exactly like a KV page
        shortfall), or False (not in the tier / promotion failed — the
        adapter is genuinely unavailable)."""
        if not self.multi_lora or self.host_tier is None:
            return False
        key = f"adapter/{name}"
        if not self.host_tier.contains(key):
            return False
        if self._ht_fault_mode() is not None:
            logger.warning(
                "host-tier auto-load of adapter %r skipped (injected "
                "host_tier.copy fault)", name,
            )
            return False
        got = self.host_tier.fetch(key, requester=self._tier_client_id)
        if got is None:
            return False
        placed, meta, origin = got
        arrays = _landed(placed)
        targets = meta.get("targets") or []
        if sorted(self._adapter_pool) != list(targets) or len(arrays) != (
            2 * len(targets)
        ):
            return False
        stacks = {
            t: (arrays[2 * i], arrays[2 * i + 1])
            for i, t in enumerate(targets)
        }
        try:
            self._check_adapter_rows(name, stacks)
        except ValueError:
            return False  # a peer with a different pool geometry
        with self._device_lock:
            try:
                idx, evicted = self.adapter_registry.assign(
                    name, generation=meta.get("generation")
                )
            except AdapterPoolFull:
                return "deferred"
            if evicted is not None:
                self._spill_adapter_row(evicted, idx)
                self._adapter_evictions.inc()
            self._adapter_generations[name] = (
                self.adapter_registry.generation_of(name)
            )
            self._tell("restore_adapter", name, idx)
            self._write_adapter_rows(idx, stacks)
        # the host copy stays: it equals the rows just installed bit for
        # bit, and peers in the share group warm from it
        self._adapter_loads.inc()
        self._ht_promotions.inc()
        if origin is not None and origin != self._tier_client_id:
            self._ht_peer_fetches.inc()
        self._adapter_occupancy.set(self.adapter_registry.used_slots)
        log_dist(
            f"auto-loaded adapter {name!r} from the host tier into pool "
            f"row {idx} (generation "
            f"{self.adapter_registry.generation_of(name)} restored)",
            ranks=[0],
        )
        return "loaded"

    def resolve_adapter(self, name):
        """Submit-time validation + per-adapter accounting: returns the
        adapter's current pool row. A known-but-not-resident name (its
        rows parked in the host tier) auto-loads here — or, when every
        pool slot is pinned, is accepted anyway (returns None) and the
        slot join retries the auto-load. Raises
        :class:`~deepspeed_tpu_torch.adapters.AdapterUnavailable` (a
        ValueError) for a name this engine cannot serve."""
        self._require_multi_lora()
        try:
            idx = self.adapter_registry.index_of(name)
        except KeyError:
            state = self._auto_load_adapter_from_tier(name)
            if state == "loaded":
                idx = self.adapter_registry.index_of(name)
            elif state == "deferred":
                self._adapter_requests.inc()
                self.metrics.counter(f"adapters/requests/{name}").inc()
                return None
            else:
                raise AdapterUnavailable(
                    f"adapter {name!r} is not loaded (loaded: "
                    f"{self.adapter_registry.loaded}); call "
                    "engine.load_adapter() first"
                ) from None
        self.adapter_registry.count_request(name)
        self._adapter_requests.inc()
        self.metrics.counter(f"adapters/requests/{name}").inc()
        return idx

    def assign_slot_adapter(self, slot, name):
        """Slot-join hook (scheduler._admit): pin ``name`` for the slot's
        lifetime and point the slot's adapter id at its pool row. Returns
        False when the adapter was evicted between submit and join — the
        scheduler fail-finishes that request instead of serving it the
        identity (or another tenant's) weights. With the host tier, an
        evicted-but-parked adapter auto-loads here instead; one that
        cannot land because every pool slot is pinned raises
        :class:`~deepspeed_tpu_torch.adapters.AdapterPoolFull`, which the
        scheduler turns into a deferral."""
        if not self.multi_lora:
            return True
        if name is None:
            # clear any stale name too: the slot's prefix-cache salt must
            # be the BASE salt, not a previous occupant's adapter
            self._slot_adapter_names.pop(slot, None)
            self._slot_adapters[slot] = 0
            return True
        try:
            idx = self.adapter_registry.acquire(name)
        except KeyError:
            state = self._auto_load_adapter_from_tier(name)
            if state == "loaded":
                idx = self.adapter_registry.acquire(name)
            elif state == "deferred":
                raise AdapterPoolFull(self.adapter_pool_slots) from None
            else:
                return False
        self._slot_adapters[slot] = idx
        self._slot_adapter_names[slot] = name
        return True

    def _adapter_salt(self, slot):
        """Prefix-cache hash salt for the slot's adapter: cached k/v are
        a function of the weights that wrote them, so pages only share
        within (adapter name, load generation) — base-model pages salt
        None, and a reloaded adapter's fresh weights never match pages
        its old weights produced."""
        name = self._slot_adapter_names.get(slot)
        if name is None:
            return None
        return f"{name}@{self.adapter_registry.generation_of(name)}"

    def adapter_snapshot(self):
        """Adapter-pool state for ``load_snapshot()``."""
        if not self.multi_lora:
            return {}
        reg = self.adapter_registry
        return {
            "adapters_loaded": reg.loaded,
            "adapter_pool_slots": self.adapter_pool_slots,
            "adapter_pool_used": reg.used_slots,
            "adapter_loads": reg.loads,
            "adapter_evictions": reg.evictions,
            "adapter_requests": dict(reg.requests),
        }

    # -- device hooks (called by the scheduler) -------------------------
    def prefill_request(self, slot, prompt_tokens, temperature):
        """Run one request's prefill into ``slot``: cache rows 0..P-1
        written, first token sampled from the prompt's last logit row. A
        cached-prefix hit prefills only the unique suffix. The prompt
        prefills THROUGH the slot's adapter, so the rows seeding decode
        carry the adapted k/v; a speculative engine also prefills the
        draft's own cache. Returns the first generated token (a host
        int)."""
        with self._device_lock:
            return self._prefill_locked(slot, prompt_tokens, temperature)

    def _prefill_locked(self, slot, prompt_tokens, temperature):
        plen = len(prompt_tokens)
        prefix_len = self._slot_prefix_len.get(slot, 0) if self.paged else 0
        if prefix_len > 0:
            first = self._prefill_suffix(
                slot, prompt_tokens, prefix_len, temperature
            )
        else:
            padded = np.zeros((1, self.prefill_len), np.int32)
            padded[0, :plen] = prompt_tokens
            block_ids = offsets = None
            if self.paged:
                # position j -> (its page, its offset); padding rows past
                # the prompt carry the null page
                block_ids = np.zeros(self.prefill_len, np.int32)
                block_ids[:plen] = np.repeat(
                    self._slot_blocks[slot], self.kv_block_size
                )[:plen]
                offsets = (
                    np.arange(self.prefill_len, dtype=np.int32)
                    % self.kv_block_size
                )
            logits = self._run("prefill", padded, slot, block_ids, offsets,
                               self._slot_ids(slice(slot, slot + 1)))
            first = self._sample(
                logits[:, plen - 1, :], np.full(1, temperature, np.float32)
            )
            first = int(first[0])
        if self.speculative:
            # the draft mirrors the slot: a full prompt prefill into its
            # own contiguous cache (a target-side prefix hit says nothing
            # about the draft's cache)
            dpad = np.zeros((1, self.prefill_len), np.int32)
            dpad[0, :plen] = prompt_tokens
            self._run("draft_prefill", dpad, slot)
            # index lengths-1 == the last PROMPT token (already cached by
            # the draft prefill; the sync rewrite is value-identical)
            self._spec_prev_tokens[slot] = int(prompt_tokens[-1])
        if self.paged and self.prefix_cache_enabled and not self._brownout:
            # publish this prompt's full pages so later requests share
            # them (no-op for pages already in the registry). Skipped
            # under fleet brownout (set_brownout): a prefix miss's
            # registration (hashing, registry churn, pages parked
            # unfreeable in the LRU) is load the degraded window cannot
            # afford; hits still serve suffix-only.
            self.block_pool.register_prefix(
                prompt_tokens, self._slot_blocks[slot],
                hashes=self._slot_hashes.get(slot),
            )
        if self.tracer.enabled:
            attrs = {
                "prompt_tokens": plen,
                "prefix_hit": prefix_len > 0,
                "prefix_len": int(prefix_len),
            }
            if prefix_len > 0:
                attrs["suffix_bucket"] = self._suffix_bucket(
                    plen - prefix_len, prefix_len
                )
            adapter = self._slot_adapter_names.get(slot)
            if adapter is not None:
                attrs["adapter"] = adapter
            self._slot_trace_attrs[slot] = attrs
        self._lengths[slot] = plen
        self._last_tokens[slot] = first
        self._temps[slot] = temperature
        return first

    def prefill_trace_attrs(self, slot):
        """Scheduler hook: the span attrs captured by the slot's latest
        prefill (prefix hit or cold, suffix bucket, adapter name), the
        facts only the engine knows."""
        return self._slot_trace_attrs.pop(slot, {})

    def set_brownout(self, on):
        """Fleet brownout toggle (docs/serving.md "Brownout"): while on,
        cold prefills and finished decodes skip prefix REGISTRATION (the
        prefix-miss speculative work); hits keep serving suffix-only. A
        mode flag, reversible at once."""
        self._brownout = bool(on)

    def use_tracer(self, tracer):
        """Adopt a caller-owned tracer (the fleet router injects its own
        into in-process replicas, so scheduler spans land in the same
        trace file as the router's root spans). The tracer stays its
        owner's: :meth:`close` never closes it."""
        self.tracer = tracer
        self.scheduler._tracer = tracer

    def _suffix_bucket(self, suffix_len, prefix_len):
        """Smallest suffix width that holds the suffix and keeps every
        PADDED row's position inside max_seq_len. None when no bucket
        qualifies (the caller falls back to the cold full prefill)."""
        for b in self._suffix_buckets:
            if b >= suffix_len and prefix_len + b <= self.max_seq_len:
                return b
        return None

    def _prefill_suffix(self, slot, prompt_tokens, prefix_len, temperature):
        """Prefix-cache hit: prefill ``prompt[prefix_len:]`` only, padded
        to the smallest suffix bucket, attending over the shared prefix
        pages."""
        suffix = prompt_tokens[prefix_len:]
        bucket = self._suffix_bucket(len(suffix), prefix_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, : len(suffix)] = suffix
        logits = self._run("suffix", padded, int(prefix_len),
                           self._block_tables[slot:slot + 1].copy(),
                           self._slot_ids(slice(slot, slot + 1)))
        first = self._sample(
            logits[:, len(suffix) - 1, :], np.full(1, temperature, np.float32)
        )
        return int(first[0])

    def reset_decode_state(self):
        """Rebuild the decode-side state (KV cache or page pool, the
        draft's cache, slot bookkeeping, block tables) from scratch; the
        weights are untouched — the driver auto-restart path after a
        decode crash."""
        with self._device_lock:
            self._run("reset")
        log_dist(
            "inference decode state reset (driver restart)", ranks=[0],
        )

    def _op_reset(self):
        self._cache = self._init_cache()
        if self.paged:
            self.block_pool = self._new_block_pool()
            self._reclaimed_synced = 0
            self._block_tables[:] = NULL_BLOCK
            self._slot_blocks.clear()
            self._slot_prefix_len.clear()
            self._slot_hashes.clear()
            self._sync_pool_metrics()
        if self.speculative:
            self._draft_cache = self._init_draft_cache()
            self._spec_prev_tokens[:] = 0
        self._lengths[:] = 0
        self._last_tokens[:] = 0
        if self.multi_lora:
            # adapter WEIGHTS survive a decode crash; only the slot pins
            # die with the fail-finished in-flight requests, which the
            # scheduler's crash recovery already released via release_slot
            self._slot_adapters[:] = 0
            self._slot_adapter_names.clear()

    def decode_tokens(self, active_slots):
        """One fixed-shape decode step over ALL slots; commits length /
        last-token bookkeeping for ``active_slots`` and returns their
        sampled tokens as host ints (same order). Each slot decodes
        through its adapter (per-slot ids, row 0 for the base model). On
        a SPECULATIVE engine each entry is instead a LIST of 1..k+1
        committed tokens (the accepted draft prefix plus the target's
        correction), which the scheduler commits in order."""
        # fault site: a decode-driver crash, which the scheduler's driver
        # auto-restart absorbs
        self.resilience.faults.maybe_raise("decode.step")
        if self.speculative:
            return self._decode_tokens_spec(active_slots)
        with self._device_lock:
            logits = self._run(
                "decode", self._last_tokens.copy(), self._lengths.copy(),
                self._block_tables.copy() if self.paged else None,
                self._slot_ids(slice(None)))
            next_tokens = self._sample(logits, self._temps).cpu().numpy()
        out = []
        for slot in active_slots:
            token = int(next_tokens[slot])
            self._lengths[slot] += 1
            self._last_tokens[slot] = token
            out.append(token)
        return out

    def _draft_propose(self, prev_tokens, tokens, positions):
        """One sync step + k greedy draft steps: proposals [slots, k], on
        the device, with no host sync between the steps.

        The SYNC step re-feeds the token at index ``positions - 1`` (the
        burst's second-to-last commit): after a FULLY accepted cycle the
        target committed k+1 tokens but the draft's steps wrote only k
        cache rows, leaving the last accepted proposal's row a hole the
        next steps would attend as garbage (the draft's acceptance falls
        to about 0.67 even with draft == target). For hole-free slots
        the rewrite recomputes the same k/v from the same cache prefix."""
        vocab = self._sampling_statics["vocab_size"]
        gpt2_decode_step(self.draft, prev_tokens,
                         torch.clamp(positions - 1, min=0), self._draft_cache)
        props = []
        for _ in range(self.spec_k):
            logits, _ = gpt2_decode_step(
                self.draft, tokens, positions, self._draft_cache)
            tokens = torch.argmax(
                mask_padded_vocab(logits.float(), vocab), dim=-1
            ).to(torch.int32)
            props.append(tokens)
            positions = positions + 1
        return torch.stack(props, dim=1)

    def _op_spec(self, host):
        """One speculative cycle's device work from its host inputs
        ``host`` (previous, last tokens, lengths, block tables and slot
        adapter ids, concatenated): the draft's proposals (the leader's,
        over a model axis) and the target's verify. Returns ``[slots,
        2k+1]`` on the host: the proposals, then the greedy row."""
        n = self.num_slots
        dev = self._to_device(host)
        prev, last, lengths = dev[:n], dev[n:2 * n], dev[2 * n:3 * n]
        end = 3 * n + self._block_tables.size
        tables = dev[3 * n:end].reshape(self._block_tables.shape)
        lora = self._lora_ids(dev[end:] if self.multi_lora else None)
        props = self._draft_propose(prev, last, lengths)
        if self._ctrl_group is not None:
            # every rank verifies the leader's proposals (the drafts are
            # the same arithmetic on the same inputs; this makes it so)
            box = [props.cpu() if self.is_leader else None]
            torch.distributed.broadcast_object_list(
                box, src=self._ctrl_src, group=self._ctrl_group)
            props = box[0].to(self.device)
        self._spec_t1 = time.monotonic()
        greedy = self._spec_verify(
            torch.cat([last[:, None], props], dim=1), lengths, tables, lora)
        return torch.cat([props, greedy], dim=1).cpu().numpy()

    def _spec_verify(self, verify_tokens, start, tables, lora):
        """ONE fixed-shape batched target step over the k+1 verify tokens
        [last, d_1..d_k] per slot: suffix-prefill arithmetic against the
        paged cache (k/v written through the block tables, rows past the
        sequence cap into the null page), greedy-argmaxed per row. Row i
        is the target's own next token after consuming verify token i."""
        logits, _ = gpt2_prefill_suffix(
            self.model, verify_tokens, start, self._cache, tables, **lora)
        return torch.argmax(
            mask_padded_vocab(logits.float(),
                              self._sampling_statics["vocab_size"]),
            dim=-1,
        ).to(torch.int32)

    def _decode_tokens_spec(self, active_slots):
        """One speculative decode cycle: the draft proposes ``k`` greedy
        tokens per slot, the target verifies all of them in ONE batched
        step against the paged cache, and the accepted prefix plus the
        target's correction token commit — every committed token is the
        target's own argmax, so greedy output equals the sequential
        path's by construction. Returns one token LIST per active slot.

        The cycle's inputs go up in one copy before any launch, and the
        proposals and the verify result come down in one copy: that copy
        is the cycle's only wait on the device. Rejected proposals' k/v
        sit at positions BEYOND the committed length, so the position
        mask hides them until a later cycle overwrites those rows."""
        k = self.spec_k
        t0 = time.monotonic()
        with self._device_lock:
            host = np.concatenate([
                self._spec_prev_tokens, self._last_tokens, self._lengths,
                self._block_tables.reshape(-1),
                self._slot_adapters if self.multi_lora
                else np.zeros(0, np.int32),
            ]).astype(np.int32)
            both = self._run("spec", host)
            t1 = self._spec_t1
        props, greedy = both[:, :k], both[:, k:]
        t2 = time.monotonic()
        out = []
        proposed = accepted = committed = 0
        for slot in active_slots:
            g, pr = greedy[slot], props[slot]
            j = 0
            while j < k and pr[j] == g[j]:
                j += 1
            # d_1..d_j matched the target's own choices; g[j] is the
            # target's token at the first divergence (the BONUS token
            # when everything matched)
            toks = [int(t) for t in pr[:j]] + [int(g[j])]
            self._lengths[slot] += len(toks)
            # token at the new index lengths-1: the burst's second-to-last
            # commit, or the previous last for a 1-token burst — what the
            # next propose's sync step re-feeds
            self._spec_prev_tokens[slot] = (
                toks[-2] if len(toks) >= 2 else self._last_tokens[slot]
            )
            self._last_tokens[slot] = toks[-1]
            proposed += k
            accepted += j
            committed += len(toks)
            out.append(toks)
        t3 = time.monotonic()
        self._spec_proposed.inc(proposed)
        self._spec_accepted.inc(accepted)
        total = self._spec_proposed.value
        self._spec_rate.set(
            self._spec_accepted.value / total if total else 0.0
        )
        # phase stats for the scheduler's sched.spec_* spans (host clock:
        # the draft's span ends when its launches are queued, the verify
        # span at the cycle's one device wait)
        self.spec_step_stats = {
            "draft_t0": t0, "draft_t1": t1,
            "verify_t0": t1, "verify_t1": t2,
            "commit_t0": t2, "commit_t1": t3,
            "proposed": proposed, "accepted": accepted,
            "committed": committed,
        }
        return out

    # -- serving API ----------------------------------------------------
    def submit(self, prompt_tokens, **kwargs):
        """Front-door submission; see
        :meth:`ContinuousBatchingScheduler.submit`."""
        self._require_leader()
        return self.scheduler.submit(prompt_tokens, **kwargs)

    def load_snapshot(self):
        """Router-facing load/health view; see
        :meth:`ContinuousBatchingScheduler.load_snapshot`."""
        return self.scheduler.load_snapshot()

    def generate(self, prompts, max_new_tokens=32, temperature=None,
                 eos_token_id=None, adapter=None):
        """Synchronous batch generation: submit every prompt (token-id
        lists), drive the scheduler until all finish, return the
        generated token-id lists in prompt order. ``adapter`` names a
        loaded LoRA adapter applied to every prompt (None = base
        model)."""
        self._require_leader()
        requests = []
        try:
            for p in prompts:
                requests.append(self.submit(
                    p, max_new_tokens=max_new_tokens,
                    temperature=temperature, eos_token_id=eos_token_id,
                    adapter=adapter,
                ))
        except Exception:
            # a rejected/invalid later prompt must not orphan the earlier
            # submissions in the queue
            for r in requests:
                r.cancel()
            raise
        if not self.scheduler.driving:
            self.scheduler.run_until_idle()
        results = [r.result() for r in requests]
        for r in requests:
            if r.finish_reason in ("cancelled", "error"):
                raise RuntimeError(
                    f"generation {r.finish_reason} after {len(r.tokens)} "
                    f"of up to {r.max_new_tokens} tokens (scheduler shut "
                    "down, or its decode driver crashed past the restart "
                    "budget)"
                )
        return results

    def serve_forever(self):
        """Rank 0 (or the only rank): the scheduler's driver loop; a
        follower: :meth:`follow`, until rank 0 closes the engine."""
        if not self.is_leader:
            return self.follow()
        return self.scheduler.serve_forever()

    def close(self):
        """Stop the scheduler and release the engine; over a mesh the
        leader's close also ends the followers' loops (a follower
        closes when its loop ends)."""
        if not self.is_leader:
            return
        self.scheduler.shutdown()
        with self._device_lock:
            self._tell("close")
        self._close_local()

    def _close_local(self):
        self._store = {}
        # give the KV pool back now: the engine and its scheduler refer to
        # each other, so without this the pool would wait for the cycle
        # collector, and a fleet's restart would build the next engine's
        # pool beside it
        self._cache = None
        self._draft_cache = None
        if self.host_tier is not None:
            # drop this engine's share-group reference; the last engine
            # out closes the tier's worker and retires the group
            self.host_tier.release()
            self.host_tier = None
        if self.telemetry.enabled:
            self.telemetry.export()
            self.telemetry.close()


def init_inference(
    model=None,
    config=None,
    model_parameters=None,
    mesh=None,
    rng_seed=0,
    device=None,
    draft_model=None,
    draft_parameters=None,
    param_specs=None,
):
    """Build a serving engine around ``model`` (a
    :class:`~deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel`).

    ``config`` is a dict or JSON path whose ``"inference"`` block sizes
    the engine (docs/inference.md): the contiguous cache
    (``kv_block_size: 0``, the default) or the paged one, the
    ``host_tier`` block and the ``speculative`` block among them.
    ``model_parameters`` is an optional state dict (e.g. from
    :func:`deepspeed_tpu_torch.convert.params_from_jax`) served in place
    of the model's own weights. ``draft_model`` (a smaller GPT-2 with the
    same vocabulary) and ``draft_parameters`` (its state dict, default
    its own weights) supply the draft of speculative decoding;
    ``speculative.draft_checkpoint`` replaces the draft's weights through
    the verified load. ``device`` defaults to ``"cuda"`` and raises
    without a GPU; ``device="cpu"`` runs the kernels' plain PyTorch
    versions. ``mesh`` (a ``parallel.ProcessMesh``) or the config's
    ``mesh`` block with a ``model_parallel_size`` or
    ``data_parallel_size`` above 1 serves over the mesh, every rank of
    the world calling this with the whole model: ``param_specs`` (default
    GPT-2's ``partition_specs``) cut the weights over the model axis, and
    every other axis replicates the engine, as the JAX engine replicates
    over its data axis; global rank 0 takes the requests and the others
    run ``serve_forever()``, which follows rank 0's plans until it closes
    the engine (see the module docstring). Returns an
    :class:`InferenceEngine`."""
    return InferenceEngine(
        model=model,
        config=config,
        model_parameters=model_parameters,
        mesh=mesh,
        rng_seed=rng_seed,
        device=device,
        draft_model=draft_model,
        draft_parameters=draft_parameters,
        param_specs=param_specs,
    )
