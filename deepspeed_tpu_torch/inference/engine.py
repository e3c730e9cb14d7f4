"""InferenceEngine: the serving façade behind ``init_inference``.

Port of deepspeed_tpu/inference/engine.py for the PAGED cache. It glues
three layers together:

  params     — the caller's GPT-2 weights, copied into the engine's own
               model in the serving dtype on the serving device (the
               caller's module is left as it was).
  decode     — prefill / decode-and-sample over inference/decode.py and
               inference/sampling.py; the page pool is updated in place.
  scheduling — the ContinuousBatchingScheduler (scheduler.py, unchanged
               from the JAX package) owning the bounded admission queue
               and the slot table; ``generate`` is the synchronous
               convenience over it, ``submit`` + ``serve_forever`` the
               server mode.

Ported: the paged KV cache with the cross-request prefix cache, fused
decode attention (the paged decode kernel), greedy and sampled decoding,
and multi-LoRA serving (the ``adapters`` block): a device adapter pool
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
Not yet ported, and refused with ``DeepSpeedConfigError``: the contiguous
cache (``kv_block_size: 0``), the host tier, speculative decoding, a
device mesh, and serving from a checkpoint (``inference.checkpoint`` and
``load_adapter(load_dir=...)``). The fleet's hooks (tracer injection,
brownout) come with the fleet.

Adapter pool rows are written IN PLACE (the JAX engine swaps in a new
pool between steps). ``load_adapter`` runs on a caller's thread while
the scheduler drives on its own, so one engine lock serializes the row
write with prefill and decode: a reload lands between two decode steps,
never between two layers of one.
"""

import dataclasses
import threading

import numpy as np
import torch

from ..config import constants as C
from ..config.config import DeepSpeedConfig, DeepSpeedConfigError
from ..config.config import not_ported as _not_ported
from ..config.config_utils import load_config_json
from ..adapters.lora import adapter_layer_stacks, split_lora_params
from ..adapters.pool import AdapterPool, AdapterUnavailable
from ..models.gpt2 import GPT2LMHeadModel
from ..ops.decode_attention import SGMV_MAX_RANK
from ..ops.head_dims import check_head_dim, model_head_dim
from ..ops.transformer import lora_scaling, resolve_lora_targets
from ..telemetry.manager import (
    build_telemetry,
    register_adapter_metrics,
    register_inference_metrics,
)
from ..telemetry.registry import MetricsRegistry
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from .decode import (
    gpt2_decode_step_paged,
    gpt2_prefill,
    gpt2_prefill_suffix,
    init_adapter_pool,
    init_kv_pool,
    write_prefill_to_pool,
)
from .paging import NULL_BLOCK, BlockPool, PoolExhausted, hash_full_blocks
from .sampling import sample_tokens
from .scheduler import ContinuousBatchingScheduler, RequestRejected  # noqa: F401  (re-exported)


class InferenceEngine:
    def __init__(
        self,
        model=None,
        config=None,
        model_parameters=None,
        mesh=None,
        rng_seed=0,
        device=None,
    ):
        mcfg = getattr(model, "config", None)
        if mcfg is None or not all(
            hasattr(mcfg, a) for a in ("n_layer", "n_head", "n_embd",
                                       "n_positions", "layer_config")
        ):
            raise DeepSpeedConfigError(
                "init_inference serves the GPT-2 family: pass a "
                "GPT2LMHeadModel (a module whose .config carries "
                "n_layer/n_head/n_embd/n_positions)"
            )
        self.model_config = mcfg

        # ---- config ---------------------------------------------------
        if config is None:
            raw = {}
        elif isinstance(config, dict):
            raw = dict(config)
        else:  # JSON path
            raw = load_config_json(config)
        if mesh is not None or raw.get(C.MESH):
            raise _not_ported("serving over a device mesh")
        self.config = DeepSpeedConfig(None, param_dict=raw)
        cfg = self.config
        if cfg.inference_speculative_enabled:
            raise _not_ported("speculative decoding (inference.speculative)")
        if cfg.inference_host_tier_enabled:
            raise _not_ported("the host-memory spill tier (inference.host_tier)")
        if cfg.inference_checkpoint_load_dir:
            raise _not_ported("serving from a checkpoint (inference.checkpoint)")
        if int(cfg.inference_kv_block_size) == 0:
            raise _not_ported(
                "the contiguous KV cache (inference.kv_block_size: 0); set "
                "kv_block_size > 0 for the paged cache"
            )
        # what the card's kernels cannot take is refused here, not mid-step
        check_head_dim(model_head_dim(mcfg), mcfg.n_positions, device,
                       fused_decode=bool(cfg.inference_fused_decode))
        self.device = resolve_device(device)

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
        self.paged = True
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
            # power-of-two ladder from one page up to the prefill window
            buckets, b = [], self.kv_block_size
            while b < self.prefill_len:
                buckets.append(b)
                b *= 2
            buckets.append(self.prefill_len)
        self._suffix_buckets = sorted(
            {min(int(b), self.prefill_len) for b in buckets}
        )
        self.fused_decode = bool(cfg.inference_fused_decode)

        # ---- params ---------------------------------------------------
        state = (
            model.state_dict() if model_parameters is None
            else model_parameters
        )

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

        # ---- telemetry + metrics --------------------------------------
        self.telemetry = build_telemetry(
            cfg, rank=0, n_params=sum(
                int(np.prod(t.shape)) for t in state.values()),
            device=self.device,
        )
        registry = (
            self.telemetry.registry
            if self.telemetry.enabled else MetricsRegistry()
        )
        self.metrics = register_inference_metrics(registry)
        # request tracer: the telemetry.tracing block's, or the no-op one
        self.tracer = self.telemetry.tracer
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

        # ---- page pool + host-side allocator --------------------------
        self.block_pool = BlockPool(self.kv_pool_blocks, self.kv_block_size)
        self._block_tables = np.zeros(
            (self.num_slots, self.blocks_per_slot), np.int32
        )
        self._slot_blocks = {}  # slot -> this request's page ids
        self._slot_prefix_len = {}  # slot -> cached-prefix tokens
        self._slot_hashes = {}  # slot -> prompt's full-page hash chain
        self._cache = self._init_cache()
        # held around prefill, decode and adapter-pool row writes
        self._device_lock = threading.RLock()

        # ---- device adapter pool + host registry ----------------------
        # {target: (A [L, n+1, in, r], B [L, n+1, r, out])}, row 0 the
        # permanent identity; the AdapterPool owns name -> row, per-slot
        # refcounts and idle-LRU eviction
        self._slot_adapter_names = {}  # slot -> adapter name
        if self.multi_lora:
            self._adapter_pool = init_adapter_pool(
                mcfg, self.adapter_pool_slots, self.adapter_rank,
                self.adapter_targets, self.compute_dtype, self.device,
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
            f"paged KV cache ({self.kv_pool_blocks} pages x "
            f"{self.kv_block_size} tokens, prefix cache "
            f"{'on' if self.prefix_cache_enabled else 'off'}, fused decode "
            f"{'on' if self.fused_decode else 'off'})"
            + (
                f", LoRA pool of {self.adapter_pool_slots} adapters at rank "
                f"{self.adapter_rank} on {list(self.adapter_targets)}"
                if self.multi_lora else ""
            ),
            ranks=[0],
        )

    def _init_cache(self):
        return init_kv_pool(
            self.model_config, self.kv_pool_blocks, self.kv_block_size,
            self.compute_dtype, self.device,
        )

    def _to_device(self, array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

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

    def kv_blocks_available(self):
        """Pages an admission could obtain right now (free + evictable
        cached): the REJECT_CAPACITY gate's denominator."""
        return self.block_pool.available_blocks

    def kv_pool_total_blocks(self):
        return self.block_pool.num_blocks

    def reserve_request(self, slot, prompt_tokens, max_new_tokens):
        """Slot-join page allocation: look up the longest cached prefix
        (acquiring shared references on its pages), then allocate private
        pages for everything else this request may write. Raises
        :class:`paging.PoolExhausted` — the scheduler defers the request
        — with no pages held. Returns the cached prefix length in tokens
        (0 = cold)."""
        plen = len(prompt_tokens)
        needed = self.kv_blocks_needed(plen, max_new_tokens)
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
        if prefix_len and self._suffix_bucket(
            plen - prefix_len, prefix_len
        ) is None:
            # no suffix width fits this (suffix, prefix) pair: fall back
            # to the always-correct cold full prefill
            self.block_pool.release(shared)
            prefix_len, shared = 0, []
        try:
            private = self.block_pool.alloc(needed - len(shared))
        except PoolExhausted:
            if shared:
                self.block_pool.release(shared)
            raise
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

    def _register_decode_pages(self, slot, final_tokens):
        """Extend the prefix registry to the full pages this request
        completed during decode, so generated continuations become
        shareable prefixes. Runs before the slot's pages release and
        before its adapter pin drops (the chain salt needs the adapter
        identity)."""
        if not self.prefix_cache_enabled:
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
        rows, never another tenant's."""
        if final_tokens is not None:
            self._register_decode_pages(slot, final_tokens)
        if self.multi_lora:
            name = self._slot_adapter_names.pop(slot, None)
            if name is not None:
                self.adapter_registry.release(name)
            self._slot_adapters[slot] = 0
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

    def kv_snapshot(self):
        """Pool/prefix-cache state for ``load_snapshot()``."""
        hits = self._prefix_hits.value
        misses = self._prefix_misses.value
        return {
            "kv_blocks_total": self.block_pool.num_blocks,
            "kv_blocks_free": self.block_pool.available_blocks,
            "kv_blocks_used": self.block_pool.used_blocks,
            "prefix_hits": hits,
            "prefix_misses": misses,
            "prefix_hit_rate": (
                hits / (hits + misses) if hits + misses else 0.0
            ),
        }

    # -- multi-tenant LoRA adapters --------------------------------------
    def _require_multi_lora(self):
        if not self.multi_lora:
            raise DeepSpeedConfigError(
                'this engine has no adapter pool; enable the "adapters" '
                "config block to serve LoRA adapters"
            )

    def load_adapter(self, name, adapter_state=None, load_dir=None,
                     tag=None):
        """Install (or hot-reload) tenant adapter ``name`` into the device
        pool and return its pool row index.

        ``adapter_state`` is an adapter state dict: per-layer
        ``h.<i>.<target>_lora_a`` [in, r] / ``_lora_b`` [r, out] tensors
        (a fine-tune engine's :meth:`DeepSpeedEngine.adapter_state_dict`,
        or :func:`deepspeed_tpu_torch.convert.adapters_from_jax`).
        ``load_dir`` (adapter checkpoints) is not ported yet. Loading past
        ``adapters.pool_slots`` evicts the least-recently-used IDLE
        adapter; a pool whose every adapter has live requests raises
        :class:`~deepspeed_tpu_torch.adapters.AdapterPoolFull`. The row is
        written in place under the engine lock, between decode steps."""
        self._require_multi_lora()
        if load_dir is not None or tag is not None:
            raise _not_ported(
                "load_adapter(load_dir=...): adapter checkpoints"
            )
        if adapter_state is None:
            raise ValueError(
                "pass adapter_state (an adapter state dict of "
                "h.<i>.<target>_lora_a/_lora_b tensors)"
            )
        stacks = adapter_layer_stacks(adapter_state, self.adapter_targets)
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
        with self._device_lock:
            idx, evicted = self.adapter_registry.assign(name)
            with torch.no_grad():
                for t, (a, b) in stacks.items():
                    la, lb = self._adapter_pool[t]
                    la[:, idx].copy_(a)
                    lb[:, idx].copy_(b)
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

    def unload_adapter(self, name):
        """Explicitly evict ``name`` (refused while live requests decode
        against it); frees its pool row for the next load."""
        self._require_multi_lora()
        idx = self.adapter_registry.remove(name)
        self._adapter_evictions.inc()
        self._adapter_occupancy.set(self.adapter_registry.used_slots)
        return idx

    def resolve_adapter(self, name):
        """Submit-time validation + per-adapter accounting: returns the
        adapter's current pool row. Raises
        :class:`~deepspeed_tpu_torch.adapters.AdapterUnavailable` (a
        ValueError) for a name that is not loaded."""
        self._require_multi_lora()
        try:
            idx = self.adapter_registry.index_of(name)
        except KeyError:
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
        identity (or another tenant's) weights."""
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

    def _lora_kwargs(self, slots):
        """The decode functions' adapter arguments for ``slots`` (a slice
        of the slot table), or none on an adapter-free engine."""
        if not self.multi_lora:
            return {}
        return dict(
            adapters=self._adapter_pool,
            adapter_ids=self._to_device(self._slot_adapters[slots]),
            lora_scale=self.adapter_scale,
        )

    # -- device hooks (called by the scheduler) -------------------------
    def prefill_request(self, slot, prompt_tokens, temperature):
        """Run one request's prefill into ``slot``: cache rows 0..P-1
        written, first token sampled from the prompt's last logit row. A
        cached-prefix hit prefills only the unique suffix. The prompt
        prefills THROUGH the slot's adapter, so the pages seeding decode
        carry the adapted k/v. Returns the first generated token (a host
        int)."""
        with self._device_lock:
            return self._prefill_locked(slot, prompt_tokens, temperature)

    def _prefill_locked(self, slot, prompt_tokens, temperature):
        plen = len(prompt_tokens)
        prefix_len = self._slot_prefix_len.get(slot, 0)
        if prefix_len > 0:
            first = self._prefill_suffix(
                slot, prompt_tokens, prefix_len, temperature
            )
        else:
            padded = np.zeros((1, self.prefill_len), np.int32)
            padded[0, :plen] = prompt_tokens
            logits, ks, vs = gpt2_prefill(
                self.model, self._to_device(padded),
                **self._lora_kwargs(slice(slot, slot + 1)),
            )
            # position j -> (its page, its offset); padding rows past the
            # prompt carry the null page
            block_ids = np.zeros(self.prefill_len, np.int32)
            block_ids[:plen] = np.repeat(
                self._slot_blocks[slot], self.kv_block_size
            )[:plen]
            offsets = (
                np.arange(self.prefill_len, dtype=np.int32)
                % self.kv_block_size
            )
            write_prefill_to_pool(
                self._cache, ks, vs,
                self._to_device(block_ids), self._to_device(offsets),
            )
            first = self._sample(
                logits[:, plen - 1, :], np.full(1, temperature, np.float32)
            )
            first = int(first[0])
        if self.prefix_cache_enabled:
            # publish this prompt's full pages so later requests share
            # them (no-op for pages already in the registry)
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
        logits, _ = gpt2_prefill_suffix(
            self.model,
            self._to_device(padded),
            self._to_device(np.full(1, prefix_len, np.int32)),
            self._cache,
            self._to_device(self._block_tables[slot:slot + 1]),
            **self._lora_kwargs(slice(slot, slot + 1)),
        )
        first = self._sample(
            logits[:, len(suffix) - 1, :], np.full(1, temperature, np.float32)
        )
        return int(first[0])

    def reset_decode_state(self):
        """Rebuild the decode-side state (page pool, slot bookkeeping,
        block tables) from scratch; the weights are untouched — the
        driver auto-restart path after a decode crash."""
        self._cache = self._init_cache()
        self.block_pool = BlockPool(self.kv_pool_blocks, self.kv_block_size)
        self._reclaimed_synced = 0
        self._block_tables[:] = NULL_BLOCK
        self._slot_blocks.clear()
        self._slot_prefix_len.clear()
        self._slot_hashes.clear()
        self._sync_pool_metrics()
        self._lengths[:] = 0
        self._last_tokens[:] = 0
        if self.multi_lora:
            # adapter WEIGHTS survive a decode crash; only the slot pins
            # die with the fail-finished in-flight requests, which the
            # scheduler's crash recovery already released via release_slot
            self._slot_adapters[:] = 0
            self._slot_adapter_names.clear()
        log_dist(
            "inference decode state reset (driver restart)", ranks=[0],
        )

    def decode_tokens(self, active_slots):
        """One fixed-shape decode step over ALL slots; commits length /
        last-token bookkeeping for ``active_slots`` and returns their
        sampled tokens as host ints (same order). Each slot decodes
        through its adapter (per-slot ids, row 0 for the base model)."""
        with self._device_lock:
            logits, _ = gpt2_decode_step_paged(
                self.model,
                self._to_device(self._last_tokens),
                self._to_device(self._lengths),
                self._cache,
                self._to_device(self._block_tables),
                fused=self.fused_decode,
                **self._lora_kwargs(slice(None)),
            )
            next_tokens = self._sample(logits, self._temps).cpu().numpy()
        out = []
        for slot in active_slots:
            token = int(next_tokens[slot])
            self._lengths[slot] += 1
            self._last_tokens[slot] = token
            out.append(token)
        return out

    # -- serving API ----------------------------------------------------
    def submit(self, prompt_tokens, **kwargs):
        """Front-door submission; see
        :meth:`ContinuousBatchingScheduler.submit`."""
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
        return self.scheduler.serve_forever()

    def close(self):
        self.scheduler.shutdown()
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
):
    """Build a serving engine around ``model`` (a
    :class:`~deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel`).

    ``config`` is a dict or JSON path whose ``"inference"`` block sizes
    the engine (docs/inference.md); ``model_parameters`` is an optional
    state dict (e.g. from :func:`deepspeed_tpu_torch.convert.params_from_jax`)
    served in place of the model's own weights. ``device`` defaults to
    ``"cuda"`` and raises without a GPU; ``device="cpu"`` runs the
    kernels' plain PyTorch versions. ``mesh`` is refused (not yet
    ported). Returns an :class:`InferenceEngine`."""
    return InferenceEngine(
        model=model,
        config=config,
        model_parameters=model_parameters,
        mesh=mesh,
        rng_seed=rng_seed,
        device=device,
    )
