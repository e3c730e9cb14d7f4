"""Inference-config parser for the port (the serving slice).

The ``inference`` block of the JAX package's DeepSpeedConfig
(deepspeed_tpu/config/config.py), with the same keys, defaults and
rejections: a config the JAX engine refuses, this one refuses too. The
training blocks (batch triangle, optimizer, ZeRO, ...) wait for the
training slice; their keys are ignored here. ``world_size`` defaults to
the initialised ``torch.distributed`` world size (1 without a group),
where the JAX package read ``jax.device_count()``.
"""

from . import constants as C
from .config_utils import get_dict_param, get_scalar_param, load_config_json


class DeepSpeedConfigError(Exception):
    pass


def _default_world_size():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DeepSpeedConfig:
    def __init__(self, config, param_dict=None, world_size=None):
        """``config`` is a JSON path or a dict, or None when ``param_dict``
        is given."""
        if param_dict is not None:
            self._param_dict = dict(param_dict)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        elif config is None:
            self._param_dict = {}
        else:
            self._param_dict = load_config_json(config)
        self.world_size = (
            _default_world_size() if world_size is None else int(world_size)
        )
        self._initialize(self._param_dict)
        self._check_inference()

    def _initialize(self, pd):
        self.adapters_enabled = get_scalar_param(
            get_dict_param(pd, C.ADAPTERS), C.ADAPTERS_ENABLED,
            C.ADAPTERS_ENABLED_DEFAULT,
        )

        # inference block (docs/inference.md)
        inf_dict = get_dict_param(pd, C.INFERENCE)
        self.inference_max_batch_slots = get_scalar_param(
            inf_dict, C.INFERENCE_MAX_BATCH_SLOTS,
            C.INFERENCE_MAX_BATCH_SLOTS_DEFAULT,
        )
        self.inference_max_seq_len = get_scalar_param(
            inf_dict, C.INFERENCE_MAX_SEQ_LEN, C.INFERENCE_MAX_SEQ_LEN_DEFAULT
        )
        self.inference_prefill_len = get_scalar_param(
            inf_dict, C.INFERENCE_PREFILL_LEN, C.INFERENCE_PREFILL_LEN_DEFAULT
        )
        self.inference_queue_depth = get_scalar_param(
            inf_dict, C.INFERENCE_QUEUE_DEPTH, C.INFERENCE_QUEUE_DEPTH_DEFAULT
        )
        self.inference_queue_timeout = get_scalar_param(
            inf_dict, C.INFERENCE_QUEUE_TIMEOUT,
            C.INFERENCE_QUEUE_TIMEOUT_DEFAULT,
        )
        self.inference_eos_token_id = get_scalar_param(
            inf_dict, C.INFERENCE_EOS_TOKEN_ID,
            C.INFERENCE_EOS_TOKEN_ID_DEFAULT,
        )
        self.inference_deadline_secs = get_scalar_param(
            inf_dict, C.INFERENCE_DEADLINE_SECS,
            C.INFERENCE_DEADLINE_SECS_DEFAULT,
        )
        self.inference_driver_restart_budget = get_scalar_param(
            inf_dict, C.INFERENCE_DRIVER_RESTART_BUDGET,
            C.INFERENCE_DRIVER_RESTART_BUDGET_DEFAULT,
        )
        self.inference_degraded_queue_ratio = get_scalar_param(
            inf_dict, C.INFERENCE_DEGRADED_QUEUE_RATIO,
            C.INFERENCE_DEGRADED_QUEUE_RATIO_DEFAULT,
        )
        self.inference_dtype = get_scalar_param(
            inf_dict, C.INFERENCE_DTYPE, C.INFERENCE_DTYPE_DEFAULT
        )
        samp_dict = get_dict_param(inf_dict, C.INFERENCE_SAMPLING)
        self.inference_temperature = get_scalar_param(
            samp_dict, C.INFERENCE_SAMPLING_TEMPERATURE,
            C.INFERENCE_SAMPLING_TEMPERATURE_DEFAULT,
        )
        self.inference_top_k = get_scalar_param(
            samp_dict, C.INFERENCE_SAMPLING_TOP_K,
            C.INFERENCE_SAMPLING_TOP_K_DEFAULT,
        )
        self.inference_top_p = get_scalar_param(
            samp_dict, C.INFERENCE_SAMPLING_TOP_P,
            C.INFERENCE_SAMPLING_TOP_P_DEFAULT,
        )
        self.inference_greedy = get_scalar_param(
            samp_dict, C.INFERENCE_SAMPLING_GREEDY,
            C.INFERENCE_SAMPLING_GREEDY_DEFAULT,
        )
        self.inference_kv_block_size = get_scalar_param(
            inf_dict, C.INFERENCE_KV_BLOCK_SIZE,
            C.INFERENCE_KV_BLOCK_SIZE_DEFAULT,
        )
        self.inference_kv_pool_blocks = get_scalar_param(
            inf_dict, C.INFERENCE_KV_POOL_BLOCKS,
            C.INFERENCE_KV_POOL_BLOCKS_DEFAULT,
        )
        self.inference_fused_decode = get_scalar_param(
            inf_dict, C.INFERENCE_FUSED_DECODE,
            C.INFERENCE_FUSED_DECODE_DEFAULT,
        )
        # the speculative block's PRESENCE is the enable switch (its keys
        # all have workable defaults); the raw dict is kept for the
        # unknown-key check — a typo'd "k" must not mean "default k"
        self.inference_speculative_enabled = (
            inf_dict.get(C.INFERENCE_SPECULATIVE) is not None
        )
        spec_dict = get_dict_param(inf_dict, C.INFERENCE_SPECULATIVE)
        self._inference_speculative_raw = spec_dict
        self.inference_speculative_k = get_scalar_param(
            spec_dict, C.INFERENCE_SPECULATIVE_K,
            C.INFERENCE_SPECULATIVE_K_DEFAULT,
        )
        self.inference_speculative_draft_checkpoint = get_scalar_param(
            spec_dict, C.INFERENCE_SPECULATIVE_DRAFT_CHECKPOINT,
            C.INFERENCE_SPECULATIVE_DRAFT_CHECKPOINT_DEFAULT,
        )
        pc_dict = get_dict_param(inf_dict, C.INFERENCE_PREFIX_CACHE)
        self.inference_prefix_cache_enabled = get_scalar_param(
            pc_dict, C.INFERENCE_PREFIX_CACHE_ENABLED,
            C.INFERENCE_PREFIX_CACHE_ENABLED_DEFAULT,
        )
        self.inference_prefix_cache_suffix_buckets = get_scalar_param(
            pc_dict, C.INFERENCE_PREFIX_CACHE_SUFFIX_BUCKETS,
            C.INFERENCE_PREFIX_CACHE_SUFFIX_BUCKETS_DEFAULT,
        )
        # host_tier block — raw dict kept for the unknown-key check (a
        # typo'd "lazy_alloc" must not silently mean "default off")
        ht_dict = get_dict_param(inf_dict, C.INFERENCE_HOST_TIER)
        self._inference_host_tier_raw = ht_dict
        self.inference_host_tier_enabled = get_scalar_param(
            ht_dict, C.INFERENCE_HOST_TIER_ENABLED,
            C.INFERENCE_HOST_TIER_ENABLED_DEFAULT,
        )
        self.inference_host_tier_max_bytes = get_scalar_param(
            ht_dict, C.INFERENCE_HOST_TIER_MAX_BYTES,
            C.INFERENCE_HOST_TIER_MAX_BYTES_DEFAULT,
        )
        self.inference_host_tier_peer_sharing = get_scalar_param(
            ht_dict, C.INFERENCE_HOST_TIER_PEER_SHARING,
            C.INFERENCE_HOST_TIER_PEER_SHARING_DEFAULT,
        )
        self.inference_host_tier_share_group = get_scalar_param(
            ht_dict, C.INFERENCE_HOST_TIER_SHARE_GROUP,
            C.INFERENCE_HOST_TIER_SHARE_GROUP_DEFAULT,
        )
        self.inference_host_tier_lazy_alloc = get_scalar_param(
            ht_dict, C.INFERENCE_HOST_TIER_LAZY_ALLOC,
            C.INFERENCE_HOST_TIER_LAZY_ALLOC_DEFAULT,
        )
        ckpt_dict = get_dict_param(inf_dict, C.INFERENCE_CHECKPOINT)
        self.inference_checkpoint_load_dir = get_scalar_param(
            ckpt_dict, C.INFERENCE_CHECKPOINT_LOAD_DIR,
            C.INFERENCE_CHECKPOINT_LOAD_DIR_DEFAULT,
        )
        self.inference_checkpoint_tag = get_scalar_param(
            ckpt_dict, C.INFERENCE_CHECKPOINT_TAG,
            C.INFERENCE_CHECKPOINT_TAG_DEFAULT,
        )

    def _check_inference(self):
        """Validate the inference block (docs/inference.md): a typo'd slot
        count or an out-of-range sampling default must fail at
        init_inference(), not as a shape error in the first decode step or
        a silently-degenerate sampler. The same checks, in the same order,
        as the JAX package's DeepSpeedConfig._check_inference."""
        slots = self.inference_max_batch_slots
        if not isinstance(slots, int) or isinstance(slots, bool) or slots < 1:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_MAX_BATCH_SLOTS} must be an "
                f"integer >= 1, got {slots!r}"
            )
        for field, value in (
            (C.INFERENCE_MAX_SEQ_LEN, self.inference_max_seq_len),
            (C.INFERENCE_PREFILL_LEN, self.inference_prefill_len),
            (C.INFERENCE_SAMPLING_TOP_K, self.inference_top_k),
        ):
            if (
                not isinstance(value, int)
                or isinstance(value, bool)
                or value < 0
            ):
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{field} must be an integer >= 0 "
                    f"(0 = default/disabled), got {value!r}"
                )
        qd = self.inference_queue_depth
        if not isinstance(qd, int) or isinstance(qd, bool) or qd < 1:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_QUEUE_DEPTH} must be an "
                f"integer >= 1, got {qd!r}"
            )
        if (
            self.inference_max_seq_len
            and self.inference_prefill_len > self.inference_max_seq_len
        ):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_PREFILL_LEN}="
                f"{self.inference_prefill_len} exceeds "
                f"{C.INFERENCE_MAX_SEQ_LEN}={self.inference_max_seq_len}"
            )
        timeout = self.inference_queue_timeout
        if (
            not isinstance(timeout, (int, float))
            or isinstance(timeout, bool)
            or timeout < 0
        ):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_QUEUE_TIMEOUT} must be a "
                f"number >= 0 seconds (0 rejects immediately when full), "
                f"got {timeout!r}"
            )
        eos = self.inference_eos_token_id
        if eos is not None and (
            not isinstance(eos, int) or isinstance(eos, bool)
        ):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_EOS_TOKEN_ID} must be an "
                f"integer token id or null, got {eos!r}"
            )
        deadline = self.inference_deadline_secs
        if deadline is not None and (
            not isinstance(deadline, (int, float))
            or isinstance(deadline, bool)
            or deadline <= 0
        ):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_DEADLINE_SECS} must be a "
                f"number > 0 seconds or null (null = no deadline), got "
                f"{deadline!r}"
            )
        budget = self.inference_driver_restart_budget
        if (
            not isinstance(budget, int)
            or isinstance(budget, bool)
            or budget < 0
        ):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_DRIVER_RESTART_BUDGET} must "
                f"be an integer >= 0 (0 = no auto-restart), got {budget!r}"
            )
        ratio = self.inference_degraded_queue_ratio
        if (
            not isinstance(ratio, (int, float))
            or isinstance(ratio, bool)
            or not 0 < ratio <= 1
        ):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_DEGRADED_QUEUE_RATIO} must "
                f"be a number in (0, 1], got {ratio!r}"
            )
        if self.inference_dtype not in ("fp32", "bf16"):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_DTYPE} must be 'fp32' or "
                f"'bf16', got {self.inference_dtype!r}"
            )
        temp = self.inference_temperature
        if (
            not isinstance(temp, (int, float))
            or isinstance(temp, bool)
            or temp < 0
        ):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_SAMPLING}."
                f"{C.INFERENCE_SAMPLING_TEMPERATURE} must be a number >= 0 "
                f"(0 = greedy), got {temp!r}"
            )
        top_p = self.inference_top_p
        if (
            not isinstance(top_p, (int, float))
            or isinstance(top_p, bool)
            or not 0 < top_p <= 1
        ):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_SAMPLING}."
                f"{C.INFERENCE_SAMPLING_TOP_P} must be a number in "
                f"(0, 1] (1 = disabled), got {top_p!r}"
            )
        if not isinstance(self.inference_greedy, bool):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_SAMPLING}."
                f"{C.INFERENCE_SAMPLING_GREEDY} must be a boolean, got "
                f"{self.inference_greedy!r}"
            )
        if not isinstance(self.inference_checkpoint_load_dir, str):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_CHECKPOINT}."
                f"{C.INFERENCE_CHECKPOINT_LOAD_DIR} must be a path string "
                f"('' = serve the passed-in parameters), got "
                f"{self.inference_checkpoint_load_dir!r}"
            )
        bs = self.inference_kv_block_size
        if not isinstance(bs, int) or isinstance(bs, bool) or bs < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_KV_BLOCK_SIZE} must be an "
                f"integer >= 0 tokens per page (0 = contiguous per-slot "
                f"cache), got {bs!r}"
            )
        pool = self.inference_kv_pool_blocks
        if not isinstance(pool, int) or isinstance(pool, bool) or pool < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_KV_POOL_BLOCKS} must be an "
                f"integer >= 0 pages (0 = auto-size to the contiguous "
                f"cache's HBM), got {pool!r}"
            )
        if pool > 0 and bs == 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_KV_POOL_BLOCKS}={pool} "
                f"without {C.INFERENCE_KV_BLOCK_SIZE}: a pool needs a "
                f"page size (set kv_block_size > 0, e.g. 32)"
            )
        if (
            bs > 0
            and self.inference_max_seq_len
            and self.inference_max_seq_len % bs != 0
        ):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_MAX_SEQ_LEN}="
                f"{self.inference_max_seq_len} is not a multiple of "
                f"{C.INFERENCE_KV_BLOCK_SIZE}={bs}: the paged cache's "
                f"logical extent must equal the contiguous cache's "
                f"(the bitwise-parity contract)"
            )
        fused = self.inference_fused_decode
        if not isinstance(fused, bool):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FUSED_DECODE} must be a "
                f"boolean, got {fused!r}"
            )
        if fused and bs == 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FUSED_DECODE} requires the "
                f"paged cache: the flash-decode kernel streams KV PAGES "
                f"through the block table (set "
                f"{C.INFERENCE_KV_BLOCK_SIZE} > 0)"
            )
        if self.inference_speculative_enabled:
            spec = self._inference_speculative_raw
            known = {
                C.INFERENCE_SPECULATIVE_K,
                C.INFERENCE_SPECULATIVE_DRAFT_CHECKPOINT,
            }
            unknown = set(spec) - known
            if unknown:
                # a typo'd "k" must not silently mean "default k=4"
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{C.INFERENCE_SPECULATIVE}: unknown "
                    f"keys {sorted(unknown)}; valid: {sorted(known)}"
                )
            k = self.inference_speculative_k
            if not isinstance(k, int) or isinstance(k, bool) or k < 1:
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{C.INFERENCE_SPECULATIVE}."
                    f"{C.INFERENCE_SPECULATIVE_K} must be an integer >= 1 "
                    f"draft tokens per step, got {k!r}"
                )
            ckpt = self.inference_speculative_draft_checkpoint
            if not isinstance(ckpt, str):
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{C.INFERENCE_SPECULATIVE}."
                    f"{C.INFERENCE_SPECULATIVE_DRAFT_CHECKPOINT} must be "
                    f"a path string ('' = serve the passed-in draft "
                    f"parameters), got {ckpt!r}"
                )
            if bs == 0:
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{C.INFERENCE_SPECULATIVE} requires "
                    f"the paged cache: the target's batched verify step "
                    f"writes through the block tables (set "
                    f"{C.INFERENCE_KV_BLOCK_SIZE} > 0)"
                )
        pc = self.inference_prefix_cache_enabled
        if pc is not None and not isinstance(pc, bool):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_PREFIX_CACHE}."
                f"{C.INFERENCE_PREFIX_CACHE_ENABLED} must be a boolean or "
                f"null (null = on whenever the cache is paged), got {pc!r}"
            )
        if pc is True and bs == 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_PREFIX_CACHE} requires the "
                f"paged cache: set {C.INFERENCE_KV_BLOCK_SIZE} > 0 "
                f"(prefixes are shared at page granularity)"
            )
        buckets = self.inference_prefix_cache_suffix_buckets
        if buckets is not None and bs == 0:
            # same guard as kv_pool_blocks-without-a-page-size: bucket
            # config on a contiguous cache would be silently inert
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_PREFIX_CACHE}."
                f"{C.INFERENCE_PREFIX_CACHE_SUFFIX_BUCKETS} requires the "
                f"paged cache: set {C.INFERENCE_KV_BLOCK_SIZE} > 0"
            )
        if buckets is not None:
            if (
                not isinstance(buckets, list)
                or not buckets
                or not all(
                    isinstance(b, int)
                    and not isinstance(b, bool)
                    and b >= 1
                    for b in buckets
                )
                or sorted(buckets) != buckets
            ):
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{C.INFERENCE_PREFIX_CACHE}."
                    f"{C.INFERENCE_PREFIX_CACHE_SUFFIX_BUCKETS} must be an "
                    f"ascending non-empty list of integers >= 1 (each a "
                    f"compiled suffix-prefill width) or null (auto "
                    f"ladder), got {buckets!r}"
                )
        ht = f"{C.INFERENCE}.{C.INFERENCE_HOST_TIER}"
        known_ht = {
            C.INFERENCE_HOST_TIER_ENABLED,
            C.INFERENCE_HOST_TIER_MAX_BYTES,
            C.INFERENCE_HOST_TIER_PEER_SHARING,
            C.INFERENCE_HOST_TIER_SHARE_GROUP,
            C.INFERENCE_HOST_TIER_LAZY_ALLOC,
        }
        unknown_ht = set(self._inference_host_tier_raw) - known_ht
        if unknown_ht:
            # a typo'd "lazy_alloc" must not silently mean "default off"
            raise DeepSpeedConfigError(
                f"{ht}: unknown keys {sorted(unknown_ht)}; valid: "
                f"{sorted(known_ht)}"
            )
        if not isinstance(self.inference_host_tier_enabled, bool):
            raise DeepSpeedConfigError(
                f"{ht}.{C.INFERENCE_HOST_TIER_ENABLED} must be a boolean, "
                f"got {self.inference_host_tier_enabled!r}"
            )
        mb = self.inference_host_tier_max_bytes
        if not isinstance(mb, int) or isinstance(mb, bool) or mb < 1:
            raise DeepSpeedConfigError(
                f"{ht}.{C.INFERENCE_HOST_TIER_MAX_BYTES} must be an "
                f"integer >= 1 (host-RAM byte budget for parked "
                f"pages/rows), got {mb!r}"
            )
        if not isinstance(self.inference_host_tier_peer_sharing, bool):
            raise DeepSpeedConfigError(
                f"{ht}.{C.INFERENCE_HOST_TIER_PEER_SHARING} must be a "
                f"boolean, got {self.inference_host_tier_peer_sharing!r}"
            )
        group = self.inference_host_tier_share_group
        if not isinstance(group, str) or not group:
            raise DeepSpeedConfigError(
                f"{ht}.{C.INFERENCE_HOST_TIER_SHARE_GROUP} must be a "
                f"non-empty string naming the process-level share group, "
                f"got {group!r}"
            )
        if not isinstance(self.inference_host_tier_lazy_alloc, bool):
            raise DeepSpeedConfigError(
                f"{ht}.{C.INFERENCE_HOST_TIER_LAZY_ALLOC} must be a "
                f"boolean, got {self.inference_host_tier_lazy_alloc!r}"
            )
        if self.inference_host_tier_enabled:
            if bs == 0 and not self.adapters_enabled:
                raise DeepSpeedConfigError(
                    f"{ht} has nothing to spill: enable the paged KV "
                    f"cache ({C.INFERENCE_KV_BLOCK_SIZE} > 0) and/or "
                    f"adapters ({C.ADAPTERS}.{C.ADAPTERS_ENABLED})"
                )
        if self.inference_host_tier_lazy_alloc:
            if not self.inference_host_tier_enabled:
                raise DeepSpeedConfigError(
                    f"{ht}.{C.INFERENCE_HOST_TIER_LAZY_ALLOC} requires "
                    f"the tier ({C.INFERENCE_HOST_TIER_ENABLED}: true): "
                    f"a preempted request's pages park in host RAM, not "
                    f"the trash"
                )
            if bs == 0:
                raise DeepSpeedConfigError(
                    f"{ht}.{C.INFERENCE_HOST_TIER_LAZY_ALLOC} requires "
                    f"the paged cache: growth and preemption happen at "
                    f"page granularity (set {C.INFERENCE_KV_BLOCK_SIZE} "
                    f"> 0)"
                )
