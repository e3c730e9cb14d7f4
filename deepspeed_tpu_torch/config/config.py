"""Config parser for the port: the serving, training, adapters,
observability, resilience and data-pipeline blocks.

The ``inference`` block, the ``adapters`` block, the training blocks
(the batch triangle, ``optimizer``, ``scheduler``, ``fp16``/``bf16``,
``gradient_clipping``, ``zero_optimization`` through
:class:`~.zero_config.DeepSpeedZeroConfig`, ``activation_checkpointing``,
``steps_per_print``, ``data_types``), the observability blocks
(``tensorboard``, ``wall_clock_breakdown``, ``memory_breakdown``,
``telemetry`` with its ``tracing`` sub-block), the ``resilience`` block
(with its ``fault_injection`` and ``supervisor`` sub-blocks), the
``data_pipeline`` and ``compile_cache`` blocks and the fleet's
``serving`` block (every key) of the JAX package's
DeepSpeedConfig (deepspeed_tpu/config/config.py), with the same keys,
defaults and rejections, error text included: a config the JAX package
refuses, this one refuses too. The batch triangle is resolved only for a training
config (``training=True``, as ``initialize()`` builds it): an inference
config names no batch size. ``world_size`` is the batch triangle's
data-parallel size: the training engine passes its mesh's data axis
(parallel/mesh.py), as the JAX engine passes its mesh's; without it the
default is the initialised ``torch.distributed`` world size (1 without a
group), where the JAX package read ``jax.device_count()``.
"""

import os

from ..utils.logging import logger
from . import constants as C
from .activation_checkpointing_config import (
    DeepSpeedActivationCheckpointingConfig,
)
from .config_utils import get_dict_param, get_scalar_param, load_config_json
from .zero_config import DeepSpeedZeroConfig


class DeepSpeedConfigError(Exception):
    pass


def _default_world_size():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DeepSpeedConfig:
    def __init__(self, config, param_dict=None, world_size=None,
                 training=False):
        """``config`` is a JSON path or a dict, or None when ``param_dict``
        is given. ``training`` resolves and checks the batch triangle and
        the training blocks, as ``initialize()`` needs."""
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
        if training:
            self._configure_batch_parameters()
            self._check_training()
        self._check_telemetry()
        self._check_resilience()
        self._check_data_pipeline()
        self._check_inference()
        self._check_adapters()
        self._check_serving()
        self._do_warning_check()

    def _initialize(self, pd):
        # adapters block (adapters/, docs/adapters.md)
        ad_dict = get_dict_param(pd, C.ADAPTERS)
        self.adapters_enabled = get_scalar_param(
            ad_dict, C.ADAPTERS_ENABLED, C.ADAPTERS_ENABLED_DEFAULT
        )
        self.adapters_rank = get_scalar_param(
            ad_dict, C.ADAPTERS_RANK, C.ADAPTERS_RANK_DEFAULT
        )
        self.adapters_alpha = get_scalar_param(
            ad_dict, C.ADAPTERS_ALPHA, C.ADAPTERS_ALPHA_DEFAULT
        )
        targets = ad_dict.get(C.ADAPTERS_TARGETS, C.ADAPTERS_TARGETS_DEFAULT)
        # keep non-list values (a bare "attn_qkvw" would list() into
        # characters) for _check_adapters to reject with a config error
        self.adapters_targets = (
            list(targets) if isinstance(targets, (list, tuple)) else targets
        )
        self.adapters_pool_slots = get_scalar_param(
            ad_dict, C.ADAPTERS_POOL_SLOTS, C.ADAPTERS_POOL_SLOTS_DEFAULT
        )
        self._initialize_training(pd)
        self._initialize_observability(pd)
        self._initialize_resilience(pd)
        self._initialize_data_pipeline(pd)
        self._initialize_serving(pd)

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

    def _initialize_serving(self, pd):
        """The ``serving`` block (serving/, docs/serving.md), as the JAX
        parser reads it: every key, the networked fleet's, the
        journal's, the autoscaler's, the hub's and the provisioner's
        included, so that a config validates alike in both packages."""
        srv_dict = get_dict_param(pd, C.SERVING)
        self.serving_replicas = get_scalar_param(
            srv_dict, C.SERVING_REPLICAS, C.SERVING_REPLICAS_DEFAULT
        )
        self.serving_backend = get_scalar_param(
            srv_dict, C.SERVING_BACKEND, C.SERVING_BACKEND_DEFAULT
        )
        self.serving_placement = get_scalar_param(
            srv_dict, C.SERVING_PLACEMENT, C.SERVING_PLACEMENT_DEFAULT
        )
        self.serving_affinity_prefix_tokens = get_scalar_param(
            srv_dict, C.SERVING_AFFINITY_PREFIX_TOKENS,
            C.SERVING_AFFINITY_PREFIX_TOKENS_DEFAULT,
        )
        self.serving_capacity_floor = get_scalar_param(
            srv_dict, C.SERVING_CAPACITY_FLOOR,
            C.SERVING_CAPACITY_FLOOR_DEFAULT,
        )
        self.serving_shed_queue_ratio = get_scalar_param(
            srv_dict, C.SERVING_SHED_QUEUE_RATIO,
            C.SERVING_SHED_QUEUE_RATIO_DEFAULT,
        )
        self.serving_max_reroutes = get_scalar_param(
            srv_dict, C.SERVING_MAX_REROUTES, C.SERVING_MAX_REROUTES_DEFAULT
        )
        self.serving_drain_on_preemption = get_scalar_param(
            srv_dict, C.SERVING_DRAIN_ON_PREEMPTION,
            C.SERVING_DRAIN_ON_PREEMPTION_DEFAULT,
        )
        rl_dict = get_dict_param(srv_dict, C.SERVING_RATE_LIMIT)
        self.serving_rate_limit_rps = get_scalar_param(
            rl_dict, C.SERVING_RATE_LIMIT_RPS, C.SERVING_RATE_LIMIT_RPS_DEFAULT
        )
        self.serving_rate_limit_burst = get_scalar_param(
            rl_dict, C.SERVING_RATE_LIMIT_BURST,
            C.SERVING_RATE_LIMIT_BURST_DEFAULT,
        )
        per_tenant = rl_dict.get(
            C.SERVING_RATE_LIMIT_PER_TENANT,
            C.SERVING_RATE_LIMIT_PER_TENANT_DEFAULT,
        )
        # keep non-dict values for _check_serving to reject loudly
        self.serving_rate_limit_per_tenant = (
            dict(per_tenant) if isinstance(per_tenant, dict)
            else {} if per_tenant is None else per_tenant
        )
        self.serving_rpc_timeout_secs = get_scalar_param(
            srv_dict, C.SERVING_RPC_TIMEOUT_SECS,
            C.SERVING_RPC_TIMEOUT_SECS_DEFAULT,
        )
        self.serving_rpc_retries = get_scalar_param(
            srv_dict, C.SERVING_RPC_RETRIES, C.SERVING_RPC_RETRIES_DEFAULT
        )
        self.serving_rpc_backoff_secs = get_scalar_param(
            srv_dict, C.SERVING_RPC_BACKOFF_SECS,
            C.SERVING_RPC_BACKOFF_SECS_DEFAULT,
        )
        self.serving_zombie_secs = get_scalar_param(
            srv_dict, C.SERVING_ZOMBIE_SECS, C.SERVING_ZOMBIE_SECS_DEFAULT
        )
        self.serving_zombie_restart_budget = get_scalar_param(
            srv_dict, C.SERVING_ZOMBIE_RESTART_BUDGET,
            C.SERVING_ZOMBIE_RESTART_BUDGET_DEFAULT,
        )
        cb_dict = get_dict_param(srv_dict, C.SERVING_CIRCUIT_BREAKER)
        self.serving_cb_failure_threshold = get_scalar_param(
            cb_dict, C.SERVING_CB_FAILURE_THRESHOLD,
            C.SERVING_CB_FAILURE_THRESHOLD_DEFAULT,
        )
        self.serving_cb_backoff_secs = get_scalar_param(
            cb_dict, C.SERVING_CB_BACKOFF_SECS,
            C.SERVING_CB_BACKOFF_SECS_DEFAULT,
        )
        self.serving_cb_backoff_max_secs = get_scalar_param(
            cb_dict, C.SERVING_CB_BACKOFF_MAX_SECS,
            C.SERVING_CB_BACKOFF_MAX_SECS_DEFAULT,
        )
        bo_dict = get_dict_param(srv_dict, C.SERVING_BROWNOUT)
        self.serving_brownout_queue_ratio = get_scalar_param(
            bo_dict, C.SERVING_BROWNOUT_QUEUE_RATIO,
            C.SERVING_BROWNOUT_QUEUE_RATIO_DEFAULT,
        )
        self.serving_brownout_max_new_tokens = get_scalar_param(
            bo_dict, C.SERVING_BROWNOUT_MAX_NEW_TOKENS,
            C.SERVING_BROWNOUT_MAX_NEW_TOKENS_DEFAULT,
        )
        sock_dict = get_dict_param(srv_dict, C.SERVING_SOCKET)
        self.serving_socket_lease_secs = get_scalar_param(
            sock_dict, C.SERVING_SOCKET_LEASE_SECS,
            C.SERVING_SOCKET_LEASE_SECS_DEFAULT,
        )
        self.serving_socket_reconnect_attempts = get_scalar_param(
            sock_dict, C.SERVING_SOCKET_RECONNECT_ATTEMPTS,
            C.SERVING_SOCKET_RECONNECT_ATTEMPTS_DEFAULT,
        )
        self.serving_socket_reconnect_backoff_secs = get_scalar_param(
            sock_dict, C.SERVING_SOCKET_RECONNECT_BACKOFF_SECS,
            C.SERVING_SOCKET_RECONNECT_BACKOFF_SECS_DEFAULT,
        )
        self.serving_socket_connect_timeout_secs = get_scalar_param(
            sock_dict, C.SERVING_SOCKET_CONNECT_TIMEOUT_SECS,
            C.SERVING_SOCKET_CONNECT_TIMEOUT_SECS_DEFAULT,
        )
        self.serving_socket_connect_retries = get_scalar_param(
            sock_dict, C.SERVING_SOCKET_CONNECT_RETRIES,
            C.SERVING_SOCKET_CONNECT_RETRIES_DEFAULT,
        )
        http_dict = get_dict_param(srv_dict, C.SERVING_HTTP)
        self.serving_http_host = get_scalar_param(
            http_dict, C.SERVING_HTTP_HOST, C.SERVING_HTTP_HOST_DEFAULT
        )
        self.serving_http_port = get_scalar_param(
            http_dict, C.SERVING_HTTP_PORT, C.SERVING_HTTP_PORT_DEFAULT
        )
        self.serving_http_max_buffer_bytes = get_scalar_param(
            http_dict, C.SERVING_HTTP_MAX_BUFFER_BYTES,
            C.SERVING_HTTP_MAX_BUFFER_BYTES_DEFAULT,
        )
        self.serving_http_overrun_policy = get_scalar_param(
            http_dict, C.SERVING_HTTP_OVERRUN_POLICY,
            C.SERVING_HTTP_OVERRUN_POLICY_DEFAULT,
        )
        # the bearer secret is held on an underscored attribute so
        # config.print's attribute walk (which skips "_" names) can
        # never log it; readers go through the property below
        self._serving_http_auth_token = get_scalar_param(
            http_dict, C.SERVING_HTTP_AUTH_TOKEN,
            C.SERVING_HTTP_AUTH_TOKEN_DEFAULT,
        )
        slo_dict = get_dict_param(srv_dict, C.SERVING_SLO)
        self.serving_slo_ttft_p99_ms = get_scalar_param(
            slo_dict, C.SERVING_SLO_TTFT_P99_MS,
            C.SERVING_SLO_TTFT_P99_MS_DEFAULT,
        )
        self.serving_slo_token_p99_ms = get_scalar_param(
            slo_dict, C.SERVING_SLO_TOKEN_P99_MS,
            C.SERVING_SLO_TOKEN_P99_MS_DEFAULT,
        )
        self.serving_slo_eval_window_secs = get_scalar_param(
            slo_dict, C.SERVING_SLO_EVAL_WINDOW_SECS,
            C.SERVING_SLO_EVAL_WINDOW_SECS_DEFAULT,
        )
        asc_dict = get_dict_param(srv_dict, C.SERVING_AUTOSCALE)
        self.serving_autoscale_enabled = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_ENABLED,
            C.SERVING_AUTOSCALE_ENABLED_DEFAULT,
        )
        self.serving_autoscale_min_replicas = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_MIN_REPLICAS,
            C.SERVING_AUTOSCALE_MIN_REPLICAS_DEFAULT,
        )
        self.serving_autoscale_max_replicas = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_MAX_REPLICAS,
            C.SERVING_AUTOSCALE_MAX_REPLICAS_DEFAULT,
        )
        self.serving_autoscale_cooldown_secs = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_COOLDOWN_SECS,
            C.SERVING_AUTOSCALE_COOLDOWN_SECS_DEFAULT,
        )
        self.serving_autoscale_hysteresis_secs = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_HYSTERESIS_SECS,
            C.SERVING_AUTOSCALE_HYSTERESIS_SECS_DEFAULT,
        )
        self.serving_autoscale_flap_budget = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_FLAP_BUDGET,
            C.SERVING_AUTOSCALE_FLAP_BUDGET_DEFAULT,
        )
        self.serving_autoscale_flap_window_secs = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_FLAP_WINDOW_SECS,
            C.SERVING_AUTOSCALE_FLAP_WINDOW_SECS_DEFAULT,
        )
        self.serving_autoscale_up_utilization = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_UP_UTILIZATION,
            C.SERVING_AUTOSCALE_UP_UTILIZATION_DEFAULT,
        )
        self.serving_autoscale_down_utilization = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_DOWN_UTILIZATION,
            C.SERVING_AUTOSCALE_DOWN_UTILIZATION_DEFAULT,
        )
        self.serving_autoscale_interval_secs = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_INTERVAL_SECS,
            C.SERVING_AUTOSCALE_INTERVAL_SECS_DEFAULT,
        )
        self.serving_autoscale_drain_timeout_secs = get_scalar_param(
            asc_dict, C.SERVING_AUTOSCALE_DRAIN_TIMEOUT_SECS,
            C.SERVING_AUTOSCALE_DRAIN_TIMEOUT_SECS_DEFAULT,
        )
        hub_dict = get_dict_param(srv_dict, C.SERVING_HUB)
        self.serving_hub_enabled = get_scalar_param(
            hub_dict, C.SERVING_HUB_ENABLED,
            C.SERVING_HUB_ENABLED_DEFAULT,
        )
        self.serving_hub_interval_secs = get_scalar_param(
            hub_dict, C.SERVING_HUB_INTERVAL_SECS,
            C.SERVING_HUB_INTERVAL_SECS_DEFAULT,
        )
        self.serving_hub_retention_points = get_scalar_param(
            hub_dict, C.SERVING_HUB_RETENTION_POINTS,
            C.SERVING_HUB_RETENTION_POINTS_DEFAULT,
        )
        self.serving_hub_drain_interval_secs = get_scalar_param(
            hub_dict, C.SERVING_HUB_DRAIN_INTERVAL_SECS,
            C.SERVING_HUB_DRAIN_INTERVAL_SECS_DEFAULT,
        )
        self.serving_hub_op_timeout_secs = get_scalar_param(
            hub_dict, C.SERVING_HUB_OP_TIMEOUT_SECS,
            C.SERVING_HUB_OP_TIMEOUT_SECS_DEFAULT,
        )
        self.serving_hub_node_backoff_secs = get_scalar_param(
            hub_dict, C.SERVING_HUB_NODE_BACKOFF_SECS,
            C.SERVING_HUB_NODE_BACKOFF_SECS_DEFAULT,
        )
        self.serving_hub_auth_exempt = tuple(get_scalar_param(
            hub_dict, C.SERVING_HUB_AUTH_EXEMPT,
            C.SERVING_HUB_AUTH_EXEMPT_DEFAULT,
        ) or ())
        hub_alerts = get_dict_param(hub_dict, C.SERVING_HUB_ALERTS)
        self.serving_hub_alerts_slo_target = get_scalar_param(
            hub_alerts, C.SERVING_HUB_ALERTS_SLO_TARGET,
            C.SERVING_HUB_ALERTS_SLO_TARGET_DEFAULT,
        )
        self.serving_hub_alerts_fast_window_secs = get_scalar_param(
            hub_alerts, C.SERVING_HUB_ALERTS_FAST_WINDOW_SECS,
            C.SERVING_HUB_ALERTS_FAST_WINDOW_SECS_DEFAULT,
        )
        self.serving_hub_alerts_slow_window_secs = get_scalar_param(
            hub_alerts, C.SERVING_HUB_ALERTS_SLOW_WINDOW_SECS,
            C.SERVING_HUB_ALERTS_SLOW_WINDOW_SECS_DEFAULT,
        )
        self.serving_hub_alerts_fast_burn = get_scalar_param(
            hub_alerts, C.SERVING_HUB_ALERTS_FAST_BURN,
            C.SERVING_HUB_ALERTS_FAST_BURN_DEFAULT,
        )
        self.serving_hub_alerts_slow_burn = get_scalar_param(
            hub_alerts, C.SERVING_HUB_ALERTS_SLOW_BURN,
            C.SERVING_HUB_ALERTS_SLOW_BURN_DEFAULT,
        )
        self.serving_hub_alerts_breaker_flood = get_scalar_param(
            hub_alerts, C.SERVING_HUB_ALERTS_BREAKER_FLOOD,
            C.SERVING_HUB_ALERTS_BREAKER_FLOOD_DEFAULT,
        )
        self.serving_hub_alerts_suppressed_growth = get_scalar_param(
            hub_alerts, C.SERVING_HUB_ALERTS_SUPPRESSED_GROWTH,
            C.SERVING_HUB_ALERTS_SUPPRESSED_GROWTH_DEFAULT,
        )
        jrn_dict = get_dict_param(srv_dict, C.SERVING_JOURNAL)
        self.serving_journal_enabled = get_scalar_param(
            jrn_dict, C.SERVING_JOURNAL_ENABLED,
            C.SERVING_JOURNAL_ENABLED_DEFAULT,
        )
        self.serving_journal_dir = get_scalar_param(
            jrn_dict, C.SERVING_JOURNAL_DIR,
            C.SERVING_JOURNAL_DIR_DEFAULT,
        )
        self.serving_journal_fsync = get_scalar_param(
            jrn_dict, C.SERVING_JOURNAL_FSYNC,
            C.SERVING_JOURNAL_FSYNC_DEFAULT,
        )
        self.serving_journal_keep_segments = get_scalar_param(
            jrn_dict, C.SERVING_JOURNAL_KEEP_SEGMENTS,
            C.SERVING_JOURNAL_KEEP_SEGMENTS_DEFAULT,
        )
        self.serving_journal_max_inflight = get_scalar_param(
            jrn_dict, C.SERVING_JOURNAL_MAX_INFLIGHT,
            C.SERVING_JOURNAL_MAX_INFLIGHT_DEFAULT,
        )
        prov_dict = get_dict_param(srv_dict, C.SERVING_PROVISIONER)
        self.serving_provisioner_enabled = get_scalar_param(
            prov_dict, C.SERVING_PROVISIONER_ENABLED,
            C.SERVING_PROVISIONER_ENABLED_DEFAULT,
        )
        self.serving_provisioner_node_spec = get_scalar_param(
            prov_dict, C.SERVING_PROVISIONER_NODE_SPEC,
            C.SERVING_PROVISIONER_NODE_SPEC_DEFAULT,
        )
        self.serving_provisioner_max_nodes = get_scalar_param(
            prov_dict, C.SERVING_PROVISIONER_MAX_NODES,
            C.SERVING_PROVISIONER_MAX_NODES_DEFAULT,
        )
        self.serving_provisioner_max_replicas_per_node = get_scalar_param(
            prov_dict, C.SERVING_PROVISIONER_MAX_REPLICAS_PER_NODE,
            C.SERVING_PROVISIONER_MAX_REPLICAS_PER_NODE_DEFAULT,
        )
        self.serving_provisioner_launch_timeout_secs = get_scalar_param(
            prov_dict, C.SERVING_PROVISIONER_LAUNCH_TIMEOUT_SECS,
            C.SERVING_PROVISIONER_LAUNCH_TIMEOUT_SECS_DEFAULT,
        )
        self.serving_provisioner_terminate_grace_secs = get_scalar_param(
            prov_dict, C.SERVING_PROVISIONER_TERMINATE_GRACE_SECS,
            C.SERVING_PROVISIONER_TERMINATE_GRACE_SECS_DEFAULT,
        )

    def _initialize_resilience(self, pd):
        """The ``resilience`` block (resilience/, docs/resilience.md), as
        the JAX parser reads it."""
        res_dict = get_dict_param(pd, C.RESILIENCE)
        self.resilience_enabled = get_scalar_param(
            res_dict, C.RESILIENCE_ENABLED, C.RESILIENCE_ENABLED_DEFAULT
        )
        self.resilience_fsync = get_scalar_param(
            res_dict, C.RESILIENCE_FSYNC, C.RESILIENCE_FSYNC_DEFAULT
        )
        self.resilience_verify_on_load = get_scalar_param(
            res_dict,
            C.RESILIENCE_VERIFY_ON_LOAD,
            C.RESILIENCE_VERIFY_ON_LOAD_DEFAULT,
        )
        self.resilience_fallback_on_corruption = get_scalar_param(
            res_dict,
            C.RESILIENCE_FALLBACK_ON_CORRUPTION,
            C.RESILIENCE_FALLBACK_ON_CORRUPTION_DEFAULT,
        )
        self.resilience_keep_last_n = get_scalar_param(
            res_dict, C.RESILIENCE_KEEP_LAST_N, C.RESILIENCE_KEEP_LAST_N_DEFAULT
        )
        retry_dict = get_dict_param(res_dict, C.RESILIENCE_RETRY)
        self.resilience_retry_max_attempts = get_scalar_param(
            retry_dict,
            C.RESILIENCE_RETRY_MAX_ATTEMPTS,
            C.RESILIENCE_RETRY_MAX_ATTEMPTS_DEFAULT,
        )
        self.resilience_retry_backoff_base = get_scalar_param(
            retry_dict,
            C.RESILIENCE_RETRY_BACKOFF_BASE,
            C.RESILIENCE_RETRY_BACKOFF_BASE_DEFAULT,
        )
        self.resilience_retry_backoff_max = get_scalar_param(
            retry_dict,
            C.RESILIENCE_RETRY_BACKOFF_MAX,
            C.RESILIENCE_RETRY_BACKOFF_MAX_DEFAULT,
        )
        self.resilience_retry_jitter = get_scalar_param(
            retry_dict,
            C.RESILIENCE_RETRY_JITTER,
            C.RESILIENCE_RETRY_JITTER_DEFAULT,
        )
        pre_dict = get_dict_param(res_dict, C.RESILIENCE_PREEMPTION)
        self.resilience_preemption_enabled = get_scalar_param(
            pre_dict,
            C.RESILIENCE_PREEMPTION_ENABLED,
            C.RESILIENCE_PREEMPTION_ENABLED_DEFAULT,
        )
        signals = pre_dict.get(
            C.RESILIENCE_PREEMPTION_SIGNALS,
            C.RESILIENCE_PREEMPTION_SIGNALS_DEFAULT,
        )
        # keep non-list values (a bare "SIGTERM" would list() into
        # characters) for _check_resilience to reject with a config error
        self.resilience_preemption_signals = (
            list(signals) if isinstance(signals, (list, tuple)) else signals
        )
        self.resilience_preemption_save_dir = get_scalar_param(
            pre_dict,
            C.RESILIENCE_PREEMPTION_SAVE_DIR,
            C.RESILIENCE_PREEMPTION_SAVE_DIR_DEFAULT,
        )
        self.resilience_preemption_tag_prefix = get_scalar_param(
            pre_dict,
            C.RESILIENCE_PREEMPTION_TAG_PREFIX,
            C.RESILIENCE_PREEMPTION_TAG_PREFIX_DEFAULT,
        )
        self.resilience_preemption_exit_after_save = get_scalar_param(
            pre_dict,
            C.RESILIENCE_PREEMPTION_EXIT_AFTER_SAVE,
            C.RESILIENCE_PREEMPTION_EXIT_AFTER_SAVE_DEFAULT,
        )
        fi_dict = get_dict_param(res_dict, C.RESILIENCE_FAULT_INJECTION)
        self.resilience_fault_injection_enabled = get_scalar_param(
            fi_dict,
            C.RESILIENCE_FAULT_INJECTION_ENABLED,
            C.RESILIENCE_FAULT_INJECTION_ENABLED_DEFAULT,
        )
        self.resilience_fault_injection_seed = get_scalar_param(
            fi_dict,
            C.RESILIENCE_FAULT_INJECTION_SEED,
            C.RESILIENCE_FAULT_INJECTION_SEED_DEFAULT,
        )
        faults = fi_dict.get(
            C.RESILIENCE_FAULT_INJECTION_FAULTS,
            C.RESILIENCE_FAULT_INJECTION_FAULTS_DEFAULT,
        )
        # keep non-list values for _check_resilience to reject loudly
        self.resilience_fault_injection_faults = (
            list(faults) if isinstance(faults, (list, tuple)) else faults
        )
        sup_dict = get_dict_param(res_dict, C.RESILIENCE_SUPERVISOR)
        self.resilience_supervisor_enabled = get_scalar_param(
            sup_dict,
            C.RESILIENCE_SUPERVISOR_ENABLED,
            C.RESILIENCE_SUPERVISOR_ENABLED_DEFAULT,
        )
        self.resilience_supervisor_max_rollbacks = get_scalar_param(
            sup_dict,
            C.RESILIENCE_SUPERVISOR_MAX_ROLLBACKS,
            C.RESILIENCE_SUPERVISOR_MAX_ROLLBACKS_DEFAULT,
        )
        self.resilience_supervisor_nonfinite_window = get_scalar_param(
            sup_dict,
            C.RESILIENCE_SUPERVISOR_NONFINITE_WINDOW,
            C.RESILIENCE_SUPERVISOR_NONFINITE_WINDOW_DEFAULT,
        )
        self.resilience_supervisor_spike_factor = get_scalar_param(
            sup_dict,
            C.RESILIENCE_SUPERVISOR_SPIKE_FACTOR,
            C.RESILIENCE_SUPERVISOR_SPIKE_FACTOR_DEFAULT,
        )
        self.resilience_supervisor_spike_window = get_scalar_param(
            sup_dict,
            C.RESILIENCE_SUPERVISOR_SPIKE_WINDOW,
            C.RESILIENCE_SUPERVISOR_SPIKE_WINDOW_DEFAULT,
        )
        self.resilience_supervisor_min_history = get_scalar_param(
            sup_dict,
            C.RESILIENCE_SUPERVISOR_MIN_HISTORY,
            C.RESILIENCE_SUPERVISOR_MIN_HISTORY_DEFAULT,
        )

    def _initialize_data_pipeline(self, pd):
        """The ``data_pipeline`` block (runtime/staging.py) and the
        ``compile_cache`` block (runtime/compile_cache.py), as the JAX
        parser reads them."""
        dp_dict = get_dict_param(pd, C.DATA_PIPELINE)
        self.data_pipeline_enabled = get_scalar_param(
            dp_dict, C.DATA_PIPELINE_ENABLED, C.DATA_PIPELINE_ENABLED_DEFAULT
        )
        self.data_pipeline_staging_buffers = get_scalar_param(
            dp_dict,
            C.DATA_PIPELINE_STAGING_BUFFERS,
            C.DATA_PIPELINE_STAGING_BUFFERS_DEFAULT,
        )
        self.data_pipeline_stage_to_device = get_scalar_param(
            dp_dict,
            C.DATA_PIPELINE_STAGE_TO_DEVICE,
            C.DATA_PIPELINE_STAGE_TO_DEVICE_DEFAULT,
        )
        cc_dict = get_dict_param(pd, C.COMPILE_CACHE)
        self.compile_cache_enabled = get_scalar_param(
            cc_dict, C.COMPILE_CACHE_ENABLED, C.COMPILE_CACHE_ENABLED_DEFAULT
        )
        self.compile_cache_dir = get_scalar_param(
            cc_dict, C.COMPILE_CACHE_DIR, C.COMPILE_CACHE_DIR_DEFAULT
        )
        self.compile_cache_min_compile_time_secs = get_scalar_param(
            cc_dict,
            C.COMPILE_CACHE_MIN_COMPILE_SECS,
            C.COMPILE_CACHE_MIN_COMPILE_SECS_DEFAULT,
        )

    def _initialize_observability(self, pd):
        """The timers (``wall_clock_breakdown``), ``memory_breakdown``,
        the monitor (``tensorboard``) and the ``telemetry`` block, as the
        JAX parser reads them."""
        self.wall_clock_breakdown = get_scalar_param(
            pd, C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT
        )
        self.memory_breakdown = get_scalar_param(
            pd, C.MEMORY_BREAKDOWN, C.MEMORY_BREAKDOWN_DEFAULT
        )
        tb_dict = get_dict_param(pd, C.TENSORBOARD)
        self.tensorboard_enabled = get_scalar_param(
            tb_dict, C.TENSORBOARD_ENABLED, C.TENSORBOARD_ENABLED_DEFAULT
        )
        self.tensorboard_output_path = get_scalar_param(
            tb_dict, C.TENSORBOARD_OUTPUT_PATH, C.TENSORBOARD_OUTPUT_PATH_DEFAULT
        )
        self.tensorboard_job_name = get_scalar_param(
            tb_dict, C.TENSORBOARD_JOB_NAME, C.TENSORBOARD_JOB_NAME_DEFAULT
        )

        # telemetry block (telemetry/, docs/observability.md)
        tel_dict = get_dict_param(pd, C.TELEMETRY)
        self.telemetry_enabled = get_scalar_param(
            tel_dict, C.TELEMETRY_ENABLED, C.TELEMETRY_ENABLED_DEFAULT
        )
        self.telemetry_output_path = get_scalar_param(
            tel_dict, C.TELEMETRY_OUTPUT_PATH, C.TELEMETRY_OUTPUT_PATH_DEFAULT
        )
        self.telemetry_job_name = get_scalar_param(
            tel_dict, C.TELEMETRY_JOB_NAME, C.TELEMETRY_JOB_NAME_DEFAULT
        )
        self.telemetry_interval = get_scalar_param(
            tel_dict, C.TELEMETRY_INTERVAL, C.TELEMETRY_INTERVAL_DEFAULT
        )
        # keep a non-list value (a bare string would list() into
        # characters, an int would TypeError) for _check_telemetry to
        # reject with a config error instead
        exporters = tel_dict.get(
            C.TELEMETRY_EXPORTERS, C.TELEMETRY_EXPORTERS_DEFAULT
        )
        self.telemetry_exporters = (
            list(exporters) if isinstance(exporters, (list, tuple))
            else exporters
        )
        self.telemetry_prometheus_path = get_scalar_param(
            tel_dict,
            C.TELEMETRY_PROMETHEUS_PATH,
            C.TELEMETRY_PROMETHEUS_PATH_DEFAULT,
        )
        profile_dict = get_dict_param(tel_dict, C.TELEMETRY_PROFILE)
        self.telemetry_profile_start_step = get_scalar_param(
            profile_dict,
            C.TELEMETRY_PROFILE_START_STEP,
            C.TELEMETRY_PROFILE_START_STEP_DEFAULT,
        )
        self.telemetry_profile_num_steps = get_scalar_param(
            profile_dict,
            C.TELEMETRY_PROFILE_NUM_STEPS,
            C.TELEMETRY_PROFILE_NUM_STEPS_DEFAULT,
        )
        self.telemetry_profile_output_path = get_scalar_param(
            profile_dict,
            C.TELEMETRY_PROFILE_OUTPUT_PATH,
            C.TELEMETRY_PROFILE_OUTPUT_PATH_DEFAULT,
        )
        watchdog_dict = get_dict_param(tel_dict, C.TELEMETRY_WATCHDOG)
        self.telemetry_watchdog_enabled = self.telemetry_enabled and get_scalar_param(
            watchdog_dict,
            C.TELEMETRY_WATCHDOG_ENABLED,
            C.TELEMETRY_WATCHDOG_ENABLED_DEFAULT,
        )
        self.telemetry_watchdog_timeout = get_scalar_param(
            watchdog_dict,
            C.TELEMETRY_WATCHDOG_TIMEOUT,
            C.TELEMETRY_WATCHDOG_TIMEOUT_DEFAULT,
        )
        self.telemetry_watchdog_poll_interval = get_scalar_param(
            watchdog_dict,
            C.TELEMETRY_WATCHDOG_POLL_INTERVAL,
            C.TELEMETRY_WATCHDOG_POLL_INTERVAL_DEFAULT,
        )
        # tracing sub-block (telemetry/tracing.py): request tracing +
        # flight recorder. Like the watchdog it rides the telemetry
        # master switch — tracing with no telemetry block is inert.
        tracing_dict = get_dict_param(tel_dict, C.TELEMETRY_TRACING)
        self._telemetry_tracing_keys = list(tracing_dict)
        self.telemetry_tracing_enabled = self.telemetry_enabled and (
            get_scalar_param(
                tracing_dict,
                C.TELEMETRY_TRACING_ENABLED,
                C.TELEMETRY_TRACING_ENABLED_DEFAULT,
            )
        )
        self.telemetry_tracing_sample_rate = get_scalar_param(
            tracing_dict,
            C.TELEMETRY_TRACING_SAMPLE_RATE,
            C.TELEMETRY_TRACING_SAMPLE_RATE_DEFAULT,
        )
        self.telemetry_tracing_ring_events = get_scalar_param(
            tracing_dict,
            C.TELEMETRY_TRACING_RING_EVENTS,
            C.TELEMETRY_TRACING_RING_EVENTS_DEFAULT,
        )
        self.telemetry_tracing_export = get_scalar_param(
            tracing_dict,
            C.TELEMETRY_TRACING_EXPORT,
            C.TELEMETRY_TRACING_EXPORT_DEFAULT,
        )

    def _initialize_training(self, pd):
        """The training blocks' keys, as the JAX parser reads them; the
        data_types values are checked here, as there."""
        self.train_batch_size = get_scalar_param(
            pd, C.TRAIN_BATCH_SIZE, C.TRAIN_BATCH_SIZE_DEFAULT
        )
        self.train_micro_batch_size_per_gpu = get_scalar_param(
            pd, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT,
        )
        self.gradient_accumulation_steps = get_scalar_param(
            pd, C.GRADIENT_ACCUMULATION_STEPS,
            C.GRADIENT_ACCUMULATION_STEPS_DEFAULT,
        )
        self.steps_per_print = get_scalar_param(
            pd, C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT
        )
        self.sparse_gradients_enabled = get_scalar_param(
            pd, C.SPARSE_GRADIENTS, C.SPARSE_GRADIENTS_DEFAULT
        )
        self.gradient_clipping = get_scalar_param(
            pd, C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT
        )

        # zero_optimization: an object, or the deprecated boolean form
        # (true => stage 1)
        self.zero_config = DeepSpeedZeroConfig(pd)
        self.zero_optimization_stage = self.zero_config.stage
        stage = self.zero_optimization_stage
        self.zero_enabled = (
            isinstance(stage, int) and not isinstance(stage, bool) and stage > 0
        )
        self.zero_allow_untested_optimizer = get_scalar_param(
            pd, C.ZERO_ALLOW_UNTESTED_OPTIMIZER,
            C.ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT,
        )
        # the engine hands it to checkpointing.configure (remat itself is
        # the model's remat / remat_policy)
        self.activation_checkpointing_config = (
            DeepSpeedActivationCheckpointingConfig(pd)
        )

        fp16_dict = get_dict_param(pd, C.FP16)
        self.fp16_enabled = get_scalar_param(
            fp16_dict, C.FP16_ENABLED, C.FP16_ENABLED_DEFAULT
        )
        self.loss_scale = get_scalar_param(
            fp16_dict, C.FP16_LOSS_SCALE, C.FP16_LOSS_SCALE_DEFAULT
        )
        self.initial_scale_power = get_scalar_param(
            fp16_dict, C.FP16_INITIAL_SCALE_POWER,
            C.FP16_INITIAL_SCALE_POWER_DEFAULT,
        )
        self.loss_scale_window = get_scalar_param(
            fp16_dict, C.FP16_LOSS_SCALE_WINDOW,
            C.FP16_LOSS_SCALE_WINDOW_DEFAULT,
        )
        self.hysteresis = get_scalar_param(
            fp16_dict, C.FP16_HYSTERESIS, C.FP16_HYSTERESIS_DEFAULT
        )
        self.min_loss_scale = get_scalar_param(
            fp16_dict, C.FP16_MIN_LOSS_SCALE, C.FP16_MIN_LOSS_SCALE_DEFAULT
        )
        self.dynamic_loss_scale = self.loss_scale == 0
        self.bf16_enabled = get_scalar_param(
            get_dict_param(pd, C.BF16), C.BF16_ENABLED, C.BF16_ENABLED_DEFAULT
        )

        dt_dict = get_dict_param(pd, C.DATA_TYPES)
        self.grad_accum_dtype = get_scalar_param(
            dt_dict, C.GRAD_ACCUM_DTYPE, C.GRAD_ACCUM_DTYPE_DEFAULT
        )
        if self.grad_accum_dtype not in ("fp32", "bf16", "fp16"):
            raise DeepSpeedConfigError(
                f"{C.GRAD_ACCUM_DTYPE} must be one of fp32/bf16/fp16, got "
                f"{self.grad_accum_dtype!r}"
            )
        self.optimizer_state_dtype = get_scalar_param(
            dt_dict, C.OPTIMIZER_STATE_DTYPE, C.OPTIMIZER_STATE_DTYPE_DEFAULT
        )
        if self.optimizer_state_dtype not in ("fp32", "bf16", "int8"):
            raise DeepSpeedConfigError(
                f"{C.OPTIMIZER_STATE_DTYPE} must be one of fp32/bf16/int8, "
                f"got {self.optimizer_state_dtype!r}"
            )
        self.master_dtype = get_scalar_param(
            dt_dict, C.MASTER_DTYPE, C.MASTER_DTYPE_DEFAULT
        )
        if self.master_dtype not in ("fp32", "compensated"):
            raise DeepSpeedConfigError(
                f"{C.MASTER_DTYPE} must be 'fp32' or 'compensated', got "
                f"{self.master_dtype!r}"
            )

        optimizer_dict = get_dict_param(pd, C.OPTIMIZER)
        self.optimizer_name = optimizer_dict.get(C.TYPE)
        if isinstance(self.optimizer_name, str):
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = get_dict_param(
            optimizer_dict, C.OPTIMIZER_PARAMS
        )
        scheduler_dict = get_dict_param(pd, C.SCHEDULER)
        self.scheduler_name = scheduler_dict.get(C.TYPE)
        self.scheduler_params = get_dict_param(
            scheduler_dict, C.SCHEDULER_PARAMS
        )

    def _configure_batch_parameters(self):
        """The batch triangle (JAX config.py:_configure_batch_parameters):
        any two of train / micro / accum give the third, with
        train == micro * accum * world_size; the same errors."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        accum = self.gradient_accumulation_steps
        world = self.world_size
        if all(v is not None for v in (train, micro, accum)):
            pass  # verified below
        elif train is not None and micro is not None:
            accum, rem = divmod(train, micro * world)
            if rem != 0:
                raise DeepSpeedConfigError(
                    f"{C.TRAIN_BATCH_SIZE}={train} is not divisible by "
                    f"{C.TRAIN_MICRO_BATCH_SIZE_PER_GPU}={micro} * "
                    f"world_size={world}"
                )
        elif train is not None and accum is not None:
            micro, rem = divmod(train, accum * world)
            if rem != 0:
                raise DeepSpeedConfigError(
                    f"{C.TRAIN_BATCH_SIZE}={train} is not divisible by "
                    f"{C.GRADIENT_ACCUMULATION_STEPS}={accum} * "
                    f"world_size={world}"
                )
        elif micro is not None and accum is not None:
            train = micro * accum * world
        elif train is not None:
            accum = 1
            micro, rem = divmod(train, world)
            if rem != 0:
                raise DeepSpeedConfigError(
                    f"{C.TRAIN_BATCH_SIZE}={train} is not divisible by "
                    f"world_size={world}"
                )
        elif micro is not None:
            accum = 1
            train = micro * world
        else:
            raise DeepSpeedConfigError(
                f"At least one of {C.TRAIN_BATCH_SIZE} and "
                f"{C.TRAIN_MICRO_BATCH_SIZE_PER_GPU} must be set in the config"
            )
        if train <= 0:
            raise DeepSpeedConfigError(
                f"Train batch size {train} must be positive"
            )
        if micro <= 0:
            raise DeepSpeedConfigError(
                f"Micro batch size {micro} must be positive"
            )
        if accum <= 0:
            raise DeepSpeedConfigError(
                f"Gradient accumulation steps {accum} must be positive"
            )
        if train != micro * accum * world:
            raise DeepSpeedConfigError(
                f"Check batch-related parameters: {C.TRAIN_BATCH_SIZE}="
                f"{train} must equal {C.TRAIN_MICRO_BATCH_SIZE_PER_GPU}="
                f"{micro} * {C.GRADIENT_ACCUMULATION_STEPS}={accum} * "
                f"world_size={world}"
            )
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = accum

    def _check_training(self):
        """The JAX parser's error checks on the training blocks (ZeRO
        stage and keys, fp16 with bf16, the loss scale)."""
        self._check_zero()
        if self.fp16_enabled and self.bf16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        if self.loss_scale < 0:
            raise DeepSpeedConfigError(
                f"loss_scale must be >= 0, got {self.loss_scale}"
            )

    def _check_zero(self):
        """Validate the zero_optimization block. Every key must be known
        (a typo'd knob must not silently mean its default), the stage
        must be a real stage, and the stage-3 overlap knobs are REJECTED
        below stage 3 — a config that spells out stage-3 machinery while
        a typo'd stage leaves params replicated should fail at init, not
        train at the wrong memory profile."""
        zc = self.zero_config
        stage = self.zero_optimization_stage
        if (
            not isinstance(stage, int)
            or isinstance(stage, bool)
            or stage < 0
            or stage > C.MAX_STAGE_ZERO_OPTIMIZATION
        ):
            raise DeepSpeedConfigError(
                f"ZeRO stage {stage!r} not supported; stages are 0.."
                f"{C.MAX_STAGE_ZERO_OPTIMIZATION} "
                f"({C.MAX_STAGE_ZERO_OPTIMIZATION} = parameter "
                "partitioning)"
            )
        unknown = sorted(set(zc.explicit_keys) - set(C.ZERO_VALID_KEYS))
        if unknown:
            raise DeepSpeedConfigError(
                f"unknown {C.ZERO_OPTIMIZATION} key(s) {unknown}; valid: "
                f"{sorted(C.ZERO_VALID_KEYS)}"
            )
        stage3_set = [
            k for k in C.ZERO_STAGE3_ONLY_KEYS if k in zc.explicit_keys
        ]
        if stage3_set and stage < C.ZERO_OPTIMIZATION_WEIGHTS:
            raise DeepSpeedConfigError(
                f"{C.ZERO_OPTIMIZATION} key(s) {stage3_set} configure "
                f"stage-3 machinery but stage is {stage}; set "
                f'"{C.ZERO_STAGE}": {C.ZERO_OPTIMIZATION_WEIGHTS} or '
                "remove them"
            )
        gb = zc.stage3_gather_block
        if not isinstance(gb, int) or isinstance(gb, bool) or gb < 1:
            raise DeepSpeedConfigError(
                f"{C.ZERO_OPTIMIZATION}.{C.ZERO_STAGE3_GATHER_BLOCK} "
                f"must be an integer >= 1, got {gb!r}"
            )
        if not isinstance(zc.stage3_latency_hiding, bool):
            raise DeepSpeedConfigError(
                f"{C.ZERO_OPTIMIZATION}.{C.ZERO_STAGE3_LATENCY_HIDING} "
                f"must be a bool, got {zc.stage3_latency_hiding!r}"
            )

    def _check_telemetry(self):
        """Validate the telemetry block (like the tensorboard block, but
        with cross-field constraints worth failing loudly on)."""
        if not isinstance(self.telemetry_exporters, list) or not all(
            isinstance(e, str) for e in self.telemetry_exporters
        ):
            raise DeepSpeedConfigError(
                f"{C.TELEMETRY}.{C.TELEMETRY_EXPORTERS} must be a list of "
                f"strings, got {self.telemetry_exporters!r}"
            )
        for exporter in self.telemetry_exporters:
            if exporter not in C.TELEMETRY_VALID_EXPORTERS:
                raise DeepSpeedConfigError(
                    f"unknown telemetry exporter {exporter!r}; valid: "
                    f"{list(C.TELEMETRY_VALID_EXPORTERS)}"
                )
        if (
            not isinstance(self.telemetry_interval, int)
            or isinstance(self.telemetry_interval, bool)
            or self.telemetry_interval < 1
        ):
            raise DeepSpeedConfigError(
                f"{C.TELEMETRY}.{C.TELEMETRY_INTERVAL} must be an integer "
                f">= 1, got {self.telemetry_interval!r}"
            )
        # type-check numerics up front: a string like "600" would hit the
        # range comparisons below as a raw TypeError instead of a config
        # error naming the field
        for field, value, want_int in (
            (f"{C.TELEMETRY_PROFILE}.{C.TELEMETRY_PROFILE_START_STEP}",
             self.telemetry_profile_start_step, True),
            (f"{C.TELEMETRY_PROFILE}.{C.TELEMETRY_PROFILE_NUM_STEPS}",
             self.telemetry_profile_num_steps, True),
            (f"{C.TELEMETRY_WATCHDOG}.{C.TELEMETRY_WATCHDOG_TIMEOUT}",
             self.telemetry_watchdog_timeout, False),
            (f"{C.TELEMETRY_WATCHDOG}.{C.TELEMETRY_WATCHDOG_POLL_INTERVAL}",
             self.telemetry_watchdog_poll_interval, False),
        ):
            if value is None and not want_int:
                continue  # watchdog fields accept null (poll -> timeout/4)
            ok = (
                isinstance(value, int) if want_int
                else isinstance(value, (int, float))
            ) and not isinstance(value, bool)
            if not ok:
                raise DeepSpeedConfigError(
                    f"{C.TELEMETRY}.{field} must be "
                    f"{'an integer' if want_int else 'a number'}, "
                    f"got {value!r}"
                )
        if self.telemetry_profile_start_step < -1:
            raise DeepSpeedConfigError(
                f"{C.TELEMETRY}.{C.TELEMETRY_PROFILE}."
                f"{C.TELEMETRY_PROFILE_START_STEP} must be >= 0 (or -1 for "
                f"disabled), got {self.telemetry_profile_start_step}"
            )
        if (
            self.telemetry_profile_start_step >= 0
            and self.telemetry_profile_num_steps < 1
        ):
            raise DeepSpeedConfigError(
                f"{C.TELEMETRY}.{C.TELEMETRY_PROFILE}."
                f"{C.TELEMETRY_PROFILE_NUM_STEPS} must be >= 1 when a "
                f"profile window is armed, got "
                f"{self.telemetry_profile_num_steps}"
            )
        if self.telemetry_watchdog_enabled and not (
            self.telemetry_watchdog_timeout
            and self.telemetry_watchdog_timeout > 0
        ):
            raise DeepSpeedConfigError(
                f"{C.TELEMETRY}.{C.TELEMETRY_WATCHDOG}."
                f"{C.TELEMETRY_WATCHDOG_TIMEOUT} must be > 0 seconds, got "
                f"{self.telemetry_watchdog_timeout!r}"
            )
        if (
            self.telemetry_watchdog_poll_interval is not None
            and self.telemetry_watchdog_poll_interval <= 0
        ):
            raise DeepSpeedConfigError(
                f"{C.TELEMETRY}.{C.TELEMETRY_WATCHDOG}."
                f"{C.TELEMETRY_WATCHDOG_POLL_INTERVAL} must be > 0 seconds "
                f"(or null for timeout/4), got "
                f"{self.telemetry_watchdog_poll_interval!r}"
            )
        self._check_tracing()

    def _check_tracing(self):
        """Validate the telemetry.tracing sub-block (telemetry/tracing.py):
        a typo'd sample_rate must fail at init, not silently mean
        'sample everything'."""
        prefix = f"{C.TELEMETRY}.{C.TELEMETRY_TRACING}"
        known = (
            C.TELEMETRY_TRACING_ENABLED,
            C.TELEMETRY_TRACING_SAMPLE_RATE,
            C.TELEMETRY_TRACING_RING_EVENTS,
            C.TELEMETRY_TRACING_EXPORT,
        )
        unknown = [
            k for k in self._telemetry_tracing_keys if k not in known
        ]
        if unknown:
            raise DeepSpeedConfigError(
                f"unknown {prefix} key(s) {unknown}; valid: {list(known)}"
            )
        rate = self.telemetry_tracing_sample_rate
        if (
            not isinstance(rate, (int, float))
            or isinstance(rate, bool)
            or not 0.0 <= float(rate) <= 1.0
        ):
            raise DeepSpeedConfigError(
                f"{prefix}.{C.TELEMETRY_TRACING_SAMPLE_RATE} must be a "
                f"number within [0, 1], got {rate!r}"
            )
        ring = self.telemetry_tracing_ring_events
        if (
            not isinstance(ring, int)
            or isinstance(ring, bool)
            or ring < 1
        ):
            raise DeepSpeedConfigError(
                f"{prefix}.{C.TELEMETRY_TRACING_RING_EVENTS} must be an "
                f"integer >= 1, got {ring!r}"
            )
        if self.telemetry_tracing_export not in (
            C.TELEMETRY_TRACING_VALID_EXPORTS
        ):
            raise DeepSpeedConfigError(
                f"unknown {prefix}.{C.TELEMETRY_TRACING_EXPORT} "
                f"{self.telemetry_tracing_export!r}; valid: "
                f"{list(C.TELEMETRY_TRACING_VALID_EXPORTS)}"
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

    def _check_data_pipeline(self):
        """Validate the data_pipeline and compile_cache blocks: a typo'd
        buffer count or cache threshold must fail at init, not as a
        wedged staging thread / silently-disabled cache at step 1."""
        for field, value in (
            (f"{C.DATA_PIPELINE}.{C.DATA_PIPELINE_ENABLED}",
             self.data_pipeline_enabled),
            (f"{C.DATA_PIPELINE}.{C.DATA_PIPELINE_STAGE_TO_DEVICE}",
             self.data_pipeline_stage_to_device),
            (f"{C.COMPILE_CACHE}.{C.COMPILE_CACHE_ENABLED}",
             self.compile_cache_enabled),
        ):
            if not isinstance(value, bool):
                raise DeepSpeedConfigError(
                    f"{field} must be a boolean, got {value!r}"
                )
        if (
            not isinstance(self.data_pipeline_staging_buffers, int)
            or isinstance(self.data_pipeline_staging_buffers, bool)
            or self.data_pipeline_staging_buffers < 1
        ):
            raise DeepSpeedConfigError(
                f"{C.DATA_PIPELINE}.{C.DATA_PIPELINE_STAGING_BUFFERS} must "
                f"be an integer >= 1 (2 = double buffering), got "
                f"{self.data_pipeline_staging_buffers!r}"
            )
        if not isinstance(self.compile_cache_dir, str):
            raise DeepSpeedConfigError(
                f"{C.COMPILE_CACHE}.{C.COMPILE_CACHE_DIR} must be a path "
                f"string ('' for the default), got {self.compile_cache_dir!r}"
            )
        secs = self.compile_cache_min_compile_time_secs
        if (
            not isinstance(secs, (int, float))
            or isinstance(secs, bool)
            or secs < 0
        ):
            raise DeepSpeedConfigError(
                f"{C.COMPILE_CACHE}.{C.COMPILE_CACHE_MIN_COMPILE_SECS} must "
                f"be a number >= 0 seconds (0 caches everything), got "
                f"{secs!r}"
            )

    def _check_resilience(self):
        """Validate the resilience block (docs/resilience.md): a typo'd
        retry policy or an unknown signal name must fail at init, not at
        the first flaky write / first SIGTERM."""
        if (
            not isinstance(self.resilience_keep_last_n, int)
            or isinstance(self.resilience_keep_last_n, bool)
            or self.resilience_keep_last_n < 0
        ):
            raise DeepSpeedConfigError(
                f"{C.RESILIENCE}.{C.RESILIENCE_KEEP_LAST_N} must be an "
                f"integer >= 0 (0 keeps everything), got "
                f"{self.resilience_keep_last_n!r}"
            )
        if (
            not isinstance(self.resilience_retry_max_attempts, int)
            or isinstance(self.resilience_retry_max_attempts, bool)
            or self.resilience_retry_max_attempts < 1
        ):
            raise DeepSpeedConfigError(
                f"{C.RESILIENCE}.{C.RESILIENCE_RETRY}."
                f"{C.RESILIENCE_RETRY_MAX_ATTEMPTS} must be an integer >= 1 "
                f"(1 = no retries), got "
                f"{self.resilience_retry_max_attempts!r}"
            )
        for field, value in (
            (C.RESILIENCE_RETRY_BACKOFF_BASE, self.resilience_retry_backoff_base),
            (C.RESILIENCE_RETRY_BACKOFF_MAX, self.resilience_retry_backoff_max),
        ):
            if (
                not isinstance(value, (int, float))
                or isinstance(value, bool)
                or value <= 0
            ):
                raise DeepSpeedConfigError(
                    f"{C.RESILIENCE}.{C.RESILIENCE_RETRY}.{field} must be a "
                    f"number > 0 seconds, got {value!r}"
                )
        jitter = self.resilience_retry_jitter
        if (
            not isinstance(jitter, (int, float))
            or isinstance(jitter, bool)
            or not 0 <= jitter <= 1
        ):
            raise DeepSpeedConfigError(
                f"{C.RESILIENCE}.{C.RESILIENCE_RETRY}."
                f"{C.RESILIENCE_RETRY_JITTER} must be a number in [0, 1], "
                f"got {jitter!r}"
            )
        sigs = self.resilience_preemption_signals
        if not isinstance(sigs, list) or not sigs or not all(
            isinstance(s, str) for s in sigs
        ):
            raise DeepSpeedConfigError(
                f"{C.RESILIENCE}.{C.RESILIENCE_PREEMPTION}."
                f"{C.RESILIENCE_PREEMPTION_SIGNALS} must be a non-empty "
                f"list of signal names, got {sigs!r}"
            )
        import signal as _signal

        for name in sigs:
            if not isinstance(getattr(_signal, name, None), _signal.Signals):
                raise DeepSpeedConfigError(
                    f"{C.RESILIENCE}.{C.RESILIENCE_PREEMPTION}."
                    f"{C.RESILIENCE_PREEMPTION_SIGNALS}: unknown signal "
                    f"name {name!r}"
                )
        prefix = self.resilience_preemption_tag_prefix
        if (
            not isinstance(prefix, str)
            or not prefix
            or os.sep in prefix
            or prefix in (".", "..")
        ):
            raise DeepSpeedConfigError(
                f"{C.RESILIENCE}.{C.RESILIENCE_PREEMPTION}."
                f"{C.RESILIENCE_PREEMPTION_TAG_PREFIX} must be a non-empty "
                f"path-component-safe string, got {prefix!r}"
            )
        self._check_fault_injection()
        self._check_supervisor()

    def _check_fault_injection(self):
        """Validate the fault_injection sub-block: a typo'd site name must
        fail at init — a chaos run whose fault never fires reads as "the
        stack survived" when nothing was tested."""
        fi = f"{C.RESILIENCE}.{C.RESILIENCE_FAULT_INJECTION}"
        if not isinstance(self.resilience_fault_injection_enabled, bool):
            raise DeepSpeedConfigError(
                f"{fi}.{C.RESILIENCE_FAULT_INJECTION_ENABLED} must be a "
                f"boolean, got {self.resilience_fault_injection_enabled!r}"
            )
        seed = self.resilience_fault_injection_seed
        if not isinstance(seed, int) or isinstance(seed, bool):
            raise DeepSpeedConfigError(
                f"{fi}.{C.RESILIENCE_FAULT_INJECTION_SEED} must be an "
                f"integer, got {seed!r}"
            )
        faults = self.resilience_fault_injection_faults
        if not isinstance(faults, list):
            raise DeepSpeedConfigError(
                f"{fi}.{C.RESILIENCE_FAULT_INJECTION_FAULTS} must be a "
                f"list of fault entries, got {faults!r}"
            )
        if self.resilience_fault_injection_enabled and not faults:
            raise DeepSpeedConfigError(
                f"{fi} is enabled but {C.RESILIENCE_FAULT_INJECTION_FAULTS} "
                "is empty — arm at least one site or disable the block"
            )
        from ..resilience.faults import KNOWN_FAULT_SITES

        for i, f in enumerate(faults):
            where = f"{fi}.{C.RESILIENCE_FAULT_INJECTION_FAULTS}[{i}]"
            if not isinstance(f, dict):
                raise DeepSpeedConfigError(
                    f"{where} must be an object, got {f!r}"
                )
            site = f.get("site")
            if site not in KNOWN_FAULT_SITES:
                raise DeepSpeedConfigError(
                    f"{where}.site: unknown fault site {site!r}; valid "
                    f"sites: {sorted(KNOWN_FAULT_SITES)}"
                )
            for field, default, minimum in (
                ("times", 1, 0), ("after", 0, 0),
            ):
                v = f.get(field, default)
                if not isinstance(v, int) or isinstance(v, bool) or v < minimum:
                    raise DeepSpeedConfigError(
                        f"{where}.{field} must be an integer >= {minimum}, "
                        f"got {v!r}"
                    )
            prob = f.get("probability", 1.0)
            if (
                not isinstance(prob, (int, float))
                or isinstance(prob, bool)
                or not 0 <= prob <= 1
            ):
                raise DeepSpeedConfigError(
                    f"{where}.probability must be a number in [0, 1], got "
                    f"{prob!r}"
                )
            args = f.get("args", {})
            if not isinstance(args, dict):
                raise DeepSpeedConfigError(
                    f"{where}.args must be an object, got {args!r}"
                )
            if site in ("rpc.send", "rpc.recv"):
                from ..resilience.faults import RPC_FAULT_MODES

                mode = args.get("mode", "drop")
                if mode not in RPC_FAULT_MODES:
                    # a typo'd mode must not silently mean "drop"
                    raise DeepSpeedConfigError(
                        f"{where}.args.mode must be one of "
                        f"{list(RPC_FAULT_MODES)}, got {mode!r}"
                    )

    def _check_supervisor(self):
        """Validate the supervisor sub-block: a negative retry budget or a
        zero detector window must fail at init, not as a supervisor that
        escalates on its first window."""
        sup = f"{C.RESILIENCE}.{C.RESILIENCE_SUPERVISOR}"
        if not isinstance(self.resilience_supervisor_enabled, bool):
            raise DeepSpeedConfigError(
                f"{sup}.{C.RESILIENCE_SUPERVISOR_ENABLED} must be a "
                f"boolean, got {self.resilience_supervisor_enabled!r}"
            )
        for field, value, minimum in (
            (C.RESILIENCE_SUPERVISOR_MAX_ROLLBACKS,
             self.resilience_supervisor_max_rollbacks, 0),
            (C.RESILIENCE_SUPERVISOR_NONFINITE_WINDOW,
             self.resilience_supervisor_nonfinite_window, 1),
            (C.RESILIENCE_SUPERVISOR_SPIKE_WINDOW,
             self.resilience_supervisor_spike_window, 2),
            (C.RESILIENCE_SUPERVISOR_MIN_HISTORY,
             self.resilience_supervisor_min_history, 1),
        ):
            if (
                not isinstance(value, int)
                or isinstance(value, bool)
                or value < minimum
            ):
                raise DeepSpeedConfigError(
                    f"{sup}.{field} must be an integer >= {minimum}, got "
                    f"{value!r}"
                )
        spike = self.resilience_supervisor_spike_factor
        if (
            not isinstance(spike, (int, float))
            or isinstance(spike, bool)
            or spike < 0
        ):
            raise DeepSpeedConfigError(
                f"{sup}.{C.RESILIENCE_SUPERVISOR_SPIKE_FACTOR} must be a "
                f"number >= 0 (0 disables spike detection), got {spike!r}"
            )

    def _check_adapters(self):
        """Validate the adapters block (docs/adapters.md): a typo'd
        target name or a zero rank must fail at initialize()/
        init_inference(), not as a partially-adapted model that silently
        trains or serves the wrong matrices."""
        ad = C.ADAPTERS
        if not isinstance(self.adapters_enabled, bool):
            raise DeepSpeedConfigError(
                f"{ad}.{C.ADAPTERS_ENABLED} must be a boolean, got "
                f"{self.adapters_enabled!r}"
            )
        rank = self.adapters_rank
        if not isinstance(rank, int) or isinstance(rank, bool) or rank < 1:
            raise DeepSpeedConfigError(
                f"{ad}.{C.ADAPTERS_RANK} must be an integer >= 1, got "
                f"{rank!r}"
            )
        alpha = self.adapters_alpha
        if (
            not isinstance(alpha, (int, float))
            or isinstance(alpha, bool)
            or alpha < 0
        ):
            raise DeepSpeedConfigError(
                f"{ad}.{C.ADAPTERS_ALPHA} must be a number >= 0 "
                f"(0 = rank, scaling 1.0), got {alpha!r}"
            )
        targets = self.adapters_targets
        if targets is not None:
            from ..ops.transformer import LORA_TARGETS

            if (
                not isinstance(targets, list)
                or not targets
                or not all(isinstance(t, str) for t in targets)
            ):
                raise DeepSpeedConfigError(
                    f"{ad}.{C.ADAPTERS_TARGETS} must be a non-empty list "
                    f"of projection names or null (null = all of "
                    f"{list(LORA_TARGETS)}), got {targets!r}"
                )
            unknown = [t for t in targets if t not in LORA_TARGETS]
            if unknown:
                raise DeepSpeedConfigError(
                    f"{ad}.{C.ADAPTERS_TARGETS}: unknown target(s) "
                    f"{unknown}; valid: {list(LORA_TARGETS)}"
                )
            if len(set(targets)) != len(targets):
                raise DeepSpeedConfigError(
                    f"{ad}.{C.ADAPTERS_TARGETS}: duplicate targets in "
                    f"{targets}"
                )
        slots = self.adapters_pool_slots
        if not isinstance(slots, int) or isinstance(slots, bool) or slots < 1:
            raise DeepSpeedConfigError(
                f"{ad}.{C.ADAPTERS_POOL_SLOTS} must be an integer >= 1 "
                f"loadable adapters, got {slots!r}"
            )

    def _check_serving(self):
        """Validate the serving block (docs/serving.md): a typo'd backend
        or a capacity floor no rolling restart can satisfy must fail at
        init_fleet(), not mid-restart with live traffic on the fleet."""
        replicas = self.serving_replicas
        if (
            not isinstance(replicas, int)
            or isinstance(replicas, bool)
            or replicas < 1
        ):
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_REPLICAS} must be an integer >= 1, "
                f"got {replicas!r}"
            )
        if self.serving_backend not in C.SERVING_VALID_BACKENDS:
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_BACKEND} must be one of "
                f"{list(C.SERVING_VALID_BACKENDS)}, got "
                f"{self.serving_backend!r}"
            )
        if self.serving_placement not in C.SERVING_VALID_PLACEMENTS:
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_PLACEMENT} must be one of "
                f"{list(C.SERVING_VALID_PLACEMENTS)}, got "
                f"{self.serving_placement!r}"
            )
        affinity = self.serving_affinity_prefix_tokens
        if (
            not isinstance(affinity, int)
            or isinstance(affinity, bool)
            or affinity < 1
        ):
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_AFFINITY_PREFIX_TOKENS} must be an "
                f"integer >= 1, got {affinity!r}"
            )
        floor = self.serving_capacity_floor
        if (
            not isinstance(floor, (int, float))
            or isinstance(floor, bool)
            or not 0 <= floor < 1
        ):
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_CAPACITY_FLOOR} must be a number "
                f"in [0, 1) — the fraction of replicas that must stay "
                f"routable (< 1, or no replica could ever drain), got "
                f"{floor!r}"
            )
        shed = self.serving_shed_queue_ratio
        if (
            not isinstance(shed, (int, float))
            or isinstance(shed, bool)
            or not 0 < shed <= 1
        ):
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_SHED_QUEUE_RATIO} must be a number "
                f"in (0, 1], got {shed!r}"
            )
        reroutes = self.serving_max_reroutes
        if (
            not isinstance(reroutes, int)
            or isinstance(reroutes, bool)
            or reroutes < 0
        ):
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_MAX_REROUTES} must be an integer "
                f">= 0 (0 = fail a request with its replica), got "
                f"{reroutes!r}"
            )
        if not isinstance(self.serving_drain_on_preemption, bool):
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_DRAIN_ON_PREEMPTION} must be a "
                f"boolean, got {self.serving_drain_on_preemption!r}"
            )
        rl = f"{C.SERVING}.{C.SERVING_RATE_LIMIT}"
        rl_dict = get_dict_param(
            get_dict_param(self._param_dict, C.SERVING), C.SERVING_RATE_LIMIT
        )
        unknown = set(rl_dict) - {
            C.SERVING_RATE_LIMIT_RPS, C.SERVING_RATE_LIMIT_BURST,
            C.SERVING_RATE_LIMIT_PER_TENANT,
        }
        if unknown:
            # a typo'd requests_per_sec would otherwise mean "unlimited"
            # in production — the exact silent misconfiguration this
            # validator exists to catch
            raise DeepSpeedConfigError(
                f"{rl}: unknown keys {sorted(unknown)}; valid: "
                f"['{C.SERVING_RATE_LIMIT_BURST}', "
                f"'{C.SERVING_RATE_LIMIT_PER_TENANT}', "
                f"'{C.SERVING_RATE_LIMIT_RPS}']"
            )
        if not isinstance(self.serving_rate_limit_per_tenant, dict):
            raise DeepSpeedConfigError(
                f"{rl}.{C.SERVING_RATE_LIMIT_PER_TENANT} must be an object "
                f"mapping tenant -> limits, got "
                f"{self.serving_rate_limit_per_tenant!r}"
            )
        limits = [(
            f"{rl}", self.serving_rate_limit_rps,
            self.serving_rate_limit_burst,
        )]
        for tenant, block in self.serving_rate_limit_per_tenant.items():
            where = f"{rl}.{C.SERVING_RATE_LIMIT_PER_TENANT}.{tenant}"
            if not isinstance(block, dict):
                raise DeepSpeedConfigError(
                    f"{where} must be an object, got {block!r}"
                )
            unknown = set(block) - {
                C.SERVING_RATE_LIMIT_RPS, C.SERVING_RATE_LIMIT_BURST,
            }
            if unknown:
                raise DeepSpeedConfigError(
                    f"{where}: unknown keys {sorted(unknown)}; valid: "
                    f"['{C.SERVING_RATE_LIMIT_BURST}', "
                    f"'{C.SERVING_RATE_LIMIT_RPS}']"
                )
            limits.append((
                where,
                block.get(C.SERVING_RATE_LIMIT_RPS,
                          self.serving_rate_limit_rps),
                block.get(C.SERVING_RATE_LIMIT_BURST,
                          self.serving_rate_limit_burst),
            ))
        for where, rps, burst in limits:
            if rps is not None and (
                not isinstance(rps, (int, float))
                or isinstance(rps, bool)
                or rps <= 0
            ):
                raise DeepSpeedConfigError(
                    f"{where}.{C.SERVING_RATE_LIMIT_RPS} must be a number "
                    f"> 0 or null (null = unlimited), got {rps!r}"
                )
            if (
                not isinstance(burst, int)
                or isinstance(burst, bool)
                or burst < 1
            ):
                raise DeepSpeedConfigError(
                    f"{where}.{C.SERVING_RATE_LIMIT_BURST} must be an "
                    f"integer >= 1, got {burst!r}"
                )
        for key, value in (
            (C.SERVING_RPC_TIMEOUT_SECS, self.serving_rpc_timeout_secs),
            (C.SERVING_RPC_BACKOFF_SECS, self.serving_rpc_backoff_secs),
        ):
            if (
                not isinstance(value, (int, float))
                or isinstance(value, bool)
                or value <= 0
            ):
                raise DeepSpeedConfigError(
                    f"{C.SERVING}.{key} must be a number > 0, got {value!r}"
                )
        retries = self.serving_rpc_retries
        if not isinstance(retries, int) or isinstance(retries, bool) or (
            retries < 0
        ):
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_RPC_RETRIES} must be an integer "
                f">= 0 (0 = no retries), got {retries!r}"
            )
        zombie = self.serving_zombie_secs
        if (
            not isinstance(zombie, (int, float))
            or isinstance(zombie, bool)
            or zombie < 0
        ):
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_ZOMBIE_SECS} must be a number "
                f">= 0 (0 disables zombie detection), got {zombie!r}"
            )
        zbudget = self.serving_zombie_restart_budget
        if not isinstance(zbudget, int) or isinstance(zbudget, bool) or (
            zbudget < 0
        ):
            raise DeepSpeedConfigError(
                f"{C.SERVING}.{C.SERVING_ZOMBIE_RESTART_BUDGET} must be "
                f"an integer >= 0 (0 = evict on first zombie detection), "
                f"got {zbudget!r}"
            )
        cb = f"{C.SERVING}.{C.SERVING_CIRCUIT_BREAKER}"
        cb_dict = get_dict_param(
            get_dict_param(self._param_dict, C.SERVING),
            C.SERVING_CIRCUIT_BREAKER,
        )
        unknown = set(cb_dict) - {
            C.SERVING_CB_FAILURE_THRESHOLD, C.SERVING_CB_BACKOFF_SECS,
            C.SERVING_CB_BACKOFF_MAX_SECS,
        }
        if unknown:
            raise DeepSpeedConfigError(
                f"{cb}: unknown keys {sorted(unknown)}; valid: "
                f"['{C.SERVING_CB_BACKOFF_MAX_SECS}', "
                f"'{C.SERVING_CB_BACKOFF_SECS}', "
                f"'{C.SERVING_CB_FAILURE_THRESHOLD}']"
            )
        threshold = self.serving_cb_failure_threshold
        if not isinstance(threshold, int) or isinstance(threshold, bool) or (
            threshold < 1
        ):
            raise DeepSpeedConfigError(
                f"{cb}.{C.SERVING_CB_FAILURE_THRESHOLD} must be an "
                f"integer >= 1, got {threshold!r}"
            )
        for key, value in (
            (C.SERVING_CB_BACKOFF_SECS, self.serving_cb_backoff_secs),
            (C.SERVING_CB_BACKOFF_MAX_SECS,
             self.serving_cb_backoff_max_secs),
        ):
            if (
                not isinstance(value, (int, float))
                or isinstance(value, bool)
                or value <= 0
            ):
                raise DeepSpeedConfigError(
                    f"{cb}.{key} must be a number > 0, got {value!r}"
                )
        if self.serving_cb_backoff_max_secs < self.serving_cb_backoff_secs:
            raise DeepSpeedConfigError(
                f"{cb}.{C.SERVING_CB_BACKOFF_MAX_SECS} "
                f"({self.serving_cb_backoff_max_secs!r}) must be >= "
                f"{C.SERVING_CB_BACKOFF_SECS} "
                f"({self.serving_cb_backoff_secs!r})"
            )
        bo = f"{C.SERVING}.{C.SERVING_BROWNOUT}"
        bo_dict = get_dict_param(
            get_dict_param(self._param_dict, C.SERVING), C.SERVING_BROWNOUT
        )
        unknown = set(bo_dict) - {
            C.SERVING_BROWNOUT_QUEUE_RATIO,
            C.SERVING_BROWNOUT_MAX_NEW_TOKENS,
        }
        if unknown:
            # a typo'd queue_ratio would silently mean "brownout off"
            raise DeepSpeedConfigError(
                f"{bo}: unknown keys {sorted(unknown)}; valid: "
                f"['{C.SERVING_BROWNOUT_MAX_NEW_TOKENS}', "
                f"'{C.SERVING_BROWNOUT_QUEUE_RATIO}']"
            )
        ratio = self.serving_brownout_queue_ratio
        if ratio is not None:
            if (
                not isinstance(ratio, (int, float))
                or isinstance(ratio, bool)
                or not 0 < ratio < 1
            ):
                raise DeepSpeedConfigError(
                    f"{bo}.{C.SERVING_BROWNOUT_QUEUE_RATIO} must be a "
                    f"number in (0, 1) or null (null = brownout off), "
                    f"got {ratio!r}"
                )
            if ratio >= self.serving_shed_queue_ratio:
                # the brownout band sits BELOW the shed cliff; an
                # inverted pair would be a brownout that can never engage
                # before rejection does
                raise DeepSpeedConfigError(
                    f"{bo}.{C.SERVING_BROWNOUT_QUEUE_RATIO} ({ratio!r}) "
                    f"must be below {C.SERVING}."
                    f"{C.SERVING_SHED_QUEUE_RATIO} "
                    f"({self.serving_shed_queue_ratio!r}) — degradation "
                    f"engages before the rejection cliff"
                )
        floor = self.serving_brownout_max_new_tokens
        if not isinstance(floor, int) or isinstance(floor, bool) or (
            floor < 1
        ):
            raise DeepSpeedConfigError(
                f"{bo}.{C.SERVING_BROWNOUT_MAX_NEW_TOKENS} must be an "
                f"integer >= 1, got {floor!r}"
            )
        sk = f"{C.SERVING}.{C.SERVING_SOCKET}"
        sock_dict = get_dict_param(
            get_dict_param(self._param_dict, C.SERVING), C.SERVING_SOCKET
        )
        valid_sock = {
            C.SERVING_SOCKET_LEASE_SECS,
            C.SERVING_SOCKET_RECONNECT_ATTEMPTS,
            C.SERVING_SOCKET_RECONNECT_BACKOFF_SECS,
            C.SERVING_SOCKET_CONNECT_TIMEOUT_SECS,
            C.SERVING_SOCKET_CONNECT_RETRIES,
        }
        unknown = set(sock_dict) - valid_sock
        if unknown:
            # a typo'd lease_secs would silently mean "default lease"
            raise DeepSpeedConfigError(
                f"{sk}: unknown keys {sorted(unknown)}; valid: "
                f"{sorted(valid_sock)}"
            )
        for key, value in (
            (C.SERVING_SOCKET_LEASE_SECS, self.serving_socket_lease_secs),
            (C.SERVING_SOCKET_RECONNECT_BACKOFF_SECS,
             self.serving_socket_reconnect_backoff_secs),
            (C.SERVING_SOCKET_CONNECT_TIMEOUT_SECS,
             self.serving_socket_connect_timeout_secs),
        ):
            if (
                not isinstance(value, (int, float))
                or isinstance(value, bool)
                or value <= 0
            ):
                raise DeepSpeedConfigError(
                    f"{sk}.{key} must be a number > 0, got {value!r}"
                )
        for key, value, floor_v in (
            (C.SERVING_SOCKET_RECONNECT_ATTEMPTS,
             self.serving_socket_reconnect_attempts, 0),
            (C.SERVING_SOCKET_CONNECT_RETRIES,
             self.serving_socket_connect_retries, 1),
        ):
            if not isinstance(value, int) or isinstance(value, bool) or (
                value < floor_v
            ):
                raise DeepSpeedConfigError(
                    f"{sk}.{key} must be an integer >= {floor_v}, got "
                    f"{value!r}"
                )
        ht = f"{C.SERVING}.{C.SERVING_HTTP}"
        http_dict = get_dict_param(
            get_dict_param(self._param_dict, C.SERVING), C.SERVING_HTTP
        )
        valid_http = {
            C.SERVING_HTTP_HOST, C.SERVING_HTTP_PORT,
            C.SERVING_HTTP_MAX_BUFFER_BYTES, C.SERVING_HTTP_OVERRUN_POLICY,
            C.SERVING_HTTP_AUTH_TOKEN,
        }
        unknown = set(http_dict) - valid_http
        if unknown:
            raise DeepSpeedConfigError(
                f"{ht}: unknown keys {sorted(unknown)}; valid: "
                f"{sorted(valid_http)}"
            )
        if not isinstance(self.serving_http_host, str):
            raise DeepSpeedConfigError(
                f"{ht}.{C.SERVING_HTTP_HOST} must be a string, got "
                f"{self.serving_http_host!r}"
            )
        port = self.serving_http_port
        if not isinstance(port, int) or isinstance(port, bool) or (
            not 0 <= port <= 65535
        ):
            raise DeepSpeedConfigError(
                f"{ht}.{C.SERVING_HTTP_PORT} must be an integer in "
                f"[0, 65535] (0 = ephemeral), got {port!r}"
            )
        buf = self.serving_http_max_buffer_bytes
        if not isinstance(buf, int) or isinstance(buf, bool) or buf < 1024:
            raise DeepSpeedConfigError(
                f"{ht}.{C.SERVING_HTTP_MAX_BUFFER_BYTES} must be an "
                f"integer >= 1024 (one SSE event must fit), got {buf!r}"
            )
        if (
            self.serving_http_overrun_policy
            not in C.SERVING_HTTP_VALID_OVERRUN_POLICIES
        ):
            raise DeepSpeedConfigError(
                f"{ht}.{C.SERVING_HTTP_OVERRUN_POLICY} must be one of "
                f"{C.SERVING_HTTP_VALID_OVERRUN_POLICIES}, got "
                f"{self.serving_http_overrun_policy!r}"
            )
        token = self._serving_http_auth_token
        if token is not None and (
            not isinstance(token, str) or not token
        ):
            # the VALUE is deliberately absent from this message — a
            # config error must not leak the secret into logs either
            raise DeepSpeedConfigError(
                f"{ht}.{C.SERVING_HTTP_AUTH_TOKEN} must be a non-empty "
                f"string or null (null = open door)"
            )
        sl = f"{C.SERVING}.{C.SERVING_SLO}"
        slo_dict = get_dict_param(
            get_dict_param(self._param_dict, C.SERVING), C.SERVING_SLO
        )
        valid_slo = {
            C.SERVING_SLO_TTFT_P99_MS, C.SERVING_SLO_TOKEN_P99_MS,
            C.SERVING_SLO_EVAL_WINDOW_SECS,
        }
        unknown = set(slo_dict) - valid_slo
        if unknown:
            # a typo'd ttft_p99_ms would silently mean "no TTFT SLO"
            raise DeepSpeedConfigError(
                f"{sl}: unknown keys {sorted(unknown)}; valid: "
                f"{sorted(valid_slo)}"
            )
        for key, value in (
            (C.SERVING_SLO_TTFT_P99_MS, self.serving_slo_ttft_p99_ms),
            (C.SERVING_SLO_TOKEN_P99_MS, self.serving_slo_token_p99_ms),
        ):
            if value is not None and (
                not isinstance(value, (int, float))
                or isinstance(value, bool)
                or value <= 0
            ):
                raise DeepSpeedConfigError(
                    f"{sl}.{key} must be a number > 0 or null (null = "
                    f"no target on that axis), got {value!r}"
                )
        window = self.serving_slo_eval_window_secs
        if (
            not isinstance(window, (int, float))
            or isinstance(window, bool)
            or window <= 0
        ):
            raise DeepSpeedConfigError(
                f"{sl}.{C.SERVING_SLO_EVAL_WINDOW_SECS} must be a number "
                f"> 0, got {window!r}"
            )
        asc = f"{C.SERVING}.{C.SERVING_AUTOSCALE}"
        asc_dict = get_dict_param(
            get_dict_param(self._param_dict, C.SERVING), C.SERVING_AUTOSCALE
        )
        valid_asc = {
            C.SERVING_AUTOSCALE_ENABLED, C.SERVING_AUTOSCALE_MIN_REPLICAS,
            C.SERVING_AUTOSCALE_MAX_REPLICAS,
            C.SERVING_AUTOSCALE_COOLDOWN_SECS,
            C.SERVING_AUTOSCALE_HYSTERESIS_SECS,
            C.SERVING_AUTOSCALE_FLAP_BUDGET,
            C.SERVING_AUTOSCALE_FLAP_WINDOW_SECS,
            C.SERVING_AUTOSCALE_UP_UTILIZATION,
            C.SERVING_AUTOSCALE_DOWN_UTILIZATION,
            C.SERVING_AUTOSCALE_INTERVAL_SECS,
            C.SERVING_AUTOSCALE_DRAIN_TIMEOUT_SECS,
        }
        unknown = set(asc_dict) - valid_asc
        if unknown:
            # a typo'd max_replicas must not silently mean its default
            raise DeepSpeedConfigError(
                f"{asc}: unknown keys {sorted(unknown)}; valid: "
                f"{sorted(valid_asc)}"
            )
        if not isinstance(self.serving_autoscale_enabled, bool):
            raise DeepSpeedConfigError(
                f"{asc}.{C.SERVING_AUTOSCALE_ENABLED} must be a boolean, "
                f"got {self.serving_autoscale_enabled!r}"
            )
        mn = self.serving_autoscale_min_replicas
        mx = self.serving_autoscale_max_replicas
        for key, value in (
            (C.SERVING_AUTOSCALE_MIN_REPLICAS, mn),
            (C.SERVING_AUTOSCALE_MAX_REPLICAS, mx),
        ):
            if not isinstance(value, int) or isinstance(value, bool) or (
                value < 1
            ):
                raise DeepSpeedConfigError(
                    f"{asc}.{key} must be an integer >= 1, got {value!r}"
                )
        if mx < mn:
            raise DeepSpeedConfigError(
                f"{asc}.{C.SERVING_AUTOSCALE_MAX_REPLICAS} ({mx!r}) must "
                f"be >= {C.SERVING_AUTOSCALE_MIN_REPLICAS} ({mn!r})"
            )
        for key, value in (
            (C.SERVING_AUTOSCALE_COOLDOWN_SECS,
             self.serving_autoscale_cooldown_secs),
            (C.SERVING_AUTOSCALE_FLAP_WINDOW_SECS,
             self.serving_autoscale_flap_window_secs),
            (C.SERVING_AUTOSCALE_INTERVAL_SECS,
             self.serving_autoscale_interval_secs),
            (C.SERVING_AUTOSCALE_DRAIN_TIMEOUT_SECS,
             self.serving_autoscale_drain_timeout_secs),
        ):
            if (
                not isinstance(value, (int, float))
                or isinstance(value, bool)
                or value <= 0
            ):
                raise DeepSpeedConfigError(
                    f"{asc}.{key} must be a number > 0, got {value!r}"
                )
        hyst = self.serving_autoscale_hysteresis_secs
        if (
            not isinstance(hyst, (int, float))
            or isinstance(hyst, bool)
            or hyst < 0
        ):
            raise DeepSpeedConfigError(
                f"{asc}.{C.SERVING_AUTOSCALE_HYSTERESIS_SECS} must be a "
                f"number >= 0, got {hyst!r}"
            )
        flap = self.serving_autoscale_flap_budget
        if not isinstance(flap, int) or isinstance(flap, bool) or flap < 0:
            raise DeepSpeedConfigError(
                f"{asc}.{C.SERVING_AUTOSCALE_FLAP_BUDGET} must be an "
                f"integer >= 0 (0 = no direction reversals allowed "
                f"inside the window), got {flap!r}"
            )
        up = self.serving_autoscale_up_utilization
        down = self.serving_autoscale_down_utilization
        for key, value in (
            (C.SERVING_AUTOSCALE_UP_UTILIZATION, up),
            (C.SERVING_AUTOSCALE_DOWN_UTILIZATION, down),
        ):
            if (
                not isinstance(value, (int, float))
                or isinstance(value, bool)
                or not 0 < value <= 1
            ):
                raise DeepSpeedConfigError(
                    f"{asc}.{key} must be a number in (0, 1], got "
                    f"{value!r}"
                )
        if down >= up:
            # an inverted pair would oscillate on every tick: scale-down
            # headroom would begin inside the scale-up region
            raise DeepSpeedConfigError(
                f"{asc}.{C.SERVING_AUTOSCALE_DOWN_UTILIZATION} ({down!r}) "
                f"must be below {C.SERVING_AUTOSCALE_UP_UTILIZATION} "
                f"({up!r}) — the bands must not overlap"
            )
        hub = f"{C.SERVING}.{C.SERVING_HUB}"
        hub_dict = get_dict_param(
            get_dict_param(self._param_dict, C.SERVING), C.SERVING_HUB
        )
        valid_hub = {
            C.SERVING_HUB_ENABLED, C.SERVING_HUB_INTERVAL_SECS,
            C.SERVING_HUB_RETENTION_POINTS,
            C.SERVING_HUB_DRAIN_INTERVAL_SECS,
            C.SERVING_HUB_OP_TIMEOUT_SECS,
            C.SERVING_HUB_NODE_BACKOFF_SECS,
            C.SERVING_HUB_AUTH_EXEMPT, C.SERVING_HUB_ALERTS,
        }
        unknown = set(hub_dict) - valid_hub
        if unknown:
            raise DeepSpeedConfigError(
                f"{hub}: unknown keys {sorted(unknown)}; valid: "
                f"{sorted(valid_hub)}"
            )
        if not isinstance(self.serving_hub_enabled, bool):
            raise DeepSpeedConfigError(
                f"{hub}.{C.SERVING_HUB_ENABLED} must be a boolean, got "
                f"{self.serving_hub_enabled!r}"
            )
        for key, value in (
            (C.SERVING_HUB_INTERVAL_SECS, self.serving_hub_interval_secs),
            (C.SERVING_HUB_OP_TIMEOUT_SECS,
             self.serving_hub_op_timeout_secs),
        ):
            if (
                not isinstance(value, (int, float))
                or isinstance(value, bool)
                or value <= 0
            ):
                raise DeepSpeedConfigError(
                    f"{hub}.{key} must be a number > 0, got {value!r}"
                )
        for key, value in (
            (C.SERVING_HUB_DRAIN_INTERVAL_SECS,
             self.serving_hub_drain_interval_secs),
            (C.SERVING_HUB_NODE_BACKOFF_SECS,
             self.serving_hub_node_backoff_secs),
        ):
            # 0 is meaningful: drain on every tick / no scrape backoff
            if (
                not isinstance(value, (int, float))
                or isinstance(value, bool)
                or value < 0
            ):
                raise DeepSpeedConfigError(
                    f"{hub}.{key} must be a number >= 0, got {value!r}"
                )
        retention = self.serving_hub_retention_points
        if (
            not isinstance(retention, int) or isinstance(retention, bool)
            or retention < 2
        ):
            raise DeepSpeedConfigError(
                f"{hub}.{C.SERVING_HUB_RETENTION_POINTS} must be an "
                f"integer >= 2 (window queries need two points), got "
                f"{retention!r}"
            )
        exempt_raw = hub_dict.get(
            C.SERVING_HUB_AUTH_EXEMPT, C.SERVING_HUB_AUTH_EXEMPT_DEFAULT
        )
        if not isinstance(exempt_raw, (list, tuple)) or any(
            not isinstance(p, str) for p in exempt_raw
        ):
            raise DeepSpeedConfigError(
                f"{hub}.{C.SERVING_HUB_AUTH_EXEMPT} must be a list of "
                f"path strings, got {exempt_raw!r}"
            )
        bad = set(exempt_raw) - set(C.SERVING_HUB_VALID_AUTH_EXEMPT)
        if bad:
            # only hub-served paths may be exempted: a typo here must
            # not silently leave /v1/generate behind the token while the
            # operator believes it opened a metrics path
            raise DeepSpeedConfigError(
                f"{hub}.{C.SERVING_HUB_AUTH_EXEMPT}: unknown paths "
                f"{sorted(bad)}; valid: "
                f"{list(C.SERVING_HUB_VALID_AUTH_EXEMPT)}"
            )
        alerts = f"{hub}.{C.SERVING_HUB_ALERTS}"
        alerts_dict = get_dict_param(hub_dict, C.SERVING_HUB_ALERTS)
        valid_alerts = {
            C.SERVING_HUB_ALERTS_SLO_TARGET,
            C.SERVING_HUB_ALERTS_FAST_WINDOW_SECS,
            C.SERVING_HUB_ALERTS_SLOW_WINDOW_SECS,
            C.SERVING_HUB_ALERTS_FAST_BURN,
            C.SERVING_HUB_ALERTS_SLOW_BURN,
            C.SERVING_HUB_ALERTS_BREAKER_FLOOD,
            C.SERVING_HUB_ALERTS_SUPPRESSED_GROWTH,
        }
        unknown = set(alerts_dict) - valid_alerts
        if unknown:
            raise DeepSpeedConfigError(
                f"{alerts}: unknown keys {sorted(unknown)}; valid: "
                f"{sorted(valid_alerts)}"
            )
        target = self.serving_hub_alerts_slo_target
        if (
            not isinstance(target, (int, float))
            or isinstance(target, bool)
            or not 0 < target < 1
        ):
            raise DeepSpeedConfigError(
                f"{alerts}.{C.SERVING_HUB_ALERTS_SLO_TARGET} must be a "
                f"number in (0, 1), got {target!r}"
            )
        for key, value in (
            (C.SERVING_HUB_ALERTS_FAST_WINDOW_SECS,
             self.serving_hub_alerts_fast_window_secs),
            (C.SERVING_HUB_ALERTS_SLOW_WINDOW_SECS,
             self.serving_hub_alerts_slow_window_secs),
            (C.SERVING_HUB_ALERTS_FAST_BURN,
             self.serving_hub_alerts_fast_burn),
            (C.SERVING_HUB_ALERTS_SLOW_BURN,
             self.serving_hub_alerts_slow_burn),
            (C.SERVING_HUB_ALERTS_BREAKER_FLOOD,
             self.serving_hub_alerts_breaker_flood),
            (C.SERVING_HUB_ALERTS_SUPPRESSED_GROWTH,
             self.serving_hub_alerts_suppressed_growth),
        ):
            if (
                not isinstance(value, (int, float))
                or isinstance(value, bool)
                or value <= 0
            ):
                raise DeepSpeedConfigError(
                    f"{alerts}.{key} must be a number > 0, got {value!r}"
                )
        if (
            self.serving_hub_alerts_fast_window_secs
            >= self.serving_hub_alerts_slow_window_secs
        ):
            raise DeepSpeedConfigError(
                f"{alerts}.{C.SERVING_HUB_ALERTS_FAST_WINDOW_SECS} must "
                f"be below {C.SERVING_HUB_ALERTS_SLOW_WINDOW_SECS} — the "
                f"multiwindow burn rule needs a short and a long window"
            )
        jr = f"{C.SERVING}.{C.SERVING_JOURNAL}"
        jrn_dict = get_dict_param(
            get_dict_param(self._param_dict, C.SERVING), C.SERVING_JOURNAL
        )
        valid_jrn = {
            C.SERVING_JOURNAL_ENABLED, C.SERVING_JOURNAL_DIR,
            C.SERVING_JOURNAL_FSYNC, C.SERVING_JOURNAL_KEEP_SEGMENTS,
            C.SERVING_JOURNAL_MAX_INFLIGHT,
        }
        unknown = set(jrn_dict) - valid_jrn
        if unknown:
            # a typo'd enabled would silently mean "no durability" — the
            # operator learns only at the first router crash
            raise DeepSpeedConfigError(
                f"{jr}: unknown keys {sorted(unknown)}; valid: "
                f"{sorted(valid_jrn)}"
            )
        for key, value in (
            (C.SERVING_JOURNAL_ENABLED, self.serving_journal_enabled),
            (C.SERVING_JOURNAL_FSYNC, self.serving_journal_fsync),
        ):
            if not isinstance(value, bool):
                raise DeepSpeedConfigError(
                    f"{jr}.{key} must be a boolean, got {value!r}"
                )
        jdir = self.serving_journal_dir
        if not isinstance(jdir, str) or not jdir:
            raise DeepSpeedConfigError(
                f"{jr}.{C.SERVING_JOURNAL_DIR} must be a non-empty "
                f"directory path, got {jdir!r}"
            )
        for key, value in (
            (C.SERVING_JOURNAL_KEEP_SEGMENTS,
             self.serving_journal_keep_segments),
            (C.SERVING_JOURNAL_MAX_INFLIGHT,
             self.serving_journal_max_inflight),
        ):
            if (
                not isinstance(value, int) or isinstance(value, bool)
                or value < 1
            ):
                raise DeepSpeedConfigError(
                    f"{jr}.{key} must be an integer >= 1, got {value!r}"
                )
        pr = f"{C.SERVING}.{C.SERVING_PROVISIONER}"
        prov_dict = get_dict_param(
            get_dict_param(self._param_dict, C.SERVING),
            C.SERVING_PROVISIONER,
        )
        valid_prov = {
            C.SERVING_PROVISIONER_ENABLED,
            C.SERVING_PROVISIONER_NODE_SPEC,
            C.SERVING_PROVISIONER_MAX_NODES,
            C.SERVING_PROVISIONER_MAX_REPLICAS_PER_NODE,
            C.SERVING_PROVISIONER_LAUNCH_TIMEOUT_SECS,
            C.SERVING_PROVISIONER_TERMINATE_GRACE_SECS,
        }
        unknown = set(prov_dict) - valid_prov
        if unknown:
            raise DeepSpeedConfigError(
                f"{pr}: unknown keys {sorted(unknown)}; valid: "
                f"{sorted(valid_prov)}"
            )
        if not isinstance(self.serving_provisioner_enabled, bool):
            raise DeepSpeedConfigError(
                f"{pr}.{C.SERVING_PROVISIONER_ENABLED} must be a "
                f"boolean, got {self.serving_provisioner_enabled!r}"
            )
        spec = self.serving_provisioner_node_spec
        if spec is not None and not isinstance(spec, dict):
            raise DeepSpeedConfigError(
                f"{pr}.{C.SERVING_PROVISIONER_NODE_SPEC} must be a "
                f"node.py spec object (or null), got {spec!r}"
            )
        for key, value in (
            (C.SERVING_PROVISIONER_MAX_NODES,
             self.serving_provisioner_max_nodes),
            (C.SERVING_PROVISIONER_MAX_REPLICAS_PER_NODE,
             self.serving_provisioner_max_replicas_per_node),
        ):
            if (
                not isinstance(value, int) or isinstance(value, bool)
                or value < 1
            ):
                raise DeepSpeedConfigError(
                    f"{pr}.{key} must be an integer >= 1, got {value!r}"
                )
        for key, value in (
            (C.SERVING_PROVISIONER_LAUNCH_TIMEOUT_SECS,
             self.serving_provisioner_launch_timeout_secs),
            (C.SERVING_PROVISIONER_TERMINATE_GRACE_SECS,
             self.serving_provisioner_terminate_grace_secs),
        ):
            if (
                not isinstance(value, (int, float))
                or isinstance(value, bool) or value <= 0
            ):
                raise DeepSpeedConfigError(
                    f"{pr}.{key} must be a positive number, got {value!r}"
                )

    def _do_warning_check(self):
        if self.zero_enabled and not (self.fp16_enabled or self.bf16_enabled):
            # DeepSpeed hard-errored here (ZeRO required fp16); the JAX
            # package warns, and so does the port
            logger.warning(
                "ZeRO is enabled without fp16/bf16; proceeding with fp32 "
                "(the reference implementation required fp16 here)."
            )
        vocab_size = self._param_dict.get("vocabulary_size")
        if vocab_size is not None and vocab_size % 8 != 0:
            logger.warning(
                "vocabulary_size %d is not divisible by 8; pad for "
                "tensor-core-friendly matmul tiling",
                vocab_size,
            )
        if C.MAX_GRAD_NORM in self._param_dict:
            logger.warning(
                "max_grad_norm is deprecated; use gradient_clipping instead"
            )

    @property
    def serving_http_auth_token(self):
        """The door's bearer secret (``serving.http.auth_token``) —
        stored on an underscored attribute so :meth:`print`'s attribute
        walk (which skips ``_`` names) can never log it."""
        return self._serving_http_auth_token

    def print(self, name="DeepSpeedConfig"):
        logger.info("%s:", name)
        for key in sorted(self.__dict__):
            if key.startswith("_"):
                continue
            logger.info("  %s %s", f"{key} ".ljust(32, "."), self.__dict__[key])
