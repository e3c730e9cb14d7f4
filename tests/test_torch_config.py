"""Port parity: the port's inference-config parser against the JAX
package's DeepSpeedConfig — the same attributes for valid blocks and a
DeepSpeedConfigError for every block the JAX parser refuses (the blocks
of tests/unit/test_config.py's inference sections and a few more)."""

import pytest

from deepspeed_tpu.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.config import DeepSpeedConfigError as JConfigError
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError


def _both(block):
    raw = {"inference": block}
    # the JAX parser also resolves the training batch triangle
    return (
        JConfig(None, param_dict=dict(raw, train_batch_size=8), world_size=1),
        DeepSpeedConfig(None, param_dict=raw, world_size=1),
    )


def _inference_attrs(cfg):
    return {
        k: v for k, v in vars(cfg).items()
        if k.startswith("inference_")
    }


@pytest.mark.parametrize("block", [
    {},
    {"deadline_secs": 2.5, "driver_restart_budget": 3,
     "degraded_queue_ratio": 0.5},
    {"max_seq_len": 256, "kv_block_size": 32, "kv_pool_blocks": 40,
     "prefix_cache": {"enabled": True, "suffix_buckets": [16, 32, 64]}},
    {"max_seq_len": 256, "kv_block_size": 32, "fused_decode": True,
     "speculative": {"k": 6, "draft_checkpoint": "/ckpts/draft"}},
    {"max_seq_len": 256, "kv_block_size": 32, "speculative": {}},
    {"max_batch_slots": 8, "kv_block_size": 16, "fused_decode": True,
     "dtype": "bf16", "sampling": {"greedy": True}},
    {"sampling": {"temperature": 0.7, "top_k": 40, "top_p": 0.9},
     "eos_token_id": 50256, "queue_depth": 3, "queue_timeout_secs": 0.5},
])
def test_valid_blocks_parse_to_the_same_attributes(block):
    jcfg, tcfg = _both(block)
    want = _inference_attrs(jcfg)
    got = _inference_attrs(tcfg)
    assert got == want
    assert want  # the comparison saw the block's attributes


@pytest.mark.parametrize("block", [
    # self-healing keys (test_config.py)
    {"deadline_secs": 0}, {"deadline_secs": -1.0}, {"deadline_secs": "1s"},
    {"driver_restart_budget": -1}, {"driver_restart_budget": 1.5},
    {"driver_restart_budget": True}, {"degraded_queue_ratio": 0},
    {"degraded_queue_ratio": 1.2}, {"degraded_queue_ratio": "half"},
    # paged KV + prefix cache keys
    {"kv_block_size": -1}, {"kv_block_size": 16.0}, {"kv_block_size": True},
    {"kv_pool_blocks": -4}, {"kv_pool_blocks": "many"}, {"kv_pool_blocks": 8},
    {"max_seq_len": 100, "kv_block_size": 32},
    {"prefix_cache": {"enabled": True}},
    {"prefix_cache": {"suffix_buckets": [16]}},
    {"kv_block_size": 32, "max_seq_len": 64,
     "prefix_cache": {"enabled": "yes"}},
    {"kv_block_size": 32, "max_seq_len": 64,
     "prefix_cache": {"suffix_buckets": []}},
    {"kv_block_size": 32, "max_seq_len": 64,
     "prefix_cache": {"suffix_buckets": [64, 16]}},
    {"kv_block_size": 32, "max_seq_len": 64,
     "prefix_cache": {"suffix_buckets": [0, 16]}},
    # fused decode + speculative keys
    {"fused_decode": "yes"}, {"fused_decode": 1},
    {"fused_decode": True},  # fused decode without kv_block_size
    {"speculative": {}},
    {"max_seq_len": 256, "kv_block_size": 32, "speculative": {"k": 0}},
    {"max_seq_len": 256, "kv_block_size": 32, "speculative": {"kk": 4}},
    # geometry, sampling, queue
    {"max_seq_len": 64, "prefill_len": 128},  # prefill_len > max_seq_len
    {"max_batch_slots": 0}, {"max_seq_len": -1}, {"queue_depth": 0},
    {"dtype": "fp16"}, {"sampling": {"temperature": -1}},
    {"sampling": {"top_p": 0}}, {"sampling": {"greedy": "yes"}},
    {"checkpoint": {"load_dir": 3}},
    # host tier
    {"kv_block_size": 16, "host_tier": {"enabled": True, "lazy": True}},
    {"host_tier": {"enabled": True}},
    {"kv_block_size": 16, "host_tier": {"lazy_alloc": True}},
])
def test_both_parsers_refuse_the_same_blocks(block):
    with pytest.raises(JConfigError):
        JConfig(None, param_dict={"train_batch_size": 8, "inference": block},
                world_size=1)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(None, param_dict={"inference": block}, world_size=1)


def test_world_size_defaults_to_one_without_a_process_group():
    assert DeepSpeedConfig(None, param_dict={}).world_size == 1
