"""Port parity: the port's inference-config parser against the JAX
package's DeepSpeedConfig — the same attributes for valid blocks and a
DeepSpeedConfigError for every block the JAX parser refuses (the blocks
of tests/unit/test_config.py's inference sections and a few more)."""

import pytest

from deepspeed_tpu.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.config import DeepSpeedConfigError as JConfigError
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from torch_test_env import jax_compile_cache  # noqa: F401


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


# ---------------------------------------------------------------------------
# the training blocks this slice reads: zero_optimization, activation
# checkpointing, tensorboard, the breakdowns and telemetry (with tracing)
# ---------------------------------------------------------------------------
_OBSERVED = ("zero_", "activation_checkpointing", "tensorboard_",
             "telemetry_", "wall_clock_breakdown", "memory_breakdown")


def _training_both(extra):
    raw = dict({"train_batch_size": 8}, **extra)
    return (JConfig(None, param_dict=raw, world_size=1),
            DeepSpeedConfig(None, param_dict=raw, world_size=1,
                            training=True))


def _observed_attrs(cfg):
    out = {}
    for k, v in vars(cfg).items():
        if not k.startswith(_OBSERVED) or k == "zero_allow_untested_optimizer":
            continue
        # the sub-configs compare by their parsed fields
        out[k] = v.repr_dict() if hasattr(v, "repr_dict") else v
    return out


@pytest.mark.parametrize("extra", [
    {},
    # test_config.py's ZeRO cases
    {"fp16": {"enabled": True},
     "zero_optimization": {"stage": 2, "allgather_bucket_size": 1234,
                           "overlap_comm": True}},
    {"fp16": {"enabled": True}, "zero_optimization": True},
    {"zero_optimization": False},
    {"zero_optimization": {"stage": 3, "stage3_gather_block": 4,
                           "stage3_latency_hiding": False}},
    {"zero_optimization": {"stage": 3}},
    {"zero_optimization": {"stage": 1, "allgather_size": 77,
                           "offload_optimizer": {"pin_memory": True}}},
    # activation checkpointing and the observability switches
    {"activation_checkpointing": {"partition_activations": True,
                                  "number_checkpoints": 4,
                                  "cpu_checkpointing": True}},
    {"wall_clock_breakdown": True, "memory_breakdown": True},
    {"tensorboard": {"enabled": True, "output_path": "/tmp/tb",
                     "job_name": "run7"}},
    # test_telemetry.py's accepted telemetry blocks
    {"telemetry": {"enabled": True}},
    {"telemetry": {"enabled": True, "interval": 4,
                   "exporters": ["jsonl", "prometheus", "tensorboard"],
                   "prometheus_path": "/tmp/x.prom",
                   "profile": {"start_step": 3, "num_steps": 2,
                               "output_path": "/tmp/prof"},
                   "watchdog": {"enabled": False, "timeout": 30,
                                "poll_interval": 2.5}}},
    {"telemetry": {"enabled": False, "watchdog": {"timeout": 1}}},
    {"telemetry": {"enabled": True, "watchdog": {"poll_interval": None}}},
    {"telemetry": {"enabled": True,
                   "tracing": {"enabled": True, "sample_rate": 0.25,
                               "ring_events": 64, "export": "none"}}},
    {"telemetry": {"enabled": True, "tracing": {"sample_rate": 1}}},
])
def test_training_blocks_parse_to_the_same_attributes(extra):
    jcfg, tcfg = _training_both(extra)
    want = _observed_attrs(jcfg)
    got = _observed_attrs(tcfg)
    assert got == want
    assert "telemetry_enabled" in got and "zero_config" in got


@pytest.mark.parametrize("extra", [
    # test_config.py's refused ZeRO blocks
    {"zero_optimization": {"stage": 4}},
    *({"zero_optimization": {"stage": s}} for s in (-1, True, "2", 1.5)),
    *({"zero_optimization": {"stage": 3, k: 1}}
      for k in ("stag", "stage3_gather_blocks", "overlap_com", "zero3")),
    *({"zero_optimization": {"stage": s, k: v}}
      for s in (0, 1, 2)
      for k, v in (("stage3_gather_block", 2),
                   ("stage3_latency_hiding", True))),
    *({"zero_optimization": {"stage": 3, "stage3_gather_block": g}}
      for g in (0, -1, True, "2", 1.5)),
    *({"zero_optimization": {"stage": 3, "stage3_latency_hiding": h}}
      for h in (1, "true", None)),
    # test_telemetry.py's refused telemetry blocks
    {"telemetry": {"enabled": True, "exporters": ["jsonl", "statsd"]}},
    {"telemetry": {"enabled": True, "exporters": "jsonl"}},
    {"telemetry": {"enabled": True, "exporters": 5}},
    {"telemetry": {"enabled": True, "profile": {"start_step": "20"}}},
    {"telemetry": {"enabled": True,
                   "profile": {"start_step": 2, "num_steps": "2"}}},
    {"telemetry": {"enabled": True, "watchdog": {"timeout": "600"}}},
    {"telemetry": {"enabled": True, "watchdog": {"poll_interval": "5"}}},
    {"telemetry": {"enabled": True, "interval": 0}},
    {"telemetry": {"enabled": True, "interval": True}},
    {"telemetry": {"enabled": True,
                   "profile": {"start_step": 2, "num_steps": 0}}},
    {"telemetry": {"enabled": True, "profile": {"start_step": -2}}},
    {"telemetry": {"enabled": True, "watchdog": {"timeout": 0}}},
    {"telemetry": {"enabled": True, "watchdog": {"poll_interval": -1}}},
    # the tracing sub-block (test_tracing.py's rules)
    {"telemetry": {"enabled": True, "tracing": {"sample_rte": 0.5}}},
    {"telemetry": {"enabled": True, "tracing": {"sample_rate": 1.5}}},
    {"telemetry": {"enabled": True, "tracing": {"sample_rate": "all"}}},
    {"telemetry": {"enabled": True, "tracing": {"sample_rate": True}}},
    {"telemetry": {"enabled": True, "tracing": {"ring_events": 0}}},
    {"telemetry": {"enabled": True, "tracing": {"ring_events": 2.5}}},
    {"telemetry": {"enabled": True, "tracing": {"export": "otlp"}}},
])
def test_both_parsers_refuse_the_same_training_blocks_with_the_same_text(
        extra):
    with pytest.raises(JConfigError) as jerr:
        JConfig(None, param_dict=dict({"train_batch_size": 8}, **extra),
                world_size=1)
    with pytest.raises(DeepSpeedConfigError) as terr:
        DeepSpeedConfig(None, param_dict=dict({"train_batch_size": 8},
                                              **extra),
                        world_size=1, training=True)
    assert str(terr.value) == str(jerr.value)


def test_inference_configs_take_the_telemetry_block_too():
    cfg = DeepSpeedConfig(None, param_dict={
        "inference": {}, "telemetry": {"enabled": True,
                                       "tracing": {"enabled": True}}})
    assert cfg.telemetry_enabled and cfg.telemetry_tracing_enabled
    with pytest.raises(DeepSpeedConfigError, match="sample_rate"):
        DeepSpeedConfig(None, param_dict={
            "telemetry": {"enabled": True,
                          "tracing": {"sample_rate": 2}}})


def test_config_print_lists_the_public_attributes(caplog):
    from deepspeed_tpu_torch.utils.logging import logger

    lines = []

    class Capture(__import__("logging").Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    h = Capture()
    logger.addHandler(h)
    try:
        DeepSpeedConfig(None, param_dict={"train_batch_size": 8,
                                          "wall_clock_breakdown": True},
                        training=True).print()
    finally:
        logger.removeHandler(h)
    assert lines[0] == "DeepSpeedConfig:"
    assert any(l.startswith("  wall_clock_breakdown ") and l.endswith("True")
               for l in lines)
    assert not any(l.lstrip().startswith("_") for l in lines[1:])
