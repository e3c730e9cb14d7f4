"""Port parity for the training blocks of the config: the port's parser
against the JAX package's DeepSpeedConfig on the keys the training slice
reads (the batch triangle, optimizer, scheduler, fp16/bf16, clipping,
ZeRO stage, steps_per_print, data_types), with the rows of
tests/unit/test_config.py for those keys; and the engine's refusals of
what the port does not have yet."""

import dataclasses

import pytest
import torch

from deepspeed_tpu.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.config import DeepSpeedConfigError as JConfigError
import deepspeed_tpu_torch
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from torch_test_env import jax_compile_cache  # noqa: F401

TRAINING_ATTRS = (
    "train_batch_size", "train_micro_batch_size_per_gpu",
    "gradient_accumulation_steps", "steps_per_print", "gradient_clipping",
    "zero_optimization_stage", "zero_enabled", "fp16_enabled", "loss_scale",
    "initial_scale_power", "loss_scale_window", "hysteresis",
    "min_loss_scale", "dynamic_loss_scale", "bf16_enabled",
    "grad_accum_dtype", "optimizer_state_dtype", "master_dtype",
    "optimizer_name", "optimizer_params", "scheduler_name",
    "scheduler_params", "sparse_gradients_enabled",
)


def _attrs(cfg):
    return {k: getattr(cfg, k) for k in TRAINING_ATTRS}


@pytest.mark.parametrize("raw,world", [
    # test_config.py's batch rows: any two of the triangle give the third
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
      "gradient_accumulation_steps": 2}, 4),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4}, 4),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4}, 1),
    ({"train_batch_size": 32, "gradient_accumulation_steps": 2}, 4),
    ({"train_micro_batch_size_per_gpu": 4,
      "gradient_accumulation_steps": 2}, 1),
    ({"train_batch_size": 32}, 4),
    ({"train_micro_batch_size_per_gpu": 4}, 2),
])
def test_batch_triangle_resolves_as_in_the_jax_parser(raw, world):
    want = _attrs(JConfig(None, param_dict=raw, world_size=world))
    got = _attrs(DeepSpeedConfig(None, param_dict=raw, world_size=world,
                                 training=True))
    assert got == want


@pytest.mark.parametrize("raw", [
    # ZeRO: the object, the deprecated boolean, and stage 3's knobs
    {"train_batch_size": 8, "zero_optimization": {
        "stage": 2, "allgather_bucket_size": 500, "overlap_comm": True}},
    {"train_batch_size": 8, "zero_optimization": True},
    {"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "stage3_gather_block": 2}},
    # fp16 (dynamic and static loss scale) and bf16
    {"train_batch_size": 8, "fp16": {
        "enabled": True, "initial_scale_power": 16, "loss_scale_window": 500,
        "hysteresis": 3, "min_loss_scale": 2}},
    {"train_batch_size": 8, "fp16": {"enabled": True, "loss_scale": 128}},
    {"train_batch_size": 8, "bf16": {"enabled": True}},
    # optimizer, scheduler, clipping, printing, data types
    {"train_batch_size": 8,
     "optimizer": {"type": "FusedLamb",
                   "params": {"lr": 1e-3, "weight_decay": 0.01}},
     "scheduler": {"type": "WarmupLR",
                   "params": {"warmup_num_steps": 10}},
     "gradient_clipping": 1.0, "steps_per_print": 5},
    {"train_batch_size": 8, "data_types": {"grad_accum_dtype": "bf16"}},
    {"train_batch_size": 8, "sparse_gradients": True},
])
def test_training_blocks_parse_to_the_same_attributes(raw):
    want = _attrs(JConfig(None, param_dict=raw, world_size=1))
    got = _attrs(DeepSpeedConfig(None, param_dict=raw, world_size=1,
                                 training=True))
    assert got == want


@pytest.mark.parametrize("raw", [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 3},      # inconsistent triangle
    {},                                      # no batch size at all
    {"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 0},
    {"train_batch_size": 8, "zero_optimization": {"stage": 4}},
    {"train_batch_size": 8, "zero_optimization": {"stage": True}},
    {"train_batch_size": 8, "zero_optimization": {"stage": 1.0}},
    {"train_batch_size": 8, "zero_optimization": {"stage": 1, "bogus": 1}},
    {"train_batch_size": 8, "zero_optimization": {
        "stage": 2, "stage3_latency_hiding": True}},
    {"train_batch_size": 8, "fp16": {"enabled": True},
     "bf16": {"enabled": True}},
    {"train_batch_size": 8, "data_types": {"grad_accum_dtype": "fp8"}},
    {"train_batch_size": 8, "data_types": {"master_dtype": "fp16"}},
])
def test_both_parsers_refuse_the_same_training_blocks(raw):
    with pytest.raises((JConfigError, TypeError, ValueError)):
        JConfig(None, param_dict=raw, world_size=2)
    with pytest.raises((DeepSpeedConfigError, TypeError, ValueError)):
        DeepSpeedConfig(None, param_dict=raw, world_size=2, training=True)


def test_an_inference_config_resolves_no_batch_triangle():
    """init_inference passes no batch size: the triangle is resolved only
    for a training config."""
    cfg = DeepSpeedConfig(None, param_dict={"inference": {}}, world_size=1)
    assert cfg.train_batch_size is None
    with pytest.raises(DeepSpeedConfigError, match="train_batch_size"):
        DeepSpeedConfig(None, param_dict={"inference": {}}, world_size=1,
                        training=True)


def _tiny():
    return GPT2LMHeadModel(
        GPT2Config(vocab_size=64, n_positions=16, n_embd=16, n_layer=1,
                   n_head=2, dropout=0.0), device="cpu")


# the optimizer state layouts, SGD and Lion are ported: those places
# (extra0, 1, 4-7, 9, 10) now hold combinations that stay refused (the
# adapters block with offload or compensated masters, and each of them
# with a mesh or sparse gradients); test_engine_accepts_the_ported_layouts
# builds the configs they held before. A data axis above 1 and sparse
# gradients are ported too (tests/test_torch_dist.py,
# tests/test_torch_zero*.py, tests/test_torch_sparse.py): extra3, 4 and 6-8
# and extra10 now hold model, sequence and pipeline axes, which stay
# refused. The adapters block with offload or compensated masters is
# ported too, as the JAX engine takes it: extra0, 1 and 5 now build, train
# a step and leave the frozen base as it was. The model axis is ported
# (tests/test_torch_model_parallel*.py): extra2, 8 and 9 now hold
# sequence and pipeline axes. The sequence axis is ported too
# (tests/test_torch_sequence_parallel.py, which holds what it refuses on
# ranks): extra2, 3, 7 and 10 now hold a pipeline axis, alone or with a
# sequence axis. The pipe axis is ported too (tests/test_torch_pipeline*.py
# hold what it refuses on ranks): in one process the topology refuses a
# pipe axis of 2 before the engine sees the rest of the config
@pytest.mark.parametrize("extra", [
    {"adapters": {"enabled": True, "rank": 4},
     "zero_optimization": {"stage": 1,
                           "offload_optimizer": {"device": "cpu"}}},
    {"adapters": {"enabled": True, "rank": 4}, "bf16": {"enabled": True},
     "data_types": {"master_dtype": "compensated"}},
    {"mesh": {"pipeline_parallel_size": 2},
     "activation_checkpointing": {"partition_activations": True}},
    {"mesh": {"pipeline_parallel_size": 2, "sequence_parallel_size": 2}},
    {"mesh": {"pipeline_parallel_size": 2},
     "zero_optimization": {"stage": 2}},
    {"adapters": {"enabled": True, "rank": 4}, "fp16": {"enabled": True},
     "data_types": {"master_dtype": "compensated"}},
    {"mesh": {"pipeline_parallel_size": 2},
     "data_types": {"optimizer_state_dtype": "int8"}},
    {"mesh": {"pipeline_parallel_size": 2},
     "zero_optimization": {"stage": 2,
                           "offload_optimizer": {"device": "cpu"}}},
    {"mesh": {"pipeline_parallel_size": 2}},
    {"mesh": {"pipeline_parallel_size": 2},
     "optimizer": {"type": "SGD", "params": {"lr": 0.1}}},
    {"mesh": {"pipeline_parallel_size": 2, "sequence_parallel_size": 2},
     "optimizer": {"type": "Lion", "params": {"lr": 0.1}}},
])
def test_engine_refuses_what_is_not_ported(extra):
    cfg = dict({"train_batch_size": 2}, **extra)
    if "adapters" in extra:
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=_tiny(), config_params=cfg, device="cpu")
        base = {n: t.clone() for n, t in engine.frozen_base_params.items()}
        ids = torch.randint(0, 64, (2, 16),
                            generator=torch.Generator().manual_seed(0))
        loss = engine.train_batch([(ids, ids)])
        # fp16's first window may overflow at the initial scale and skip
        assert torch.isfinite(loss)
        assert engine.global_steps + engine.skipped_steps == 1
        assert set(engine.params) == set(engine.adapter_state_dict())
        assert all(torch.equal(base[n], t)
                   for n, t in engine.frozen_base_params.items())
        return
    if "pipeline_parallel_size" in extra.get("mesh", {}):
        with pytest.raises(ValueError, match="not divisible by mp"):
            deepspeed_tpu_torch.initialize(model=_tiny(), config_params=cfg,
                                           device="cpu")
        return
    with pytest.raises(DeepSpeedConfigError, match="not yet ported"):
        deepspeed_tpu_torch.initialize(model=_tiny(), config_params=cfg,
                                       device="cpu")


@pytest.mark.parametrize("extra", [
    {"zero_optimization": {"stage": 1,
                           "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 3,
                           "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 2,
                           "offload_optimizer": {"device": "cpu"}}},
    {"bf16": {"enabled": True}, "data_types": {"master_dtype": "compensated"}},
    {"data_types": {"optimizer_state_dtype": "bf16"}},
    {"data_types": {"optimizer_state_dtype": "int8"}},
    {"optimizer": {"type": "SGD", "params": {"lr": 0.1}}},
    {"optimizer": {"type": "Lion", "params": {"lr": 0.1}}},
], ids=["offload_stage1", "offload_stage3", "offload_stage2", "compensated",
        "bf16_state", "int8_state", "sgd", "lion"])
def test_engine_accepts_the_ported_layouts(extra):
    """What the engine refused before the optimizers and state layouts
    were ported now builds and takes a step."""
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_tiny(), config_params=dict({"train_batch_size": 2}, **extra),
        device="cpu")
    ids = torch.randint(0, 64, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    loss = engine.train_batch([(ids, ids)])
    assert torch.isfinite(loss) and engine.global_steps == 1


@pytest.mark.parametrize("block,armed", [
    ({"fault_injection": {"enabled": True,
                          "faults": [{"site": "grads.nan"}]}},
     lambda e: e.faults.enabled and e.supervisor is None),
    ({"supervisor": {"enabled": True}},
     lambda e: e.supervisor is not None and not e.faults.enabled),
])
def test_engine_accepts_and_arms_the_resilience_block(block, armed):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_tiny(),
        config_params={"train_batch_size": 2, "resilience": block},
        device="cpu")
    assert armed(engine)


@pytest.mark.parametrize("field,value", [
    ("remat", True), ("moe_experts", 4), ("pipeline_stages", 2),
])
def test_engine_refuses_model_features_that_are_not_ported(field, value):
    model = _tiny()
    setattr(model.config, field, value)
    if field == "moe_experts":
        # MoE is ported (tests/test_torch_moe*.py); what it refuses, as the
        # JAX layer does: the block memory modes
        cfg = dataclasses.replace(model.config, remat=True)
        with pytest.raises(ValueError, match="does not support the layer "
                                             "memory modes"):
            GPT2LMHeadModel(cfg, device="cpu")
        return
    if field == "pipeline_stages":
        # pipeline stages are ported (tests/test_torch_pipeline*.py); a
        # pipelined model needs a pipe axis of its stage count, as the JAX
        # model requires
        with pytest.raises(ValueError, match="pipeline_stages=2 needs a "
                                             "mesh whose 'pipe' axis"):
            deepspeed_tpu_torch.initialize(
                model=model, config_params={"train_batch_size": 2},
                device="cpu")
        return
    if field == "remat":
        # remat is ported; a policy factory is refused with the JAX
        # package's error class (TypeError), where the JAX package raises
        # it at the first backward
        model.config.remat_policy = "save_only_these_names"
        with pytest.raises(TypeError, match="cannot run it as a policy"):
            deepspeed_tpu_torch.initialize(
                model=model, config_params={"train_batch_size": 2},
                device="cpu")
        return
    with pytest.raises(DeepSpeedConfigError, match="not yet ported"):
        deepspeed_tpu_torch.initialize(
            model=model, config_params={"train_batch_size": 2}, device="cpu")


def test_engine_refuses_data_checkpoints_and_a_second_device(tmp_path):
    """A loader over a mesh and a mesh are refused; the data loader and
    checkpoints are ported (initialize() returns the loader; save, then
    load into a fresh engine)."""
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

    cfg = {"train_batch_size": 2}
    with pytest.raises(DeepSpeedConfigError, match="takes a deepspeed_tpu_"
                                                   "torch.parallel.ProcessMesh"):
        DeepSpeedDataLoader([1, 2], batch_size=1, mesh=object())
    _, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=_tiny(), config_params=cfg, training_data=[1, 2],
        device="cpu")
    assert isinstance(loader, DeepSpeedDataLoader) and len(loader) == 1
    with pytest.raises(DeepSpeedConfigError, match="takes a deepspeed_tpu_"
                                                   "torch.parallel.ProcessMesh"):
        deepspeed_tpu_torch.initialize(model=_tiny(), config_params=cfg,
                                       mesh=object(), device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_tiny(), config_params=cfg, device="cpu")
    assert engine.save_checkpoint(str(tmp_path)) is True
    fresh, *_ = deepspeed_tpu_torch.initialize(
        model=_tiny(), config_params=cfg, device="cpu")
    path, client = fresh.load_checkpoint(str(tmp_path))
    assert path is not None and "global_step0" in path and client == {}


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_stages_are_accepted_at_world_size_one(stage):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_tiny(),
        config_params={"train_batch_size": 2,
                       "zero_optimization": {"stage": stage}},
        device="cpu",
    )
    assert engine.zero_stage == stage
    ids = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(0))
    loss = engine.train_batch([(ids, ids)])
    assert torch.isfinite(loss) and engine.global_steps == 1
