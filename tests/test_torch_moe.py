"""MoE with expert parallelism (ops/moe.py) and GPT-2's MoE stack, held to
the JAX package on the CPU, and serving's refusal of MoE and pipeline
stages.

- ``top_k_gating`` on the same float32 logits (k 1 and 2, a capacity that
  overflows, uniform logits): the dispatch equal to the JAX layer's, the
  combine weights and the aux loss to 2e-7 (the two libraries' softmax
  exp differs in the last place);
- ``MoEMLP`` and the MoE block against the JAX modules on the same
  weights: outputs and aux to 1e-5, gradients to every leaf to rtol 1e-4,
  on inputs whose smallest router gap among the top choices is above 1e-4
  (so no routing flip can pass or fail it silently); one expert is the
  dense MLP;
- what the engine refuses with MoE experts in one process, by message.
tests/test_torch_moe_dp2.py runs the MoE GPT-2 engine at dp 1 and 2,
tests/test_torch_moe_dp4.py at dp 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch as dst
import torch_moe_pp as mp
from deepspeed_tpu.config.config import DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.ops import moe as jmoe
from deepspeed_tpu.ops.transformer import DeepSpeedTransformerConfig as JLayerConfig
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from deepspeed_tpu_torch.convert import _MATRICES
from deepspeed_tpu_torch.ops import moe as tmoe
from deepspeed_tpu_torch.ops.transformer import DeepSpeedTransformerConfig
from torch_test_env import jax_compile_cache  # noqa: F401

# ---------------------------------------------------------------------------
# the router and the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,capacity,uniform", [
    (1, 6, False), (2, 10, False), (2, 2, False), (2, 8, True),
], ids=["top1", "top2", "top2-overflow", "uniform"])
def test_top_k_gating_matches_jax(k, capacity, uniform):
    rng = np.random.default_rng(k * 10 + capacity)
    logits = (np.zeros((3, 16, 4), np.float32) if uniform
              else rng.normal(size=(3, 16, 4)).astype(np.float32))
    jd, jc, ja = jmoe.top_k_gating(jnp.asarray(logits), k, capacity)
    td, tc, ta = tmoe.top_k_gating(torch.from_numpy(logits), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=2e-7)
    np.testing.assert_allclose(float(ta), float(ja), rtol=2e-7)
    if capacity == 2:
        # the overflow drops tokens to the residual: fewer slots than
        # choices
        assert td.sum() < 3 * 16 * k


def _min_router_gap(x, gate_w, k):
    """The smallest gap, over tokens, between neighbours among the top
    ``k + 1`` router logits (a flip needs a gap near float rounding)."""
    logits = np.sort(x.reshape(-1, x.shape[-1]) @ gate_w, axis=-1)[:, ::-1]
    return float(np.min(-np.diff(logits[:, :k + 1], axis=-1)))


def _gapped_input(shape, gate_w, k, seed):
    """A seeded input whose router gaps are all above 1e-4."""
    rng = np.random.default_rng(seed)
    for _ in range(100):
        x = rng.normal(size=shape).astype(np.float32)
        if _min_router_gap(x, gate_w, k) > 1e-4:
            return x
    raise AssertionError("no input with router gaps above 1e-4")


M, I, E = 16, 32, 4


def _jax_mlp(k=2, capacity_factor=1.25):
    cfg = jmoe.MoEConfig(n_experts=E, top_k=k,
                         capacity_factor=capacity_factor)
    mlp = jmoe.MoEMLP(hidden=M, intermediate=I, cfg=cfg)
    params = jax.jit(mlp.init)(jax.random.PRNGKey(3),
                               jnp.zeros((2, 8, M)))["params"]
    return mlp, jax.device_get(params)


def test_moe_mlp_matches_jax():
    mlp, params = _jax_mlp()
    x = _gapped_input((2, 8, M), np.asarray(params["gate_w"]), 2, seed=0)
    assert _min_router_gap(x, np.asarray(params["gate_w"]), 2) > 1e-4

    def f(p, x):
        y, aux = mlp.apply({"params": p}, x)
        return jnp.sum(y * jnp.cos(y)) + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    t = tmoe.MoEMLP(M, I, tmoe.MoEConfig(n_experts=E, top_k=2),
                    device="cpu")
    with torch.no_grad():
        for n, v in params.items():
            getattr(t, n).copy_(torch.tensor(np.asarray(v)))
    xt = torch.tensor(x, requires_grad=True)
    y, aux = t(xt)
    (torch.sum(y * torch.cos(y)) + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=1e-5)
    for n, v in jg.items():
        np.testing.assert_allclose(getattr(t, n).grad.numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-7, err_msg=n)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-7)


def _layer_configs():
    kw = dict(hidden_size=M, heads=4, intermediate_size=I,
              attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
              pre_layer_norm=True)
    return JLayerConfig(**kw), DeepSpeedTransformerConfig(**kw)


def _port_block(jparams, moe_cfg):
    """The port's MoE block with the JAX block's weights (the attention
    matrices transposed)."""
    _, tcfg = _layer_configs()
    block = tmoe.DeepSpeedMoETransformerLayer(tcfg, moe_cfg, device="cpu")
    with torch.no_grad():
        for n, v in jparams.items():
            if n == "moe":
                for k, w in v.items():
                    getattr(block.moe, k).copy_(torch.tensor(np.asarray(w)))
                continue
            v = np.asarray(v)
            getattr(block, n).copy_(torch.tensor(
                v.T.copy() if n in _MATRICES else v))
    return block


def test_moe_block_matches_jax():
    jcfg, tcfg = _layer_configs()
    moe_cfg = jmoe.MoEConfig(n_experts=E, top_k=2)
    layer = jmoe.DeepSpeedMoETransformerLayer(config=jcfg, moe=moe_cfg,
                                              causal=True)
    x = np.random.default_rng(1).normal(size=(2, 8, M)).astype(np.float32)
    params = jax.device_get(jax.jit(lambda k, x: layer.init(
        {"params": k}, x, train=False))(jax.random.PRNGKey(2),
                                         jnp.asarray(x))["params"])

    def f(p):
        y, aux = layer.apply({"params": p}, jnp.asarray(x), train=False)
        return jnp.sum(jnp.sin(y)) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    block = _port_block(params, tmoe.MoEConfig(n_experts=E, top_k=2))
    y, aux = tmoe.moe_block_apply(tcfg, block, torch.tensor(x), causal=True)
    (torch.sum(torch.sin(y)) + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=1e-5)
    for n, v in jg.items():
        if n == "moe":
            for k, w in v.items():
                np.testing.assert_allclose(
                    getattr(block.moe, k).grad.numpy(), np.asarray(w),
                    rtol=1e-4, atol=1e-6, err_msg=k)
            continue
        g = getattr(block, n).grad.numpy()
        np.testing.assert_allclose(g.T if n in _MATRICES else g,
                                   np.asarray(v), rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_one_expert_is_the_dense_mlp():
    """One expert, top-1, room for every token: the gate is 1 and the FFN
    is the dense block's MLP on the expert's weights."""
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerLayer,
        transformer_block_apply,
    )

    _, tcfg = _layer_configs()
    moe_cfg = tmoe.MoEConfig(n_experts=1, top_k=1, capacity_factor=1.0)
    block = tmoe.DeepSpeedMoETransformerLayer(tcfg, moe_cfg, device="cpu")
    block.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        block.moe.expert_in_b.normal_(0.0, 0.1)
        block.moe.expert_out_b.normal_(0.0, 0.1)
    dense = DeepSpeedTransformerLayer(tcfg, device="cpu")
    with torch.no_grad():
        for n, p in block.named_parameters(recurse=False):
            getattr(dense, n).copy_(p)
        dense.inter_w.copy_(block.moe.expert_in_w[0].t())
        dense.inter_b.copy_(block.moe.expert_in_b[0])
        dense.output_w.copy_(block.moe.expert_out_w[0].t())
        dense.output_b.copy_(block.moe.expert_out_b[0])
    x = torch.randn(2, 8, M, generator=torch.Generator().manual_seed(1))
    y, aux = tmoe.moe_block_apply(tcfg, block, x, causal=True)
    want = transformer_block_apply(tcfg, dense, x, causal=True)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    # one expert holds every token: the balance loss is E * 1 * 1
    assert float(aux.detach()) == pytest.approx(moe_cfg.aux_loss_weight)


# ---------------------------------------------------------------------------
# what the engine refuses with MoE experts in one process
# ---------------------------------------------------------------------------
LIFTED_WITH_EXPERTS = ("bf16 optimizer moments", "compensated masters",
                       "optimizer offload", "int8 optimizer moments")


@pytest.mark.parametrize("extra,what", [
    ({"adapters": {"enabled": True, "rank": 4}}, "the adapters block"),
    ({"data_types": {"optimizer_state_dtype": "int8"}},
     "int8 optimizer moments"),
    ({"data_types": {"optimizer_state_dtype": "bf16"}},
     "bf16 optimizer moments"),
    ({"bf16": {"enabled": True},
      "data_types": {"master_dtype": "compensated"}}, "compensated masters"),
    ({"zero_optimization": {"stage": 1,
                            "offload_optimizer": {"device": "cpu"}}},
     "optimizer offload"),
])
def test_moe_refusals(extra, what):
    """What an MoE model refuses in one process; bf16 moments,
    compensated masters, offload and int8 moments are lifted and build
    (the first two's parity: tests/test_torch_moe_dp2.py; offload steps
    the same update on the host; int8 at dp 2 against the JAX engine:
    tests/test_torch_int8_spans.py)."""
    m = dst.GPT2LMHeadModel(dst.GPT2Config(**mp.SIZES, moe_experts=4),
                            device="cpu")
    config = dict({"train_batch_size": 2}, **extra)
    if what in LIFTED_WITH_EXPERTS:
        engine, *_ = dst.initialize(model=m, device="cpu",
                                    config_params=config)
        assert (engine.config.optimizer_state_dtype in ("bf16", "int8")
                or engine.compensated_master or engine.host_offload)
        return
    # the adapters block: refused with the JAX engine's behaviour
    match = ("MoE blocks run without their LoRA factors"
             if what == "the adapters block"
             else f"{what} with MoE experts.*ROADMAP A7f")
    with pytest.raises(DeepSpeedConfigError, match=match):
        dst.initialize(model=m, device="cpu", config_params=config)


def test_moe_block_refuses_the_memory_modes():
    with pytest.raises(ValueError, match="does not support the layer "
                                         "memory modes"):
        dst.GPT2LMHeadModel(dst.GPT2Config(**mp.SIZES, moe_experts=4,
                                           remat=True), device="cpu")


# ---------------------------------------------------------------------------
# C7: serving refuses MoE and pipeline stages, as the JAX engine does
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("field,value,message", [
    ("moe_experts", 4, "does not support MoE layers yet"),
    ("pipeline_stages", 2, "does not support the pipelined stack yet"),
])
def test_serving_refuses_moe_and_pipeline_stages(field, value, message):
    sizes = dict(mp.SIZES, **{field: value})
    jmodel = JGPT2LMHeadModel(JGPT2Config(**sizes))
    with pytest.raises(JaxConfigError, match=message):
        deepspeed_tpu.init_inference(model=jmodel, model_parameters={},
                                     config={"inference": {}})
    # the port's model is built dense, then given the field, as a
    # checkpoint's config would carry it
    model = dst.GPT2LMHeadModel(dst.GPT2Config(**mp.SIZES), device="cpu")
    setattr(model.config, field, value)
    with pytest.raises(DeepSpeedConfigError, match=message):
        dst.init_inference(model=model, config={"inference": {}},
                           device="cpu")
