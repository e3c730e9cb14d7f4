"""Remat (activation rematerialisation) in the port, on the CPU.

- Engine parity with the JAX package end to end through the data path: a
  2-layer GPT-2 (seq 64 on the plain attention, seq 256 on the flash
  route, the JAX kernels in interpret mode), fed by ``initialize(
  training_data=...)``'s loader, one window of forward/backward/step and
  two of ``train_batch``, with the port's staging off and on, and with
  remat off, "full" and the selective spec on both sides. Tolerances of
  tests/test_torch_engine.py: losses rtol 1e-5, first-micro-step
  gradients rtol 1e-4 (atol 1e-6), at dropout 0 in float32.
- Remat and no-remat gradients are equal bit for bit with dropout on (the
  block draws its seed and masks before the checkpointed region), under
  every mapped spec.
- The forward's plain-version runs per layer: 2 under "full", 1 under a
  spec that keeps flash_out and flash_lse.
- The spec strings: every string the JAX package accepts is accepted, or
  raises TypeError where the JAX package's first backward raises it (a
  policy factory or a dunder attribute as a part), and every string it
  rejects is rejected (the typo check of
  tests/unit/test_attention_sharded.py)."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel, params_from_jax
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from deepspeed_tpu_torch.ops import attention as A
from deepspeed_tpu_torch.ops.transformer import (
    DeepSpeedTransformerConfig,
    resolve_remat_policy,
)
from torch_test_env import jax_compile_cache  # noqa: F401

jattn = importlib.import_module("deepspeed_tpu.ops.attention")
jtransformer = importlib.import_module("deepspeed_tpu.ops.transformer")

VOCAB = 256
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
SELECTIVE = "dots_with_no_batch_dims_saveable+flash_out+flash_lse"
CONFIG = {
    "train_batch_size": 4,
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_max_lr": 1e-3, "warmup_num_steps": 2}},
    "gradient_clipping": 1.0,
    "steps_per_print": 1000,
}


def _drive(engine, loader, grads_of, to_input):
    """One window of forward/backward/step from the loader's iterator
    (the first micro-step's gradients kept), then two train_batch
    windows from the same iterator."""
    it = iter(loader)
    losses, first = [], None
    for _ in range(2):
        batch = [to_input(x) for x in next(it)]
        loss = engine(*batch)
        engine.backward(loss)
        losses.append(float(np.asarray(
            loss.detach() if isinstance(loss, torch.Tensor) else loss)))
        if first is None:
            first = grads_of(engine)
    engine.step()
    losses += [float(engine.train_batch(it)) for _ in range(2)]
    return np.array(losses), first


@pytest.mark.parametrize("seq,policy", [
    (64, None), (256, "full"), (256, SELECTIVE),
])
def test_training_data_and_remat_match_the_jax_engine(seq, policy,
                                                      monkeypatch):
    if seq >= jattn.FLASH_MIN_SEQ:
        # the JAX dispatcher takes flash only on one device or when forced
        monkeypatch.setattr(jattn, "FLASH_MODE", "always")
    kw = {} if policy is None else {"remat": True, "remat_policy": policy}
    jmodel = JGPT2LMHeadModel(JGPT2Config(
        vocab_size=VOCAB, n_positions=seq, n_embd=64, n_layer=2, n_head=4,
        dropout=0.0, **kw))
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = jmodel.init({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(1)}, ids0, ids0)[
        "params"]
    ids = np.random.default_rng(0).integers(0, VOCAB, (12, seq)).astype(
        np.int32)
    data = (ids, ids.copy())
    jengine, _, jloader, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params, config_params=CONFIG,
        training_data=data, mesh=build_mesh(devices=jax.devices()[:1]))
    jl, jg = _drive(jengine, jloader,
                    lambda e: params_from_jax(jax.device_get(e._grad_buffer)),
                    jnp.asarray)
    for staged in (False, True):
        model = GPT2LMHeadModel(GPT2Config(
            vocab_size=VOCAB, n_positions=seq, n_embd=64, n_layer=2,
            n_head=4, dropout=0.0, **kw), device="cpu")
        model.load_state_dict(params_from_jax(jax.device_get(params)))
        cfg = dict(CONFIG, data_pipeline={"enabled": staged})
        tengine, _, tloader, _ = deepspeed_tpu_torch.initialize(
            model=model, config_params=cfg, training_data=data,
            device="cpu")
        assert isinstance(tloader, deepspeed_tpu_torch.DeepSpeedDataLoader)
        tl, tg = _drive(tengine, tloader,
                        lambda e: {n: g.clone()
                                   for n, g in e._grad_buffer.items()},
                        lambda x: x.long())
        assert (tengine._stager is not None) == staged
        tengine.close_data_pipeline()
        assert set(tg) == set(jg)
        for name, want in jg.items():
            np.testing.assert_allclose(tg[name].numpy(), want.numpy(),
                                       err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(tl, jl, **LOSS_TOL)
        assert tengine.global_steps == jengine.global_steps == 3


def _model(seq, policy, dropout=0.2):
    kw = {} if policy is None else {"remat": True, "remat_policy": policy}
    return GPT2LMHeadModel(GPT2Config(
        vocab_size=VOCAB, n_positions=seq, n_embd=32, n_layer=2, n_head=4,
        dropout=dropout, **kw), device="cpu", seed=3)


@pytest.mark.parametrize("seq", [64, 256])
@pytest.mark.parametrize("policy", [
    "full", SELECTIVE, "dots_saveable", "nothing_saveable+attn_probs",
    "everything_saveable", "checkpoint_dots_with_no_batch_dims+flash_out",
])
def test_remat_gradients_equal_no_remat_with_dropout_on(seq, policy,
                                                        monkeypatch):
    """The RNG trap: the block's attention seed and hidden-dropout masks
    come from explicit generators that torch.utils.checkpoint does not
    restore; they are drawn before the checkpointed region, so the
    recompute repeats them and the gradients are equal bit for bit."""
    calls = []
    plain = A.flash_fwd_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(A, "flash_fwd_plain", counted)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, VOCAB, (2, seq)))
    runs = []
    for p in (None, policy):
        model = _model(seq, p)
        calls.clear()
        loss = model(ids, ids, train=True, dropout_seed=11)
        loss.backward()
        runs.append((float(loss.detach()), len(calls),
                     [t.grad for t in model.parameters()]))
    (l0, c0, g0), (l1, c1, g1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    if seq >= A.FLASH_MIN_SEQ:
        # the forward's runs per layer: twice when the recompute repeats
        # attention, once when the spec keeps flash_out and flash_lse
        keeps = "flash_out" in policy and "flash_lse" in policy
        assert c0 == 2
        assert c1 == (2 if keeps else 4)


def test_remat_is_skipped_without_autograd_and_in_eval():
    model = _model(256, "full")
    ids = torch.zeros((1, 256), dtype=torch.long)
    with torch.no_grad():
        a = model(ids, ids, train=True, dropout_seed=1)
    b = model(ids)  # the eval forward (no autograd)
    assert torch.isfinite(a) and b.shape == (1, 256, 256)


SPECS = [
    "full_typo", "dots_with_no_batch_dims_savable", "flash_out+nonsense",
    "dots_saveable", "dots_with_no_batch_dims_saveable+flash_out",
    SELECTIVE, "nothing_saveable", "everything_saveable",
    "checkpoint_dots", "checkpoint_dots_with_no_batch_dims+attn_probs",
    "attn_probs", "flash_out+flash_lse", "save_only_these_names",
    "save_anything_except_these_names", "offload_dot_with_no_batch_dims",
    "save_from_both_policies", "save_and_offload_only_these_names",
    "save_any_names_but_these", "zero3_gathered", "dots_saveable+__doc__",
    "dots_saveable+__foo__",
]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_strings_are_accepted_and_rejected_as_jax_does(spec):
    try:
        jtransformer.resolve_remat_policy(spec)
        jax_accepts = True
    except ValueError as e:
        jax_accepts = False
        assert "unknown remat policy part" in str(e)
    if not jax_accepts:
        with pytest.raises(ValueError, match="unknown remat policy part"):
            resolve_remat_policy(spec)
        return
    try:
        policy = resolve_remat_policy(spec)
    except TypeError as e:
        assert "cannot run it as a policy" in str(e)
        # the JAX package accepted the spec; its first backward raises
        jpolicy = jtransformer.resolve_remat_policy(spec)
        with pytest.raises(TypeError):
            jax.grad(jax.checkpoint(lambda x: jnp.sum(jnp.sin(x @ x)),
                                    policy=jpolicy))(jnp.ones((2, 2)))
        return
    assert policy.keep_flash == ("flash_out" in spec and "flash_lse" in spec)


def test_the_port_lists_every_public_jax_policy():
    from deepspeed_tpu_torch.ops.transformer import JAX_CHECKPOINT_POLICIES

    public = sorted(n for n in dir(jax.checkpoint_policies)
                    if not n.startswith("_"))
    assert sorted(JAX_CHECKPOINT_POLICIES) == public


def test_memory_modes_and_the_engine_refusal():
    assert not DeepSpeedTransformerConfig().use_remat
    for flag in ("normalize_invertible", "gelu_checkpoint",
                 "attn_dropout_checkpoint"):
        assert DeepSpeedTransformerConfig(**{flag: True}).use_remat
    model = _model(64, "save_only_these_names")
    with pytest.raises(TypeError, match="cannot run it as a policy"):
        deepspeed_tpu_torch.initialize(
            model=model, config_params={"train_batch_size": 2},
            device="cpu")
    model = _model(64, "dots_savable")
    with pytest.raises(ValueError, match="unknown remat policy part"):
        deepspeed_tpu_torch.initialize(
            model=model, config_params={"train_batch_size": 2},
            device="cpu")
