"""Port parity for the training slice end to end: the JAX package's engine
and the port's, both built by ``initialize()`` on the same GPT-2 weights
(carried over with ``params_from_jax``) and fed the same numpy batches,
at dropout 0 in float32 for 3 steps of 2 micro-batches each.

S=64 runs the plain attention reference in both packages; S=256 runs the
flash path in both (the JAX kernels in interpret mode, forced past the
8-device test mesh's routing; the port's kernels' plain versions).

Tolerances: first-step gradients rtol 1e-4, atol 1e-6 (float32 through
two layers, one softmax, LayerNorm and the blocked cross-entropy, summed
in other orders); losses rtol 1e-5; LAMB trust ratios per JAX leaf
group rtol 1e-5; skipped steps and the fp16 loss-scale schedule exactly
equal.
"""

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
from torch_test_env import jax_compile_cache  # noqa: F401

jattn = importlib.import_module("deepspeed_tpu.ops.attention")

VOCAB = 256
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
COEFF_TOL = dict(rtol=1e-5, atol=0.0)


def _models(seq):
    jcfg = JGPT2Config(vocab_size=VOCAB, n_positions=seq, n_embd=64,
                       n_layer=2, n_head=4, dropout=0.0)
    jmodel = JGPT2LMHeadModel(jcfg)
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        ids0, ids0,
    )["params"]
    model = GPT2LMHeadModel(
        GPT2Config(vocab_size=VOCAB, n_positions=seq, n_embd=64, n_layer=2,
                   n_head=4, dropout=0.0),
        device="cpu",
    )
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model


def _config(optimizer, **extra):
    cfg = {
        "train_batch_size": 4,
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": optimizer,
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 2}},
        "gradient_clipping": 1.0,
        "steps_per_print": 1000,
    }
    cfg.update(extra)
    return cfg


def _engines(seq, cfg):
    jmodel, params, model = _models(seq)
    jengine, jopt, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params, config_params=cfg,
        mesh=build_mesh(devices=jax.devices()[:1]),
    )
    tengine, topt, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfg, device="cpu")
    return (jengine, jopt), (tengine, topt)


def _batches(seq, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (2, seq)).astype(np.int32)
            for _ in range(n)]


def _drive(engine, batches, to_input, steps, accum, grads_of):
    """forward/backward/step over ``batches``; returns the micro-step
    losses, the gradient buffer after the first micro-step (via
    ``grads_of``) and ``skipped_steps`` after each step."""
    losses, first, schedule = [], None, []
    it = iter(batches)
    for _ in range(steps):
        for _ in range(accum):
            ids = to_input(next(it))
            loss = engine(ids, ids)
            engine.backward(loss)
            losses.append(float(np.asarray(loss.detach() if
                                           isinstance(loss, torch.Tensor)
                                           else loss)))
            if first is None:
                first = grads_of(engine)
        engine.step()
        schedule.append(engine.skipped_steps)
    return np.array(losses), first, schedule


def _run_pair(seq, cfg, steps=3):
    (jengine, jopt), (tengine, topt) = _engines(seq, cfg)
    accum = cfg.get("gradient_accumulation_steps", 1)
    batches = _batches(seq, steps * accum)
    j = _drive(jengine, batches, jnp.asarray, steps, accum,
               lambda e: params_from_jax(jax.device_get(e._grad_buffer)))
    t = _drive(tengine, batches, lambda x: torch.from_numpy(x).long(), steps,
               accum, lambda e: {n: g.clone() for n, g in
                                 e._grad_buffer.items()})
    return (jengine, jopt, j), (tengine, topt, t)


@pytest.mark.parametrize("seq,optimizer", [
    (64, "Adam"), (64, "Lamb"), (64, "FusedLamb"),
    (256, "AdamW"), (256, "FusedLamb"),
])
def test_engine_matches_jax_engine(seq, optimizer, monkeypatch):
    if seq >= jattn.FLASH_MIN_SEQ:
        # the test mesh has 8 devices, where the JAX dispatcher would take
        # its reference; a one-device engine may take the kernels
        monkeypatch.setattr(jattn, "FLASH_MODE", "always")
    (jengine, _, (jl, jg, js)), (tengine, _, (tl, tg, ts)) = _run_pair(
        seq, _config(optimizer))
    assert set(tg) == set(jg)
    for name, want in jg.items():
        np.testing.assert_allclose(tg[name].numpy(), want.numpy(),
                                   err_msg=name, **GRAD_TOL)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert ts == js == [0, 0, 0]
    assert tengine.global_steps == jengine.global_steps == 3
    if "Lamb" in optimizer:
        want = np.asarray(jengine.lamb_coeffs)
        assert want.shape == (16,)  # one per JAX leaf group
        np.testing.assert_allclose(tengine.lamb_coeffs.numpy(), want,
                                   **COEFF_TOL)
    assert tengine.get_lr() == jengine.get_lr()


def test_fp16_loss_scale_schedule_matches_jax_engine():
    """Real float16 on the CPU in both packages, the dynamic scale started
    at 2**17 with a window of 2 and no hysteresis: it doubles after every
    two clean steps until the float16 backward overflows at 2**19, halves
    and climbs again. Skipped steps and the scale after every step must be
    equal."""
    cfg = _config("Adam", train_batch_size=2, gradient_accumulation_steps=1,
                  fp16={"enabled": True, "initial_scale_power": 17,
                        "loss_scale_window": 2, "hysteresis": 1})
    (jengine, jopt), (tengine, topt) = _engines(64, cfg)
    scales = []
    for ids in _batches(64, 8, seed=3):
        for engine, opt, conv in (
            (jengine, jopt, jnp.asarray),
            (tengine, topt, lambda x: torch.from_numpy(x).long()),
        ):
            x = conv(ids)
            engine.backward(engine(x, x))
            engine.step()
        scales.append((tengine.skipped_steps, topt.loss_scale))
        assert scales[-1] == (jengine.skipped_steps, float(jopt.loss_scale))
    skipped = [s for s, _ in scales]
    grown = [b > a for (_, a), (_, b) in zip(scales, scales[1:])]
    assert skipped[-1] >= 2 and sum(grown) >= 2  # overflows and regrowth
    assert tengine.global_steps == jengine.global_steps == 8 - skipped[-1]
