"""Port parity for the engine's optimizer-state layouts on a 2-layer
GPT-2 (seq 64, the plain attention route), 4 windows of 2 micro-batches:
``optimizer_state_dtype`` bf16/int8 (Adam, Lamb), SGD, Lion, optimizer
offload and compensated masters, each through ``initialize()`` against
the JAX engine on the same weights (``params_from_jax``) and the same
numpy batches; then what only the port can show: offload equals the
on-device run bit for bit, the refusals carry the JAX engine's messages,
and checkpoints of these layouts resume bit for bit and cross layouts.

Tolerances: float32 compute: losses rtol 1e-5, LAMB trust ratios rtol
1e-5, and every final parameter (the fp32 masters) within rtol 1e-5 and
atol 4e-5, 1% of the most 4 windows can move an element at lr 1e-3: the
gradients agree to rtol 1e-4 (test_torch_engine.py), and Adam divides an
element's gradient by its own running norm, which turns those last bits
into a fraction of a step where the gradient is near zero (observed at
most 1.8e-5). Lion takes the sign of its momentum, which flips where
the momentum is near zero: all but 0.1% of its elements within that
tolerance (observed 75 of 120 576), every one within 2 lr a window.
Compensated masters need a compute dtype below float32; in bfloat16 the
two packages' matrix products round differently (one bf16 ulp is 2**-8
relative), so losses are held to rtol 2e-4 (observed 4.2e-5) and all but
0.5% of the parameters (bfloat16) to one bf16 ulp (rtol 2**-7) and atol
4e-5 (observed 165 of 120 576 beyond, 125 of them the attention key bias,
whose true gradient is zero and which Adam moves by its numerical
noise). Within the port: offload against the on-device run, resumes and
layout crossings bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import DeepSpeedConfigError as JConfigError
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel, params_from_jax
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from deepspeed_tpu_torch.ops import quant as tq
from torch_test_env import jax_compile_cache  # noqa: F401

VOCAB, SEQ, WINDOWS, ACCUM = 256, 64, 4, 2
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
LR = 1e-3
PARAM_TOL = dict(rtol=1e-5, atol=1e-2 * LR * WINDOWS)
COEFF_TOL = dict(rtol=1e-5, atol=0.0)
BF16_LOSS_TOL = dict(rtol=2e-4, atol=0.0)
BF16_PARAM_TOL = dict(rtol=2.0 ** -7, atol=1e-2 * LR * WINDOWS)
# the share of elements allowed beyond PARAM_TOL / BF16_PARAM_TOL
LION_OUTLIERS, COMPENSATED_OUTLIERS = 1e-3, 5e-3


def _jmodel():
    return JGPT2LMHeadModel(JGPT2Config(
        vocab_size=VOCAB, n_positions=SEQ, n_embd=64, n_layer=2, n_head=4,
        dropout=0.0))


@functools.lru_cache(maxsize=None)
def _jax_init(seed):
    """The JAX model's weights from PRNGKey(seed), made once a module."""
    ids0 = jnp.zeros((1, 8), jnp.int32)
    return jax.device_get(_jmodel().init(
        {"params": jax.random.PRNGKey(seed)}, ids0, ids0)["params"])


def _jax_params(seed=0):
    """A fresh JAX model (an engine arms its config) and the shared
    weights."""
    return _jmodel(), _jax_init(seed)


def _port_model(params=None, seed=0):
    model = GPT2LMHeadModel(
        GPT2Config(vocab_size=VOCAB, n_positions=SEQ, n_embd=64, n_layer=2,
                   n_head=4, dropout=0.0), device="cpu", seed=seed)
    if params is not None:
        model.load_state_dict(params_from_jax(jax.device_get(params)))
    return model


def _config(optimizer="Adam", opt_params=None, **extra):
    cfg = {
        "train_batch_size": 2 * ACCUM,
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": ACCUM,
        "optimizer": {"type": optimizer,
                      "params": dict({"lr": LR}, **(opt_params or {}))},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_max_lr": LR,
                                 "warmup_num_steps": 2}},
        "gradient_clipping": 1.0,
        "steps_per_print": 1000,
    }
    cfg.update(extra)
    return cfg


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (2, SEQ)).astype(np.int32)
            for _ in range(n)]


def _drive(engine, batches, to_input):
    """forward/backward over the batches, a step every ACCUM; the
    micro-step losses."""
    losses = []
    for i, ids in enumerate(batches):
        x = to_input(ids)
        loss = engine(x, x)
        engine.backward(loss)
        losses.append(float(np.asarray(
            loss.detach() if isinstance(loss, torch.Tensor) else loss)))
        if (i + 1) % ACCUM == 0:
            engine.step()
    return np.array(losses)


def _torch_ids(ids):
    return torch.from_numpy(ids).long()


def _port_engine(cfg, seed=0, params=None):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_port_model(params, seed), config_params=cfg, device="cpu")
    return engine


def _jax_masters(engine):
    """The JAX engine's float32 masters as the port's state dict."""
    tree = (engine.optimizer_state["master"] if engine.master_in_opt
            else engine.params)
    return params_from_jax(jax.device_get(
        jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)))


def _assert_params(params, want, dtype, tol, outliers=0.0, bound=None):
    """Every parameter within ``tol`` of JAX's, but for at most the share
    ``outliers`` of all elements, which stay within ``bound``."""
    beyond = total = 0
    for n, p in params.items():
        assert p.dtype == dtype, n
        got = p.detach().float()
        diff = (got - want[n]).abs()
        bad = diff > tol["atol"] + tol["rtol"] * want[n].abs()
        beyond += int(bad.sum())
        total += got.numel()
        if not outliers:
            assert not bad.any(), (n, float(diff.max()))
        elif bound is not None:
            assert float(diff.max()) <= bound, (n, float(diff.max()))
    assert beyond <= outliers * total, (beyond, total)


LAYOUTS = {
    "adam_bf16_state": ("Adam", {"weight_decay": 0.01},
                        {"data_types": {"optimizer_state_dtype": "bf16"}}),
    "adam_int8_state": ("Adam", {"weight_decay": 0.01},
                        {"data_types": {"optimizer_state_dtype": "int8"}}),
    "lamb_bf16_state": ("Lamb", {"weight_decay": 0.01},
                        {"data_types": {"optimizer_state_dtype": "bf16"}}),
    "lamb_int8_state": ("Lamb", {"weight_decay": 0.01},
                        {"data_types": {"optimizer_state_dtype": "int8"}}),
    "sgd_nesterov": ("SGD", {"momentum": 0.9, "nesterov": True,
                             "weight_decay": 0.01}, {}),
    "lion": ("Lion", {"weight_decay": 0.01}, {}),
    "adam_offload": ("Adam", {"weight_decay": 0.01},
                     {"zero_optimization": {
                         "stage": 1, "offload_optimizer": {"device": "cpu"}}}),
    "adam_compensated_bf16": ("AdamW", {"weight_decay": 0.01},
                              {"bf16": {"enabled": True},
                               "data_types": {"master_dtype": "compensated"}}),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_matches_jax_engine(layout):
    optimizer, opt_params, extra = LAYOUTS[layout]
    cfg = _config(optimizer, opt_params, **extra)
    jmodel, params = _jax_params()
    jengine, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params, config_params=cfg,
        mesh=build_mesh(devices=jax.devices()[:1]))
    tengine = _port_engine(cfg, params=params)
    batches = _batches(WINDOWS * ACCUM)
    jl = _drive(jengine, batches, jnp.asarray)
    tl = _drive(tengine, batches, _torch_ids)
    assert tengine.global_steps == jengine.global_steps == WINDOWS
    assert tengine.skipped_steps == jengine.skipped_steps == 0
    want = _jax_masters(jengine)
    if layout == "adam_compensated_bf16":
        assert jengine.compensated_master and tengine.compensated_master
        np.testing.assert_allclose(tl, jl, **BF16_LOSS_TOL)
        _assert_params(tengine.params, want, torch.bfloat16, BF16_PARAM_TOL,
                       COMPENSATED_OUTLIERS)
        codes = tengine.optimizer_state["comp"]
        assert set(codes) == set(tengine.params)
        assert sum(int((c != 0).sum()) for c in codes.values()) > 0
        return
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    if layout == "lion":
        _assert_params(tengine.params, want, torch.float32, PARAM_TOL,
                       LION_OUTLIERS, bound=2 * LR * WINDOWS)
    else:
        _assert_params(tengine.params, want, torch.float32, PARAM_TOL)
    if optimizer == "Lamb":
        np.testing.assert_allclose(tengine.lamb_coeffs.numpy(),
                                   np.asarray(jengine.lamb_coeffs),
                                   **COEFF_TOL)
    if "int8" in layout:
        mu = tengine.optimizer_state["mu"]
        assert all(tq.is_quantized(leaf) for leaf in mu.values())
        assert "h.*.attn_qkvw" in mu  # one leaf per group
    if layout == "adam_offload":
        assert tengine.host_offload and jengine.host_offload
        for n, p in tengine.module_params.items():
            assert p.dtype == torch.float32  # the compute dtype here
            assert p.data_ptr() != tengine.params[n].data_ptr()


def test_offload_equals_the_on_device_run():
    """bf16 compute, Adam: moving the masters and the moments to the host
    changes no bit of a loss, a master or a published parameter (the JAX
    contract, test_host_offload.py:87-93), through forward/backward/step
    and through train_batch with the data_pipeline block (which offload
    bypasses, as the JAX engine does)."""
    base = _config("Adam", {"weight_decay": 0.01}, bf16={"enabled": True})
    off = dict(base, zero_optimization={
        "stage": 2, "offload_optimizer": {"device": "cpu"}})
    batches = _batches(WINDOWS * ACCUM, seed=1)
    on_dev = _port_engine(base)
    offload = _port_engine(off)
    assert offload.host_offload and not on_dev.host_offload
    for n, p in offload.module_params.items():
        assert p.dtype == torch.bfloat16
        assert offload.params[n].dtype == torch.float32
    lo, lf = (_drive(e, batches, _torch_ids) for e in (on_dev, offload))
    np.testing.assert_array_equal(lf, lo)
    for n, p in on_dev.params.items():
        assert torch.equal(offload.params[n], p), n
        assert torch.equal(offload.module_params[n], p.to(torch.bfloat16)), n
    for key in ("mu", "nu"):
        for n, m in on_dev.optimizer_state[key].items():
            assert torch.equal(offload.optimizer_state[key][n], m), n
    # train_batch with staging on: offload runs unstaged, still equal
    staged = dict(off, data_pipeline={"enabled": True})
    windows = [[(_torch_ids(b), _torch_ids(b)) for b in batches[i:i + ACCUM]]
               for i in range(0, len(batches), ACCUM)]
    engine = _port_engine(staged)
    stream = (mb for w in windows for mb in w)
    losses = [float(engine.train_batch(stream)) for _ in windows]
    assert engine._stager is None and engine.global_steps == WINDOWS
    np.testing.assert_array_equal(
        losses, lo.reshape(WINDOWS, ACCUM).mean(axis=1).astype(np.float32))
    for n, p in on_dev.params.items():
        assert torch.equal(engine.params[n], p), n


def test_offload_skips_an_overflowed_step_without_touching_the_masters():
    """fp16 at a loss scale the backward overflows: the step is skipped,
    the host masters and the device parameters stay as they were."""
    cfg = _config("Adam", fp16={"enabled": True, "initial_scale_power": 60,
                                "hysteresis": 1},
                  zero_optimization={"offload_optimizer": {"device": "cpu"}})
    engine = _port_engine(cfg)
    masters = {n: p.clone() for n, p in engine.params.items()}
    device = {n: p.clone() for n, p in engine.module_params.items()}
    _drive(engine, _batches(ACCUM), _torch_ids)
    assert engine.skipped_steps == 1 and engine.global_steps == 0
    for n in masters:
        assert torch.equal(engine.params[n], masters[n]), n
        assert torch.equal(engine.module_params[n], device[n]), n


def _jax_refusal(cfg):
    jmodel, params = _jax_params()
    with pytest.raises(JConfigError) as info:
        deepspeed_tpu.initialize(model=jmodel, model_parameters=params,
                                 config_params=cfg,
                                 mesh=build_mesh(devices=jax.devices()[:1]))
    return str(info.value)


@pytest.mark.parametrize("case", [
    ("Adam", {"bf16": {"enabled": True},
              "data_types": {"master_dtype": "compensated"},
              "zero_optimization": {"offload_optimizer": {"device": "cpu"}}}),
    ("SGD", {"data_types": {"optimizer_state_dtype": "bf16"}}),
    ("Lion", {"data_types": {"optimizer_state_dtype": "int8"}}),
    ("FusedLamb", {"data_types": {"optimizer_state_dtype": "bf16"}}),
    ("Lamb", {"bf16": {"enabled": True},
              "data_types": {"master_dtype": "compensated"}}),
    ("SGD", {"zero_optimization": {"stage": 1}}),
], ids=["offload_and_compensated", "sgd_state_dtype", "lion_state_dtype",
        "fusedlamb_state_dtype", "lamb_compensated", "sgd_untested_zero"])
def test_refusals_carry_the_jax_messages(case):
    optimizer, extra = case
    cfg = _config(optimizer, **extra)
    want = _jax_refusal(cfg)
    with pytest.raises(DeepSpeedConfigError) as info:
        _port_engine(cfg)
    assert str(info.value) == want


def test_untested_optimizer_under_zero_runs_with_the_opt_in():
    cfg = _config("Lion", zero_optimization={"stage": 1},
                  zero_allow_untested_optimizer=True)
    engine = _port_engine(cfg)
    _drive(engine, _batches(ACCUM), _torch_ids)
    assert engine.global_steps == 1


def _state_leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _state_leaves(tree[k], f"{prefix}/{k}")


RESUMES = {
    "int8": _config("Adam", data_types={"optimizer_state_dtype": "int8"},
                    bf16={"enabled": True}),
    "compensated": _config("Adam", data_types={"master_dtype": "compensated"},
                           bf16={"enabled": True}),
    "offload": _config("Adam", bf16={"enabled": True}, zero_optimization={
        "offload_optimizer": {"device": "cpu"}}),
}


@pytest.mark.parametrize("layout", sorted(RESUMES))
def test_checkpoint_resumes_bit_for_bit(layout, tmp_path):
    """Train 2 windows, save, train 2 more; a fresh engine of another
    seed loads the checkpoint and trains the same 2: equal losses, masters,
    module parameters and every state tensor (int8 codes and scales, the
    compensation codes, the offloaded moments)."""
    cfg = RESUMES[layout]
    batches = _batches(2 * WINDOWS, seed=2)
    half = WINDOWS * ACCUM // 2
    first = _port_engine(cfg)
    _drive(first, batches[:half], _torch_ids)
    first.save_checkpoint(str(tmp_path), tag="mid")
    cont = _drive(first, batches[half:2 * half], _torch_ids)
    fresh = _port_engine(cfg, seed=7)
    path, _ = fresh.load_checkpoint(str(tmp_path), tag="mid")
    assert path is not None
    resumed = _drive(fresh, batches[half:2 * half], _torch_ids)
    np.testing.assert_array_equal(resumed, cont)
    for n, p in first.params.items():
        assert torch.equal(fresh.params[n], p), n
        assert torch.equal(fresh.module_params[n], first.module_params[n]), n
    a = dict(_state_leaves(first.optimizer_state))
    b = dict(_state_leaves(fresh.optimizer_state))
    assert set(a) == set(b) and a
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    if layout == "int8":
        assert any("/q" in k for k in a)
    if layout == "compensated":
        assert any(k.startswith("/comp/") for k in a)


def test_checkpoint_crosses_offload_and_on_device_layouts(tmp_path):
    """test_master_weights.py:171 at world size 1: the optimizer file's
    canonical {master, inner} carries an offload run's fp32 masters into
    an on-device bf16 engine bit for bit (never through the module file's
    bf16 weights), and an on-device run's into an offload engine; both
    continue exactly as the saving run does."""
    base = _config("Adam", bf16={"enabled": True})
    off = dict(base, zero_optimization={"offload_optimizer": {
        "device": "cpu"}})
    batches = _batches(2 * WINDOWS, seed=3)
    half = WINDOWS * ACCUM // 2
    for save_cfg, load_cfg, tag in ((off, base, "a"), (base, off, "b")):
        saver = _port_engine(save_cfg)
        _drive(saver, batches[:half], _torch_ids)
        saver.save_checkpoint(str(tmp_path / tag), tag="t")
        masters = {n: p.clone() for n, p in saver.params.items()}
        cont = _drive(saver, batches[half:2 * half], _torch_ids)
        loader = _port_engine(load_cfg, seed=7)
        loader.load_checkpoint(str(tmp_path / tag), tag="t")
        for n, p in loader.params.items():
            assert p.dtype == torch.float32
            assert torch.equal(p, masters[n]), n
            assert torch.equal(loader.module_params[n].to(torch.bfloat16),
                               masters[n].to(torch.bfloat16)), n
        resumed = _drive(loader, batches[half:2 * half], _torch_ids)
        np.testing.assert_array_equal(resumed, cont)
