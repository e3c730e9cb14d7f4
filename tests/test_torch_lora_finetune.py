"""Port parity for the LoRA fine-tune path: ``initialize()`` with the
``adapters`` block in deepspeed_tpu_torch against deepspeed_tpu's engine
built on a ONE-device mesh (the test conftest has 8 CPU devices, which
would change the batch triangle), both from the same converted base
(``params_from_jax``) and the same adapter init (the JAX package's
``init_lora_params``, carried over with ``adapters_from_jax``), fed the
same numpy batches at dropout 0 in float32.

S=64 runs the plain attention reference in both packages; S=256 runs the
flash path in both (the JAX kernels in interpret mode, forced past the
8-device mesh's routing; the port's kernels' plain versions).

Tolerances: losses rtol 1e-5 (float32 through two layers, summed in
other orders, as tests/test_torch_engine.py); the tuned factors atol
5e-5 (0.5% of one Adam step); LAMB trust ratios per JAX leaf group rtol
1e-5; the frozen base is compared bitwise.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.adapters import lora as jlora
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import (
    GPT2Config,
    GPT2LMHeadModel,
    adapters_from_jax,
    params_from_jax,
)
from deepspeed_tpu_torch.adapters import adapter_num_params, init_lora_params
from deepspeed_tpu_torch.config import DeepSpeedConfigError
from torch_test_env import jax_compile_cache  # noqa: F401

jattn = importlib.import_module("deepspeed_tpu.ops.attention")

VOCAB = 128
RANK = 4
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
COEFF_TOL = dict(rtol=1e-5, atol=0.0)


def _models(seq, **port_kw):
    jcfg = JGPT2Config(vocab_size=VOCAB, n_positions=seq, n_embd=32,
                       n_layer=2, n_head=4, dropout=0.0)
    jmodel = JGPT2LMHeadModel(jcfg)
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        ids0, ids0,
    )["params"])
    model = GPT2LMHeadModel(
        GPT2Config(vocab_size=VOCAB, n_positions=seq, n_embd=32, n_layer=2,
                   n_head=4, dropout=0.0, **port_kw),
        device="cpu",
    )
    return jmodel, params, model


def _config(optimizer="Adam", **extra):
    cfg = {
        "train_batch_size": 4,
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": optimizer, "params": {"lr": 1e-2}},
        "adapters": {"enabled": True, "rank": RANK, "alpha": 8.0},
        "steps_per_print": 1000,
    }
    cfg.update(extra)
    return cfg


def _windows(seq, n, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, VOCAB, (2, seq)).astype(np.int32)
             for _ in range(2)] for _ in range(n)]


def _port_engine(model, cfg, **kw):
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfg, device="cpu", **kw)
    return engine


def _train(engine, windows, conv):
    return np.array([
        float(np.asarray(engine.train_batch([(conv(x), conv(x)) for x in w])))
        for w in windows
    ])


@pytest.mark.parametrize("seq,optimizer", [
    (64, "Adam"), (64, "Lamb"), (256, "Adam"),
])
def test_lora_finetune_matches_jax_engine(seq, optimizer, monkeypatch):
    if seq >= jattn.FLASH_MIN_SEQ:
        monkeypatch.setattr(jattn, "FLASH_MODE", "always")
    jmodel, params, model = _models(seq)
    ada = jlora.init_lora_params(params, RANK, rng=jax.random.PRNGKey(3))
    cfg = _config(optimizer)
    jengine, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=jlora.merge_lora_params(params, ada),
        config_params=cfg, mesh=build_mesh(devices=jax.devices()[:1]),
    )
    tengine = _port_engine(
        model, cfg,
        model_parameters={**params_from_jax(params), **adapters_from_jax(ada)},
    )
    windows = _windows(seq, 3)
    jl = _train(jengine, windows, jnp.asarray)
    tl = _train(tengine, windows, lambda x: torch.from_numpy(x).long())
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert tengine.global_steps == jengine.global_steps == 3
    # the fine-tuned factors agree with the JAX engine's: Adam scales
    # each step to ~lr (1e-2) whatever the gradient's size, so an element
    # whose gradient is near zero may move by another fraction of a step;
    # atol 5e-5 is 0.5% of one step
    want = adapters_from_jax(jax.device_get(jengine.params))
    got = tengine.adapter_state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=5e-5,
                                   rtol=1e-4, err_msg=name)
    if optimizer == "Lamb":
        want = np.asarray(jengine.lamb_coeffs)
        assert want.shape == (8,)  # one per stacked JAX adapter leaf
        np.testing.assert_allclose(tengine.lamb_coeffs.numpy(), want,
                                   **COEFF_TOL)


def test_only_adapters_train_and_the_base_is_bitwise_frozen(tmp_path):
    _, params, model = _models(64)
    model.load_state_dict(params_from_jax(params))
    before = {n: p.detach().clone() for n, p in model.state_dict().items()}
    engine = _port_engine(model, _config())
    names = set(engine.params)
    assert names and all("_lora_" in n for n in names)
    assert set(engine.optimizer_state["mu"]) == names
    # per layer: qkv 32*4 + 4*96, attn_ow 32*4 + 4*32, inter_w 32*4 +
    # 4*128, output_w 128*4 + 4*32 = 2048
    assert adapter_num_params(engine.params) == 2 * 2048
    losses = _train(engine, _windows(64, 4), lambda x: torch.from_numpy(x).long())
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    for n, p in engine.frozen_base_params.items():
        assert not p.requires_grad
        assert torch.equal(p, before[n]), n
        assert torch.equal(model.state_dict()[n], before[n]), n
    tuned = engine.adapter_state_dict()
    assert any(t.any() for n, t in tuned.items() if n.endswith("_lora_b"))
    # a fine-tune's checkpoint holds the factors (and their moments) only
    engine.save_checkpoint(str(tmp_path))
    saved = torch.load(
        tmp_path / "global_step4" / "mp_rank_00_model_states.pt",
        weights_only=True)
    assert set(saved["module"]) == names
    assert saved["client_state"]["adapters"]["rank"] == RANK


def test_trainable_count_is_the_adapter_size():
    """GPT-2 small's adapter at rank 16 on all four targets: 12 layers x
    (768*16 + 16*2304 + 768*16 + 16*768 + 768*16 + 16*3072 + 3072*16 +
    16*768) = 2,359,296 parameters, counted from shapes (no forward)."""
    base = {f"h.{i}.{n}": torch.empty(shape, device="meta")
            for i in range(12)
            for n, shape in (("attn_qkvw", (2304, 768)),
                             ("attn_ow", (768, 768)),
                             ("inter_w", (3072, 768)),
                             ("output_w", (768, 3072)))}
    fresh = init_lora_params(base, 16, generator=torch.Generator())
    assert adapter_num_params(fresh) == 2_359_296


def test_fresh_adapter_forward_is_bitwise_the_base():
    """B = 0 at init: the armed model's forward IS the base forward, bit
    for bit, and the model's own LoRA init draws after every base tensor
    (the same seed gives the same base weights with LoRA on)."""
    _, params, base_model = _models(64)
    ids = torch.from_numpy(
        np.random.default_rng(3).integers(0, VOCAB, (2, 12))
    ).long()
    lora_model = GPT2LMHeadModel(
        GPT2Config(vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2,
                   n_head=4, dropout=0.0, lora_rank=RANK),
        device="cpu",
    )
    for n, p in base_model.state_dict().items():
        assert torch.equal(lora_model.state_dict()[n], p), n
    a = lora_model.state_dict()["h.0.attn_qkvw_lora_a"]
    assert a.any() and not lora_model.state_dict()["h.0.attn_qkvw_lora_b"].any()
    assert torch.equal(lora_model(ids), base_model(ids))
    # the engine's own init (model at rank 0, armed by the block)
    engine = _port_engine(base_model, _config())
    assert base_model.config.lora_rank == RANK
    engine.eval()
    loss_fresh = engine(ids, ids)
    plain = GPT2LMHeadModel(
        GPT2Config(vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2,
                   n_head=4, dropout=0.0),
        device="cpu",
    )
    assert torch.equal(loss_fresh, plain(ids, ids))


def test_model_config_mismatch_is_rejected():
    _, _, model = _models(64, lora_rank=3)
    with pytest.raises(DeepSpeedConfigError, match="lora_rank"):
        _port_engine(model, _config())  # the block asks rank 4


def test_a_finetuned_adapter_serves_through_load_adapter():
    """The port end to end: fine-tune an adapter on a frozen base, load
    it into a serving engine's pool, and serve it beside the base: the
    greedy tokens equal the fine-tuned model's full-forward argmax
    rollout."""
    _, params, model = _models(64)
    model.load_state_dict(params_from_jax(params))
    base_state = {n: p.detach().clone() for n, p in model.state_dict().items()}
    engine = _port_engine(model, _config(optimizer="Adam"))
    rng = np.random.default_rng(5)
    memo = rng.integers(0, VOCAB, (2, 64)).astype(np.int32)
    for _ in range(6):
        engine.train_batch([(torch.from_numpy(memo).long(),) * 2] * 2)
    serve = deepspeed_tpu_torch.init_inference(
        model=model, model_parameters=base_state, device="cpu",
        config={"inference": {"max_batch_slots": 2, "max_seq_len": 64,
                              "prefill_len": 16, "kv_block_size": 8,
                              "fused_decode": True,
                              "sampling": {"greedy": True}},
                "adapters": {"enabled": True, "rank": RANK, "alpha": 8.0,
                             "pool_slots": 2}},
    )
    try:
        assert serve.adapter_scale == 2.0
        serve.load_adapter("tuned", adapter_state=engine.adapter_state_dict())
        prompt = [int(t) for t in memo[0, :8]]
        tuned = serve.generate([prompt], max_new_tokens=8, adapter="tuned")[0]
        base = serve.generate([prompt], max_new_tokens=8)[0]
        assert tuned != base
        # the pool path (SGMV in decode) serves what the fine-tuned model's
        # own full forward (per-layer factors) rolls out greedily
        ids = list(prompt)
        for _ in range(8):
            logits = model(torch.tensor([ids]))
            ids.append(int(logits[0, -1, :VOCAB].argmax()))
        assert tuned == ids[len(prompt):]
    finally:
        serve.close()
