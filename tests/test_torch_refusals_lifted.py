"""What the port refused with ``not_ported`` until the JAX engine's
behaviour was ported, each held to the JAX package on the same weights
and the same numpy batches.

Across 2 gloo ranks (one spawn, tests/torch_dp_ranks.py), against the
JAX engine on a 2-device mesh (tests/torch_dp_gpt2.py: a 2-layer GPT-2
at width 64, 5 windows of 2 micro-batches at lr 1e-4):

- compensated masters (bf16 parameters, int8 codes in the sharded
  optimizer state) at ZeRO stages 1 and 2;
- the adapters block (rank 4; the frozen base replicated, the factors
  through the ZeRO layout) at stages 0-3;
- stage 3 with remat under ``"nothing_saveable+zero3_gathered"``: the
  gathered weights are kept, the backward gathers nothing again, and the
  losses equal the run without the tag.

In one process: the adapters block with optimizer offload and with
compensated masters; LoRA on BERT (losses and factor gradients); BERT
with ``use_flash=False`` (no flash launch); the transformer's
``stochastic_mode``; and the six ``jax.checkpoint_policies`` factories
as remat spec parts, which raise TypeError in both packages.

Tolerances: float32 as tests/test_torch_zero_gpt2.py (rtol 2e-4, atol
1e-5); bf16 compensated masters as tests/test_torch_engine_state_
layouts.py (losses rtol 2e-4; parameters one bf16 ulp, rtol 2**-7, atol
4e-5, all but 0.5% of the elements); BERT losses rtol 1e-5 and
gradients rtol 1e-4, atol 1e-6 (tests/test_torch_bert.py); the bf16
transformer block 2**-6 relative and 2**-6 absolute (two bf16 ulps: the
packages' bf16 matrix products round differently).
"""

import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
import torch_dp_gpt2 as g
import torch_dp_ranks as ranks
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import (
    BertConfig,
    BertForPreTraining,
    GPT2Config,
    GPT2LMHeadModel,
    adapters_from_jax,
    bert_params_from_jax,
    params_from_jax,
)
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops import transformer as ttr
from torch_test_env import jax_compile_cache  # noqa: F401

jattn = importlib.import_module("deepspeed_tpu.ops.attention")
jtr = importlib.import_module("deepspeed_tpu.ops.transformer")

LORA_RANK = 4
Z3G = "nothing_saveable+zero3_gathered"
BF16_LOSS_TOL = dict(rtol=2e-4, atol=0.0)
BF16_PARAM_TOL = dict(rtol=2.0 ** -7, atol=4e-5)
BF16_OUTLIERS = 5e-3
BERT_LOSS_TOL = dict(rtol=1e-5, atol=0.0)
BERT_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BLOCK_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)
COMPENSATED = {"data_types": {"master_dtype": "compensated"}}
ADAPTERS = {"adapters": {"enabled": True, "rank": LORA_RANK}}
# the adapters block with offload or compensated masters, in one process:
# (ZeRO stage, dtype, config blocks)
ONE_PROCESS = {
    "offload": (1, "fp32", dict(ADAPTERS, zero_optimization={
        "stage": 1, "offload_optimizer": {"device": "cpu"}})),
    "compensated": (0, "bf16", dict(ADAPTERS, **COMPENSATED)),
}


# ---------------------------------------------------------------------------
# the JAX engine's runs
# ---------------------------------------------------------------------------
def jax_run(model, model_parameters, dp, stage, opt, dtype, factors=False,
            **extra):
    """The JAX engine's window losses and final trainable parameters (in
    the port's names), at data size ``dp``."""
    cfg = ranks.config(stage, opt, dtype, g.MICRO, g.ACCUM, dp, lr=g.LR,
                       **extra)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=model_parameters, config_params=cfg,
        mesh=build_mesh(devices=jax.devices()[:dp]))
    losses = [float(engine.train_batch(iter(win))) for win in
              ranks.windows("gpt2", g.STEPS, g.ACCUM, g.MICRO * dp)]
    final = jax.device_get(engine.params)
    if engine.master_in_opt:
        final = jax.device_get(engine.optimizer_state["master"])
    got = adapters_from_jax(final) if factors else params_from_jax(final)
    return losses, {n: t.float().numpy() for n, t in got.items()}


def z3g_jmodel():
    return JGPT2LMHeadModel(JGPT2Config(
        vocab_size=ranks.VOCAB, n_positions=ranks.SEQ, n_embd=64, n_layer=2,
        n_head=4, dropout=0.0, remat=True, remat_policy=Z3G))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 2-rank spawn with every dp-2 case, beside the JAX oracles (the
    one-process ones too), each in a thread of its own."""
    _, params = g.jmodel()
    adapters = g.jadapters(params, LORA_RANK)
    workdir = tmp_path_factory.mktemp("lifted")
    base = params_from_jax(jax.device_get(params))
    torch.save(base, workdir / "gpt2.pt")
    torch.save({**base, **adapters_from_jax(adapters)}, workdir / "lora.pt")
    case = {"kind": "train", "model": "gpt2", "steps": g.STEPS,
            "accum": g.ACCUM, "micro": g.MICRO, "lr": g.LR,
            "weights": "gpt2.pt"}
    cases = [dict(case, name=f"compensated-s{s}", stage=s, opt="Adam",
                  dtype="bf16", extra=COMPENSATED) for s in (1, 2)]
    cases += [dict(case, name=f"adapters-s{s}", stage=s, opt="Adam",
                   dtype="fp32", extra=ADAPTERS, model_parameters="lora.pt")
              for s in range(4)]
    cases += [dict(case, name=f"z3-{p}", stage=3, opt="Adam", dtype="fp32",
                   remat=True, remat_policy=p) for p in ("full", Z3G)]
    cases += [{"name": f"order-{p}", "kind": "gather_order", "model": "gpt2",
               "weights": "gpt2.pt", "remat": True, "remat_policy": p,
               "extra": {"zero_optimization": {
                   "stage": 3, "stage3_gather_block": 1}}}
              for p in ("full", Z3G)]
    handle = ranks.start(2, cases, workdir)
    runs = {
        "compensated": (g.fresh_jmodel(), params, 2, 1, "Adam", "bf16",
                        False, COMPENSATED),
        "adapters": (g.fresh_jmodel(), g.merged(params, adapters), 2, 0,
                     "Adam", "fp32", True, ADAPTERS),
        "z3": (z3g_jmodel(), params, 2, 3, "Adam", "fp32", False, {}),
    }
    for layout, (stage, dtype, extra) in ONE_PROCESS.items():
        runs[f"adapters-{layout}"] = (g.fresh_jmodel(),
                                      g.merged(params, adapters), 1,
                                      stage, "Adam", dtype, True, extra)
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {k: pool.submit(jax_run, *a[:7], **a[7])
                   for k, a in runs.items()}
        oracle = {k: f.result() for k, f in futures.items()}
    return ranks.finish(handle, timeout=300), oracle, (params, adapters)


def _bf16_close(got, want):
    """One bf16 ulp for all but BF16_OUTLIERS of the elements."""
    total = bad = 0
    for n, w in want.items():
        ok = np.isclose(got[n], w, **BF16_PARAM_TOL)
        total += ok.size
        bad += int((~ok).sum())
    assert bad <= BF16_OUTLIERS * total, (bad, total)


@pytest.mark.parametrize("stage", [1, 2])
def test_compensated_masters_at_dp2_match_the_jax_engine(runs, stage):
    port, oracle, _ = runs
    losses, params = oracle["compensated"]
    got = port[0][f"compensated-s{stage}"]
    assert port[1][f"compensated-s{stage}"]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], losses, **BF16_LOSS_TOL)
    assert set(got["params"]) == set(params)
    _bf16_close(got["params"], params)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_adapters_at_dp2_match_the_jax_engine(runs, stage):
    port, oracle, _ = runs
    g.check(port, f"adapters-s{stage}", *oracle["adapters"])
    # the factors only: the frozen base is neither stepped nor saved, and
    # stage 3 does not arm the layer-wise gather with adapters
    assert all("_lora_" in n for n in port[0][f"adapters-s{stage}"]["params"])
    assert not port[0][f"adapters-s{stage}"]["zero3_armed"]


def test_zero3_gathered_keeps_the_gathers_and_equals_full(runs):
    port, oracle, _ = runs
    tagged, full = port[0][f"z3-{Z3G}"], port[0]["z3-full"]
    assert tagged["zero3_armed"] and tagged["losses"] == full["losses"]
    g.check(port, f"z3-{Z3G}", *oracle["z3"])
    # "full" re-gathers in the backward; the tag keeps the forward's
    order_full = port[0]["order-full"]["order"]
    order_tagged = port[0][f"order-{Z3G}"]["order"]
    assert any(d == "bwd" for d, _ in order_full)
    assert order_tagged == [("fwd", 0), ("fwd", 1)]


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", list(ONE_PROCESS))
def test_adapters_with_offload_or_compensated_match_the_jax_engine(runs,
                                                                   layout):
    _, oracle, (params, adapters) = runs
    losses, want = oracle[f"adapters-{layout}"]
    stage, dtype, extra = ONE_PROCESS[layout]
    tmodel = GPT2LMHeadModel(GPT2Config(
        vocab_size=ranks.VOCAB, n_positions=ranks.SEQ, n_embd=64, n_layer=2,
        n_head=4, dropout=0.0), device="cpu")
    state = {**params_from_jax(jax.device_get(params)),
             **adapters_from_jax(adapters)}
    cfg = ranks.config(stage, "Adam", dtype, g.MICRO, g.ACCUM, 1, lr=g.LR,
                       **extra)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tmodel, model_parameters=state, config_params=cfg,
        device="cpu")
    assert engine.host_offload == (layout == "offload")
    assert engine.compensated_master == (layout == "compensated")
    base = {n: t.clone() for n, t in engine.frozen_base_params.items()}
    got = [float(engine.train_batch(iter([
        tuple(torch.from_numpy(x) for x in b) for b in win])))
        for win in ranks.windows("gpt2", g.STEPS, g.ACCUM, g.MICRO)]
    final = {n: t.float().numpy() for n, t in
             engine.adapter_state_dict().items()}
    assert set(final) == set(want)
    assert all(torch.equal(base[n], t)
               for n, t in engine.frozen_base_params.items())
    if layout == "offload":
        np.testing.assert_allclose(got, losses, **g.TOL)
        for n, w in want.items():
            np.testing.assert_allclose(final[n], w, err_msg=n, **g.TOL)
    else:
        np.testing.assert_allclose(got, losses, **BF16_LOSS_TOL)
        _bf16_close(final, want)


def _bert_kw(seq, **kw):
    return dict(vocab_size=100, hidden_size=64, num_hidden_layers=1,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=seq, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, **kw)


def _bert_batch(seq, b=3, seed=0):
    """ids, a ragged padding mask, segment ids, 15% MLM labels, NSP."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 100, (b, seq)).astype(np.int32)
    mask = np.zeros((b, seq), np.int32)
    for i, n in enumerate((seq, seq * 3 // 4, seq // 2 + 1)[:b]):
        mask[i, :n] = 1
    tt = np.broadcast_to((np.arange(seq) >= seq // 3).astype(np.int32),
                         (b, seq)).copy()
    labels = np.where(rng.random((b, seq)) < 0.15, ids, -100)
    return (ids, mask, tt, labels.astype(np.int32),
            rng.integers(0, 2, (b,)).astype(np.int32))


def _bert_pair(seq, **kw):
    """The JAX and port BERT on the same weights (LoRA B noised so that
    both factors have gradients)."""
    jmodel = jbert.BertForPreTraining(jbert.BertConfig(**_bert_kw(seq, **kw)))
    batch = _bert_batch(seq)
    params = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0)}, *map(jnp.asarray, batch),
        train=False)["params"])
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: ((0.02 * rng.normal(size=x.shape)).astype(np.float32)
                      if jax.tree_util.keystr(p).endswith("_lora_b']")
                      else np.asarray(x)), params)
    tmodel = BertForPreTraining(BertConfig(**_bert_kw(seq, **kw)),
                                device="cpu")
    tmodel.load_state_dict(bert_params_from_jax(params))
    return jmodel, params, tmodel, batch


def _bert_check(seq, monkeypatch, **kw):
    """Loss and gradients of both packages; returns the port's flash
    launches."""
    if seq >= jattn.FLASH_MIN_SEQ:
        monkeypatch.setattr(jattn, "FLASH_MODE", "always")
    launches = []
    flash = tattn.flash_attention

    def counted(*args, **kwargs):
        launches.append(1)
        return flash(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attention", counted)
    jmodel, params, tmodel, batch = _bert_pair(seq, **kw)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, *map(jnp.asarray, batch),
                               train=False))(params)
    tloss = tmodel(*(torch.from_numpy(a).long() for a in batch), train=False)
    names = [n for n, _ in tmodel.named_parameters()]
    grads = torch.autograd.grad(tloss, list(tmodel.parameters()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **BERT_LOSS_TOL)
    want = bert_params_from_jax(jax.device_get(jgrads))
    for n, gt in zip(names, grads):
        if "_lora_" in n or not kw.get("lora_rank"):
            np.testing.assert_allclose(gt.numpy(), want[n].numpy(),
                                       err_msg=n, **BERT_GRAD_TOL)
    return len(launches), names


@pytest.mark.parametrize("seq", [16, 256])
def test_bert_lora_losses_and_factor_gradients_match_jax(seq, monkeypatch):
    launches, names = _bert_check(seq, monkeypatch, lora_rank=LORA_RANK)
    assert sum("_lora_" in n for n in names) == 4 * 2
    assert launches == (1 if seq >= tattn.FLASH_MIN_SEQ else 0)


def test_bert_without_flash_matches_jax_and_launches_no_kernel(monkeypatch):
    launches, _ = _bert_check(256, monkeypatch, use_flash=False)
    assert launches == 0
    assert tattn.routes_to_flash(None, 256, 256)


def _block_pair(stochastic):
    """The JAX layer (bf16 weights from its initializer, the input bf16)
    and the port's block on the same weights."""
    base = dict(hidden_size=64, heads=4, attn_dropout_ratio=0.0,
                hidden_dropout_ratio=0.0)
    jcfg = jtr.DeepSpeedTransformerConfig(stochastic_mode=stochastic, **base)
    jlayer = jtr.DeepSpeedTransformerLayer(config=jcfg)
    x = jnp.asarray(np.random.default_rng(3).normal(size=(2, 64, 64)),
                    jnp.bfloat16)
    params = jlayer.init(jax.random.PRNGKey(0), x, train=False)["params"]
    tcfg = ttr.DeepSpeedTransformerConfig(stochastic_mode=stochastic, **base)
    layer = ttr.DeepSpeedTransformerLayer(tcfg, "cpu", torch.bfloat16)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            v = np.asarray(jax.device_get(params[name]).astype(np.float32))
            p.copy_(torch.from_numpy(v.T.copy() if v.ndim == 2 else v))
    jout = np.asarray(jlayer.apply({"params": params}, x, train=False),
                      np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        tout = ttr.transformer_block_apply(tcfg, layer, xt).float().numpy()
    return jout, tout


def test_stochastic_mode_matches_jax_and_differs_from_the_default():
    ttr._STOCHASTIC_NOTICED[0] = False
    jout_s, tout_s = _block_pair(True)
    jout_d, tout_d = _block_pair(False)
    assert ttr._STOCHASTIC_NOTICED[0]
    np.testing.assert_allclose(tout_s, jout_s, **BLOCK_TOL)
    np.testing.assert_allclose(tout_d, jout_d, **BLOCK_TOL)
    # a real change of path, close to the default (the JAX test's bound)
    assert not np.array_equal(tout_s, tout_d)
    np.testing.assert_allclose(tout_s, tout_d, rtol=0.1, atol=0.1)
    # the LayerNorm alone: bf16 statistics differ from float32 ones
    cfg = ttr.DeepSpeedTransformerConfig(hidden_size=64, heads=4,
                                         stochastic_mode=True)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 64)).astype(np.float32) * 3 + 1).to(torch.bfloat16)
    one, zero = torch.ones(64), torch.zeros(64)
    relaxed = ttr.layer_norm_apply(cfg, x, one, zero)
    cfg.stochastic_mode = False
    assert not torch.equal(relaxed, ttr.layer_norm_apply(cfg, x, one, zero))


@pytest.mark.parametrize("part", list(ttr.JAX_POLICY_FACTORIES))
def test_policy_factories_raise_type_error_in_both_packages(part):
    with pytest.raises(TypeError, match="cannot run it as a policy"):
        ttr.resolve_remat_policy(part)
    model = GPT2LMHeadModel(GPT2Config(
        vocab_size=64, n_positions=16, n_embd=32, n_layer=1, n_head=2,
        remat=True, remat_policy=part), device="cpu")
    with pytest.raises(TypeError, match="cannot run it as a policy"):
        deepspeed_tpu_torch.initialize(
            model=model, config_params={"train_batch_size": 2},
            device="cpu")
    jpolicy = jtr.resolve_remat_policy(part)
    with pytest.raises(TypeError):
        jax.grad(jax.checkpoint(lambda x: jnp.sum(jnp.sin(x @ x)),
                                policy=jpolicy))(jnp.ones((2, 2)))
