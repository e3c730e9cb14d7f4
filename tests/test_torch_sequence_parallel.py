"""Sequence parallelism in the port, held to the JAX package's.

Function level: the port's ring and Ulysses attention (parallel/
sequence.py, the global forms) on 2 and 4 gloo ranks against the JAX
package's ``ring_attention``/``ulysses_attention`` on a sequence mesh of
the same size, with the same inputs from a numpy seed: tests/unit/
test_sequence_parallel.py's cases (plain and causal, a padding mask,
fully masked rows giving zeros, the gradients, the uneven-head dispatch,
Ulysses refusing uneven heads, the ring's dropout keeping the
distribution and not the bits) and ``auto`` choosing by the model rank's
heads at sequence 2 x model 2.

Engine level: GPT-2 (2 layers, width 64, 4 heads, vocab 256, sequence
32; tests/torch_dp_gpt2.py's weights and schedule) at a sequence axis of
2 with dp 1, dp 2 and a model axis of 2, ZeRO stages 0-3 with Adam (and
FusedLamb at one stage at dp 2 and at mp 2), against the JAX engine on the same
mesh: losses and whole parameters at ``rtol=2e-4, atol=1e-5``. The
optimizer-state layouts at sequence 2 x data 2, ZeRO 2: int8 and bf16
moments (float32 compute, the same tolerance) and compensated masters
(bfloat16 compute: losses rtol 2e-4, all but 0.5% of the parameters
within one bf16 ulp, rtol 2**-7, and atol 1% of the most the windows can
move an element, as test_torch_engine_state_layouts.py holds them). The ring trains too
(forced by ``seq_parallel_impl``). A checkpoint saved at sequence 2 x
data 2 loads in one process. And the refusals, each by its message (the
lifted ones build).

Two spawns (tests/torch_dp_ranks.py): 2 ranks for sequence 2 alone, 4
ranks for sequence 4, sequence 2 x data 2, sequence 2 x model 2 and the
MLP at pipe 2 x data 2; the JAX oracles compute meanwhile.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch as dst
import torch_dp_gpt2 as g
import torch_dp_ranks as ranks
from deepspeed_tpu.models.gpt2 import partition_specs as jpartition_specs
from deepspeed_tpu.ops.attention import NEG_INF, mha_reference
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.parallel.sequence import (
    ring_attention,
    sequence_parallel_attention,
    ulysses_attention,
)
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu_torch import (
    adapters_from_jax,
    bert_params_from_jax,
    params_from_jax,
)
from torch_test_env import jax_compile_cache  # noqa: F401

sys.path.insert(0, str(Path(__file__).parent / "unit"))
from simple_model import SimpleModel  # noqa: E402

ATOL_OUT = 2e-5  # test_sequence_parallel.py's output tolerance
# (name, sp, dp, mp) of the engine layouts, the spawn that runs each
LAYOUTS = {"sp2": (2, 1, 1), "sp2dp2": (2, 2, 1), "sp2mp2": (2, 1, 2)}
WORLD = {"sp2": 2, "sp2dp2": 4, "sp2mp2": 4}
# the JAX oracle's stage per layout (its losses do not depend on the
# stage), rotated
JAX_STAGE = {"sp2": 0, "sp2dp2": 1, "sp2mp2": 3}
# FusedLamb at one port stage of the layouts with more than one
# reduction of its norms (its oracle at the same stage)
LAMB_STAGE = {"sp2dp2": 3, "sp2mp2": 1}
# the optimizer-state layouts a sequence axis trains (ZeRO 2 at sequence
# 2 x data 2): {name: (config changes, compute dtype)}
STATES = {
    "int8": ({"data_types": {"optimizer_state_dtype": "int8"}}, "fp32"),
    "bf16_moments": ({"data_types": {"optimizer_state_dtype": "bf16"}},
                     "fp32"),
    "compensated": ({"data_types": {"master_dtype": "compensated"}}, "bf16"),
}
STATE_STAGE = 2
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-2 * g.LR * g.STEPS)
BF16_OUTLIERS = 5e-3
# LoRA fine-tune at a sequence axis of 2 (dp 1), Adam at ZeRO 0
ADAPTERS = {"adapters": {"enabled": True, "rank": 4}}
# sparse embedding gradients at sequence 2 x data 2, Adam at ZeRO 1
SPARSE = {"sparse_gradients": True}
# optimizer offload at sequence 2 (dp 1), Adam at ZeRO 1
OFFLOAD = {"zero_optimization": {"stage": 1,
                                 "offload_optimizer": {"device": "cpu"}}}
# lifted: these now build at a sequence axis (their parity: STATES,
# ADAPTERS and SPARSE)
LIFTED = ("int8", "bf16_moments", "compensated", "adapters", "sparse",
          "bert", "offload")
REFUSED = {
    "int8": {"data_types": {"optimizer_state_dtype": "int8"}},
    "bf16_moments": {"data_types": {"optimizer_state_dtype": "bf16"}},
    "compensated": {"bf16": {"enabled": True},
                    "data_types": {"master_dtype": "compensated"}},
    "offload": {"zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}},
    "adapters": {"adapters": {"enabled": True, "rank": 4}},
    "sparse": {"sparse_gradients": True},
}
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32)
# BERT pretraining at sequence 2 (dp 1): 2 layers, dropout 0, padded rows
BERT_TRAIN = dict(BERT, hidden_size=64, num_hidden_layers=2,
                  intermediate_size=128, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)


def _train_case(name, layout, stage, opt="Adam", **extra):
    sp, _, mp = LAYOUTS[layout]
    return dict({"kind": "sp_train", "name": name, "model": "gpt2",
                 "weights": "gpt2.pt", "steps": g.STEPS, "accum": g.ACCUM,
                 "micro": g.MICRO, "lr": g.LR, "sp": sp, "mp": mp,
                 "stage": stage, "opt": opt, "dtype": "fp32"}, **extra)


def _layout_cases(layout):
    out = [_train_case(f"{layout}-adam-s{s}", layout, s) for s in range(4)]
    if layout in LAMB_STAGE:
        out.append(_train_case(f"{layout}-fusedlamb-s{LAMB_STAGE[layout]}",
                               layout, LAMB_STAGE[layout], "FusedLamb"))
    return out


def _jax_mesh(dp, sp, mp):
    return build_mesh(data_parallel_size=dp, sequence_parallel_size=sp,
                      model_parallel_size=mp,
                      devices=jax.devices()[:dp * sp * mp])


def _state_case(name):
    extra, dtype = STATES[name]
    return _train_case(f"sp2dp2-{name}", "sp2dp2", STATE_STAGE,
                       dtype=dtype, extra=extra)


def _jax_train(params, layout, stage, opt, state=None, extra=None):
    """The JAX engine's window losses and final float32 masters (in the
    port's names; under ``ADAPTERS`` the LoRA factors)."""
    sp, dp, mp = LAYOUTS[layout]
    extra, dtype = STATES[state] if state else (extra or {}, "fp32")
    cfg = ranks.config(stage, opt, dtype, g.MICRO, g.ACCUM, dp, lr=g.LR,
                       **extra)
    engine, *_ = deepspeed_tpu.initialize(
        model=g.fresh_jmodel(), model_parameters=params, config_params=cfg,
        mesh=_jax_mesh(dp, sp, mp),
        param_specs=jpartition_specs(params) if mp > 1 else None)
    losses = [float(engine.train_batch(iter(w))) for w in
              ranks.windows("gpt2", g.STEPS, g.ACCUM, g.MICRO * dp)]
    final = (engine.optimizer_state["master"] if engine.master_in_opt
             else engine.params)
    final = jax.device_get(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), final))
    final = (adapters_from_jax(final) if "adapters" in extra
             else params_from_jax(final))
    return losses, {n: t.float().numpy() for n, t in final.items()}


# the BERT task models at sequence 2: {model kind: JAX class}
BERT_TASKS = {"bert": jbert.BertForPreTraining,
              "bert_qa": jbert.BertForQuestionAnswering}
# QA's tensors whose true gradient is zero: the span cross-entropy is
# invariant to a constant added to a row's logits, which is all that the
# span head's bias and the last block's output LayerNorm bias (whose
# only consumer is that head) can add. Adam moves them by the gradient's
# rounding noise, up to lr a step (the JAX engine's own sp 1 and sp 2
# runs differ there by 2.6e-5), so they are held to lr x windows.
QA_ZERO_GRAD = ("qa_outputs.bias", "bert.encoder.layer.1.norm_b")


def _jax_bert_init(kind):
    """The JAX BERT task model of BERT_TRAIN and its weights from
    PRNGKey(0)."""
    jmodel = BERT_TASKS[kind](jbert.BertConfig(**BERT_TRAIN))
    batch = ranks.windows(kind, 1, 1, 2, vocab=BERT["vocab_size"])[0][0]
    return jmodel, jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0)}, *map(jnp.asarray, batch),
        train=False)["params"])


def _jax_bert(kind, jmodel, params):
    """A BERT task model trained at sequence 2 on the JAX engine (its
    model arms the engine's mesh: sequence-parallel attention): the
    window losses and the final parameters in the port's names."""
    engine, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params,
        config_params=ranks.config(0, "Adam", "fp32", g.MICRO, g.ACCUM, 1,
                                   lr=g.LR),
        mesh=_jax_mesh(1, 2, 1))
    losses = [float(engine.train_batch(iter(w))) for w in ranks.windows(
        kind, g.STEPS, g.ACCUM, g.MICRO, vocab=BERT["vocab_size"])]
    final = bert_params_from_jax(jax.device_get(engine.params))
    return losses, {n: t.float().numpy() for n, t in final.items()}


# a model without a sequence or pipeline seam (the MLP of
# tests/unit/simple_model.py): replicated over the axis, as the JAX engine
# runs it; {name: (mesh, ZeRO stage, optimizer, lr, config changes)}. At
# pipe 2 x data 2 the ZeRO-1 shards make the gradient norm a sum over the
# world, which must count one pipe replica's leaves: SGD, whose step
# scales with the clip factor (Adam's would cancel it), at a clip below
# every window's norm
MLP_CLIPPED = {"gradient_clipping": 0.05,
               "zero_allow_untested_optimizer": True}
SEAMLESS = {
    "sp2-mlp": (dict(sequence_parallel_size=2), 0, "Adam", g.LR, {}),
    "pp2-mlp": (dict(pipeline_parallel_size=2), 0, "Adam", g.LR, {}),
    "pp2dp2-mlp": (dict(pipeline_parallel_size=2, data_parallel_size=2), 1,
                   "SGD", 1.0, MLP_CLIPPED),
}


def _seamless_case(name):
    mesh, stage, opt, lr, extra = SEAMLESS[name]
    return _train_case(name, "sp2", stage, opt, model="mlp", lr=lr,
                       sp=mesh.get("sequence_parallel_size", 1),
                       pp=mesh.get("pipeline_parallel_size", 1), extra=extra)


def _seamless_world(name):
    return int(np.prod(list(SEAMLESS[name][0].values())))


def _jax_mlp(name):
    """The MLP on the JAX engine over a mesh of the case's devices: the
    window losses and the final parameters in the port's names."""
    mesh, stage, opt, lr, extra = SEAMLESS[name]
    dp = mesh.get("data_parallel_size", 1)
    engine, *_ = deepspeed_tpu.initialize(
        model=SimpleModel(hidden_dim=ranks.HIDDEN),
        model_parameters=ranks.mlp_weights(),
        config_params=ranks.config(stage, opt, "fp32", g.MICRO, g.ACCUM, dp,
                                   lr=lr, **extra),
        mesh=build_mesh(devices=jax.devices()[:_seamless_world(name)],
                        **mesh))
    losses = [float(engine.train_batch(iter(w))) for w in ranks.windows(
        "mlp", g.STEPS, g.ACCUM, g.MICRO * dp)]
    p = jax.device_get(engine.params)
    return losses, {
        "linear.weight": np.asarray(p["linear"]["kernel"]).T,
        "linear.bias": np.asarray(p["linear"]["bias"]),
        "head.weight": np.asarray(p["head"]["kernel"]).T,
        "head.bias": np.asarray(p["head"]["bias"])}


def _jit(fn, mesh, **kw):
    """``fn(q, k, v, mesh, *rest, **kw)`` under ``jax.jit`` (eager
    shard_map traces every call again)."""
    return jax.jit(lambda q, k, v, *rest: fn(q, k, v, mesh, *rest, **kw))


def _jax_attention(sp):
    """JAX's side of case_sp_attention on a sequence mesh of ``sp``: the
    outputs of each decomposition in one jitted program, its gradients in
    another."""
    mesh = _jax_mesh(1, sp, 1)
    q, k, v = (jnp.asarray(x) for x in ranks.sp_qkv())
    valid = jnp.asarray(ranks.sp_valid())
    qs, ks, vs = (jnp.asarray(x) for x in ranks.sp_qkv(s=32))
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        def outputs(q, k, v, valid, fn=fn):
            got = {f"{name}-causal{int(c)}": fn(q, k, v, mesh, causal=c)
                   for c in (False, True)}
            got[f"{name}-padding"] = fn(q, k, v, mesh, valid)
            if name == "ring":
                got["ring-masked"] = fn(q, k, v, mesh,
                                        jnp.zeros_like(valid))
            return got

        out.update(jax.tree_util.tree_map(
            np.asarray, jax.jit(outputs)(q, k, v, valid)))
        grads = jax.jit(jax.grad(
            lambda a, b, c, fn=fn: jnp.sum(fn(a, b, c, mesh, causal=True)
                                           ** 2),
            argnums=(0, 1, 2)))(qs, ks, vs)
        out[f"{name}-grads"] = [np.asarray(x) for x in grads]
    q3, k3, v3 = (jnp.asarray(x) for x in ranks.sp_qkv(h=3))
    out["auto-uneven"] = np.asarray(
        _jit(sequence_parallel_attention, mesh, causal=True)(q3, k3, v3))
    return out


def _jax_auto_mp():
    mesh = _jax_mesh(1, 2, 2)
    q, k, v = (jnp.asarray(x) for x in ranks.sp_qkv(h=6))
    return np.asarray(_jit(sequence_parallel_attention, mesh, causal=True)(
        q, k, v))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    model, params = g.jmodel()
    state = params_from_jax(jax.device_get(params))
    jberts = {kind: _jax_bert_init(kind) for kind in BERT_TASKS}
    d2 = tmp_path_factory.mktemp("sp_world2")
    d4 = tmp_path_factory.mktemp("sp_world4")
    for d in (d2, d4):
        torch.save(state, d / "gpt2.pt")
    adapters = g.jadapters(params, ADAPTERS["adapters"]["rank"])
    torch.save({**state, **adapters_from_jax(adapters)}, d2 / "lora.pt")
    for kind, (_, jparams) in jberts.items():
        torch.save(bert_params_from_jax(jparams), d2 / f"{kind}.pt")
    two = [{"kind": "sp_attention", "name": "attention"},
           *_layout_cases("sp2"),
           _train_case("sp2-ring-s0", "sp2", 0, impl="ring"),
           _train_case("sp2-offload", "sp2", 1, extra=OFFLOAD),
           *(_seamless_case(n) for n in SEAMLESS if _seamless_world(n) == 2),
           _train_case("sp2-adapters", "sp2", 0, extra=ADAPTERS,
                       model_parameters="lora.pt"),
           *(_train_case(f"sp2-{kind}", "sp2", 0, model=kind,
                         bert=BERT_TRAIN, weights=f"{kind}.pt",
                         vocab=BERT["vocab_size"]) for kind in BERT_TASKS),
           {"kind": "sp_refusals", "name": "refusals", "engine": REFUSED,
            "bert": BERT, "weights": "none"}]
    four = [{"kind": "sp_attention", "name": "attention"},
            {"kind": "sp_auto_mp", "name": "auto_mp"},
            *_layout_cases("sp2dp2"), *_layout_cases("sp2mp2"),
            *(_state_case(name) for name in STATES),
            _train_case("sp2dp2-sparse", "sp2dp2", 1, extra=SPARSE),
            _train_case("sp2dp2-save", "sp2dp2", 1, save="ckpt"),
            *(_seamless_case(n) for n in SEAMLESS if _seamless_world(n) == 4)]
    h2 = ranks.start(2, two, d2)
    h4 = ranks.start(4, four, d4)
    with ThreadPoolExecutor(8) as pool:
        jobs = {(lay, "adam"): pool.submit(_jax_train, params, lay,
                                           JAX_STAGE[lay], "Adam")
                for lay in LAYOUTS}
        jobs.update({(lay, "fusedlamb"): pool.submit(
            _jax_train, params, lay, stage, "FusedLamb")
            for lay, stage in LAMB_STAGE.items()})
        jobs.update({("sp2dp2", name): pool.submit(
            _jax_train, params, "sp2dp2", STATE_STAGE, "Adam", name)
            for name in STATES})
        jobs[("sp2dp2", "sparse")] = pool.submit(
            _jax_train, params, "sp2dp2", 1, "Adam", extra=SPARSE)
        jobs.update({name: pool.submit(_jax_mlp, name) for name in SEAMLESS})
        jobs[("sp2", "offload")] = pool.submit(
            _jax_train, params, "sp2", 1, "Adam", extra=OFFLOAD)
        jobs[("sp2", "adapters")] = pool.submit(
            _jax_train, g.merged(params, adapters), "sp2", 0, "Adam",
            extra=ADAPTERS)
        jobs["attention2"] = pool.submit(_jax_attention, 2)
        jobs["attention4"] = pool.submit(_jax_attention, 4)
        jobs["auto_mp"] = pool.submit(_jax_auto_mp)
        jobs.update({("sp2", kind): pool.submit(_jax_bert, kind, *jb)
                     for kind, jb in jberts.items()})
        oracle = {k: f.result() for k, f in jobs.items()}
    return ({2: ranks.finish(h2, timeout=300),
             4: ranks.finish(h4, timeout=300)}, oracle, d4)


# ---------------------------------------------------------------------------
# function level
# ---------------------------------------------------------------------------
SP_WORLDS = [2, 4]


def _attention(runs, sp):
    port, oracle, _ = runs
    got = [r["attention"] for r in port[sp]]
    return got, oracle[f"attention{sp}"]


@pytest.mark.parametrize("sp", SP_WORLDS)
@pytest.mark.parametrize("key", ["ring-causal0", "ring-causal1",
                                 "ulysses-causal0", "ulysses-causal1",
                                 "ring-padding", "ulysses-padding"])
def test_matches_jax_and_the_reference(runs, sp, key):
    got, want = _attention(runs, sp)
    for res in got:  # the whole output on every rank of the line
        np.testing.assert_allclose(res[key], want[key], atol=ATOL_OUT)
    q, k, v = (jnp.asarray(x) for x in ranks.sp_qkv())
    if key.endswith("padding"):
        mask = jnp.where(jnp.asarray(ranks.sp_valid()) > 0, 0.0,
                         NEG_INF)[:, None, None, :]
        ref = mha_reference(q, k, v, mask=mask)
    else:
        ref = mha_reference(q, k, v, causal=key.endswith("1"))
    np.testing.assert_allclose(got[0][key], np.asarray(ref), atol=ATOL_OUT)


@pytest.mark.parametrize("sp", SP_WORLDS)
def test_ring_fully_masked_rows_are_zero(runs, sp):
    got, want = _attention(runs, sp)
    np.testing.assert_allclose(got[0]["ring-masked"], 0.0, atol=1e-6)
    np.testing.assert_allclose(want["ring-masked"], 0.0, atol=1e-6)


@pytest.mark.parametrize("sp", SP_WORLDS)
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gradients_match_jax(runs, sp, impl):
    got, want = _attention(runs, sp)
    for res in got:
        for a, b in zip(res[f"{impl}-grads"], want[f"{impl}-grads"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sp", SP_WORLDS)
def test_uneven_heads_dispatch_to_the_ring_and_ulysses_refuses(runs, sp):
    got, want = _attention(runs, sp)
    np.testing.assert_allclose(got[0]["auto-uneven"], want["auto-uneven"],
                               atol=ATOL_OUT)
    assert "heads" in got[0]["uneven-refused"]
    with pytest.raises(ValueError, match="heads"):
        q, k, v = (jnp.asarray(x) for x in ranks.sp_qkv(h=3))
        ulysses_attention(q, k, v, _jax_mesh(1, sp, 1))


def test_auto_dispatch_uses_local_head_count(runs):
    port, oracle, _ = runs
    want = oracle["auto_mp"]
    for res in port[4]:
        got = res["auto_mp"]
        assert got["impl"] == "ring"
        lo = got["model_rank"] * 3
        np.testing.assert_allclose(got["out"], want[:, lo:lo + 3],
                                   atol=ATOL_OUT)


@pytest.mark.parametrize("sp", SP_WORLDS)
def test_ring_dropout_preserves_distribution_not_bits(runs, sp):
    got, _ = _attention(runs, sp)
    res = got[0]
    assert res["drop-repeats"] and res["drop-seed-matters"]
    assert res["drop-vs-one-device"]
    assert res["drop-std"].max() > 1e-3, "dropout appears inactive"
    err = np.abs(res["drop-mean"] - res["drop-clean"])
    tol = 4.0 * res["drop-std"] / np.sqrt(ranks.SP_DROP_DRAWS) + 5e-3
    assert (err < tol).mean() > 0.99
    # the clean ring is the reference
    q, k, v = (jnp.asarray(x) for x in ranks.sp_qkv(**ranks.SP_DROP))
    np.testing.assert_allclose(res["drop-clean"],
                               np.asarray(mha_reference(q, k, v)),
                               atol=ATOL_OUT)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------
def _check(results, name, want_losses, want_params):
    g.check(results, name, want_losses, want_params)
    assert results[0][name]["skipped"] == 0


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gpt2_at_a_sequence_axis_matches_jax_engine(runs, layout, stage):
    port, oracle, _ = runs
    _check(port[WORLD[layout]], f"{layout}-adam-s{stage}",
           *oracle[(layout, "adam")])


@pytest.mark.parametrize("layout", list(LAMB_STAGE))
def test_fused_lamb_at_a_sequence_axis_matches_jax_engine(runs, layout):
    port, oracle, _ = runs
    _check(port[WORLD[layout]], f"{layout}-fusedlamb-s{LAMB_STAGE[layout]}",
           *oracle[(layout, "fusedlamb")])


@pytest.mark.parametrize("name", list(STATES))
def test_state_layouts_at_a_sequence_axis_match_jax_engine(runs, name):
    """int8 and bf16 moments and compensated masters at sequence 2 x data
    2, ZeRO 2, against the JAX engine on the same mesh."""
    port, oracle, _ = runs
    want_losses, want_params = oracle[("sp2dp2", name)]
    if STATES[name][1] == "fp32":
        _check(port[4], f"sp2dp2-{name}", want_losses, want_params)
        return
    got = port[4][0][f"sp2dp2-{name}"]
    for r in port[4][1:]:
        assert r[f"sp2dp2-{name}"]["losses"] == got["losses"]
    assert got["skipped"] == 0
    np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-4)
    beyond = total = 0
    for n, want in want_params.items():
        diff = np.abs(got["params"][n] - want)
        beyond += int((diff > BF16_TOL["atol"]
                       + BF16_TOL["rtol"] * np.abs(want)).sum())
        total += want.size
    assert beyond <= BF16_OUTLIERS * total, (beyond, total)


@pytest.mark.parametrize("name", list(SEAMLESS))
def test_a_model_without_the_seam_is_replicated_over_the_axis(runs, name):
    """The MLP at a sequence or a pipe axis of 2: every rank of the axis
    computes the whole step on the same rows (no token split, no stages),
    as the JAX engine runs it on the same mesh; at pipe 2 x data 2 with
    ZeRO 1 the clipped step's norm counts each leaf once."""
    port, oracle, _ = runs
    _check(port[_seamless_world(name)], name, *oracle[name])


def test_offload_at_a_sequence_axis_matches_jax_engine(runs):
    """Optimizer offload at sequence 2: each rank's host masters step the
    line's summed gradients, against the JAX engine on the same mesh."""
    port, oracle, _ = runs
    _check(port[2], "sp2-offload", *oracle[("sp2", "offload")])


def test_sparse_gradients_at_a_sequence_axis_match_jax_engine(runs):
    """``sparse_gradients`` at sequence 2 x data 2 (the lookup's CSR pairs
    all-gathered over the data group, then the line's sum), ZeRO 1,
    against the JAX engine on the same mesh."""
    port, oracle, _ = runs
    _check(port[4], "sp2dp2-sparse", *oracle[("sp2dp2", "sparse")])


@pytest.mark.parametrize("kind", list(BERT_TASKS))
def test_bert_pretraining_at_a_sequence_axis_matches_jax_engine(runs, kind):
    """BERT at sequence 2 on padded rows, Ulysses with the padding mask's
    key validity: pretraining (the masked-LM loss over the line's labels,
    the next-sentence loss from rank 0's [CLS] position) and question
    answering (the span logits joined over the line); against the JAX
    engine on the same mesh."""
    port, oracle, _ = runs
    want_losses, want_params = oracle[("sp2", kind)]
    got = port[2][0][f"sp2-{kind}"]
    for r in port[2][1:]:
        assert r[f"sp2-{kind}"]["losses"] == got["losses"]
    assert got["skipped"] == 0
    np.testing.assert_allclose(got["losses"], want_losses, **g.TOL)
    assert set(got["params"]) == set(want_params)
    zero = QA_ZERO_GRAD if kind == "bert_qa" else ()
    for n, want in want_params.items():
        tol = dict(rtol=0, atol=g.LR * g.STEPS) if n in zero else g.TOL
        np.testing.assert_allclose(got["params"][n], want, err_msg=n, **tol)


def test_lora_finetune_at_a_sequence_axis_matches_jax_engine(runs):
    """The adapters block at sequence 2: the LoRA factors (the only
    trainable tensors) against the JAX engine's on the same mesh."""
    port, oracle, _ = runs
    assert all("_lora_" in n for n in port[2][0]["sp2-adapters"]["params"])
    _check(port[2], "sp2-adapters", *oracle[("sp2", "adapters")])


def test_the_ring_trains_as_ulysses_does(runs):
    port, oracle, _ = runs
    _check(port[2], "sp2-ring-s0", *oracle[("sp2", "adam")])


def test_each_rank_keeps_its_place(runs):
    port, _, _ = runs
    for r, res in enumerate(port[2]):
        assert res["sp2-adam-s0"]["coords"] == (0, r, 0)
    for r, res in enumerate(port[4]):
        assert res["sp2dp2-adam-s0"]["coords"] == (r // 2, r % 2, 0)
        assert res["sp2mp2-adam-s0"]["coords"] == (0, r // 2, r % 2)


def test_checkpoint_at_a_sequence_axis_loads_in_one_process(runs):
    """Layouts are unchanged by the sequence axis: a checkpoint saved at
    sequence 2 x data 2 (ZeRO stage 1) loads into one process, with the
    saved parameters."""
    port, _, d4 = runs
    saved = port[4][0]["sp2dp2-save"]["params"]
    model = dst.GPT2LMHeadModel(dst.GPT2Config(
        vocab_size=ranks.VOCAB, n_positions=ranks.SEQ, n_embd=64, n_layer=2,
        n_head=4, dropout=0.0), device="cpu", seed=5)
    engine, *_ = dst.initialize(
        model=model, device="cpu",
        config_params=ranks.config(0, "Adam", "fp32", g.MICRO, g.ACCUM, 1,
                                   lr=g.LR))
    path, _ = engine.load_checkpoint(str(d4 / "ckpt"), tag="sp")
    assert path is not None
    for n, p in engine.module.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), saved[n], err_msg=n)


@pytest.mark.parametrize("what", list(REFUSED) + ["bert"])
def test_what_a_sequence_axis_refuses(runs, what):
    port, _, _ = runs
    got = port[2][0]["refusals"][what]
    # every case builds (trained in STATES, ADAPTERS and SPARSE); nothing
    # is left refused at a sequence axis
    assert what in LIFTED and got is None, got


def test_the_block_refuses_return_kv_and_query_masks(runs):
    port, _, _ = runs
    got = port[2][0]["refusals"]
    assert "return_kv" in got["return_kv"]
    assert "padding-style masks only" in got["query_mask"]
    assert "pipeline_stages > 1 does not compose" in got["pipeline"]
