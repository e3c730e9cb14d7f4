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
mesh: losses and whole parameters at ``rtol=2e-4, atol=1e-5``. The ring
trains too (forced by ``seq_parallel_impl``). A checkpoint saved at
sequence 2 x data 2 loads in one process. And the refusals, each by its
message.

Two spawns (tests/torch_dp_ranks.py): 2 ranks for sequence 2 alone, 4
ranks for sequence 4, sequence 2 x data 2 and sequence 2 x model 2; the
JAX oracles compute meanwhile.
"""

from concurrent.futures import ThreadPoolExecutor

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
from deepspeed_tpu_torch import params_from_jax

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


def _jax_train(params, layout, stage, opt):
    sp, dp, mp = LAYOUTS[layout]
    cfg = ranks.config(stage, opt, "fp32", g.MICRO, g.ACCUM, dp, lr=g.LR)
    engine, *_ = deepspeed_tpu.initialize(
        model=g.fresh_jmodel(), model_parameters=params, config_params=cfg,
        mesh=_jax_mesh(dp, sp, mp),
        param_specs=jpartition_specs(params) if mp > 1 else None)
    losses = [float(engine.train_batch(iter(w))) for w in
              ranks.windows("gpt2", g.STEPS, g.ACCUM, g.MICRO * dp)]
    final = params_from_jax(jax.device_get(engine.params))
    return losses, {n: t.float().numpy() for n, t in final.items()}


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
    d2 = tmp_path_factory.mktemp("sp_world2")
    d4 = tmp_path_factory.mktemp("sp_world4")
    for d in (d2, d4):
        torch.save(state, d / "gpt2.pt")
    two = [{"kind": "sp_attention", "name": "attention"},
           *_layout_cases("sp2"),
           _train_case("sp2-ring-s0", "sp2", 0, impl="ring"),
           {"kind": "sp_refusals", "name": "refusals", "engine": REFUSED,
            "bert": BERT, "weights": "none"}]
    four = [{"kind": "sp_attention", "name": "attention"},
            {"kind": "sp_auto_mp", "name": "auto_mp"},
            *_layout_cases("sp2dp2"), *_layout_cases("sp2mp2"),
            _train_case("sp2dp2-save", "sp2dp2", 1, save="ckpt")]
    h2 = ranks.start(2, two, d2)
    h4 = ranks.start(4, four, d4)
    with ThreadPoolExecutor(8) as pool:
        jobs = {(lay, "adam"): pool.submit(_jax_train, params, lay,
                                           JAX_STAGE[lay], "Adam")
                for lay in LAYOUTS}
        jobs.update({(lay, "fusedlamb"): pool.submit(
            _jax_train, params, lay, stage, "FusedLamb")
            for lay, stage in LAMB_STAGE.items()})
        jobs["attention2"] = pool.submit(_jax_attention, 2)
        jobs["attention4"] = pool.submit(_jax_attention, 4)
        jobs["auto_mp"] = pool.submit(_jax_auto_mp)
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
    assert got is not None and "not yet ported" in got
    if what != "bert":
        assert "ROADMAP A7b, what is left" in got


def test_the_block_refuses_return_kv_and_query_masks(runs):
    port, _, _ = runs
    got = port[2][0]["refusals"]
    assert "return_kv" in got["return_kv"]
    assert "padding-style masks only" in got["query_mask"]
    assert "pipeline_stages > 1 does not compose" in got["pipeline"]
