"""The MoE GPT-2 engine at dp 1 (this process) and dp 2 (two gloo ranks,
4 experts, 2 a rank; ZeRO 0-3, Adam and FusedLamb): FusedLamb at dp 1
and 2 against the JAX engine on the dp-2 data sub-mesh with
``partition_specs``, fed the same global batches (losses, ``last_aux``
and parameters to rtol 2e-4, atol 1e-5; lr 1e-4); every run at dp 2
equal to dp 1 (Adam's JAX oracle is tests/test_torch_moe_dp4.py's: one
JAX compile a file keeps the suite's seconds); bf16 FusedLamb with
dropout; a dp-2 checkpoint loaded at dp 1 with its fingerprint; the
same two ranks at a model axis of 2 (dp 1: every expert on each model
rank, the attention Megatron-sharded) and at a sequence axis of 2 (the
rows routed whole), Adam against the JAX engine on a ``model=2`` and a
``sequence=2`` mesh; bf16 moments and compensated masters (bfloat16
compute: losses rtol 2e-4, every parameter within one bf16 ulp plus 2 lr
a window, torch_moe_pp.check_bf16) with the experts at dp 2
against the JAX engine on the same data mesh; what a data axis refuses
with experts, by message.
tests/test_torch_moe.py holds the router, the layer and the block.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_dp_ranks as ranks
import torch_moe_pp as mp
from torch_test_env import jax_compile_cache  # noqa: F401

DP = 2
OPT_KEYS = {"adam": "Adam", "fusedlamb": "FusedLamb"}


MP = SP = 2
BF16_MOMENTS = {"data_types": {"optimizer_state_dtype": "bf16"}}
COMPENSATED = {"data_types": {"master_dtype": "compensated"}}
# lifted (they build): their parity is test_moe_engine_at_a_model_axis_*,
# test_moe_engine_at_a_sequence_axis_* and (int8 moments over the expert
# ranks) tests/test_torch_int8_spans.py
LIFTED = ("model_axis", "sequence_axis", "int8")
REFUSED_ON_RANKS = {
    "model_axis": {"mesh": {"model_parallel_size": MP}},
    "sequence_axis": {"mesh": {"sequence_parallel_size": 2}},
    "int8": {"data_types": {"optimizer_state_dtype": "int8"}},
    "experts_split": {"case": {"experts": 3, "weights": None}},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of DP ranks (the ZeRO stages with Adam, FusedLamb, a
    bf16 FusedLamb run with dropout, a checkpoint save, the refusals)
    while the JAX oracles and the port at dp 1 compute here."""
    d = tmp_path_factory.mktemp("moe")
    params = mp.weights("moe")
    mp.save_port_weights(params, d / "moe.pt")
    cases = [mp.case("moe", f"adam-s{s}", stage=s) for s in range(4)]
    cases += [mp.case("moe", "fusedlamb-s1", stage=1, opt="FusedLamb"),
              mp.case("moe", "bf16", opt="FusedLamb", dtype="bf16",
                      dropout=0.1, lr=1e-3, steps=4),
              {"kind": "moe_pp_checkpoint", "name": "save", "mode": "save",
               "weights": "moe.pt", "experts": mp.EXPERTS, "micro": 2,
               "stage": 1, "dir": str(d / "ckpt")},
              mp.case("moe", "compensated", dtype="bf16", extra=COMPENSATED),
              mp.case("moe", "bf16_moments-s0", extra=BF16_MOMENTS),
              mp.case("moe", "mp2-adam", micro=mp.MOE_MICRO * DP,
                      extra={"mesh": {"model_parallel_size": MP}}),
              mp.case("moe", "sp2-adam", micro=mp.MOE_MICRO * DP,
                      extra={"mesh": {"sequence_parallel_size": SP}}),
              dict(mp.case("moe", "refusals"), kind="moe_pp_refusals",
                   refusals=REFUSED_ON_RANKS)]
    handle = ranks.start(DP, cases, d)
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(mp.jax_run, "moe", params, DP, 2, "FusedLamb")
        at_mp = pool.submit(mp.jax_run, "moe", params, 1, 0, "Adam",
                            rows=mp.MOE_MICRO * DP, mp=MP)
        at_sp = pool.submit(mp.jax_run, "moe", params, 1, 0, "Adam",
                            rows=mp.MOE_MICRO * DP, sp=SP)
        states = {"compensated": pool.submit(
                      mp.jax_run, "moe", params, DP, 0, "Adam", "bf16",
                      extra=COMPENSATED),
                  "bf16_moments-s0": pool.submit(
                      mp.jax_run, "moe", params, DP, 0, "Adam",
                      extra=BF16_MOMENTS)}
        one = {k: mp.in_process(ranks.case_moe_pp_train,
            mp.case("moe", k, opt=opt, micro=mp.MOE_MICRO * DP), d)
            for k, opt in OPT_KEYS.items()}
        results = ranks.finish(handle, timeout=240)
        oracle = oracle.result()
        at_mp = at_mp.result()
        states = {k: f.result() for k, f in states.items()}
        states["sp2-adam"] = at_sp.result()
    return results, oracle, one, d, (at_mp, states)


def test_moe_engine_one_rank_matches_jax(runs):
    _, oracle, one, _, _ = runs
    want_losses, want_aux, want_params = oracle
    got = one["fusedlamb"]
    mp.check(got, want_losses, want_params)
    # last_aux: (lm, aux), each [accum]
    assert [a.shape for a in got["aux"]] == [a.shape for a in want_aux]
    assert [a.shape for a in got["aux"]] == [(mp.ACCUM,), (mp.ACCUM,)]
    np.testing.assert_allclose(np.stack(got["aux"]), np.stack(want_aux),
                               **mp.TOL)


def test_moe_engine_dp2_matches_jax(runs):
    results, (want_losses, want_aux, want_params), _, _, _ = runs
    got = results[0]["fusedlamb-s1"]
    mp.same_on_every_rank(results, "fusedlamb-s1")
    mp.check(got, want_losses, want_params)
    np.testing.assert_allclose(np.stack(got["aux"]), np.stack(want_aux),
                               **mp.TOL)


@pytest.mark.parametrize("name", ["adam-s0", "adam-s1", "adam-s2",
                                  "adam-s3", "fusedlamb-s1"])
def test_expert_sharding_does_not_change_numerics(runs, name):
    """Every ZeRO stage at dp 2 equals dp 1: losses, parameters and
    ``last_aux``."""
    results, _, one, _, _ = runs
    mp.same_on_every_rank(results, name)
    want = one[name.split("-")[0]]
    got = results[0][name]
    mp.check(got, want["losses"], want["params"])
    np.testing.assert_allclose(np.stack(got["aux"]), np.stack(want["aux"]),
                               **mp.TOL)
    # each rank holds its 2 of the 4 experts (whole at every stage); the
    # router is whole below stage 3, a persistent shard at it
    shapes = got["local_shapes"]
    assert shapes["h.0.moe.expert_in_w"] == (mp.EXPERTS // DP, 64, 256)
    assert shapes["h.1.moe.expert_out_b"] == (mp.EXPERTS // DP, 64)
    assert shapes["h.0.moe.gate_w"] == ((64 // DP, mp.EXPERTS)
                                        if name == "adam-s3"
                                        else (64, mp.EXPERTS))


def test_bf16_fused_lamb_with_dropout_trains(runs):
    results, _, _, _, _ = runs
    got = results[0]["bf16"]
    mp.same_on_every_rank(results, "bf16")
    assert np.all(np.isfinite(got["losses"])) and got["skipped"] == 0
    lm, aux = got["aux"]
    assert np.all(np.isfinite(lm)) and np.all(aux > 0)
    assert len(got["coeffs"]) > 0


def test_dp2_checkpoint_loads_at_dp1(runs):
    results, _, _, d, _ = runs
    save = results[0]["save"]
    assert "zero_pp_rank_1_mp_rank_00optim_states.pt" in save["files"]
    got = mp.in_process(ranks.case_moe_pp_checkpoint,
        {"mode": "load", "weights": None, "experts": mp.EXPERTS, "micro": 4,
         "stage": 1, "dir": str(d / "ckpt")}, d)
    assert got["loaded"] and got["global_steps"] == 2
    np.testing.assert_allclose(got["fingerprint"], save["fingerprint"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["resume"], save["resume"], rtol=1e-5)


def test_moe_engine_at_a_model_axis_matches_jax(runs):
    """MoE at a model axis of 2 (dp 1): the JAX layer shards only the
    expert dim (over the data axis), so each model rank routes every
    token to all 4 experts; losses, ``last_aux`` and parameters against
    the JAX engine on the same mesh."""
    results, _, _, _, ((want_losses, want_aux, want_params), _) = runs
    mp.same_on_every_rank(results, "mp2-adam")
    got = results[0]["mp2-adam"]
    mp.check(got, want_losses, want_params)
    np.testing.assert_allclose(np.stack(got["aux"]), np.stack(want_aux),
                               **mp.TOL)
    shapes = got["local_shapes"]
    assert shapes["h.0.moe.expert_in_w"] == (mp.EXPERTS, 64, 256)
    assert shapes["h.0.attn_qkvw"] == (3 * 64 // MP, 64)


def test_moe_engine_at_a_sequence_axis_matches_jax(runs):
    """MoE at a sequence axis of 2 (dp 1): each MoE layer gathers its rows
    over the line and routes them whole (the capacity of the global row,
    as the JAX layer routes it), its router loss counted once; losses,
    ``last_aux`` and parameters against the JAX engine on the same
    mesh."""
    results, _, _, _, (_, states) = runs
    mp.same_on_every_rank(results, "sp2-adam")
    want_losses, want_aux, want_params = states["sp2-adam"]
    got = results[0]["sp2-adam"]
    mp.check(got, want_losses, want_params)
    np.testing.assert_allclose(np.stack(got["aux"]), np.stack(want_aux),
                               **mp.TOL)


@pytest.mark.parametrize("name", ["compensated", "bf16_moments-s0"])
def test_moe_state_layouts_match_jax(runs, name):
    """bf16 moments and compensated masters with the experts over dp 2:
    Adam against the JAX engine on the same data mesh."""
    results, _, _, _, (_, states) = runs
    mp.same_on_every_rank(results, name)
    want_losses, want_aux, want_params = states[name]
    if name == "compensated":
        # every element within one bf16 ulp plus 2 lr a window (2.2% are
        # beyond one ulp: the experts' near-zero gradients)
        mp.check_bf16(results[0][name], want_losses, want_params,
                      outliers=None)
        return
    mp.check(results[0][name], want_losses, want_params)
    np.testing.assert_allclose(np.stack(results[0][name]["aux"]),
                               np.stack(want_aux), **mp.TOL)


@pytest.mark.parametrize("name,message", [
    ("model_axis", "a model axis above 1 with MoE experts (ROADMAP A7c"),
    ("sequence_axis", "a sequence axis above 1 with MoE experts (ROADMAP "
                      "A7c"),
    ("experts_split", "moe_experts=3 must divide over the expert axis "
                      "(data) of 2"),
    ("int8", "int8 optimizer moments with MoE experts (ROADMAP A7f"),
])
def test_moe_refusals_on_ranks(runs, name, message):
    """The lifted cases build where they were refused with ``message``
    (their parity: see LIFTED); a split the JAX model refuses keeps its
    message."""
    results, _, _, _, _ = runs
    for r in results:
        if name in LIFTED:
            assert r["refusals"][name] is None, message
        else:
            assert message in r["refusals"][name]
