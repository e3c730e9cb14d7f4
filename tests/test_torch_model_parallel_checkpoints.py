"""Checkpoints, cross-rank agreement and dropout under tensor parallelism.

Checkpoints keep the global form the JAX engine writes: the model file
holds every tensor joined over the model group in the JAX element order
and records ``mp_world_size``; each model rank's optimizer file records
its leaves' model dims, and a load joins them before it cuts its own
shards. So a checkpoint crosses layouts:

- a dp 1 x mp 2 checkpoint loads at mp 1 (this process) and at dp 2 x
  mp 1 with the same eval fingerprint (1e-5: float32 sums taken in
  another order), and the next windows' losses agree;
- an mp 1 checkpoint (this process) loads at mp 2 the same way.

At dp 2 x mp 2 (4 gloo ranks) the drain, the load and the commit agree
across every rank, as tests/test_torch_dist_resilience.py holds them at
dp 2: a SIGTERM to one rank drains every rank into one tag; a read fault
on one rank fails the load everywhere; rank 0's failed verification
raises the same class on every rank. Sparse embedding gradients over the
vocab-sharded ``wte`` (the rank's rows, reduced over the data group)
equal the JAX engine's.

Dropout at mp 2: the hidden dropouts act on the replicated residual
stream, so both model ranks draw the same keep masks, and the loss and
every replicated parameter after a window are bit for bit the same on
both; the attention seeds differ by the model rank's stride, and the
keep rate of each rank's mask is statistical (the JAX package's dropout
kernel never runs off the TPU, so there is no mask to compare bits
with).
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
import torch_dp_gpt2 as g
import torch_dp_ranks as ranks
import torch_mp_gpt2 as mpg
from deepspeed_tpu_torch import params_from_jax
from deepspeed_tpu_torch.ops.attention import (
    MODEL_RANK_SEED_STRIDE,
    dropout_keep_mask,
)
from torch_test_env import jax_compile_cache  # noqa: F401

FP_TOL = dict(rtol=1e-5, atol=1e-6)
MICRO_GLOBAL = 4
SPARSE = {"sparse_gradients": True}


def _ckpt_case(name, mp, mode, path, stage=1):
    return {"name": name, "kind": "mp_checkpoint", "model": "gpt2",
            "weights": "gpt2.pt", "mp": mp, "mode": mode, "dir": str(path),
            "stage": stage, "opt": "Adam", "dtype": "fp32", "lr": 1e-3,
            "micro": MICRO_GLOBAL // 2, "micro_global": MICRO_GLOBAL}


def _one_process(workdir, mode, path):
    """The mp 1 engine of this process: save after 2 windows, or load;
    then the fingerprint and 2 windows."""
    model = ranks._model({"model": "gpt2", "weights": "gpt2.pt"}, workdir)
    engine, *_ = dst.initialize(
        model=model, device="cpu",
        config_params=ranks.config(1, "Adam", "fp32", MICRO_GLOBAL, 1, 1,
                                   lr=1e-3, resilience={"enabled": True}))
    data = ranks.windows("gpt2", 4, 1, MICRO_GLOBAL, 0)
    out = {}
    if mode == "save":
        out["train"] = [ranks._mp_run(engine, w) for w in data[:2]]
        engine.save_checkpoint(str(path), tag="t2")
    else:
        got, _ = engine.load_checkpoint(str(path))
        out["loaded"] = got is not None
        out["global_steps"] = engine.global_steps
    out["fingerprint"] = ranks.mp_fingerprint(engine)
    out["resume"] = [ranks._mp_run(engine, w) for w in data[2:]]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, params = g.jmodel()
    state = params_from_jax(jax.device_get(params))
    two = tmp_path_factory.mktemp("mp_ckpt")
    four = tmp_path_factory.mktemp("mp_agree")
    for d in (two, four):
        torch.save(state, d / "gpt2.pt")
    mp1_dir, mp2_dir = two / "ckpt_mp1", two / "ckpt_mp2"
    mp1 = _one_process(two, "save", mp1_dir)
    cases = [_ckpt_case("save", 2, "save", mp2_dir),
             _ckpt_case("from_mp1", 2, "load", mp1_dir),
             _ckpt_case("at_dp2", 1, "load", mp2_dir),
             {"name": "dropout", "kind": "mp_dropout", "model": "gpt2",
              "weights": "gpt2.pt", "mp": 2}]
    h2 = ranks.start(2, cases, two)
    agree = [{"name": "preempt", "kind": "mp_preempt", "mp": 2,
              "dir": "drain", "signalled": 3},
             {"name": "load", "kind": "mp_load_disagree", "mp": 2,
              "dir": "disagree", "faulty": 1},
             {"name": "commit", "kind": "mp_commit_fail", "mp": 2,
              "dir": "commit"},
             mpg.case("sparse", 2, stage=2, extra=SPARSE)]
    h4 = ranks.start(4, agree, four)
    oracle = mpg.jax_run(params, 2, 2, 2, "Adam", "fp32", **SPARSE)
    port2 = ranks.finish(h2, timeout=300)
    at_mp1 = _one_process(two, "load", mp2_dir)
    return {"mp1": mp1, "at_mp1": at_mp1, "port2": port2,
            "port4": ranks.finish(h4, timeout=300), "oracle": oracle,
            "mp2_dir": mp2_dir}


def _same_run(got, want):
    assert got["loaded"]
    assert got["global_steps"] == 2
    np.testing.assert_allclose(got["fingerprint"], want["fingerprint"],
                               **FP_TOL)
    np.testing.assert_allclose(got["resume"], want["resume"], **FP_TOL)


def test_an_mp2_checkpoint_records_its_layout(runs):
    d = runs["mp2_dir"] / "t2"
    files = sorted(os.listdir(d))
    # one global model file, one optimizer file per model rank
    assert "mp_rank_00_model_states.pt" in files
    assert "mp_rank_01_model_states.pt" not in files
    assert {"zero_pp_rank_0_mp_rank_00optim_states.pt",
            "zero_pp_rank_0_mp_rank_01optim_states.pt"} <= set(files)
    state = torch.load(d / "mp_rank_00_model_states.pt", weights_only=True)
    assert state["mp_world_size"] == 2
    # the module file is the global model, in the JAX element order
    assert tuple(state["module"]["h.0.attn_qkvw"].shape) == (192, 64)
    assert tuple(state["module"]["wte"].shape) == (256, 64)
    manifest = json.loads((d / "MANIFEST.json").read_text())
    assert manifest["mp_world_size"] == 2
    for r in runs["port2"]:
        assert r["save"]["files"] == files


def test_an_mp2_checkpoint_loads_at_mp1_and_at_dp2(runs):
    save = runs["port2"][0]["save"]
    for r in runs["port2"]:
        assert r["save"]["fingerprint"] == save["fingerprint"]
        _same_run(r["at_dp2"], save)
    _same_run(runs["at_mp1"], save)


def test_an_mp1_checkpoint_loads_at_mp2(runs):
    for r in runs["port2"]:
        _same_run(r["from_mp1"], runs["mp1"])


def test_the_drain_agrees_across_dp2_mp2(runs):
    port = runs["port4"]
    assert all(r["preempt"]["saved"] == ["latest", "preempt_global_step2"]
               for r in port)
    assert {r["preempt"]["latest"] for r in port} == {"preempt_global_step2"}
    assert all(r["preempt"]["global_steps"] == 3 for r in port)
    assert len({tuple(r["preempt"]["losses"]) for r in port}) == 1


def test_the_load_agrees_across_dp2_mp2(runs):
    for r in runs["port4"]:
        got = r["load"]
        assert got["path"] is None and got["steps"] == 0
        assert got["again"] == "t2" and got["steps_again"] == 2


def test_a_failed_commit_raises_alike_across_dp2_mp2(runs):
    for r in runs["port4"]:
        assert r["commit"]["raised"] == "CheckpointCorruptionError"
        assert not r["commit"]["latest"]


def test_sparse_gradients_over_vocab_shards_match_the_jax_engine(runs):
    mpg.check(runs["port4"], "sparse", *runs["oracle"])


def test_hidden_dropout_is_the_same_on_every_model_rank(runs):
    a, b = (r["dropout"] for r in runs["port2"])
    assert a["loss"] == b["loss"]
    assert set(a["replicated"]) == set(b["replicated"])
    assert {"wpe", "ln_f.weight", "h.0.attn_ob"} <= set(a["replicated"])
    for n, t in a["replicated"].items():
        assert torch.equal(t, b["replicated"][n]), n
    assert torch.equal(a["keep"], b["keep"])
    assert (b["seed"] - a["seed"]) % (2**31 - 1) == MODEL_RANK_SEED_STRIDE


def test_attention_keep_rate_is_statistical_per_model_rank(runs):
    a, b = (r["dropout"] for r in runs["port2"])
    shape = (2, 2, 128, 128)  # this rank's [B, H/mp, S, S]
    masks = [dropout_keep_mask(r["seed"], shape, 0.1, "cpu") for r in (a, b)]
    for m in masks:
        rate = m.float().mean().item()
        assert abs(rate - 0.9) < 4 * (0.09 / m.numel()) ** 0.5
    # the two ranks' masks are independent streams
    agree = (masks[0] == masks[1]).float().mean().item()
    assert abs(agree - (0.81 + 0.01)) < 0.01
