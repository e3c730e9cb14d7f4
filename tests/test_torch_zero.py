"""ZeRO stages 0-3 across gloo ranks, held to the JAX engine on the MLP.

The port trains tests/unit/simple_model.py's SimpleModel (16 -> 64 -> 10)
in 2 and 4 rank processes (tests/torch_dp_ranks.py, one spawn per data
size for every case of this module), each rank feeding its own rows of
the global batch, at ZeRO stages 0-3 with Adam, Lamb, FusedLamb (its
plain path on the CPU) and Adam with int8 moments. The oracle is the JAX
engine on a mesh of the same data size (``build_mesh(devices=
jax.devices()[:dp])``) fed the global batches: the window losses and the
parameters after 5 steps agree to ``rtol=2e-4, atol=1e-5``, the
tolerance of tests/unit/test_engine.py:113-135 (float32 sums taken in
another order across ranks). The JAX engine runs once per optimizer and
data size, at one stage, rotated so that every stage is an oracle twice;
its stages lay the same update out differently (tests/unit/
test_zero_specs.py), so every port stage is held to it.

At dp = 4 the head's bias (10 elements) has no divisible dimension and
stays replicated: LAMB's trust ratio and the global norm count it once.
Also here: an fp16 overflow on one rank makes every rank skip, and the
stage-3 layout gauges equal the JAX engine's accounting.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import jax

import deepspeed_tpu
import torch_dp_ranks as ranks
from deepspeed_tpu.parallel.mesh import build_mesh
from torch_test_env import jax_compile_cache  # noqa: F401

sys.path.insert(0, str(Path(__file__).parent / "unit"))
from simple_model import SimpleModel  # noqa: E402

STEPS, MICRO, ACCUM = 5, 2, 2
TOL = dict(rtol=2e-4, atol=1e-5)
OPTS = {"adam": ("Adam", "fp32"), "lamb": ("Lamb", "fp32"),
        "fusedlamb": ("FusedLamb", "fp32"), "int8": ("Adam", "int8")}
# the stage of the JAX oracle per (data size, optimizer)
JAX_STAGE = {(2, "adam"): 0, (2, "lamb"): 1, (2, "fusedlamb"): 2,
             (2, "int8"): 3, (4, "adam"): 3, (4, "lamb"): 2,
             (4, "fusedlamb"): 1, (4, "int8"): 0}


def _cases():
    cases = [{"name": f"{opt}-s{stage}", "kind": "train", "model": "mlp",
              "stage": stage, "opt": OPTS[opt][0], "dtype": OPTS[opt][1],
              "steps": STEPS, "accum": ACCUM, "micro": MICRO}
             for opt in OPTS for stage in range(4)]
    cases += [{"name": f"overflow-s{stage}", "kind": "overflow",
               "model": "mlp", "stage": stage} for stage in (1, 3)]
    return cases


def _jax_engine(dp, stage, opt, dtype):
    cfg = ranks.config(stage, opt, dtype, MICRO, ACCUM, dp)
    model = SimpleModel(hidden_dim=ranks.HIDDEN)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=ranks.mlp_weights(),
        config_params=cfg, mesh=build_mesh(devices=jax.devices()[:dp]))
    return engine


def _jax_run(dp, key):
    opt, dtype = OPTS[key]
    engine = _jax_engine(dp, JAX_STAGE[(dp, key)], opt, dtype)
    losses = [float(engine.train_batch(iter(win))) for win in
              ranks.windows("mlp", STEPS, ACCUM, MICRO * dp)]
    params = jax.device_get(engine.params)
    if engine.master_in_opt:
        params = jax.device_get(engine.optimizer_state["master"])
    return losses, {
        "linear.weight": np.asarray(params["linear"]["kernel"]).T,
        "linear.bias": np.asarray(params["linear"]["bias"]),
        "head.weight": np.asarray(params["head"]["kernel"]).T,
        "head.bias": np.asarray(params["head"]["bias"]),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns run while the JAX oracles compute, each in a thread of
    its own."""
    handles = {dp: ranks.start(dp, _cases(), tmp_path_factory.mktemp(
        f"dp{dp}")) for dp in (2, 4)}
    with ThreadPoolExecutor(len(JAX_STAGE)) as pool:
        futures = {k: pool.submit(_jax_run, *k) for k in JAX_STAGE}
        oracle = {k: f.result() for k, f in futures.items()}
    port = {dp: ranks.finish(h, timeout=240) for dp, h in handles.items()}
    return port, oracle


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("key", list(OPTS))
@pytest.mark.parametrize("dp", [2, 4])
def test_zero_stage_matches_jax_engine(runs, dp, key, stage):
    port, oracle = runs
    want_losses, want_params = oracle[(dp, key)]
    results = port[dp]
    got = results[0][f"{key}-s{stage}"]
    for r in results[1:]:
        # every rank returns the global batch's loss
        assert r[f"{key}-s{stage}"]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, **TOL)
    assert set(got["params"]) == set(want_params)
    for n, want in want_params.items():
        np.testing.assert_allclose(got["params"][n], want, err_msg=n, **TOL)
    assert got["skipped"] == 0


@pytest.mark.parametrize("stage", [1, 3])
def test_an_overflow_on_one_rank_skips_every_rank(runs, stage):
    port, _ = runs
    scales = set()
    for r in port[2]:
        got = r[f"overflow-s{stage}"]
        assert got["skipped"] == 1 and got["global_steps"] == 0
        assert got["unchanged"]
        scales.add(got["scale"])
    # one loss-scale schedule on every rank (hysteresis 2 keeps 2**4)
    assert scales == {16.0}


@pytest.mark.parametrize("dp", [2, 4])
def test_stage3_gauges_equal_the_jax_accounting(runs, dp):
    port, _ = runs
    engine = _jax_engine(dp, 3, "Adam", "fp32")
    want = (engine._zero3_shard_bytes, engine._zero3_gather_bytes)
    assert want[0] > 0
    for r in port[dp]:
        assert tuple(r["adam-s3"]["zero3_bytes"]) == want
        # the MLP has no layer stack: the engine gathers at the forward
        assert not r["adam-s3"]["zero3_armed"]
