"""The MoE GPT-2 engine at dp 4 (four gloo ranks, one of the 4 experts a
rank) and at dp 1 (this process), held to the JAX engine on the 4-device
data sub-mesh with ``partition_specs`` (Adam; losses, ``last_aux`` and
parameters to rtol 2e-4, atol 1e-5 at lr 1e-4), and dp 4 to the port at
dp 1 fed the same global batches (ZeRO 0-2, Adam and FusedLamb): expert
sharding does not change the numerics.
tests/test_torch_moe_dp2.py holds dp 1 and 2, tests/test_torch_moe.py the pieces.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_dp_ranks as ranks
import torch_moe_pp as mp
from torch_test_env import jax_compile_cache  # noqa: F401

DP = 4
OPT_KEYS = {"adam": "Adam", "fusedlamb": "FusedLamb"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of DP ranks while the JAX oracle and the port at dp 1
    compute here."""
    d = tmp_path_factory.mktemp("moe4")
    params = mp.weights("moe")
    mp.save_port_weights(params, d / "moe.pt")
    cases = [mp.case("moe", f"adam-s{s}", stage=s) for s in range(3)]
    cases.append(mp.case("moe", "fusedlamb-s2", stage=2, opt="FusedLamb"))
    handle = ranks.start(DP, cases, d)
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(mp.jax_run, "moe", params, DP, 2, "Adam")
        one = {k: mp.in_process(ranks.case_moe_pp_train,
            mp.case("moe", k, opt=opt, micro=mp.MOE_MICRO * DP), d)
            for k, opt in OPT_KEYS.items()}
        results = ranks.finish(handle, timeout=240)
        oracle = oracle.result()
    return results, oracle, one


@pytest.mark.parametrize("name", ["adam-s0", "adam-s1", "adam-s2"])
def test_moe_engine_dp4_matches_jax(runs, name):
    results, (want_losses, want_aux, want_params), _ = runs
    mp.same_on_every_rank(results, name)
    got = results[0][name]
    mp.check(got, want_losses, want_params)
    np.testing.assert_allclose(np.stack(got["aux"]), np.stack(want_aux),
                               **mp.TOL)
    assert got["local_shapes"]["h.0.moe.expert_in_w"] == (1, 64, 256)


def test_moe_engine_one_rank_matches_jax(runs):
    """The port at dp 1 fed the same global batches as the JAX engine's
    4-device sub-mesh."""
    _, (want_losses, want_aux, want_params), one = runs
    mp.check(one["adam"], want_losses, want_params)
    np.testing.assert_allclose(np.stack(one["adam"]["aux"]),
                               np.stack(want_aux), **mp.TOL)


@pytest.mark.parametrize("name", ["adam-s1", "fusedlamb-s2"])
def test_expert_sharding_does_not_change_numerics(runs, name):
    results, _, one = runs
    mp.same_on_every_rank(results, name)
    want = one[name.split("-")[0]]
    mp.check(results[0][name], want["losses"], want["params"])
    for r in results:
        np.testing.assert_allclose(np.stack(r[name]["aux"]),
                                   np.stack(want["aux"]), **mp.TOL)
