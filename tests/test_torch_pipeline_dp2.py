"""GPT-2 over a pipe axis of 2 and a data axis of 2 (four gloo ranks),
ZeRO 0-2: FusedLamb held to the JAX engine on the same ``pipe=2 x
data=2`` mesh with ``partition_specs(params, pipeline=True)``, Adam to
the port at pp 1 x dp 1 on the same global batches (losses and
parameters to rtol 2e-4, atol 1e-5 at lr 1e-4);
the stages of a data rank read its rows, and every stage returns the
loss; what a pipe axis refuses at a data axis above 1 (ZeRO stage 3) and
with a model axis.
tests/test_torch_pipeline.py holds pp 2 x dp 1 and the schedule.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

import torch_dp_ranks as ranks
import torch_moe_pp as mp

PP, DP = 2, 2

REFUSED = {
    "stage3": {"case": {"stage": 3}},
    "model_axis": {"mesh": {"model_parallel_size": 2}},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp2dp2")
    params = mp.weights("pp")
    mp.save_port_weights(params, d / "pp.pt")
    cases = [mp.case("pp", f"adam-s{s}", stage=s) for s in range(3)]
    cases += [mp.case("pp", "fusedlamb-s1", stage=1, opt="FusedLamb"),
              dict(mp.case("pp", "refusals"), kind="moe_pp_refusals",
                   refusals=REFUSED)]
    handle = ranks.start(PP * DP, cases, d)
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(mp.jax_run, "pp", params, DP, 1, "FusedLamb")
        pp1 = mp.in_process(ranks.case_moe_pp_train,
            dict(mp.case("pp", "pp1"), pp=1, n_micro=0,
                 micro=mp.PP_MICRO * DP), d)
        results = ranks.finish(handle, timeout=240)
        oracle = oracle.result()
    return results, oracle, pp1


@pytest.mark.parametrize("name", ["adam-s0", "adam-s1", "adam-s2",
                                  "fusedlamb-s1"])
def test_gpt2_pp2_dp2_matches_jax(runs, name):
    """FusedLamb against the JAX engine on the same mesh; Adam against pp
    1 at dp 1 on the same global batches (Adam's JAX oracle on a pipe
    mesh is tests/test_torch_pipeline.py's)."""
    results, oracle, pp1 = runs
    mp.same_on_every_rank(results, name)
    if name.startswith("fusedlamb"):
        want_losses, _, want_params = oracle
    else:
        want_losses, want_params = pp1["losses"], pp1["params"]
    mp.check(results[0][name], want_losses, want_params)
    # rank = pipe * dp + data: the pipe axis outermost, as the JAX mesh
    assert [r[name]["coords"] for r in results] == [(0, 0), (0, 1), (1, 0),
                                                    (1, 1)]


@pytest.mark.parametrize("name,message", [
    ("stage3", "ZeRO stage 3 at a pipe axis above 1 (ROADMAP A7d, what is "
               "left)"),
    ("model_axis", "a model axis above 1 at a pipe axis above 1 (ROADMAP "
                   "A7d"),
])
def test_pipeline_refusals_at_dp2(runs, name, message):
    results, *_ = runs
    for r in results:
        assert message in r["refusals"][name]
