"""GPT-2 over a pipe axis of 2 and a data axis of 2 (four gloo ranks),
ZeRO 0-2: FusedLamb held to the JAX engine on the same ``pipe=2 x
data=2`` mesh with ``partition_specs(params, pipeline=True)``, Adam to
the port at pp 1 x dp 1 on the same global batches (losses and
parameters to rtol 2e-4, atol 1e-5 at lr 1e-4);
the stages of a data rank read its rows, and every stage returns the
loss; the microbatches split the global batch, as the JAX model's do
(``pipeline_microbatches`` 8 and 0 over 8 global rows: each rank runs
the 4 whole one-row microbatches its rows hold), Adam against the JAX
engine on the same mesh; ZeRO stage 3 at pp 2 x dp 2 and Megatron
tensor parallelism at pp 2 x mp 2 (dp 1, the same four ranks), Adam
against the JAX engine on the same mesh, where the port refused both
before; the optimizer-state layouts with stages: bf16 moments at ZeRO 1
against the JAX engine on the same mesh, and compensated masters
(bfloat16 compute) against the port at pp 1 on the same global batches,
at the bf16 tolerances of torch_moe_pp.check_bf16 (the JAX pipeline
aborts in XLA on the CPU at bfloat16 compute: "Invalid binary
instruction opcode copy").
tests/test_torch_pipeline.py holds pp 2 x dp 1 and the schedule.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

import torch_dp_ranks as ranks
import torch_moe_pp as mp
from torch_test_env import jax_compile_cache  # noqa: F401

PP, DP = 2, 2
# pipeline_microbatches over the 8 global rows (0: the JAX default, 4*PP)
GLOBAL_SPLITS = (8, 0)

# once refused at a pipe axis (each now builds): {name: engine changes}
LIFTED = {
    "stage3": {"case": {"stage": 3}},
    "model_axis": {"mesh": {"model_parallel_size": 2}},
}
MP = 2
COMPENSATED = {"data_types": {"master_dtype": "compensated"}}
BF16_MOMENTS = {"data_types": {"optimizer_state_dtype": "bf16"}}
SPARSE = {"sparse_gradients": True}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp2dp2")
    params = mp.weights("pp")
    mp.save_port_weights(params, d / "pp.pt")
    cases = [mp.case("pp", f"adam-s{s}", stage=s) for s in range(3)]
    cases += [mp.case("pp", f"n_micro{n}", n_micro=n) for n in GLOBAL_SPLITS]
    cases += [mp.case("pp", "bf16_moments-s1", stage=1, extra=BF16_MOMENTS),
              mp.case("pp", "compensated", dtype="bf16",
                      extra=COMPENSATED)]
    cases += [mp.case("pp", "sparse-s1", stage=1, extra=SPARSE),
              mp.case("pp", "adam-s3", stage=3),
              mp.case("pp", "pp2mp2-adam",
                      extra={"mesh": {"model_parallel_size": MP}})]
    cases += [mp.case("pp", "fusedlamb-s1", stage=1, opt="FusedLamb"),
              dict(mp.case("pp", "refusals"), kind="moe_pp_refusals",
                   refusals=LIFTED)]
    handle = ranks.start(PP * DP, cases, d)
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(mp.jax_run, "pp", params, DP, 1, "FusedLamb")
        jobs = {f"n_micro{n}": pool.submit(
            mp.jax_run, "pp", params, DP, 0, "Adam", n_micro=n)
            for n in GLOBAL_SPLITS}
        jobs["adam-s3"] = pool.submit(mp.jax_run, "pp", params, DP, 3,
                                      "Adam")
        jobs["sparse-s1"] = pool.submit(mp.jax_run, "pp", params, DP, 1,
                                        "Adam", extra=SPARSE)

        jobs["bf16_moments-s1"] = pool.submit(
            mp.jax_run, "pp", params, DP, 1, "Adam", extra=BF16_MOMENTS)
        pp1_compensated = mp.in_process(ranks.case_moe_pp_train,
            dict(mp.case("pp", "pp1-compensated", dtype="bf16",
                         extra=COMPENSATED), pp=1, n_micro=0,
                 micro=mp.PP_MICRO * DP), d)
        jobs["pp2mp2-adam"] = pool.submit(mp.jax_run, "pp", params, 1, 0,
                                          "Adam", mp=MP)
        pp1 = mp.in_process(ranks.case_moe_pp_train,
            dict(mp.case("pp", "pp1"), pp=1, n_micro=0,
                 micro=mp.PP_MICRO * DP), d)
        results = ranks.finish(handle, timeout=240)
        oracle = oracle.result()
        jax_runs = {n: f.result() for n, f in jobs.items()}
        jax_runs["compensated"] = (pp1_compensated["losses"], None,
                                   pp1_compensated["params"])
    return results, oracle, pp1, jax_runs


@pytest.mark.parametrize("name", ["adam-s0", "adam-s1", "adam-s2",
                                  "fusedlamb-s1"])
def test_gpt2_pp2_dp2_matches_jax(runs, name):
    """FusedLamb against the JAX engine on the same mesh; Adam against pp
    1 at dp 1 on the same global batches (Adam's JAX oracle on a pipe
    mesh is tests/test_torch_pipeline.py's)."""
    results, oracle, pp1, _ = runs
    mp.same_on_every_rank(results, name)
    if name.startswith("fusedlamb"):
        want_losses, _, want_params = oracle
    else:
        want_losses, want_params = pp1["losses"], pp1["params"]
    mp.check(results[0][name], want_losses, want_params)
    # rank = pipe * dp + data: the pipe axis outermost, as the JAX mesh
    assert [r[name]["coords"] for r in results] == [(0, 0), (0, 1), (1, 0),
                                                    (1, 1)]


@pytest.mark.parametrize("n_micro", GLOBAL_SPLITS)
def test_gpt2_pp2_dp2_microbatches_split_the_global_batch(runs, n_micro):
    """8 global microbatches of one row: each data rank runs the 4 whole
    microbatches its rows hold (global indices 4 * data rank onwards);
    Adam at ZeRO 0 against the JAX engine on the same mesh."""
    results, _, _, jax_runs = runs
    name = f"n_micro{n_micro}"
    mp.same_on_every_rank(results, name)
    want_losses, _, want_params = jax_runs[name]
    mp.check(results[0][name], want_losses, want_params)
    for r in results:
        data = r[name]["coords"][1]
        assert tuple(r[name]["plan"]) == (8, 4, 4 * data, 1)


@pytest.mark.parametrize("name", ["adam-s3", "pp2mp2-adam", "sparse-s1"])
def test_gpt2_pp2_stage3_and_model_axis_match_jax(runs, name):
    """ZeRO stage 3 at pp 2 x dp 2 (the layer-wise gather disarmed, as
    the JAX engine disarms it with stages), Megatron tensor parallelism
    at pp 2 x mp 2 and ``sparse_gradients`` at pp 2 x dp 2 (stage 0's
    lookup reduced over its data group): Adam against the JAX engine on
    the same mesh."""
    results, _, _, jax_runs = runs
    mp.same_on_every_rank(results, name)
    want_losses, _, want_params = jax_runs[name]
    mp.check(results[0][name], want_losses, want_params)
    if name == "pp2mp2-adam":
        assert [r[name]["coords"] for r in results] == [(0, 0), (0, 0),
                                                        (1, 0), (1, 0)]


@pytest.mark.parametrize("name", ["bf16_moments-s1", "compensated"])
def test_gpt2_pp2_state_layouts_match_jax(runs, name):
    """bf16 moments and compensated masters over the stages: Adam against
    the JAX engine on the same pipe=2 x data=2 mesh (compensated: against
    the port at pp 1, see the module docstring)."""
    results, _, _, jax_runs = runs
    mp.same_on_every_rank(results, name)
    want_losses, _, want_params = jax_runs[name]
    if name == "compensated":
        mp.check_bf16(results[0][name], want_losses, want_params)
    else:
        mp.check(results[0][name], want_losses, want_params)


@pytest.mark.parametrize("name,message", [
    ("stage3", "ZeRO stage 3 at a pipe axis above 1 (ROADMAP A7d, what is "
               "left)"),
    ("model_axis", "a model axis above 1 at a pipe axis above 1 (ROADMAP "
                   "A7d"),
])
def test_pipeline_refusals_at_dp2(runs, name, message):
    """Lifted: the engine builds where it refused with ``message``
    (trained in test_gpt2_pp2_stage3_and_model_axis_match_jax)."""
    results, *_ = runs
    for r in results:
        assert r["refusals"][name] is None, (message, r["refusals"][name])
