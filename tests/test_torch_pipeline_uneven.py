"""Pipeline microbatches that neither divide over the data axis nor fit
whole into a data rank's rows: GPT-2 at pp 2 x dp 4 (eight gloo ranks),
12 global rows a micro-step, held to the JAX engine on the same ``pipe=2
x data=4`` mesh of its CPU devices.

The JAX model reshapes the global batch into ``pipeline_microbatches``
microbatches and leaves a split that does not divide over the data axis
to GSPMD. The port's data rank runs the pieces of the microbatches its
rows cut (models/gpt2.py:pipeline_plan): at 2 microbatches of 6 rows each
rank holds 3 rows of one of them; at 6 microbatches of 2 rows a rank's 3
rows straddle two microbatches (pieces of 2 and 1 rows, or 1 and 2).
Adam at ZeRO 0, dropout 0, 2 windows of 2 micro-steps: losses and the
whole parameters to the pipeline files' tolerance (rtol 2e-4, atol
1e-5), and each rank's plan.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

import torch_dp_ranks as ranks
import torch_moe_pp as mp
from torch_test_env import jax_compile_cache  # noqa: F401

PP, DP, ROWS = 2, 4, 12
SPLITS = (2, 6)
#: the plan of each data rank: (n_micro, pieces, first, rows of each)
PLANS = {2: [(2, 1, 0, (3,)), (2, 1, 0, (3,)), (2, 1, 1, (3,)),
             (2, 1, 1, (3,))],
         6: [(6, 2, 0, (2, 1)), (6, 2, 1, (1, 2)), (6, 2, 3, (2, 1)),
             (6, 2, 4, (1, 2))]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp2dp4")
    params = mp.weights("pp")
    mp.save_port_weights(params, d / "pp.pt")
    cases = [mp.case("pp", f"n_micro{n}", n_micro=n, micro=ROWS // DP)
             for n in SPLITS]
    handle = ranks.start(PP * DP, cases, d)
    with ThreadPoolExecutor(1) as pool:
        jobs = {n: pool.submit(mp.jax_run, "pp", params, DP, 0, "Adam",
                               rows=ROWS, n_micro=n) for n in SPLITS}
        results = ranks.finish(handle, timeout=240)
        oracle = {n: f.result() for n, f in jobs.items()}
    return results, oracle


@pytest.mark.parametrize("n_micro", SPLITS)
def test_uneven_microbatches_match_jax(runs, n_micro):
    results, oracle = runs
    name = f"n_micro{n_micro}"
    mp.same_on_every_rank(results, name)
    want_losses, _, want_params = oracle[n_micro]
    mp.check(results[0][name], want_losses, want_params)


@pytest.mark.parametrize("n_micro", SPLITS)
def test_each_rank_runs_the_pieces_its_rows_cut(runs, n_micro):
    results, _ = runs
    name = f"n_micro{n_micro}"
    assert [r[name]["coords"] for r in results] == [
        (p, d) for p in range(PP) for d in range(DP)]
    for r in results:
        data = r[name]["coords"][1]
        assert tuple(r[name]["plan"]) == PLANS[n_micro][data]
