"""ZeRO stages 0-3 across 2 gloo ranks on GPT-2 with FusedLamb (its plain
path on the CPU) and with Adam's int8 moments, held to the JAX engine
(tests/torch_dp_gpt2.py: a 2-layer GPT-2 at width 64, 5 windows of 2
micro-batches at lr 1e-4, tolerance ``rtol=2e-4, atol=1e-5`` as
tests/test_torch_zero_gpt2.py). FusedLamb's per-group partial norms are
reduced over the ranks after its phase 1 on the shards; int8 moments
shard as the JAX engine's flat leaves, in contiguous block ranges of
each group in the JAX element order.
"""

import pytest

import torch_dp_gpt2 as g
from torch_test_env import jax_compile_cache  # noqa: F401

ORACLES = {(2, "fusedlamb"): 1, (2, "int8"): 3}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dp2 = g.cases(["fusedlamb", "int8"])
    return g.run(tmp_path_factory, [(2, dp2[0::2]), (2, dp2[1::2])],
                 ORACLES)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("key", ["fusedlamb", "int8"])
def test_gpt2_zero_stage_matches_jax_engine(runs, key, stage):
    port, oracle, _ = runs
    g.check(port[2], f"{key}-s{stage}", *oracle[(2, key)])
