"""ZeRO stages 0-3 across gloo ranks on GPT-2 with Adam and Lamb, held to
the JAX engine (tests/torch_dp_gpt2.py: a 2-layer GPT-2 at width 64, 5
windows of 2 micro-batches).

In 2 rank processes at stages 0-3 with Adam and Lamb, and in 4 with
Adam: the window losses and the parameters agree with the JAX engine's
at the same data size to ``rtol=2e-4, atol=1e-5`` (the tolerance of
tests/unit/test_engine.py:113-135). The JAX engine runs once per
optimizer and data size, at one stage; every port stage is held to it
(the JAX stages lay out the same update).

The learning rate is 1e-4. Adam divides each element's gradient by its
own running norm, so where a gradient is near zero the last bits of a
sum taken in another order become a fraction of a step: at lr 1e-3 the
JAX engine at dp = 4 and at dp = 1 on the same global batches already
differ by 3.5e-5 on one element after 5 windows (beyond the tolerance);
at lr 1e-4 by at most 3.5e-6.

Stage 3 runs the blocks through the layer-wise gather stack
(models/stack.py): with and without latency hiding, with remat (the
gather block is the remat region) and with one layer per gather block,
all held to the same oracle; its gauges equal the JAX engine's.
"""

import pytest

import torch_dp_gpt2 as g
from torch_test_env import jax_compile_cache  # noqa: F401

ORACLES = {(2, "adam"): 3, (2, "lamb"): 2, (4, "adam"): 1}
# stage-3 variants, each held to the Adam oracle
VARIANTS = {
    "sync": {"extra": {"zero_optimization": {
        "stage": 3, "stage3_latency_hiding": False}}},
    "block1": {"extra": {"zero_optimization": {
        "stage": 3, "stage3_gather_block": 1}}},
    "remat": {"remat": True},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three spawns (the dp = 2 cases split in two) beside the oracles."""
    dp2 = g.cases(["adam", "lamb"], VARIANTS)
    dp2 += [{"name": f"order-{v}", "kind": "gather_order", "model": "gpt2",
             "weights": "gpt2.pt", "remat": v == "remat",
             "extra": {"zero_optimization": {
                 "stage": 3, "stage3_gather_block": 1,
                 "stage3_latency_hiding": v != "sync"}}}
            for v in ("hiding", "sync", "remat")]
    return g.run(tmp_path_factory,
                 [(2, dp2[0::2]), (2, dp2[1::2]), (4, g.cases(["adam"]))],
                 ORACLES)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("dp,key", list(ORACLES))
def test_gpt2_zero_stage_matches_jax_engine(runs, dp, key, stage):
    port, oracle, _ = runs
    g.check(port[dp], f"{key}-s{stage}", *oracle[(dp, key)])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stage3_gather_stack_variants_match_jax_engine(runs, variant):
    port, oracle, _ = runs
    g.check(port[2], f"adam-{variant}", *oracle[(2, "adam")])
    assert port[2][0][f"adam-{variant}"]["zero3_armed"]


@pytest.mark.parametrize("dp", [2, 4])
def test_gpt2_stage3_gauges_equal_the_jax_accounting(runs, dp):
    port, _, (model, params) = runs
    engine = g.jax_engine(model, params, dp, 3, "Adam", "fp32")
    want = (engine._zero3_shard_bytes, engine._zero3_gather_bytes)
    for r in port[dp]:
        assert r["adam-s3"]["zero3_armed"]
        assert tuple(r["adam-s3"]["zero3_bytes"]) == want


@pytest.mark.parametrize("variant", ["hiding", "sync", "remat"])
def test_stage3_gathers_a_block_at_a_time_and_regathers_backward(runs,
                                                                 variant):
    """One layer a gather block, 2 layers: the forward gathers block 0
    then block 1, the backward gathers again from the last block down
    (the gathered tensors were not kept); with latency hiding the next
    block's gathers are issued before a block computes, so block 1's is
    in flight at block 0's compute, and nothing is left pending after
    the forward."""
    for r in runs[0][2]:
        got = r[f"order-{variant}"]
        assert got["order"] == [("fwd", 0), ("fwd", 1), ("bwd", 1),
                                ("bwd", 0)]
        assert got["pending_after_forward"] == 0
