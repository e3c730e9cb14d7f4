"""Megatron tensor parallelism in training at dp 2 x mp 2, held to the
JAX engine.

The port trains GPT-2 (2 layers, width 64, 4 heads, vocab 256) with
``initialize(param_specs=partition_specs(model))`` and a model axis of 2
in a spawn of 4 ranks (rank = data rank * 2 + model rank; tests/
torch_dp_ranks.py), at ZeRO stages 0-3 with Adam and FusedLamb (its
plain path on the CPU). Each model rank holds its Megatron shard: the
strided qkv columns, ``inter_w``'s rows, ``attn_ow``'s and
``output_w``'s columns, ``wte``'s vocab rows. The oracle is the JAX engine on a 2 x 2 data x model mesh
with the JAX ``partition_specs`` (tests/torch_mp_gpt2.py), fed the global
batches: the window losses and the whole parameters after 5 windows
agree to ``rtol=2e-4, atol=1e-5``. One JAX run per optimizer, its stage
rotated; every port stage is held to it. LAMB's trust ratio is per JAX
leaf: each group's norms sum the model shards of the leaf, and the
ratios equal the JAX engine's ``lamb_coeffs``. Adam with int8 moments
runs once, at stage 2. dp 1 x mp 2 is
tests/test_torch_model_parallel.py; ZeRO runs over the data group on
the model shards.
"""

import pytest

import torch_mp_gpt2 as mpg
from torch_test_env import jax_compile_cache  # noqa: F401

DP = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mpg.layout_runs(tmp_path_factory, DP)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("key", list(mpg.OPTS))
def test_tensor_parallel_stage_matches_jax_engine(runs, key, stage):
    mpg.check_layout(runs, key, stage)


def test_int8_moments_at_stage_2_match_jax_engine(runs):
    # the optimizer steps model-gathered tensors (the JAX engine's flat
    # int8 leaves are whole over the model axis): each window's gradient
    # shards are joined over the model group once, then reduce-scattered
    # over the data group
    mpg.check_int8(runs)


def test_each_rank_holds_its_megatron_shard(runs):
    mpg.check_shards(runs)


def test_lamb_trust_ratios_are_per_jax_leaf(runs):
    mpg.check_lamb_ratios(runs)
