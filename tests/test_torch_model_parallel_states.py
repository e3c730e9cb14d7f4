"""Tensor parallelism with the optimizer-state layouts, LoRA and a
replicated model, held to the JAX engine at dp 1 x mp 2.

One spawn of 2 ranks (one model line) trains GPT-2 (tests/
torch_mp_gpt2.py) in each layout beside the JAX engine on a 1 x 2 mesh:

- the plain Lamb (its per-group norms summed over the model shards of
  each JAX leaf, one reduction for every group);
- int8 moments: the JAX engine keeps its flat int8 leaves whole over the
  model axis (their blocks cross the model split), so the port's
  optimizer steps the model-gathered tensors and cuts its shards from
  them;
- compensated masters (bf16 parameters and int8 codes, elementwise on
  the shards), bf16 tolerances as tests/test_torch_refusals_lifted.py:
  losses rtol 2e-4, parameters one bf16 ulp for all but 0.5% of the
  elements;
- optimizer offload (the masters of the rank's shards on the host);
- a LoRA fine-tune (the adapters block): the factors ride their base's
  model axis, only they train, and they equal the JAX engine's;
- no ``param_specs``: the model is replicated over the model axis (the
  JAX engine's leaves without a spec), every model rank computing the
  whole step.

fp32 layouts agree to ``rtol=2e-4, atol=1e-5``.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import torch_dp_gpt2 as g
import torch_dp_ranks as ranks
import torch_mp_gpt2 as mpg
from deepspeed_tpu.adapters import lora as jlora
from deepspeed_tpu_torch import adapters_from_jax, params_from_jax
from torch_test_env import jax_compile_cache  # noqa: F401

MP = 2
LORA_RANK = 4
BF16_LOSS_TOL = dict(rtol=2e-4, atol=0.0)
BF16_PARAM_TOL = dict(rtol=2.0 ** -7, atol=4e-5)
BF16_OUTLIERS = 5e-3
ADAPTERS = {"adapters": {"enabled": True, "rank": LORA_RANK}}
COMPENSATED = {"data_types": {"master_dtype": "compensated"}}
OFFLOAD = {"zero_optimization": {"stage": 1,
                                 "offload_optimizer": {"device": "cpu"}}}
# name: (stage, dtype, config blocks, port case fields, JAX fields)
LAYOUTS = {
    "lamb": (0, "fp32", {}, {"opt": "Lamb"}, {}),
    "int8": (0, "int8", {}, {}, {}),
    "compensated": (0, "bf16", COMPENSATED, {}, {}),
    "offload": (1, "fp32", OFFLOAD, {}, {}),
    "lora": (0, "fp32", ADAPTERS, {"model_parameters": "lora.pt"},
             {"factors": True}),
    "nospecs": (0, "fp32", {}, {"specs": False}, {"specs": False}),
}


def jadapters(params, seed=7):
    """A rank-4 adapter whose B factors are noised, so that both factors
    train from the first window (numpy leaves)."""
    tree = jax.device_get(jlora.init_lora_params(
        params, LORA_RANK, rng=jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def noise(path, leaf):
        leaf = np.asarray(leaf, np.float32)
        if jax.tree_util.keystr(path).endswith("_lora_b']"):
            return (0.02 * rng.normal(size=leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(noise, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, params = g.jmodel()
    adapters = jadapters(params)
    merged = jlora.merge_lora_params(
        jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
        adapters)
    workdir = tmp_path_factory.mktemp("mp_states")
    base = params_from_jax(jax.device_get(params))
    torch.save(base, workdir / "gpt2.pt")
    torch.save({**base, **adapters_from_jax(adapters)}, workdir / "lora.pt")
    cases = []
    for name, (stage, dtype, extra, fields, _) in LAYOUTS.items():
        case = mpg.case(name, MP, stage=stage, dtype=dtype, extra=extra)
        case.update(fields)
        cases.append(case)
    handle = ranks.start(MP, cases, workdir)
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        futures = {
            name: pool.submit(mpg.jax_run, merged if name == "lora"
                              else params, 1, MP, stage,
                              fields.get("opt", "Adam"), dtype,
                              **jfields, **extra)
            for name, (stage, dtype, extra, fields, jfields)
            in LAYOUTS.items()}
        oracle = {k: f.result() for k, f in futures.items()}
    return ranks.finish(handle, timeout=300), oracle, base


def _bf16_close(got, want):
    """One bf16 ulp for all but BF16_OUTLIERS of the elements."""
    total = bad = 0
    for n, w in want.items():
        ok = np.isclose(got[n], w, **BF16_PARAM_TOL)
        total += ok.size
        bad += int((~ok).sum())
    assert bad <= BF16_OUTLIERS * total, (bad, total)


@pytest.mark.parametrize("layout", ["lamb", "int8", "offload", "nospecs"])
def test_fp32_layouts_at_mp2_match_the_jax_engine(runs, layout):
    port, oracle, _ = runs
    mpg.check(port, layout, *oracle[layout])


def test_compensated_masters_at_mp2_match_the_jax_engine(runs):
    port, oracle, _ = runs
    mpg.check(port, "compensated", *oracle["compensated"],
              loss_tol=BF16_LOSS_TOL, param_close=_bf16_close)


def test_lora_at_mp2_trains_only_the_factors_as_the_jax_engine(runs):
    port, oracle, _ = runs
    want_losses, want = oracle["lora"]
    assert want and all("_lora_" in n for n in want)
    mpg.check(port, "lora", want_losses, want)
    # the factors are sharded on their base's axis: B of the column-
    # parallel qkv and inter_w, A of the row-parallel attn_ow and output_w
    shapes = port[1]["lora"]["local_shapes"]
    assert shapes["h.0.attn_qkvw_lora_b"] == (LORA_RANK, 3 * 64 // MP)
    assert shapes["h.0.inter_w_lora_b"] == (LORA_RANK, 4 * 64 // MP)
    assert shapes["h.0.attn_ow_lora_a"] == (64 // MP, LORA_RANK)
    assert shapes["h.0.output_w_lora_a"] == (4 * 64 // MP, LORA_RANK)
    assert shapes["h.0.attn_ow_lora_b"] == (LORA_RANK, 64)


def test_without_specs_every_rank_holds_the_whole_model(runs):
    port, _, base = runs
    for r in port:
        shapes = r["nospecs"]["local_shapes"]
        assert all(shapes[n] == tuple(t.shape) for n, t in base.items())
