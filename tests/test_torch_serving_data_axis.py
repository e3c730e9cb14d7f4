"""Serving over a data axis: the port's engine at dp 2 (two gloo ranks) and
at dp 2 x mp 2 (four), held to the JAX engine on the same meshes of its
CPU devices.

The JAX engine builds its serving mesh from ``data_parallel_size`` and
``model_parallel_size`` and replicates the weights and the KV pool over
the data axis (its KV specs shard only heads); every reference serving
test runs it over a data axis of 8. The port builds the same mesh over
its processes: global rank 0 leads (scheduler, pool, registries,
sampling) and broadcasts every plan to the whole serving world, and
every other rank, of any data or model coordinate, follows. The model is
tests/test_torch_serving_model_parallel.py's (2 layers, width 32, 4
heads, vocab 128, weights from ``PRNGKey(0)``); the traffic is
tests/torch_dp_ranks.py's ``serve_traffic``: the paged pool with fused
decode, a prefix-cache hit, two adapters beside the base in one batch,
and speculative decoding at k = 3. Greedy tokens and counters are equal;
every data replica holds the whole pool at its model shard. One spawn a
mesh, both started before the oracles run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import torch_dp_ranks as ranks
from deepspeed_tpu.adapters import init_lora_params as jinit_lora_params
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.models.gpt2 import partition_specs as jpartition_specs
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import adapters_from_jax, params_from_jax
from torch_test_env import jax_compile_cache  # noqa: F401

DP = 2
#: (data, model) sizes -> the traffic kinds served there
MESHES = {(DP, 1): ("paged", "prefix", "lora", "spec"),
          (DP, 2): ("paged", "lora")}


def _jax_model(seed=0, n_layer=2):
    cfg = JGPT2Config(vocab_size=ranks.SERVE_VOCAB, n_positions=64,
                      n_embd=32, n_layer=n_layer, n_head=4, dropout=0.0,
                      use_flash=False)
    model = JGPT2LMHeadModel(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init({"params": jax.random.PRNGKey(seed),
                         "dropout": jax.random.PRNGKey(seed + 1)},
                        ids, ids)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _adapter(params, seed):
    tree = jinit_lora_params(params, ranks.SERVE_ADAPTERS["rank"])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (0.2 * rng.standard_normal(x.shape)).astype(np.float32),
        tree)


def _jax_serve(kind, dp, mp, jmodel, params, adapters, draft):
    kw = {}
    if kind == "spec":
        kw = dict(draft_model=draft[0], draft_parameters=draft[1])
    engine = deepspeed_tpu.init_inference(
        model=jmodel, model_parameters=params,
        config=dict(ranks.SERVE_CONFIGS[kind]),
        mesh=build_mesh(data_parallel_size=dp, model_parallel_size=mp,
                        devices=jax.devices()[:dp * mp]),
        param_specs=jpartition_specs(params), **kw)
    try:
        tokens = ranks.serve_traffic(engine, kind, adapters)
        snap = engine.metrics.snapshot()
        return {"tokens": tokens,
                "counters": {k: snap.get(k) for k in ranks.SERVE_COUNTERS},
                "mesh": dict(engine._mesh.shape)}
    finally:
        engine.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jmodel, params = _jax_model()
    jdraft, dparams = _jax_model(seed=7, n_layer=1)
    adapters = {n: _adapter(params, s) for n, s in zip("abc", (3, 4, 5))}
    root = tmp_path_factory.mktemp("serve_dp")
    handles = {}
    for (dp, mp), kinds in MESHES.items():
        d = root / f"dp{dp}mp{mp}"
        d.mkdir()
        torch.save(params_from_jax(params), d / "serve.pt")
        torch.save(params_from_jax(dparams), d / "draft.pt")
        for n, tree in adapters.items():
            torch.save(adapters_from_jax(tree), d / f"adapter_{n}.pt")
        mesh = {"data_parallel_size": dp, "model_parallel_size": mp}
        handles[dp, mp] = ranks.start(
            dp * mp, [{"kind": "serve_mp", "name": k, "traffic": k,
                       "mesh": mesh} for k in kinds], d)
    oracle = {(dp, mp): {k: _jax_serve(k, dp, mp, jmodel, params, adapters,
                                       (jdraft, dparams)) for k in kinds}
              for (dp, mp), kinds in MESHES.items()}
    port = {key: ranks.finish(h, timeout=300) for key, h in handles.items()}
    return port, oracle


CASES = [(dp, mp, k) for (dp, mp), kinds in MESHES.items() for k in kinds]


@pytest.mark.parametrize("dp,mp,kind", CASES)
def test_greedy_tokens_equal_the_jax_engine(runs, dp, mp, kind):
    port, oracle = runs
    want = oracle[dp, mp][kind]
    assert want["mesh"] == {"pipe": 1, "data": dp, "sequence": 1,
                            "model": mp}
    assert port[dp, mp][0][kind]["tokens"] == want["tokens"]


@pytest.mark.parametrize("dp,mp,kind", CASES)
def test_counters_equal_the_jax_engine(runs, dp, mp, kind):
    port, oracle = runs
    assert port[dp, mp][0][kind]["counters"] == oracle[dp, mp][kind][
        "counters"]


@pytest.mark.parametrize("dp,mp", list(MESHES))
def test_global_rank_0_leads_and_every_replica_holds_the_pool(runs, dp, mp):
    """Rank = data rank * mp + model rank; only global rank 0 leads; every
    data replica holds the whole paged pool at its model shard ([L, pages
    + 1, block, heads / mp, hd]), so a rank's pool bytes are the one-rank
    engine's over mp."""
    port, _ = runs
    results = port[dp, mp]
    assert [r["paged"]["coords"] for r in results] == [
        (d * mp + m, d, m, d * mp + m == 0)
        for d in range(dp) for m in range(mp)]
    for r in results:
        assert r["paged"]["kv_shape"] == (2, 4 * 6 + 1, 8, 4 // mp, 8)
        assert r["paged"]["kv_bytes"] * mp == 2 * 2 * 25 * 8 * 4 * 8 * 4
        assert r["paged"]["fused"]


def test_the_prefix_and_speculative_paths_ran(runs):
    """The cases reach what they claim at dp 2: a prefix hit, proposals
    with rejections, three adapter loads."""
    port, _ = runs
    first = port[DP, 1][0]
    assert first["prefix"]["counters"]["infer/prefix_hits"] >= 1
    spec = first["spec"]["counters"]
    assert 0 < spec["infer/spec_accepted"] < spec["infer/spec_proposed"]
    assert first["lora"]["counters"]["adapters/loads"] == 3
