"""Serving over the model axis: the port's engine at mp 2 on two gloo
ranks, held to the JAX engine on an mp 2 mesh.

The model is a small GPT-2 (2 layers, width 32, 4 heads, vocab 128) with
weights from ``PRNGKey(0)``, carried over with ``params_from_jax``. Every
rank builds the engine with ``mesh: {"model_parallel_size": 2}``; rank 0
(the leader) takes the traffic of tests/torch_dp_ranks.py's
``serve_traffic`` and the other rank follows its plans
(``serve_forever``). The JAX engine runs the same traffic with
``mesh=build_mesh(model_parallel_size=2)`` over the 8 CPU devices and
``param_specs=partition_specs(params)``. Greedy tokens are equal for the
paged pool with fused decode (the plain versions on the CPU), a
prefix-cache hit, the contiguous cache, two adapters and the base in one
batch, the host tier with spills and promotions (pages and adapter
rows), and speculative decoding at k = 3; so are the counters
(``infer/spec_*``, ``host_tier/*``, prefix hits, adapter loads). The
port keeps fused decode at mp 2 (its kernels run per rank), where the
JAX engine falls back to its XLA path: the ``infer/fused_decode`` gauge
reads 1 on the port and 0 on the JAX engine. A leader's tier parks only
its heads' rows, so its occupancy is half the JAX engine's. The prefill
logits are pinned at the JAX engine's tolerance plus argmax; a deadline
that expires on rank 0 mid-run finishes its request without a hang, and
the engine serves on. One spawn runs every case.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import torch_dp_ranks as ranks
from deepspeed_tpu.adapters import init_lora_params as jinit_lora_params
from deepspeed_tpu.inference.decode import gpt2_prefill as jgpt2_prefill
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.models.gpt2 import partition_specs as jpartition_specs
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import adapters_from_jax, params_from_jax
from torch_test_env import jax_compile_cache  # noqa: F401

MP = 2
KINDS = ("paged", "prefix", "contig", "lora", "tier", "tier_lora", "spec",
         "deadline")


def _jax_model(seed=0, n_layer=2):
    cfg = JGPT2Config(vocab_size=ranks.SERVE_VOCAB, n_positions=64,
                      n_embd=32, n_layer=n_layer, n_head=4, dropout=0.0,
                      use_flash=False)
    model = JGPT2LMHeadModel(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init({"params": jax.random.PRNGKey(seed),
                         "dropout": jax.random.PRNGKey(seed + 1)},
                        ids, ids)["params"]
    return cfg, model, jax.tree_util.tree_map(np.asarray, params)


def _adapter(params, seed):
    """A nonzero JAX adapter tree (random A and B)."""
    tree = jinit_lora_params(params, ranks.SERVE_ADAPTERS["rank"])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (0.2 * rng.standard_normal(x.shape)).astype(np.float32),
        tree)


def _jax_serve(kind, jmodel, params, adapters, draft):
    cfg = dict(ranks.SERVE_CONFIGS[kind])
    kw = {}
    if kind == "spec":
        kw = dict(draft_model=draft[0], draft_parameters=draft[1])
    engine = deepspeed_tpu.init_inference(
        model=jmodel, model_parameters=params, config=cfg,
        mesh=build_mesh(model_parallel_size=MP),
        param_specs=jpartition_specs(params), **kw)
    try:
        tokens = ranks.serve_traffic(
            engine, "paged" if kind == "deadline" else kind, adapters)
        snap = engine.metrics.snapshot()
        return {"tokens": tokens,
                "counters": {k: snap.get(k) for k in ranks.SERVE_COUNTERS},
                "fused_gauge": snap["infer/fused_decode"]}
    finally:
        engine.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, jmodel, params = _jax_model()
    _, jdraft, dparams = _jax_model(seed=7, n_layer=1)
    adapters = {n: _adapter(params, s) for n, s in zip("abc", (3, 4, 5))}
    d = tmp_path_factory.mktemp("serve_mp")
    torch.save(params_from_jax(params), d / "serve.pt")
    torch.save(params_from_jax(dparams), d / "draft.pt")
    for n, tree in adapters.items():
        torch.save(adapters_from_jax(tree), d / f"adapter_{n}.pt")
    handle = ranks.start(MP, [{"kind": "serve_mp", "name": k, "traffic": k}
                              for k in KINDS], d)
    oracle = {k: _jax_serve(k, jmodel, params, adapters, (jdraft, dparams))
              for k in KINDS}
    ids = jnp.asarray([ranks.serve_prompts(1, seed=9, lengths=(12,))[0]])
    logits = np.asarray(jgpt2_prefill(jcfg, jax.device_put(params), ids)[0])
    return ranks.finish(handle, timeout=300), oracle, logits


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "deadline"])
def test_greedy_tokens_equal_the_jax_engine(runs, kind):
    port, oracle, _ = runs
    got, want = port[0][kind]["tokens"], oracle[kind]["tokens"]
    if kind == "tier":  # (tokens, the pool's and tier's counters)
        got, want = got[0], want[0]
    assert got == want


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "deadline"])
def test_counters_equal_the_jax_engine(runs, kind):
    port, oracle, _ = runs
    got, want = port[0][kind]["counters"], oracle[kind]["counters"]
    assert got == want


def test_spec_and_tier_paths_ran(runs):
    """The cases reach what they claim: proposals and rejections,
    spills and promotions of pages and of adapter rows, a prefix hit."""
    port, oracle, _ = runs
    spec = port[0]["spec"]["counters"]
    assert 0 < spec["infer/spec_accepted"] < spec["infer/spec_proposed"]
    for kind in ("tier", "tier_lora"):
        c = port[0][kind]["counters"]
        assert c["host_tier/spills"] >= 1 and c["host_tier/promotions"] >= 1
    assert port[0]["prefix"]["counters"]["infer/prefix_hits"] >= 1
    assert port[0]["lora"]["counters"]["adapters/loads"] == 3


def test_the_leaders_tier_parks_its_heads_only(runs):
    port, oracle, _ = runs
    tokens, snap = port[0]["tier"]["tokens"]
    jtokens, jsnap = oracle["tier"]["tokens"]
    assert tokens == jtokens
    for k in ("prefix_hits", "host_tier_spills", "host_tier_promotions",
              "host_tier_entries"):
        assert snap[k] == jsnap[k], k
    assert snap["host_tier_occupancy_bytes"] * MP == (
        jsnap["host_tier_occupancy_bytes"])


def test_fused_decode_stays_on_where_the_jax_engine_drops_it(runs):
    port, oracle, _ = runs
    for r in port:
        assert r["paged"]["fused"] and r["lora"]["fused"]
    assert port[0]["paged"]["fused_gauge"] == 1
    assert oracle["paged"]["fused_gauge"] == 0


def test_each_rank_holds_its_heads_and_adapter_shards(runs):
    port, _, _ = runs
    for r in port:
        # [L, pages + 1, block, heads / mp, hd] and the contiguous
        # [L, slots, heads / mp, max_len, hd]
        assert r["paged"]["kv_shape"] == (2, 4 * 6 + 1, 8, 4 // MP, 8)
        assert r["contig"]["kv_shape"] == (2, 4, 4 // MP, 48, 8)
        shapes = r["lora"]["adapter_shapes"]
        rank = ranks.SERVE_ADAPTERS["rank"]
        assert shapes["attn_qkvw"] == ((2, 5, 32, rank),
                                       (2, 5, rank, 96 // MP))
        assert shapes["inter_w"] == ((2, 5, 32, rank), (2, 5, rank, 128 // MP))
        assert shapes["attn_ow"] == ((2, 5, 32 // MP, rank), (2, 5, rank, 32))
        assert shapes["output_w"] == ((2, 5, 128 // MP, rank),
                                      (2, 5, rank, 32))


def test_prefill_logits_pinned_with_argmax(runs):
    port, _, want = runs
    for r in port:
        got = r["paged"]["logits"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[..., :ranks.SERVE_VOCAB].argmax(-1),
                                      want[..., :ranks.SERVE_VOCAB].argmax(-1))


def test_a_deadline_expiring_on_the_leader_finishes_without_a_hang(runs):
    port, oracle, _ = runs
    reason, n = port[0]["deadline"]["late"]
    assert reason == "deadline" and 0 < n < 38
    # the engine served on, its ranks still in step
    assert port[0]["deadline"]["tokens"] == oracle["deadline"]["tokens"]
