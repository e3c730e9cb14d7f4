"""Port parity for multi-LoRA serving: the adapters config block, the
adapter state-dict helpers, the SGMV kernel's plain version, apply_lora,
the decode functions and the engine, deepspeed_tpu_torch (CPU, the
kernels' plain versions) against deepspeed_tpu (CPU; its Pallas kernels
in interpret mode), plus the port's own pool, salting and refusal
contracts.

Inputs are made from seeds with numpy (the JAX package's small adapter
fixture: 2 layers, n_embd 32, rank 2) and carried over with
``params_from_jax`` / ``adapters_from_jax``. Tolerances (float32): the
SGMV product and apply_lora atol = rtol = 1e-5 (one product pair summed
in another order); logits atol = rtol = 1e-4, as the serving slice's
parity (test_torch_gpt2_serving.py). Engine runs must give IDENTICAL
greedy tokens.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.adapters import lora as jlora
from deepspeed_tpu.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.inference import decode as jdecode
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu_torch import (
    GPT2Config,
    GPT2LMHeadModel,
    adapters_from_jax,
    params_from_jax,
)
from deepspeed_tpu_torch.adapters import (
    AdapterPool,
    AdapterPoolFull,
    AdapterUnavailable,
    adapter_layer_stacks,
    adapter_num_params,
    init_lora_params,
    merge_lora_params,
    split_lora_params,
)
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.inference import decode as tdecode
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import transformer as tops
from torch_test_env import jax_compile_cache  # noqa: F401

jda = importlib.import_module("deepspeed_tpu.ops.decode_attention")
jops = importlib.import_module("deepspeed_tpu.ops.transformer")

VOCAB = 97
RANK = 2
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_model(seed=0, **kw):
    """The JAX package's small adapter fixture (test_adapters.py)."""
    cfg = JGPT2Config(
        vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        dropout=0.0, use_flash=False, **kw,
    )
    model = JGPT2LMHeadModel(cfg)
    ids0 = jnp.asarray(
        np.random.default_rng(seed).integers(0, VOCAB, (1, 8)), jnp.int32
    )
    params = model.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        ids0, ids0,
    )["params"]
    return cfg, model, jax.device_get(params)


def _port_model(jcfg, params, **kw):
    cfg = GPT2Config(
        vocab_size=jcfg.vocab_size, n_positions=jcfg.n_positions,
        n_embd=jcfg.n_embd, n_layer=jcfg.n_layer, n_head=jcfg.n_head,
        layer_norm_eps=jcfg.layer_norm_eps, dropout=0.0, **kw,
    )
    model = GPT2LMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=not kw)
    return model


@pytest.fixture(scope="module")
def models():
    jcfg, jmodel, params = _jax_model()
    return jcfg, jmodel, params, _port_model(jcfg, params)


def _synth_adapter(params, seed, rank=RANK, scale=0.2):
    """A synthetic NONZERO JAX adapter tree (random A and B, numpy), as
    the JAX package's test_adapters.py builds it."""
    ada = jlora.init_lora_params(params, rank, rng=jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(
            jax.random.normal(
                jax.random.fold_in(jax.random.PRNGKey(seed), a.size),
                a.shape,
            ) * scale,
            np.float32,
        ),
        ada,
    )


def _prompt(n=8, seed=1):
    return [int(t) for t in np.random.default_rng(seed).integers(0, VOCAB, n)]


# ---------------------------------------------------------------------------
# the adapters config block (tests/unit/test_config.py's adapters table)
# ---------------------------------------------------------------------------
def _adapter_attrs(cfg):
    return {k: v for k, v in vars(cfg).items() if k.startswith("adapters_")}


@pytest.mark.parametrize("block", [
    {},
    {"enabled": True, "rank": 4, "alpha": 16.0,
     "targets": ["attn_qkvw", "attn_ow"], "pool_slots": 32},
    {"enabled": True, "rank": 16, "pool_slots": 4},
    {"enabled": False, "alpha": 0, "targets": None},
])
def test_adapters_block_parses_like_jax(block):
    jcfg = JConfig(None, param_dict={"train_batch_size": 8,
                                     "adapters": block}, world_size=1)
    tcfg = DeepSpeedConfig(None, param_dict={"adapters": block},
                           world_size=1)
    want = _adapter_attrs(jcfg)
    assert want and _adapter_attrs(tcfg) == want


@pytest.mark.parametrize("block", [
    {"enabled": "yes"}, {"rank": 0}, {"rank": -2}, {"rank": 2.5},
    {"rank": True}, {"alpha": -1.0}, {"alpha": "big"}, {"targets": []},
    {"targets": "attn_qkvw"}, {"targets": ["attn_qkvw", "wte"]},
    {"targets": ["attn_qkvw", "attn_qkvw"]}, {"targets": [1]},
    {"pool_slots": 0}, {"pool_slots": -1}, {"pool_slots": True},
])
def test_adapters_block_rejects_like_jax(block):
    with pytest.raises(Exception):
        JConfig(None, param_dict={"train_batch_size": 8, "adapters": block},
                world_size=1)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(None, param_dict={"adapters": block}, world_size=1)


# ---------------------------------------------------------------------------
# adapter state dicts
# ---------------------------------------------------------------------------
def test_adapters_from_jax_unstacks_without_transposing(models):
    _, _, params, _ = models
    ada = _synth_adapter(params, 1)
    state = adapters_from_jax(ada)
    h = ada["transformer"]["h"]
    assert len(state) == 2 * len(h)
    for name, stacked in h.items():
        for i in range(stacked.shape[0]):
            np.testing.assert_array_equal(
                state[f"h.{i}.{name}"].numpy(), stacked[i]
            )
    # the pool rows stack back to the JAX package's exactly
    want = jlora.adapter_layer_stacks(ada)
    got = adapter_layer_stacks(state)
    assert set(got) == set(want)
    for t, (a, b) in got.items():
        np.testing.assert_array_equal(a.numpy(), want[t][0])
        np.testing.assert_array_equal(b.numpy(), want[t][1])
    assert adapter_num_params(state) == jlora.adapter_num_params(ada)


def test_init_split_merge_match_the_jax_layout(models):
    jcfg, _, params, model = models
    base = model.state_dict()
    fresh = init_lora_params(base, 3, generator=torch.Generator().manual_seed(4))
    jfresh = adapters_from_jax(jlora.init_lora_params(params, 3))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: tuple(v.shape) for k, v in jfresh.items()
    }
    assert all(not v.any() for k, v in fresh.items() if k.endswith("_b"))
    a = fresh["h.0.attn_qkvw_lora_a"]
    assert 0.01 < float(a.std()) < 0.03
    again = init_lora_params(base, 3, generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)
    merged = merge_lora_params(base, fresh)
    b2, a2 = split_lora_params(merged)
    assert set(b2) == set(base) and set(a2) == set(fresh)
    assert all(b2[k] is base[k] for k in base)
    # a subset of targets
    only = init_lora_params(base, 2, targets=["attn_ow"])
    assert sorted({k.split(".")[2] for k in only}) == [
        "attn_ow_lora_a", "attn_ow_lora_b",
    ]


def test_init_and_stacks_reject_bad_input(models):
    _, _, _, model = models
    base = model.state_dict()
    with pytest.raises(ValueError, match="rank"):
        init_lora_params(base, 0)
    with pytest.raises(ValueError, match="unknown LoRA target"):
        init_lora_params(base, 2, targets=("attn_qkvw", "nope"))
    with pytest.raises(ValueError, match="no LoRA target"):
        init_lora_params({"x": torch.zeros(4, 4)}, 2)
    state = init_lora_params(base, 2)
    with pytest.raises(ValueError, match="missing"):
        adapter_layer_stacks(
            {k: v for k, v in state.items() if "inter_w" not in k}
        )
    with pytest.raises(ValueError, match="layers"):
        adapter_layer_stacks(
            {k: v for k, v in state.items() if not k.startswith("h.0.")}
        )


def test_adapter_pool_refcounts_block_eviction_and_unload():
    pool = AdapterPool(2)
    pool.assign("a")
    pool.assign("b")
    pool.acquire("a")
    pool.acquire("b")
    with pytest.raises(AdapterPoolFull):
        pool.assign("c")  # both busy: nothing evictable
    with pytest.raises(RuntimeError, match="live"):
        pool.remove("a")
    pool.release("b")
    idx, evicted = pool.assign("c")  # b idle: evicted
    assert evicted == "b" and idx == pool.index_of("c")
    with pytest.raises(ValueError, match="no live"):
        pool.release("b")
    pool.release("a")
    assert pool.remove("a") in (1, 2)
    # reload bumps the generation (the prefix-salt input)
    g1 = pool.generation_of("c")
    pool.assign("c")
    assert pool.generation_of("c") > g1
    assert pool.loaded == ["c"] and pool.used_slots == 1
    with pytest.raises(ValueError):
        AdapterPool(0)


# ---------------------------------------------------------------------------
# the SGMV kernel's function
# ---------------------------------------------------------------------------
def _sgmv_case(b, din, r, dout, n, ids, seed=5):
    rng = np.random.default_rng(seed)
    a_pool = np.asarray(rng.normal(size=(n + 1, din, r)), np.float32)
    b_pool = np.asarray(rng.normal(size=(n + 1, r, dout)), np.float32)
    a_pool[0] = 0.0
    b_pool[0] = 0.0
    x = np.asarray(rng.normal(size=(b, din)), np.float32)
    return x, a_pool, b_pool, np.asarray(ids, np.int32)


@pytest.mark.parametrize("b,din,r,dout,n,ids", [
    (4, 16, 2, 24, 3, [2, 0, 3, 1]),            # test_adapters.py:345
    (4, 16, 1, 24, 3, [2, 0, 3, 1]),            # rank 1
    (5, 32, 16, 96, 3, [3, 3, 0, 1, 3]),        # rank 16, repeated ids
    (3, 128, 16, 32, 2, [0, 0, 0]),             # only the identity
])
def test_sgmv_plain_matches_jax_kernel(b, din, r, dout, n, ids):
    x, a_pool, b_pool, ids = _sgmv_case(b, din, r, dout, n, ids)
    want = np.asarray(jda.lora_sgmv(
        jnp.asarray(x), jnp.asarray(a_pool), jnp.asarray(b_pool),
        jnp.asarray(ids),
    ))
    before = tda.lora_sgmv.launches
    got = tda.lora_sgmv(
        torch.from_numpy(x), torch.from_numpy(a_pool),
        torch.from_numpy(b_pool), torch.from_numpy(ids),
    )
    assert tda.lora_sgmv.launches == before  # the plain version, uncounted
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, dout)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for slot in np.flatnonzero(ids == 0):
        assert np.all(got[slot].numpy() == 0.0)  # the identity: exact zeros
        assert np.all(want[slot] == 0.0)


def test_sgmv_plain_rounds_t_to_the_pool_dtype():
    """In bfloat16, t = x @ A[id] is rounded to bfloat16 before the second
    product (the Pallas kernel's ``t.astype(b_ref.dtype)``): the plain
    version equals that float32 arithmetic exactly, differs from keeping t
    in float32, and agrees with the JAX kernel."""
    x, a_pool, b_pool, ids = _sgmv_case(4, 64, 16, 48, 2, [1, 2, 0, 1])
    xb, ab, bb = (torch.from_numpy(v).bfloat16() for v in (x, a_pool, b_pool))
    got = tda.lora_sgmv_plain(xb, ab, bb, torch.from_numpy(ids)).numpy()
    rows = torch.from_numpy(ids).long()
    t = torch.einsum("bi,bir->br", xb.float(), ab[rows].float())
    rounded = torch.einsum(
        "br,bro->bo", t.bfloat16().float(), bb[rows].float()
    ).numpy()
    unrounded = torch.einsum("br,bro->bo", t, bb[rows].float()).numpy()
    np.testing.assert_allclose(got, rounded, atol=1e-5, rtol=1e-5)
    assert np.abs(got - unrounded).max() > 1e-3
    want = np.asarray(jda.lora_sgmv(
        *(jnp.asarray(v.float().numpy(), jnp.bfloat16) for v in (xb, ab, bb)),
        jnp.asarray(ids),
    ))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(got[2] == 0.0)


def test_sgmv_wrapper_never_runs_plain_for_a_non_cpu_tensor():
    x, a_pool, b_pool, ids = _sgmv_case(2, 16, 2, 8, 1, [1, 0])
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tda._sgmv_cuda(*(torch.from_numpy(v) for v in (x, a_pool, b_pool,
                                                       ids)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("leading", [(), (1,)])
def test_sgmv_add_plain_is_the_unfused_ops_bit_for_bit(dtype, leading):
    """The epilogue form on CPU tensors (its plain version) is bit for bit
    ``y + (scale * lora_sgmv_plain(...)).to(y.dtype)``, shaped as y, for
    x/y [B, in]/[B, out] and [B, 1, in]/[B, 1, out]; the identity row
    leaves y unchanged, and nothing is counted as a launch."""
    x, a_pool, b_pool, ids = _sgmv_case(5, 32, 16, 96, 3, [3, 0, 1, 3, 2])
    x, a_pool, b_pool = (torch.from_numpy(v).to(dtype)
                         for v in (x, a_pool, b_pool))
    ids = torch.from_numpy(ids)
    y = torch.from_numpy(np.random.default_rng(8).normal(
        size=(5, 96)).astype(np.float32)).to(dtype)
    scale = 0.75
    xs = x.reshape(5, *leading, 32)
    ys = y.reshape(5, *leading, 96)
    before = tda.lora_sgmv.launches
    got = tda.lora_sgmv_add(xs, a_pool, b_pool, ids, ys, scale)
    assert tda.lora_sgmv.launches == before
    want = ys + (scale * tda.lora_sgmv_plain(x, a_pool, b_pool, ids)
                 .reshape(ys.shape)).to(dtype)
    assert got.dtype == dtype and got.shape == ys.shape
    assert torch.equal(got, want)
    assert torch.equal(got.reshape(5, 96)[1], y[1])  # id 0
    assert not torch.equal(got, ys)


def test_engine_fused_decode_takes_the_sgmv_epilogue_and_matches_jax(
        models, monkeypatch):
    """apply_lora's fused decode branch is one call of lora_sgmv_add a
    target (the kernel with its epilogue on the card): a batch mixing two
    adapters and the base model (id 0) gives the JAX engine's greedy
    tokens."""
    _, jmodel, params, model = models
    ada, adb = _synth_adapter(params, 3), _synth_adapter(params, 4)
    calls = []
    real = tops.lora_sgmv_add

    def counted(*args):
        calls.append(args[3].tolist())
        return real(*args)

    monkeypatch.setattr(tops, "lora_sgmv_add", counted)
    ej = deepspeed_tpu.init_inference(
        model=jmodel, model_parameters=params,
        config={"inference": dict(_BLOCK, fused_decode=True),
                "adapters": {"enabled": True, "rank": RANK,
                             "pool_slots": 4}},
    )
    et = _port_engine(model, inference={"fused_decode": True})
    try:
        for e, conv in ((ej, lambda t: t), (et, adapters_from_jax)):
            e.load_adapter("a", adapter_state=conv(ada))
            e.load_adapter("b", adapter_state=conv(adb))
        outs = []
        for e in (ej, et):
            reqs = [e.submit(_prompt(8, 21), max_new_tokens=6, adapter="b"),
                    e.submit(_prompt(6, 22), max_new_tokens=6),
                    e.submit(_prompt(7, 23), max_new_tokens=6, adapter="a")]
            e.scheduler.run_until_idle()
            outs.append([r.tokens for r in reqs])
        assert outs[1] == outs[0]
    finally:
        ej.close()
        et.close()
    # 4 targets x 2 layers a decode step, and a batch held ids 0 and both
    # adapters' rows
    assert calls and len(calls) % 8 == 0
    assert any(0 in ids and len(set(ids) - {0}) == 2 for ids in calls)


# ---------------------------------------------------------------------------
# apply_lora
# ---------------------------------------------------------------------------
def _lora_pools(seed, din, dout, n=3, rank=RANK):
    rng = np.random.default_rng(seed)
    a = np.asarray(rng.normal(size=(n + 1, din, rank)), np.float32)
    b = np.asarray(rng.normal(size=(n + 1, rank, dout)), np.float32)
    a[0] = b[0] = 0.0
    return a, b


@pytest.mark.parametrize("source", ["fused", "gathered", "gathered_seq",
                                    "per_layer"])
@pytest.mark.parametrize("name", ["attn_qkvw", "output_w"])
def test_apply_lora_matches_jax(source, name):
    jcfg = jops.DeepSpeedTransformerConfig(
        hidden_size=32, heads=4, intermediate_size=128, lora_rank=RANK,
        lora_alpha=4.0,
    )
    tcfg = tops.DeepSpeedTransformerConfig(
        hidden_size=32, heads=4, intermediate_size=128, lora_rank=RANK,
        lora_alpha=4.0,
    )
    din, dout = tcfg.lora_dims(name)
    rng = np.random.default_rng(7)
    s = 5 if source == "gathered_seq" else 1
    x = np.asarray(rng.normal(size=(4, s, din)), np.float32)
    y = np.asarray(rng.normal(size=(4, s, dout)), np.float32)
    scale = tops.lora_scaling(RANK, 4.0)
    assert scale == jops.lora_scaling(RANK, 4.0) == 2.0
    if source == "per_layer":
        a, b = (v[1] for v in _lora_pools(3, din, dout))
        jp = {f"{name}_lora_a": jnp.asarray(a), f"{name}_lora_b": jnp.asarray(b)}
        tp = types.SimpleNamespace(**{k: torch.from_numpy(np.array(v))
                                      for k, v in jp.items()})
        jlo = tlo = None
    else:
        a, b = _lora_pools(3, din, dout)
        ids = np.asarray([2, 0, 1, 2], np.int32)
        fused = source == "fused"
        jlo = ({name: (jnp.asarray(a), jnp.asarray(b))}, jnp.asarray(ids),
               scale, fused)
        tlo = ({name: (torch.from_numpy(a), torch.from_numpy(b))},
               torch.from_numpy(ids), scale, fused)
        jp, tp = {}, types.SimpleNamespace()
    want = np.asarray(jops.apply_lora(
        jcfg, jp, jlo, name, jnp.asarray(x), jnp.asarray(y)
    ))
    got = tops.apply_lora(
        tcfg, tp, tlo, name, torch.from_numpy(x), torch.from_numpy(y)
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not np.allclose(want, y)  # the delta was not zero
    if source != "per_layer":
        np.testing.assert_array_equal(got[1].numpy(), y[1])  # id 0
        # a target the pool does not hold is left untouched
        other = tops.apply_lora(
            tcfg, tp, tlo, "attn_ow", torch.from_numpy(x[..., :32]),
            torch.from_numpy(y[..., :32]),
        )
        np.testing.assert_array_equal(other.numpy(), y[..., :32])


# ---------------------------------------------------------------------------
# the decode functions with an adapter pool
# ---------------------------------------------------------------------------
def _pools_with(params, jcfg, model, adapters):
    """Both packages' adapter pools with ``adapters`` in rows 1.."""
    jpool = jdecode.init_adapter_pool(jcfg, len(adapters), RANK)
    tpool = tdecode.init_adapter_pool(model.config, len(adapters), RANK,
                                      device="cpu")
    for row, ada in enumerate(adapters, start=1):
        for t, (a, b) in jlora.adapter_layer_stacks(ada).items():
            ja, jb = jpool[t]
            jpool[t] = (ja.at[:, row].set(a), jb.at[:, row].set(b))
        for t, (a, b) in adapter_layer_stacks(adapters_from_jax(ada)).items():
            tpool[t][0][:, row] = a
            tpool[t][1][:, row] = b
    return jpool, tpool


def test_prefill_and_suffix_with_adapters_match_jax(models):
    jcfg, _, params, model = models
    jpool, tpool = _pools_with(params, jcfg, model,
                               [_synth_adapter(params, 1)])
    tokens = np.zeros((2, 32), np.int32)
    tokens[0, :11] = _prompt(11)
    tokens[1, :20] = _prompt(20, 2)
    ids = np.asarray([1, 0], np.int32)
    lj, kj, vj = jdecode.gpt2_prefill(
        jcfg, params, jnp.asarray(tokens), adapters=jpool,
        adapter_ids=jnp.asarray(ids), lora_scale=1.0,
    )
    lt, kt, vt = tdecode.gpt2_prefill(
        model, torch.from_numpy(tokens), adapters=tpool,
        adapter_ids=torch.from_numpy(ids), lora_scale=1.0,
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **LOGIT_TOL)
    # id 0 is the adapter-free prefill, bit for bit
    l0, _, _ = tdecode.gpt2_prefill(model, torch.from_numpy(tokens[1:]))
    assert torch.equal(lt[1:], l0)
    assert not torch.allclose(lt[0], tdecode.gpt2_prefill(
        model, torch.from_numpy(tokens[:1]))[0][0])

    # the suffix path over a pool the cold prefill wrote
    bs = 8
    tables = np.asarray([[1, 2, 3, 4, 5, 6]], np.int32)
    jkv = jdecode.init_kv_pool(jcfg, 8, bs)
    tkv = tdecode.init_kv_pool(model.config, 8, bs, device="cpu")
    block_ids = np.repeat(tables[0], bs)[:32].astype(np.int32)
    offsets = (np.arange(32) % bs).astype(np.int32)
    jkv = jdecode.write_prefill_to_pool(
        jkv, kj[:, :1], vj[:, :1], jnp.asarray(block_ids),
        jnp.asarray(offsets),
    )
    tdecode.write_prefill_to_pool(
        tkv, kt[:, :1], vt[:, :1], torch.from_numpy(block_ids),
        torch.from_numpy(offsets),
    )
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :5] = _prompt(5, 9)
    start = np.asarray([8], np.int32)
    one = np.asarray([1], np.int32)
    lj, _ = jdecode.gpt2_prefill_suffix(
        jcfg, params, jnp.asarray(suffix), jnp.asarray(start), jkv,
        jnp.asarray(tables), adapters=jpool, adapter_ids=jnp.asarray(one),
    )
    lt, _ = tdecode.gpt2_prefill_suffix(
        model, torch.from_numpy(suffix), torch.from_numpy(start), tkv,
        torch.from_numpy(tables), adapters=tpool,
        adapter_ids=torch.from_numpy(one),
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_decode_steps_with_mixed_adapters_match_jax(models, fused):
    """Six paged decode steps with slots on adapter 1, adapter 2 and the
    base model (and one dead slot): logits agree with the JAX package's
    at every step; ``fused`` takes the SGMV path in both packages."""
    jcfg, _, params, model = models
    jpool, tpool = _pools_with(
        params, jcfg, model,
        [_synth_adapter(params, 1), _synth_adapter(params, 2)],
    )
    bs, slots = 8, 4
    tables = np.zeros((slots, 6), np.int32)
    tables[0] = [1, 2, 3, 4, 5, 6]
    tables[1] = [7, 8, 9, 10, 11, 12]
    tables[3] = [13, 14, 15, 16, 17, 18]
    ids = np.asarray([1, 2, 0, 0], np.int32)
    jkv = jdecode.init_kv_pool(jcfg, 18, bs)
    tkv = tdecode.init_kv_pool(model.config, 18, bs, device="cpu")
    toks = np.asarray(_prompt(4, 3), np.int32)
    pos = np.asarray([0, 0, 0, 0], np.int32)
    live = tables[:, 0] != 0
    step = jax.jit(lambda p, t, po, kv, bt, ap, ai: jdecode.gpt2_decode_step_paged(
        jcfg, p, t, po, kv, bt, adapters=ap, adapter_ids=ai, lora_scale=1.0,
        fused=fused,
    ))
    for _ in range(6):
        lj, jkv = step(params, jnp.asarray(toks), jnp.asarray(pos), jkv,
                       jnp.asarray(tables), jpool, jnp.asarray(ids))
        lt, _ = tdecode.gpt2_decode_step_paged(
            model, torch.from_numpy(toks), torch.from_numpy(pos), tkv,
            torch.from_numpy(tables), adapters=tpool,
            adapter_ids=torch.from_numpy(ids), lora_scale=1.0, fused=fused,
        )
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        nxt = np.asarray(jnp.argmax(lj[:, :VOCAB], axis=-1)).astype(np.int32)
        toks = np.where(live, nxt, 0).astype(np.int32)
        pos = np.where(live, pos + 1, 0).astype(np.int32)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------
_BLOCK = {"max_batch_slots": 4, "max_seq_len": 48, "prefill_len": 16,
          "kv_block_size": 8, "sampling": {"greedy": True}}


def _port_engine(model, inference=None, adapters=None, **kw):
    ad = {"enabled": True, "rank": RANK, "pool_slots": 4}
    ad.update(adapters or {})
    return deepspeed_tpu_torch.init_inference(
        model=model, device="cpu",
        config={"inference": dict(_BLOCK, **(inference or {})),
                "adapters": ad},
        **kw,
    )


@pytest.mark.parametrize("fused", [False, True])
def test_engine_mixed_adapter_batch_matches_jax_engine(models, fused):
    """One batch mixing adapters a, b and the base model (the port of
    test_adapters.py:370): identical greedy tokens from both engines, with
    fused decode off and on."""
    _, jmodel, params, model = models
    ada, adb = _synth_adapter(params, 1), _synth_adapter(params, 2)
    ej = deepspeed_tpu.init_inference(
        model=jmodel, model_parameters=params,
        config={"inference": dict(_BLOCK, fused_decode=fused),
                "adapters": {"enabled": True, "rank": RANK,
                             "pool_slots": 4}},
    )
    et = _port_engine(model, inference={"fused_decode": fused})
    try:
        assert et.fused_decode == fused and et.multi_lora
        for e, conv in ((ej, lambda t: t), (et, adapters_from_jax)):
            e.load_adapter("a", adapter_state=conv(ada))
            e.load_adapter("b", adapter_state=conv(adb))
        outs = []
        for e in (ej, et):
            reqs = [
                e.submit(_prompt(9, 5), max_new_tokens=8, adapter="a"),
                e.submit(_prompt(6, 7), max_new_tokens=8, adapter="b"),
                e.submit(_prompt(7, 9), max_new_tokens=8),
                e.submit(_prompt(5, 3), max_new_tokens=6, adapter="a"),
            ]
            e.scheduler.run_until_idle()
            outs.append([r.tokens for r in reqs])
        assert outs[1] == outs[0]
        assert outs[1][0] != et.generate([_prompt(9, 5)], max_new_tokens=8)[0]
        assert et.load_snapshot()["adapter_requests"] == {"a": 2, "b": 1}
        assert et.metrics.counter("adapters/requests").value == 3
        assert et.metrics.counter("adapters/requests/a").value == 2
        assert et.metrics.gauge("adapters/pool_occupancy").value == 2
        assert et.metrics.gauge("adapters/pool_slots").value == 4
        # every slot released its pin and reset to the identity row
        assert not et._slot_adapters.any() and not et._slot_adapter_names
        assert et.adapter_registry.active_count("a") == 0
    finally:
        ej.close()
        et.close()


@pytest.mark.parametrize("fused", [False, True])
def test_id0_decode_bitwise_matches_adapter_free_engine(models, fused):
    _, _, _, model = models
    prompt = _prompt(9, seed=5)
    plain = deepspeed_tpu_torch.init_inference(
        model=model, device="cpu",
        config={"inference": dict(_BLOCK, fused_decode=fused)},
    )
    eng = _port_engine(model, inference={"fused_decode": fused})
    try:
        base = plain.generate([prompt], max_new_tokens=10)[0]
        assert eng.generate([prompt], max_new_tokens=10)[0] == base
        assert "adapters/requests" not in plain.metrics.snapshot()
        assert plain.adapter_snapshot() == {}
    finally:
        plain.close()
        eng.close()


def test_mixed_batch_equals_solo_runs(models):
    """Slots on different adapters (and the base) decode exactly as each
    does alone in the batch. Prefix cache off: solo reruns of a prompt
    would otherwise hit its salted pages and prefill only the suffix."""
    _, _, params, model = models
    eng = _port_engine(model, inference={
        "fused_decode": True, "prefix_cache": {"enabled": False},
    })
    try:
        eng.load_adapter("a", adapter_state=adapters_from_jax(
            _synth_adapter(params, 1)))
        eng.load_adapter("b", adapter_state=adapters_from_jax(
            _synth_adapter(params, 2)))
        prompt = _prompt(9, seed=5)
        solo = {n: eng.generate([prompt], max_new_tokens=8, adapter=n)[0]
                for n in ("a", "b", None)}
        reqs = {n: eng.submit(prompt, max_new_tokens=8, adapter=n)
                for n in ("a", "b", None)}
        eng.scheduler.run_until_idle()
        assert {n: r.tokens for n, r in reqs.items()} == solo
        assert solo["a"] != solo["b"] and solo["a"] != solo[None]
        assert eng.metrics.counter("infer/prefix_hits").value == 0
    finally:
        eng.close()


def test_prefix_cache_salted_by_adapter(models):
    _, _, params, model = models
    ada = adapters_from_jax(_synth_adapter(params, 1))
    eng = _port_engine(model)
    eng.load_adapter("a", adapter_state=ada)
    eng.load_adapter("b", adapter_state=adapters_from_jax(
        _synth_adapter(params, 2)))
    hits = eng.metrics.counter("infer/prefix_hits")
    misses = eng.metrics.counter("infer/prefix_misses")
    template = _prompt(8, seed=11)  # exactly one page
    p1 = template + _prompt(3, seed=12)
    p2 = template + _prompt(4, seed=13)
    eng.generate([p1], max_new_tokens=4, adapter="a")
    assert (hits.value, misses.value) == (0, 1)
    warm = eng.generate([p2], max_new_tokens=4, adapter="a")[0]
    assert (hits.value, misses.value) == (1, 1)  # same adapter: HIT
    eng.generate([p2], max_new_tokens=4, adapter="b")
    assert misses.value == 2  # other adapter: MISS despite same tokens
    eng.generate([p2], max_new_tokens=4)
    assert misses.value == 3  # base model: MISS too
    # the warm hit served the adapter's own pages: equal to a fresh cold run
    eng2 = _port_engine(model)
    eng2.load_adapter("a", adapter_state=ada)
    assert eng2.generate([p2], max_new_tokens=4, adapter="a")[0] == warm
    eng.close()
    eng2.close()


def test_adapter_reload_invalidates_its_old_prefix_pages(models):
    _, _, params, model = models
    eng = _port_engine(model)
    eng.load_adapter("a", adapter_state=adapters_from_jax(
        _synth_adapter(params, 1)))
    misses = eng.metrics.counter("infer/prefix_misses")
    template = _prompt(8, seed=11)
    eng.generate([template + _prompt(3, seed=12)], max_new_tokens=4,
                 adapter="a")
    row = eng.adapter_registry.index_of("a")
    assert eng.load_adapter("a", adapter_state=adapters_from_jax(
        _synth_adapter(params, 4))) == row  # a reload keeps its row
    eng.generate([template + _prompt(4, seed=13)], max_new_tokens=4,
                 adapter="a")
    assert misses.value == 2  # reload => no stale hit
    eng.close()


def test_pool_eviction_lru_and_snapshot_counters(models):
    _, _, params, model = models
    eng = _port_engine(model, adapters={"pool_slots": 2})
    for i, n in enumerate("ab", start=1):
        eng.load_adapter(n, adapter_state=adapters_from_jax(
            _synth_adapter(params, i)))
    prompt = _prompt(9, seed=5)
    eng.generate([prompt], max_new_tokens=4, adapter="a")  # a now MRU
    b_row = eng.adapter_registry.index_of("b")
    assert eng.load_adapter("c", adapter_state=adapters_from_jax(
        _synth_adapter(params, 3))) == b_row
    snap = eng.load_snapshot()
    assert snap["adapters_loaded"] == ["a", "c"]  # b was LRU: evicted
    assert snap["adapter_pool_used"] == 2
    assert snap["adapter_evictions"] == 1
    assert snap["adapter_requests"]["a"] == 1
    assert eng.metrics.counter("adapters/evictions").value == 1
    assert eng.metrics.counter("adapters/loads").value == 3
    with pytest.raises(AdapterUnavailable, match="not loaded"):
        eng.submit(prompt, adapter="b")
    # the identity row stays zero through every load
    for a, b in eng._adapter_pool.values():
        assert not a[:, 0].any() and not b[:, 0].any()
    eng.close()


def test_unknown_adapter_rejected_at_submit(models):
    _, _, _, model = models
    eng = _port_engine(model)
    with pytest.raises(ValueError, match="not loaded"):
        eng.submit(_prompt(), adapter="ghost")
    plain = deepspeed_tpu_torch.init_inference(
        model=model, device="cpu", config={"inference": _BLOCK},
    )
    with pytest.raises(DeepSpeedConfigError, match="adapter"):
        plain.submit(_prompt(), adapter="any")
    with pytest.raises(DeepSpeedConfigError, match="adapter pool"):
        plain.load_adapter("a", adapter_state={})
    plain.close()
    eng.close()


def test_evicted_adapter_between_submit_and_join_fail_finishes(models):
    _, _, params, model = models
    eng = _port_engine(model, adapters={"pool_slots": 2})
    eng.load_adapter("a", adapter_state=adapters_from_jax(
        _synth_adapter(params, 1)))
    req = eng.submit(_prompt(9, seed=5), max_new_tokens=4, adapter="a")
    eng.unload_adapter("a")
    eng.scheduler.run_until_idle()
    assert req.done and req.finish_reason == "error"
    assert not eng._slot_adapters.any()
    eng.close()


def test_load_adapter_checks_shapes_and_live_unload(models):
    _, _, params, model = models
    eng = _port_engine(model, adapters={"pool_slots": 1})
    try:
        with pytest.raises(ValueError, match="do not fit"):
            eng.load_adapter("r3", adapter_state=adapters_from_jax(
                _synth_adapter(params, 1, rank=3)))
        eng.load_adapter("a", adapter_state=adapters_from_jax(
            _synth_adapter(params, 1)))
        req = eng.submit(_prompt(9, seed=5), max_new_tokens=6, adapter="a")
        eng.scheduler.step()  # a is pinned by a live slot
        assert eng._slot_adapters.tolist().count(1) == 1
        with pytest.raises(RuntimeError, match="live"):
            eng.unload_adapter("a")
        with pytest.raises(AdapterPoolFull):
            eng.load_adapter("b", adapter_state=adapters_from_jax(
                _synth_adapter(params, 2)))
        eng.scheduler.run_until_idle()
        assert req.finish_reason == "max_new_tokens"
        assert eng.unload_adapter("a") == 1
    finally:
        eng.close()


def test_serving_refuses_lora_tensors_in_params(models):
    """Pool mode + *_lora_* tensors in the parameters would double-apply
    adapters; a model whose CONFIG a fine-tune armed, served with base
    parameters, is fine."""
    jcfg, _, params, _ = models
    armed = _port_model(jcfg, params, lora_rank=RANK)
    with pytest.raises(DeepSpeedConfigError, match="BASE parameters"):
        _port_engine(armed)
    base, _ = split_lora_params(armed.state_dict())
    eng = _port_engine(armed, model_parameters=base)
    try:
        assert eng.generate([_prompt(6)], max_new_tokens=2)[0]
        assert eng.model.config.lora_rank == 0
    finally:
        eng.close()


def test_what_is_not_yet_ported_raises(models):
    _, _, params, model = models
    eng = _port_engine(model)
    try:
        with pytest.raises(RuntimeError, match="no loadable adapter"):
            eng.load_adapter("a", load_dir="/nonexistent")
    finally:
        eng.close()
    # the host tier is ported: with adapters on, the contiguous cache has
    # something to spill (adapter rows), and the engine builds
    tiered = _port_engine(model, inference={
        "kv_block_size": 0, "host_tier": {"enabled": True}})
    try:
        assert tiered.host_tier is not None and not tiered.paged
    finally:
        tiered.close()
    with pytest.raises(DeepSpeedConfigError, match="SGMV_MAX_RANK"):
        _port_engine(model, inference={"fused_decode": True},
                     adapters={"rank": tda.SGMV_MAX_RANK + 1})


def test_concurrent_row_writes_land_between_decode_steps(models,
                                                         monkeypatch):
    """A caller thread hot-reloads adapter a, which live requests decode
    against, alternating two sets of weights, while the scheduler decodes
    a batch on a, b and the base. The engine lock serializes each row
    write with prefill and decode: no step sees a's row change between
    its first layer and its last, the other rows are never touched (b and
    the base give their solo-run tokens), and every pin is released."""
    import sys
    import threading

    from deepspeed_tpu_torch.inference import engine as tengine

    _, _, params, model = models
    eng = _port_engine(model, adapters={"pool_slots": 2}, inference={
        "fused_decode": True, "prefix_cache": {"enabled": False},
    })
    torn = []

    def guarded(fn):
        def run(*args, **kwargs):
            row = eng.adapter_registry.index_of("a")
            before = [t[:, row].clone() for ab in eng._adapter_pool.values()
                      for t in ab]
            out = fn(*args, **kwargs)
            after = [t[:, row] for ab in eng._adapter_pool.values()
                     for t in ab]
            torn.extend(not torch.equal(x, y) for x, y in zip(before, after))
            return out
        return run

    for name in ("gpt2_prefill", "gpt2_decode_step_paged"):
        monkeypatch.setattr(tengine, name, guarded(getattr(tengine, name)))
    try:
        for i, n in enumerate("ab", start=1):
            eng.load_adapter(n, adapter_state=adapters_from_jax(
                _synth_adapter(params, i)))
        prompts = [_prompt(9, 5), _prompt(6, 7), _prompt(7, 9), _prompt(5, 3)]
        names = ["a", "b", None, "a"]
        solo = [eng.generate([p], max_new_tokens=8, adapter=n)[0]
                for p, n in zip(prompts, names)]
        fresh = [adapters_from_jax(_synth_adapter(params, s))
                 for s in (20, 21)]
        stop = threading.Event()
        reloads = [0]

        def reload_a():
            while not stop.is_set():
                eng.load_adapter("a", adapter_state=fresh[reloads[0] % 2])
                reloads[0] += 1

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        loader = threading.Thread(target=reload_a, daemon=True)
        try:
            loader.start()
            for _ in range(3):
                reqs = [eng.submit(p, max_new_tokens=8, adapter=n)
                        for p, n in zip(prompts, names)]
                eng.scheduler.run_until_idle()
                outs = [r.result(10) for r in reqs]
                assert outs[1] == solo[1] and outs[2] == solo[2]
        finally:
            stop.set()
            loader.join(timeout=30)
            sys.setswitchinterval(interval)
        assert not loader.is_alive()
        assert reloads[0] >= 1
        assert torn and not any(torn)
        assert eng.adapter_registry.loaded == ["a", "b"]
        assert all(eng.adapter_registry.active_count(n) == 0 for n in "ab")
        assert eng.metrics.counter("adapters/loads").value == 2 + reloads[0]
        assert not eng._slot_adapters.any()
    finally:
        eng.close()
