"""Port parity for the contiguous KV cache (``kv_block_size: 0``):
``KVCache``, ``init_kv_cache``, ``write_prefill_to_cache``,
``gpt2_decode_step`` and ``transformer_block_decode`` of
deepspeed_tpu_torch (CPU) against deepspeed_tpu's on the same weights,
carried over with ``params_from_jax``, and the engine over that cache.

Tolerances (float32): a block's output and the step logits atol = rtol
= 1e-4, the serving slice's bound (test_torch_gpt2_serving.py: two
summation orders over a 2-layer stack); a cache row written from the
same k/v is EXACT. Engine runs must give IDENTICAL greedy tokens: the
JAX contiguous engine's, the port's paged engine's, and the JAX model's
full-forward argmax rollout.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import decode as jdecode
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu_torch import (
    GPT2Config,
    GPT2LMHeadModel,
    adapters_from_jax,
    params_from_jax,
)
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from deepspeed_tpu_torch.inference import decode as tdecode
from deepspeed_tpu_torch.ops import transformer as tops
from torch_test_env import jax_compile_cache  # noqa: F401

jops = importlib.import_module("deepspeed_tpu.ops.transformer")

VOCAB = 97
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
_BLOCK = {"max_batch_slots": 4, "max_seq_len": 48, "prefill_len": 16,
          "sampling": {"greedy": True}}


def _jax_model(seed=0):
    """test_inference.py's small model: 2 x 32, vocab 97."""
    cfg = JGPT2Config(
        vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        dropout=0.0, use_flash=False,
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
    return cfg, model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(jcfg, params):
    cfg = GPT2Config(
        vocab_size=jcfg.vocab_size, n_positions=jcfg.n_positions,
        n_embd=jcfg.n_embd, n_layer=jcfg.n_layer, n_head=jcfg.n_head,
        layer_norm_eps=jcfg.layer_norm_eps,
    )
    model = GPT2LMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.fixture(scope="module")
def models():
    jcfg, jmodel, params = _jax_model()
    return jcfg, jmodel, params, _port_model(jcfg, params)


def _prompt(n=8, seed=1):
    return [int(t) for t in np.random.default_rng(seed).integers(0, VOCAB, n)]


def _engine(model, inference=None, **kw):
    return deepspeed_tpu_torch.init_inference(
        model=model, device="cpu",
        config={"inference": dict(_BLOCK, **(inference or {}))}, **kw)


def _jax_engine(jmodel, params, inference=None, **kw):
    return deepspeed_tpu.init_inference(
        model=jmodel, model_parameters=params,
        config={"inference": dict(_BLOCK, **(inference or {}))}, **kw)


def _reference_rollout(jmodel, params, prompt, out):
    """The JAX model's full-forward greedy choice after every prefix of
    ``prompt + out`` (one teacher-forced forward): ``out`` is the greedy
    rollout exactly when this returns ``out``."""
    seq = jnp.asarray([list(prompt) + list(out[:-1])], jnp.int32)
    logits = jmodel.apply({"params": params}, seq, train=False)
    return [int(t) for t in
            jnp.argmax(logits[0, len(prompt) - 1:, :VOCAB], axis=-1)]


# ---------------------------------------------------------------------------
# the cache and its functions
# ---------------------------------------------------------------------------
def test_kv_cache_layout(models):
    """test_inference.py's layout test: [layers, slots, heads, max_len,
    hd], as the JAX package's init_kv_cache (the port has no mesh, so no
    partition specs)."""
    jcfg, _, _, model = models
    cache = tdecode.init_kv_cache(model.config, num_slots=4, max_len=32,
                                  device="cpu")
    jcache = jdecode.init_kv_cache(jcfg, num_slots=4, max_len=32)
    assert cache.k.shape == (2, 4, 4, 32, 8) == jcache.k.shape
    assert cache.v.shape == cache.k.shape
    assert cache.num_slots == 4 and cache.max_len == 32
    assert cache.k.dtype == torch.float32 and not cache.k.any()
    bf = tdecode.init_kv_cache(model.config, 2, 16, torch.bfloat16, "cpu")
    assert bf.k.dtype == torch.bfloat16 and bf.max_len == 16


def test_write_prefill_to_cache_matches_jax(models):
    """The same k/v land in the same rows of the same slot, exactly."""
    jcfg, _, _, model = models
    rng = np.random.default_rng(5)
    ks = rng.standard_normal((2, 1, 4, 16, 8)).astype(np.float32)
    vs = rng.standard_normal((2, 1, 4, 16, 8)).astype(np.float32)
    jcache = jdecode.write_prefill_to_cache(
        jdecode.init_kv_cache(jcfg, 3, 32), 1, jnp.asarray(ks),
        jnp.asarray(vs))
    cache = tdecode.init_kv_cache(model.config, 3, 32, device="cpu")
    got = tdecode.write_prefill_to_cache(
        cache, 1, torch.from_numpy(ks), torch.from_numpy(vs))
    assert got is cache  # written in place
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))


def _prefilled(jcfg, params, model, slots=3, max_len=48):
    """Both packages' contiguous caches after one prefill per slot (JAX
    k/v written to both, so the decode comparison starts from the same
    rows)."""
    jcache = jdecode.init_kv_cache(jcfg, slots, max_len)
    tcache = tdecode.init_kv_cache(model.config, slots, max_len,
                                   device="cpu")
    lengths = []
    for slot, n in enumerate((9, 5, 13)[:slots]):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = _prompt(n, 30 + slot)
        _, ks, vs = jdecode.gpt2_prefill(jcfg, params, jnp.asarray(toks))
        jcache = jdecode.write_prefill_to_cache(jcache, slot, ks, vs)
        tdecode.write_prefill_to_cache(
            tcache, slot, torch.from_numpy(np.array(ks)),
            torch.from_numpy(np.array(vs)))
        lengths.append(n)
    return jcache, tcache, np.asarray(lengths, np.int32)


def test_eight_decode_steps_match_jax(models):
    """gpt2_decode_step over the contiguous cache: eight steps of logits
    within LOGIT_TOL of JAX's, greedy tokens fed back, and the rows each
    step wrote within the same bound."""
    jcfg, _, params, model = models
    jcache, tcache, lengths = _prefilled(jcfg, params, model)
    tokens = np.asarray([3, 14, 15], np.int32)
    jstep = jax.jit(lambda p, t, pos, c: jdecode.gpt2_decode_step(
        jcfg, p, t, pos, c))
    for _ in range(8):
        jl, jcache = jstep(params, jnp.asarray(tokens), jnp.asarray(lengths),
                           jcache)
        tl, got = tdecode.gpt2_decode_step(
            model, torch.from_numpy(tokens), torch.from_numpy(lengths),
            tcache)
        assert got is tcache
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tokens = np.argmax(np.asarray(jl)[:, :VOCAB], -1).astype(np.int32)
        lengths = lengths + 1
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               **LOGIT_TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               **LOGIT_TOL)


def test_transformer_block_decode_matches_jax(models):
    """One block's decode step against the JAX block on the same cache
    rows and hidden states."""
    jcfg, _, params, model = models
    rng = np.random.default_rng(11)
    b, heads, max_len, hd = 3, 4, 24, 8
    x = rng.standard_normal((b, 1, 32)).astype(np.float32)
    kc = rng.standard_normal((b, heads, max_len, hd)).astype(np.float32)
    vc = rng.standard_normal((b, heads, max_len, hd)).astype(np.float32)
    pos = np.asarray([0, 7, 23], np.int32)
    layer = jax.tree_util.tree_map(
        lambda a: a[0], params["transformer"]["h"])
    jx, jk, jv = jops.transformer_block_decode(
        jcfg.layer_config(), layer, jnp.asarray(x), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(pos))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    with torch.no_grad():
        tx = tops.transformer_block_decode(
            model.layer_config, model.h[0], torch.from_numpy(x), tk, tv,
            torch.from_numpy(pos))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **LOGIT_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **LOGIT_TOL)


def test_decode_past_the_cache_writes_nothing_like_jax(models):
    """A position at or past max_len (the speculative draft's proposals
    near the cap): the write is dropped and the position embedding reads
    the table's last row, as JAX's scatter and gather do; the logits
    agree."""
    jcfg, _, params, model = models
    jcache, tcache, _ = _prefilled(jcfg, params, model, max_len=16)
    before = tcache.k.clone()
    tokens = np.asarray([3, 14, 15], np.int32)
    positions = np.asarray([16, 40, 70], np.int32)  # 70 > n_positions
    jl, jcache = jax.jit(lambda p, t, pos, c: jdecode.gpt2_decode_step(
        jcfg, p, t, pos, c))(params, jnp.asarray(tokens),
                             jnp.asarray(positions), jcache)
    tl, _ = tdecode.gpt2_decode_step(
        model, torch.from_numpy(tokens), torch.from_numpy(positions),
        tcache)
    assert torch.equal(tcache.k, before)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the engine over the contiguous cache
# ---------------------------------------------------------------------------
def test_engine_greedy_tokens_match_jax_paged_and_the_rollout(models):
    """Concurrent mixed-length requests on the contiguous cache: the JAX
    contiguous engine's tokens, the port's paged engine's, and the full
    forward's argmax rollout."""
    _, jmodel, params, model = models
    et = _engine(model)
    ej = _jax_engine(jmodel, params)
    paged = _engine(model, {"kv_block_size": 8, "prefill_len": 16})
    try:
        assert not et.paged and et.block_pool is None
        prompts = [_prompt(9, 1), _prompt(5, 2), _prompt(13, 3)]
        out = et.generate(prompts, max_new_tokens=10)
        assert out == ej.generate(prompts, max_new_tokens=10)
        assert out == paged.generate(prompts, max_new_tokens=10)
        for prompt, got in zip(prompts, out):
            assert len(got) == 10
            assert got == _reference_rollout(jmodel, params, prompt, got)
        assert et.metrics.gauge("infer/kv_cache_bytes").value == \
            ej.metrics.gauge("infer/kv_cache_bytes").value == \
            2 * 2 * 4 * 4 * 48 * 8 * 4
        assert et.metrics.gauge("infer/fused_decode").value == 0
        assert et.kv_snapshot() == ej.kv_snapshot() == {}
    finally:
        for e in (et, ej, paged):
            e.close()


def test_mid_flight_join_and_eos_slot_reuse(models):
    """A join while another request decodes leaves both exact; EOS
    frees the slot, whose stale rows do not touch the next request."""
    _, jmodel, params, model = models
    et = _engine(model, {"max_batch_slots": 2})
    try:
        p1, p2 = _prompt(8, 3), _prompt(7, 4)
        r1 = et.submit(p1, max_new_tokens=12)
        for _ in range(4):
            et.scheduler.step()
        r2 = et.submit(p2, max_new_tokens=8)
        et.scheduler.run_until_idle()
        for p, r, n in ((p1, r1, 12), (p2, r2, 8)):
            got = r.result(0)
            assert len(got) == n
            assert got == _reference_rollout(jmodel, params, p, got)

        prompt = _prompt(8)
        ref = et.generate([prompt], max_new_tokens=8)[0]
        assert ref == _reference_rollout(jmodel, params, prompt, ref)
        eos = ref[3]
        r = et.submit(prompt, max_new_tokens=8, eos_token_id=eos)
        et.scheduler.run_until_idle()
        assert r.finish_reason == "eos"
        assert r.result(0) == ref[: ref.index(eos) + 1]
        p3 = _prompt(6, 9)
        got = et.generate([p3], max_new_tokens=6)[0]
        assert len(got) == 6
        assert got == _reference_rollout(jmodel, params, p3, got)
    finally:
        et.close()


def test_length_cap_finishes_request(models):
    _, _, _, model = models
    et = _engine(model, {"max_seq_len": 12, "prefill_len": 8})
    try:
        r = et.submit(_prompt(8), max_new_tokens=100)
        et.scheduler.run_until_idle()
        assert r.finish_reason == "length"
        assert len(r.result(0)) == 12 - 8
    finally:
        et.close()


def test_multi_lora_on_the_contiguous_cache_matches_jax(models):
    """The adapters block over the contiguous cache: a batch mixing two
    adapters and the base model gives the JAX engine's tokens."""
    from deepspeed_tpu.adapters import init_lora_params

    _, jmodel, params, model = models

    def synth(seed):
        ada = init_lora_params(params, 2, rng=jax.random.PRNGKey(seed))
        return jax.tree_util.tree_map(
            lambda a: np.asarray(jax.random.normal(
                jax.random.fold_in(jax.random.PRNGKey(seed), a.size),
                a.shape) * 0.2, np.float32), ada)

    adapters = {"enabled": True, "rank": 2, "pool_slots": 2}
    et = deepspeed_tpu_torch.init_inference(
        model=model, device="cpu",
        config={"inference": _BLOCK, "adapters": adapters})
    ej = deepspeed_tpu.init_inference(
        model=jmodel, model_parameters=params,
        config={"inference": _BLOCK, "adapters": adapters})
    try:
        outs = []
        for e, conv in ((et, adapters_from_jax), (ej, lambda a: a)):
            e.load_adapter("a", adapter_state=conv(synth(1)))
            e.load_adapter("b", adapter_state=conv(synth(2)))
            rs = [e.submit(_prompt(7, 20 + i), max_new_tokens=8,
                           adapter=name)
                  for i, name in enumerate(("a", None, "b"))]
            e.scheduler.run_until_idle()
            outs.append([r.result(0) for r in rs])
        assert outs[0] == outs[1]
        assert outs[0][1] == _reference_rollout(
            jmodel, params, _prompt(7, 21), outs[0][1])
    finally:
        et.close()
        ej.close()


def test_restarted_decode_matches_clean_engine(models):
    """A decode crash on the contiguous cache restarts from a fresh cache
    and serves on exactly."""
    _, jmodel, params, model = models
    eng = deepspeed_tpu_torch.init_inference(
        model=model, device="cpu", config={
            "inference": dict(_BLOCK, driver_restart_budget=1),
            "resilience": {"fault_injection": {"enabled": True, "faults": [
                {"site": "decode.step", "times": 1}]}}})
    try:
        crash = eng.submit(_prompt(6), max_new_tokens=4)
        eng.scheduler.run_until_idle()
        assert crash.finish_reason == "error"
        assert eng.metrics.snapshot()["infer/driver_restarts"] == 1
        prompt = _prompt(8, 3)
        got = eng.generate([prompt], max_new_tokens=8)[0]
        assert len(got) == 8
        assert got == _reference_rollout(jmodel, params, prompt, got)
    finally:
        eng.close()


@pytest.mark.parametrize("inference", [
    {"fused_decode": True},
    {"prefix_cache": {"enabled": True}},
    {"kv_pool_blocks": 8},
])
def test_contiguous_cache_refuses_paged_options_like_jax(models, inference):
    """The paged-only options on the contiguous cache: refused with the
    JAX package's messages."""
    _, jmodel, params, model = models
    with pytest.raises(DeepSpeedConfigError) as got:
        _engine(model, inference)
    with pytest.raises(Exception) as want:
        _jax_engine(jmodel, params, inference)
    assert type(want.value).__name__ == "DeepSpeedConfigError"
    assert str(got.value) == str(want.value)
