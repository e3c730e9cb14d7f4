"""Port parity for the serving slice: GPT-2 prefill, paged decode and the
engine, deepspeed_tpu_torch (CPU, the kernels' plain versions) against
deepspeed_tpu (CPU; its Pallas decode kernel in interpret mode).

The JAX model is initialised from a seed and its parameters carried over
with ``params_from_jax``. Tolerances (float32): logits atol = rtol =
1e-4, the JAX package's own bound between its fused and unfused decode
logits (test_paged_kv.py) — two summation orders over a 2-layer stack.
Engine runs must give IDENTICAL greedy tokens.
"""

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
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel, params_from_jax
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from deepspeed_tpu_torch.inference import decode as tdecode
from torch_test_env import jax_compile_cache  # noqa: F401

VOCAB = 97
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_model(seed=0):
    """The JAX package's small serving fixture (test_paged_kv.py)."""
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
    return cfg, model, params


def _port_model(jcfg, params):
    cfg = GPT2Config(
        vocab_size=jcfg.vocab_size, n_positions=jcfg.n_positions,
        n_embd=jcfg.n_embd, n_layer=jcfg.n_layer, n_head=jcfg.n_head,
        layer_norm_eps=jcfg.layer_norm_eps,
    )
    model = GPT2LMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return model


@pytest.fixture(scope="module")
def models():
    jcfg, jmodel, params = _jax_model()
    return jcfg, jmodel, params, _port_model(jcfg, params)


def _prompt(n=8, seed=1):
    return [int(t) for t in np.random.default_rng(seed).integers(0, VOCAB, n)]


# ---------------------------------------------------------------------------
# parameters and the model-level functions
# ---------------------------------------------------------------------------
def test_params_from_jax_round_trips_the_tree(models):
    jcfg, _, params, model = models
    state = model.state_dict()
    tp = jax.device_get(params)["transformer"]
    assert set(state) == set(params_from_jax(jax.device_get(params)))
    np.testing.assert_array_equal(state["wte"].numpy(), tp["wte"])
    assert state["wte"].shape == (GPT2Config(vocab_size=VOCAB).vocab_padded, 32)
    np.testing.assert_array_equal(state["ln_f.weight"].numpy(), tp["ln_f"]["scale"])
    for name, stacked in tp["h"].items():
        assert stacked.shape[0] == jcfg.n_layer
        for i in range(jcfg.n_layer):
            leaf = state[f"h.{i}.{name}"].numpy()
            want = stacked[i].T if stacked[i].ndim == 2 else stacked[i]
            assert leaf.shape == want.shape, name
            np.testing.assert_array_equal(leaf, want)


@pytest.mark.parametrize("prefill_len", [32, 256])
def test_prefill_logits_and_kv_match_jax(models, prefill_len):
    """prefill_len 256 routes the port's attention through the flash
    kernel's function (S >= FLASH_MIN_SEQ); 32 through the reference."""
    jcfg, _, params, model = models
    jcfg = JGPT2Config(**{**jcfg.__dict__, "n_positions": 256})
    tcfg = GPT2Config(**{**model.config.__dict__, "n_positions": 256})
    rng = np.random.default_rng(0)
    jparams = jax.device_get(params)
    jparams["transformer"]["wpe"] = rng.normal(
        scale=0.02, size=(256, 32)
    ).astype(np.float32)
    tmodel = GPT2LMHeadModel(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jparams))
    tokens = np.zeros((2, prefill_len), np.int32)
    tokens[0, :11] = _prompt(11)
    tokens[1, :] = rng.integers(0, VOCAB, prefill_len)
    lj, kj, vj = jdecode.gpt2_prefill(jcfg, jparams, jnp.asarray(tokens))
    lt, kt, vt = tdecode.gpt2_prefill(tmodel, torch.from_numpy(tokens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **LOGIT_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **LOGIT_TOL)
    # the model's own forward is the same arithmetic
    np.testing.assert_allclose(
        tmodel(torch.from_numpy(tokens)).numpy(), lt.numpy(), atol=1e-6,
        rtol=1e-6,
    )


def _prefilled_pools(jcfg, params, model, bs=8, slots=3, max_len=48):
    """Two live slots (real pages, prefilled) beside one dead slot (an
    all-NULL block table), in both packages' pools."""
    prefill_len = 32
    tables = np.zeros((slots, max_len // bs), np.int32)
    tables[0] = [1, 2, 3, 4, 5, 6]
    tables[2] = [7, 8, 9, 10, 11, 12]
    jpool = jdecode.init_kv_pool(jcfg, 14, bs)
    tpool = tdecode.init_kv_pool(model.config, 14, bs, device="cpu")
    toks = np.zeros(slots, np.int32)
    pos = np.zeros(slots, np.int32)
    for slot, plen, seed in ((0, 11, 1), (2, 20, 2)):
        prompt = _prompt(plen, seed)
        padded = np.zeros((1, prefill_len), np.int32)
        padded[0, :plen] = prompt
        lj, kj, vj = jdecode.gpt2_prefill(jcfg, params, jnp.asarray(padded))
        _, kt, vt = tdecode.gpt2_prefill(model, torch.from_numpy(padded))
        block_ids = np.zeros(prefill_len, np.int32)
        block_ids[:plen] = [tables[slot][j // bs] for j in range(plen)]
        offsets = np.arange(prefill_len, dtype=np.int32) % bs
        jpool = jdecode.write_prefill_to_pool(
            jpool, kj, vj, jnp.asarray(block_ids), jnp.asarray(offsets)
        )
        tdecode.write_prefill_to_pool(
            tpool, kt, vt, torch.from_numpy(block_ids),
            torch.from_numpy(offsets),
        )
        toks[slot] = int(jnp.argmax(lj[0, plen - 1, :VOCAB]))
        pos[slot] = plen
    return jpool, tpool, tables, toks, pos


@pytest.mark.parametrize("fused", [False, True])
def test_eight_paged_decode_steps_match_jax(models, fused):
    """Eight steps of gpt2_decode_step_paged: the port's logits agree
    with the JAX package's at every step (both fed the JAX greedy
    tokens), the dead slot's included, and the port updated its pool in
    place."""
    jcfg, _, params, model = models
    jpool, tpool, tables, toks, pos = _prefilled_pools(jcfg, params, model)
    step = jax.jit(lambda p, t, po, pl, bt: jdecode.gpt2_decode_step_paged(
        jcfg, p, t, po, pl, bt, fused=fused
    ))
    live = tables[:, 0] != 0
    for _ in range(8):
        lj, jpool = step(
            params, jnp.asarray(toks), jnp.asarray(pos), jpool,
            jnp.asarray(tables),
        )
        lt, same_pool = tdecode.gpt2_decode_step_paged(
            model, torch.from_numpy(toks), torch.from_numpy(pos), tpool,
            torch.from_numpy(tables), fused=fused,
        )
        assert same_pool is tpool
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        nxt = np.asarray(jnp.argmax(lj[:, :VOCAB], axis=-1)).astype(np.int32)
        toks = np.where(live, nxt, 0).astype(np.int32)
        pos = np.where(live, pos + 1, 0).astype(np.int32)
    # every live slot's cached rows agree with the JAX pool's
    for slot in np.flatnonzero(live):
        pages = tables[slot]
        np.testing.assert_allclose(
            tpool.k[:, pages].numpy(), np.asarray(jpool.k[:, pages]),
            **LOGIT_TOL,
        )


def test_prefill_suffix_matches_jax(models):
    jcfg, _, params, model = models
    jpool, tpool, tables, _, _ = _prefilled_pools(jcfg, params, model)
    # slot 2 holds 20 prompt tokens: two full pages are a cached prefix
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :5] = _prompt(5, 9)
    start = np.asarray([16], np.int32)
    lj, jpool = jdecode.gpt2_prefill_suffix(
        jcfg, params, jnp.asarray(suffix), jnp.asarray(start), jpool,
        jnp.asarray(tables[2:3]),
    )
    lt, _ = tdecode.gpt2_prefill_suffix(
        model, torch.from_numpy(suffix), torch.from_numpy(start), tpool,
        torch.from_numpy(tables[2:3]),
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    pages = tables[2]
    np.testing.assert_allclose(
        tpool.v[:, pages].numpy(), np.asarray(jpool.v[:, pages]),
        **LOGIT_TOL,
    )


# ---------------------------------------------------------------------------
# engine level: identical greedy tokens
# ---------------------------------------------------------------------------
_BLOCK = {"max_batch_slots": 4, "max_seq_len": 48, "prefill_len": 32,
          "kv_block_size": 8, "sampling": {"greedy": True}}


def _engines(models, fused=True):
    _, jmodel, params, model = models
    block = dict(_BLOCK, fused_decode=fused)
    ej = deepspeed_tpu.init_inference(
        model=jmodel, model_parameters=params,
        config={"inference": dict(_BLOCK, fused_decode=True)},
    )
    et = deepspeed_tpu_torch.init_inference(
        model=model, config={"inference": block}, device="cpu",
    )
    return ej, et


def test_engine_greedy_tokens_match_jax_engine(models):
    """Concurrent mixed-length requests, a mid-flight join, EOS slot
    reuse and a prefix-cache hit give the JAX engine's greedy tokens, and
    infer/prefix_hits moves the same way on both."""
    ej, et = _engines(models)
    try:
        assert et.fused_decode
        prompts = [_prompt(9, 1), _prompt(5, 2), _prompt(13, 3)]
        assert et.generate(prompts, max_new_tokens=10) == \
            ej.generate(prompts, max_new_tokens=10)

        # mid-flight join
        r1j = ej.submit(_prompt(8, 4), max_new_tokens=12)
        r1t = et.submit(_prompt(8, 4), max_new_tokens=12)
        for _ in range(4):
            ej.scheduler.step()
            et.scheduler.step()
        r2j = ej.submit(_prompt(7, 5), max_new_tokens=8)
        r2t = et.submit(_prompt(7, 5), max_new_tokens=8)
        ej.scheduler.run_until_idle()
        et.scheduler.run_until_idle()
        assert r1t.result(0) == r1j.result(0)
        assert r2t.result(0) == r2j.result(0)

        # EOS slot reuse
        ref = ej.generate([_prompt(8, 6)], max_new_tokens=8)[0]
        eos = ref[3]
        aj = ej.submit(_prompt(8, 6), max_new_tokens=8, eos_token_id=eos)
        at = et.submit(_prompt(8, 6), max_new_tokens=8, eos_token_id=eos)
        ej.scheduler.run_until_idle()
        et.scheduler.run_until_idle()
        assert at.finish_reason == aj.finish_reason == "eos"
        assert at.result(0) == aj.result(0)

        # prefix-cache hit
        hits_j = ej.metrics.counter("infer/prefix_hits").value
        hits_t = et.metrics.counter("infer/prefix_hits").value
        shared = _prompt(16, 7)
        for tail_seed in (8, 9):
            p = shared + _prompt(3, tail_seed)
            assert et.generate([p], max_new_tokens=6) == \
                ej.generate([p], max_new_tokens=6)
        dj = ej.metrics.counter("infer/prefix_hits").value - hits_j
        dt = et.metrics.counter("infer/prefix_hits").value - hits_t
        assert dt == dj >= 1
        assert et.metrics.gauge("infer/fused_decode").value == 1
    finally:
        ej.close()
        et.close()


def test_port_engine_fused_and_unfused_agree(models):
    _, _, _, model = models
    engines = [
        deepspeed_tpu_torch.init_inference(
            model=model, device="cpu",
            config={"inference": dict(_BLOCK, fused_decode=fused)},
        )
        for fused in (False, True)
    ]
    try:
        prompts = [_prompt(9, 11), _prompt(30, 12), _prompt(3, 13)]
        outs = [e.generate(prompts, max_new_tokens=12) for e in engines]
        assert outs[0] == outs[1]
        snap = engines[1].load_snapshot()
        assert snap["kv_blocks_used"] == 0 and snap["active_slots"] == 0
    finally:
        for e in engines:
            e.close()


def test_sampled_decoding_is_seeded_and_in_vocab(models):
    _, _, _, model = models
    block = dict(_BLOCK, sampling={"temperature": 0.8, "top_k": 5})
    outs = []
    for _ in range(2):
        e = deepspeed_tpu_torch.init_inference(
            model=model, device="cpu", rng_seed=3,
            config={"inference": block},
        )
        try:
            outs.append(e.generate([_prompt(6, 14)], max_new_tokens=10))
        finally:
            e.close()
    assert outs[0] == outs[1]
    assert all(0 <= t < VOCAB for t in outs[0][0])


@pytest.mark.parametrize("inference,extra", [
    ({"kv_block_size": 0, "fused_decode": True}, {}),
    ({"kv_block_size": 0, "host_tier": {"enabled": True}}, {}),
    ({"speculative": {"k": 2}}, {}),
    ({}, {"mesh": {"data_parallel_size": 2}}),
    ({}, {"mesh": {"sequence_parallel_size": 2}}),
])
def test_engine_refuses_what_is_not_yet_ported(models, inference, extra):
    """Serving over a data axis is ported (ROADMAP A8c,
    tests/test_torch_serving_data_axis.py), as is the model axis
    (tests/test_torch_serving_model_parallel.py): their cases hold what the
    JAX engine does with the same block, a data axis that does not cover
    the world refused with its ``ValueError`` and a sequence size not read
    (both serve, with equal greedy tokens). The contiguous cache, the host
    tier and speculative decoding are ported (since they came with the
    rest of inference), so their cases hold what the JAX engine still
    refuses of them, with its message: fused decode without pages, a host
    tier with nothing to spill, speculation without a draft."""
    _, jmodel, params, model = models
    block = {k: v for k, v in dict(_BLOCK, **inference).items()
             if not (k == "kv_block_size" and v == 0)}
    if extra:
        config = {"inference": block, **extra}
        if "data_parallel_size" in extra["mesh"]:
            with pytest.raises(ValueError, match="covers 2 devices but 8"):
                deepspeed_tpu.init_inference(
                    model=jmodel, model_parameters=params, config=config)
            with pytest.raises(ValueError, match="covers 2 devices but 1"):
                deepspeed_tpu_torch.init_inference(
                    model=model, device="cpu", config=config)
            return
        want = deepspeed_tpu.init_inference(
            model=jmodel, model_parameters=params, config=config)
        got = deepspeed_tpu_torch.init_inference(
            model=model, device="cpu", config=config)
        try:
            assert got.mesh is None
            prompt = [_prompt(6, 14)]
            assert got.generate(prompt, max_new_tokens=4) == want.generate(
                prompt, max_new_tokens=4)
        finally:
            got.close()
            want.close()
        return
    with pytest.raises(DeepSpeedConfigError) as got:
        deepspeed_tpu_torch.init_inference(
            model=model, device="cpu",
            config={"inference": block, **extra},
        )
    with pytest.raises(Exception) as want:
        deepspeed_tpu.init_inference(
            model=jmodel, model_parameters=params,
            config={"inference": block})
    assert type(want.value).__name__ == "DeepSpeedConfigError"
    assert str(got.value) == str(want.value)


def test_checkpoint_load_dir_without_a_checkpoint_raises(models, tmp_path):
    """``inference.checkpoint.load_dir`` is ported: a directory with no
    loadable checkpoint raises the JAX engine's error."""
    _, _, _, model = models
    block = dict(_BLOCK, checkpoint={"load_dir": str(tmp_path)})
    with pytest.raises(RuntimeError, match="no loadable checkpoint"):
        deepspeed_tpu_torch.init_inference(
            model=model, device="cpu", config={"inference": block})
