"""Port parity for speculative decoding: deepspeed_tpu_torch's engine
(CPU, the kernels' plain versions) against deepspeed_tpu's on the same
weights, carried over with ``params_from_jax``.

Each case mirrors one of tests/unit/test_speculative.py and holds the
port to the JAX engine where both run: greedy tokens IDENTICAL, and the
``infer/spec_proposed``/``spec_accepted`` counters EQUAL (float32, the
same draft on both sides, so every proposal and every acceptance is the
same). Where the JAX test pins compile counts across acceptance lengths,
the port pins its device waits instead: one device-to-host copy a cycle,
and no other wait, whatever the cycle accepts.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel, params_from_jax
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from torch_test_env import jax_compile_cache  # noqa: F401

VOCAB = 97
_BLOCK = {"max_batch_slots": 4, "max_seq_len": 48, "prefill_len": 32,
          "kv_block_size": 8, "sampling": {"greedy": True}}
SPEC_COUNTERS = ("infer/spec_proposed", "infer/spec_accepted")


def _jax_model(seed=0, n_layer=2, n_embd=32):
    """test_speculative.py's small model: 2 x 32, vocab 97."""
    cfg = JGPT2Config(
        vocab_size=VOCAB, n_positions=64, n_embd=n_embd, n_layer=n_layer,
        n_head=4, dropout=0.0, use_flash=False,
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


def _port_model(jcfg, params, vocab=VOCAB):
    cfg = GPT2Config(
        vocab_size=vocab, n_positions=jcfg.n_positions,
        n_embd=jcfg.n_embd, n_layer=jcfg.n_layer, n_head=jcfg.n_head,
        layer_norm_eps=jcfg.layer_norm_eps,
    )
    model = GPT2LMHeadModel(cfg, device="cpu")
    if params is not None:
        model.load_state_dict(params_from_jax(params))
    return model


def _pair(jcfg, jmodel, params):
    """(JAX model, its params, the port model with the same weights)."""
    return jmodel, params, _port_model(jcfg, params)


@pytest.fixture(scope="module")
def random_draft():
    """Target (seed 0) and an INDEPENDENT 1-layer random draft (seed 7):
    frequent rejections."""
    cfg, jm, p = _jax_model()
    dcfg, jd, dp = _jax_model(seed=7, n_layer=1)
    return _pair(cfg, jm, p), _pair(dcfg, jd, dp)


@pytest.fixture(scope="module")
def agreeing():
    """test_speculative.py's agreeing pair: the draft is the target's
    first block with its embeddings and ln_f, and the target's second
    block has zero attn_ow/output_w and biases, so it adds exactly 0.0
    to the residual stream — target logits equal draft logits while the
    target pays full depth."""
    cfg, jm, params = _jax_model()
    t2 = copy.deepcopy(params)
    h = t2["transformer"]["h"]
    for key in ("attn_ow", "output_w", "attn_ob", "output_b"):
        arr = np.array(h[key])
        arr[1:] = 0.0
        h[key] = arr
    dcfg = JGPT2Config(
        vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=1,
        n_head=4, dropout=0.0, use_flash=False,
    )
    dparams = copy.deepcopy(params)
    dparams["transformer"]["h"] = {
        k: np.array(v)[:1] for k, v in params["transformer"]["h"].items()
    }
    return _pair(cfg, jm, t2), _pair(dcfg, JGPT2LMHeadModel(dcfg), dparams)


def _engines(target, draft=None, extra=None, jax_too=True):
    """(port engine, JAX engine or None) with the same block."""
    jm, jp, tm = target
    block = dict(_BLOCK, **(extra or {}))
    kw_t, kw_j = {}, {}
    if draft is not None:
        kw_t = dict(draft_model=draft[2])
        kw_j = dict(draft_model=draft[0], draft_parameters=draft[1])
    et = deepspeed_tpu_torch.init_inference(
        model=tm, config={"inference": block}, device="cpu", **kw_t)
    ej = None
    if jax_too:
        ej = deepspeed_tpu.init_inference(
            model=jm, model_parameters=jp, config={"inference": block},
            **kw_j)
    return et, ej


def _prompt(n=8, seed=1):
    return [int(t) for t in np.random.default_rng(seed).integers(0, VOCAB, n)]


def _counters(engine):
    snap = engine.metrics.snapshot()
    return {n: snap[n] for n in SPEC_COUNTERS}


def _close(*engines):
    for e in engines:
        if e is not None:
            e.close()


# ---------------------------------------------------------------------------
# greedy parity across acceptance regimes
# ---------------------------------------------------------------------------
def test_spec_parity_with_rejecting_random_draft(random_draft):
    """An independent random draft: the port's speculative tokens equal
    its own non-speculative engine's and the JAX speculative engine's,
    and its proposal/acceptance counters equal JAX's."""
    target, draft = random_draft
    ref, _ = _engines(target, jax_too=False)
    et, ej = _engines(target, draft, {"speculative": {"k": 3}})
    try:
        prompts = [_prompt(9, 1), _prompt(5, 2), _prompt(13, 3)]
        out = et.generate(prompts, max_new_tokens=10)
        assert out == ref.generate(prompts, max_new_tokens=10)
        assert out == ej.generate(prompts, max_new_tokens=10)
        assert _counters(et) == _counters(ej)
        snap = et.metrics.snapshot()
        assert snap["infer/spec_proposed"] > 0
        assert 0.0 <= snap["infer/spec_acceptance_rate"] <= 1.0
    finally:
        _close(ref, et, ej)


def test_spec_parity_and_acceptance_with_agreeing_draft(agreeing):
    """The high-acceptance regime: parity holds, the acceptance rate
    approaches 1 and EQUALS the JAX engine's (the sync step closes the
    full-acceptance cache hole on both), and each decode step commits
    several tokens."""
    target, draft = agreeing
    ref, _ = _engines(target, jax_too=False)
    et, ej = _engines(target, draft, {"speculative": {"k": 4}})
    try:
        prompts = [_prompt(9, 1), _prompt(5, 2)]
        out = et.generate(prompts, max_new_tokens=12)
        assert out == ref.generate(prompts, max_new_tokens=12)
        assert out == ej.generate(prompts, max_new_tokens=12)
        assert _counters(et) == _counters(ej)
        snap = et.metrics.snapshot()
        assert snap["infer/spec_acceptance_rate"] > 0.8, snap
        assert snap["infer/spec_acceptance_rate"] == \
            ej.metrics.snapshot()["infer/spec_acceptance_rate"]
        assert snap["infer/token_latency_ms/count"] * 2 <= \
            snap["infer/tokens_generated"]
    finally:
        _close(ref, et, ej)


def test_spec_parity_mid_flight_join_and_eos_reuse(agreeing):
    """A mid-flight join and EOS slot reuse on the speculative path give
    the sequential engine's tokens (and the JAX speculative engine's);
    EOS mid-burst discards the burst's tail."""
    target, draft = agreeing
    ref, _ = _engines(target, jax_too=False)
    et, ej = _engines(target, draft, {"speculative": {"k": 3}})
    try:
        r1 = [e.submit(_prompt(8, 4), max_new_tokens=12)
              for e in (ref, et, ej)]
        ref.scheduler.step()
        ref.scheduler.step()
        et.scheduler.step()
        ej.scheduler.step()
        r2 = [e.submit(_prompt(7, 5), max_new_tokens=8)
              for e in (ref, et, ej)]
        for e in (ref, et, ej):
            e.scheduler.run_until_idle()
        assert r1[0].result(0) == r1[1].result(0) == r1[2].result(0)
        assert r2[0].result(0) == r2[1].result(0) == r2[2].result(0)

        eos = ref.generate([_prompt(8, 6)], max_new_tokens=8)[0][3]
        rs = [e.submit(_prompt(8, 6), max_new_tokens=8, eos_token_id=eos)
              for e in (ref, et, ej)]
        for e in (ref, et, ej):
            e.scheduler.run_until_idle()
        assert {r.finish_reason for r in rs} == {"eos"}
        assert rs[0].result(0) == rs[1].result(0) == rs[2].result(0)
        # the freed slot serves the next request exactly
        outs = [e.generate([_prompt(6, 9)], max_new_tokens=6)
                for e in (ref, et, ej)]
        assert outs[0] == outs[1] == outs[2]
        assert _counters(et) == _counters(ej)
    finally:
        _close(ref, et, ej)


def test_spec_disables_inert_fused_flag_and_prefix_cache_composes(agreeing):
    """fused_decode on a speculative engine is inert and turned off (the
    gauge reads 0); the prefix cache composes: hits serve suffix-only
    under speculation, with parity, and move as on the JAX engine."""
    target, draft = agreeing
    ref, _ = _engines(target, jax_too=False)
    et, ej = _engines(target, draft,
                      {"speculative": {"k": 3}, "fused_decode": True})
    try:
        assert et.speculative and not et.fused_decode
        assert et.metrics.gauge("infer/fused_decode").value == 0
        shared = _prompt(16, 7)
        for tail_seed in (8, 9):
            p = [shared + _prompt(3, tail_seed)]
            out = et.generate(p, max_new_tokens=6)
            assert out == ref.generate(p, max_new_tokens=6)
            assert out == ej.generate(p, max_new_tokens=6)
        hits = et.metrics.counter("infer/prefix_hits").value
        assert hits >= 1
        assert hits == ej.metrics.counter("infer/prefix_hits").value
    finally:
        _close(ref, et, ej)


def test_spec_length_cap_null_redirect_protects_shared_pages(agreeing):
    """A speculative request finishing AT the length cap: its verify
    writes past max_seq_len land on the null page, not on the slot's
    last (shared prefix) page — serving the same prefix again decodes
    exactly like a cache-less engine."""
    target, draft = agreeing
    et, ej = _engines(target, draft,
                      {"speculative": {"k": 4}, "prefill_len": 40})
    cold, _ = _engines(target, None,
                       {"prefix_cache": {"enabled": False},
                        "prefill_len": 40}, jax_too=False)
    try:
        shared = _prompt(32, 11)  # 4 full pages of shared prefix
        pa = shared + _prompt(2, 12)
        ra = et.submit(pa, max_new_tokens=30)
        et.scheduler.run_until_idle()
        assert ra.finish_reason == "length"
        assert ra.result(0) == cold.generate([pa], max_new_tokens=30)[0]
        assert ra.result(0) == ej.generate([pa], max_new_tokens=30)[0]
        pb = shared + _prompt(2, 13)
        hot = et.generate([pb], max_new_tokens=6)[0]
        assert et.metrics.counter("infer/prefix_hits").value >= 1
        assert hot == cold.generate([pb], max_new_tokens=6)[0]
        assert hot == ej.generate([pb], max_new_tokens=6)[0]
        assert _counters(et) == _counters(ej)
    finally:
        _close(et, ej, cold)


# ---------------------------------------------------------------------------
# one device wait a cycle, whatever the acceptance (the JAX test pins
# zero recompiles across acceptance lengths)
# ---------------------------------------------------------------------------
def test_spec_decode_waits_once_a_cycle_across_acceptance_lengths(
        random_draft, monkeypatch):
    """Cycles whose bursts commit varying token counts each make exactly
    one device-to-host copy (the proposals and the verify result
    together) and no other host read of a device value: the k + 1 draft
    steps and the verify queue without a wait."""
    target, draft = random_draft
    et, _ = _engines(target, draft, {"speculative": {"k": 3}},
                     jax_too=False)
    waits = {"cpu": 0, "other": 0}
    in_decode = [False]

    def counting(name, original):
        def wrapper(self, *a, **kw):
            if in_decode[0]:
                waits["cpu" if name == "cpu" else "other"] += 1
            return original(self, *a, **kw)
        return wrapper

    for name in ("cpu", "item", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    decode = et.decode_tokens
    per_cycle = []

    def watched(active):
        before = dict(waits)
        in_decode[0] = True
        try:
            return decode(active)
        finally:
            in_decode[0] = False
            per_cycle.append((waits["cpu"] - before["cpu"],
                              waits["other"] - before["other"]))

    et.decode_tokens = watched
    try:
        seen_commits = set()
        for seed in range(2, 8):
            r = et.submit(_prompt(5 + seed, seed),
                          max_new_tokens=6 + seed % 3)
            steps_before = et.metrics.snapshot()[
                "infer/token_latency_ms/count"]
            et.scheduler.run_until_idle()
            steps = et.metrics.snapshot()[
                "infer/token_latency_ms/count"] - steps_before
            seen_commits.add((len(r.result(0)), int(steps)))
        assert len(seen_commits) > 1, seen_commits
        assert per_cycle and set(per_cycle) == {(1, 0)}, per_cycle
    finally:
        et.decode_tokens = decode
        et.close()


# ---------------------------------------------------------------------------
# telemetry + tracing
# ---------------------------------------------------------------------------
def test_spec_streams_and_phase_spans(agreeing, tmp_path):
    """infer/spec_* move and the tracer's ring carries the
    sched.spec_draft/spec_verify/spec_commit phase spans."""
    target, draft = agreeing
    engine = deepspeed_tpu_torch.init_inference(
        model=target[2], device="cpu", draft_model=draft[2],
        config={
            "inference": dict(_BLOCK, max_batch_slots=2,
                              speculative={"k": 3}),
            "telemetry": {
                "enabled": True, "output_path": str(tmp_path),
                "job_name": "spec_spans", "exporters": [],
                "watchdog": {"enabled": False},
                "tracing": {"enabled": True, "ring_events": 1024,
                            "export": "none"},
            },
        },
    )
    try:
        engine.generate([_prompt(8, 1)], max_new_tokens=6)
        names = {s["name"] for s in engine.tracer.flight_snapshot()}
        for want in ("sched.decode_step", "sched.spec_draft",
                     "sched.spec_verify", "sched.spec_commit"):
            assert want in names, f"{want} missing from {sorted(names)}"
        snap = engine.metrics.snapshot()
        assert snap["infer/spec_proposed"] > 0
        assert snap["infer/spec_accepted"] > 0
    finally:
        engine.close()


# ---------------------------------------------------------------------------
# guard rails: the JAX engine's refusals and messages
# ---------------------------------------------------------------------------
def _refusal(build, error=DeepSpeedConfigError):
    with pytest.raises(error) as info:
        build()
    return str(info.value)


JAX_REFUSAL = deepspeed_tpu.config.config.DeepSpeedConfigError


def test_spec_requires_draft_model(random_draft):
    (jm, jp, tm), _ = random_draft
    block = dict(_BLOCK, speculative={"k": 2})
    got = _refusal(lambda: deepspeed_tpu_torch.init_inference(
        model=tm, config={"inference": block}, device="cpu"))
    want = _refusal(lambda: deepspeed_tpu.init_inference(
        model=jm, model_parameters=jp, config={"inference": block}),
        JAX_REFUSAL)
    assert "draft" in got
    assert got == want


def test_spec_requires_greedy_sampling(random_draft):
    target, draft = random_draft
    extra = {"speculative": {"k": 2},
             "sampling": {"greedy": False, "temperature": 0.8}}
    got = _refusal(lambda: _engines(target, draft, extra, jax_too=False))
    want = _refusal(lambda: deepspeed_tpu.init_inference(
        model=target[0], model_parameters=target[1],
        config={"inference": dict(_BLOCK, **extra)},
        draft_model=draft[0], draft_parameters=draft[1]), JAX_REFUSAL)
    assert got == want
    assert "GREEDY" in got


def test_spec_submit_rejects_nonzero_temperature(agreeing):
    target, draft = agreeing
    et, _ = _engines(target, draft, {"speculative": {"k": 2}},
                     jax_too=False)
    try:
        with pytest.raises(ValueError, match="speculative"):
            et.submit(_prompt(6), temperature=0.7)
    finally:
        et.close()


@pytest.mark.parametrize("case", ["vocab", "n_positions", "contiguous"])
def test_spec_refuses_mismatched_drafts_and_the_contiguous_cache(
        random_draft, case):
    """A draft vocabulary that differs from the target's, a draft whose
    n_positions does not reach max_seq_len, and speculation without the
    paged cache: refused with the JAX engine's messages."""
    target, (jd, jdp, _) = random_draft
    jm, jp, tm = target
    dvocab, dpos, extra = VOCAB, 64, {"speculative": {"k": 2}}
    if case == "vocab":
        dvocab = VOCAB + 1
    elif case == "n_positions":
        dpos = 32
    else:
        extra = dict(extra, kv_block_size=0)
    dcfg = JGPT2Config(vocab_size=dvocab, n_positions=dpos, n_embd=32,
                       n_layer=1, n_head=4, dropout=0.0, use_flash=False)
    djm = JGPT2LMHeadModel(dcfg)
    ids0 = jnp.zeros((1, 8), jnp.int32)
    dparams = jax.tree_util.tree_map(np.asarray, djm.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        ids0, ids0)["params"])
    dtm = _port_model(dcfg, dparams, vocab=dvocab)
    block = dict(_BLOCK, **extra)
    got = _refusal(lambda: deepspeed_tpu_torch.init_inference(
        model=tm, config={"inference": block}, device="cpu",
        draft_model=dtm))
    want = _refusal(lambda: deepspeed_tpu.init_inference(
        model=jm, model_parameters=jp, config={"inference": block},
        draft_model=djm, draft_parameters=dparams), JAX_REFUSAL)
    assert got == want
    assert {"vocab": "vocab", "n_positions": "n_positions",
            "contiguous": "paged cache"}[case] in got


def test_spec_driver_restart_resets_draft_cache_and_serves_on(agreeing):
    """A decode crash on the speculative path restarts like any other:
    fresh target pool AND fresh draft cache, queue preserved,
    post-restart output exactly a clean engine's (and the JAX
    engine's)."""
    target, draft = agreeing
    engine, _ = _engines(
        target, draft,
        {"speculative": {"k": 3}, "driver_restart_budget": 1},
        jax_too=False)
    clean, ej = _engines(target, draft, {"speculative": {"k": 3}})
    try:
        engine.generate([_prompt(8, 1)], max_new_tokens=4)
        original = engine.decode_tokens

        def crash_once(active):
            engine.decode_tokens = original
            raise RuntimeError("injected decode crash")

        r = engine.submit(_prompt(9, 2), max_new_tokens=6)
        engine.decode_tokens = crash_once
        engine.scheduler.run_until_idle()
        assert r.finish_reason == "error"
        assert engine.scheduler.restarts_used == 1
        out = engine.generate([_prompt(10, 3)], max_new_tokens=6)
        assert out == clean.generate([_prompt(10, 3)], max_new_tokens=6)
        assert out == ej.generate([_prompt(10, 3)], max_new_tokens=6)
    finally:
        _close(engine, clean, ej)


# ---------------------------------------------------------------------------
# the draft from a checkpoint and from JAX parameters
# ---------------------------------------------------------------------------
def test_spec_draft_from_params_and_from_a_checkpoint(agreeing, tmp_path):
    """``draft_parameters`` as a state dict (through params_from_jax)
    replaces the draft module's own weights, and
    ``speculative.draft_checkpoint`` replaces them through the verified
    load: both serve what the agreeing draft serves."""
    target, draft = agreeing
    (_, _, tm), (_, dparams, dtm) = target, draft
    fresh = _port_model(
        JGPT2Config(vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=1,
                    n_head=4), None)
    ref, _ = _engines(target, draft, {"speculative": {"k": 3}},
                      jax_too=False)
    by_params = deepspeed_tpu_torch.init_inference(
        model=tm, device="cpu", draft_model=fresh,
        draft_parameters=params_from_jax(dparams),
        config={"inference": dict(_BLOCK, speculative={"k": 3})})
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=copy.deepcopy(dtm), device="cpu",
        config_params={"train_micro_batch_size_per_gpu": 1,
                       "optimizer": {"type": "Adam",
                                     "params": {"lr": 1e-3}}})
    engine.save_checkpoint(str(tmp_path))
    by_ckpt = deepspeed_tpu_torch.init_inference(
        model=tm, device="cpu", draft_model=fresh,
        config={"inference": dict(_BLOCK, speculative={
            "k": 3, "draft_checkpoint": str(tmp_path)})})
    try:
        prompts = [_prompt(9, 1), _prompt(6, 2)]
        want = ref.generate(prompts, max_new_tokens=10)
        assert by_params.generate(prompts, max_new_tokens=10) == want
        assert by_ckpt.generate(prompts, max_new_tokens=10) == want
        assert _counters(by_params) == _counters(ref)
        assert _counters(by_ckpt) == _counters(ref)
    finally:
        _close(ref, by_params, by_ckpt)
        engine.close()
