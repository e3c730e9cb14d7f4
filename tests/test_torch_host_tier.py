"""Port parity for the host-memory spill tier: deepspeed_tpu_torch's
HostTier, BlockPool/AdapterPool spill seams and engine (CPU, the kernels'
plain versions) against deepspeed_tpu's on the same weights, carried
over with ``params_from_jax`` / ``adapters_from_jax``.

Each case mirrors one of tests/unit/test_host_tier.py. The tier itself
is held to the JAX tier's digest over the same bytes, LRU order, pins,
refcounted share groups and counters; the engine cases run both engines
on the same traffic and require IDENTICAL greedy tokens and EQUAL
``host_tier_*`` counters (kv_snapshot), and hold spilled and promoted
pages and adapter rows bit for bit against what the pool held.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.adapters import init_lora_params as jinit_lora_params
from deepspeed_tpu.inference import host_tier as jhost_tier
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.telemetry import manager as jmanager
from deepspeed_tpu_torch import (
    GPT2Config,
    GPT2LMHeadModel,
    adapters_from_jax,
    params_from_jax,
)
from deepspeed_tpu_torch.adapters.pool import AdapterPool, AdapterPoolFull
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.inference import BlockPool, HostTier
from deepspeed_tpu_torch.inference import host_tier as thost_tier
from deepspeed_tpu_torch.telemetry import manager as tmanager
from torch_test_env import jax_compile_cache  # noqa: F401

VOCAB = 97
TIER_KEYS = ("host_tier_spills", "host_tier_promotions",
             "host_tier_peer_fetches", "host_tier_preemptions",
             "host_tier_copy_faults", "host_tier_entries",
             "host_tier_occupancy_bytes")


def _jax_model(seed=0):
    """test_host_tier.py's small model: 2 x 32, vocab 97."""
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
    return jmodel, params, _port_model(jcfg, params)


def _prompt(n=8, seed=1):
    return [int(t) for t in np.random.default_rng(seed).integers(0, VOCAB, n)]


def _config(inference=None, adapters=None, resilience=None):
    block = {"max_batch_slots": 4, "max_seq_len": 48, "prefill_len": 32,
             "kv_block_size": 8, "sampling": {"greedy": True}}
    block.update(inference or {})
    config = {"inference": block}
    if adapters is not None:
        ad = {"enabled": True, "rank": 2, "pool_slots": 4}
        ad.update(adapters)
        config["adapters"] = ad
    if resilience is not None:
        config["resilience"] = resilience
    return config


def _engines(models, **kw):
    """(port engine, JAX engine) over the same config; the share groups
    are the process's own per package, so the two never share a tier."""
    jmodel, params, tmodel = models
    config = _config(**kw)
    et = deepspeed_tpu_torch.init_inference(
        model=tmodel, config=config, device="cpu")
    ej = deepspeed_tpu.init_inference(
        model=jmodel, model_parameters=params, config=config)
    return et, ej


def _tier_block(group, **kw):
    ht = {"enabled": True, "share_group": group}
    ht.update(kw)
    return ht


def _tier_counts(engine):
    snap = engine.kv_snapshot()
    return {k: snap[k] for k in TIER_KEYS}


def _synth_adapter(params, seed, rank=2, scale=0.2):
    ada = jinit_lora_params(params, rank, rng=jax.random.PRNGKey(seed))
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


def _close(*engines):
    for e in engines:
        e.close()


# ---------------------------------------------------------------------------
# HostTier: the tier itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tier_roundtrip_bitwise_with_meta_and_origin(dtype):
    tier = HostTier(max_bytes=1 << 20)
    gen = torch.Generator().manual_seed(0)
    k = torch.rand((2, 8, 4, 8), generator=gen).to(dtype)
    v = torch.rand((2, 8, 4, 8), generator=gen).to(dtype)
    assert tier.put("h1", (k, v), meta={"kind": "kv"}, origin="engine-a")
    assert tier.contains("h1") and tier.entries == 1
    assert tier.occupancy_bytes == 2 * k.numel() * k.element_size()
    placed, meta, origin = tier.fetch("h1", requester="engine-b")
    assert torch.equal(placed[0], k) and torch.equal(placed[1], v)
    assert placed[0].dtype == dtype
    assert meta == {"kind": "kv"} and origin == "engine-a"
    assert tier.promotions == 1 and tier.peer_fetches == 1
    # same-origin fetch is NOT a peer fetch
    tier.fetch("h1", requester="engine-a")
    assert tier.peer_fetches == 1
    tier.close()


def test_tier_digest_is_the_jax_tiers_over_the_same_bytes():
    """The sha1 over each tensor's bytes in order equals the JAX tier's
    over the same numpy arrays (float32, int32 and a bfloat16 payload
    read as its raw 16-bit words)."""
    rng = np.random.default_rng(3)
    f = rng.random((2, 8, 4, 8), np.float32)
    i = rng.integers(0, 1000, (5, 7)).astype(np.int32)
    b = torch.from_numpy(rng.random((3, 16), np.float32)).to(torch.bfloat16)
    words = b.view(torch.int16).numpy()
    assert thost_tier._digest((torch.from_numpy(f), torch.from_numpy(i),
                               b)) == jhost_tier._digest((f, i, words))
    # numpy payloads park as tensors over the same bytes, same digest
    tier = HostTier(max_bytes=1 << 20)
    assert tier.put("x", (f, i))
    assert tier._entries["x"].digest == jhost_tier._digest((f, i))
    placed, _, _ = tier.fetch("x")
    assert np.array_equal(placed[0].numpy(), f)
    tier.close()


def test_tier_byte_budget_evicts_lru_first_injectable_clock():
    clock = [0.0]
    tier = HostTier(max_bytes=3 * 1024, clock=lambda: clock[0])
    page = torch.zeros(256)  # 1 KiB each
    for i, key in enumerate(("a", "b", "c")):
        clock[0] = float(i)
        assert tier.put(key, (page,))
    clock[0] = 10.0
    tier.fetch("a")  # refresh a's recency: b is now the LRU victim
    clock[0] = 11.0
    assert tier.put("d", (page,))
    assert tier.entries == 3 and tier.evictions == 1
    assert not tier.contains("b")
    assert tier.contains("a") and tier.contains("c") and tier.contains("d")
    tier.close()


def test_tier_pinned_entry_survives_budget_pressure():
    tier = HostTier(max_bytes=1024)
    page = torch.zeros(256)
    assert tier.put("pinned", (page,))
    handle = tier.fetch_async("pinned")  # pin without consuming
    assert tier.put("next", (page,))  # over budget, but "pinned" is pinned
    assert tier.contains("pinned")
    handle.result()  # placement done: unpinned
    assert tier.put("more", (page,))
    assert not tier.contains("pinned")  # now evictable, and evicted
    tier.close()


def test_tier_oversize_entry_rejected_outright():
    tier = HostTier(max_bytes=64)
    assert not tier.put("big", (torch.zeros(1024),))
    assert tier.entries == 0 and tier.spills == 0
    tier.close()


def test_tier_corrupt_entry_drops_at_fetch_as_cold_miss():
    """The digest is computed over the CLEAN payload, the stored copy is
    mangled (the caller's tensor is not), and the promotion-time verify
    drops the entry: a corrupt page only ever reads as a miss."""
    tier = HostTier(max_bytes=1 << 20)
    page = torch.arange(64, dtype=torch.float32)
    assert tier.put("bad", (page,), corrupt=True)
    assert torch.equal(page, torch.arange(64, dtype=torch.float32))
    assert tier.contains("bad")
    assert tier.fetch_async("bad") is None
    assert tier.checksum_drops == 1 and not tier.contains("bad")
    assert tier.fetch("bad") is None  # stays a miss
    tier.close()


def test_tier_shared_group_identity_and_refcount_retirement():
    a = HostTier.shared("t-group-x", max_bytes=1 << 16).retain()
    b = HostTier.shared("t-group-x").retain()
    assert a is b
    assert HostTier.shared("t-group-y") is not a
    a.put("k", (torch.zeros(8),))
    a.release()
    assert b.contains("k")  # one ref left: still open
    b.release()
    fresh = HostTier.shared("t-group-x").retain()
    try:
        assert fresh is not a and not fresh.contains("k")
    finally:
        fresh.release()


def test_tier_snapshot_counts():
    tier = HostTier(max_bytes=1 << 20)
    tier.put("a", (torch.zeros(16),), origin="e1")
    tier.fetch("a", requester="e2")
    snap = tier.snapshot()
    assert snap["entries"] == 1 and snap["spills"] == 1
    assert snap["promotions"] == 1 and snap["peer_fetches"] == 1
    assert snap["occupancy_bytes"] == 64
    tier.close()


def test_host_tier_catalog_matches_the_reference():
    assert [(k, n) for k, n, _ in tmanager.HOST_TIER_METRICS] == [
        (k, n) for k, n, _ in jmanager.HOST_TIER_METRICS]


# ---------------------------------------------------------------------------
# BlockPool spill seam
# ---------------------------------------------------------------------------
def test_block_pool_spill_fn_fires_on_eviction_with_hash():
    spilled = []
    pool = BlockPool(4, block_size=4,
                     spill_fn=lambda b, h: spilled.append((b, h)))
    prompt = list(range(9))  # 2 full pages + tail
    blocks = pool.alloc(3)
    pool.register_prefix(prompt, blocks)
    pool.release(blocks)
    assert pool.cached_blocks == 2 and not spilled  # parked, not evicted
    pool.alloc(4)  # pressure: both cached pages evict -> spill first
    assert [b for b, _ in spilled] == blocks[:2]
    assert all(isinstance(h, str) and h for _, h in spilled)
    assert pool.reclaimed == 2 and pool.spill_errors == 0


def test_block_pool_spill_fn_failure_never_blocks_eviction():
    def boom(b, h):
        raise OSError("device-to-host copy failed")
    pool = BlockPool(2, block_size=4, spill_fn=boom)
    blocks = pool.alloc(2)
    pool.register_prefix(list(range(9)), blocks)
    pool.release(blocks)
    got = pool.alloc(2)  # eviction proceeds despite the failing spill
    assert len(got) == 2 and pool.spill_errors == 2


def test_threaded_eviction_vs_acquire_stress():
    """BlockPool eviction (a spill callback writing into a shared
    HostTier) racing prefix acquires on other threads, and AdapterPool
    assign/acquire/release churn against the same tier: refcounts exact,
    the tier's locking holds, no exceptions and no lost pages."""
    clock = [0.0]
    tier = HostTier(max_bytes=1 << 22, clock=lambda: clock[0])
    pool = BlockPool(
        16, block_size=4,
        spill_fn=lambda b, h: tier.put(h, (torch.full((8,), float(b)),)),
    )
    apool = AdapterPool(3)
    pool_lock = threading.Lock()  # BlockPool is single-driver by contract
    errors = []

    def kv_churn(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(150):
                prompt = [int(t) for t in rng.integers(0, 50, 9)]
                with pool_lock:
                    try:
                        blocks = pool.alloc(3)
                    except Exception:
                        continue  # transient exhaustion: racing churn
                    _plen, shared = pool.match_prefix(prompt)
                    pool.register_prefix(prompt, blocks)
                    pool.release(blocks)
                    if shared:
                        pool.release(shared)
        except Exception as exc:  # pragma: no cover - the assertion
            errors.append(exc)

    def adapter_churn(seed):
        rng = np.random.default_rng(seed)
        names = [f"t{j}" for j in range(5)]
        try:
            for _ in range(200):
                name = names[int(rng.integers(0, len(names)))]
                op = int(rng.integers(0, 3))
                if op == 0:
                    try:
                        _, evicted = apool.assign(name)
                        if evicted is not None:
                            tier.put(f"adapter/{evicted}",
                                     (torch.zeros(16),))
                    except AdapterPoolFull:
                        pass
                elif op == 1:
                    try:
                        apool.acquire(name)
                        apool.release(name)
                    except KeyError:
                        pass
                else:
                    tier.fetch(f"adapter/{name}", timeout=5.0)
        except Exception as exc:  # pragma: no cover - the assertion
            errors.append(exc)

    threads = (
        [threading.Thread(target=kv_churn, args=(s,)) for s in range(2)]
        + [threading.Thread(target=adapter_churn, args=(s,))
           for s in range(2)]
    )
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert pool.used_blocks == 0  # every alloc was released
    for name in apool.loaded:
        assert apool.active_count(name) == 0
    assert tier.occupancy_bytes <= tier.max_bytes
    tier.close()


def test_adapter_pool_assign_restores_a_generation():
    """The auto-load seam: ``assign(name, generation=g)`` restores g, and
    a later true reload still mints a strictly newer generation."""
    pool = AdapterPool(2)
    pool.assign("a")
    pool.assign("b")
    gen_b = pool.generation_of("b")
    pool.remove("b")
    pool.assign("b", generation=gen_b)
    assert pool.generation_of("b") == gen_b
    pool.assign("b")
    assert pool.generation_of("b") > gen_b


# ---------------------------------------------------------------------------
# engine level, against the JAX engine
# ---------------------------------------------------------------------------
def _page_bytes(engine, block_id):
    return (engine._cache.k[:, block_id].clone(),
            engine._cache.v[:, block_id].clone())


def test_kv_spill_promote_bitwise_roundtrip(models):
    """Evicted prefix pages park on the host, a chain-hash hit promotes
    them into fresh private pages, and decode over them gives the first
    (cold) serve's tokens — the JAX engine's tokens, with its counters.
    Every parked page holds the bytes its page held, and every promoted
    page holds its entry's bytes, bit for bit."""
    et, ej = _engines(models, inference={
        "kv_pool_blocks": 6, "host_tier": _tier_block("rt-g")})
    try:
        shared = _prompt(16, 7)
        p0 = shared + _prompt(4, 8)
        out1 = et.generate([p0], max_new_tokens=4)[0]
        assert out1 == ej.generate([p0], max_new_tokens=4)[0]
        assert et.block_pool.cached_blocks == 2
        # the cached pages' bytes, by chain hash, before the churn
        before = {}
        for h, b in list(et.block_pool._registry.items()):
            before[h] = _page_bytes(et, b)
        for e in (et, ej):
            rs = [e.submit(_prompt(8, 20 + i), max_new_tokens=8)
                  for i in range(3)]
            e.scheduler.run_until_idle()
            assert all(len(r.result(0)) == 8 for r in rs)
        assert et.kv_snapshot()["host_tier_spills"] >= 2
        for h, (k, v) in before.items():
            if et.host_tier.contains(h):
                parked = et.host_tier._entries[h].arrays
                assert torch.equal(parked[0], k)
                assert torch.equal(parked[1], v)
        parked = {h: et.host_tier._entries[h].arrays
                  for h in et.host_tier.keys()}
        out2 = et.generate([p0], max_new_tokens=4)[0]
        assert out2 == out1 == ej.generate([p0], max_new_tokens=4)[0]
        assert et.kv_snapshot()["host_tier_promotions"] >= 1
        promoted = [h for h in parked
                    if h in et.block_pool._registry]
        assert promoted
        for h in promoted:
            k, v = _page_bytes(et, et.block_pool._registry[h])
            assert torch.equal(k, parked[h][0])
            assert torch.equal(v, parked[h][1])
        assert _tier_counts(et) == _tier_counts(ej)
        assert et.load_snapshot()["host_tier_occupancy_bytes"] > 0
    finally:
        _close(et, ej)


def test_peer_promotion_warms_cohosted_engine(models):
    """Two engines in one share group share one tier; A's evicted
    template pages serve B's FIRST templated request as a peer-promoted
    hit, with A's tokens, and both engines count as the JAX pair."""
    jmodel, params, tmodel = models
    config = _config(inference={"kv_pool_blocks": 6,
                                "host_tier": _tier_block("peer-g")})

    def pair(pkg, model, **kw):
        return [pkg.init_inference(model=model, config=config, **kw)
                for _ in range(2)]

    ta, tb = pair(deepspeed_tpu_torch, tmodel, device="cpu")
    ja, jb = pair(deepspeed_tpu, jmodel, model_parameters=params)
    try:
        assert ta.host_tier is tb.host_tier
        shared = _prompt(16, 7)
        p0 = shared + _prompt(4, 8)
        outs = {}
        for name, (a, b) in (("t", (ta, tb)), ("j", (ja, jb))):
            out_a = a.generate([p0], max_new_tokens=4)[0]
            rs = [a.submit(_prompt(8, 40 + i), max_new_tokens=8)
                  for i in range(3)]
            a.scheduler.run_until_idle()
            assert all(len(r.result(0)) == 8 for r in rs)
            assert a.kv_snapshot()["host_tier_spills"] >= 2
            out_b = b.generate([p0], max_new_tokens=4)[0]
            sb = b.kv_snapshot()
            assert sb["host_tier_peer_fetches"] >= 1
            assert sb["prefix_hits"] >= 1
            assert out_b == out_a
            outs[name] = (out_a, _tier_counts(a), _tier_counts(b))
        assert outs["t"] == outs["j"]
    finally:
        _close(ta, tb, ja, jb)
    fresh = HostTier.shared("peer-g").retain()
    try:
        assert fresh.entries == 0
    finally:
        fresh.release()


def test_preempt_park_resume_bitwise_exactness(models):
    """Lazy page growth: admission reserves only the prompt's pages, and
    decode-time growth preempts when the pool runs dry. The preempted
    request parks, resumes suffix-only, and every request completes with
    an unpressured engine's tokens — and the JAX engine's, with as many
    preemptions."""
    jmodel, params, tmodel = models
    et, ej = _engines(models, inference={
        "kv_pool_blocks": 4, "max_batch_slots": 2,
        "host_tier": _tier_block("lazy-g", lazy_alloc=True)})
    ref = deepspeed_tpu_torch.init_inference(
        model=tmodel, device="cpu", config=_config(
            inference={"kv_pool_blocks": 12, "max_batch_slots": 2}))
    try:
        prompts = [_prompt(8, 60), _prompt(8, 61)]
        outs = {}
        for name, e in (("t", et), ("j", ej)):
            rs = [e.submit(p, max_new_tokens=16) for p in prompts]
            e.scheduler.run_until_idle()
            outs[name] = [r.result(0) for r in rs]
            assert all(len(o) == 16 for o in outs[name])
        assert et.kv_snapshot()["host_tier_preemptions"] >= 1
        cold = [ref.generate([p], max_new_tokens=16)[0] for p in prompts]
        assert outs["t"] == cold == outs["j"]
        assert _tier_counts(et) == _tier_counts(ej)
    finally:
        _close(et, ej, ref)


def test_adapter_spill_and_auto_load_with_generation_restore(models):
    """An adapter evicted by pool pressure parks its rows (bit for bit
    the rows it held); a later submit for the name auto-loads them under
    the ORIGINAL generation and serves an always-resident engine's
    tokens — and the JAX engine's, with its counters. An explicit unload
    drops the tier copy too."""
    jmodel, params, tmodel = models
    sa, sb, sc = (_synth_adapter(params, s) for s in (1, 2, 3))
    et, ej = _engines(
        models,
        inference={"prefill_len": 16, "host_tier": _tier_block("ad-g")},
        adapters={"pool_slots": 2})
    ref = deepspeed_tpu_torch.init_inference(
        model=tmodel, device="cpu",
        config=_config(inference={"prefill_len": 16},
                       adapters={"pool_slots": 2}))
    try:
        for e, conv in ((et, adapters_from_jax), (ej, lambda a: a)):
            e.load_adapter("a", adapter_state=conv(sa))
            e.load_adapter("b", adapter_state=conv(sb))
        gen_b = et.adapter_registry.generation_of("b")
        row_b = et.adapter_registry.index_of("b")
        rows_b = [t[:, row_b].clone() for pair in
                  (et._adapter_pool[t] for t in sorted(et._adapter_pool))
                  for t in pair]
        outs = {}
        for name, e, conv in (("t", et, adapters_from_jax),
                              ("j", ej, lambda a: a)):
            e.generate([_prompt(6, 4)], max_new_tokens=2, adapter="a")
            e.load_adapter("c", adapter_state=conv(sc))
            assert "b" not in e.adapter_registry.loaded
            assert e.host_tier.contains("adapter/b")
            if e is et:
                parked = et.host_tier._entries["adapter/b"].arrays
                assert len(parked) == len(rows_b)
                for got, want in zip(parked, rows_b):
                    assert torch.equal(got, want)
            outs[name] = e.generate([_prompt(6, 5)], max_new_tokens=6,
                                    adapter="b")[0]
            assert "b" in e.adapter_registry.loaded
            assert e.adapter_registry.generation_of("b") == gen_b
            assert e.kv_snapshot()["host_tier_promotions"] >= 1
        row_b = et.adapter_registry.index_of("b")
        restored = [t[:, row_b] for pair in
                    (et._adapter_pool[t] for t in sorted(et._adapter_pool))
                    for t in pair]
        for got, want in zip(restored, rows_b):
            assert torch.equal(got, want)
        ref.load_adapter("b", adapter_state=adapters_from_jax(sb))
        want = ref.generate([_prompt(6, 5)], max_new_tokens=6,
                            adapter="b")[0]
        assert outs["t"] == want == outs["j"]
        assert _tier_counts(et) == _tier_counts(ej)
        et.unload_adapter("c")
        assert not et.host_tier.contains("adapter/c")
        with pytest.raises(ValueError, match="not loaded"):
            et.generate([_prompt(6, 5)], max_new_tokens=2, adapter="c")
    finally:
        _close(et, ej, ref)


@pytest.mark.parametrize("mode", ["oserror", "garble"])
def test_host_tier_copy_fault_serves_cold_and_counts(models, mode):
    """The ``host_tier.copy`` chaos site, armed twice. "oserror": both
    spills are skipped (the pages drop as without the tier). "garble":
    both park corrupted, the promotion-time checksum drops them and the
    template re-prefills. Either way the template's second serve equals
    its first and the JAX engine's, with the JAX engine's counters."""
    et, ej = _engines(
        models,
        inference={"kv_pool_blocks": 6,
                   "host_tier": _tier_block(f"f-{mode}")},
        resilience={"fault_injection": {
            "enabled": True,
            "faults": [{"site": "host_tier.copy", "times": 2,
                        "args": {"mode": mode}}],
        }})
    try:
        shared = _prompt(16, 7)
        p0 = shared + _prompt(4, 8)
        for e in (et, ej):
            out1 = e.generate([p0], max_new_tokens=4)[0]
            rs = [e.submit(_prompt(8, 20 + i), max_new_tokens=8)
                  for i in range(3)]
            e.scheduler.run_until_idle()
            [r.result(0) for r in rs]
            snap = e.kv_snapshot()
            assert snap["host_tier_copy_faults"] == 2
            assert snap["host_tier_spills"] == (
                0 if mode == "oserror" else 2)
            out2 = e.generate([p0], max_new_tokens=4)[0]
            assert out2 == out1
            if mode == "garble":
                assert e.host_tier.checksum_drops >= 1
                assert e.host_tier.entries <= 1
            else:
                assert e.host_tier.entries == 0
        assert out2 == ej.generate([p0], max_new_tokens=4)[0]
        assert _tier_counts(et) == _tier_counts(ej)
    finally:
        _close(et, ej)


def test_decode_pages_register_as_shareable_prefixes(models):
    """Full blocks COMPLETED DURING DECODE register at release, so a
    re-submit of prompt + continuation prefix-hits, as on the JAX
    engine."""
    et, ej = _engines(models, inference={"kv_pool_blocks": 8})
    try:
        prompt = _prompt(8, 3)
        for e in (et, ej):
            out = e.generate([prompt], max_new_tokens=10)[0]
            assert e.block_pool.cached_blocks >= 2
            hits0 = e.metrics.snapshot()["infer/prefix_hits"]
            follow = (prompt + out)[:16] + _prompt(4, 44)
            e.generate([follow], max_new_tokens=2)
            assert e.metrics.snapshot()["infer/prefix_hits"] == hits0 + 1
        assert et.block_pool.cached_blocks == ej.block_pool.cached_blocks
    finally:
        _close(et, ej)


def test_config_validation_matrix():
    def build(ht, adapters=None, kv_block_size=8):
        inf = {"max_batch_slots": 2, "max_seq_len": 32, "prefill_len": 16,
               "host_tier": ht}
        if kv_block_size:
            inf["kv_block_size"] = kv_block_size
        cfg = {"train_micro_batch_size_per_gpu": 1, "inference": inf}
        if adapters:
            cfg["adapters"] = adapters
        return DeepSpeedConfig(None, param_dict=cfg)

    cfg = build({"enabled": True, "max_bytes": 1024, "lazy_alloc": True})
    assert cfg.inference_host_tier_enabled
    assert cfg.inference_host_tier_max_bytes == 1024
    assert cfg.inference_host_tier_lazy_alloc
    assert cfg.inference_host_tier_share_group == "node"
    with pytest.raises(DeepSpeedConfigError, match="unknown"):
        build({"enabled": True, "max_byte": 1024})
    with pytest.raises(DeepSpeedConfigError, match="max_bytes"):
        build({"enabled": True, "max_bytes": 0})
    with pytest.raises(DeepSpeedConfigError, match="share_group"):
        build({"enabled": True, "share_group": ""})
    with pytest.raises(DeepSpeedConfigError, match="nothing to spill"):
        build({"enabled": True}, kv_block_size=0)
    assert build(
        {"enabled": True}, kv_block_size=0,
        adapters={"enabled": True, "rank": 2},
    ).inference_host_tier_enabled
    with pytest.raises(DeepSpeedConfigError, match="lazy_alloc"):
        build({"enabled": False, "lazy_alloc": True})


def test_adapter_tier_on_the_contiguous_cache(models):
    """Adapters alone are a reason for the tier: on the contiguous cache
    an evicted adapter parks and auto-loads as on the paged one, with the
    JAX engine's tokens and counters (lazy_alloc is inert there)."""
    jmodel, params, tmodel = models
    sa, sb, sc = (_synth_adapter(params, s) for s in (1, 2, 3))
    et, ej = _engines(
        models,
        inference={"kv_block_size": 0, "prefill_len": 16,
                   "host_tier": _tier_block("ad-contig")},
        adapters={"pool_slots": 2})
    try:
        assert not et.paged and et.block_pool is None
        outs = {}
        for name, e, conv in (("t", et, adapters_from_jax),
                              ("j", ej, lambda a: a)):
            for n, s in (("a", sa), ("b", sb)):
                e.load_adapter(n, adapter_state=conv(s))
            e.generate([_prompt(6, 4)], max_new_tokens=2, adapter="a")
            e.load_adapter("c", adapter_state=conv(sc))
            outs[name] = e.generate([_prompt(6, 5)], max_new_tokens=6,
                                    adapter="b")[0]
        assert outs["t"] == outs["j"]
        assert et.kv_snapshot() == {
            k: v for k, v in ej.kv_snapshot().items()}
    finally:
        _close(et, ej)
