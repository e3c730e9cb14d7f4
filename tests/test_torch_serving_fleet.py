"""Port parity for the fleet over real engines: ``init_fleet`` with two
in-process replicas of the JAX serving tests' small GPT-2
(tests/unit/test_serving.py ``_small_model``), the port's engines
serving its parameters carried over with ``params_from_jax``.

- Greedy tokens of the port's fleet equal the JAX fleet's, request for
  request, over paged engines with the prefix cache behind prefix
  affinity; the placement-independent ``fleet/*`` counts are equal too.
- A rolling restart under traffic answers every request exactly once,
  with the JAX engine's tokens, and routable capacity never drops under
  the floor.
- Brownout: the port's engine, toggled through its in-process replica,
  skips prefix registration exactly where the JAX engine does, while
  hits still serve (prefix hits, misses and registry sizes equal).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel, params_from_jax
from deepspeed_tpu_torch.serving import InProcessReplica
from torch_test_env import jax_compile_cache  # noqa: F401

VOCAB = 97
ENGINE_BLOCK = {"max_batch_slots": 2, "max_seq_len": 48, "prefill_len": 16,
                "sampling": {"greedy": True}}
PAGED_BLOCK = dict(ENGINE_BLOCK, kv_block_size=4)


@pytest.fixture(scope="module")
def models():
    """The JAX small model and its port twin (test_serving.py:649)."""
    cfg = JGPT2Config(
        vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        dropout=0.0, use_flash=False,
    )
    jmodel = JGPT2LMHeadModel(cfg)
    ids0 = jnp.asarray(
        np.random.default_rng(0).integers(0, VOCAB, (1, 8)), jnp.int32)
    params = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        ids0, ids0,
    )["params"]
    tmodel = GPT2LMHeadModel(GPT2Config(
        vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        dropout=0.0), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    tmodel.requires_grad_(False)
    return jmodel, params, tmodel


def _jax_factory(jmodel, params, block):
    return lambda: deepspeed_tpu.init_inference(
        model=jmodel, model_parameters=params,
        config={"inference": dict(block)})


def _port_factory(tmodel, block):
    return lambda: deepspeed_tpu_torch.init_inference(
        model=tmodel, config={"inference": dict(block)}, device="cpu")


def _prompts(n, seed=1):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, VOCAB, k)]
            for k in rng.integers(5, 12, n)]


def _shared_prefix_prompts():
    """Two templates of two pages (kv_block_size 4), three tails each."""
    rng = np.random.default_rng(11)
    heads = [[int(t) for t in rng.integers(0, VOCAB, 8)] for _ in range(2)]
    return [h + [int(t) for t in rng.integers(0, VOCAB, 3)]
            for h in heads for _ in range(3)]


COUNTS = ("fleet/requests_routed", "fleet/requests_completed",
          "fleet/requests_rerouted", "fleet/requests_rejected",
          "fleet/affinity_hits", "fleet/replicas_total",
          "fleet/replicas_available", "fleet/replicas_evicted",
          "fleet/breaker_opens", "fleet/zombie_restarts",
          "fleet/ttft_ms/count")


def _fleet_run(init_fleet, factory, prompts):
    router = init_fleet(
        engine_factory=factory,
        config={"serving": {"replicas": 2, "placement": "prefix_affinity",
                            "affinity_prefix_tokens": 8}})
    try:
        outs = []
        for p in prompts:  # one at a time: affinity sees each answer
            outs.append(router.submit(p, max_new_tokens=6).result(120.0))
        router.refresh_telemetry()
        snap = router.metrics.snapshot()
        return outs, {k: snap[k] for k in COUNTS}
    finally:
        router.shutdown()


def test_fleet_greedy_tokens_equal_the_jax_fleet(models):
    jmodel, params, tmodel = models
    prompts = _shared_prefix_prompts() + _prompts(2, seed=4)
    want = _fleet_run(deepspeed_tpu.init_fleet,
                      _jax_factory(jmodel, params, PAGED_BLOCK), prompts)
    got = _fleet_run(deepspeed_tpu_torch.init_fleet,
                     _port_factory(tmodel, PAGED_BLOCK), prompts)
    assert got == want
    assert want[1]["fleet/affinity_hits"] == 4


def test_rolling_restart_under_traffic_is_exactly_once(models):
    """test_serving.py's acceptance pin on the port: every request of
    eight concurrent clients is answered exactly once during a rolling
    restart of both replicas, with the JAX engine's greedy tokens, and
    routable capacity stays at or above the floor."""
    jmodel, params, tmodel = models
    prompts = _prompts(4, seed=3)
    single = _jax_factory(jmodel, params, ENGINE_BLOCK)()
    reference = single.generate(prompts, max_new_tokens=8)
    single.close()

    router = deepspeed_tpu_torch.init_fleet(
        engine_factory=_port_factory(tmodel, ENGINE_BLOCK),
        config={"serving": {"replicas": 2, "capacity_floor": 0.5}})
    available = router.metrics.gauge("fleet/replicas_available")
    floor_breached = []
    try:
        results, errors = {}, []

        def pump(i):
            try:
                req = router.submit(prompts[i % 4], max_new_tokens=8)
                results.setdefault(i, []).append(req.result(120.0))
            except Exception as e:  # pragma: no cover - failure detail
                errors.append((i, e))

        threads = [threading.Thread(target=pump, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        watching = threading.Event()

        def watch_floor():
            while not watching.is_set():
                if available.value < 1.0:
                    floor_breached.append(available.value)
                time.sleep(0.002)

        watcher = threading.Thread(target=watch_floor, daemon=True)
        watcher.start()
        router.rolling_restart(wait_timeout=60.0)
        for t in threads:
            t.join(120.0)
        watching.set()
        watcher.join(5.0)
        assert not errors, errors
        assert sorted(results) == list(range(8))
        for i, answers in results.items():
            assert answers == [reference[i % 4]]
        snap = router.metrics.snapshot()
        assert snap["fleet/replica_restarts"] == 2
        assert snap["fleet/requests_completed"] == 8
        assert snap["fleet/ttft_ms/count"] == 8
        assert snap["fleet/requests_rerouted"] == 0
        assert not floor_breached, floor_breached
    finally:
        router.shutdown()


def _brownout_trail(engine, set_brownout):
    """Serve a request sequence across brownout toggles; after each, the
    tokens, prefix hits and misses and registered pages."""
    a, b = _shared_prefix_prompts()[0], _shared_prefix_prompts()[3]
    trail = []
    for on, prompt in ((False, a), (True, b), (True, a[:8] + [1, 2]),
                       (False, b[:8] + [3, 4]), (False, b)):
        set_brownout(on)
        out = engine.generate([prompt], max_new_tokens=5)
        snap = engine.metrics.snapshot()
        trail.append((out, snap["infer/prefix_hits"],
                      snap["infer/prefix_misses"],
                      len(engine.block_pool._registry)))
    return trail


def test_brownout_skips_registration_as_the_jax_engine(models):
    jmodel, params, tmodel = models
    jengine = _jax_factory(jmodel, params, PAGED_BLOCK)()
    try:
        want = _brownout_trail(jengine, jengine.set_brownout)
    finally:
        jengine.close()
    replica = InProcessReplica("0", _port_factory(tmodel, PAGED_BLOCK))
    replica.start()
    try:
        got = _brownout_trail(replica.engine, replica.set_brownout)
    finally:
        replica.shutdown()
    assert got == want
    # under brownout the cold prompt registered nothing, the template's
    # hit still served, and after it a prefix of the unregistered prompt
    # missed
    assert want[1][3] == want[0][3] and want[1][2] > want[0][2]
    assert want[2][1] > want[1][1] and want[2][3] == want[1][3]
    assert want[3][2] > want[2][2] and want[3][3] > want[2][3]
