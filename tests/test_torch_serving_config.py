"""Port parity for the fleet's ``serving`` config block: every key's
default and every rejection of ``_check_serving``, error text included,
deepspeed_tpu_torch's DeepSpeedConfig against deepspeed_tpu's.

Each case feeds both parsers the same config. Both must refuse it with
the same message, or both accept it with equal ``serving_*``
attributes. The bad values walk every key of the block (each sub-block's
unknown keys included), and the cross-key cases cover the rules that
relate two keys.
"""

import pytest

from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.config.config import DeepSpeedConfigError as JError
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from torch_test_env import jax_compile_cache  # noqa: F401

# the block's keys: a sub-block maps to its own keys, a leaf to None
TREE = {
    "replicas": None, "backend": None, "placement": None,
    "affinity_prefix_tokens": None, "capacity_floor": None,
    "shed_queue_ratio": None, "max_reroutes": None,
    "drain_on_preemption": None,
    "rate_limit": {"requests_per_sec": None, "burst": None,
                   "per_tenant": None},
    "rpc_timeout_secs": None, "rpc_retries": None,
    "rpc_backoff_secs": None, "zombie_secs": None,
    "zombie_restart_budget": None,
    "circuit_breaker": {"failure_threshold": None, "backoff_secs": None,
                        "backoff_max_secs": None},
    "brownout": {"queue_ratio": None, "max_new_tokens": None},
    "socket": {"lease_secs": None, "reconnect_attempts": None,
               "reconnect_backoff_secs": None,
               "connect_timeout_secs": None, "connect_retries": None},
    "http": {"host": None, "port": None, "max_buffer_bytes": None,
             "overrun_policy": None, "auth_token": None},
    "slo": {"ttft_p99_ms": None, "token_p99_ms": None,
            "eval_window_secs": None},
    "autoscale": {"enabled": None, "min_replicas": None,
                  "max_replicas": None, "cooldown_secs": None,
                  "hysteresis_secs": None, "flap_budget": None,
                  "flap_window_secs": None, "scale_up_utilization": None,
                  "scale_down_utilization": None, "interval_secs": None,
                  "drain_timeout_secs": None},
    "hub": {"enabled": None, "interval_secs": None,
            "retention_points": None, "drain_interval_secs": None,
            "op_timeout_secs": None, "node_backoff_secs": None,
            "auth_exempt": None,
            "alerts": {"slo_target": None, "fast_window_secs": None,
                       "slow_window_secs": None, "fast_burn": None,
                       "slow_burn": None, "breaker_flood": None,
                       "suppressed_growth": None}},
    "journal": {"enabled": None, "dir": None, "fsync": None,
                "keep_segments": None, "max_inflight": None},
    "provisioner": {"enabled": None, "node_spec": None, "max_nodes": None,
                    "max_replicas_per_node": None,
                    "launch_timeout_secs": None,
                    "terminate_grace_secs": None},
}

# what each key is tried with: wrong types, signs, bounds and members
BAD_VALUES = (-1, 0, 0.5, 1, 2.5, 10 ** 9, "x", "", True, False, None,
              [], ["/metrics"], ["/nope"], {"t": {"burst": 0}},
              {"t": {"nope": 1}}, {"t": 3}, {"x": 1})


def _leaves(tree, path=()):
    for key, sub in tree.items():
        if sub is None:
            yield path + (key,)
        else:
            yield from _leaves(sub, path + (key,))


def _blocks(tree, path=()):
    yield path
    for key, sub in tree.items():
        if sub is not None:
            yield from _blocks(sub, path + (key,))


def _nest(path, value):
    block = value
    for key in reversed(path):
        block = {key: block}
    return block


def _outcome(cls, err, serving):
    """(``"error"``, message), (the exception's type, message) where the
    parser fails before its checks, or (``"ok"``, the ``serving_*``
    attributes)."""
    try:
        cfg = cls(None, param_dict={"train_batch_size": 1,
                                    "serving": serving}, world_size=1)
    except err as e:
        return "error", str(e)
    except (TypeError, ValueError) as e:
        return type(e).__name__, str(e)
    attrs = {k: v for k, v in vars(cfg).items()
             if k.startswith("serving_")}
    attrs["serving_http_auth_token"] = cfg.serving_http_auth_token
    return "ok", attrs


def _same(serving):
    want = _outcome(JConfig, JError, serving)
    got = _outcome(DeepSpeedConfig, DeepSpeedConfigError, serving)
    assert got == want, serving
    return want


def test_every_default_equals_the_jax_parsers():
    kind, attrs = _same({})
    assert kind == "ok"
    # every leaf of the block has its attribute in both parsers
    assert len(attrs) >= len(list(_leaves(TREE)))


@pytest.mark.parametrize("path", [".".join(p) for p in _leaves(TREE)])
def test_every_bad_value_of_a_key_is_refused_alike(path):
    refused = 0
    for value in BAD_VALUES:
        kind, _ = _same(_nest(path.split("."), value))
        refused += kind == "error"
    # every key of the block refuses some value
    assert refused > 0, path


@pytest.mark.parametrize("path", [".".join(p) or "serving"
                                  for p in _blocks(TREE)])
def test_unknown_keys_of_a_block_are_refused_alike(path):
    keys = [] if path == "serving" else path.split(".")
    kind, message = _same(_nest(keys, {"no_such_key": 1}))
    if keys:  # the top level takes what it does not know, as in JAX
        assert kind == "error" and "no_such_key" in message


CROSS_KEY_CASES = {
    "backoff_max_below_backoff": {"circuit_breaker": {
        "backoff_secs": 2.0, "backoff_max_secs": 1.0}},
    "brownout_at_shed_ratio": {"shed_queue_ratio": 0.5,
                               "brownout": {"queue_ratio": 0.5}},
    "brownout_above_shed_ratio": {"shed_queue_ratio": 0.5,
                                  "brownout": {"queue_ratio": 0.7}},
    "brownout_in_band": {"shed_queue_ratio": 0.8,
                         "brownout": {"queue_ratio": 0.5,
                                      "max_new_tokens": 4}},
    "autoscale_min_above_max": {"autoscale": {"min_replicas": 4,
                                              "max_replicas": 2}},
    "autoscale_bands_overlap": {"autoscale": {
        "scale_up_utilization": 0.5, "scale_down_utilization": 0.6}},
    "alerts_fast_window_at_slow": {"hub": {"alerts": {
        "fast_window_secs": 60.0, "slow_window_secs": 60.0}}},
    "per_tenant_inherits_default": {"rate_limit": {
        "requests_per_sec": 5.0, "burst": 2,
        "per_tenant": {"a": {"burst": 3}, "b": {}}}},
    "per_tenant_bad_rps": {"rate_limit": {
        "per_tenant": {"a": {"requests_per_sec": -1}}}},
    "capacity_floor_one": {"capacity_floor": 1.0},
    "auth_token_empty": {"http": {"auth_token": ""}},
    "provisioner_without_spec": {"provisioner": {"enabled": True}},
    "provisioner_spec": {"provisioner": {"enabled": True,
                                         "node_spec": {"replicas": {}}}},
    "journal_armed": {"journal": {"enabled": True, "dir": "j",
                                  "fsync": False}},
    "hub_exempt_tuple": {"hub": {"auth_exempt": ("/statz",)}},
    "every_armed_block": {
        "replicas": 3, "backend": "subprocess",
        "placement": "adapter_affinity", "autoscale": {"enabled": True},
        "hub": {"enabled": True}, "slo": {"ttft_p99_ms": 100.0}},
}


@pytest.mark.parametrize("case", sorted(CROSS_KEY_CASES))
def test_cross_key_rules_equal_the_jax_parsers(case):
    _same(CROSS_KEY_CASES[case])


def test_the_walk_reaches_every_rejection_site():
    """The cases above reach every distinct rejection of the JAX
    ``_check_serving`` (by the source line that raises it)."""
    import inspect
    import sys
    import traceback

    check = JConfig._check_serving
    first = check.__code__.co_firstlineno
    lines, _ = inspect.getsourcelines(check)
    sites = {first + i for i, line in enumerate(lines)
             if "raise DeepSpeedConfigError" in line}
    hit = set()

    def record(serving):
        try:
            JConfig(None, param_dict={"train_batch_size": 1,
                                      "serving": serving}, world_size=1)
        except JError:
            tb = traceback.extract_tb(sys.exc_info()[2])
            hit.add(next(f.lineno for f in reversed(tb)
                         if f.name == "_check_serving"))
        except TypeError:
            pass  # refused while the parser reads the block

    for path in _leaves(TREE):
        for value in BAD_VALUES:
            record(_nest(path, value))
    for path in _blocks(TREE):
        if path:
            record(_nest(path, {"no_such_key": 1}))
    for serving in CROSS_KEY_CASES.values():
        record(serving)
    assert sites - hit == set(), sorted(sites - hit)


def _fleet_outcome(P, case, tmp_path):
    """What ``init_fleet`` of package ``P`` does with the case's config:
    ``(error type, text)``, or what the fleet it built serves on stub
    engines (the replicas, the armed parts, one answer)."""
    from torch_fleet import host_engine, stub_node

    node = None

    def factory():
        return host_engine(P)

    sources = {"engine_factory": factory}
    serving = {"backend": "socket"} if case == "socket" else {}
    if case == "nodes":
        node = stub_node(P, delay=0.0)
        node.start()
        host, port = node.address
        sources = {"nodes": {"n0": {"address": f"{host}:{port}",
                                    "replicas": ["r0"]}}}
        serving = {"backend": "socket"}
    elif case != "socket":
        serving = {case: {"enabled": True}}
        if case == "journal":
            serving[case]["dir"] = str(tmp_path / P.name)
    router = None
    try:
        router = P.serving.init_fleet(
            config={"train_batch_size": 1, "serving": serving}, **sources)
        return (type(router).__name__, sorted(router.replica_ids),
                router._journal is not None, router._autoscaler is not None,
                router.hub is not None,
                router.submit([3], max_new_tokens=2).result(30.0))
    except Exception as e:  # noqa: BLE001 - the comparison is the point
        return type(e).__name__, str(e)
    finally:
        if router is not None:
            router.shutdown()
        if node is not None:
            node.shutdown()


@pytest.mark.parametrize("case", ["socket", "nodes", "journal", "autoscale",
                                  "hub"])
def test_init_fleet_refuses_the_networked_fleet_naming_a8b(case, tmp_path):
    """The socket backend and the journal, autoscaler and hub blocks (the
    networked fleet, ROADMAP A8b) are ported: each config does in
    init_fleet what it does in the JAX package's, the same error (the
    socket backend without a nodes map) or a fleet that builds and
    serves on stub engines with the same parts armed."""
    from torch_fleet import package

    got = _fleet_outcome(package("torch"), case, tmp_path)
    assert got == _fleet_outcome(package("jax"), case, tmp_path)
    if case == "socket":
        assert got[0] == "ValueError" and "nodes was not passed" in got[1]
    else:
        assert got[0] == "FleetRouter" and got[-1] == [4, 5]
        armed = {"journal": 2, "autoscale": 3, "hub": 4}.get(case)
        if armed is not None:
            assert got[armed] is True
        assert "A8b" not in repr(got)


def test_serving_over_a_data_axis_names_a8c():
    """Serving over a data axis (ROADMAP A8c) builds its mesh as the JAX
    engine does, from the block's data and model sizes alone: a data size
    that does not cover the world is refused with the JAX engine's
    ``ValueError`` (its world the 8 CPU devices, the port's this one
    process), and a sequence or pipe size in the block is not read (both
    engines serve, with equal greedy tokens)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import deepspeed_tpu
    import deepspeed_tpu_torch
    from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch import params_from_jax

    sizes = dict(vocab_size=32, n_positions=16, n_embd=8, n_layer=1,
                 n_head=2, dropout=0.0)
    jmodel = JGPT2LMHeadModel(JGPT2Config(**sizes, use_flash=False))
    ids = jnp.zeros((1, 4), jnp.int32)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0)}, ids, ids)["params"])
    model = GPT2LMHeadModel(GPT2Config(**sizes), device="cpu")
    model.load_state_dict(params_from_jax(params))
    inference = {"max_batch_slots": 1, "max_seq_len": 8,
                 "sampling": {"greedy": True}}
    with pytest.raises(ValueError, match="covers 2 devices but 8 are "
                                         "available"):
        deepspeed_tpu.init_inference(
            model=jmodel, model_parameters=params,
            config={"inference": inference,
                    "mesh": {"data_parallel_size": 2}})
    with pytest.raises(ValueError, match="covers 2 devices but 1 are "
                                         "available"):
        deepspeed_tpu_torch.init_inference(
            model=model, device="cpu",
            config={"inference": inference,
                    "mesh": {"data_parallel_size": 2}})
    for block in ({"sequence_parallel_size": 2},
                  {"pipeline_parallel_size": 2}):
        cfg = {"inference": inference, "mesh": block}
        jengine = deepspeed_tpu.init_inference(
            model=jmodel, model_parameters=params, config=dict(cfg))
        engine = deepspeed_tpu_torch.init_inference(
            model=model, device="cpu", config=dict(cfg))
        try:
            assert engine.mesh is None and engine.is_leader
            assert engine.generate([[3, 1, 4]], max_new_tokens=4) == (
                jengine.generate([[3, 1, 4]], max_new_tokens=4))
        finally:
            engine.close()
            jengine.close()
