"""Port parity for the node agent (serving/node.py) and the provisioner
(serving/provisioner.py) against the JAX package's.

Each package's own ``NodeServer`` runs in a thread on stub engines:
epoch fencing on the control and data planes (``FencedOut`` with the
same text, epoch and high-water), ``spawn_replica``, ``retire_replica``
and ``node_info`` over ``NodeControlClient`` with the ``max_replicas``
refusal, and the ``node.crash`` and ``node.partition`` fault sites give
equal records.

One process: the port's ``LocalSubprocessProvisioner`` launches the
port's node agent (``python -m deepspeed_tpu_torch.serving.node``) on
the CPU with the JAX package's tiny GPT-2, converted and saved as a port
checkpoint; ``init_fleet``'s socket backend serves it, and the greedy
tokens must equal the JAX in-process engine's. ``terminate_node`` leaves
no process, the node logs its kernel launches at exit, and a failed
launch leaks none.
"""

import os
import signal
import socket

import jax
import numpy as np
import pytest

import deepspeed_tpu_torch
from deepspeed_tpu.serving import worker as jworker
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel, params_from_jax
from torch_fleet import (
    control,
    error_of,
    expected_answer,
    package,
    socket_replica,
    stub_node,
    wait,
)
from torch_test_env import jax_compile_cache  # noqa: F401


def _both():
    return package("jax"), package("torch")


def _addr(text, *nodes):
    for node in nodes:
        host, port = node.address
        text = text.replace(f"{host}:{port}", "ADDR")
    return text


def _fenced(P, node, epoch):
    """What a control dial at ``epoch`` raises: type, text, and the
    error's epoch and high-water."""
    try:
        control(P, node, epoch=epoch).node_info()
    except P.replica.FencedOut as e:
        return ("FencedOut", _addr(str(e), node), e.epoch, e.high_water)
    return None


def _info(reply):
    return {k: v for k, v in reply.items() if k != "id"}


def _fencing(P):
    node = stub_node(P)
    node.start()
    out = []
    try:
        out.append(_info(control(P, node, epoch=5).node_info()))
        out.append(_fenced(P, node, 3))
        out.append(_info(control(P, node, epoch=5).node_info()))
        out.append(_info(control(P, node, epoch=7).node_info()))
        out.append(_fenced(P, node, 5))
        # an epoch-less hello is never fenced
        out.append(_info(control(P, node).node_info()))
        # the data plane: a stale session is fenced at start and never
        # reconnects through the fence
        stale = socket_replica(P, node, epoch=6)
        got = error_of(stale.start)
        out.append((got[0], _addr(got[1], node), stale.fenced,
                    stale.failed))
        stale.shutdown()
        live = socket_replica(P, node, epoch=7)
        live.start()
        req = live.submit([3], max_new_tokens=3)
        out.append(("live", req.result(30.0), live.fenced))
        live.shutdown()
    finally:
        node.shutdown()
    return out


def _lifecycle(P):
    node = stub_node(P, ("r0",), max_replicas=2,
                     spawn_spec={"stub": {"delay_secs": 0.01}})
    node.start()
    out = []
    try:
        ctl = control(P, node)
        out.append(_info(ctl.node_info()))
        out.append(_info(ctl.spawn_replica("r1")))
        # the ceiling: a third engine is refused, typed
        got = error_of(lambda: ctl.spawn_replica("r2"))
        out.append((got[0], _addr(got[1], node)))
        got = error_of(lambda: ctl.spawn_replica("r1"))
        out.append((got[0], _addr(got[1], node)))
        # the spawned replica serves over its own session
        replica = socket_replica(P, node, "r1")
        replica.start()
        req = replica.submit([11], max_new_tokens=3)
        out.append(("spawned serves", req.result(30.0)))
        replica.shutdown()
        out.append(_info(ctl.retire_replica("r1")))
        got = error_of(lambda: ctl.retire_replica("r1"))
        out.append((got[0], _addr(got[1], node)))
        out.append(_info(ctl.node_info()))
        # a freed slot under the ceiling takes a spawn again
        out.append(_info(ctl.spawn_replica("r2")))
        out.append(sorted(node.engines))
    finally:
        node.shutdown()
    return out


class _OSProxy:
    """``os`` with ``kill`` recorded instead of delivered: node.crash
    would SIGKILL the test process otherwise."""

    def __init__(self, real):
        self._real = real
        self.kills = []

    def kill(self, pid, sig):
        self.kills.append((pid == os.getpid(), sig))

    def __getattr__(self, name):
        return getattr(self._real, name)


def _node_crash(P, monkeypatch):
    proxy = _OSProxy(os)
    monkeypatch.setattr(P.node, "os", proxy)
    node = stub_node(P, config={"resilience": {"fault_injection": {
        "enabled": True, "seed": 0,
        "faults": [{"site": "node.crash", "after": 1, "times": 1}],
    }}})
    node.start()
    try:
        first = _info(control(P, node).node_info())
        second = _info(control(P, node).node_info())
    finally:
        node.shutdown()
    return [first, second, proxy.kills]


def _node_partition(P):
    node = stub_node(P, config={"resilience": {"fault_injection": {
        "enabled": True, "seed": 0,
        "faults": [{"site": "node.partition", "times": 1}],
    }}})
    node.start()
    replica = socket_replica(P, node, rpc_timeout=0.5, rpc_retries=3)
    key = "internal/suppressed_errors/serving.node_partition_drop"
    before = P.registry.suppressed_errors_snapshot().get(key, 0)
    out = []
    try:
        replica.start()
        snap = replica.load_snapshot()
        out.append(("snapshot", snap["alive"], snap["failed"]))
        out.append(("drops", P.registry.suppressed_errors_snapshot().get(
            key, 0) - before))
        req = replica.submit([3], max_new_tokens=3)
        out.append(("result", req.result(30.0), replica.failed))
    finally:
        replica.shutdown()
        node.shutdown()
    return out


SCENARIOS = {
    "fencing": _fencing,
    "spawn_retire_node_info": _lifecycle,
    "node_partition": _node_partition,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_node_scenario_equals_the_jax_package(scenario):
    J, T = _both()
    assert SCENARIOS[scenario](T) == SCENARIOS[scenario](J)


def test_fencing_outcomes_are_right():
    out = _fencing(package("torch"))
    assert out[0] == {"event": "reply", "node": "n0", "replicas": ["r0"],
                      "epoch_high_water": 5}
    assert out[1][0] == "FencedOut" and out[1][2:] == (3, 5)
    assert "fenced out control epoch 3 (node high-water epoch 5)" in out[1][1]
    assert out[3]["epoch_high_water"] == 7
    assert out[4][2:] == (5, 7)
    assert out[6][0] == "FencedOut" and out[6][2:] == (True, True)
    assert out[7] == ("live", expected_answer([3], 3), False)


def test_spawn_retire_outcomes_are_right():
    out = _lifecycle(package("torch"))
    assert out[1]["replicas"] == ["r0", "r1"]
    assert out[2][0] == "RuntimeError"
    assert "at its max_replicas ceiling (2)" in out[2][1]
    assert "already hosts replica 'r1'" in out[3][1]
    assert out[4] == ("spawned serves", expected_answer([11], 3))
    assert out[5]["replicas"] == ["r0"]
    assert "hosts no replica 'r1'" in out[6][1]
    assert out[-1] == ["r0", "r2"]


def test_node_crash_site_equals_the_jax_package(monkeypatch):
    J, T = _both()
    ref = _node_crash(J, monkeypatch)
    got = _node_crash(T, monkeypatch)
    assert got == ref
    assert got[2] == [(True, signal.SIGKILL)]


def test_node_engine_defaults_to_the_gpu():
    """A real engine spec without ``"device"`` serves on the GPU: on a
    host without one the node refuses to start instead of serving the
    plain versions on the CPU."""
    T = package("torch")
    if __import__("torch").cuda.is_available():
        pytest.skip("a GPU is present: the default builds there")
    node = T.node.NodeServer({"replicas": {"r0": {"model": MODEL_KW}}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node.start()
    node.shutdown()


# ---------------------------------------------------------------------------
# the port's node agent in a process, serving a real GPT-2 on the CPU
# ---------------------------------------------------------------------------
MODEL_KW = {"vocab_size": 64, "n_positions": 32, "n_embd": 16, "n_layer": 1,
            "n_head": 2}
ENGINE_BLOCK = {"max_batch_slots": 2, "max_seq_len": 24, "prefill_len": 8,
                "sampling": {"greedy": True}}


def _save_port_checkpoint(params, path):
    """A port checkpoint of ``params`` (the training engine's save)."""
    model = GPT2LMHeadModel(GPT2Config(**MODEL_KW, dropout=0.0),
                            device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params,
        config_params={"train_batch_size": 1,
                       "optimizer": {"type": "SGD", "params": {"lr": 0.0}}},
        device="cpu")
    engine.save_checkpoint(str(path))


def test_provisioned_port_node_serves_the_jax_engines_tokens(tmp_path,
                                                             capfd):
    T = package("torch")
    jspec = {"model": dict(MODEL_KW, use_flash=False), "init_seed": 0,
             "config": {"inference": ENGINE_BLOCK}}
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 64, 6)] for _ in range(3)]
    local = jworker.build_engine_from_spec(jspec)
    reference = local.generate(prompts, max_new_tokens=5)
    params = params_from_jax(jax.device_get(local.params))
    local.close()
    _save_port_checkpoint(params, tmp_path)

    engine_spec = {"model": MODEL_KW, "device": "cpu",
                   "config": {"inference": dict(
                       ENGINE_BLOCK, checkpoint={"load_dir": str(tmp_path)})}}
    prov = T.provisioner.LocalSubprocessProvisioner(
        {"replicas": {"r0": engine_spec}, "lease_secs": 10.0,
         "resume_grace_secs": 10.0},
        launch_timeout=120.0, terminate_grace=10.0, epoch=3)
    handle = prov.launch_node("pn0")
    try:
        assert handle.proc.args[:3] == [
            handle.proc.args[0], "-m", "deepspeed_tpu_torch.serving.node"]
        info = control(T, handle.address, timeout=30.0).node_info()
        assert info["node"] == "pn0" and info["replicas"] == ["r0"]
        assert info["epoch_high_water"] == 3
        host, port = handle.address
        router = deepspeed_tpu_torch.init_fleet(
            nodes={"pn0": {"address": f"{host}:{port}",
                           "replicas": ["r0"]}},
            config={"serving": {"backend": "socket"}})
        try:
            reqs = [router.submit(p, max_new_tokens=5) for p in prompts]
            assert [r.result(120.0) for r in reqs] == reference
            assert all(r.finish_reason == "max_new_tokens" for r in reqs)
            assert router.metrics.snapshot()[
                "fleet/requests_completed"] == len(prompts)
        finally:
            router.shutdown()
    finally:
        prov.terminate_node("pn0")
        prov.close()
    assert handle.proc.poll() is not None
    assert prov.list_nodes() == {}
    # the node's log (its stderr, the test's fd 2) ends with its kernel
    # launches: none on the CPU, where the wrappers run the plain versions
    err = capfd.readouterr().err
    assert ('node: kernel launches {"flash_fwd": 0, "paged_decode": 0, '
            '"sgmv": 0}') in err


def test_failed_launch_leaks_no_process():
    T = package("torch")
    prov = T.provisioner.LocalSubprocessProvisioner(launch_timeout=60.0)
    launched = []
    real_popen = T.provisioner.subprocess.Popen

    def popen(*args, **kw):
        proc = real_popen(*args, **kw)
        launched.append(proc)
        return proc

    T.provisioner.subprocess.Popen = popen
    try:
        # an empty replicas map with no spawn_spec is refused by the agent
        # before it announces: the launch fails typed and cleans up
        with pytest.raises(T.provisioner.ProvisionFailed,
                           match="exited before announcing"):
            prov.launch_node("broken", spec={"replicas": {}})
    finally:
        T.provisioner.subprocess.Popen = real_popen
    assert prov.list_nodes() == {}
    assert len(launched) == 1 and launched[0].poll() is not None
    assert "deepspeed_tpu_torch.serving.node" in launched[0].args
    # nothing listens where a node would have
    assert wait(lambda: launched[0].returncode is not None, 5.0)
    prov.close()


def test_static_provisioner_equals_the_jax_package():
    """The fork-free provisioner: a confirm dial stamps the epoch, a
    second dial below it is fenced, terminate forgets, and the typed
    refusals read the same."""
    out = {}
    for P in _both():
        node = stub_node(P, node_id="ext0")
        node.start()
        rec = []
        try:
            prov = P.provisioner.StaticProvisioner({"ext0": node.address},
                                                   epoch=4)
            handle = prov.launch_node("ext0")
            rec.append((handle.name, handle.alive, list(prov.list_nodes())))
            rec.append(_fenced(P, node, 3))
            prov.terminate_node("ext0")
            rec.append((prov.list_nodes(), error_of(
                lambda: prov.terminate_node("ext0"))))
            ghost = P.provisioner.StaticProvisioner(confirm_timeout=0.5)
            rec.append(error_of(lambda: ghost.launch_node("ghost")))
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()
            s.close()
            ghost.register("deadbeat", dead)
            got = error_of(lambda: ghost.launch_node("deadbeat"))
            rec.append((got[0], got[1].replace(str(dead), "ADDR")[:60]))
        finally:
            node.shutdown()
        out[P.name] = rec
    assert out["torch"] == out["jax"]
    assert out["torch"][1][0] == "FencedOut"
