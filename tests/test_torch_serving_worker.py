"""Port parity for the replica worker: the newline-JSON protocol frame by
frame, and a worker process serving a real GPT-2.

The protocol: each package's ``WorkerServer`` drives its own
``StubWorkerEngine`` through one op script (init, a streamed submit, a
snapshot, a metrics scrape, an adapter op the stub lacks, a cancel, a
drain and a refused submit, shutdown). The frames answering each op must
equal the JAX package's.

The process: ``init_fleet``'s subprocess backend starts one port worker
(``python -m deepspeed_tpu_torch.serving.worker``) on the CPU (the
spec's ``"device": "cpu"``), which serves the JAX package's tiny GPT-2
from a port checkpoint of its converted parameters; its greedy tokens
must equal the JAX in-process engine's, shutdown reaps the process, and
its log reports no kernel launch (the CPU runs the plain versions).
"""

import json
import queue
import threading
import time

import jax
import numpy as np

import deepspeed_tpu_torch
from deepspeed_tpu.serving import worker as jworker
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel, params_from_jax
from deepspeed_tpu_torch.serving import worker as tworker
from torch_test_env import jax_compile_cache  # noqa: F401


class _ChanIn:
    """Blocking line source driving WorkerServer.run like a real pipe."""

    def __init__(self):
        self._q = queue.Queue()

    def send(self, msg):
        self._q.put(json.dumps(msg) + "\n")

    def close(self):
        self._q.put(None)

    def __iter__(self):
        while True:
            line = self._q.get()
            if line is None:
                return
            yield line


class _ChanOut:
    """Collects protocol frames; the script waits on their arrival."""

    def __init__(self):
        self.frames = []
        self._cond = threading.Condition()

    def write(self, text):
        with self._cond:
            self.frames.append(json.loads(text))
            self._cond.notify_all()

    def flush(self):
        pass

    def wait_for(self, predicate, timeout=10.0):
        deadline = time.monotonic() + timeout
        with self._cond:
            while not any(predicate(m) for m in self.frames):
                remaining = deadline - time.monotonic()
                assert remaining > 0, f"no matching frame in {self.frames}"
                self._cond.wait(remaining)


def _is(event, rpc_id):
    return lambda m: m.get("event") == event and m.get("id") == rpc_id


def _script(module, stub, hang_stub):
    """Run the op script through ``module``'s WorkerServer over its own
    StubWorkerEngine (``stub``, then ``hang_stub`` for the cancel);
    returns the frames grouped by op, each group in a canonical order
    (the watch thread and the op loop interleave)."""
    groups, code = [], []
    stdin = stdout = thread = None

    def serve():
        nonlocal stdin, stdout, thread
        stdin, stdout = _ChanIn(), _ChanOut()
        server = module.WorkerServer(stdin, stdout,
                                     module.build_engine_from_spec,
                                     poll_interval=0.001)
        thread = threading.Thread(target=lambda: code.append(server.run()),
                                  daemon=True)
        thread.start()

    def shutdown():
        stdin.send({"op": "shutdown"})
        thread.join(10.0)
        assert not thread.is_alive()

    def step(msg, *waits):
        start = len(stdout.frames)
        stdin.send(msg)
        for pred in waits:
            stdout.wait_for(pred)
        time.sleep(0.02)  # frames that trail the awaited one
        groups.append(sorted((json.dumps(m, sort_keys=True)
                              for m in stdout.frames[start:])))

    serve()
    step({"op": "init", "proto": 1, "spec": {"stub": stub,
                                             "replica_id": "w0"}},
         lambda m: m.get("event") == "ready")
    step({"op": "submit", "id": 1, "prompt": [10, 20], "max_new_tokens": 3},
         _is("reply", 1), _is("finished", 1))
    step({"op": "snapshot", "id": 2}, _is("reply", 2))
    step({"op": "metrics_snapshot", "id": 3}, _is("reply", 3))
    step({"op": "load_adapter", "id": 4, "name": "a"}, _is("reply", 4))
    step({"op": "brownout", "on": True})
    step({"op": "submit", "id": 6, "prompt": [], "max_new_tokens": 2},
         _is("reply", 6), _is("finished", 6))
    step({"op": "drain"})
    step({"op": "submit", "id": 7, "prompt": [3], "max_new_tokens": 2},
         _is("reply", 7))
    step({"op": "no_such_op"})
    shutdown()
    serve()
    step({"op": "init", "proto": 1, "spec": {"stub": hang_stub}},
         lambda m: m.get("event") == "ready")
    step({"op": "submit", "id": 5, "prompt": [7], "max_new_tokens": 50},
         _is("reply", 5))
    step({"op": "snapshot", "id": 8}, _is("reply", 8))
    step({"op": "cancel", "id": 5}, _is("finished", 5))
    shutdown()
    return groups, code


def test_worker_protocol_frames_equal_jax():
    stub = {"delay_secs": 0.0, "token_delay_secs": 0.002}
    hang = {"hang": True}
    want, want_code = _script(jworker, stub, hang)
    got, got_code = _script(tworker, stub, hang)
    assert got == want
    assert got_code == want_code == [0, 0]
    # the streamed submit's frames: the ack, first_token, one token
    # event per token and the finish
    events = [json.loads(f)["event"] for f in want[1]]
    assert sorted(events) == ["finished", "first_token", "reply", "token",
                              "token", "token"]


# ---------------------------------------------------------------------------
# a worker process serving a real GPT-2 on the CPU
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


def test_subprocess_worker_serves_the_jax_engines_tokens(tmp_path, capfd):
    jspec = {"model": dict(MODEL_KW, use_flash=False), "init_seed": 0,
             "config": {"inference": ENGINE_BLOCK}}
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 64, 6)] for _ in range(2)]
    local = jworker.build_engine_from_spec(jspec)
    reference = local.generate(prompts, max_new_tokens=5)
    params = params_from_jax(jax.device_get(local.params))
    local.close()
    _save_port_checkpoint(params, tmp_path)

    spec = {"model": MODEL_KW, "device": "cpu",
            "config": {"inference": dict(
                ENGINE_BLOCK, checkpoint={"load_dir": str(tmp_path)})}}
    router = deepspeed_tpu_torch.init_fleet(
        worker_spec=spec,
        config={"serving": {"backend": "subprocess", "replicas": 1}})
    replica = router._replicas["0"]
    proc = replica._proc
    try:
        snap = replica.load_snapshot()
        assert snap["alive"] and not snap["failed"]
        reqs = [router.submit(p, max_new_tokens=5) for p in prompts]
        assert [r.result(120.0) for r in reqs] == reference
        assert all(r.finish_reason == "max_new_tokens" for r in reqs)
    finally:
        router.shutdown()
    assert not replica.alive and not replica.failed
    assert proc.poll() is not None  # reaped
    # the worker's log (its stderr, the test's fd 2) ends with its kernel
    # launches: none on the CPU, where the wrappers run the plain versions
    assert ('worker: kernel launches {"flash_fwd": 0, "paged_decode": 0, '
            '"sgmv": 0}') in capfd.readouterr().err
