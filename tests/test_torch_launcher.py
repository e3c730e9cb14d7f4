"""The port's launcher (launcher/runner.py, launcher/launch.py) against the
JAX package's, and a training run started through it.

- The hostfile, the include/exclude filters, the world info and the node
  rank: the non-TPU cases of tests/unit/test_run.py, run through both
  packages' functions and compared output for output (or error for
  error).
- One process per GPU slot: the per-child environment across hosts of 2
  and 3 slots and under an ``--include host:1,3`` filter (global ranks,
  ``LOCAL_RANK``, ``CUDA_VISIBLE_DEVICES``), and ``init_distributed``
  binding ``cuda:<LOCAL_RANK>``.
- ``python -m deepspeed_tpu_torch.launcher.runner --num_gpus 2`` on the
  CPU: two gloo ranks of the 2-layer GPT-2 of tests/torch_dp_gpt2.py at
  dp 2, ZeRO stage 2, whose losses and parameters equal the JAX engine's
  at dp 2 (rtol 2e-4, atol 1e-5, as tests/test_torch_zero_gpt2.py); a
  rank that exits 3 ends its sibling and the runner exits 3; a SIGTERM
  to the runner reaches both ranks, which drain into one checkpoint.
"""

import base64
import collections
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import pytest
import torch

import torch_dp_gpt2 as g
import torch_dp_ranks as ranks
from deepspeed_tpu.launcher import launch as jlaunch
from deepspeed_tpu.launcher import runner as jrunner
from deepspeed_tpu_torch import params_from_jax
from deepspeed_tpu_torch.config import constants as tconstants
from deepspeed_tpu_torch.launcher import launch as tlaunch
from deepspeed_tpu_torch.launcher import runner as trunner
from deepspeed_tpu_torch.runtime import dist as tdist
from torch_test_env import jax_compile_cache  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "tests" / "torch_launched.py"


# ---------------------------------------------------------------------------
# the runner's functions, both packages
# ---------------------------------------------------------------------------
def _outcome(fn, *args):
    """``("ok", result)`` or ``("error", class, message)``."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the class and message are the outcome
        return ("error", type(e).__name__, str(e))


HOSTFILES = {
    "good": "worker-0 slots=4\nworker-1 slots=2\n\n# comment\n",
    "bad_format": "worker-0 4\n",
    "duplicate": "w0 slots=4\nw0 slots=4\n",
}


@pytest.mark.parametrize("text", list(HOSTFILES) + ["missing"])
def test_fetch_hostfile_matches_the_jax_runner(tmp_path, text):
    path = tmp_path / "hostfile"
    if text != "missing":
        path.write_text(HOSTFILES[text])
    assert (_outcome(trunner.fetch_hostfile, str(path))
            == _outcome(jrunner.fetch_hostfile, str(path)))


def _pool(**kw):
    return collections.OrderedDict(kw)


FILTERS = [
    (dict(w0=4, w1=4), "w0@w1:0,2", ""),
    (dict(w0=4, w1=4), "", "w1:0"),
    (dict(w0=2, w1=2), "", "w1"),
    (dict(w0=2), "w0", "w0"),
    (dict(w0=2), "w9", ""),
    (dict(w0=2), "w0:7", ""),
    (dict(a=2, b=2, c=2), "c@a", ""),
    (dict(a=2, b=3), "b:1,2", ""),
]


@pytest.mark.parametrize("pool,include,exclude", FILTERS)
def test_filters_match_the_jax_runner(pool, include, exclude):
    args = (_pool(**pool), include, exclude)
    got = _outcome(trunner.parse_inclusion_exclusion, *args)
    assert got == _outcome(jrunner.parse_inclusion_exclusion, *args)
    if got[0] == "ok":
        assert list(got[1]) == list(
            jrunner.parse_inclusion_exclusion(*args))


@pytest.mark.parametrize("info", [{"w0": [0, 1], "w1": [2]}, {},
                                  {"localhost": []}])
def test_world_info_matches_the_jax_runner(info):
    enc = trunner.encode_world_info(info)
    assert enc == jrunner.encode_world_info(info)
    assert tlaunch.decode_world_info(enc) == info
    assert json.loads(base64.urlsafe_b64decode(enc)) == info


def test_node_rank_matches_the_jax_launcher():
    class Numeric:
        node_rank = "1"

    class Token:
        node_rank = "%n"  # pdsh's token never substituted -> hostname

    info = {"hostA": [0], "hostB": [0]}
    here = {socket.gethostname(): [0], "other": [0]}
    assert tlaunch.resolve_node_rank(Numeric, info) == 1
    assert (tlaunch.resolve_node_rank(Token, here)
            == jlaunch.resolve_node_rank(Token, here) == 0)
    assert (_outcome(tlaunch.resolve_node_rank, Token, info)
            == _outcome(jlaunch.resolve_node_rank, Token, info))


def test_the_defaults_and_exports_are_the_gpu_runners():
    assert tconstants.TORCH_DISTRIBUTED_DEFAULT_PORT == 29500
    assert trunner.EXPORT_PREFIXES == ["NCCL", "PYTHON", "DS_TPU"]
    args = trunner.parse_args(["train.py", "--lr", "1"])
    assert args.master_port == 29500 and args.user_args == ["--lr", "1"]
    with pytest.raises(SystemExit):
        trunner.parse_args(["--tpu", "pod", "train.py"])


# ---------------------------------------------------------------------------
# one process per slot
# ---------------------------------------------------------------------------
class _Args:
    master_addr = "10.0.0.1"
    master_port = 29501


def test_per_slot_env_across_hosts_of_2_and_3_slots():
    info = {"h0": [0, 1], "h1": [0, 1, 2]}
    envs = tlaunch.build_envs(_Args, info, 1)
    assert [e["RANK"] for e in envs] == ["2", "3", "4"]
    assert [e["DS_TPU_PROCESS_ID"] for e in envs] == ["2", "3", "4"]
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1", "2"]
    for e in envs:
        assert e["WORLD_SIZE"] == e["DS_TPU_NUM_PROCESSES"] == "5"
        assert e["CUDA_VISIBLE_DEVICES"] == "0,1,2"
        assert e["DS_TPU_COORDINATOR_ADDRESS"] == "10.0.0.1:29501"
        assert (e["MASTER_ADDR"], e["MASTER_PORT"]) == ("10.0.0.1", "29501")
    assert [e["RANK"] for e in tlaunch.build_envs(_Args, info, 0)] == [
        "0", "1"]


def test_per_slot_env_under_an_include_filter():
    pool = trunner.parse_inclusion_exclusion(
        _pool(h0=2, h1=4), "h0@h1:1,3", "")
    info = json.loads(base64.urlsafe_b64decode(
        trunner.encode_world_info(dict(pool))))
    envs = tlaunch.build_envs(_Args, info, 1)
    assert [e["RANK"] for e in envs] == ["2", "3"]
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1"]
    assert {e["CUDA_VISIBLE_DEVICES"] for e in envs} == {"1,3"}
    assert {e["WORLD_SIZE"] for e in envs} == {"4"}


def test_a_host_without_slots_runs_one_process():
    envs = tlaunch.build_envs(_Args, {"localhost": []}, 0)
    assert len(envs) == 1 and envs[0]["WORLD_SIZE"] == "1"
    assert envs[0]["LOCAL_RANK"] == "0"


def test_local_slots_follow_cuda_visible_devices(monkeypatch):
    """Without a hostfile the slots are the devices CUDA_VISIBLE_DEVICES
    lists, which the launch exports again for its children."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert trunner._visible_slots(2) == [2, 3]
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert trunner._visible_slots(2) == [0, 1]


def test_init_distributed_binds_the_local_rank(monkeypatch):
    bound, joined = [], []
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tdist.dist, "init_process_group",
                        lambda **kw: joined.append(kw))
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    monkeypatch.setenv("DS_TPU_COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("DS_TPU_NUM_PROCESSES", "8")
    monkeypatch.setenv("DS_TPU_PROCESS_ID", "5")
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert tdist.init_distributed(device="cuda")
    # the global rank 5 would have taken 5 % 4 = 1
    assert bound == [2]
    assert joined[0]["backend"] == "nccl" and joined[0]["rank"] == 5
    monkeypatch.delenv("LOCAL_RANK")
    assert tdist.local_device_index(5) == 1


def test_the_bootstrap_names_the_ports_runner(monkeypatch):
    monkeypatch.delenv("DS_TPU_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("DS_TPU_NUM_PROCESSES", "2")
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError,
                       match="deepspeed_tpu_torch.launcher.runner"):
        tdist.init_distributed(dist_init_required=True)


# ---------------------------------------------------------------------------
# runs through the runner
# ---------------------------------------------------------------------------
def _runner(workdir, mode, *extra):
    """The runner's command line for ``torch_launched.py --mode``."""
    return [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
            "--hostfile", str(workdir / "absent"), "--num_gpus", "2",
            "--master_port", str(ranks.free_port()), str(SCRIPT),
            "--mode", mode, "--workdir", str(workdir), *extra]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DS_TPU_", "LOCAL_RANK", "RANK",
                                "WORLD_SIZE", "MASTER_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(workdir, mode, *extra):
    workdir.mkdir(parents=True, exist_ok=True)
    log = open(workdir / "runner.log", "w")
    return subprocess.Popen(_runner(workdir, mode, *extra), env=_env(),
                            cwd=str(ROOT), stdout=log,
                            stderr=subprocess.STDOUT), log


def _wait(proc, log, timeout):
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    return proc.returncode


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The training run and the failing run, started through the runner
    together, beside the JAX engine's dp-2 oracle."""
    model, params = g.jmodel()
    train_dir = tmp_path_factory.mktemp("launched_train")
    torch.save(params_from_jax(jax.device_get(params)),
               train_dir / "gpt2.pt")
    cfg = ranks.config(2, "Adam", "fp32", g.MICRO, g.ACCUM, 2, lr=g.LR)
    (train_dir / "ds.json").write_text(json.dumps(cfg))
    train = _start(train_dir, "train", "--steps", str(g.STEPS),
                   "--deepspeed", "--deepspeed_config",
                   str(train_dir / "ds.json"))
    fail_dir = tmp_path_factory.mktemp("launched_fail")
    started = time.monotonic()
    fail = _start(fail_dir, "fail")
    oracle = g.jax_run(params, 2, "adam", 2)
    fail_rc = _wait(*fail, timeout=120)
    fail_secs = time.monotonic() - started
    train_rc = _wait(*train, timeout=240)
    got = [torch.load(train_dir / f"rank{r}.pt", weights_only=False)
           if train_rc == 0 else None for r in range(2)]
    return {"train": (train_rc, got, train_dir), "oracle": oracle,
            "fail": (fail_rc, fail_secs, fail_dir)}


def test_runner_launches_two_gloo_ranks_that_equal_the_jax_engine(launched):
    rc, got, workdir = launched["train"]
    assert rc == 0, (workdir / "runner.log").read_text()[-4000:]
    for r, res in enumerate(got):
        env = res["env"]
        assert (env["RANK"], env["LOCAL_RANK"], env["WORLD_SIZE"]) == (
            str(r), str(r), "2")
        assert env["DS_TPU_PROCESS_ID"] == str(r)
        assert env["CUDA_VISIBLE_DEVICES"] == "0,1"
        assert (res["backend"], res["world"], res["rank"]) == ("gloo", 2, r)
    g.check([{"run": r} for r in got], "run", *launched["oracle"])


def test_a_failing_rank_ends_its_sibling_and_the_runner_exits_with_its_code(
        launched):
    rc, secs, workdir = launched["fail"]
    assert rc == 3, (workdir / "runner.log").read_text()[-4000:]
    # rank 0 was running (it sleeps 120 s) and was terminated
    assert (workdir / "started").exists() and secs < 100


def test_a_sigterm_to_the_runner_drains_every_rank_into_one_tag(tmp_path):
    proc, log = _start(tmp_path, "preempt")
    deadline = time.monotonic() + 120
    while not all((tmp_path / f"ready{r}").exists() for r in range(2)):
        assert proc.poll() is None, (tmp_path / "runner.log").read_text()
        assert time.monotonic() < deadline
        time.sleep(0.1)
    proc.send_signal(signal.SIGTERM)
    rc = _wait(proc, log, timeout=120)
    text = (tmp_path / "runner.log").read_text()
    # each rank saved at its step boundary and left through the signal
    assert rc == 128 + signal.SIGTERM, text[-4000:]
    tags = sorted(p.name for p in (tmp_path / "ckpt").iterdir()
                  if p.is_dir())
    assert len(tags) == 1, tags
    assert (tmp_path / "ckpt" / "latest").read_text() == tags[0]
    shards = sorted(os.listdir(tmp_path / "ckpt" / tags[0]))
    assert "zero_pp_rank_1_mp_rank_00optim_states.pt" in shards
    assert "zero_pp_rank_0_mp_rank_00optim_states.pt" in shards
