"""Checkpoints and resilience in the port's engines (runtime/checkpointing.py,
resilience/ wired into initialize() and init_inference()), on the CPU at
a small size: GPT-2 with 2 layers, n_embd 64, 4 heads, 32 positions.

- The port alone: a resume is bit for bit (dropout 0.1; Adam, Lamb and
  FusedLamb); the JAX engine's engine-level resilience cases (the
  corruption matrix, the kill between shard write and publish, the
  save-crash sweep, the partial restore, retries, retention, the
  preemption drain, self-healing at every traversed fault site, typed
  escalation, ragged windows); serving from a checkpoint and from an
  adapter-only checkpoint.
- Parity with the JAX engine, both built from the same weights
  (``params_from_jax``) at dropout 0 in float32 (and fp16) on one
  device: through save, a fresh load and 3 more windows the resumed
  losses agree at rtol 1e-5 (float32 through two layers summed in other
  orders, as tests/test_torch_engine.py), and the step counters, the
  fp16 loss-scale state and the supervisor's counters are equal. Each
  package's verify_checkpoint judges the other's directories the same.
"""

import copy
import os
import shutil
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.resilience import manifest as jmanifest
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel, params_from_jax
from deepspeed_tpu_torch.config import DeepSpeedConfigError
from deepspeed_tpu_torch.resilience import (
    ReplayableDataSource,
    SupervisorEscalation,
    atomic_io,
    manifest,
)
from torch_test_env import jax_compile_cache  # noqa: F401

VOCAB = 256
SEQ = 32
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
MODEL_FILE = "mp_rank_00_model_states.pt"
OPTIM_FILE = "zero_pp_rank_0_mp_rank_00optim_states.pt"


def _gpt2_config(dropout=0.1):
    return GPT2Config(vocab_size=VOCAB, n_positions=SEQ, n_embd=64,
                      n_layer=2, n_head=4, dropout=dropout)


class WeightedGPT2(GPT2LMHeadModel):
    """GPT-2 whose micro-batches carry a float weight (all ones) on the
    loss: a floating batch input for the ``grads.nan`` fault site to
    poison (token ids are integers)."""

    def forward(self, input_ids, labels=None, weight=None, train=False,
                dropout_seed=None):
        loss = super().forward(input_ids, labels, train=train,
                               dropout_seed=dropout_seed)
        return loss * weight.mean()


def _config(optimizer="Adam", **extra):
    cfg = {
        "train_batch_size": 4,
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": optimizer,
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 2}},
        "gradient_clipping": 1.0,
        "steps_per_print": 1000,
    }
    cfg.update(extra)
    return cfg


def _engine(optimizer="Adam", seed=0, dropout=0.1, model_cls=GPT2LMHeadModel,
            **extra):
    model = model_cls(_gpt2_config(dropout), device="cpu", seed=seed)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config_params=_config(optimizer, **extra),
        device="cpu", rng_seed=seed)
    return engine


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = torch.from_numpy(rng.integers(0, VOCAB, (4, SEQ))).long()
        out.append([(ids[:2], ids[:2]), (ids[2:], ids[2:])])
    return out


def _train(engine, windows):
    return [float(engine.train_batch(w)) for w in windows]


def _snapshot(engine):
    return {
        "params": {n: p.detach().clone() for n, p in engine.params.items()},
        "opt": copy.deepcopy(engine.optimizer_state),
        "counters": (engine.global_steps, engine.skipped_steps,
                     engine.micro_steps),
        "scale": engine.loss_scale_state,
        "rng": engine._rng.get_state(),
        "lr": engine.get_lr(),
    }


def _assert_matches(engine, snap):
    for n, p in engine.params.items():
        assert torch.equal(p, snap["params"][n]), n
    for key in ("mu", "nu"):
        for n, t in engine.optimizer_state[key].items():
            assert torch.equal(t, snap["opt"][key][n]), (key, n)
    assert engine.optimizer_state["step"] == snap["opt"]["step"]
    assert (engine.global_steps, engine.skipped_steps,
            engine.micro_steps) == snap["counters"]
    assert engine.loss_scale_state == snap["scale"]
    assert torch.equal(engine._rng.get_state(), snap["rng"])
    assert engine.get_lr() == snap["lr"]


# ---------------------------------------------------------------------------
# the resume, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("optimizer", ["Adam", "Lamb", "FusedLamb"])
def test_a_resumed_run_continues_bit_for_bit(tmp_path, optimizer):
    """6 windows straight through, against 3, a save, a fresh engine
    (other weights, other seed) that loads, and 3 more: the same losses,
    counters, loss scale and LR, and the same parameters, bit for bit
    (dropout 0.1: the dropout-seed generator travels in the model
    file)."""
    windows = _windows(6)
    straight = _engine(optimizer)
    want = _train(straight, windows)
    first = _engine(optimizer)
    assert _train(first, windows[:3]) == want[:3]
    first.save_checkpoint(str(tmp_path), client_state={"epoch": 1})
    resumed = _engine(optimizer, seed=7)
    path, client = resumed.load_checkpoint(str(tmp_path))
    assert path.endswith(os.path.join("global_step3", ""))
    assert client == {"epoch": 1}
    assert _train(resumed, windows[3:]) == want[3:]
    _assert_matches(resumed, _snapshot(straight))


def test_the_checkpoint_files_and_their_roles(tmp_path):
    engine = _engine(bf16={"enabled": True})
    _train(engine, _windows(1))
    engine.save_checkpoint(str(tmp_path))
    tag = tmp_path / "global_step1"
    assert sorted(os.listdir(tag)) == ["MANIFEST.json", MODEL_FILE,
                                       OPTIM_FILE]
    assert (tmp_path / "latest").read_text() == "global_step1"
    model = torch.load(tag / MODEL_FILE, weights_only=True)
    assert set(model) == {
        "module", "global_steps", "skipped_steps", "micro_steps",
        "dp_world_size", "mp_world_size", "zero_stage", "loss_scaler",
        "lr_scheduler", "client_state", "rng_state"}
    assert set(model["module"]) == set(engine.params)
    assert all(t.dtype == torch.float32 for t in model["module"].values())
    assert model["lr_scheduler"] == {"last_batch_iteration": 0}
    optim = torch.load(tag / OPTIM_FILE, weights_only=True)
    assert optim["num_shards"] == 1
    opt = optim["optimizer_state"]
    # bf16: the fp32 masters ride in the optimizer file too
    assert set(opt) == {"master", "inner"} and opt["inner"]["step"] == 1
    for n, p in engine.params.items():
        assert torch.equal(opt["master"][n], p)
        assert torch.equal(model["module"][n], p)


def test_an_fp32_engine_saves_the_bare_optimizer_state(tmp_path):
    engine = _engine()
    _train(engine, _windows(1))
    engine.save_checkpoint(str(tmp_path))
    opt = torch.load(tmp_path / "global_step1" / OPTIM_FILE,
                     weights_only=True)["optimizer_state"]
    assert set(opt) == {"step", "mu", "nu"}


def test_a_load_restores_in_place(tmp_path):
    """Parameters and moments keep their storage across a load (the
    engine and FusedLamb's device tables hold their addresses)."""
    engine = _engine("FusedLamb")
    _train(engine, _windows(1))
    engine.save_checkpoint(str(tmp_path))
    ptrs = {n: p.data_ptr() for n, p in engine.params.items()}
    mptrs = {n: t.data_ptr() for n, t in engine.optimizer_state["mu"].items()}
    _train(engine, _windows(1, seed=1))
    assert engine.load_checkpoint(str(tmp_path))[0] is not None
    assert {n: p.data_ptr() for n, p in engine.params.items()} == ptrs
    assert {n: t.data_ptr()
            for n, t in engine.optimizer_state["mu"].items()} == mptrs


def test_client_state_is_refused_at_save_not_at_load(tmp_path):
    engine = _engine()
    with pytest.raises(TypeError, match="client_state"):
        engine.save_checkpoint(str(tmp_path),
                               client_state={"x": np.zeros(3)})
    with pytest.raises(TypeError, match="not a string"):
        engine.save_checkpoint(str(tmp_path), client_state={1: 2})
    assert not (tmp_path / "latest").exists()
    engine.save_checkpoint(str(tmp_path), client_state={
        "a": [1, 2.5, "s", None, True], "t": torch.arange(3)})
    _, client = _engine().load_checkpoint(str(tmp_path))
    assert client["a"] == [1, 2.5, "s", None, True]
    assert torch.equal(client["t"], torch.arange(3))


def test_a_checkpoint_of_another_model_is_refused_untouched(tmp_path):
    engine = _engine()
    engine.save_checkpoint(str(tmp_path))
    other = GPT2LMHeadModel(GPT2Config(vocab_size=VOCAB, n_positions=SEQ,
                                       n_embd=32, n_layer=2, n_head=4),
                            device="cpu")
    small, *_ = deepspeed_tpu_torch.initialize(
        model=other, config_params=_config(), device="cpu")
    snap = _snapshot(small)
    with pytest.raises(ValueError, match="shape"):
        small.load_checkpoint(str(tmp_path))
    _assert_matches(small, snap)


# ---------------------------------------------------------------------------
# the corruption matrix (tagA at step 1, tagB at step 2)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def saved_pair(tmp_path_factory):
    base = tmp_path_factory.mktemp("ckpt_base")
    engine = _engine(seed=1)
    _train(engine, _windows(1))
    engine.save_checkpoint(str(base), tag="tagA")
    snap_a = _snapshot(engine)
    _train(engine, _windows(1, seed=1))
    engine.save_checkpoint(str(base), tag="tagB")
    return str(base), snap_a, _snapshot(engine)


@pytest.fixture(scope="module")
def loader_engine():
    return _engine(seed=7)


def _case_dir(tmp_path, base):
    dst = str(tmp_path / "case")
    shutil.copytree(base, dst)
    return dst


def _truncate(path):
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[: len(blob) // 3])


def test_save_writes_verified_manifest_and_latest(saved_pair):
    base, _, _ = saved_pair
    assert open(os.path.join(base, "latest")).read() == "tagB"
    for tag in ("tagA", "tagB"):
        status, reason = manifest.verify_checkpoint(os.path.join(base, tag))
        assert status == manifest.VALID, (tag, reason)
    import json

    m = json.load(open(os.path.join(base, "tagB", manifest.MANIFEST_FILE)))
    assert sorted(m["files"]) == [MODEL_FILE, OPTIM_FILE]
    assert m["global_steps"] == 2 and m["tag"] == "tagB"


def test_clean_load_is_bitwise_identical(saved_pair, loader_engine):
    base, _, snap_b = saved_pair
    path, _ = loader_engine.load_checkpoint(base)
    assert path is not None
    _assert_matches(loader_engine, snap_b)


@pytest.mark.parametrize("damage", [
    "truncated_model", "truncated_optim", "missing_optim", "deleted_tag",
])
def test_a_damaged_latest_falls_back_to_the_previous_tag(
        tmp_path, saved_pair, loader_engine, damage):
    base, snap_a, _ = saved_pair
    d = _case_dir(tmp_path, base)
    tag_b = os.path.join(d, "tagB")
    if damage == "truncated_model":
        _truncate(os.path.join(tag_b, MODEL_FILE))
    elif damage == "truncated_optim":
        _truncate(os.path.join(tag_b, OPTIM_FILE))
    elif damage == "missing_optim":
        os.unlink(os.path.join(tag_b, OPTIM_FILE))
    else:
        shutil.rmtree(tag_b)  # latest still names tagB
    before = loader_engine.resilience.registry.snapshot()[
        "resilience/corruption_fallbacks"]
    path, _ = loader_engine.load_checkpoint(d)
    assert path is not None and "tagA" in path
    _assert_matches(loader_engine, snap_a)
    assert loader_engine.resilience.registry.snapshot()[
        "resilience/corruption_fallbacks"] == before + 1


def test_kill_between_shard_write_and_tag_publish(tmp_path, saved_pair,
                                                  loader_engine):
    base, _, snap_b = saved_pair
    d = _case_dir(tmp_path, base)
    torn = os.path.join(d, "tagC")
    shutil.copytree(os.path.join(d, "tagB"), torn)
    os.unlink(os.path.join(torn, manifest.MANIFEST_FILE))
    _truncate(os.path.join(torn, OPTIM_FILE))
    path, _ = loader_engine.load_checkpoint(d)
    assert path is not None and "tagB" in path
    _assert_matches(loader_engine, snap_b)


def test_explicit_tag_never_silently_substitutes(tmp_path, saved_pair,
                                                 loader_engine):
    base, _, _ = saved_pair
    d = _case_dir(tmp_path, base)
    _truncate(os.path.join(d, "tagB", OPTIM_FILE))
    snap = _snapshot(loader_engine)
    assert loader_engine.load_checkpoint(d, tag="tagB") == (None, {})
    _assert_matches(loader_engine, snap)


def test_no_loadable_checkpoint_returns_none(tmp_path, saved_pair,
                                             loader_engine):
    base, _, _ = saved_pair
    d = _case_dir(tmp_path, base)
    for tag in ("tagA", "tagB"):
        _truncate(os.path.join(d, tag, MODEL_FILE))
    snap = _snapshot(loader_engine)
    assert loader_engine.load_checkpoint(d) == (None, {})
    _assert_matches(loader_engine, snap)


def test_partial_restore_leaves_engine_untouched(tmp_path, saved_pair,
                                                 loader_engine):
    """A truncated optimizer file on the manifest-less (legacy) path only
    fails at parse time: every engine field stays as it was."""
    base, _, _ = saved_pair
    d = _case_dir(tmp_path, base)
    shutil.rmtree(os.path.join(d, "tagA"))
    torn = os.path.join(d, "tagB")
    os.unlink(os.path.join(torn, manifest.MANIFEST_FILE))
    _truncate(os.path.join(torn, OPTIM_FILE))
    snap = _snapshot(loader_engine)
    assert loader_engine.load_checkpoint(d) == (None, {})
    _assert_matches(loader_engine, snap)


def test_save_crash_sweep_never_publishes_torn_checkpoint(
        tmp_path, saved_pair, loader_engine):
    """A crash at every os.replace of a save (model, optimizer, manifest,
    latest) leaves ``latest`` on a complete checkpoint that loads bit for
    bit."""
    base, _, snap_b = saved_pair
    engine = _engine(seed=3)
    _train(engine, _windows(1, seed=5))

    class SimulatedKill(BaseException):
        """Not an Exception: nothing on the save path may swallow it."""

    real_replace = atomic_io.os.replace
    calls = {"n": 0}

    def counting(src, dst):
        calls["n"] += 1
        return real_replace(src, dst)

    atomic_io.os.replace = counting
    try:
        engine.save_checkpoint(str(tmp_path / "probe"), tag="probe")
    finally:
        atomic_io.os.replace = real_replace
    assert calls["n"] == 4
    for k in range(4):
        workdir = str(tmp_path / f"crash{k}")
        shutil.copytree(base, workdir)
        seen = {"n": 0}

        def crashing(src, dst, _k=k, _seen=seen):
            if _seen["n"] == _k:
                raise SimulatedKill(f"killed at publish op {_k}")
            _seen["n"] += 1
            return real_replace(src, dst)

        atomic_io.os.replace = crashing
        try:
            with pytest.raises(SimulatedKill):
                engine.save_checkpoint(workdir, tag="tagC")
        finally:
            atomic_io.os.replace = real_replace
        latest = open(os.path.join(workdir, "latest")).read().strip()
        assert latest == "tagB", k
        path, _ = loader_engine.load_checkpoint(workdir)
        assert path is not None and "tagB" in path, (k, path)
        _assert_matches(loader_engine, snap_b)
    workdir = str(tmp_path / "clean")
    shutil.copytree(base, workdir)
    engine.save_checkpoint(workdir, tag="tagC")
    path, _ = loader_engine.load_checkpoint(workdir)
    assert "tagC" in path
    _assert_matches(loader_engine, _snapshot(engine))


def test_save_retries_transient_write_failures(tmp_path):
    engine = _engine(resilience={"retry": {"max_attempts": 3,
                                           "backoff_base": 0.001}})
    real_replace = atomic_io.os.replace
    fails = {"n": 2}

    def flaky(src, dst):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient fuse error")
        return real_replace(src, dst)

    atomic_io.os.replace = flaky
    try:
        assert engine.save_checkpoint(str(tmp_path), tag="t") is True
    finally:
        atomic_io.os.replace = real_replace
    assert manifest.verify_checkpoint(str(tmp_path / "t"))[0] == \
        manifest.VALID
    snap = engine.resilience.registry.snapshot()
    assert snap["resilience/io_retries"] == 2
    assert snap["resilience/save_time_ms/count"] == 1


def test_an_injected_write_fault_is_absorbed_by_the_retry(tmp_path):
    engine = _engine(resilience={
        "retry": {"backoff_base": 0.001},
        "fault_injection": {"enabled": True, "faults": [
            {"site": "checkpoint.write", "times": 1}]}})
    engine.save_checkpoint(str(tmp_path))
    snap = engine.resilience.registry.snapshot()
    assert snap["resilience/io_retries"] == 1
    assert snap["resilience/faults_injected"] == 1
    assert _engine(seed=2).load_checkpoint(str(tmp_path))[0] is not None


def test_keep_last_n_prunes_after_save(tmp_path):
    engine = _engine(resilience={"keep_last_n": 2})
    for i in range(4):
        engine.save_checkpoint(str(tmp_path), tag=f"s{i}")
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == [
        "s2", "s3"]
    assert (tmp_path / "latest").read_text() == "s3"
    assert engine.resilience.registry.snapshot()[
        "resilience/checkpoints_pruned"] == 2


def test_resilience_disabled_writes_bare_files(tmp_path):
    engine = _engine(resilience={"enabled": False})
    _train(engine, _windows(1))
    engine.save_checkpoint(str(tmp_path), tag="t")
    files = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert files == [MODEL_FILE, OPTIM_FILE]
    loader = _engine(seed=11)
    assert loader.load_checkpoint(str(tmp_path))[0] is not None
    _assert_matches(loader, _snapshot(engine))


def test_resilience_shares_the_telemetry_registry(tmp_path):
    import json

    engine = _engine(telemetry={"enabled": True,
                                "output_path": str(tmp_path),
                                "job_name": "job",
                                "watchdog": {"enabled": False}})
    try:
        assert engine.resilience.registry is engine.telemetry.registry
        _train(engine, _windows(1))
        engine.save_checkpoint(str(tmp_path / "ck"))
        engine.flush_monitor()
        tags = {json.loads(line)["tag"] for line in
                open(tmp_path / "job" / "metrics.jsonl")}
        assert {"resilience/io_retries", "resilience/save_time_ms"} <= tags
    finally:
        engine.close()


# ---------------------------------------------------------------------------
# the preemption drain
# ---------------------------------------------------------------------------
def _preempt_engine(tmp_path, **preemption):
    return _engine(resilience={"preemption": {
        "enabled": True, "save_dir": str(tmp_path), **preemption}})


def test_preemption_drain_saves_at_step_boundary(tmp_path):
    engine = _preempt_engine(tmp_path, exit_after_save=False)
    try:
        windows = _windows(2)
        _train(engine, windows[:1])
        assert not list(tmp_path.iterdir())
        # a SIGTERM lands mid-window: the handler only arms a flag
        engine.resilience.preemption._on_signal(signal.SIGTERM, None)
        assert engine.resilience.preemption_armed
        _train(engine, windows[1:])
        tag = f"preempt_global_step{engine.global_steps}"
        assert manifest.verify_checkpoint(str(tmp_path / tag))[0] == \
            manifest.VALID
        assert (tmp_path / "latest").read_text() == tag
        assert not engine.resilience.preemption_armed
        assert engine.resilience.registry.snapshot()[
            "resilience/preemption_saves"] == 1
        loader = _engine(seed=6)
        loader.load_checkpoint(str(tmp_path))
        _assert_matches(loader, _snapshot(engine))
    finally:
        engine.resilience.preemption.uninstall()


def test_preemption_exit_after_save_resignals(tmp_path, monkeypatch):
    from deepspeed_tpu_torch.resilience import preemption

    engine = _preempt_engine(tmp_path)
    kills = []
    monkeypatch.setattr(preemption.os, "kill",
                        lambda pid, sig: kills.append(sig))
    try:
        _train(engine, _windows(1))
        engine.resilience.preemption.arm(signal.SIGTERM)
        _train(engine, _windows(1, seed=1))
        assert kills == [signal.SIGTERM]
        tag = f"preempt_global_step{engine.global_steps}"
        assert manifest.verify_checkpoint(str(tmp_path / tag))[0] == \
            manifest.VALID
    finally:
        engine.resilience.preemption.uninstall()


def test_preemption_without_save_target_warns_not_crashes():
    engine = _engine(resilience={"preemption": {
        "enabled": True, "exit_after_save": False}})
    try:
        engine.resilience.preemption.arm()
        _train(engine, _windows(1))
        assert engine.global_steps == 1
    finally:
        engine.resilience.preemption.uninstall()


# ---------------------------------------------------------------------------
# the run supervisor and the fault sites
# ---------------------------------------------------------------------------
def _chaos_factory(base_seed=20_000):
    """Micro-batch i is a pure function of (base_seed, i): (ids, labels,
    weight ones), so any start offset replays bit for bit."""
    def factory(start):
        def gen(i):
            while True:
                r = np.random.default_rng(base_seed + i)
                ids = torch.from_numpy(r.integers(0, VOCAB, (2, SEQ))).long()
                yield ids, ids, torch.ones(2)
                i += 1
        return gen(start)
    return factory


def _supervised(faults, seed=0, max_rollbacks=2, nonfinite_window=1):
    res = {"supervisor": {"enabled": True,
                          "nonfinite_window": nonfinite_window,
                          "max_rollbacks": max_rollbacks},
           "retry": {"backoff_base": 0.001}}
    if faults:
        res["fault_injection"] = {"enabled": True, "faults": faults}
    return _engine(seed=seed, model_cls=WeightedGPT2, resilience=res)


@pytest.mark.parametrize("site", ["grads.nan", "staging.device_put"])
def test_injected_fault_self_heals_bitwise(tmp_path, site):
    """A fault after the commit point poisons a window (grads.nan) or
    fails its placement (staging.device_put); the supervisor rolls back,
    rewinds the data and the dropout seeds, and the run ends bit for bit
    where an uninjected replay from the same checkpoint ends."""
    factory = _chaos_factory()
    engine = _supervised([{"site": site, "after": 3, "times": 1}], seed=3)
    src = ReplayableDataSource(factory)
    losses = [float(engine.train_batch(src)) for _ in range(2)]
    engine.save_checkpoint(str(tmp_path))
    losses += [float(engine.train_batch(src)) for _ in range(4)]
    assert all(np.isfinite(losses)), losses
    snap = engine.resilience.registry.snapshot()
    assert snap["resilience/rollbacks"] == 1
    assert snap["resilience/anomalies"] == 1
    assert snap["resilience/faults_injected"] == 1
    replay = _engine(seed=9, model_cls=WeightedGPT2)
    assert replay.load_checkpoint(str(tmp_path))[0] is not None
    src2 = ReplayableDataSource(factory, start=replay.micro_steps)
    n_replay = engine.global_steps - replay.global_steps
    assert n_replay == 3
    replayed = [float(replay.train_batch(src2)) for _ in range(n_replay)]
    assert replayed == losses[-3:]
    for n, p in engine.params.items():
        assert torch.equal(p, replay.params[n]), n
    assert (engine.global_steps, engine.micro_steps,
            engine.skipped_steps) == (replay.global_steps,
                                      replay.micro_steps,
                                      replay.skipped_steps)


def test_persistent_fault_escalates_with_typed_error(tmp_path):
    engine = _supervised([{"site": "grads.nan", "after": 2, "times": 0}],
                         seed=4, max_rollbacks=1)
    src = ReplayableDataSource(_chaos_factory())
    float(engine.train_batch(src))
    engine.save_checkpoint(str(tmp_path))
    float(engine.train_batch(src))
    with pytest.raises(SupervisorEscalation) as err:
        for _ in range(4):
            float(engine.train_batch(src))
    assert err.value.rollbacks == 1 and "budget" in str(err.value)


def test_anomaly_without_checkpoint_escalates():
    engine = _supervised([{"site": "grads.nan", "after": 0, "times": 1}],
                         seed=5)
    with pytest.raises(SupervisorEscalation):
        engine.train_batch(ReplayableDataSource(_chaos_factory()))


def test_stall_escalation_rolls_back_at_next_boundary(tmp_path):
    engine = _supervised([], seed=6)
    src = ReplayableDataSource(_chaos_factory())
    float(engine.train_batch(src))
    engine.save_checkpoint(str(tmp_path))
    engine.supervisor.notify_stall(waited=123.0, last_step=1)
    float(engine.train_batch(src))
    assert engine.supervisor.rollbacks == 1 and engine.global_steps == 2
    float(engine.train_batch(src))
    assert engine.global_steps == 3


def test_step_stall_fault_sleeps_and_run_completes():
    import time

    engine = _supervised([{"site": "step.stall", "times": 1,
                           "args": {"duration_ms": 30}}], seed=7)
    src = ReplayableDataSource(_chaos_factory())
    t0 = time.monotonic()
    losses = [float(engine.train_batch(src)) for _ in range(2)]
    assert time.monotonic() - t0 >= 0.03 and all(np.isfinite(losses))
    assert engine.resilience.faults.injected["step.stall"] == 1


def test_checkpoint_read_fault_during_rollback_is_retried(tmp_path):
    engine = _supervised([{"site": "grads.nan", "after": 2, "times": 1},
                          {"site": "checkpoint.read", "times": 1}], seed=8)
    src = ReplayableDataSource(_chaos_factory())
    float(engine.train_batch(src))
    engine.save_checkpoint(str(tmp_path))
    losses = [float(engine.train_batch(src)) for _ in range(3)]
    assert all(np.isfinite(losses))
    snap = engine.resilience.registry.snapshot()
    assert snap["resilience/rollbacks"] == 1
    assert snap["resilience/io_retries"] == 1


def test_a_rollback_drops_the_half_run_window(tmp_path):
    """A failure between a forward and its backward leaves a stashed
    forward behind; the rollback discards it and the window re-runs."""
    engine = _supervised([], seed=12)
    src = ReplayableDataSource(_chaos_factory())
    float(engine.train_batch(src))
    engine.save_checkpoint(str(tmp_path))
    real_backward = engine.backward
    state = {"failed": False}

    def backward_once_broken(loss):
        if not state["failed"]:
            state["failed"] = True
            raise RuntimeError("device fault mid-window")
        return real_backward(loss)

    engine.backward = backward_once_broken
    loss = float(engine.train_batch(src))
    assert np.isfinite(loss) and engine.supervisor.rollbacks == 1
    assert engine._pending is None and engine.global_steps == 2


def test_ragged_window_error_is_not_healed(tmp_path):
    engine = _supervised([], seed=30)

    class Finite:
        """2.5 windows of data: ends mid-window."""

        def __init__(self):
            self.n = 0

        def __iter__(self):
            return self

        def __next__(self):
            if self.n >= 5:
                raise StopIteration
            self.n += 1
            ids = torch.full((2, SEQ), self.n, dtype=torch.long)
            return ids, ids, torch.ones(2)

        def rewind(self, position):
            self.n = position

    src = Finite()
    float(engine.train_batch(src))
    engine.save_checkpoint(str(tmp_path))
    float(engine.train_batch(src))
    with pytest.raises(RuntimeError, match="ran dry mid-window"):
        engine.train_batch(src)
    assert engine.supervisor.rollbacks == 0


def test_integer_only_batches_make_grads_nan_a_warned_no_op(tmp_path):
    """GPT-2's own (ids, labels) batches have no floating input: the
    fault fires, as in the JAX engine, and poisons nothing."""
    engine = _engine(resilience={"supervisor": {"enabled": True},
                                 "fault_injection": {"enabled": True,
                                                     "faults": [{"site":
                                                                 "grads.nan"}]}})
    loss = _train(engine, _windows(1))[0]
    assert np.isfinite(loss) and engine.global_steps == 1
    assert engine.resilience.faults.injected["grads.nan"] == 1
    assert engine.supervisor.rollbacks == 0


# ---------------------------------------------------------------------------
# serving from checkpoints
# ---------------------------------------------------------------------------
def _serve_block(**extra):
    return {"inference": {"max_batch_slots": 2, "kv_block_size": 8,
                          "fused_decode": True,
                          "sampling": {"greedy": True}, **extra}}


PROMPTS = [[5, 17, 3, 250, 9], [100, 2, 77]]


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("trained")
    engine = _engine(dropout=0.0, optimizer="Adam")
    rng = np.random.default_rng(5)
    memo = torch.from_numpy(rng.integers(0, VOCAB, (2, SEQ))).long()
    for _ in range(8):
        engine.train_batch([(memo, memo)] * 2)
    engine.save_checkpoint(str(d))
    return str(d), engine.module


def test_a_checkpoint_serves_the_trained_models_tokens(trained_dir):
    d, trained = trained_dir
    served = deepspeed_tpu_torch.init_inference(
        model=GPT2LMHeadModel(_gpt2_config(0.0), device="cpu", seed=99),
        config=_serve_block(checkpoint={"load_dir": d}), device="cpu")
    direct = deepspeed_tpu_torch.init_inference(
        model=trained, config=_serve_block(), device="cpu")
    try:
        assert served.loaded_tag == "global_step8"
        got = served.generate(PROMPTS, max_new_tokens=6)
        assert got == direct.generate(PROMPTS, max_new_tokens=6)
    finally:
        served.close()
        direct.close()


def test_a_serving_load_falls_back_and_counts_it(tmp_path, trained_dir):
    d, _ = trained_dir
    case = str(tmp_path / "case")
    shutil.copytree(d, case)
    shutil.copytree(os.path.join(case, "global_step8"),
                    os.path.join(case, "global_step9"))
    _truncate(os.path.join(case, "global_step9", MODEL_FILE))
    with open(os.path.join(case, "latest"), "w") as f:
        f.write("global_step9")
    served = deepspeed_tpu_torch.init_inference(
        model=GPT2LMHeadModel(_gpt2_config(0.0), device="cpu"),
        config=_serve_block(checkpoint={"load_dir": case}), device="cpu")
    try:
        assert served.loaded_tag == "global_step8"
        assert served.metrics.snapshot()[
            "resilience/corruption_fallbacks"] == 1
    finally:
        served.close()
    with pytest.raises(RuntimeError, match="no loadable checkpoint"):
        deepspeed_tpu_torch.init_inference(
            model=GPT2LMHeadModel(_gpt2_config(0.0), device="cpu"),
            config=_serve_block(checkpoint={"load_dir": case,
                                            "tag": "global_step9"}),
            device="cpu")


def test_a_decode_crash_restarts_the_driver(trained_dir):
    """``decode.step`` armed once: the in-flight requests fail-finish,
    the driver restarts (infer/driver_restarts 1), and the next requests
    are served the checkpoint's tokens."""
    d, trained = trained_dir
    direct = deepspeed_tpu_torch.init_inference(
        model=trained, config=_serve_block(), device="cpu")
    want = direct.generate(PROMPTS, max_new_tokens=6)
    direct.close()
    cfg = _serve_block(checkpoint={"load_dir": d}, driver_restart_budget=1)
    cfg["resilience"] = {"fault_injection": {"enabled": True, "faults": [
        {"site": "decode.step", "after": 1, "times": 1}]}}
    eng = deepspeed_tpu_torch.init_inference(
        model=GPT2LMHeadModel(_gpt2_config(0.0), device="cpu"),
        config=cfg, device="cpu")
    try:
        first = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
        eng.scheduler.run_until_idle()
        assert [r.finish_reason for r in first] == ["error", "error"]
        snap = eng.metrics.snapshot()
        assert snap["infer/driver_restarts"] == 1
        assert snap["resilience/faults_injected"] == 1
        assert eng.generate(PROMPTS, max_new_tokens=6) == want
    finally:
        eng.close()


LORA_RANK = 4


def _lora_engine():
    cfg = _config("Adam", adapters={"enabled": True, "rank": LORA_RANK,
                                    "alpha": 8.0})
    cfg["optimizer"]["params"]["lr"] = 1e-2
    model = GPT2LMHeadModel(_gpt2_config(0.0), device="cpu", seed=0)
    base = {n: p.detach().clone() for n, p in model.state_dict().items()}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config_params=cfg,
                                                device="cpu")
    return engine, base


def _adapter_server(base, rank=LORA_RANK):
    return deepspeed_tpu_torch.init_inference(
        model=GPT2LMHeadModel(_gpt2_config(0.0), device="cpu"),
        model_parameters=base, device="cpu",
        config={**_serve_block(),
                "adapters": {"enabled": True, "rank": rank, "alpha": 8.0,
                             "pool_slots": 2}})


def test_an_adapter_checkpoint_serves_like_its_adapter_state(tmp_path):
    engine, base = _lora_engine()
    memo = torch.from_numpy(
        np.random.default_rng(5).integers(0, VOCAB, (2, SEQ))).long()
    for _ in range(6):
        engine.train_batch([(memo, memo)] * 2)
    engine.save_checkpoint(str(tmp_path), tag="global_step3")
    prompts = [memo[0, :8].tolist(), memo[1, :5].tolist()]
    saved = torch.load(tmp_path / "global_step3" / MODEL_FILE,
                       weights_only=True)
    assert set(saved["module"]) == set(engine.params)
    assert all("_lora_" in n for n in saved["module"])
    assert saved["client_state"]["adapters"] == {
        "rank": LORA_RANK, "alpha": 8.0,
        "targets": ["attn_qkvw", "attn_ow", "inter_w", "output_w"]}
    optim = torch.load(tmp_path / "global_step3" / OPTIM_FILE,
                       weights_only=True)["optimizer_state"]
    assert set(optim["mu"]) == set(engine.params)
    serve = _adapter_server(base)
    try:
        serve.load_adapter("ckpt", load_dir=str(tmp_path))
        serve.load_adapter("live", adapter_state=engine.adapter_state_dict())
        a = serve.generate(prompts, max_new_tokens=6, adapter="ckpt")
        b = serve.generate(prompts, max_new_tokens=6, adapter="live")
        assert a == b
        assert a != serve.generate(prompts, max_new_tokens=6)
    finally:
        serve.close()
    small = _adapter_server(base, rank=2)
    try:
        with pytest.raises(DeepSpeedConfigError, match="rank=4"):
            small.load_adapter("ckpt", load_dir=str(tmp_path))
        assert small.adapter_registry.used_slots == 0
    finally:
        small.close()


def test_a_lora_fine_tune_resumes_bit_for_bit(tmp_path):
    windows = _windows(4, seed=3)
    straight, _ = _lora_engine()
    want = _train(straight, windows)
    first, _ = _lora_engine()
    _train(first, windows[:2])
    first.save_checkpoint(str(tmp_path))
    resumed, _ = _lora_engine()
    resumed.load_checkpoint(str(tmp_path))
    assert _train(resumed, windows[2:]) == want[2:]


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------
def _jax_models():
    jcfg = JGPT2Config(vocab_size=VOCAB, n_positions=SEQ, n_embd=64,
                       n_layer=2, n_head=4, dropout=0.0)
    jmodel = JGPT2LMHeadModel(jcfg)
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        ids0, ids0)["params"])
    return jmodel, params


def _jax_engine(model, params, cfg):
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=params, config_params=cfg,
        mesh=build_mesh(devices=jax.devices()[:1]))
    return engine


def _port_engine(params, cfg, model_cls=GPT2LMHeadModel):
    model = model_cls(_gpt2_config(0.0), device="cpu")
    model.load_state_dict(params_from_jax(params))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config_params=cfg,
                                                device="cpu")
    return engine


def _np_windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, VOCAB, (2, SEQ)).astype(np.int32)
             for _ in range(2)] for _ in range(n)]


def _scale_state(engine):
    s = engine.loss_scale_state
    return (float(s.loss_scale), int(s.good_steps), int(s.hysteresis))


PRECISIONS = {"fp32": {}, "fp16": {"fp16": {"enabled": True,
                                            "initial_scale_power": 16}}}


@pytest.fixture(scope="module", params=sorted(PRECISIONS))
def parity_run(request, tmp_path_factory):
    """Both engines: 2 windows, save, a fresh engine loads, 3 windows,
    save again. Returns each package's (losses, counters, scale state,
    save dir)."""
    precision = request.param
    cfg = _config("Adam", **PRECISIONS[precision])
    jmodel, params = _jax_models()
    windows = _np_windows(5)
    out = {}
    for name in ("jax", "torch"):
        d = str(tmp_path_factory.mktemp(f"{name}_{precision}"))
        if name == "jax":
            make = lambda: _jax_engine(jmodel, params, cfg)  # noqa: E731
            conv = jnp.asarray
        else:
            make = lambda: _port_engine(params, cfg)  # noqa: E731
            conv = lambda x: torch.from_numpy(x).long()  # noqa: E731
        first = make()
        for w in windows[:2]:
            first.train_batch([(conv(x), conv(x)) for x in w])
        first.save_checkpoint(d, tag="first")
        saved_scale = _scale_state(first)
        resumed = make()
        path, _ = resumed.load_checkpoint(d)
        assert path is not None
        assert _scale_state(resumed) == saved_scale
        losses = [float(np.asarray(resumed.train_batch(
            [(conv(x), conv(x)) for x in w]))) for w in windows[2:]]
        resumed.save_checkpoint(d, tag="second")
        out[name] = (losses, (resumed.global_steps, resumed.skipped_steps),
                     _scale_state(resumed), d)
    return precision, out


def test_resumed_losses_and_counters_match_the_jax_engine(parity_run):
    precision, out = parity_run
    (jl, jc, js, _), (tl, tc, ts, _) = out["jax"], out["torch"]
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert tc == jc and tc[0] + tc[1] == 5
    assert ts == js
    if precision == "fp16":
        assert ts[0] <= 2.0 ** 16


@pytest.mark.parametrize("reader", ["jax", "torch"])
@pytest.mark.parametrize("damage", ["none", "truncate", "bitflip",
                                    "missing"])
def test_each_package_judges_the_others_checkpoints(parity_run, tmp_path,
                                                    reader, damage):
    """A directory saved by one package's engine gets the same verdict
    from both packages' verify_checkpoint."""
    _, out = parity_run
    writer = "torch" if reader == "jax" else "jax"
    src = os.path.join(out[writer][3], "second")
    d = str(tmp_path / "tag")
    shutil.copytree(src, d)
    files = sorted(f for f in os.listdir(d) if f != "MANIFEST.json")
    target = os.path.join(d, files[-1])
    if damage == "truncate":
        _truncate(target)
    elif damage == "bitflip":
        blob = open(target, "rb").read()
        open(target, "wb").write(blob[:-1] + bytes([blob[-1] ^ 1]))
    elif damage == "missing":
        os.unlink(target)
    verify = (jmanifest if reader == "jax" else manifest).verify_checkpoint
    other = (manifest if reader == "jax" else jmanifest).verify_checkpoint
    status, reason = verify(d)
    assert (status, reason) == other(d)
    assert status == ("valid" if damage == "none" else "corrupt"), reason


def test_supervisor_counters_match_the_jax_engine(tmp_path):
    """The same grads.nan config and seed in both engines: the same
    rollbacks, anomalies and injected faults, and the healed runs' losses
    agree."""
    jmodel, params = _jax_models()

    def jax_loss(p, batch, rng):
        ids, labels, weight = batch
        loss = jmodel.apply({"params": p}, ids, labels, train=False,
                            rngs={"dropout": rng})
        return loss * jnp.mean(weight)

    res = {"supervisor": {"enabled": True, "nonfinite_window": 1},
           "fault_injection": {"enabled": True, "seed": 5, "faults": [
               {"site": "grads.nan", "after": 3, "times": 1}]}}
    cfg = _config("Adam", resilience=res)
    rng = np.random.default_rng(1)
    micro = [rng.integers(0, VOCAB, (2, SEQ)).astype(np.int32)
             for _ in range(12)]

    def factory(conv, weight):
        def make(start):
            def gen(i):
                while True:
                    ids = conv(micro[i % len(micro)])
                    yield ids, ids, weight
                    i += 1
            return gen(start)
        return make

    out = {}
    for name in ("jax", "torch"):
        if name == "jax":
            engine = _jax_engine(jax_loss, params, cfg)
            src = ReplayableDataSource(factory(
                jnp.asarray, np.ones(2, np.float32)))
        else:
            engine = _port_engine(params, cfg, model_cls=WeightedGPT2)
            src = ReplayableDataSource(factory(
                lambda x: torch.from_numpy(x).long(), torch.ones(2)))
        d = str(tmp_path / name)
        losses = [float(np.asarray(engine.train_batch(src)))
                  for _ in range(2)]
        engine.save_checkpoint(d)
        losses += [float(np.asarray(engine.train_batch(src)))
                   for _ in range(3)]
        snap = engine.resilience.registry.snapshot()
        out[name] = (losses, {k: snap[f"resilience/{k}"] for k in
                              ("rollbacks", "anomalies", "faults_injected")})
    assert out["torch"][1] == out["jax"][1] == {
        "rollbacks": 1, "anomalies": 1, "faults_injected": 1}
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], **LOSS_TOL)
