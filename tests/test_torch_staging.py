"""The staged input pipeline (runtime/staging.py) in the training engine,
and the data_pipeline and compile_cache config blocks, on the CPU.

Staged ``train_batch`` equals unstaged bit for bit (losses, parameters and
the dropout-seed generator's state) at accumulation 1 and 2 with dropout
on; the ragged-window and clean-exhaustion errors hold on both paths, as
do the epoch refill, the fresh-iterator churn guard, thread hygiene (no
leak across stager lifecycles or from an abandoned engine; a bounded,
idempotent close), the staging.worker fault and the supervisor's rewind
of a loader's ReplayableDataSource, the preemption drain, the telemetry
streams, the config rejections (the JAX package's messages) and the
kernel build cache."""

import gc
import signal
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.config.config import DeepSpeedConfigError as JConfigError
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.config.config import (
    DeepSpeedConfig,
    DeepSpeedConfigError,
)
from deepspeed_tpu_torch.ops import kernel_lib
from deepspeed_tpu_torch.resilience import ReplayableDataSource
from deepspeed_tpu_torch.runtime import compile_cache
from deepspeed_tpu_torch.runtime.staging import (
    WindowStager,
    ragged_window_error,
)
from torch_test_env import jax_compile_cache  # noqa: F401

VOCAB = 64
SEQ = 16
MICRO = 2


class WeightedGPT2(GPT2LMHeadModel):
    """GPT-2 whose micro-batches carry a float weight (all ones) on the
    loss, the input the grads.nan fault site poisons."""

    def forward(self, input_ids, labels=None, weight=None, train=False,
                dropout_seed=None):
        loss = super().forward(input_ids, labels, train=train,
                               dropout_seed=dropout_seed)
        return loss if weight is None else loss * weight.mean()


def _engine(accum=1, staged=True, seed=0, training_data=None, extra=None,
            model_cls=GPT2LMHeadModel):
    model = model_cls(GPT2Config(vocab_size=VOCAB, n_positions=SEQ,
                                 n_embd=32, n_layer=2, n_head=4,
                                 dropout=0.1), device="cpu", seed=seed)
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": accum,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "steps_per_print": 1000,
           "data_pipeline": {"enabled": staged}}
    cfg.update(extra or {})
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfg, training_data=training_data,
        device="cpu", rng_seed=seed)
    return engine, loader


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = torch.from_numpy(rng.integers(0, VOCAB, (MICRO, SEQ)))
        out.append((ids, ids))
    return out


def _data(rows, seed=2, weighted=False):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (rows, SEQ))
    out = (ids, ids.copy())
    return out + (np.ones(rows, np.float32),) if weighted else out


def _stager_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("ds-window-stager")]


def _wait_no_stager_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while _stager_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    return _stager_threads()


def _state(engine):
    return ([p.detach().clone() for p in engine.params.values()],
            engine._rng.get_state())


def _same_state(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
            and torch.equal(a[1], b[1]))


# ---------------------------------------------------------------------------
# staged == unstaged, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("source", ["iterator", "loader"])
def test_staged_equals_unstaged_bitwise(accum, source):
    runs = []
    for staged in (False, True):
        data = _data(4 * accum * MICRO) if source == "loader" else None
        engine, loader = _engine(accum, staged, training_data=data)
        it = iter(loader) if loader is not None else iter(
            _batches(4 * accum))
        losses = [float(engine.train_batch(it)) for _ in range(4)]
        used = engine._stager is not None or getattr(
            it, "already_staged", False)
        runs.append((losses, _state(engine), used))
        engine.close_data_pipeline()
    (lu, su, used_u), (ls, ss, used_s) = runs
    assert not used_u and used_s
    assert lu == ls  # float-exact
    assert _same_state(su, ss)


def test_loader_stages_itself_at_accum_1_and_not_above():
    engine, loader = _engine(1, True, training_data=_data(8))
    assert loader.stage_to_device
    it = iter(loader)
    assert getattr(it, "already_staged", False)
    float(engine.train_batch(it))
    assert engine._stager is None
    it.close()
    engine2, loader2 = _engine(2, True, training_data=_data(8))
    assert not loader2.stage_to_device
    it2 = iter(loader2)
    float(engine2.train_batch(it2))
    assert engine2._stager is not None
    engine2.close_data_pipeline()
    assert _wait_no_stager_threads() == []


# ---------------------------------------------------------------------------
# end of data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("staged", [False, True])
def test_ragged_window_raises_the_shared_error(staged):
    engine, _ = _engine(accum=2, staged=staged)
    it = iter(_batches(3))
    float(engine.train_batch(it))
    with pytest.raises(RuntimeError, match="1 of gradient_accumulation_"
                       "steps=2") as info:
        engine.train_batch(it)
    assert info.value.ds_unrecoverable
    assert str(info.value) == str(ragged_window_error(1, 2))
    assert engine._stager is None
    assert _wait_no_stager_threads() == []


@pytest.mark.parametrize("staged", [False, True])
def test_clean_exhaustion_raises_stop_iteration(staged):
    engine, _ = _engine(accum=2, staged=staged)
    it = iter(_batches(4))
    for _ in range(2):
        float(engine.train_batch(it))
    with pytest.raises(StopIteration):
        engine.train_batch(it)
    assert engine.global_steps == 2 and engine._stager is None


def test_epoch_boundary_refill_matches_a_single_stream():
    """Two epochs of a loader, each a fresh iterator, staged: the second
    epoch's stager picks up where the first left off, and the run equals
    the same batches fed unstaged."""
    runs = []
    for staged in (False, True):
        engine, loader = _engine(2, staged, training_data=_data(8))
        losses = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            it = iter(loader)
            while True:
                try:
                    losses.append(float(engine.train_batch(it)))
                except StopIteration:
                    break
        runs.append((losses, _state(engine)))
        engine.close_data_pipeline()
    assert len(runs[0][0]) == 4
    assert runs[0][0] == runs[1][0] and _same_state(runs[0][1], runs[1][1])


def test_fresh_iterator_per_call_falls_back_unstaged():
    engine, _ = _engine(accum=1, staged=True)
    for seed in range(5):
        float(engine.train_batch(iter(_batches(1, seed=seed))))
    assert engine.global_steps == 5
    assert engine._stager is None and engine._stager_churn >= 2
    assert _wait_no_stager_threads() == []
    # not a latch: one persistent iterator re-engages staging
    it = iter(_batches(4, seed=9))
    float(engine.train_batch(it))
    assert engine._stager is None
    float(engine.train_batch(it))
    assert engine._stager is not None
    engine.close_data_pipeline()


# ---------------------------------------------------------------------------
# thread hygiene
# ---------------------------------------------------------------------------
def test_no_thread_leak_across_stager_lifecycles():
    before = len(_stager_threads())
    for _ in range(3):
        engine, _ = _engine(accum=1, staged=True)
        float(engine.train_batch(iter(_batches(3))))
        it = iter(_batches(3, seed=7))
        float(engine.train_batch(it))
        float(engine.train_batch(it))
        engine.close_data_pipeline()
    assert len(_wait_no_stager_threads()) <= before


def test_abandoned_engine_does_not_leak_its_stager():
    import itertools

    engine, _ = _engine(accum=1, staged=True)
    it = itertools.cycle(_batches(2))
    float(engine.train_batch(it))
    assert _stager_threads()
    del engine
    gc.collect()
    assert _wait_no_stager_threads() == []


def test_stager_close_is_idempotent_and_bounded():
    def slow():
        while True:
            time.sleep(0.05)
            yield _batches(1)[0]

    stager = WindowStager(slow(), accum=2, buffers=2, device="cpu")
    assert stager.get_window(timeout=5.0).arrays
    t0 = time.monotonic()
    stager.close(timeout=2.0)
    stager.close(timeout=2.0)
    assert time.monotonic() - t0 < 2.5
    assert stager.closed and not stager.alive()


def test_get_window_detects_a_dead_worker():
    stager = WindowStager(iter(_batches(4)), accum=1, buffers=1,
                          device="cpu")
    stager.get_window(timeout=5.0)
    stager._stop.set()  # the worker exits without an end-of-stream mark
    stager._slots.release()
    stager._thread.join(timeout=5.0)
    with pytest.raises(RuntimeError, match="died without signalling"):
        stager.get_window(timeout=0.05)
    stager.close()


# ---------------------------------------------------------------------------
# faults, rollback, preemption
# ---------------------------------------------------------------------------
def test_staging_worker_fault_heals_and_the_loader_rewinds(tmp_path):
    """A supervised staged run fed by a ReplayableDataSource over the
    loader: grads.nan in window 3 and then a staging.worker death each
    roll back to the window-2 checkpoint, and the run equals an
    unpoisoned one bit for bit."""
    def run(faults):
        res = {"supervisor": {"enabled": True, "nonfinite_window": 1}}
        if faults:
            res["fault_injection"] = {"enabled": True, "faults": faults}
        engine, loader = _engine(
            2, True, training_data=_data(12, weighted=True),
            extra={"resilience": res}, model_cls=WeightedGPT2)
        src = ReplayableDataSource(loader.iter_from)
        losses = [float(engine.train_batch(src)) for _ in range(2)]
        engine.save_checkpoint(str(tmp_path / str(bool(faults))))
        losses += [float(engine.train_batch(src)) for _ in range(3)]
        snap = engine.resilience.registry.snapshot()
        engine.close_data_pipeline()
        return losses, _state(engine), snap

    want, want_state, _ = run(None)
    got, got_state, snap = run([
        {"site": "grads.nan", "after": 2, "times": 1},
        {"site": "staging.worker", "after": 5, "times": 1},
    ])
    assert snap["resilience/rollbacks"] == 2
    assert snap["resilience/faults_injected"] == 2
    assert got == want and _same_state(got_state, want_state)
    assert _wait_no_stager_threads() == []


def test_staging_worker_fault_fires_on_the_worker_thread_only():
    seen = []

    def fault_fn(site):
        seen.append((site, threading.current_thread().name))

    stager = WindowStager(iter(_batches(2)), accum=1, buffers=1,
                          fault_fn=fault_fn, stage_to_device=False,
                          device="cpu")
    stager.get_window(timeout=5.0)
    stager.close()
    worker = [name for site, name in seen if site == "staging.worker"]
    assert worker and all(n.startswith("ds-window-stager") for n in worker)
    # placement deferred to the consumer fires there
    assert ("staging.device_put", threading.current_thread().name) in seen


def test_preemption_drain_exit_closes_the_stager(tmp_path, monkeypatch):
    from deepspeed_tpu_torch.resilience import preemption

    engine, _ = _engine(accum=1, staged=True, extra={"resilience": {
        "preemption": {"enabled": True, "save_dir": str(tmp_path)}}})
    kills = []
    monkeypatch.setattr(preemption.os, "kill",
                        lambda pid, sig: kills.append(sig))
    try:
        it = iter(_batches(6))
        float(engine.train_batch(it))
        assert engine._stager is not None
        engine.resilience.preemption.arm(signal.SIGTERM)
        float(engine.train_batch(it))
        assert kills == [signal.SIGTERM]
        assert engine._stager is None
        assert _wait_no_stager_threads() == []
    finally:
        engine.resilience.preemption.uninstall()


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def test_staging_feeds_the_dataloader_rows(tmp_path):
    engine, _ = _engine(accum=2, staged=True, extra={"telemetry": {
        "enabled": True, "output_path": str(tmp_path), "job_name": "st",
        "watchdog": {"enabled": False}}})
    it = iter(_batches(6))
    for _ in range(3):
        float(engine.train_batch(it))
    snap = engine.telemetry.registry.snapshot()
    engine.close()
    assert snap["dataloader/h2d_bytes"] == 6 * 2 * MICRO * SEQ * 8
    assert snap["dataloader/staging_time_ms/count"] >= 3
    assert snap["dataloader/staging_wait_ms/count"] == 3


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block", [
    {"data_pipeline": {"staging_buffers": 0}},
    {"data_pipeline": {"staging_buffers": True}},
    {"data_pipeline": {"staging_buffers": "2"}},
    {"data_pipeline": {"enabled": "yes"}},
    {"data_pipeline": {"stage_to_device": 1}},
    {"compile_cache": {"enabled": "on"}},
    {"compile_cache": {"cache_dir": 7}},
    {"compile_cache": {"min_compile_time_secs": -1}},
    {"compile_cache": {"min_compile_time_secs": "1"}},
])
def test_config_rejections_match_jax(block):
    cfg = {"train_batch_size": 8, **block}
    with pytest.raises(JConfigError) as want:
        JConfig(None, param_dict=cfg, world_size=1)
    with pytest.raises(DeepSpeedConfigError) as got:
        DeepSpeedConfig(None, param_dict=cfg, world_size=1, training=True)
    assert str(got.value) == str(want.value)


def test_config_defaults_match_jax():
    pd = {"train_batch_size": 8}
    want = JConfig(None, param_dict=pd, world_size=1)
    got = DeepSpeedConfig(None, param_dict=pd, world_size=1, training=True)
    for field in ("data_pipeline_enabled", "data_pipeline_staging_buffers",
                  "data_pipeline_stage_to_device", "compile_cache_enabled",
                  "compile_cache_dir", "compile_cache_min_compile_time_secs"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.data_pipeline_stage_to_device, got.compile_cache_dir,
            got.data_pipeline_staging_buffers) == (True, "", 2)


def test_compile_cache_second_initialize_resolves_the_same_build_dir(
        tmp_path):
    cache = tmp_path / "kernels"
    extra = {"compile_cache": {"enabled": True, "cache_dir": str(cache)}}
    try:
        _engine(extra=extra)
        first = kernel_lib.BUILD_DIR
        _engine(extra=extra)
        assert kernel_lib.BUILD_DIR == first == cache
        assert kernel_lib.library_path("flash_fwd").parent == cache
        assert cache.is_dir()
    finally:
        compile_cache.disarm_compile_cache()
    assert kernel_lib.BUILD_DIR == compile_cache.DEFAULT_BUILD_DIR


def test_compile_cache_off_or_unwritable_keeps_the_default(tmp_path):
    cfg = DeepSpeedConfig(None, param_dict={"train_batch_size": 8},
                          world_size=1)
    assert compile_cache.configure_compile_cache(cfg) is None
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert compile_cache.arm_compile_cache(str(blocker / "sub")) is None
    assert kernel_lib.BUILD_DIR == compile_cache.DEFAULT_BUILD_DIR


def test_stagers_under_a_short_switch_interval_lose_nothing():
    """More stagers than cores, consumed from as many threads with the
    interpreter switching every microsecond: every window arrives once, in
    order, and the counters agree with what was consumed."""
    import os
    import sys

    n = (os.cpu_count() or 2) + 2
    errors = []

    def consume(k):
        items = [(torch.tensor([k, i]),) for i in range(60)]
        stager = WindowStager(iter(items), accum=3, buffers=2,
                              device="cpu")
        try:
            got = []
            while True:
                try:
                    w = stager.get_window(timeout=5.0)
                except StopIteration:
                    break
                got += [int(b[0][1]) for b in w.arrays]
            if (got != list(range(60)) or stager.windows_served != 20
                    or stager.unconsumed_micro_batches() != 0):
                errors.append((k, got[:6], stager.windows_served))
        except Exception as e:  # reported by the assertion below
            errors.append((k, repr(e)))
        finally:
            stager.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(k,))
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert _wait_no_stager_threads() == []
