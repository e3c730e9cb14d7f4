"""Port parity: the monitor (utils/monitor.py), the ``tensorboard`` block
and ``wall_clock_breakdown`` / ``memory_breakdown`` in the training
engine, against the JAX package's (oracles: tests/unit/test_monitor.py
and test_wall_clock_breakdown.py).

Both engines train the same tiny GPT-2 (2 layers, n_embd 64, seq 64,
float32, dropout 0, the same weights) for 4 windows on the same numpy
batches with the ``tensorboard`` block on. Their ``Train/*`` streams must
carry the same tags at the same steps: ``Train/lr`` and
``Train/loss_scale`` exactly, ``Train/loss`` at rtol 1e-5 and
``Train/grad_norm`` at rtol 1e-4 (float32 through two layers and the
blocked cross-entropy, summed in other orders: the engine parity test's
tolerances). Through PyTorch's TensorBoard writer both sides store
float32, compared the same way.
"""

import json
import logging
import os

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
from deepspeed_tpu.utils import monitor as jmonitor
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel, params_from_jax
from deepspeed_tpu_torch.runtime import engine as tengine_mod
from deepspeed_tpu_torch.utils import monitor as tmonitor
from deepspeed_tpu_torch.utils.logging import logger as tlogger
from torch_test_env import jax_compile_cache  # noqa: F401

VOCAB = 256
SEQ = 64


# ---------------------------------------------------------------------------
# the writers
# ---------------------------------------------------------------------------
def _lines(path):
    out = []
    for line in open(path).read().splitlines():
        rec = json.loads(line, parse_constant=lambda s: pytest.fail(s))
        rec.pop("wall_time")
        out.append(rec)
    return out


def test_jsonl_writer_writes_what_the_reference_writes(tmp_path):
    for pkg, mod in (("jax", jmonitor), ("torch", tmonitor)):
        w = mod.JsonlSummaryWriter(str(tmp_path / pkg))
        w.add_scalar("Train/loss", 1.5, global_step=3)
        w.add_scalar("Train/loss", float("nan"), global_step=4)
        w.add_scalar("Train/grad_norm", float("inf"), global_step=4)
        w.add_scalar("Train/lr", np.float32(0.01), global_step=4)
        w.add_record({"tag": "h", "kind": "histogram", "count": 2,
                      "wall_time": 0.0})
        w.close()
    got = _lines(tmp_path / "torch" / "events.jsonl")
    assert got == _lines(tmp_path / "jax" / "events.jsonl")
    assert got[1] == {"tag": "Train/loss", "value": None, "step": 4,
                      "finite": False}


def test_monitor_disabled_is_a_noop():
    m = tmonitor.Monitor(enabled=False)
    m.write_scalars({"a": 1.0}, 1)
    m.close()
    assert m.writer is None


def test_summary_writer_falls_back_to_jsonl_without_tensorboard(
        tmp_path, monkeypatch):
    """Without the tensorboard package the writer is the JSONL one,
    events.jsonl in the same directory."""
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    w = tmonitor.get_summary_writer(name="job", base=str(tmp_path))
    assert isinstance(w, tmonitor.JsonlSummaryWriter)
    w.add_scalar("Train/lr", 0.5, global_step=1)
    w.close()
    assert _lines(tmp_path / "job" / "events.jsonl") == [
        {"tag": "Train/lr", "value": 0.5, "step": 1}]


# ---------------------------------------------------------------------------
# the engines' Train/* streams
# ---------------------------------------------------------------------------
def _models():
    jcfg = JGPT2Config(vocab_size=VOCAB, n_positions=SEQ, n_embd=64,
                       n_layer=2, n_head=4, dropout=0.0)
    jmodel = JGPT2LMHeadModel(jcfg)
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        ids0, ids0,
    )["params"]
    model = GPT2LMHeadModel(
        GPT2Config(vocab_size=VOCAB, n_positions=SEQ, n_embd=64, n_layer=2,
                   n_head=4, dropout=0.0),
        device="cpu",
    )
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model


def _config(out, **extra):
    cfg = {
        "train_batch_size": 4,
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 3}},
        "gradient_clipping": 1.0,
        "steps_per_print": 1000,
        "tensorboard": {"enabled": True, "output_path": str(out),
                        "job_name": "job"},
    }
    cfg.update(extra)
    return cfg


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, VOCAB, (2, SEQ)).astype(np.int32)
             for _ in range(2)] for _ in range(n)]


def _scalars(job_dir):
    """{tag: [(step, value)]} from events.jsonl or TensorBoard files."""
    files = os.listdir(job_dir)
    out = {}
    if "events.jsonl" in files:
        for rec in _lines(os.path.join(job_dir, "events.jsonl")):
            out.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
        return out
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(job_dir))
    acc.Reload()
    for tag in acc.Tags()["scalars"]:
        out[tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
    return out


def _train_both(tmp_path, windows=4, **extra):
    jmodel, params, model = _models()
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params,
        config_params=_config(tmp_path / "jax", **extra),
        mesh=build_mesh(devices=jax.devices()[:1]),
    )
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=_config(tmp_path / "torch", **extra),
        device="cpu")
    # forward/backward/step: the JAX engine's fused train_batch donates
    # the loss-scale state its deferred monitor entry still holds
    for window in _windows(windows):
        for engine, conv in ((jeng, jnp.asarray),
                             (teng, lambda x: torch.from_numpy(x).long())):
            for x in window:
                ids = conv(x)
                engine.backward(engine(ids, ids))
            engine.step()
    jeng.flush_monitor()
    jeng.monitor.close()
    teng.close()
    return (_scalars(tmp_path / "jax" / "job"),
            _scalars(tmp_path / "torch" / "job"))


@pytest.mark.parametrize("writer", ["jsonl", "tensorboard"])
def test_train_scalars_match_the_jax_engine(writer, tmp_path, monkeypatch):
    if writer == "jsonl":
        for mod in (jmonitor, tmonitor):
            monkeypatch.setattr(
                mod, "get_summary_writer",
                lambda name, base, mod=mod: mod.JsonlSummaryWriter(
                    os.path.join(base, name)))
    want, got = _train_both(tmp_path)
    assert set(got) == set(want) == {"Train/lr", "Train/loss_scale",
                                     "Train/loss", "Train/grad_norm"}
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] == [
            1, 2, 3, 4], tag
    assert got["Train/lr"] == want["Train/lr"]
    assert got["Train/loss_scale"] == want["Train/loss_scale"]
    np.testing.assert_allclose([v for _, v in got["Train/loss"]],
                               [v for _, v in want["Train/loss"]], rtol=1e-5)
    np.testing.assert_allclose([v for _, v in got["Train/grad_norm"]],
                               [v for _, v in want["Train/grad_norm"]],
                               rtol=1e-4)
    # the warmup moves the rate: the stream is not a constant
    assert len({v for _, v in got["Train/lr"]}) >= 3


def test_tensorboard_block_is_obeyed_not_ignored(tmp_path):
    """A config with the tensorboard block on writes Train/* scalars,
    and one with wall_clock_breakdown and memory_breakdown on exposes
    them and logs (the port once built such a config and wrote and
    logged nothing)."""
    _, _, model = _models()
    cfg = _config(tmp_path, wall_clock_breakdown=True, memory_breakdown=True)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfg, device="cpu")
    assert engine.config.tensorboard_enabled
    assert engine.config.wall_clock_breakdown
    assert engine.config.memory_breakdown
    for window in _windows(2):
        t = [torch.from_numpy(x).long() for x in window]
        engine.train_batch([(x, x) for x in t])
    engine.close()
    scalars = _scalars(tmp_path / "job")
    assert [s for s, _ in scalars["Train/loss"]] == [1, 2]


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture()
def captured_log():
    h = _Capture()
    tlogger.addHandler(h)
    yield h.lines
    tlogger.removeHandler(h)


def test_wall_clock_breakdown_logs_the_reference_timer_names(captured_log):
    from deepspeed_tpu.runtime import engine as jengine_mod

    for name in ("FORWARD_TIMER", "BACKWARD_TIMER", "STEP_TIMER",
                 "TRAIN_BATCH_TIMER"):
        assert getattr(tengine_mod, name) == getattr(jengine_mod, name)
    _, _, model = _models()
    cfg = _config("unused", steps_per_print=2, wall_clock_breakdown=True,
                  memory_breakdown=True)
    del cfg["tensorboard"]
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfg, device="cpu")
    windows = _windows(4)
    for window in windows[:2]:  # the train_batch window
        t = [torch.from_numpy(x).long() for x in window]
        engine.train_batch([(x, x) for x in t])
    for window in windows[2:]:  # forward / backward / step
        for x in window:
            ids = torch.from_numpy(x).long()
            engine.backward(engine(ids, ids))
        engine.step()
    for name in ("forward", "backward", "step", "train_batch_window"):
        assert engine.timers.has_timer(name), name
    breakdown = [l for l in captured_log if "time (ms)" in l]
    assert len(breakdown) == 2
    for line in breakdown:
        for name in ("forward", "backward", "step"):
            assert f"| {name}: " in line, line
    windows_line = [l for l in captured_log if "train_batch window" in l]
    assert len(windows_line) == 1 and "samples/s" in windows_line[0]
    assert sum("device mem" in l for l in captured_log) == 2


def test_breakdown_off_builds_no_timer():
    _, _, model = _models()
    cfg = _config("unused")
    del cfg["tensorboard"]
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfg, device="cpu")
    x = torch.from_numpy(_windows(1)[0][0]).long()
    engine.train_batch([(x, x), (x, x)])
    assert engine.timers.timers == {}
    assert not engine.monitor.enabled and not engine.telemetry.enabled
