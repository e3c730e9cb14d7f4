"""Engine-level telemetry parity: both engines with the ``telemetry``
block on, against the JAX package's.

Training: the tiny GPT-2 (2 layers, n_embd 64, seq 64, float32, dropout
0, the same weights) trains 5 windows in both engines under
``telemetry.interval`` 2 with the jsonl and Prometheus exporters, the
watchdog and tracing on. ``metrics.jsonl`` must hold the same names
(the JAX engine's ``jax/*`` rows are absent by design) at the same
export steps, with ``train/loss`` at rtol 1e-5, ``train/grad_norm`` at
rtol 1e-4 (the engine parity test's tolerances), and
``train/learning_rate``, ``train/loss_scale``, ``train/global_steps`` and
``train/skipped_steps`` exactly equal.

Serving: the JAX package's small serving model in both engines with
``telemetry.tracing`` on, the same prompts, greedy: the exported trace
must give each request the same span names, and the same prefill
attributes.
"""

import collections
import json
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.telemetry.tracing import load_chrome_trace as jload
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel, params_from_jax
from deepspeed_tpu_torch.telemetry.tracing import load_chrome_trace
from torch_test_env import jax_compile_cache  # noqa: F401

ABSENT_BY_DESIGN = {"jax/recompiles", "jax/compile_cache_hits",
                    "jax/compile_cache_misses"}


def _models(vocab, seq, n_embd, n_layer, n_head):
    jcfg = JGPT2Config(vocab_size=vocab, n_positions=seq, n_embd=n_embd,
                       n_layer=n_layer, n_head=n_head, dropout=0.0,
                       use_flash=False)
    jmodel = JGPT2LMHeadModel(jcfg)
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        ids0, ids0,
    )["params"]
    model = GPT2LMHeadModel(
        GPT2Config(vocab_size=vocab, n_positions=seq, n_embd=n_embd,
                   n_layer=n_layer, n_head=n_head, dropout=0.0),
        device="cpu",
    )
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model


def _telemetry(out, **extra):
    block = {"enabled": True, "output_path": str(out), "job_name": "job",
             "exporters": ["jsonl", "prometheus"],
             "watchdog": {"timeout": 600.0},
             "tracing": {"enabled": True}}
    block.update(extra)
    return block


def _exports(path):
    """{step: {tag: value}} from metrics.jsonl (histograms by count)."""
    out = collections.defaultdict(dict)
    for line in open(path).read().splitlines():
        rec = json.loads(line)
        value = rec["count"] if rec.get("kind") == "histogram" else rec[
            "value"]
        out[rec["step"]][rec["tag"]] = value
    return dict(out)


def test_training_metrics_match_the_jax_engine(tmp_path):
    jmodel, params, model = _models(256, 64, 64, 2, 4)
    cfgs = []
    for pkg in ("jax", "torch"):
        cfgs.append({
            "train_batch_size": 4,
            "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_max_lr": 1e-3,
                                     "warmup_num_steps": 3}},
            "gradient_clipping": 1.0,
            "steps_per_print": 1000,
            "telemetry": _telemetry(tmp_path / pkg, interval=2),
        })
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params, config_params=cfgs[0],
        mesh=build_mesh(devices=jax.devices()[:1]))
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfgs[1], device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(5):  # 5 windows: the fifth settles at flush
        window = [rng.integers(0, 256, (2, 64)).astype(np.int32)
                  for _ in range(2)]
        for engine, conv in ((jeng, jnp.asarray),
                             (teng, lambda x: torch.from_numpy(x).long())):
            for x in window:
                ids = conv(x)
                engine.backward(engine(ids, ids))
            engine.step()
    jeng.telemetry.close()
    teng.close()
    want = _exports(tmp_path / "jax" / "job" / "metrics.jsonl")
    got = _exports(tmp_path / "torch" / "job" / "metrics.jsonl")
    assert sorted(got) == sorted(want) == [2, 4, 5]
    for step in want:
        assert set(got[step]) == set(want[step]) - ABSENT_BY_DESIGN, step
        for tag in ("train/learning_rate", "train/loss_scale",
                    "train/global_steps", "train/skipped_steps",
                    "train/micro_steps"):
            assert got[step][tag] == want[step][tag], (step, tag)
        np.testing.assert_allclose(got[step]["train/loss"],
                                   want[step]["train/loss"], rtol=1e-5)
        np.testing.assert_allclose(got[step]["train/grad_norm"],
                                   want[step]["train/grad_norm"], rtol=1e-4)
        assert got[step]["train/window_time_ms"] == step
    # the Prometheus textfile carries the same families
    prom = open(tmp_path / "torch" / "job" / "metrics.prom").read()
    assert "# TYPE train_loss gauge" in prom
    assert "train_global_steps 5.0" in prom
    # the training window spans (the port has no data stager)
    spans = load_chrome_trace(str(tmp_path / "torch" / "job" / "trace.json"))
    assert [e["name"] for e in spans] == ["train.window"] * 5
    assert len({e["args"]["trace_id"] for e in spans}) == 1


VOCAB = 97
PROMPTS = ([5, 17, 3, 88, 42, 7, 9, 1, 60, 2, 33],
           [5, 17, 3, 88, 42, 7, 9, 1, 60, 2, 33, 12, 70, 71],  # a prefix hit
           [40, 41])


def _requests(path, loader):
    """Per request (root span ``sched.request``, in prompt order): the
    sorted span names of its trace, and its prefill attributes."""
    events = loader(str(path))
    by_trace = collections.defaultdict(list)
    for e in events:
        by_trace[e["args"]["trace_id"]].append(e)
    out = []
    for evs in by_trace.values():
        names = sorted(e["name"] for e in evs)
        if "sched.request" not in names:
            continue  # the decode driver's own trace
        prefill = [e["args"] for e in evs if e["name"] == "sched.prefill"]
        attrs = {k: prefill[0].get(k) for k in (
            "prompt_tokens", "prefix_hit", "prefix_len", "suffix_bucket")}
        out.append((names, attrs))
    return sorted(out, key=lambda r: (r[1]["prompt_tokens"], r[0]))


def _driver_spans(path, loader):
    return sorted({e["name"] for e in loader(str(path))})


def test_serving_spans_match_the_jax_engine(tmp_path):
    jmodel, params, model = _models(VOCAB, 64, 32, 2, 4)
    block = {"max_batch_slots": 4, "max_seq_len": 48, "prefill_len": 32,
             "kv_block_size": 4, "sampling": {"greedy": True},
             "fused_decode": True}
    outs = []
    for pkg in ("jax", "torch"):
        config = {"inference": block, "telemetry": _telemetry(tmp_path / pkg)}
        if pkg == "jax":
            engine = deepspeed_tpu.init_inference(
                model=jmodel, model_parameters=params, config=config)
        else:
            engine = deepspeed_tpu_torch.init_inference(
                model=model, config=config, device="cpu")
        try:
            # one by one: the second request finds the first's pages
            outs.append([engine.generate([p], max_new_tokens=5)[0]
                         for p in PROMPTS])
        finally:
            engine.close()
    assert outs[0] == outs[1]
    want = _requests(tmp_path / "jax" / "job" / "trace.json", jload)
    got = _requests(tmp_path / "torch" / "job" / "trace.json",
                    load_chrome_trace)
    assert got == want and len(got) == len(PROMPTS)
    assert any(attrs["prefix_hit"] for _, attrs in got)
    assert _driver_spans(tmp_path / "torch" / "job" / "trace.json",
                         load_chrome_trace) == _driver_spans(
        tmp_path / "jax" / "job" / "trace.json", jload)
    # the infer/* catalog was exported at close, beside the trace
    exported = set()
    for line in open(tmp_path / "torch" / "job" / "metrics.jsonl"):
        exported.add(json.loads(line)["tag"])
    from deepspeed_tpu_torch.telemetry.manager import INFERENCE_METRICS

    assert {n for _, n, _ in INFERENCE_METRICS} <= exported
    assert os.path.exists(tmp_path / "torch" / "job" / "metrics.prom")
