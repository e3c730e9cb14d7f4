"""The GPT-2 side of the ZeRO parity tests (not a test module): the JAX
engine's oracle runs and the port's rank spawns for
tests/test_torch_zero_gpt2*.py.

A 2-layer GPT-2 at width 64 (vocab 256, sequence 32, dropout 0) trains 5
windows of 2 micro-batches at lr 1e-4. The JAX engine runs on a mesh of
the rank count's data size (``build_mesh(devices=jax.devices()[:dp])``)
from the same weights (``params_from_jax``), fed the global batches; the
port's ranks feed their rows (tests/torch_dp_ranks.py).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import torch_dp_ranks as ranks
from deepspeed_tpu.adapters import lora as jlora
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import params_from_jax

STEPS, MICRO, ACCUM, LR = 5, 2, 2, 1e-4
TOL = dict(rtol=2e-4, atol=1e-5)
OPTS = {"adam": ("Adam", "fp32"), "lamb": ("Lamb", "fp32"),
        "fusedlamb": ("FusedLamb", "fp32"), "int8": ("Adam", "int8")}


def fresh_jmodel():
    """A JAX GPT-2 with a config object of its own: a stage-3 JAX engine
    arms its gather on the config, so concurrent oracles must not share
    one."""
    return JGPT2LMHeadModel(JGPT2Config(
        vocab_size=ranks.VOCAB, n_positions=ranks.SEQ, n_embd=64,
        n_layer=2, n_head=4, dropout=0.0))


def jmodel():
    """A JAX GPT-2 and its weights from PRNGKey(0)."""
    model = fresh_jmodel()
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)}, ids, ids)["params"]
    return model, params


def jadapters(params, rank, seed=7):
    """A rank-``rank`` adapter for the JAX GPT-2's weights: A from the
    JAX initializer, B noised so that both factors train from the first
    window (numpy leaves)."""
    tree = jax.device_get(jlora.init_lora_params(
        params, rank, rng=jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def noise(path, leaf):
        leaf = np.asarray(leaf, np.float32)
        if jax.tree_util.keystr(path).endswith("_lora_b']"):
            return (0.02 * rng.normal(size=leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(noise, tree)


def merged(params, adapters):
    """The JAX weights with the adapter's factors merged in (the JAX
    engine's ``model_parameters`` for a fine-tune from them)."""
    return jlora.merge_lora_params(
        jax.tree_util.tree_map(np.asarray, jax.device_get(params)), adapters)


def cases(keys, variants=None):
    """Stages 0-3 for each optimizer key, then the stage-3 Adam
    ``variants`` ({name: case fields})."""
    base = {"kind": "train", "model": "gpt2", "steps": STEPS,
            "accum": ACCUM, "micro": MICRO, "lr": LR, "weights": "gpt2.pt"}
    out = [dict(base, name=f"{k}-s{stage}", stage=stage, opt=OPTS[k][0],
                dtype=OPTS[k][1]) for k in keys for stage in range(4)]
    out += [dict(base, name=f"adam-{v}", stage=3, opt="Adam", dtype="fp32",
                 **spec) for v, spec in (variants or {}).items()]
    return out


def jax_engine(model, params, dp, stage, opt, dtype):
    cfg = ranks.config(stage, opt, dtype, MICRO, ACCUM, dp, lr=LR)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=params, config_params=cfg,
        mesh=build_mesh(devices=jax.devices()[:dp]))
    return engine


def jax_run(params, dp, key, stage):
    """The JAX engine's window losses and final fp32 parameters (in the
    port's names and layout), on a model of its own."""
    opt, dtype = OPTS[key]
    engine = jax_engine(fresh_jmodel(), params, dp, stage, opt, dtype)
    losses = [float(engine.train_batch(iter(win))) for win in
              ranks.windows("gpt2", STEPS, ACCUM, MICRO * dp)]
    final = engine.params
    if engine.master_in_opt:
        final = engine.optimizer_state["master"]
    got = params_from_jax(jax.device_get(final))
    return losses, {n: t.float().numpy() for n, t in got.items()}


def run(tmp_path_factory, spawns, oracles):
    """Start ``spawns`` ([(dp, cases)]), compute the ``oracles``
    ({(dp, key): JAX stage}) meanwhile, each in a thread of its own, and
    return (the ranks' results merged by dp, the oracles, (model,
    params))."""
    model, params = jmodel()
    state = params_from_jax(jax.device_get(params))
    handles = []
    for i, (dp, group) in enumerate(spawns):
        d = tmp_path_factory.mktemp(f"gpt2_{i}")
        torch.save(state, d / "gpt2.pt")
        handles.append((dp, ranks.start(dp, group, d)))
    with ThreadPoolExecutor(len(oracles)) as pool:
        futures = {k: pool.submit(jax_run, params, *k, stage)
                   for k, stage in oracles.items()}
        oracle = {k: f.result() for k, f in futures.items()}
    port = {}
    for dp, h in handles:
        got = ranks.finish(h, timeout=300)
        port[dp] = got if dp not in port else [
            {**a, **b} for a, b in zip(port[dp], got)]
    return port, oracle, (model, params)


def check(results, name, want_losses, want_params):
    """Every rank's losses equal; rank 0's losses and parameters equal
    the oracle's to TOL."""
    got = results[0][name]
    for r in results[1:]:
        assert r[name]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, **TOL)
    assert set(got["params"]) == set(want_params)
    for n, want in want_params.items():
        np.testing.assert_allclose(got["params"][n], want, err_msg=n, **TOL)
