"""The tensor-parallel side of the parity tests (not a test module): the
JAX engine's oracle runs on a data x model mesh and the port's rank
spawns, for tests/test_torch_model_parallel*.py.

The model is tests/torch_dp_gpt2.py's GPT-2 (2 layers, width 64, 4
heads, vocab 256, sequence 32, dropout 0) and its data and schedule (5
windows of 2 micro-batches at lr 1e-4). The JAX engine runs on
``build_mesh(data_parallel_size=dp, model_parallel_size=mp,
devices=jax.devices()[:dp * mp])`` with ``param_specs=
partition_specs(params)``, as tests/model/test_gpt2_loss_parity.py
builds its tensor-parallel layouts, fed the global batches; the port's
ranks (tests/torch_dp_ranks.py, ``mp_*`` cases) feed their data rank's
rows, each model rank of a line the same ones.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import torch

import deepspeed_tpu
import torch_dp_gpt2 as g
import torch_dp_ranks as ranks
from deepspeed_tpu.models.gpt2 import partition_specs as jpartition_specs
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import adapters_from_jax, params_from_jax
from deepspeed_tpu_torch.convert import _MATRICES

TOL = g.TOL


def specs_from_jax(specs, tree):
    """The JAX package's GPT-2 ``partition_specs`` tree (PartitionSpec
    leaves, beside the parameter tree ``tree`` it was made for) -> the
    port's ``{name: spec}``: a tuple of one entry per dim of the port's
    tensor, the stacked layer dim dropped and the block matrices'
    entries reversed as their weights are transposed."""
    def full(spec, ndim):
        spec = tuple(spec)
        return spec + (None,) * (ndim - len(spec))

    ts, tt = specs["transformer"], tree["transformer"]
    out = {"wte": full(ts["wte"], 2), "wpe": full(ts["wpe"], 2),
           "ln_f.weight": full(ts["ln_f"]["scale"], 1),
           "ln_f.bias": full(ts["ln_f"]["bias"], 1)}
    for name, spec in ts["h"].items():
        stacked = np.asarray(tt["h"][name])
        entry = full(spec, stacked.ndim)[1:]
        if name in _MATRICES:
            entry = entry[::-1]
        for i in range(stacked.shape[0]):
            out[f"h.{i}.{name}"] = entry
    return out


def jax_engine(model, params, dp, mp, stage, opt, dtype, specs=True,
               **extra):
    """The JAX engine on a dp x mp mesh of the first dp * mp devices."""
    cfg = ranks.config(stage, opt, dtype, g.MICRO, g.ACCUM, dp, lr=g.LR,
                       **extra)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=params, config_params=cfg,
        mesh=build_mesh(data_parallel_size=dp, model_parallel_size=mp,
                        devices=jax.devices()[:dp * mp]),
        param_specs=jpartition_specs(params) if specs else None)
    return engine


def jax_run(params, dp, mp, stage, opt, dtype, specs=True, factors=False,
            model=None, coeffs=False, **extra):
    """The JAX engine's window losses and final trainable float32
    parameters in the port's names (whole tensors), on a model of its
    own; with ``coeffs`` also its last step's LAMB trust ratios."""
    engine = jax_engine(model or g.fresh_jmodel(), params, dp, mp, stage,
                        opt, dtype, specs, **extra)
    losses = [float(engine.train_batch(iter(win))) for win in
              ranks.windows("gpt2", g.STEPS, g.ACCUM, g.MICRO * dp)]
    final = jax.device_get(engine.params)
    if engine.master_in_opt:
        final = jax.device_get(engine.optimizer_state["master"])
    got = adapters_from_jax(final) if factors else params_from_jax(final)
    out = (losses, {n: t.float().numpy() for n, t in got.items()})
    if coeffs:
        out += (np.asarray(jax.device_get(engine.lamb_coeffs), np.float64),)
    return out


def case(name, mp, **fields):
    """A port ``mp_train`` case on the module's model and schedule."""
    base = {"kind": "mp_train", "model": "gpt2", "weights": "gpt2.pt",
            "steps": g.STEPS, "accum": g.ACCUM, "micro": g.MICRO,
            "lr": g.LR, "mp": mp, "stage": 0, "opt": "Adam",
            "dtype": "fp32"}
    return dict(base, name=name, **fields)


def check(results, name, want_losses, want_params, loss_tol=TOL,
          param_close=None):
    """Every rank's losses equal; rank 0's losses and whole parameters
    equal the oracle's (to ``TOL`` or by ``param_close``)."""
    got = results[0][name]
    for r in results[1:]:
        assert r[name]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, **loss_tol)
    assert set(got["params"]) == set(want_params)
    if param_close is not None:
        param_close(got["params"], want_params)
        return
    for n, want in want_params.items():
        np.testing.assert_allclose(got["params"][n], want, err_msg=n, **TOL)


# ---------------------------------------------------------------------------
# the ZeRO-stage layouts of tests/test_torch_model_parallel*.py
# ---------------------------------------------------------------------------
MP = 2
OPTS = {"adam": "Adam", "fusedlamb": "FusedLamb"}
# the JAX oracle's stage per (data size, optimizer), rotated so that every
# stage is an oracle
JAX_STAGE = {(1, "adam"): 0, (1, "fusedlamb"): 2, (2, "adam"): 3,
             (2, "fusedlamb"): 1}
# above one data rank, also Adam with int8 moments at ZeRO stage 2 (the
# optimizer on model-gathered tensors, reduced over the data group once
# a window): (case name, stage)
INT8_CASE = ("int8-s2", 2)


def layout_runs(tmp_path_factory, dp):
    """One spawn of dp x MP ranks with every (optimizer, stage) case,
    while the layout's JAX oracles compute, each in a thread of its own.
    Returns (the ranks' results, {optimizer key: oracle}, the JAX
    weights)."""
    _, params = g.jmodel()
    d = tmp_path_factory.mktemp(f"mp{MP}dp{dp}")
    torch.save(params_from_jax(jax.device_get(params)), d / "gpt2.pt")
    cases = [case(f"{k}-s{s}", MP, stage=s, opt=opt)
             for k, opt in OPTS.items() for s in range(4)]
    name, stage = INT8_CASE
    if dp > 1:
        cases.append(case(name, MP, stage=stage, dtype="int8"))
    handle = ranks.start(dp * MP, cases, d)
    with ThreadPoolExecutor(len(OPTS) + 1) as pool:
        futures = {k: pool.submit(jax_run, params, dp, MP,
                                  JAX_STAGE[(dp, k)], opt, "fp32",
                                  coeffs=True)
                   for k, opt in OPTS.items()}
        if dp > 1:
            futures[name] = pool.submit(jax_run, params, dp, MP, stage,
                                        "Adam", "int8")
        oracle = {k: f.result() for k, f in futures.items()}
    return ranks.finish(handle, timeout=300), oracle, params


def check_layout(runs, key, stage):
    """A port stage's losses and whole parameters against the layout's
    JAX oracle for optimizer ``key``."""
    port, oracle, _ = runs
    check(port, f"{key}-s{stage}", *oracle[key][:2])
    assert port[0][f"{key}-s{stage}"]["skipped"] == 0


def check_int8(runs):
    """int8 moments at ZeRO stage 2 over the data group against the JAX
    engine's int8 run at the same stage."""
    port, oracle, _ = runs
    name = INT8_CASE[0]
    check(port, name, *oracle[name][:2])
    assert port[0][name]["skipped"] == 0


def check_shards(runs):
    """Each rank's coordinates and the local shapes of its Megatron
    shards: the qkv, inter_w (and their biases) and wte rows, attn_ow's
    and output_w's columns."""
    port, _, params = runs
    full = params_from_jax(jax.device_get(params))
    for r, res in enumerate(port):
        got = res["adam-s0"]
        assert tuple(got["coords"]) == (r // MP, r % MP)
        for n, t in full.items():
            leaf = n.rpartition(".")[2]
            want = list(t.shape)
            if leaf in ("wte", "attn_qkvw", "attn_qkvb", "inter_w",
                        "inter_b"):
                want[0] //= MP
            elif leaf in ("attn_ow", "output_w"):
                want[1] //= MP
            assert tuple(got["local_shapes"][n]) == tuple(want), n


def check_lamb_ratios(runs):
    """LAMB's trust ratio is per JAX leaf: every port stage's last ratios
    (on every rank) equal the JAX engine's ``lamb_coeffs``."""
    port, oracle, _ = runs
    want = sorted(oracle["fusedlamb"][2])
    for s in range(4):
        for res in port:
            np.testing.assert_allclose(
                sorted(res[f"fusedlamb-s{s}"]["coeffs"]), want, rtol=1e-4)
