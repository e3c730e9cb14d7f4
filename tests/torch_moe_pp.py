"""The JAX side of the MoE and pipeline parity tests (not a test module),
for tests/test_torch_moe*.py and tests/test_torch_pipeline*.py.

The model is a small GPT-2 (vocab 128, 32 positions, width 64, 2 layers,
4 heads, dropout 0), with 4 MoE experts or 2 pipeline stages. Its weights
come from ONE JAX init (the scanned model's, PRNGKey(0)): the JAX
pipelined stack initialises other values from the same key, so every run
and the port take these (tests/unit/test_pipeline.py feeds its pipelined
model the scanned tree the same way). The JAX engine runs on the data
sub-mesh of the first ``dp`` devices (MoE, ``partition_specs(params)``:
the experts over the data axis) or on a ``pipe=2 x data=dp`` mesh
(``partition_specs(params, pipeline=True)``), fed the global batches;
the port's ranks (tests/torch_dp_ranks.py, ``moe_pp_*`` cases) feed their
data rank's rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deepspeed_tpu
import torch_dp_ranks as ranks
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2LMHeadModel
from deepspeed_tpu.models.gpt2 import partition_specs
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import params_from_jax

STEPS, ACCUM, LR = 2, 2, 1e-4
EXPERTS, STAGES = 4, 2
# rows a data rank feeds a micro-step: MoE, and the pipeline's (its 4
# microbatches of one row)
MOE_MICRO, PP_MICRO, PP_MICRO_BATCHES = 2, 4, 4
TOL = dict(rtol=2e-4, atol=1e-5)
SIZES = dict(vocab_size=ranks.MOE_VOCAB, n_positions=ranks.SEQ, n_embd=64,
             n_layer=2, n_head=4, dropout=0.0)


def jconfig(kind, **over):
    fields = dict(SIZES, **over)
    if kind == "moe":
        fields["moe_experts"] = EXPERTS
    elif kind == "pp":
        fields["pipeline_stages"] = STAGES
        fields.setdefault("pipeline_microbatches", PP_MICRO_BATCHES)
    return JGPT2Config(**fields)


def weights(kind):
    """The JAX weights of ``kind`` ("moe", or the dense tree the pipeline
    runs take), from PRNGKey(0) on the scanned model."""
    model = JGPT2LMHeadModel(jconfig("moe" if kind == "moe" else "dense"))
    ids = jnp.zeros((1, 8), jnp.int32)
    return jax.device_get(jax.jit(lambda k: model.init(
        {"params": k}, ids, ids, train=False))(
            jax.random.PRNGKey(0))["params"])


def save_port_weights(params, path):
    torch.save(params_from_jax(jax.device_get(params)), path)


def jax_run(kind, params, dp, stage, opt, dtype="fp32", steps=STEPS,
            rows=None, n_micro=PP_MICRO_BATCHES, mp=1, extra=None, sp=1,
            int8_state=False, client_int8=False):
    """The JAX engine's window losses, its last ``last_aux`` and its final
    float32 parameters in the port's names; ``rows`` global rows a
    micro-step (default: a data rank's times dp); ``n_micro`` the
    pipeline's microbatches; ``mp`` a model axis (the Megatron specs),
    ``sp`` a sequence axis (MoE); ``extra`` more engine config. Kind
    ``dense``: the dense model on a ``data x model`` mesh. With
    ``int8_state`` a fourth element: the int8 first moment's leaves keyed
    by the port's group names (:func:`int8_groups`). ``client_int8``: a
    client ``Adam(state_dtype="int8")`` in place of the config's."""
    micro = MOE_MICRO if kind == "moe" else PP_MICRO
    if rows is not None:
        micro = rows // dp
    if kind in ("moe", "dense"):
        mesh = build_mesh(data_parallel_size=dp, model_parallel_size=mp,
                          sequence_parallel_size=sp,
                          devices=jax.devices()[:dp * mp * sp])
        specs = partition_specs(params)
    else:
        mesh = build_mesh(data_parallel_size=dp, model_parallel_size=mp,
                          pipeline_parallel_size=STAGES,
                          devices=jax.devices()[:STAGES * dp * mp])
        specs = partition_specs(params, pipeline=True)
    engine, *_ = deepspeed_tpu.initialize(
        model=JGPT2LMHeadModel(jconfig(kind) if kind != "pp" else jconfig(
            kind, pipeline_microbatches=n_micro)),
        optimizer=(deepspeed_tpu.ops.optimizers.Adam(state_dtype="int8")
                   if client_int8 else None),
        model_parameters=params,
        config_params=ranks.config(stage, opt, dtype, micro, ACCUM, dp,
                                   lr=LR, **(extra or {})),
        mesh=mesh, param_specs=specs)
    losses = [float(engine.train_batch(iter(win))) for win in ranks.windows(
        "gpt2", steps, ACCUM, micro * dp, vocab=ranks.MOE_VOCAB)]
    final = jax.device_get(engine.params)
    if engine.master_in_opt:
        final = jax.device_get(engine.optimizer_state["master"])
    aux = [np.asarray(a) for a in jax.device_get(engine.last_aux)]
    out = (losses, aux, {n: t.float().numpy()
                         for n, t in params_from_jax(final).items()})
    if int8_state:
        state = jax.device_get(engine.optimizer_state)
        while "mu" not in state:  # under offload: {master, inner}
            state = state["inner"]
        out += (int8_groups(state["mu"]),)
    return out


def int8_groups(mu):
    """A JAX int8 first moment (``{"q", "scale"}`` leaves) keyed by the
    port's group names (``h.*.<key>``, ``h.*.moe.<key>``, ``wte``,
    ``ln_f.weight``, ...), as numpy arrays."""
    tp = mu["transformer"]
    out = {"wte": tp["wte"], "wpe": tp["wpe"],
           "ln_f.weight": tp["ln_f"]["scale"], "ln_f.bias": tp["ln_f"]["bias"]}
    for name, leaf in tp["h"].items():
        if set(leaf) == {"q", "scale"}:
            out[f"h.*.{name}"] = leaf
        else:
            for key, sub in leaf.items():
                out[f"h.*.{name}.{key}"] = sub
    return {g: {k: np.asarray(v) for k, v in leaf.items()}
            for g, leaf in out.items()}


def case(kind, name, **fields):
    """A port ``moe_pp_train`` case of ``kind`` on this module's model and
    schedule."""
    base = {"kind": "moe_pp_train", "weights": f"{kind}.pt",
            "steps": STEPS, "accum": ACCUM, "lr": LR, "stage": 0,
            "opt": "Adam", "dtype": "fp32"}
    if kind == "moe":
        base.update(experts=EXPERTS, micro=MOE_MICRO)
    else:
        base.update(pp=STAGES, n_micro=PP_MICRO_BATCHES, micro=PP_MICRO)
    return dict(base, name=name, **fields)


def check(got, want_losses, want_params, tol=TOL):
    """The case's losses and whole parameters against the oracle's."""
    np.testing.assert_allclose(got["losses"], want_losses, **tol)
    assert set(got["params"]) == set(want_params)
    for n, want in want_params.items():
        np.testing.assert_allclose(got["params"][n], want, err_msg=n, **tol)


# compensated masters (bfloat16 compute): all but 0.5% of the parameters
# within one bf16 ulp (2**-7 relative) and 1% of the most the windows
# can move an element, as tests/test_torch_engine_state_layouts.py holds
# them; losses rtol 2e-4
BF16_OUTLIERS = 5e-3


def check_bf16(got, want_losses, want_params, lr=LR, windows=STEPS,
               outliers=BF16_OUTLIERS):
    """A bfloat16-compute case's losses and parameters against the
    oracle's, at the bf16 tolerances above. ``outliers=None`` holds every
    element instead within one bf16 ulp plus 2 lr a window (Lion's bound
    in tests/test_torch_engine_state_layouts.py): Adam turns the last
    bits of a near-zero gradient into a step of +-lr, and an MoE expert
    sees few tokens a step."""
    np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-4)
    assert set(got["params"]) == set(want_params)
    atol = 1e-2 * lr * windows if outliers is not None else 2 * lr * windows
    beyond = total = 0
    for n, want in want_params.items():
        diff = np.abs(got["params"][n] - want)
        bad = diff > atol + 2.0 ** -7 * np.abs(want)
        if outliers is None:
            assert not bad.any(), (n, float(diff.max()))
        beyond += int(bad.sum())
        total += want.size
    assert beyond <= (outliers or 0.0) * total, (beyond, total)


def same_on_every_rank(results, name):
    """Every rank's losses are rank 0's."""
    for r in results[1:]:
        assert r[name]["losses"] == results[0][name]["losses"]


def in_process(fn, case, workdir):
    """Rank case ``fn`` run in this process at world size 1 (on one torch
    thread, as tests/torch_test_env.py sets it for the test processes and
    the rank processes run)."""
    return fn(case, 0, 1, workdir)
