"""The GPipe schedule (parallel/pipeline.py) and GPT-2 over a pipe axis,
held to the JAX package on the CPU (two gloo ranks: pipe 2 x data 1).

- the schedule on tests/unit/test_pipeline.py's toy stage (``tanh(x @
  w)``, 2 stages of 3 layers, 4 microbatches) against ``gpipe_spmd`` on a
  ``pipe=2`` sub-mesh: outputs to 1e-6, the gradients of ``sum(out ** 2)``
  (each stage's weights, the inputs) to 1e-5; ``last_stage_fn``'s
  per-microbatch scalars; an exp-amplifying stage stays finite; one stage
  is the sequential stack;
- GPT-2 at pp 2 (ZeRO 0-2, Adam) against the JAX engine on the same
  ``pipe=2`` mesh with ``partition_specs(params, pipeline=True)``
  (losses and parameters to rtol 2e-4, atol 1e-5 at lr 1e-4), and equal
  to pp 1 with Adam, FusedLamb and remat (FusedLamb's JAX oracle is
  tests/test_torch_pipeline_dp2.py's: one JAX engine compile a file
  keeps the suite's seconds); dropout reproduced by its seed and changed by another; a pp 2
  checkpoint loaded at pp 1 and a pp 1 checkpoint at pp 2, with the eval
  fingerprint; the validation errors and the refusals by their messages.
tests/test_torch_pipeline_dp2.py runs pp 2 x dp 2.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
import torch_dp_ranks as ranks
import torch_moe_pp as mp
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.parallel.pipeline import gpipe_spmd
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from deepspeed_tpu_torch.parallel.pipeline import PipelineStage, gpipe
from torch_test_env import jax_compile_cache  # noqa: F401

PP = 2


def _jax_gpipe():
    """``gpipe_spmd`` on the toy over a pipe=2 sub-mesh: the plain and the
    head outputs, the plain run's gradients, the exp stage's."""
    W, X = ranks.toy_pipeline()
    W, X = jnp.asarray(W), jnp.asarray(X)
    mesh = build_mesh(pipeline_parallel_size=PP, devices=jax.devices()[:PP])
    Wp = W.reshape(PP, -1, *W.shape[1:])

    def tanh_stage(w, x, t, extras):
        return jax.lax.scan(lambda h, wi: (jnp.tanh(h @ wi), None), x, w)[0]

    def exp_stage(w, x, t, extras):
        return jax.lax.scan(lambda h, wi: (
            jnp.exp(jnp.clip(h @ wi, -50.0, 50.0)) * 1e-2, None), x, w)[0]

    def head(y, mb, extras):
        return jnp.mean(y * y) + 0.5 * mb.astype(jnp.float32)

    def plain(w, x):
        return jnp.sum(gpipe_spmd(tanh_stage, w, x, mesh) ** 2)

    out = {}
    out["plain"] = jax.jit(lambda w, x: gpipe_spmd(tanh_stage, w, x, mesh))(
        Wp, X)
    out["grads"] = jax.jit(jax.grad(plain, argnums=(0, 1)))(Wp, X)
    out["head"] = jax.jit(lambda w, x: gpipe_spmd(
        tanh_stage, w, x, mesh, last_stage_fn=head))(Wp, X)
    out["head_grad"] = jax.jit(jax.grad(lambda w: jnp.sum(gpipe_spmd(
        tanh_stage, w, X, mesh, last_stage_fn=head))))(Wp)
    out["exp"] = jax.jit(jax.grad(lambda w: jnp.sum(gpipe_spmd(
        exp_stage, w, X, mesh) ** 2)))(Wp)
    return jax.device_get(out)


REFUSED = {
    "adapters": {"adapters": {"enabled": True, "rank": 4}},
    "int8": {"data_types": {"optimizer_state_dtype": "int8"}},
    "bf16_moments": {"data_types": {"optimizer_state_dtype": "bf16"}},
    "compensated": {"bf16": {"enabled": True},
                    "data_types": {"master_dtype": "compensated"}},
    "offload": {"zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}},
    "sparse": {"sparse_gradients": True},
    "dense_model": {"case": {"pp": 1, "weights": "pp.pt"},
                    "mesh": {"pipeline_parallel_size": PP}},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A pp 1 checkpoint saved here, then one spawn of the pp 2 ranks (the
    schedule, the ZeRO stages, dropout, the checkpoints both ways, the
    refusals) while the JAX oracles and the port at pp 1 compute here."""
    d = tmp_path_factory.mktemp("pp")
    params = mp.weights("pp")
    mp.save_port_weights(params, d / "pp.pt")
    ckpt = {"kind": "moe_pp_checkpoint", "weights": "pp.pt", "micro": 4,
            "stage": 1}
    saved1 = mp.in_process(ranks.case_moe_pp_checkpoint,
        dict(ckpt, mode="save", dir=str(d / "pp1")), d)
    drop = dict(opt="FusedLamb", dtype="bf16", dropout=0.1, lr=1e-3,
                steps=2)
    cases = [{"kind": "pp_gpipe", "name": "gpipe"}]
    cases += [mp.case("pp", f"adam-s{s}", stage=s) for s in range(3)]
    cases += [mp.case("pp", "offload-s1", stage=1,
                      extra=REFUSED["offload"])]
    cases += [mp.case("pp", "fusedlamb-s0", opt="FusedLamb"),
              mp.case("pp", "remat-s2", stage=2, remat=True),
              mp.case("pp", "drop-a", **drop),
              mp.case("pp", "drop-b", **drop),
              mp.case("pp", "drop-c", rng_seed=1, **drop),
              dict(ckpt, name="save", pp=PP, n_micro=4, mode="save",
                   dir=str(d / "pp2")),
              dict(ckpt, name="load1", pp=PP, n_micro=4, mode="load",
                   dir=str(d / "pp1")),
              dict(mp.case("pp", "refusals"), kind="moe_pp_refusals",
                   refusals=REFUSED)]
    handle = ranks.start(PP, cases, d)
    with ThreadPoolExecutor(2) as pool:
        oracles = {
            "adam": pool.submit(mp.jax_run, "pp", params, 1, 0, "Adam"),
            "gpipe": pool.submit(_jax_gpipe),
        }
        pp1 = {k: mp.in_process(ranks.case_moe_pp_train,
            dict(mp.case("pp", k, opt=opt), pp=1, n_micro=0), d)
            for k, opt in (("adam", "Adam"), ("fusedlamb", "FusedLamb"))}
        results = ranks.finish(handle, timeout=240)
        oracles = {k: f.result() for k, f in oracles.items()}
    return results, oracles, pp1, saved1, d


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------
def test_gpipe_matches_gpipe_spmd(runs):
    results, oracles, *_ = runs
    want = oracles["gpipe"]
    gw, gx = want["grads"]
    for r, res in enumerate(results):
        got = res["gpipe"]["plain"]
        np.testing.assert_allclose(got["out"], want["plain"], atol=1e-6)
        np.testing.assert_allclose(got["grad_w"], gw[r], atol=1e-5)
    np.testing.assert_allclose(results[0]["gpipe"]["plain"]["grad_x"], gx,
                               atol=1e-5)


def test_gpipe_last_stage_fn(runs):
    results, oracles, *_ = runs
    want = oracles["gpipe"]
    for r, res in enumerate(results):
        got = res["gpipe"]["head"]
        assert got["out"].shape == (4,)
        np.testing.assert_allclose(got["out"], want["head"], atol=1e-6)
        np.testing.assert_allclose(got["grad_w"], want["head_grad"][r],
                                   atol=1e-5)


def test_gpipe_exp_amplifying_stage_stays_finite(runs):
    results, oracles, *_ = runs
    for r, res in enumerate(results):
        got = res["gpipe"]["exp"]
        assert np.isfinite(got["loss"]) and np.all(np.isfinite(got["out"]))
        assert np.all(np.isfinite(got["grad_w"]))
        np.testing.assert_allclose(got["grad_w"], oracles["gpipe"]["exp"][r],
                                   rtol=1e-4, atol=1e-5)


def test_gpipe_one_stage_is_the_sequential_stack():
    W, X = ranks.toy_pipeline()
    line = PipelineStage(None, 1, 0, (0,))

    def stage_fn(w, x, m, extras):
        for i in range(w.shape[0]):
            x = torch.tanh(x @ w[i])
        return x

    w = torch.tensor(W, requires_grad=True)
    x = torch.tensor(X, requires_grad=True)
    out = gpipe(stage_fn, w, x, line)
    (out ** 2).sum().backward()
    w2 = torch.tensor(W, requires_grad=True)
    x2 = torch.tensor(X, requires_grad=True)
    ref = stage_fn(w2, x2, 0, None)
    (ref ** 2).sum().backward()
    # the same float32 products a microbatch at a time (a BLAS may block
    # another row count otherwise: the last place)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-7)
    # the gradients sum the microbatches' parts in another order
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# GPT-2 at pp 2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["adam-s0", "adam-s1", "adam-s2",
                                  "offload-s1"])
def test_gpt2_pp2_matches_jax(runs, name):
    """Adam at ZeRO 0-2, and with optimizer offload (the JAX engine's
    offload changes no bit of Adam's update), against the JAX engine."""
    results, oracles, *_ = runs
    mp.same_on_every_rank(results, name)
    want_losses, _, want_params = oracles["adam"]
    mp.check(results[0][name], want_losses, want_params)
    # each stage holds its own block and the shared embeddings and ln_f
    for stage, r in enumerate(results):
        names = set(r[name]["local_shapes"])
        assert {"wte", "wpe", "ln_f.weight"} <= names
        assert {n.split(".")[1] for n in names if n.startswith("h.")} == {
            str(stage)}


@pytest.mark.parametrize("name", ["adam-s0", "remat-s2", "fusedlamb-s0"])
def test_gpt2_pp2_equals_pp1(runs, name):
    """pp 2 equals pp 1, with FusedLamb (its group norms summed over the
    stages) and with every block checkpointed (remat runs inside the
    schedule's kept graphs)."""
    results, _, pp1, _, _ = runs
    mp.same_on_every_rank(results, name)
    want = pp1["fusedlamb" if name.startswith("fusedlamb") else "adam"]
    mp.check(results[0][name], want["losses"], want["params"])


def test_pp1_matches_jax(runs):
    """The one-stage reference of the cases above against the JAX engine
    on the pipe mesh."""
    _, oracles, pp1, _, _ = runs
    want_losses, _, want_params = oracles["adam"]
    mp.check(pp1["adam"], want_losses, want_params)


def test_pipeline_dropout_is_keyed_by_its_seed(runs):
    results, *_ = runs
    a, b, c = (results[0][f"drop-{k}"] for k in "abc")
    for k in "abc":
        mp.same_on_every_rank(results, f"drop-{k}")
    assert np.all(np.isfinite(a["losses"])) and a["skipped"] == 0
    assert a["losses"] == b["losses"]
    assert a["losses"][0] != c["losses"][0]
    assert len(a["coeffs"]) > 0


def test_pp2_checkpoint_loads_at_pp1(runs):
    results, _, _, _, d = runs
    save = results[0]["save"]
    got = mp.in_process(ranks.case_moe_pp_checkpoint,
        {"mode": "load", "weights": "pp.pt", "micro": 4, "stage": 1,
         "dir": str(d / "pp2")}, d)
    assert got["loaded"] and got["global_steps"] == 2
    np.testing.assert_allclose(got["fingerprint"], save["fingerprint"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["resume"], save["resume"], rtol=1e-5)


def test_pp1_checkpoint_loads_at_pp2(runs):
    results, _, _, saved1, _ = runs
    for r in results:
        got = r["load1"]
        assert got["loaded"] and got["global_steps"] == 2
        np.testing.assert_allclose(got["fingerprint"],
                                   saved1["fingerprint"], rtol=1e-6)
        np.testing.assert_allclose(got["resume"], saved1["resume"],
                                   rtol=1e-5)


LIFTED_AT_PP = ("bf16_moments", "compensated", "sparse", "offload", "int8")
# refused with the JAX engine's behaviour as the reason
REASONS = {"adapters": "the JAX engine's pipelined stack runs the blocks "
                       "without their LoRA factors"}


@pytest.mark.parametrize("name,message", [
    ("adapters", "the adapters block at a pipe axis above 1 (ROADMAP A7d"),
    ("int8", "int8 optimizer moments at a pipe axis above 1 (ROADMAP A7d"),
    ("bf16_moments", "bf16 optimizer moments at a pipe axis above 1"),
    ("compensated", "compensated masters at a pipe axis above 1"),
    ("offload", "optimizer offload at a pipe axis above 1"),
    ("sparse", "sparse_gradients at a pipe axis above 1 (ROADMAP A7d"),
    ("dense_model", "pipeline_stages=1 needs a mesh whose 'pipe' axis has "
                    "that size (got a pipe axis of 2)"),
])
def test_pipeline_refusals_on_ranks(runs, name, message):
    """Each refusal by its message; bf16 moments, compensated masters,
    sparse gradients, offload and int8 moments are lifted and build
    (their parity: tests/test_torch_pipeline_dp2.py, offload's here, int8
    tests/test_torch_int8_spans.py), the adapters block is refused with
    the JAX engine's behaviour (REASONS), and a model without stages with
    the JAX model's message."""
    results, *_ = runs
    for r in results:
        if name in LIFTED_AT_PP:
            assert r["refusals"][name] is None, message
        elif name in REASONS:
            assert REASONS[name] in r["refusals"][name]
        else:
            assert message in r["refusals"][name]


def _fake_stage(size=PP, rank=0):
    return PipelineStage(None, size, rank, tuple(range(size)))


def _pp_model(**over):
    return dst.GPT2LMHeadModel(dst.GPT2Config(
        **dict(mp.SIZES, pipeline_stages=PP, **over)), device="cpu")


@pytest.mark.parametrize("rows,n_micro,dp,rank,plan", [
    # a microbatch's rows divide over dp: every rank runs its share of
    # every microbatch
    (8, 4, 2, 1, (4, 4, 0, 2)),
    # they do not: each rank runs the whole microbatches its rows hold,
    # global indices from 4 * rank
    (4, 8, 2, 1, (8, 4, 4, 1)),
    # the default from the global rows: 4 * stages when they divide (8
    # global rows, though a rank holds 4) ...
    (4, 0, 2, 0, (8, 4, 0, 1)),
    # ... else 2 * stages
    (12, 0, 1, 0, (4, 4, 0, 3)),
])
def test_pipeline_plan_splits_the_global_batch(rows, n_micro, dp, rank,
                                               plan):
    """models/gpt2.py:pipeline_plan at PP stages: (global microbatches,
    this rank's, the global index of its first, rows each)."""
    from deepspeed_tpu_torch.models.gpt2 import pipeline_plan

    assert pipeline_plan(rows, PP, n_micro, dp, rank) == plan


@pytest.mark.parametrize("rows,n_micro,dp,message", [
    (3, 0, 2, "batch 6 must divide into pipeline microbatches 4"),
    # once refused: microbatches of 6 rows over 4 ranks of 3 rows; the JAX
    # model trains it, and each rank runs its piece of one microbatch
    # (tests/test_torch_pipeline_uneven.py trains it)
    (3, 2, 4, (2, 1, 0, (3,))),
])
def test_pipeline_plan_refuses_a_split(rows, n_micro, dp, message):
    """The split the JAX model refuses raises its message; every split it
    trains has a plan."""
    from deepspeed_tpu_torch.models.gpt2 import pipeline_plan

    if isinstance(message, tuple):
        assert pipeline_plan(rows, PP, n_micro, dp, 0) == message
        return
    with pytest.raises(ValueError, match=message):
        pipeline_plan(rows, PP, n_micro, dp, 0)


def test_pipeline_validation_errors():
    """The JAX model's ValueErrors, raised before any stage talks."""
    with pytest.raises(ValueError, match="n_layer=3 must divide into "
                                         "pipeline_stages=2"):
        _pp_model(n_layer=3).configure_pipeline(_fake_stage())
    with pytest.raises(ValueError, match="pipeline_stages=2 needs a mesh "
                                         "whose 'pipe' axis has that size"):
        _pp_model().configure_pipeline(None)
    with pytest.raises(ValueError, match="pipeline_stages > 1 does not "
                                         "compose with a >1 sequence axis"):
        from deepspeed_tpu_torch.parallel.sequence import SequenceParallel

        _pp_model().configure_sequence_parallel(
            SequenceParallel(None, 2, 0, (0, 1)))
    model = _pp_model(pipeline_microbatches=3)
    model.configure_pipeline(_fake_stage())
    ids = torch.zeros(4, ranks.SEQ, dtype=torch.long)
    with pytest.raises(ValueError, match="batch 4 must divide into "
                                         "pipeline microbatches 3"):
        model(ids, ids, train=True)
    with pytest.raises(ValueError, match="pick one of pp or ep"):
        _pp_model(moe_experts=4)


def test_a_pipelined_model_is_refused_by_a_one_stage_engine():
    with pytest.raises(ValueError, match="pipeline_stages=2 needs a mesh"):
        dst.initialize(model=_pp_model(), device="cpu",
                       config_params={"train_batch_size": 2})
    # sparse gradients compose with stages now: the model's own check
    with pytest.raises(ValueError, match="pipeline_stages=2 needs a mesh"):
        dst.initialize(model=_pp_model(), device="cpu", config_params={
            "train_batch_size": 2, "sparse_gradients": True})
    # so do int8 moments (tests/test_torch_int8_spans.py)
    with pytest.raises(ValueError, match="pipeline_stages=2 needs a mesh"):
        dst.initialize(model=_pp_model(), device="cpu", config_params={
            "train_batch_size": 2,
            "data_types": {"optimizer_state_dtype": "int8"}})
