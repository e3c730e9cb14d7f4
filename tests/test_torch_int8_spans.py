"""int8 optimizer moments where the JAX engine's flat leaves span ranks,
held to the JAX engine on the same CPU meshes: a pipe axis (pp 2, and pp
2 x dp 2 at ZeRO 1), MoE experts over a data axis of 2, and a model axis
of 2 with ZeRO stage 3 (mp 2 x dp 2) or with optimizer offload (mp 2).

The JAX engine keeps one flat ``{"q", "scale"}`` leaf per stacked group,
over all its layers (and experts), in blocks of 2048; at this file's
width (64) a bias group's two layers share one block, so pp 2 puts one
block on both stages, and the expert biases put every block on both data
ranks. The port's ranks hold their runs of the whole leaf on its block
grid, and a shared block's scale is the max of its ranks' absmax
(ops/quant.py:BlockMap). At a model axis the optimizer steps the
model-gathered tensors: at ZeRO 3 each rank's data shard of them, under
offload on the host. Adam, 2 windows of 2 micro-steps at lr 1e-4: losses
and whole parameters to the pipeline and MoE files' tolerance (rtol 2e-4,
atol 1e-5), and the first moment joined into the JAX leaves' flat order
against the JAX state: scales to ``SCALE_RTOL``, codes equal but for at
most ``CODE_FLIPS`` of them one step apart. The two packages' float32
gradients differ in their last bits (summation order), and so do the
moments: measured here, scales at most 1.23e-6 apart (MoE at dp 2, whose
token all-to-all sums in another order; 6e-7 to 7.5e-7 elsewhere), and
0 to 12 codes of a case (12 of 327680 in MoE) one step apart, each on a
rounding edge. A layout fault moves whole blocks: the naive lift once put
9 of 192 elements of a shared block off, and MoE losses 3.4e-3 apart.
A pp 2 and an MoE dp 2 checkpoint of int8 moments load at one rank and
resume alike. One spawn a world size (2 and 4 ranks), both started
before the oracles run.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_dp_ranks as ranks
import torch_moe_pp as mp
from torch_test_env import jax_compile_cache  # noqa: F401

INT8 = {"data_types": {"optimizer_state_dtype": "int8"}}
OFFLOAD = {"zero_optimization": {"stage": 0,
                                 "offload_optimizer": {"device": "cpu"}}}
MP2 = {"mesh": {"model_parallel_size": 2}}
#: scales' relative tolerance, and the share of a leaf's codes that may
#: sit one step from the JAX engine's (see the module docstring)
SCALE_RTOL = 2e-6
CODE_FLIPS = 1e-4


def _dense(name, **fields):
    """A ``moe_pp_train`` case of the dense model (no stages, no experts)
    on the pipeline files' sizes."""
    return dict(mp.case("pp", name, **fields), pp=1, n_micro=0,
                micro=mp.PP_MICRO)


CASES = {
    # name: (world, port case, JAX oracle arguments)
    "pp2": (2, mp.case("pp", "pp2", extra=INT8),
            dict(kind="pp", dp=1, stage=0)),
    "moe_dp2": (2, mp.case("moe", "moe_dp2", extra=INT8),
                dict(kind="moe", dp=2, stage=0)),
    "mp2_offload": (2, _dense("mp2_offload", extra=dict(INT8, **MP2,
                                                         **OFFLOAD)),
                    dict(kind="dense", dp=1, stage=0, mp=2,
                         extra=OFFLOAD)),
    "pp2dp2_s1": (4, mp.case("pp", "pp2dp2_s1", stage=1, extra=INT8),
                  dict(kind="pp", dp=2, stage=1)),
    "mp2dp2_s3": (4, _dense("mp2dp2_s3", stage=3, extra=dict(INT8, **MP2)),
                  dict(kind="dense", dp=2, stage=3, mp=2)),
}


def _ckpt(kind, root, mode, **fields):
    """A ``moe_pp_checkpoint`` case of int8 moments (``kind`` "pp" at pp 2
    or "moe" at dp 2 when saving; one rank of the same model when
    loading)."""
    case = dict(mp.case(kind, f"ckpt_{kind}", extra=INT8), mode=mode,
                kind="moe_pp_checkpoint", dir=str(root / f"ckpt_{kind}"),
                accum=1, **fields)
    if mode == "load":
        case.update(micro=4, **({"pp": 1, "n_micro": 0} if kind == "pp"
                                else {}))
    return case


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("int8_spans")
    params = {"pp": mp.weights("pp"), "moe": mp.weights("moe")}
    handles = {}
    for world in (2, 4):
        d = root / f"world{world}"
        d.mkdir()
        mp.save_port_weights(params["pp"], d / "pp.pt")
        mp.save_port_weights(params["moe"], d / "moe.pt")
        cases = [case for w, case, _ in CASES.values() if w == world]
        if world == 2:
            cases += [_ckpt("pp", root, "save"), _ckpt("moe", root, "save")]
        handles[world] = ranks.start(world, cases, d)
    with ThreadPoolExecutor(1) as pool:
        jobs = {}
        for name, (_, _, args) in CASES.items():
            args = dict(args)
            kind, dp, stage = args.pop("kind"), args.pop("dp"), args.pop(
                "stage")
            args["extra"] = dict(INT8, **args.get("extra", {}))
            weights = params["moe" if kind == "moe" else "pp"]
            jobs[name] = pool.submit(mp.jax_run, kind, weights, dp, stage,
                                     "Adam", int8_state=True, **args)
        port = {w: ranks.finish(h, timeout=300) for w, h in handles.items()}
        loads = {kind: mp.in_process(ranks.case_moe_pp_checkpoint,
                                     _ckpt(kind, root, "load"),
                                     root / "world2") for kind in ("pp",
                                                                   "moe")}
        oracle = {n: f.result() for n, f in jobs.items()}
    results = {name: port[world] for name, (world, _, _) in CASES.items()}
    results["ckpt"] = {kind: (port[2][0][f"ckpt_{kind}"], loads[kind])
                       for kind in loads}
    return results, oracle


@pytest.mark.parametrize("name", list(CASES))
def test_int8_losses_and_parameters_match_jax(runs, name):
    results, oracle = runs
    mp.same_on_every_rank(results[name], name)
    want_losses, _, want_params, _ = oracle[name]
    mp.check(results[name][0][name], want_losses, want_params)


@pytest.mark.parametrize("name", list(CASES))
def test_int8_moments_are_the_jax_leaves(runs, name):
    """Every rank's whole leaves are the same; each group's scales and
    codes are the JAX state's (the port's ZeRO leaves are padded to
    ``max(256, dp)`` blocks as the JAX engine's are: the tails are
    zero)."""
    results, oracle = runs
    got = results[name][0][name]["int8"]
    for r in results[name][1:]:
        for g, leaf in r[name]["int8"].items():
            np.testing.assert_array_equal(leaf["q"], got[g]["q"], err_msg=g)
    want = oracle[name][3]
    assert set(got) == set(want)
    for g, w in want.items():
        q, scale = got[g]["q"], got[g]["scale"]
        nb = min(scale.size, w["scale"].size)
        for t, n in ((q, nb * 2048), (scale, nb)):
            assert not np.any(t[n:])
        for t, n in ((w["q"], nb * 2048), (w["scale"], nb)):
            assert not np.any(t[n:])
        np.testing.assert_allclose(scale[:nb], w["scale"][:nb],
                                   rtol=SCALE_RTOL, atol=0, err_msg=g)
        step = np.abs(q[:nb * 2048].astype(np.int32)
                      - w["q"][:nb * 2048].astype(np.int32))
        assert step.max() <= 1, (g, int(step.max()))
        assert step.sum() <= CODE_FLIPS * step.size + 1, (g, int(step.sum()))


def test_a_shared_block_spans_the_ranks(runs):
    """The cases reach what they claim: at pp 2 the bias groups' one
    block holds both stages' layers, and every expert-bias block holds
    both data ranks' experts."""
    results, _ = runs
    pp = results["pp2"][0]["pp2"]["int8"]["h.*.attn_qkvb"]
    # layer 0's 192 elements (stage 0) and layer 1's (stage 1), one block
    assert pp["scale"].size == 1
    assert np.any(pp["q"][:192]) and np.any(pp["q"][192:384])
    moe = results["moe_dp2"][0]["moe_dp2"]["int8"]
    biases = ["h.*.moe.expert_in_b", "h.*.moe.expert_out_b"]
    assert biases and all(moe[g]["scale"].size == 1 for g in biases)


@pytest.mark.parametrize("kind", ["pp", "moe"])
def test_an_int8_checkpoint_loads_at_one_rank(runs, kind):
    """Saved at pp 2 (or with experts over dp 2), loaded by one rank of
    the same model: the eval fingerprint and the two resumed windows (the
    second reads the restored int8 moments) equal the saving run's."""
    results, _ = runs
    saved, loaded = results["ckpt"][kind]
    assert loaded["loaded"] and loaded["global_steps"] == 2
    np.testing.assert_allclose(loaded["fingerprint"], saved["fingerprint"],
                               **mp.TOL)
    np.testing.assert_allclose(loaded["resume"], saved["resume"], **mp.TOL)
