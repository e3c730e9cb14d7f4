"""int8 optimizer moments where the JAX engine's flat leaves span ranks,
held to the JAX engine on the same CPU meshes: a pipe axis (pp 2, and pp
2 x dp 2 at ZeRO 1, 2 and 3), MoE experts over a data axis of 2 (at ZeRO
0, 1 and 3), and a model axis of 2 with ZeRO stage 3 (mp 2 x dp 2) or
with optimizer offload (mp 2); and a client ``Adam(state_dtype="int8")``
beside a config without int8 (pp 2, and pp 2 x dp 2 at ZeRO 1), which
both engines take as int8.

The JAX engine keeps one flat ``{"q", "scale"}`` leaf per stacked group,
over all its layers (and experts), in blocks of 2048; at this file's
width (64) a bias group's two layers share one block, so pp 2 puts one
block on both stages, and the expert biases put every block on both data
ranks. The port's ranks hold their runs of the whole leaf on its block
grid, and a shared block's scale is the max of its ranks' absmax
(ops/quant.py:BlockMap); from ZeRO stage 1 each data rank of a stage
holds its contiguous share of the stage's blocks, and an expert rank its
runs, while the dense groups shard as without stages or experts, and at
stage 3 no master is kept beside the persistent shards: what a rank
holds is checked against that layout and stage 0's. At a model axis the optimizer steps the
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
A pp 2, an MoE dp 2, a pp 2 x dp 2 ZeRO 3 and an MoE dp 2 ZeRO 3
checkpoint of int8 moments load at one rank and resume alike, and a
one-rank checkpoint loads at pp 2 x dp 2 ZeRO 3. One spawn a world size (2 and 4 ranks), both started
before the oracles run.
"""

import math

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
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
BLOCK = 2048


def _dense(name, **fields):
    """A ``moe_pp_train`` case of the dense model (no stages, no experts)
    on the pipeline files' sizes."""
    return dict(mp.case("pp", name, **fields), pp=1, n_micro=0,
                micro=mp.PP_MICRO)


CASES = {
    # name: (world, port case, JAX oracle arguments)
    "pp2": (2, mp.case("pp", "pp2", extra=INT8),
            dict(kind="pp", dp=1, stage=0)),
    # a client Adam(state_dtype="int8") beside a config without int8
    "pp2_client": (2, mp.case("pp", "pp2_client", client_int8=True),
                   dict(kind="pp", dp=1, stage=0, client=True)),
    "moe_dp2": (2, mp.case("moe", "moe_dp2", extra=INT8),
                dict(kind="moe", dp=2, stage=0)),
    "mp2_offload": (2, _dense("mp2_offload", extra=dict(INT8, **MP2,
                                                         **OFFLOAD)),
                    dict(kind="dense", dp=1, stage=0, mp=2,
                         extra=OFFLOAD)),
    "pp2dp2_s1": (4, mp.case("pp", "pp2dp2_s1", stage=1, extra=INT8,
                             held=True),
                  dict(kind="pp", dp=2, stage=1)),
    "pp2dp2_s2": (4, mp.case("pp", "pp2dp2_s2", stage=2, extra=INT8,
                             held=True),
                  dict(kind="pp", dp=2, stage=2)),
    "pp2dp2_s3": (4, mp.case("pp", "pp2dp2_s3", stage=3, extra=INT8,
                             held=True),
                  dict(kind="pp", dp=2, stage=3)),
    "pp2dp2_s1_client": (4, mp.case("pp", "pp2dp2_s1_client", stage=1,
                                    client_int8=True, held=True),
                         dict(kind="pp", dp=2, stage=1, client=True)),
    "moe_dp2_s1": (2, mp.case("moe", "moe_dp2_s1", stage=1, extra=INT8,
                              held=True),
                   dict(kind="moe", dp=2, stage=1)),
    "moe_dp2_s3": (2, mp.case("moe", "moe_dp2_s3", stage=3, extra=INT8,
                              held=True),
                   dict(kind="moe", dp=2, stage=3)),
    "mp2dp2_s3": (4, _dense("mp2dp2_s3", stage=3, extra=dict(INT8, **MP2)),
                  dict(kind="dense", dp=2, stage=3, mp=2)),
}


def _ckpt(kind, root, mode, tag=None, one_rank=None, **fields):
    """A ``moe_pp_checkpoint`` case of int8 moments in directory ``tag``
    (default ``kind``): ``kind`` "pp" at pp 2 or "moe" at dp 2, and one
    rank of the same model when ``one_rank`` (default: when loading);
    ``fields`` override the case (a ZeRO stage, a data rank's rows)."""
    tag = tag or kind
    case = dict(mp.case(kind, f"ckpt_{tag}", extra=INT8), mode=mode,
                kind="moe_pp_checkpoint", dir=str(root / f"ckpt_{tag}"),
                accum=1)
    if mode == "load" if one_rank is None else one_rank:
        case.update(micro=4, **({"pp": 1, "n_micro": 0} if kind == "pp"
                                else {}))
    return dict(case, **fields)


#: the checkpoints across layouts: (tag, model kind, saved at one rank,
#: the world that saves or loads at pp 2 x dp 2 ZeRO 3, the one rank's
#: fields). pp 2 x dp 2 feeds 4 rows a data rank, one rank all 8.
CKPTS = {
    "pp": ("pp", False, 2, {}),
    "moe": ("moe", False, 2, {}),
    "pp2dp2_s3": ("pp", False, 4, {"micro": 8}),
    "one_to_pp2dp2_s3": ("pp", True, 4, {"micro": 8}),
    "moe_dp2_s3": ("moe", False, 2, {}),
}


def _ckpt_cases(root, tag):
    """(the save case, the load case) of checkpoint ``tag``."""
    kind, from_one, _, one = CKPTS[tag]
    wide = {"stage": 3} if tag != kind else {}
    save = _ckpt(kind, root, "save", tag, from_one,
                 **(one if from_one else wide))
    load = _ckpt(kind, root, "load", tag, not from_one,
                 **(wide if from_one else one))
    return save, load


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("int8_spans")
    params = {"pp": mp.weights("pp"), "moe": mp.weights("moe")}
    handles = {}
    one = {}
    for world in (2, 4):
        d = root / f"world{world}"
        d.mkdir()
        mp.save_port_weights(params["pp"], d / "pp.pt")
        mp.save_port_weights(params["moe"], d / "moe.pt")
        cases = [case for w, case, _ in CASES.values() if w == world]
        for tag, (_, from_one, w, _) in CKPTS.items():
            if w != world:
                continue
            save, load = _ckpt_cases(root, tag)
            if from_one:
                # saved here before the ranks start, which load it
                one[tag] = mp.in_process(ranks.case_moe_pp_checkpoint,
                                         save, d)
            cases.append(load if from_one else save)
        handles[world] = ranks.start(world, cases, d)
    with ThreadPoolExecutor(1) as pool:
        jobs = {}
        for name, (_, _, args) in CASES.items():
            args = dict(args)
            kind, dp, stage = args.pop("kind"), args.pop("dp"), args.pop(
                "stage")
            client = args.pop("client", False)
            args["extra"] = dict({} if client else INT8,
                                 **args.get("extra", {}))
            weights = params["moe" if kind == "moe" else "pp"]
            jobs[name] = pool.submit(mp.jax_run, kind, weights, dp, stage,
                                     "Adam", int8_state=True,
                                     client_int8=client, **args)
        port = {w: ranks.finish(h, timeout=300) for w, h in handles.items()}
        for tag, (_, from_one, w, _) in CKPTS.items():
            if not from_one:
                one[tag] = mp.in_process(ranks.case_moe_pp_checkpoint,
                                         _ckpt_cases(root, tag)[1],
                                         root / f"world{w}")
        oracle = {n: f.result() for n, f in jobs.items()}
    results = {name: port[world] for name, (world, _, _) in CASES.items()}
    results["ckpt"] = {
        tag: ((one[tag], port[w][0][f"ckpt_{tag}"]) if from_one
              else (port[w][0][f"ckpt_{tag}"], one[tag]))
        for tag, (_, from_one, w, _) in CKPTS.items()}
    results["ckpt_root"] = root
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


@pytest.mark.parametrize("kind", list(CKPTS))
def test_an_int8_checkpoint_loads_at_one_rank(runs, kind):
    """Saved at pp 2 (or with experts over dp 2, at pp 2 x dp 2 ZeRO 3
    or with experts over dp 2 at ZeRO 3), loaded by one rank of the same
    model, and saved at one rank, loaded at pp 2 x dp 2 ZeRO 3: the eval
    fingerprint and the two resumed windows (the second reads the
    restored int8 moments) equal the saving run's. A ZeRO 3 save writes
    one rank's file, its first moment the whole JAX leaves."""
    results, oracle = runs
    saved, loaded = results["ckpt"][kind]
    assert loaded["loaded"] and loaded["global_steps"] == 2
    np.testing.assert_allclose(loaded["fingerprint"], saved["fingerprint"],
                               **mp.TOL)
    np.testing.assert_allclose(loaded["resume"], saved["resume"], **mp.TOL)
    if kind in ("pp2dp2_s3", "moe_dp2_s3"):
        from deepspeed_tpu_torch.runtime import checkpointing

        d = results["ckpt_root"] / f"ckpt_{kind}" / "t2"
        assert saved["files"] == sorted(p.name for p in d.iterdir())
        files = [p for p in d.iterdir() if p.name.endswith("optim_states.pt")]
        assert len(files) == 1
        payload = checkpointing._deserialize(files[0].read_bytes())
        # float32 masters: the bare inner state, as one rank's (the
        # module file is the master)
        mu = payload["optimizer_state"]["mu"]
        params = oracle[kind][2]
        assert set(mu) == set(oracle[kind][3])
        for g, leaf in mu.items():
            total = sum(p.size for n, p in params.items()
                        if _group(n) == g)
            nb = math.ceil(total / BLOCK)
            assert leaf["scale"].numel() == nb, g
            assert leaf["q"].numel() == nb * BLOCK, g


def _group(name):
    """The group of a parameter (``h.3.attn_qkvw`` -> ``h.*.attn_qkvw``)."""
    parts = name.split(".")
    return ".".join(["h", "*"] + parts[2:]) if parts[0] == "h" else name


def _blocks(pieces, me):
    """The blocks of a group's whole leaf that rank ``me``'s pieces touch,
    and those of them another rank's touch too: ``pieces`` ``[(numel,
    owner)]`` in the leaf's order."""
    mine, other, off = set(), set(), 0
    for n, owner in pieces:
        (mine if owner == me else other).update(
            range(off // BLOCK, -(-(off + n) // BLOCK)))
        off += n
    return mine, mine & other


@pytest.mark.parametrize("name", [n for n, (_, case, _) in CASES.items()
                                  if case.get("held")])
def test_int8_state_is_sharded_over_the_data_axis(runs, name):
    """At ZeRO stage s (1-3) with int8 moments and stages or experts over
    dp 2 the engine reports s and each rank holds its share: a group
    that spans ranks at most ceil(runs / dp) blocks of int8 first moment,
    plus one a shared block it touches (a stage's runs cut over its data
    ranks; an expert group's runs the rank's of the whole leaf's), under
    stage 0's runs for a stage; the model elements whose optimizer state
    the ranks step are each once a stage (the embeddings and ``ln_f`` on
    both stages), under stage 0's replicas over the data axis; from stage
    2 the gradients are the optimizer's shards, and at stage 3 the module's
    persistent shards are the masters (none kept beside them) and hold
    less than whole tensors."""
    results, oracle = runs
    stage = CASES[name][2]["stage"]
    pp = name.startswith("pp")
    params = oracle[name][2]
    groups = {}
    for n, p in params.items():
        groups.setdefault(_group(n), []).append((n, p))
    stepped = whole = 0
    for r in results[name]:
        held, (pipe, data) = r[name]["held"], r[name]["coords"]
        assert held["zero_stage"] == stage
        runs_held = runs_stage0 = 0
        for g, members in groups.items():
            if g not in held["mu"] or not g.startswith("h."):
                continue
            if pp:
                per = len(members) // 2
                pieces = [(p.size, int(n.split(".")[1]) // per)
                          for n, p in members]
                me = pipe
            elif "expert" in g:
                pieces = [(p.size // 2, k) for _, p in members
                          for k in range(2)]
                me = data
            else:
                continue
            mine, shared = _blocks(pieces, me)
            runs = len(mine) if pp else -(-sum(n for n, _ in pieces)
                                         // BLOCK)
            bound = (-(-runs // 2) + len(shared)) * BLOCK
            assert held["mu"][g] <= bound, (g, held["mu"][g], bound)
            runs_held += held["mu"][g]
            runs_stage0 += len(mine) * BLOCK
        assert runs_held < runs_stage0 if pp else runs_held == runs_stage0
        assert held["stepped"] <= held["whole"]
        stepped += held["stepped"]
        whole += held["whole"]
        if stage >= 2:
            assert held["grads"] == held["leaves"]
        else:
            assert held["grads"] == held["whole"]
        if stage >= 3:
            assert held["masters"] == 0
            assert held["module"] < held["whole"]
    # each data group steps its tensors once, not once a data rank
    once = sum(p.size for p in params.values()) + (pp and sum(
        p.size for n, p in params.items() if not n.startswith("h.")))
    assert stepped == once < whole
