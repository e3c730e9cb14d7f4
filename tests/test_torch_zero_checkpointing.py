"""Checkpoints across data-parallel sizes.

Two gloo ranks train a 2-layer GPT-2 (width 64, float32, lr 1e-3) for 2
windows of a 4-row global batch and save: at ZeRO stage 1 with Adam, and
at stage 3 with int8 moments (the flat group layout). Each rank writes
its own ``zero_pp_rank_<r>`` optimizer file, rank 0 the model file, and
the manifest covers them all. Then the checkpoint loads at dp = 1 (in
this process) and at dp = 4 (four ranks): the eval fingerprint (the mean
loss of a fixed batch) equals the saving run's within 1e-5 relative (the
tolerance of tests/unit/test_dist_multiprocess.py:292-328), and two more
windows train on: the first window's loss follows from the restored
parameters, the second's from the restored optimizer state too; both
equal the saving run's continuation to the ZeRO parity tolerance
(``rtol=2e-4``, tests/test_torch_zero.py).
"""

import numpy as np
import pytest

import torch_dp_ranks as ranks
from torch_test_env import jax_compile_cache  # noqa: F401

FP_TOL = dict(rtol=1e-5, atol=0.0)
RESUME_TOL = dict(rtol=2e-4, atol=1e-5)
SAVES = {"s1": dict(stage=1, opt="Adam", dtype="fp32"),
         "s3int8": dict(stage=3, opt="Adam", dtype="int8")}


def _cases(mode, root):
    return [dict(name=key, kind="checkpoint", model="gpt2", mode=mode,
                 micro_global=4, dir=str(root / f"ckpt_{key}"), **spec)
            for key, spec in SAVES.items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    saved = ranks.finish(ranks.start(2, _cases("save", root), root / "dp2"),
                         timeout=120)
    handle = ranks.start(4, _cases("load", root), root / "dp4")
    dp1 = {c["name"]: ranks.case_checkpoint(c, 0, 1, root)
           for c in _cases("load", root)}
    dp4 = ranks.finish(handle, timeout=120)
    return saved, dp1, dp4


@pytest.mark.parametrize("key", list(SAVES))
def test_every_rank_writes_its_shard_and_the_manifest_covers_them(runs, key):
    saved, _, _ = runs
    files = saved[0][key]["files"]
    assert saved[1][key]["files"] == files
    shards = [f for f in files if f.startswith("zero_pp_rank_")]
    assert shards == ["zero_pp_rank_0_mp_rank_00optim_states.pt",
                      "zero_pp_rank_1_mp_rank_00optim_states.pt"]
    assert "mp_rank_00_model_states.pt" in files
    assert set(saved[0][key]["manifest"]) == {
        f for f in files if f != "MANIFEST.json"}


@pytest.mark.parametrize("dp", [1, 4])
@pytest.mark.parametrize("key", list(SAVES))
def test_a_dp2_checkpoint_loads_at_another_data_size(runs, key, dp):
    saved, dp1, dp4 = runs
    want = saved[0][key]
    for got in ([dp1[key]] if dp == 1 else [r[key] for r in dp4]):
        assert got["loaded"] and got["global_steps"] == 2
        np.testing.assert_allclose(got["fingerprint"], want["fingerprint"],
                                   **FP_TOL)
        np.testing.assert_allclose(got["resume"], want["resume"],
                                   **RESUME_TOL)
