"""Cross-rank agreement in the preemption drain, the checkpoint load and
the save commit, on two gloo ranks (tests/torch_dp_ranks.py, one spawn
for the module).

- The drain: a SIGTERM reaches one rank; at the next step boundary every
  rank must save the same tag (the JAX engine allgathers the armed flag,
  deepspeed_tpu/runtime/engine.py:1847-1863). A rank that drained alone
  would wait in the save's barrier while the other ran the next window.
- The load: one rank falls back to an older tag after an injected read
  fault on the newest; every rank must then load nothing (the JAX
  package's tag agreement, deepspeed_tpu/runtime/checkpointing.py:
  705-727), not resume from different checkpoints.
- The commit: rank 0's post-save verification fails; every rank must
  raise the same error instead of rank 1 waiting for a 'latest' that is
  never published.

Run alone: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_dist_resilience.py -q`` (about 20 s).
"""

import pytest

import torch_dp_ranks as ranks
from torch_test_env import jax_compile_cache  # noqa: F401

CASES = [
    {"name": "preempt", "kind": "preempt", "dir": "preempt"},
    {"name": "load_disagree", "kind": "load_disagree", "dir": "disagree"},
    {"name": "commit_fail", "kind": "commit_fail", "dir": "commit"},
]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    return ranks.finish(
        ranks.start(2, CASES, tmp_path_factory.mktemp("resilience")),
        timeout=90)


def test_a_signal_to_one_rank_drains_every_rank_at_one_boundary(spawned):
    got = [r["preempt"] for r in spawned]
    for g in got:
        assert g["saved"] == ["latest", "preempt_global_step2"]
        assert g["latest"] == "preempt_global_step2"
        assert not g["armed"]  # exit_after_save false: disarmed, trains on
        assert g["global_steps"] == 3
    # the global batch's loss, the same on both ranks every window
    assert got[0]["losses"] == got[1]["losses"]


def test_ranks_that_stage_different_tags_load_nothing(spawned):
    for g in (r["load_disagree"] for r in spawned):
        assert g["path"] is None and g["client"] == {}
        assert g["steps"] == 0  # the engine untouched
        # the fault spent, both ranks stage the newest tag and load it
        assert g["again"] == "t2" and g["steps_again"] == 2


def test_a_failed_commit_on_rank_0_fails_every_rank(spawned):
    for g in (r["commit_fail"] for r in spawned):
        assert g["raised"] == "CheckpointCorruptionError"
        assert not g["latest"]
