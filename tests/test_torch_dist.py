"""The torch.distributed bootstrap, the process mesh and mpu, and the
loader across ranks.

Every spawn of tests/torch_dp_ranks.py starts its ranks under the
launcher's environment (``DS_TPU_COORDINATOR_ADDRESS``, ``DS_TPU_NUM_
PROCESSES``, ``DS_TPU_PROCESS_ID``), so ``initialize()`` bootstraps a
gloo group of 2 or 4 ranks; each rank reports the group, its mesh
coordinates, the mpu's sizes, ranks and groups, and the port's three
collectives on known values. In this process: ``init_distributed``'s
return value and its two errors (deepspeed_tpu/runtime/dist.py:112-138),
a model, sequence or pipe axis that the topology of one process
refuses, and the loader's per-rank
rows against the JAX loader's per-process rows (its multi-process
slicing, run here by giving it the process count and index).
"""

import numpy as np
import pytest

import jax

import torch_dp_ranks as ranks
from deepspeed_tpu.runtime import dataloader as jloader_mod
from deepspeed_tpu_torch.parallel import (
    MeshTopology,
    ProcessMesh,
    TorchMpu,
    as_mpu,
    build_mesh,
    mesh_from_config,
    resolve_topology,
)
from deepspeed_tpu_torch.parallel.mpu import ExternalMpuAdapter
from deepspeed_tpu_torch.runtime import dist as dist_lib
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from torch_test_env import jax_compile_cache  # noqa: F401


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    cases = [{"name": "dist", "kind": "dist"}]
    handles = {w: ranks.start(w, cases, tmp_path_factory.mktemp(f"w{w}"))
               for w in (2, 4)}
    return {w: ranks.finish(h, timeout=120) for w, h in handles.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_the_launcher_environment_bootstraps_a_gloo_group(spawned, world):
    for rank, got in enumerate(r["dist"] for r in spawned[world]):
        assert got["backend"] == "gloo"
        assert (got["world"], got["rank"]) == (world, rank)
        # a second call finds the group: True, no second init
        assert got["init_again"] is True


@pytest.mark.parametrize("world", [2, 4])
def test_the_mesh_and_mpu_over_the_group(spawned, world):
    for rank, got in enumerate(r["dist"] for r in spawned[world]):
        assert got["coords"] == {"pipe": 0, "data": rank, "sequence": 0,
                                 "model": 0}
        assert (got["dp"], got["dp_rank"]) == (world, rank)
        assert (got["mp"], got["mp_rank"]) == (1, 0)
        assert got["group_size"] == world and got["mp_group"] is None


@pytest.mark.parametrize("world", [2, 4])
def test_the_collectives_sum_scatter_and_gather(spawned, world):
    total = world * (world + 1) / 2
    for rank, got in enumerate(r["dist"] for r in spawned[world]):
        assert got["all_reduce"] == [total] * 4
        # chunk `rank` of every rank's arange(2*world) + 10*rank, summed
        want = [sum(2 * rank + i + 10 * r for r in range(world))
                for i in range(2)]
        assert got["reduce_scatter"] == want
        assert got["all_gather"] == [float(r) for r in range(world)
                                     for _ in range(2)]


def test_init_distributed_return_values_and_errors(monkeypatch):
    for env in (dist_lib.COORD_ENV, dist_lib.NPROC_ENV, dist_lib.PID_ENV):
        monkeypatch.delenv(env, raising=False)
    # one process: nothing to rendezvous, required or not
    assert dist_lib.init_distributed() is False
    assert dist_lib.init_distributed(dist_init_required=True) is False
    # the caller manages torch.distributed: skipped entirely
    monkeypatch.setenv(dist_lib.NPROC_ENV, "2")
    assert dist_lib.init_distributed(dist_init_required=False) is False
    # no coordinator: False, or the launcher error when required
    assert dist_lib.init_distributed() is False
    with pytest.raises(RuntimeError, match="DS_TPU_COORDINATOR_ADDRESS"):
        dist_lib.init_distributed(dist_init_required=True)
    # a build without torch.distributed cannot start the group
    monkeypatch.setenv(dist_lib.COORD_ENV, "localhost:1")
    monkeypatch.setattr(dist_lib.dist, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        dist_lib.init_distributed(dist_init_required=True)


@pytest.mark.parametrize("axis", ["model_parallel_size",
                                  "sequence_parallel_size",
                                  "pipeline_parallel_size"])
def test_a_non_data_axis_is_refused_naming_a7(axis):
    # the model, sequence and pipe axes are ported: in one process only the
    # topology refuses them (tests/test_torch_model_parallel*.py,
    # tests/test_torch_sequence_parallel.py and tests/test_torch_pipeline*.py
    # run them on ranks)
    with pytest.raises(ValueError, match="not divisible by mp"):
        build_mesh(**{axis: 2})
    with pytest.raises(ValueError, match="not divisible by mp"):
        mesh_from_config({axis: 2})


def test_topology_errors_are_the_jax_ones():
    assert resolve_topology(4) == MeshTopology(1, 4, 1, 1)
    with pytest.raises(ValueError, match="not divisible by mp"):
        resolve_topology(3, model_parallel_size=2)
    with pytest.raises(ValueError, match="covers 2 devices but 1"):
        build_mesh(data_parallel_size=2)


def test_one_process_mesh_and_mpu():
    mesh = build_mesh()
    mpu = as_mpu(None, mesh)
    assert isinstance(mpu, TorchMpu)
    assert mpu.get_data_parallel_world_size() == 1
    assert mpu.get_data_parallel_group() is None
    assert mpu.get_pipeline_parallel_rank() == 0

    class Megatron:
        def get_data_parallel_world_size(self):
            return 7

    ext = as_mpu(Megatron())
    assert isinstance(ext, ExternalMpuAdapter)
    assert ext.get_data_parallel_world_size() == 7
    assert as_mpu(ext) is ext


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_loads_the_jax_processes_rows(monkeypatch, world,
                                                shuffle):
    """The port's rank r of n loads exactly the rows the JAX loader's
    process r of n does: the same seeded order, its contiguous slice of
    every global batch."""
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(40, 3)).astype(np.float32),
            np.arange(40, dtype=np.int32))
    for rank in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        want = list(jloader_mod.DeepSpeedDataLoader(
            data, batch_size=8, mesh=None, shuffle=shuffle, prefetch=0))
        monkeypatch.undo()
        mesh = ProcessMesh(MeshTopology(1, world, 1, 1), rank,
                           {"pipe": 0, "data": rank, "sequence": 0,
                            "model": 0})
        got = list(DeepSpeedDataLoader(data, batch_size=8, mesh=mesh,
                                       shuffle=shuffle, device="cpu",
                                       prefetch=0))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g[1].shape[0] == 8 // world
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
            np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))


def test_the_loader_across_ranks_drops_a_ragged_batch():
    mesh = ProcessMesh(MeshTopology(1, 2, 1, 1), 1,
                       {"pipe": 0, "data": 1, "sequence": 0, "model": 0})
    data = (np.zeros((10, 2), np.float32),)
    loader = DeepSpeedDataLoader(data, batch_size=4, mesh=mesh,
                                 drop_last=False, device="cpu")
    assert loader.drop_last and len(loader) == 2
    with pytest.raises(ValueError, match="must divide across 2"):
        DeepSpeedDataLoader(data, batch_size=3, mesh=mesh, device="cpu")
