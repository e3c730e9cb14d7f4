"""The process mesh: one torch.distributed rank per device.

Port of deepspeed_tpu/parallel/mesh.py. The JAX package's mesh is one
program over every device (a single controller); the port runs one
process per device, so its mesh is the same four axes laid over process
ranks in the same order, outermost first:

  pipe     — pipeline stages
  data     — data parallel / ZeRO sharding
  sequence — sequence parallelism
  model    — tensor model parallelism (innermost)

A rank's coordinates follow from its rank (row-major over the axes), and
``data_group`` is the process group of its data-axis line: the ranks that
differ from it in the data coordinate only. Only the data axis may exceed
1 here; the other three (sequence/ring attention, the pipeline schedule,
tensor parallelism) raise ``not_ported`` (ROADMAP A7).
"""

import dataclasses
from typing import Optional

from ..config import constants as C
from ..config.config import not_ported

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SEQ_AXIS = "sequence"
MODEL_AXIS = "model"

MESH_AXES = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    pipe: int
    data: int
    sequence: int
    model: int

    @property
    def world_size(self):
        return self.pipe * self.data * self.sequence * self.model


def resolve_topology(
    num_devices: int,
    data_parallel_size: Optional[int] = None,
    model_parallel_size: int = 1,
    sequence_parallel_size: int = 1,
    pipeline_parallel_size: int = 1,
) -> MeshTopology:
    """Fill in the data-parallel degree from the device count when unset
    (one process per device: ``num_devices`` is the world size)."""
    fixed = model_parallel_size * sequence_parallel_size * pipeline_parallel_size
    if num_devices % fixed != 0:
        raise ValueError(
            f"{num_devices} devices not divisible by mp*sp*pp = {fixed}"
        )
    dp = data_parallel_size if data_parallel_size is not None else num_devices // fixed
    topo = MeshTopology(
        pipe=pipeline_parallel_size,
        data=dp,
        sequence=sequence_parallel_size,
        model=model_parallel_size,
    )
    if topo.world_size != num_devices:
        raise ValueError(
            f"Mesh {topo} covers {topo.world_size} devices but "
            f"{num_devices} are available"
        )
    return topo


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place in the mesh: the topology, the rank, its
    coordinates ``{axis: index}`` and its data-axis process group (None in
    a single process)."""

    topology: MeshTopology
    rank: int
    coords: dict
    data_group: object = None

    @property
    def shape(self):
        t = self.topology
        return {PIPE_AXIS: t.pipe, DATA_AXIS: t.data, SEQ_AXIS: t.sequence,
                MODEL_AXIS: t.model}

    @property
    def dp_size(self):
        return self.topology.data

    @property
    def data_rank(self):
        return self.coords[DATA_AXIS]


def _coords(rank, shape):
    out, rest = {}, rank
    for axis in reversed(MESH_AXES):
        out[axis] = rest % shape[axis]
        rest //= shape[axis]
    return {a: out[a] for a in MESH_AXES}


def build_mesh(world_size=None, rank=None, **topo_kwargs) -> ProcessMesh:
    """The process mesh over the initialised torch.distributed world (or
    ``world_size``/``rank`` given), sized by ``resolve_topology``'s
    keywords. Raises ``not_ported`` for a model, sequence or pipeline
    axis above 1."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    for axis, key in ((MODEL_AXIS, "model_parallel_size"),
                      (SEQ_AXIS, "sequence_parallel_size"),
                      (PIPE_AXIS, "pipeline_parallel_size")):
        size = topo_kwargs.get(key, 1)
        if size > 1:
            raise not_ported(
                f"a {axis} mesh axis of {size} (ROADMAP A7: the "
                "parallelism modes)"
            )
    topology = resolve_topology(world_size, **topo_kwargs)
    group = None
    if topology.data > 1:
        if not live:
            raise RuntimeError(
                f"a data axis of {topology.data} needs an initialised "
                "torch.distributed group (deepspeed_tpu_torch.runtime.dist."
                "init_distributed)"
            )
        # the only axis above 1: its one line is the whole world
        group = dist.group.WORLD
    shape = {PIPE_AXIS: topology.pipe, DATA_AXIS: topology.data,
             SEQ_AXIS: topology.sequence, MODEL_AXIS: topology.model}
    return ProcessMesh(topology, int(rank), _coords(int(rank), shape), group)


def mesh_from_config(config, world_size=None, rank=None) -> ProcessMesh:
    """The mesh of a ``mesh`` config block (a dict of the four sizes, or
    an object with them as attributes)."""
    def get(key, default):
        if isinstance(config, dict):
            value = config.get(key, default)
        else:
            value = getattr(config, key, default)
        return default if value is None else value

    return build_mesh(
        world_size=world_size, rank=rank,
        data_parallel_size=get(C.MESH_DATA_PARALLEL_SIZE, None),
        model_parallel_size=get(C.MESH_MODEL_PARALLEL_SIZE, 1),
        sequence_parallel_size=get(C.MESH_SEQUENCE_PARALLEL_SIZE, 1),
        pipeline_parallel_size=get(C.MESH_PIPELINE_PARALLEL_SIZE, 1),
    )
