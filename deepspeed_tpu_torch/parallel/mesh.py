"""The process mesh: one torch.distributed rank per device.

Port of deepspeed_tpu/parallel/mesh.py. The JAX package's mesh is one
program over every device (a single controller); the port runs one
process per device, so its mesh is the same four axes laid over process
ranks in the same order, outermost first:

  pipe     — pipeline stages
  data     — data parallel / ZeRO sharding
  sequence — sequence parallelism
  model    — tensor model parallelism (innermost)

A rank's coordinates follow from its rank (row-major over the axes, the
model axis innermost, as the JAX package orders its mesh), ``pipe_group``
is the process group of its pipe-axis line (the ranks that differ from it
in the pipe coordinate only: the stages of the GPipe schedule,
parallel/pipeline.py), ``data_group`` that of its data-axis line (data
parallelism, ZeRO and the experts of ops/moe.py), ``seq_group`` that of
its sequence-axis line (ring and Ulysses attention, parallel/sequence.py)
and ``model_group`` that of its model-axis line. Every axis may exceed 1.
"""

import dataclasses
from typing import Optional

from ..config import constants as C

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
    coordinates ``{axis: index}`` and the process groups of its pipe-,
    data-, sequence- and model-axis lines (None for an axis of size 1)."""

    topology: MeshTopology
    rank: int
    coords: dict
    data_group: object = None
    model_group: object = None
    seq_group: object = None
    pipe_group: object = None

    @property
    def shape(self):
        t = self.topology
        return {PIPE_AXIS: t.pipe, DATA_AXIS: t.data, SEQ_AXIS: t.sequence,
                MODEL_AXIS: t.model}

    @property
    def pp_size(self):
        return self.topology.pipe

    @property
    def pipe_rank(self):
        return self.coords[PIPE_AXIS]

    @property
    def dp_size(self):
        return self.topology.data

    @property
    def data_rank(self):
        return self.coords[DATA_AXIS]

    @property
    def sp_size(self):
        return self.topology.sequence

    @property
    def seq_rank(self):
        return self.coords[SEQ_AXIS]

    @property
    def mp_size(self):
        return self.topology.model

    @property
    def model_rank(self):
        return self.coords[MODEL_AXIS]

    @property
    def world_group(self):
        """The group of every rank of the mesh (None in one process): what
        a decision every rank must share reduces over."""
        if self.topology.world_size <= 1:
            return None
        import torch.distributed as dist

        return dist.group.WORLD

    def line_ranks(self, axis):
        """The global ranks of this rank's line along ``axis``, in the
        order of that axis's coordinate."""
        shape = self.shape
        stride = 1
        for a in reversed(MESH_AXES):
            if a == axis:
                break
            stride *= shape[a]
        base = self.rank - self.coords[axis] * stride
        return tuple(base + i * stride for i in range(shape[axis]))


def _coords(rank, shape):
    out, rest = {}, rank
    for axis in reversed(MESH_AXES):
        out[axis] = rest % shape[axis]
        rest //= shape[axis]
    return {a: out[a] for a in MESH_AXES}


def _line_groups(shape, axis):
    """One process group per line along ``axis`` (the ranks that differ in
    that coordinate only), made on every rank in the same order, as
    ``torch.distributed.new_group`` requires; returns this process's
    line's group. A line that is the whole world is ``group.WORLD``."""
    import torch.distributed as dist

    world = 1
    for a in MESH_AXES:
        world *= shape[a]
    if shape[axis] == world:
        return dist.group.WORLD
    strides, acc = {}, 1
    for a in reversed(MESH_AXES):
        strides[a] = acc
        acc *= shape[a]
    rank = dist.get_rank()
    mine = None
    for base in range(world):
        if (base // strides[axis]) % shape[axis] != 0:
            continue  # not the first rank of its line
        members = [base + i * strides[axis] for i in range(shape[axis])]
        group = dist.new_group(members)
        if rank in members:
            mine = group
    return mine


def build_mesh(world_size=None, rank=None, **topo_kwargs) -> ProcessMesh:
    """The process mesh over the initialised torch.distributed world (or
    ``world_size``/``rank`` given), sized by ``resolve_topology``'s
    keywords. Every rank makes the pipe-axis line groups, then the
    data-axis ones, the sequence-axis ones and the model-axis ones
    (``new_group`` must be called in one order on every rank), so this
    is a collective of the world when any axis is above 1."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    topology = resolve_topology(world_size, **topo_kwargs)
    shape = {PIPE_AXIS: topology.pipe, DATA_AXIS: topology.data,
             SEQ_AXIS: topology.sequence, MODEL_AXIS: topology.model}
    groups = {}
    for axis in MESH_AXES:
        if shape[axis] <= 1:
            continue
        if not live:
            raise RuntimeError(
                f"a {axis} axis of {shape[axis]} needs an initialised "
                "torch.distributed group (deepspeed_tpu_torch.runtime.dist."
                "init_distributed)"
            )
        groups[axis] = _line_groups(shape, axis)
    return ProcessMesh(topology, int(rank), _coords(int(rank), shape),
                       groups.get(DATA_AXIS), groups.get(MODEL_AXIS),
                       groups.get(SEQ_AXIS), groups.get(PIPE_AXIS))


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
