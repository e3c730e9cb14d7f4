"""Parallelism: the process mesh and the mpu protocol over it.

Port of deepspeed_tpu/parallel/ (mesh.py, mpu.py): data parallelism
across processes, one per device. The JAX package's sequence parallelism
(ring attention, Ulysses) and SPMD pipeline are not ported (ROADMAP A7).
"""

from .mesh import (
    DATA_AXIS,
    MESH_AXES,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    MeshTopology,
    ProcessMesh,
    build_mesh,
    mesh_from_config,
    resolve_topology,
)
from .mpu import ExternalMpuAdapter, TorchMpu, as_mpu

__all__ = [
    "DATA_AXIS",
    "MESH_AXES",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "MeshTopology",
    "ProcessMesh",
    "build_mesh",
    "mesh_from_config",
    "resolve_topology",
    "ExternalMpuAdapter",
    "TorchMpu",
    "as_mpu",
]
