"""Parallelism: the process mesh, the mpu protocol over it, and the
tensor-parallel collectives.

Port of deepspeed_tpu/parallel/ (mesh.py, mpu.py): data and model
(tensor) parallelism across processes, one per device; tensor.py holds
the Megatron collectives that GSPMD inserts for the JAX package. The JAX
package's sequence parallelism (ring attention, Ulysses; ROADMAP A7b) and
SPMD pipeline (A7d) are not ported.
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
