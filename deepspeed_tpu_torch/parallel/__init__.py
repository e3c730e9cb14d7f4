"""Parallelism: the process mesh, the mpu protocol over it, the
tensor-parallel collectives, sequence parallelism and the pipeline.

Port of deepspeed_tpu/parallel/ (mesh.py, mpu.py, sequence.py,
pipeline.py): pipeline, data, sequence and model (tensor) parallelism
across processes, one per device; tensor.py holds the Megatron
collectives that GSPMD inserts for the JAX package, sequence.py the ring
and Ulysses attention over the sequence process group, pipeline.py the
GPipe schedule over the pipe process group (one process a stage, the
activations sent stage to stage where the JAX package runs one SPMD
program).
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
from .pipeline import PipelineStage, gpipe, pipeline_line, pipeline_stages
from .sequence import (
    SequenceParallel,
    ring_attention,
    ring_attention_local,
    sequence_line,
    sequence_parallel_attention,
    ulysses_attention,
    ulysses_attention_local,
)

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
    "PipelineStage",
    "gpipe",
    "pipeline_line",
    "pipeline_stages",
    "SequenceParallel",
    "ring_attention",
    "ring_attention_local",
    "sequence_line",
    "sequence_parallel_attention",
    "ulysses_attention",
    "ulysses_attention_local",
]
