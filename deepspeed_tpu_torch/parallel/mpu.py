"""The model-parallel unit (mpu) over the process mesh.

Port of deepspeed_tpu/parallel/mpu.py. The reference consumed a
Megatron-style ``mpu`` object exposing ``get_{model,data}_parallel_
{rank,group,world_size}`` (and the sequence and pipeline forms);
:class:`TorchMpu` implements that protocol on the process mesh
(parallel/mesh.py). Where the JAX package's groups are axis names for
its collectives, these are torch.distributed process groups (the data,
sequence or model axis's line; None for an axis of size 1, whose
only member is this rank), and the ranks are this process's mesh
coordinates. ``checkpointing.model_parallel_seed`` and an external
Megatron integration read the model-parallel rank and group.

An external object with the same duck-type is accepted wherever an mpu
is taken (:class:`ExternalMpuAdapter` wraps it), the reference's hook
for a user's tensor-parallel integration.
"""

from . import mesh as mesh_lib


class TorchMpu:
    """Mesh-backed mpu: sizes from the topology, ranks from this rank's
    coordinates, groups as process groups."""

    def __init__(self, mesh):
        self.mesh = mesh

    # --- sizes ---------------------------------------------------------
    def get_model_parallel_world_size(self):
        return self.mesh.shape[mesh_lib.MODEL_AXIS]

    def get_data_parallel_world_size(self):
        return self.mesh.shape[mesh_lib.DATA_AXIS]

    def get_sequence_parallel_world_size(self):
        return self.mesh.shape[mesh_lib.SEQ_AXIS]

    def get_pipeline_parallel_world_size(self):
        return self.mesh.shape[mesh_lib.PIPE_AXIS]

    # --- groups (None for an axis of size 1) ------------------------------
    def get_model_parallel_group(self):
        return self.mesh.model_group

    def get_data_parallel_group(self):
        return self.mesh.data_group

    def get_sequence_parallel_group(self):
        return self.mesh.seq_group

    def get_pipeline_parallel_group(self):
        return self.mesh.pipe_group

    # --- ranks ---------------------------------------------------------
    def get_model_parallel_rank(self):
        return self.mesh.coords[mesh_lib.MODEL_AXIS]

    def get_data_parallel_rank(self):
        return self.mesh.coords[mesh_lib.DATA_AXIS]

    def get_sequence_parallel_rank(self):
        return self.mesh.coords[mesh_lib.SEQ_AXIS]

    def get_pipeline_parallel_rank(self):
        return self.mesh.coords[mesh_lib.PIPE_AXIS]


class ExternalMpuAdapter:
    """Wrap a Megatron-style mpu object; pass-through of the reference
    protocol so user-supplied mpus keep working."""

    def __init__(self, mpu):
        self._mpu = mpu

    def __getattr__(self, name):
        return getattr(self._mpu, name)


def as_mpu(obj, mesh=None):
    """``obj`` as an mpu: a :class:`TorchMpu` over ``mesh`` when ``obj``
    is None, ``obj`` itself when it already is one, else wrapped."""
    if obj is None:
        if mesh is None:
            raise ValueError("as_mpu needs an mpu object or a mesh")
        return TorchMpu(mesh)
    if isinstance(obj, (TorchMpu, ExternalMpuAdapter)):
        return obj
    return ExternalMpuAdapter(obj)
