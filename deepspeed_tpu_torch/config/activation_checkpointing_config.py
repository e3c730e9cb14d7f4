"""Activation checkpointing sub-config.

Port of deepspeed_tpu/config/activation_checkpointing_config.py: the
``activation_checkpointing`` block parsed with the JAX package's keys and
defaults (partition_activations, contiguous_memory_optimization,
cpu_checkpointing, number_checkpoints, synchronize_checkpoint_boundary,
profile). The training engine hands the parsed block to
``deepspeed_tpu_torch.checkpointing.configure``, as the JAX engine does;
a model's own remat (``remat`` / ``remat_policy`` on its config) runs
through ``torch.utils.checkpoint`` (ops/transformer.py).
"""

from . import constants as C
from .config_utils import get_scalar_param


class DeepSpeedActivationCheckpointingConfig:
    def __init__(self, param_dict=None):
        self.partition_activations = C.ACT_CKPT_PARTITION_ACTIVATIONS_DEFAULT
        self.contiguous_memory_optimization = (
            C.ACT_CKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT
        )
        self.cpu_checkpointing = C.ACT_CKPT_CPU_CHECKPOINTING_DEFAULT
        self.number_checkpoints = C.ACT_CKPT_NUMBER_CHECKPOINTS_DEFAULT
        self.synchronize_checkpoint_boundary = (
            C.ACT_CKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT
        )
        self.profile = C.ACT_CKPT_PROFILE_DEFAULT

        if param_dict is not None:
            act_dict = param_dict.get(C.ACTIVATION_CHECKPOINTING)
            if isinstance(act_dict, dict):
                self._read(act_dict)

    def _read(self, act_dict):
        self.partition_activations = get_scalar_param(
            act_dict,
            C.ACT_CKPT_PARTITION_ACTIVATIONS,
            C.ACT_CKPT_PARTITION_ACTIVATIONS_DEFAULT,
        )
        self.contiguous_memory_optimization = get_scalar_param(
            act_dict,
            C.ACT_CKPT_CONTIGUOUS_MEMORY_OPTIMIZATION,
            C.ACT_CKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT,
        )
        self.cpu_checkpointing = get_scalar_param(
            act_dict, C.ACT_CKPT_CPU_CHECKPOINTING, C.ACT_CKPT_CPU_CHECKPOINTING_DEFAULT
        )
        self.number_checkpoints = get_scalar_param(
            act_dict, C.ACT_CKPT_NUMBER_CHECKPOINTS, C.ACT_CKPT_NUMBER_CHECKPOINTS_DEFAULT
        )
        self.synchronize_checkpoint_boundary = get_scalar_param(
            act_dict,
            C.ACT_CKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY,
            C.ACT_CKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT,
        )
        self.profile = get_scalar_param(
            act_dict, C.ACT_CKPT_PROFILE, C.ACT_CKPT_PROFILE_DEFAULT
        )

    def repr_dict(self):
        return {
            C.ACT_CKPT_PARTITION_ACTIVATIONS: self.partition_activations,
            C.ACT_CKPT_CONTIGUOUS_MEMORY_OPTIMIZATION: self.contiguous_memory_optimization,
            C.ACT_CKPT_CPU_CHECKPOINTING: self.cpu_checkpointing,
            C.ACT_CKPT_NUMBER_CHECKPOINTS: self.number_checkpoints,
            C.ACT_CKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY: self.synchronize_checkpoint_boundary,
            C.ACT_CKPT_PROFILE: self.profile,
        }

    def __repr__(self):
        return f"DeepSpeedActivationCheckpointingConfig({self.repr_dict()})"
