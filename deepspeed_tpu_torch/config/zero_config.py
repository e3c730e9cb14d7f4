"""ZeRO optimization sub-config.

Port of deepspeed_tpu/config/zero_config.py (the JAX package's
``DeepSpeedZeroConfig``), with the same keys, defaults and errors: stage
selection, bucket-size knobs, reduce-scatter toggle, overlap, contiguous
gradients, fp32-weight restore, the optimizer offload block, the stage-3
overlap knobs, and the deprecated boolean form (``"zero_optimization":
true`` means stage 1).

The training engine runs on one device, where every stage lays the state
out as stage 0 does; the bucket sizes and overlap knobs are parsed and
checked so that a reference config works unchanged, and the engine
refuses what it cannot run (optimizer offload).
"""

from . import constants as C
from .config_utils import get_scalar_param


class DeepSpeedZeroConfig:
    def __init__(self, param_dict=None):
        self.stage = C.ZERO_STAGE_DEFAULT
        self.allgather_partitions = C.ZERO_ALLGATHER_PARTITIONS_DEFAULT
        self.allgather_bucket_size = C.ZERO_ALLGATHER_BUCKET_SIZE_DEFAULT
        self.reduce_scatter = C.ZERO_REDUCE_SCATTER_DEFAULT
        self.reduce_bucket_size = C.ZERO_REDUCE_BUCKET_SIZE_DEFAULT
        self.overlap_comm = C.ZERO_OVERLAP_COMM_DEFAULT
        self.contiguous_gradients = C.ZERO_CONTIGUOUS_GRADIENTS_DEFAULT
        self.load_from_fp32_weights = C.ZERO_LOAD_FROM_FP32_WEIGHTS_DEFAULT
        self.max_elements_per_comm = C.ZERO_MAX_ELEMENTS_PER_COMM_DEFAULT
        self.master_weights = C.ZERO_MASTER_WEIGHTS_DEFAULT
        self.offload_optimizer_device = C.ZERO_OFFLOAD_DEVICE_DEFAULT
        self.stage3_gather_block = C.ZERO_STAGE3_GATHER_BLOCK_DEFAULT
        self.stage3_latency_hiding = C.ZERO_STAGE3_LATENCY_HIDING_DEFAULT
        # keys the user actually wrote (raw, pre-default): _check_zero
        # rejects unknown ones and stage3_* knobs below stage 3
        self.explicit_keys = frozenset()

        if param_dict is not None:
            raw = param_dict.get(C.ZERO_OPTIMIZATION)
            if isinstance(raw, bool):
                # Deprecated form: true => stage 1, false => disabled.
                self.stage = (
                    C.ZERO_OPTIMIZATION_OPTIMIZER_STATES
                    if raw
                    else C.ZERO_OPTIMIZATION_DISABLED
                )
            elif isinstance(raw, dict):
                self._read(raw)
            elif raw is not None:
                raise TypeError(
                    f"'{C.ZERO_OPTIMIZATION}' must be a bool or object, got "
                    f"{type(raw).__name__}"
                )

    def _read(self, zero_dict):
        self.explicit_keys = frozenset(zero_dict.keys())
        self.stage = get_scalar_param(zero_dict, C.ZERO_STAGE, C.ZERO_STAGE_DEFAULT)
        self.allgather_partitions = get_scalar_param(
            zero_dict, C.ZERO_ALLGATHER_PARTITIONS, C.ZERO_ALLGATHER_PARTITIONS_DEFAULT
        )
        self.allgather_bucket_size = get_scalar_param(
            zero_dict,
            C.ZERO_ALLGATHER_BUCKET_SIZE,
            get_scalar_param(
                zero_dict,
                C.ZERO_ALLGATHER_BUCKET_SIZE_DEPRECATED,
                C.ZERO_ALLGATHER_BUCKET_SIZE_DEFAULT,
            ),
        )
        self.reduce_scatter = get_scalar_param(
            zero_dict, C.ZERO_REDUCE_SCATTER, C.ZERO_REDUCE_SCATTER_DEFAULT
        )
        self.reduce_bucket_size = get_scalar_param(
            zero_dict, C.ZERO_REDUCE_BUCKET_SIZE, C.ZERO_REDUCE_BUCKET_SIZE_DEFAULT
        )
        self.overlap_comm = get_scalar_param(
            zero_dict, C.ZERO_OVERLAP_COMM, C.ZERO_OVERLAP_COMM_DEFAULT
        )
        self.contiguous_gradients = get_scalar_param(
            zero_dict, C.ZERO_CONTIGUOUS_GRADIENTS, C.ZERO_CONTIGUOUS_GRADIENTS_DEFAULT
        )
        self.load_from_fp32_weights = get_scalar_param(
            zero_dict, C.ZERO_LOAD_FROM_FP32_WEIGHTS, C.ZERO_LOAD_FROM_FP32_WEIGHTS_DEFAULT
        )
        self.max_elements_per_comm = get_scalar_param(
            zero_dict, C.ZERO_MAX_ELEMENTS_PER_COMM, C.ZERO_MAX_ELEMENTS_PER_COMM_DEFAULT
        )
        self.master_weights = get_scalar_param(
            zero_dict, C.ZERO_MASTER_WEIGHTS, C.ZERO_MASTER_WEIGHTS_DEFAULT
        )
        off = zero_dict.get(C.ZERO_OFFLOAD_OPTIMIZER)
        if off is not None:
            if not isinstance(off, dict):
                raise TypeError(
                    f"'{C.ZERO_OFFLOAD_OPTIMIZER}' must be an object, got "
                    f"{type(off).__name__}"
                )
            # default 'none' (upstream semantics): an offload block without
            # an explicit device — e.g. ported configs carrying only
            # pin_memory — must not silently enable host offload
            device = off.get(
                C.ZERO_OFFLOAD_DEVICE, C.ZERO_OFFLOAD_DEVICE_DEFAULT
            )
            if device not in ("none", "cpu"):
                raise ValueError(
                    f"{C.ZERO_OFFLOAD_OPTIMIZER}.{C.ZERO_OFFLOAD_DEVICE} "
                    f"must be 'none' or 'cpu', got {device!r}"
                )
            self.offload_optimizer_device = device
        # stage-3 collective/compute overlap knobs (docs/performance.md);
        # range/type/stage gating happens in config.py:_check_zero
        self.stage3_gather_block = get_scalar_param(
            zero_dict, C.ZERO_STAGE3_GATHER_BLOCK,
            C.ZERO_STAGE3_GATHER_BLOCK_DEFAULT,
        )
        self.stage3_latency_hiding = get_scalar_param(
            zero_dict, C.ZERO_STAGE3_LATENCY_HIDING,
            C.ZERO_STAGE3_LATENCY_HIDING_DEFAULT,
        )

    def repr_dict(self):
        return {
            C.ZERO_STAGE: self.stage,
            C.ZERO_ALLGATHER_PARTITIONS: self.allgather_partitions,
            C.ZERO_ALLGATHER_BUCKET_SIZE: self.allgather_bucket_size,
            C.ZERO_REDUCE_SCATTER: self.reduce_scatter,
            C.ZERO_REDUCE_BUCKET_SIZE: self.reduce_bucket_size,
            C.ZERO_OVERLAP_COMM: self.overlap_comm,
            C.ZERO_CONTIGUOUS_GRADIENTS: self.contiguous_gradients,
            C.ZERO_LOAD_FROM_FP32_WEIGHTS: self.load_from_fp32_weights,
            C.ZERO_MASTER_WEIGHTS: self.master_weights,
            C.ZERO_OFFLOAD_OPTIMIZER: {
                C.ZERO_OFFLOAD_DEVICE: self.offload_optimizer_device
            },
            C.ZERO_STAGE3_GATHER_BLOCK: self.stage3_gather_block,
            C.ZERO_STAGE3_LATENCY_HIDING: self.stage3_latency_hiding,
        }

    def __repr__(self):
        return f"DeepSpeedZeroConfig({self.repr_dict()})"
