"""Ops: attention (the flash forward and backward kernels), paged decode
attention (decode kernel), the transformer block, the expert-parallel
MoE FFN, the LM-head loss, the optimizers (fused LAMB's phase-1 kernel),
and the kernels' build/load layer. The ``attention`` dispatcher stays in its module, where its name
does not shadow the submodule."""

from .attention import flash_attention, flash_fwd, mha_reference
from .decode_attention import paged_flash_decode
from .moe import DeepSpeedMoETransformerLayer, MoEConfig, MoEMLP

__all__ = [
    "DeepSpeedMoETransformerLayer",
    "MoEConfig",
    "MoEMLP",
    "flash_attention",
    "flash_fwd",
    "mha_reference",
    "paged_flash_decode",
]
