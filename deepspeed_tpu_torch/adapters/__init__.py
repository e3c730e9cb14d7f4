"""Multi-tenant LoRA adapters: the host-side pool registry (pool.py) and
the adapter state-dict helpers (lora.py)."""

from .lora import (
    adapter_layer_stacks,
    adapter_num_params,
    init_lora_params,
    is_lora_name,
    merge_lora_params,
    split_lora_params,
)
from .pool import (
    IDENTITY_ADAPTER,
    AdapterPool,
    AdapterPoolFull,
    AdapterUnavailable,
)

__all__ = [
    "IDENTITY_ADAPTER",
    "AdapterPool",
    "AdapterPoolFull",
    "AdapterUnavailable",
    "adapter_layer_stacks",
    "adapter_num_params",
    "init_lora_params",
    "is_lora_name",
    "merge_lora_params",
    "split_lora_params",
]
