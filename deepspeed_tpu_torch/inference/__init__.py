"""Continuous-batching inference over a contiguous or paged KV cache.

  decode.py    — prefill + incremental decode over the contiguous cache
                 or the page pool.
  paging.py    — the host-side page allocator and prefix cache.
  host_tier.py — the host-RAM spill tier under the allocator: evicted
                 prefix pages and LoRA adapter rows park in host memory
                 (checksummed) and promote back asynchronously; one tier
                 is shared by the engines of a process share group.
  sampling.py  — greedy/temperature/top-k/top-p sampling.
  engine.py /  — ``init_inference()`` and the slot-managed
  scheduler.py   continuous-batching scheduler.
"""

from .decode import (
    KVCache,
    KVPool,
    gpt2_decode_step,
    gpt2_decode_step_paged,
    gpt2_prefill,
    gpt2_prefill_suffix,
    init_kv_cache,
    init_kv_pool,
    write_prefill_to_cache,
    write_prefill_to_pool,
)
from .engine import InferenceEngine, init_inference
from .host_tier import HostTier, PromotionHandle
from .paging import NULL_BLOCK, BlockPool, PoolExhausted, hash_full_blocks
from .sampling import sample_tokens
from .scheduler import (
    REJECT_CAPACITY,
    REJECT_DEADLINE,
    REJECT_DRAINING,
    REJECT_OVERLOAD,
    REJECT_RATE_LIMIT,
    REJECT_REASONS,
    ContinuousBatchingScheduler,
    InferenceRequest,
    RequestRejected,
)

__all__ = [
    "REJECT_CAPACITY",
    "REJECT_DEADLINE",
    "REJECT_DRAINING",
    "REJECT_OVERLOAD",
    "REJECT_RATE_LIMIT",
    "REJECT_REASONS",
    "HostTier",
    "PromotionHandle",
    "KVCache",
    "KVPool",
    "NULL_BLOCK",
    "BlockPool",
    "PoolExhausted",
    "hash_full_blocks",
    "gpt2_decode_step",
    "gpt2_decode_step_paged",
    "gpt2_prefill",
    "gpt2_prefill_suffix",
    "init_kv_cache",
    "init_kv_pool",
    "write_prefill_to_cache",
    "write_prefill_to_pool",
    "InferenceEngine",
    "init_inference",
    "sample_tokens",
    "ContinuousBatchingScheduler",
    "InferenceRequest",
    "RequestRejected",
]
