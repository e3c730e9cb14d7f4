"""GPT-2 KV-cache decode: prefill + incremental step, over a contiguous
cache or the paged pool.

Port of deepspeed_tpu/inference/decode.py. Serving is split into the
usual two phases:

  PREFILL  runs the prompt once through the full-sequence forward and
           keeps each layer's split-head key/value projections (the
           tensors attention consumed, via
           ``transformer_block_apply(..., return_kv=True)``); the flash
           forward kernel carries its attention.
  DECODE   feeds ONE token per slot through
           ``transformer_block_decode`` (contiguous) or
           ``transformer_block_decode_paged``: qkv for the new position,
           k/v written into the cache, attention over the slot's rows or
           pages (the paged decode kernel when ``fused``).

Two cache layouts. The contiguous cache (``kv_block_size: 0``, and the
speculative draft's own cache) is one ``[layers, slots, heads, max_len,
head_dim]`` block per slot. The paged cache is a global pool of
fixed-size pages ``[layers, num_blocks, block_size, heads, head_dim]``
indirected through per-slot block tables, with page 0 the
never-allocated NULL page. Unlike the JAX package, whose functions
return a new cache, every function here that writes a cache writes it
IN PLACE and returns the same ``KVCache``/``KVPool``.

Multi-LoRA serving: every function takes an optional adapter pool
(:func:`init_adapter_pool`) with per-request ``adapter_ids``; each layer
hands its slice of the pool to the block as ``apply_lora``'s batched
source, and decode routes those deltas through the SGMV kernel when
``fused``.

Tensor parallelism (a model whose ``configure_model_parallel`` the
serving engine armed): the caches and the adapter pool hold this model
rank's shards (models/gpt2.py: ``kv_cache_partition_specs``,
``kv_pool_partition_specs``, ``adapter_pool_partition_specs``; the
``mp_size`` of the ``init_*`` functions), the token embeddings are looked
up over the vocab shards (parallel/tensor.py:vocab_parallel_lookup), the
blocks run on the rank's heads, and the logits come whole from the
model's head (gathered over the model group).
"""

import typing

import torch

from ..models.gpt2 import (
    adapter_pool_partition_specs,
    kv_cache_partition_specs,
    kv_pool_partition_specs,
)
from ..ops.transformer import (
    resolve_lora_targets,
    transformer_block_apply,
    transformer_block_decode,
    transformer_block_decode_paged,
    transformer_block_prefill_paged,
)
from ..parallel.tensor import MODEL_AXIS, vocab_parallel_lookup
from ..utils.device import resolve_device


def _local_shape(shape, spec, mp_size):
    """``shape`` with every dim ``spec`` puts on the model axis divided by
    ``mp_size`` (a model rank's share)."""
    out = list(shape)
    for d, axis in enumerate(spec):
        if axis == MODEL_AXIS and mp_size > 1:
            if out[d] % mp_size:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"over a model axis of {mp_size}")
            out[d] //= mp_size
    return tuple(out)


class KVCache(typing.NamedTuple):
    """Contiguous decode cache: ``k``/``v`` each ``[layers, slots, heads,
    max_len, head_dim]``."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_slots(self):
        return self.k.shape[1]

    @property
    def max_len(self):
        return self.k.shape[3]


def init_kv_cache(config, num_slots, max_len, dtype=torch.float32,
                  device=None, mp_size=1):
    """Zero-filled contiguous cache for a GPT2Config: ``[L, slots, heads,
    max_len, hd]`` on ``device`` in ``dtype`` (``heads / mp_size`` of a
    model rank)."""
    shape = _local_shape((
        config.n_layer,
        int(num_slots),
        config.n_head,
        int(max_len),
        config.n_embd // config.n_head,
    ), kv_cache_partition_specs(), mp_size)
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


class KVPool(typing.NamedTuple):
    """Block-paged decode cache: ``k``/``v`` each ``[layers, num_blocks,
    block_size, heads, head_dim]``; physical page 0 is the NULL page."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_blocks(self):
        """Physical pages INCLUDING the null page."""
        return self.k.shape[1]

    @property
    def block_size(self):
        return self.k.shape[2]


def init_kv_pool(config, num_blocks, block_size, dtype=torch.float32,
                 device=None, mp_size=1):
    """Zero-filled page pool for a GPT2Config: ``num_blocks`` usable pages
    plus the null page at physical index 0 (``heads / mp_size`` of a
    model rank)."""
    shape = _local_shape((
        config.n_layer,
        int(num_blocks) + 1,  # + the null page
        int(block_size),
        config.n_head,
        config.n_embd // config.n_head,
    ), kv_pool_partition_specs(), mp_size)
    device = resolve_device(device)
    return KVPool(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def init_adapter_pool(config, n_adapters, rank, targets=None,
                      dtype=torch.float32, device=None, mp_size=1):
    """Zero-filled LoRA adapter pool for a GPT2Config: ``{target: (A [L,
    n_adapters+1, in, rank], B [L, n_adapters+1, rank, out])}`` on
    ``device`` in ``dtype``. Row 0 is the permanent all-zeros IDENTITY
    adapter (id 0 = no adapter; its delta is exactly 0.0); rows
    1..n_adapters are the loadable slots the engine's AdapterPool hands
    out. The factors keep the JAX orientation (delta = ``(x @ A) @ B``).
    A model rank's pool (``mp_size`` above 1) holds its shards of every
    adapter: B's output columns of a column-parallel target, A's input
    rows of a row-parallel one."""
    layer_cfg = config.layer_config()
    rank = int(rank)
    rows = int(n_adapters) + 1  # + the identity row
    device = resolve_device(device)
    specs = adapter_pool_partition_specs(targets)
    out = {}
    for t in resolve_lora_targets(targets):
        din, dout = layer_cfg.lora_dims(t)
        spec_a, spec_b = specs[t]
        out[t] = (
            torch.zeros(_local_shape((config.n_layer, rows, din, rank),
                                     spec_a, mp_size),
                        dtype=dtype, device=device),
            torch.zeros(_local_shape((config.n_layer, rows, rank, dout),
                                     spec_b, mp_size),
                        dtype=dtype, device=device),
        )
    return out


def _embed(model, tokens):
    """``model.wte[tokens]``, over the vocab shards when the model is
    tensor parallel (a collective of the model group)."""
    tp = getattr(model, "tensor_parallel", None)
    if tp is None:
        return model.wte[tokens]
    return vocab_parallel_lookup(tokens, model.wte, tp)


def _layer_lora(adapters, adapter_ids, lora_scale, layer, fused=False):
    """Layer ``layer``'s batched adapter source for ``apply_lora``: that
    layer's ``{target: (A [n+1, in, r], B [n+1, r, out])}`` rows with the
    per-slot ids, or None with no adapter pool (the adapter-free engine
    runs exactly the pre-adapter arithmetic)."""
    if adapters is None:
        return None
    pools = {t: (a[layer], b[layer]) for t, (a, b) in adapters.items()}
    return (pools, adapter_ids, lora_scale, fused)


@torch.no_grad()
def gpt2_prefill(model, tokens, adapters=None, adapter_ids=None,
                 lora_scale=1.0):
    """Full-sequence forward over ``tokens`` [B, S] that also returns each
    layer's k/v projections. Returns ``(logits [B, S, vocab_padded],
    k [L, B, heads, S, hd], v [...])``. Right-padded prompts are safe
    without a mask: causality keeps padding columns out of every real
    row. ``adapters``/``adapter_ids`` [B]: the prompt prefills THROUGH
    its tenant's adapter, so the pages seeding decode already carry the
    adapted k/v (id 0 = base model)."""
    s = tokens.shape[1]
    x = _embed(model, tokens.long()) + model.wpe[None, :s, :]
    ks, vs = [], []
    for i, layer in enumerate(model.h):
        x, (k, v) = transformer_block_apply(
            model.layer_config, layer, x, None, causal=True, return_kv=True,
            lora=_layer_lora(adapters, adapter_ids, lora_scale, i),
        )
        ks.append(k)
        vs.append(v)
    return model.final_norm_and_logits(x), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def write_prefill_to_cache(cache, slot, ks, vs):
    """Install one prefilled request's k/v ([L, 1, heads, S, hd]) into
    ``slot`` of the contiguous cache, positions 0..S-1, IN PLACE. Returns
    ``cache``."""
    s = ks.shape[3]
    cache.k[:, slot, :, :s] = ks[:, 0].to(cache.k.dtype)
    cache.v[:, slot, :, :s] = vs[:, 0].to(cache.v.dtype)
    return cache


@torch.no_grad()
def write_prefill_to_pool(pool, ks, vs, block_ids, offsets):
    """Install one cold-prefilled request's k/v ([L, 1, heads, S, hd])
    into its pages IN PLACE: position ``j`` lands at ``(block_ids[j],
    offsets[j])``. Padding rows carry the NULL page in ``block_ids``, so
    their k/v sink into the sacrificial page. Returns ``pool``."""
    block_ids = block_ids.long()
    offsets = offsets.long()
    # [L, 1, heads, S, hd] -> [L, S, heads, hd]
    pool.k[:, block_ids, offsets] = ks[:, 0].transpose(1, 2).to(pool.k.dtype)
    pool.v[:, block_ids, offsets] = vs[:, 0].transpose(1, 2).to(pool.v.dtype)
    return pool


def _embed_positions(model, tokens, positions):
    """Token plus position embeddings for one decode step, [slots, 1, H].
    A position past the table reads its last row, as JAX's gather clamps
    an out-of-bounds index (only the speculative draft's proposals near
    the length cap get there, and they are never committed)."""
    pos = torch.clamp(positions.long(), max=model.wpe.shape[0] - 1)
    return (_embed(model, tokens.long()) + model.wpe[pos])[:, None, :]


@torch.no_grad()
def gpt2_decode_step(model, tokens, positions, cache, adapters=None,
                     adapter_ids=None, lora_scale=1.0):
    """One incremental token for every slot over the contiguous cache.
    ``tokens``/``positions`` [slots] int32 (each slot's previous token and
    its position == tokens already cached); ``adapter_ids`` [slots] as in
    :func:`gpt2_decode_step_paged`. Writes this step's k/v into ``cache``
    IN PLACE (a position past ``max_len`` writes nothing). Dead slots ride
    along at their stale position. Returns ``(logits [slots,
    vocab_padded], cache)``."""
    x = _embed_positions(model, tokens, positions)
    for i, (layer, k_cache, v_cache) in enumerate(
        zip(model.h, cache.k, cache.v)
    ):
        x = transformer_block_decode(
            model.layer_config, layer, x, k_cache, v_cache, positions,
            lora=_layer_lora(adapters, adapter_ids, lora_scale, i),
        )
    return model.final_norm_and_logits(x)[:, 0, :], cache


@torch.no_grad()
def gpt2_decode_step_paged(model, tokens, positions, pool, block_tables,
                           adapters=None, adapter_ids=None, lora_scale=1.0,
                           fused=False):
    """One incremental token for every slot over the paged pool.
    ``tokens``/``positions`` [slots] int32; ``block_tables`` [slots,
    max_blocks] int32 (0 = null page); ``adapter_ids`` [slots] int32
    picks each slot's LoRA adapter from ``adapters`` (0 = identity).
    ``fused`` runs each layer's attention through the paged decode kernel
    and the LoRA deltas through the SGMV kernel instead of the gathered
    views. Writes this step's k/v into ``pool`` IN PLACE. Returns
    ``(logits [slots, vocab_padded], pool)``."""
    x = _embed_positions(model, tokens, positions)
    for i, (layer, k_pool, v_pool) in enumerate(
        zip(model.h, pool.k, pool.v)
    ):
        x = transformer_block_decode_paged(
            model.layer_config, layer, x, k_pool, v_pool, block_tables,
            positions, fused=fused,
            lora=_layer_lora(adapters, adapter_ids, lora_scale, i, fused),
        )
    return model.final_norm_and_logits(x)[:, 0, :], pool


@torch.no_grad()
def gpt2_prefill_suffix(model, tokens, start_pos, pool, block_tables,
                        adapters=None, adapter_ids=None, lora_scale=1.0):
    """Prefill a prompt's UNIQUE SUFFIX against its cached prefix pages
    (the prefix-cache hit path). ``tokens`` [B, S] is the suffix padded to
    a bucket, ``start_pos`` [B] the cached prefix length (whole pages).
    Writes the suffix's k/v into ``pool`` IN PLACE. ``adapters`` /
    ``adapter_ids`` [B] as in :func:`gpt2_prefill`. Returns ``(logits
    [B, S, vocab_padded], pool)``; row ``suffix_len-1`` seeds
    generation."""
    s = tokens.shape[1]
    positions = start_pos.long()[:, None] + torch.arange(
        s, device=tokens.device
    )[None, :]
    positions = torch.clamp(positions, max=model.wpe.shape[0] - 1)
    x = _embed(model, tokens.long()) + model.wpe[positions]
    for i, (layer, k_pool, v_pool) in enumerate(
        zip(model.h, pool.k, pool.v)
    ):
        x = transformer_block_prefill_paged(
            model.layer_config, layer, x, k_pool, v_pool, block_tables,
            start_pos,
            lora=_layer_lora(adapters, adapter_ids, lora_scale, i),
        )
    return model.final_norm_and_logits(x), pool
