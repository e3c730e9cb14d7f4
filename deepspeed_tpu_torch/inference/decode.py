"""GPT-2 KV-cache decode over the paged pool: prefill + incremental step.

Port of the paged half of deepspeed_tpu/inference/decode.py. Serving is
split into the usual two phases:

  PREFILL  runs the prompt once through the full-sequence forward and
           keeps each layer's split-head key/value projections (the
           tensors attention consumed, via
           ``transformer_block_apply(..., return_kv=True)``); the flash
           forward kernel carries its attention.
  DECODE   feeds ONE token per slot through
           ``transformer_block_decode_paged``: qkv for the new position,
           k/v written into the pool, attention over the slot's pages
           (the paged decode kernel when ``fused``).

The cache is a global pool of fixed-size pages ``[layers, num_blocks,
block_size, heads, head_dim]`` indirected through per-slot block tables,
with page 0 the never-allocated NULL page. Unlike the JAX package, whose
functions return a new pool, every function here that writes the pool
writes it IN PLACE and returns the same ``KVPool``. The contiguous cache
(``kv_block_size: 0``) is not ported yet.
"""

import typing

import torch

from ..ops.transformer import (
    transformer_block_apply,
    transformer_block_decode_paged,
    transformer_block_prefill_paged,
)
from ..utils.device import resolve_device


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
                 device=None):
    """Zero-filled page pool for a GPT2Config: ``num_blocks`` usable pages
    plus the null page at physical index 0."""
    shape = (
        config.n_layer,
        int(num_blocks) + 1,  # + the null page
        int(block_size),
        config.n_head,
        config.n_embd // config.n_head,
    )
    device = resolve_device(device)
    return KVPool(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


@torch.no_grad()
def gpt2_prefill(model, tokens):
    """Full-sequence forward over ``tokens`` [B, S] that also returns each
    layer's k/v projections. Returns ``(logits [B, S, vocab_padded],
    k [L, B, heads, S, hd], v [...])``. Right-padded prompts are safe
    without a mask: causality keeps padding columns out of every real
    row."""
    s = tokens.shape[1]
    x = model.wte[tokens.long()] + model.wpe[None, :s, :]
    ks, vs = [], []
    for layer in model.h:
        x, (k, v) = transformer_block_apply(
            model.layer_config, layer, x, None, causal=True, return_kv=True,
        )
        ks.append(k)
        vs.append(v)
    return model.final_norm_and_logits(x), torch.stack(ks), torch.stack(vs)


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


@torch.no_grad()
def gpt2_decode_step_paged(model, tokens, positions, pool, block_tables,
                           fused=False):
    """One incremental token for every slot over the paged pool.
    ``tokens``/``positions`` [slots] int32; ``block_tables`` [slots,
    max_blocks] int32 (0 = null page). ``fused`` runs each layer's
    attention through the paged decode kernel instead of the gathered
    view. Writes this step's k/v into ``pool`` IN PLACE. Returns
    ``(logits [slots, vocab_padded], pool)``."""
    x = model.wte[tokens.long()] + model.wpe[positions.long()]
    x = x[:, None, :]  # [slots, 1, H]
    for layer, k_pool, v_pool in zip(model.h, pool.k, pool.v):
        x = transformer_block_decode_paged(
            model.layer_config, layer, x, k_pool, v_pool, block_tables,
            positions, fused=fused,
        )
    return model.final_norm_and_logits(x)[:, 0, :], pool


@torch.no_grad()
def gpt2_prefill_suffix(model, tokens, start_pos, pool, block_tables):
    """Prefill a prompt's UNIQUE SUFFIX against its cached prefix pages
    (the prefix-cache hit path). ``tokens`` [B, S] is the suffix padded to
    a bucket, ``start_pos`` [B] the cached prefix length (whole pages).
    Writes the suffix's k/v into ``pool`` IN PLACE. Returns ``(logits
    [B, S, vocab_padded], pool)``; row ``suffix_len-1`` seeds
    generation."""
    s = tokens.shape[1]
    positions = start_pos.long()[:, None] + torch.arange(
        s, device=tokens.device
    )[None, :]
    positions = torch.clamp(positions, max=model.wpe.shape[0] - 1)
    x = model.wte[tokens.long()] + model.wpe[positions]
    for layer, k_pool, v_pool in zip(model.h, pool.k, pool.v):
        x = transformer_block_prefill_paged(
            model.layer_config, layer, x, k_pool, v_pool, block_tables,
            start_pos,
        )
    return model.final_norm_and_logits(x), pool
