"""LM-head cross-entropy: plain and blocked.

Port of deepspeed_tpu/ops/cross_entropy.py (``blocked_lm_head_loss``) and
of ``cross_entropy_ignore_index`` (deepspeed_tpu/models/bert.py): the
mean next-token negative log-likelihood over positions whose label is
not an ignore value, with the log-sum-exp in float32 and the logits in
the compute dtype.

The blocked form streams the tokens through the tied head in chunks of
``block_rows`` sequence positions, each chunk under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``): the
backward recomputes a chunk's [B, block, vocab] logits instead of
keeping all of them, so one chunk's logits is the only such buffer
alive. The JAX package pads the last chunk and masks the padding by
position; here the last chunk is simply shorter, which counts the same
positions.
"""

import torch
from torch.utils.checkpoint import checkpoint


def _valid(labels, ignore_values):
    valid = torch.ones_like(labels, dtype=torch.bool)
    for iv in ignore_values:
        valid &= labels != iv
    return valid


def _count(labels, ignore_values, count_fn=None):
    """max(valid positions, 1) as a float32 tensor (no host sync), or
    ``count_fn`` of the valid positions: the divisor of a data-parallel
    rank, max(the data group's count, 1) / dp, so that the ranks' losses
    average to the global batch's mean."""
    count = _valid(labels, ignore_values).sum().float()
    if count_fn is not None:
        return count_fn(count)
    return count.clamp(min=1)


def _nll_sum(logits, labels, ignore_values):
    """Sum of the NLL over the valid positions, float32 (0-d)."""
    valid = _valid(labels, ignore_values)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    picked = torch.gather(logits, -1, safe[..., None])[..., 0].float()
    m = logits.max(dim=-1).values.detach().float()
    z = torch.exp(logits.float() - m[..., None]).sum(dim=-1)
    nll = torch.log(z) + m - picked
    return torch.where(valid, nll, torch.zeros_like(nll)).sum()


def cross_entropy_ignore_index(logits, labels, ignore_values=(-1, -100),
                               count_fn=None):
    """Mean CE of ``logits`` [..., V] against ``labels`` [...] (the
    divisor through ``count_fn``, see :func:`_count`)."""
    return _nll_sum(logits, labels, ignore_values) / _count(
        labels, ignore_values, count_fn
    )


def blocked_lm_head_loss(hidden, word_table, labels, block_rows=512,
                         ignore_values=(-1, -100), count_fn=None):
    """Mean CE of ``hidden @ word_table.T`` against ``labels``.

    ``hidden`` [B, T, H] (already shifted for next-token prediction),
    ``word_table`` [V, H] (the tied embedding), ``labels`` [B, T]
    integers; ``block_rows`` sequence positions per chunk; ``count_fn``
    as :func:`cross_entropy_ignore_index`."""
    t = hidden.shape[1]
    block = min(block_rows, t)

    def chunk(x, table, lab):
        return _nll_sum(x @ table.t(), lab, ignore_values)

    num = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, t, block):
        stop = min(start + block, t)
        num = num + checkpoint(
            chunk, hidden[:, start:stop], word_table, labels[:, start:stop],
            use_reentrant=False,
        )
    return num / _count(labels, ignore_values, count_fn)
