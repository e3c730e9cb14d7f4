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

Under tensor parallelism the tied table is sharded over the vocab (rank
``r`` holds rows ``r*V/mp:(r+1)*V/mp``, models/gpt2.py:partition_specs)
and :func:`vocab_parallel_lm_head_loss` is the blocked loss over it: per
chunk the rank's logits, a MAX all-reduce of the row maxima over the
model group, a SUM all-reduce of the rows' sums of exponentials, and the
target's logit from the rank that holds its row (a masked local pick,
summed). The backward gives each rank its rows' gradient only, and the
loss is the same scalar on every model rank. The JAX package computes
the same thing under GSPMD, outside any Pallas kernel; here the
reductions are plain PyTorch and collectives too.
"""

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..parallel.tensor import copy_to_region
from ..runtime import dist as dist_lib


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


class _VocabParallelNLL(torch.autograd.Function):
    """Sum of one chunk's NLL over a vocab-sharded table: ``x`` [B, T, H]
    (inside the model region), this rank's ``table`` rows [V/mp, H],
    ``labels`` [B, T]. Keeps ``x``, the table and the rows' max and sum
    of exponentials; the backward recomputes the chunk's local logits,
    as the checkpointed chunk of :func:`blocked_lm_head_loss` does."""

    @staticmethod
    def forward(ctx, x, table, labels, tp, ignore_values):
        logits = x @ table.t()
        rows = table.shape[0]
        valid = _valid(labels, ignore_values)
        local = labels - tp.rank * rows
        mine = valid & (local >= 0) & (local < rows)
        safe = torch.where(mine, local, torch.zeros_like(local))
        m = logits.max(dim=-1).values.float()
        dist_lib.all_reduce(m, tp.group, op=dist.ReduceOp.MAX)
        z = torch.exp(logits.float() - m[..., None]).sum(dim=-1)
        picked = torch.gather(logits, -1, safe[..., None])[..., 0].float()
        both = torch.stack([z, torch.where(mine, picked,
                                           torch.zeros_like(picked))])
        dist_lib.all_reduce(both, tp.group)
        z, picked = both[0], both[1]
        nll = torch.log(z) + m - picked
        ctx.save_for_backward(x, table, labels, m, z)
        ctx.tp, ctx.ignore = tp, ignore_values
        return torch.where(valid, nll, torch.zeros_like(nll)).sum()

    @staticmethod
    def backward(ctx, g):
        x, table, labels, m, z = ctx.saved_tensors
        rows = table.shape[0]
        logits = x @ table.t()
        valid = _valid(labels, ctx.ignore)
        local = labels - ctx.tp.rank * rows
        mine = valid & (local >= 0) & (local < rows)
        safe = torch.where(mine, local, torch.zeros_like(local))
        # softmax minus the one-hot target, on the valid positions
        d = torch.exp(logits.float() - m[..., None]) / z[..., None]
        d = d.scatter_add(-1, safe[..., None],
                          -mine[..., None].to(d.dtype))
        d = (d * (valid[..., None] * g).to(d.dtype)).to(logits.dtype)
        dx = d @ table
        dtable = d.reshape(-1, rows).t() @ x.reshape(-1, x.shape[-1])
        return dx, dtable, None, None, None


def vocab_parallel_lm_head_loss(hidden, word_table, labels, tp,
                                block_rows=512, ignore_values=(-1, -100),
                                count_fn=None):
    """:func:`blocked_lm_head_loss` over this rank's rows ``word_table``
    [V/mp, H] of a vocab-sharded tied table (``tp``: the model group,
    parallel/tensor.py). ``hidden`` [B, T, H] is replicated over the
    model group; its gradient is the group's sum."""
    t = hidden.shape[1]
    block = min(block_rows, t) if block_rows > 0 else t
    hidden = copy_to_region(hidden, tp)
    num = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, t, block):
        stop = min(start + block, t)
        num = num + _VocabParallelNLL.apply(
            hidden[:, start:stop], word_table, labels[:, start:stop], tp,
            tuple(ignore_values))
    return num / _count(labels, ignore_values, count_fn)
