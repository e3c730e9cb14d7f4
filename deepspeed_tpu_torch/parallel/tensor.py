"""Tensor (model) parallelism: Megatron's collectives over the model
group, and the one place that cuts a tensor into model shards and joins
them again.

The JAX package states tensor parallelism as PartitionSpecs on the
parameters (deepspeed_tpu/models/gpt2.py:partition_specs) and lets GSPMD
insert the collectives; it has no module like this one. The port runs
one process per device, so a block on its ``heads / mp`` local heads
calls them itself (ops/transformer.py):

  copy-to-region      identity forward, all-reduce backward: the
                      replicated input of a column-parallel product (and
                      a replicated tensor used inside a parallel region,
                      whose gradient is partial on each rank)
  reduce-from-region  all-reduce forward, identity backward: the sum of a
                      row-parallel product's partial outputs
  vocab-parallel lookup  the ids outside this rank's rows of a
                      vocab-sharded table masked, the rows looked up, the
                      result all-reduced
  gather-from-region  the all-gather of a vocab-sharded logits plane
                      along its last dim (backward: this rank's slice),
                      for a caller that needs every logit

Shards (:func:`shard_for_rank`, :func:`join_shards`): a tensor split
along its model dim gives rank ``r`` the ``r``-th of ``mp`` contiguous
slices, as JAX's ``P(..., "model")`` does, except for the fused qkv
projection (``attn_qkvw`` [3H, H], ``attn_qkvb`` [3H], the qkv LoRA B
factor [r, 3H]). JAX's contiguous split of its 3H columns would put rank
0 on all of q and half of k, which GSPMD then lays out again; here each
rank takes its own heads of q, of k and of v: a strided slice of the
three column groups (deepspeed_tpu/ops/transformer.py:414-430). The
engine, ``convert.params_from_jax`` and the checkpoints all cut and join
through these two functions, so the element order of a joined tensor is
always the JAX package's.
"""

import dataclasses

import torch

from ..runtime import dist as dist_lib
from .mesh import MODEL_AXIS

#: The tensors whose model dim holds the q | k | v column groups.
QKV_STRIDED = ("attn_qkvw", "attn_qkvb", "attn_qkvw_lora_b")


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A rank's place on its model-axis line: the process ``group``, its
    ``size`` (mp) and this rank's index in it."""

    group: object
    size: int
    rank: int


def model_dim(spec):
    """The dim a spec (a tuple of axis names or None per tensor dim)
    shards over the model axis, or None."""
    if spec is None:
        return None
    for i, axis in enumerate(spec):
        if axis == MODEL_AXIS or (isinstance(axis, tuple)
                                  and MODEL_AXIS in axis):
            return i
    return None


def strided(name):
    """Whether tensor ``name`` (a full parameter name) is cut per q|k|v
    column group."""
    return name.rpartition(".")[2] in QKV_STRIDED


def shard_for_rank(name, full, dim, size, rank):
    """Rank ``rank``'s model shard of ``full`` along ``dim`` (None: the
    tensor itself), a view where the slice is contiguous."""
    if dim is None or size <= 1:
        return full
    if full.shape[dim] % (3 * size if strided(name) else size):
        raise ValueError(
            f"{name}: dim {dim} of {tuple(full.shape)} does not split "
            f"into {size} model shards"
            + (" of q, k and v each" if strided(name) else ""))
    if strided(name):
        return torch.cat([part.chunk(size, dim)[rank]
                          for part in full.chunk(3, dim)], dim)
    return full.chunk(size, dim)[rank]


def join_shards(name, shards, dim):
    """The inverse of :func:`shard_for_rank`: every rank's shard (in rank
    order) -> the full tensor, in the JAX package's element order."""
    if dim is None or len(shards) == 1:
        return shards[0]
    if strided(name):
        parts = [s.chunk(3, dim) for s in shards]
        return torch.cat([torch.cat([p[i] for p in parts], dim)
                          for i in range(3)], dim)
    return torch.cat(list(shards), dim)


def gather_shards(name, local, dim, tp):
    """All-gather ``local`` (this rank's shard of ``name`` along ``dim``)
    over the model group and join the shards: the full tensor on every
    rank of the group (a collective)."""
    if dim is None or tp is None or tp.size <= 1:
        return local
    local = local.detach().contiguous()
    flat = torch.empty(local.numel() * tp.size, dtype=local.dtype,
                       device=local.device)
    dist_lib.all_gather(flat, local.reshape(-1), tp.group)
    return join_shards(name, list(flat.view(tp.size, *local.shape)), dim)


# ---------------------------------------------------------------------------
# the collectives of a parallel region, as autograd Functions
# ---------------------------------------------------------------------------
def _summed(x, tp):
    out = x.contiguous().clone()
    dist_lib.all_reduce(out, tp.group)
    return out


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.tp), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _summed(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        x = x.contiguous()
        buf = torch.empty((tp.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist_lib.all_gather(buf.view(-1), x.reshape(-1), tp.group)
        return torch.cat(list(buf), dim=-1)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return g.chunk(tp.size, dim=-1)[tp.rank].contiguous(), None


def copy_to_region(x, tp):
    """Identity forward, the model group's all-reduce backward (None
    ``tp``: ``x``)."""
    return x if tp is None else _CopyToRegion.apply(x, tp)


def reduce_from_region(x, tp):
    """The model group's all-reduce forward, identity backward (None
    ``tp``: ``x``)."""
    return x if tp is None else _ReduceFromRegion.apply(x, tp)


def gather_from_region(x, tp):
    """Every rank's ``x`` concatenated along the last dim in rank order;
    the backward keeps this rank's slice (None ``tp``: ``x``)."""
    return x if tp is None else _GatherFromRegion.apply(x, tp)


def vocab_parallel_lookup(ids, table, tp, lookup=None):
    """``full_table[ids]`` from this rank's rows of a vocab-sharded
    ``table`` (rank ``r`` holds rows ``r*V/mp:(r+1)*V/mp``): the ids
    outside them looked up at row 0 and zeroed, then the model group's
    sum. ``lookup(table, local_ids)`` replaces the plain row gather (the
    sparse-gradient lookup of runtime/sparse.py); its gradient reaches
    this rank's rows only."""
    rows = table.shape[0]
    lo = tp.rank * rows
    inside = (ids >= lo) & (ids < lo + rows)
    local = torch.where(inside, ids - lo, torch.zeros_like(ids))
    emb = table[local] if lookup is None else lookup(table, local)
    emb = torch.where(inside[..., None], emb,
                      torch.zeros((), dtype=emb.dtype, device=emb.device))
    return reduce_from_region(emb, tp)
