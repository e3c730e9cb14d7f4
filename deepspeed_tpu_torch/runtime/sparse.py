"""Row-sparse (CSR-style) gradients for embedding tables.

Port of deepspeed_tpu/runtime/sparse.py (the reference's CSRTensor and
its sparse all-reduce): a table gradient as the rows it touches,
``indices`` [k] and ``values`` [k, cols], reduced across the data group
by an all-gather of every rank's fixed-capacity indices and values and
an ``index_add_`` into the dense shape. The traffic is ``dp * k * (cols
+ 1)`` elements instead of ``rows * cols``: a win when a step touches
few rows of a large table.

``sparse_embedding_lookup`` is ``table[ids]`` whose backward takes that
path (the ``sparse_gradients`` config): each rank's CSR pair is its own
``(ids, output gradient)``, whose sparsity the ids give without a scan.
The engine then reduces every gradient over the data group as usual, so
the lookup hands back the summed table gradient divided by the data
size: the engine's sum restores it once. As in the JAX package, the win
needs the table's other uses to be sparse too; GPT-2's and BERT's tied
LM heads give the same table a dense gradient, which the engine reduces
densely all the same.
"""

import torch

from . import dist as dist_lib


class CSRTensor:
    """Row-sparse view of a ``[rows, cols]`` tensor: ``indices`` [k] row
    ids and ``values`` [k, cols] rows; padding entries hold zero values
    (their id is irrelevant)."""

    def __init__(self, indices=None, values=None, dense_size=None):
        self.indices = indices
        self.values = values
        self.dense_size = list(dense_size) if dense_size is not None else None

    @staticmethod
    def type():
        return "deepspeed.CSRTensor"

    @classmethod
    def from_dense(cls, dense, max_rows=None):
        """The nonzero rows of ``dense``, at most ``max_rows`` of them
        (default: every row, always lossless; fewer is lossless while at
        most ``max_rows`` rows are nonzero): the top rows by absolute
        sum, the zero ones among them with zero values."""
        rows = dense.shape[0]
        k = rows if max_rows is None else min(int(max_rows), rows)
        presence = dense.abs().sum(dim=1)
        idx = torch.topk(presence, k).indices
        vals = dense[idx]
        vals = torch.where((presence[idx] > 0)[:, None], vals,
                           torch.zeros_like(vals))
        obj = cls(indices=idx, values=vals, dense_size=dense.shape)
        obj.orig_dense_tensor = dense
        return obj

    def to_dense(self):
        out = torch.zeros(self.dense_size, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, self.indices.long(), self.values)

    def sparse_size(self):
        index_size = int(self.indices.shape[0])
        value_size = int(self.values.shape[0] * self.values.shape[1])
        dense_size = int(self.dense_size[0] * self.dense_size[1])
        return index_size + value_size, dense_size

    def add(self, other):
        if self.dense_size != other.dense_size:
            raise ValueError("dense sizes must match")
        self.indices = torch.cat([self.indices, other.indices])
        self.values = torch.cat([self.values, other.values])

    def __repr__(self):
        sparse_size, dense_size = self.sparse_size()
        return (
            f"deepspeed_tpu_torch.CSRTensor(indices_size="
            f"{tuple(self.indices.shape)}, values_size="
            f"{tuple(self.values.shape)}, dense_size={self.dense_size}, "
            f"reduction_factor={dense_size / max(sparse_size, 1):.2f})"
        )


def sparse_all_reduce(csr, group=None, world=None):
    """The dense SUM over ``group`` of every rank's row-sparse gradient:
    an all-gather of the (fixed-capacity, equal on every rank) indices
    and values, then an ``index_add_`` into the dense shape."""
    import torch.distributed as dist

    world = dist.get_world_size(group) if world is None else world
    idx = csr.indices.reshape(-1).long().contiguous()
    vals = csr.values.reshape(idx.numel(), -1).contiguous()
    all_idx = torch.empty(world * idx.numel(), dtype=idx.dtype,
                          device=idx.device)
    all_vals = torch.empty((world * vals.shape[0], vals.shape[1]),
                           dtype=vals.dtype, device=vals.device)
    dist_lib.all_gather(all_idx, idx, group)
    dist_lib.all_gather(all_vals.view(-1), vals.view(-1), group)
    out = torch.zeros(csr.dense_size, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, all_idx, all_vals)


class _SparseLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, group, world):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        ctx.group, ctx.world = group, world
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        csr = CSRTensor(indices=ids.reshape(-1),
                        values=g.reshape(-1, g.shape[-1]),
                        dense_size=(ctx.rows, g.shape[-1]))
        dense = sparse_all_reduce(csr, ctx.group, ctx.world)
        return dense / ctx.world, None, None, None


def sparse_embedding_lookup(table, ids, group=None, world=1):
    """``table[ids]`` whose gradient goes through :func:`sparse_all_reduce`
    over ``group`` (``world`` ranks, see the module docstring); the plain
    gather in one process."""
    if world <= 1:
        return table[ids]
    return _SparseLookup.apply(table, ids, group, world)
