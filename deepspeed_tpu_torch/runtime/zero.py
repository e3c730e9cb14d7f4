"""ZeRO across data-parallel processes: which tensor shards where, and how.

Port of deepspeed_tpu/runtime/zero.py. The JAX package states ZeRO as
sharding specs and lets XLA insert the collectives; the port runs one
process per device and issues them itself (runtime/dist.py):

  stage 0 — gradients and optimizer state replicated; the gradients are
            all-reduced at the accumulation boundary.
  stage 1 — the fp32 masters and the optimizer state exist only for this
            rank's shard of each tensor; at the boundary the gradients
            are reduce-scattered to the shards, and after the update the
            new parameters are all-gathered.
  stage 2 — the gradient accumulation buffer is the shard too: every
            micro-step's gradients are reduce-scattered into it.
  stage 3 — the persistent parameters are shards as well; the model
            gathers them one block of layers at a time (models/stack.py).
            In float32 they are the masters: a flat int8 group's master
            is cut from them at each update (the engine's
            ``_master_leaf``).

The per-tensor rule is the JAX package's (:func:`leaf_partition_spec`):
shard the largest dimension the data-parallel size divides; with
``prefer_leading`` the earliest; a tensor with no such dimension stays
replicated. Under tensor parallelism the data axis lands only on a
dimension the model axis left free (the JAX rule's ``existing_spec``):
the layout's shapes are then the rank's model shards, and the model dim
of each (``model_dims``) is never a candidate. The spec functions are pure functions of names and shapes
and return ``{name: shard dim or None}``. The port's parameters are per
layer and its linear weights ``[out, in]`` where the JAX leaves are
``[L, in, out]``: a weight is ruled on its JAX orientation, so the rule
picks the JAX package's tensor dimension, ties included, as long as the
layer count is not the largest dimension (a model whose layer count is
its largest dimension shards differently in the two packages).

:class:`ZeroLayout` applies the specs. A shard along dim ``d`` is held
with ``d`` moved to the front (``[k, ...rest]``, rank ``r`` owning rows
``r*k:(r+1)*k``), so that every collective runs on a contiguous buffer
of ``dp`` equal chunks. With int8 moments the optimizer instead steps
one flat leaf per parameter group (``h.*.attn_qkvw``): the group's
tensors flattened in the JAX package's element order
(ops/optimizers.py:jax_element_order), padded to a multiple of
``max(256, dp)`` quantization blocks, and cut into ``dp`` contiguous
block ranges, which are the JAX engine's shards of its flat int8 leaves.
A group whose JAX leaf spans pipeline stages (a stage's layers of
``h.*.<name>``) has a block map instead (ops/quant.py:BlockMap): its
leaf is the stage's runs of the whole leaf's blocks, cut into ``dp``
contiguous block ranges. An expert group (``h.*.moe.expert_*``) keeps
its tensors as ``local`` leaves (below): its int8 leaf is the rank's
runs of the whole leaf's blocks, whole on the rank.

Tensors already partitioned over the data axis (``local``: the MoE
experts of ops/moe.py, whose gradients arrive whole from the token
all-to-all's backward) are not partitioned again, as the JAX rule leaves a
spec that holds the data axis alone: each is one whole leaf on its rank,
and its gradient is never reduced over the data group.
"""

import math
from collections import OrderedDict

import torch

from ..ops import quant
from ..ops.optimizers import jax_element_order, param_groups
from ..utils.logging import warn_once
from . import dist as dist_lib

ZERO_OPTIMIZATION_OPTIMIZER_STATES = 1
ZERO_OPTIMIZATION_GRADIENTS = 2
ZERO_OPTIMIZATION_WEIGHTS = 3


def leaf_partition_spec(shape, dp_size, prefer_leading=False, taken=None):
    """The dim of ``shape`` to shard over ``dp_size`` ranks, or None
    (replicated): the largest dim ``dp_size`` divides (ties: the first),
    or with ``prefer_leading`` the earliest; never ``taken``, the dim
    another mesh axis (the model axis) already shards."""
    if dp_size <= 1:
        return None
    best_dim, best_size = None, 0
    for i, d in enumerate(shape):
        if i == taken or d % dp_size != 0:
            continue
        if prefer_leading:
            return i
        if d > best_size:
            best_dim, best_size = i, d
    return best_dim


def gathered_spec(spec):
    """The spec a stage-3 tensor takes while a layer computes with it:
    ``spec`` without its data-axis shard. The port shards over the data
    axis only, so this is always None (the whole tensor)."""
    del spec
    return None


def _spec(name, shape, dp_size, prefer_leading, model_dim=None):
    """The rule on the tensor as the JAX package lays it out: a linear
    weight (``[out, in]`` here, ``[in, out]`` there; ops/optimizers.py:
    jax_element_order) is ruled on its reversed shape, so that a tie
    between equal dims falls on the JAX package's tensor dimension.
    ``model_dim``: the dim the model axis shards (left out)."""
    shape = tuple(shape)
    t = torch.empty(shape, device="meta")
    like = jax_element_order(name, t)
    if like is t:
        return leaf_partition_spec(shape, dp_size, prefer_leading,
                                   model_dim)
    d = leaf_partition_spec(tuple(like.shape), dp_size, prefer_leading,
                            None if model_dim is None else 1 - model_dim)
    return None if d is None else 1 - d


def _specs(shapes, dp_size, active, prefer_leading, model_dims=None):
    model_dims = model_dims or {}
    return {n: (_spec(n, s, dp_size, prefer_leading, model_dims.get(n))
                if active else None)
            for n, s in shapes.items()}


def zero_param_specs(shapes, dp_size, stage, prefer_leading=False,
                     model_dims=None):
    """Specs of the persistent parameters (sharded only at stage 3). A
    stage-3 tensor with no dp-divisible dim stays replicated, warned once
    (the analog of the reference's ``zero_empty_partition`` case)."""
    specs = _specs(shapes, dp_size, stage >= ZERO_OPTIMIZATION_WEIGHTS,
                   prefer_leading, model_dims)
    if stage >= ZERO_OPTIMIZATION_WEIGHTS and dp_size > 1:
        for n, spec in specs.items():
            if spec is None and len(shapes[n]) > 0:
                warn_once(
                    "zero3-replicated-leaves",
                    "ZeRO stage 3: parameter leaf %s %s has no free "
                    "dp%d-divisible dimension — it stays REPLICATED "
                    "(further such leaves are not logged)",
                    n, tuple(shapes[n]), dp_size,
                )
    return specs


def zero_grad_specs(shapes, dp_size, stage, prefer_leading=False,
                    model_dims=None):
    """Specs of the gradient accumulation buffer (sharded from stage 2)."""
    return _specs(shapes, dp_size, stage >= ZERO_OPTIMIZATION_GRADIENTS,
                  prefer_leading, model_dims)


def zero_optstate_specs(shapes, dp_size, stage, prefer_leading=False,
                        model_dims=None):
    """Specs of the fp32 masters and the per-tensor optimizer state
    (sharded from stage 1)."""
    return _specs(shapes, dp_size,
                  stage >= ZERO_OPTIMIZATION_OPTIMIZER_STATES,
                  prefer_leading, model_dims)


# ---------------------------------------------------------------------------
# shards of a tensor along one dim
# ---------------------------------------------------------------------------
def to_chunks(t, dim):
    """``t`` with ``dim`` moved to the front, contiguous: ``dp`` equal
    chunks of rows, one per rank."""
    return t.movedim(dim, 0).contiguous() if dim else t.contiguous()


def from_chunks(buf, shape, dim):
    """The inverse of :func:`to_chunks`: a view of ``buf`` in ``shape``."""
    moved = list(shape)
    moved.insert(0, moved.pop(dim))
    v = buf.reshape(moved)
    return v.movedim(0, dim) if dim else v


def shard_of(t, dim, dp, rank):
    """Rank ``rank``'s shard of ``t`` along ``dim``, as a contiguous
    ``[k, ...rest]`` tensor (a copy)."""
    k = t.shape[dim] // dp
    return t.narrow(dim, rank * k, k).movedim(dim, 0).contiguous().clone()


class _Leaf:
    """One tensor the optimizer steps on this rank: a dim shard of a
    parameter (``dim``), the whole of a replicated one (``dim`` None), or
    a block range of a flat int8 group (``members``; with ``runs``, the
    group's block map, of the rank's runs of the whole leaf)."""

    __slots__ = ("name", "members", "dim", "shape", "numel", "pad_to",
                 "local", "runs")

    def __init__(self, name, members, dim, shape, numel, pad_to=0,
                 local=False, runs=None):
        self.local = local  # partitioned over the data axis already
        self.name = name
        self.members = members  # [(param name, shape)]
        self.dim = dim
        self.shape = shape  # this rank's tensor shape
        self.numel = numel  # its element count
        self.pad_to = pad_to  # flat groups: the padded element count
        self.runs = runs

    @property
    def flat(self):
        return self.pad_to > 0

    @property
    def replicated(self):
        return not self.flat and self.dim is None


class ZeroLayout:
    """ZeRO's placement of a model's trainable tensors over the data
    group: the optimizer's leaves (this rank's shards), the stage-3
    persistent shards, and the collectives between them and the full
    tensors. ``shapes`` is ``{name: shape}`` in parameter order (under
    tensor parallelism the rank's model shards, whose model dims
    ``model_dims`` {name: dim} the data axis leaves alone). ``local``: the
    names already partitioned over the data axis (whole leaves here,
    never reduced). ``persist_shapes`` and ``persist_model_dims``: the
    stage-3 persistent tensors' shapes and model dims where they differ
    from the optimizer's (the model-gathered optimizer of int8 moments at
    a model axis above 1 steps whole tensors while the module holds model
    shards); by default ``shapes`` and ``model_dims``. ``quant_maps``
    ``{group: BlockMap}``: the engine's block maps; a flat group that has
    one (a stage's layers) is its map's data share (``shard``)."""

    def __init__(self, shapes, dp, rank, group, stage, flat_groups=False,
                 model_dims=None, local=(), persist_shapes=None,
                 persist_model_dims=None, quant_maps=None):
        self.dp = int(dp)
        self.rank = int(rank)
        self.group = group
        self.stage = int(stage)
        self.shapes = OrderedDict((n, tuple(s)) for n, s in shapes.items())
        self.persist_shapes = (self.shapes if persist_shapes is None else
                               OrderedDict((n, tuple(s)) for n, s
                                           in persist_shapes.items()))
        self.flat_groups = flat_groups
        self.local = frozenset(local)
        self.param_specs = zero_param_specs(
            self.persist_shapes, self.dp, stage, prefer_leading=flat_groups,
            model_dims=(model_dims if persist_shapes is None
                        else persist_model_dims))
        opt_specs = zero_optstate_specs(self.shapes, self.dp, stage,
                                        model_dims=model_dims)
        for n in self.local:
            self.param_specs[n] = opt_specs[n] = None
        self.leaves = OrderedDict()
        if flat_groups and stage >= ZERO_OPTIMIZATION_OPTIMIZER_STATES:
            pad = max(256, self.dp)
            for group_name, names in param_groups(self.shapes).items():
                members = [(n, self.shapes[n]) for n in names]
                if all(n in self.local for n in names):
                    # experts: whole tensors on their rank, never reduced
                    for n, shape in members:
                        self.leaves[n] = _Leaf(n, [(n, shape)], None, shape,
                                               math.prod(shape), local=True)
                    continue
                bmap = (quant_maps or {}).get(group_name)
                if bmap is not None:
                    self.leaves[group_name] = _Leaf(
                        group_name, members, None, (bmap.numel,),
                        bmap.numel, pad_to=bmap.run_numel, runs=bmap)
                    continue
                total = sum(math.prod(self.shapes[n]) for n in names)
                nb = max(1, math.ceil(total / quant.BLOCK))
                nb = -(-nb // pad) * pad
                per_rank = nb // self.dp * quant.BLOCK
                self.leaves[group_name] = _Leaf(
                    group_name, members, None, (per_rank,), per_rank,
                    pad_to=nb * quant.BLOCK)
        else:
            for n, s in self.shapes.items():
                d = opt_specs[n]
                shape = s if d is None else (s[d] // self.dp,) + tuple(
                    x for i, x in enumerate(s) if i != d)
                self.leaves[n] = _Leaf(n, [(n, s)], d, shape,
                                       math.prod(shape),
                                       local=n in self.local)
        # each parameter's leaf (a flat group's for its members)
        self._member_leaf = {n: lf for lf in self.leaves.values()
                             for n, _ in lf.members}

    # ---- the optimizer's tensors ------------------------------------------
    @property
    def sharded(self):
        """True when the optimizer steps shards (stage >= 1 at dp > 1)."""
        return self.stage >= ZERO_OPTIMIZATION_OPTIMIZER_STATES and self.dp > 1

    def _pack(self, leaf, tensors):
        """A leaf's ``dp`` chunks as one contiguous buffer (flat groups:
        the members in JAX element order, zero-padded; a mapped group's
        at their offsets in the rank's runs)."""
        if not leaf.flat:
            return to_chunks(tensors[leaf.name], leaf.dim)
        if leaf.runs is not None:
            offsets = leaf.runs.run_offsets
            buf = tensors[leaf.members[0][0]].new_zeros(leaf.pad_to)
            for n, _ in leaf.members:
                t = jax_element_order(n, tensors[n]).reshape(-1)
                buf[offsets[n]:offsets[n] + t.numel()] = t
            return buf
        parts = [jax_element_order(n, tensors[n]).reshape(-1)
                 for n, _ in leaf.members]
        used = sum(p.numel() for p in parts)
        parts.append(parts[0].new_zeros(leaf.pad_to - used))
        return torch.cat(parts)

    def _unpack_into(self, leaf, buf, out):
        """Copy a leaf's gathered buffer into the full tensors ``out``."""
        if not leaf.flat:
            out[leaf.name].copy_(
                from_chunks(buf, self.shapes[leaf.name], leaf.dim))
            return
        off = 0
        for n, shape in leaf.members:
            dst = out[n]
            view = jax_element_order(n, dst)
            k = dst.numel()
            if leaf.runs is not None:
                off = leaf.runs.run_offsets[n]
            view.copy_(buf[off:off + k].view(view.shape))
            off += k

    def shard_leaves(self, full, dtype=None, names=None):
        """This rank's leaves (or those in ``names``) cut from the full
        tensors ``full`` (copies, in ``dtype`` or the tensors' own)."""
        out = OrderedDict()
        for name, leaf in self.leaves.items():
            if names is not None and name not in names:
                continue
            if leaf.replicated:
                t = full[name].detach().clone()
            else:
                buf = self._pack(leaf, {n: full[n].detach()
                                        for n, _ in leaf.members})
                t = buf.reshape(self.dp, -1)[self.rank].reshape(
                    leaf.shape).clone()
            out[name] = t if dtype is None else t.to(dtype)
        return out

    def empty_leaves(self, dtype, device):
        """Zero tensors shaped like this rank's leaves."""
        return OrderedDict(
            (n, torch.zeros(lf.shape, dtype=dtype, device=device))
            for n, lf in self.leaves.items())

    @staticmethod
    def _store(out, name, g, first):
        """``g`` into ``out[name]``: taken as it is when ``out`` has no
        such buffer, else copied (``first``) or added."""
        if name not in out:
            out[name] = g
        elif first:
            out[name].copy_(g)
        else:
            out[name].add_(g.to(out[name].dtype))

    def leaf_view(self, name, full):
        """Leaf ``name`` as a view of the full tensor ``full`` when it is
        one (a dim-0 shard's contiguous rows, or a replicated tensor
        itself), else None."""
        leaf = self.leaves[name]
        if leaf.flat:
            return None
        if leaf.replicated:
            return full
        if leaf.dim != 0:
            return None
        k = leaf.shape[0]
        return full.narrow(0, self.rank * k, k)

    def reduce_grads(self, full_grads, out, first=True, names=None):
        """Sum full gradients over the data group into this rank's leaves
        ``out`` (or those in ``names``; copied in when ``first``, else
        added): reduce-scatter for shards, all-reduce for replicated
        leaves."""
        for name, leaf in self.leaves.items():
            if names is not None and name not in names:
                continue
            if leaf.local:
                g = full_grads[name]
            elif leaf.replicated:
                g = full_grads[name].clone()
                dist_lib.all_reduce(g, self.group)
            else:
                buf = self._pack(leaf, full_grads)
                g = torch.empty(leaf.shape, dtype=buf.dtype,
                                device=buf.device)
                dist_lib.reduce_scatter(g.view(-1), buf.view(-1), self.group)
            self._store(out, name, g, first)
        return out

    def reduce_one(self, name, g, out, state):
        """One parameter's full gradient into its leaf of ``out`` as soon
        as it exists (stage 2's hook): a dim or replicated leaf at once, a
        flat group when its last member arrives. ``state`` holds the
        micro-step's ``first`` flag, the names ``done`` and the flat
        groups' ``pending`` members and the groups already reduced
        (``flushed``)."""
        # a parameter whose gradient comes in parts (the pipeline's
        # microbatch backward passes) adds the later ones
        first = state["first"] and name not in state["done"]
        state["done"].add(name)
        leaf = self._member_leaf[name]
        if not leaf.flat:
            self.reduce_grads({name: g}, out, first, (leaf.name,))
            return
        members = state["pending"].setdefault(leaf.name, {})
        members[name] = g
        if len(members) == len(leaf.members):
            del state["pending"][leaf.name]
            first = state["first"] and leaf.name not in state["flushed"]
            state["flushed"].add(leaf.name)
            self.reduce_grads(members, out, first, (leaf.name,))

    def reduce_missing(self, params, out, state):
        """After the backward: zeros for every parameter whose gradient
        never came (the loss does not reach it), in parameter order."""
        for name, t in params.items():
            if name not in state["done"]:
                buf = out[self._member_leaf[name].name]
                self.reduce_one(name, torch.zeros(
                    t.shape, dtype=buf.dtype, device=buf.device), out, state)

    def add_persistent_grads(self, grads, out, first=True, to_full=None):
        """Stage 3: gradients of the persistent tensors (a shard's already
        summed over the data group by the gather's backward; a replicated
        tensor's local, all-reduced here) into this rank's leaves ``out``.
        Where the layouts differ (flat int8 groups), through the full
        tensors (``to_full(name, t)``: a persistent tensor's whole one
        when the optimizer's tensors are model-gathered)."""
        summed = OrderedDict()
        for n, g in grads.items():
            if self.param_specs[n] is None and n not in self.local:
                g = g.clone()
                dist_lib.all_reduce(g, self.group)
            summed[n] = g
        if not self.persistent_matches_leaves():
            full = OrderedDict(
                (n, self.gather_full(n, g)
                 if self.param_specs[n] is not None else g)
                for n, g in summed.items())
            if to_full is not None:
                full = OrderedDict((n, to_full(n, g))
                                   for n, g in full.items())
            summed = self.shard_leaves(full)
        for name in self.leaves:
            self._store(out, name, summed[name], first)
        return out

    def gather_into(self, leaves, full, names=None):
        """All-gather this rank's ``leaves`` (or those in ``names``) into
        the full tensors ``full`` (cast to their dtype). Replicated leaves
        are copied."""
        for name, leaf in self.leaves.items():
            if names is not None and name not in names:
                continue
            src = leaves[name]
            if leaf.replicated:
                full[name].copy_(src)
                continue
            dtype = full[leaf.members[0][0]].dtype
            chunk = src.reshape(-1).to(dtype)
            buf = torch.empty(self.dp * chunk.numel(), dtype=dtype,
                              device=chunk.device)
            dist_lib.all_gather(buf, chunk, self.group)
            self._unpack_into(leaf, buf, full)

    # ---- stage 3: the persistent shards --------------------------------------
    def persistent_leaf(self, name):
        """True when the stage-3 persistent shard of ``name`` is the
        optimizer leaf of the same name (not a flat int8 group's member)."""
        leaf = self.leaves.get(name)
        return (leaf is not None and not leaf.flat
                and leaf.dim == self.param_specs[name]
                and self.persist_shapes[name] == self.shapes[name])

    def persistent_matches_leaves(self):
        """True when every stage-3 persistent shard is the optimizer leaf
        of the same name (the layouts agree; not with flat int8 groups)."""
        return all(self.persistent_leaf(n) for n in self.param_specs)

    def gather_full(self, name, shard):
        """The full tensor of persistent shard ``shard`` (a new tensor)."""
        d = self.param_specs[name]
        if d is None:
            return shard
        shard = shard.detach()
        buf = torch.empty(shard.numel() * self.dp, dtype=shard.dtype,
                          device=shard.device)
        dist_lib.all_gather(buf, shard.reshape(-1).contiguous(), self.group)
        return from_chunks(buf, self.persist_shapes[name], d)

    def persistent_shard(self, name, full):
        d = self.param_specs[name]
        if d is None:
            return full.detach().clone()
        return shard_of(full.detach(), d, self.dp, self.rank)

    # ---- the accounting of the stage-3 gauges ----------------------------------
    def zero3_bytes(self, itemsize):
        """``(resident, gather)``: the per-rank persistent parameter bytes
        and the all-gather bytes one window moves (forward + backward
        re-gather, ``(dp-1)/dp`` of each sharded tensor): the JAX
        engine's ``_zero3_account_bytes`` at ``itemsize`` bytes an
        element."""
        resident = gather = 0
        for name, s in self.persist_shapes.items():
            nbytes = math.prod(s) * itemsize
            if self.param_specs[name] is None:
                resident += nbytes
            else:
                resident += nbytes // self.dp
                gather += 2 * (nbytes * (self.dp - 1) // self.dp)
        return resident, gather
