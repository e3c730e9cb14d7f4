"""Checkpoint save/load with a crash-safe commit protocol, on one device
or across data-parallel ranks.

Port of deepspeed_tpu/runtime/checkpointing.py. The directory layout and
the role of each file are the JAX package's; the serializer is PyTorch's
own (``torch.save``, read back with ``torch.load(..., weights_only=True,
map_location="cpu")``), under upstream DeepSpeed's file names:

  <dir>/<tag>/mp_rank_00_model_states.pt   — the trainable parameters
      as the module holds them (``module``: the fp32 masters, the
      compute-dtype parameters of a compensated engine, or under
      optimizer offload the device's compute-dtype copies), the step
      counters, dp/mp world sizes
      and ZeRO stage, the loss scaler's state, the LR schedule's state,
      ``client_state`` and the engine's dropout-seed generator state
      (``rng_state``).
  <dir>/<tag>/zero_pp_rank_0_mp_rank_00optim_states.pt — the optimizer
      state: ``{"master": fp32 masters, "inner": step and moments}`` when
      the compute dtype is below fp32 or the masters are offloaded (a
      compensated engine's master is its parameters in float32, its
      codes in ``inner["comp"]``), the bare inner state otherwise (the
      module file then IS the master), with ``num_shards`` 1. Moments
      stored in int8 are ``{"q", "scale"}`` dicts, one per parameter
      group. The canonical ``{master, inner}`` layout crosses layouts: a
      master in the file overrides the module file's weights, so an
      offload checkpoint resumes an on-device engine exactly and the
      other way round.
  <dir>/<tag>/MANIFEST.json — per-file sha256 commit record
      (resilience/manifest.py; absent on saves with resilience off).
  <dir>/latest              — tag pointer.

Commit protocol (resilience/, docs/resilience.md): every file is written
tmp + fsync + ``os.replace`` under the ``checkpoint.write`` fault site
and the retry loop; ``MANIFEST.json`` is written last and re-verified,
and only then is ``latest`` published; retention GC runs after the
publish. A kill at any instant leaves the previous checkpoint or a
complete new one.

Loads are transactional: every file is read, parsed and checked against
the engine on the host before one engine field changes. A
``latest``-driven load walks back to the newest valid tag; an explicit
tag never substitutes another. The restore copies into the engine's
existing tensors (``copy_``): the engine updates its parameters and
moments in place, FusedLamb's device tables are keyed by their
addresses, so a resume builds no new table, and an offload engine's
state stays in its pinned host buffers (its device parameters are then
published from the restored masters).

A checkpoint is untrusted input: ``weights_only`` loading takes tensors,
primitives and containers of them only, and ``save_checkpoint`` refuses a
``client_state`` that holds anything else.

Under tensor parallelism checkpoints keep the global form the JAX
engine writes, independent of the layout: the model file holds every
tensor joined over the model group in the JAX package's element order
(parallel/tensor.py undoes the strided qkv slice), and records
``mp_world_size``; each model rank ``m`` writes
``zero_pp_rank_<r>_mp_rank_<m>optim_states.pt`` with each leaf's model
dim, and a load joins the model ranks' states into the global one before
it cuts this engine's model shards, then its data shards, from it. So a
checkpoint saved at one data x model layout loads at any other. The tag
agreement, the barrier and the commit outcome span every rank. The ranks
of a sequence line hold the same state, so only the line's first writes
(the files are those of the layout without the sequence axis, and load
at any sequence size).

Across data-parallel ranks at ZeRO stage >= 1 (runtime/zero.py) every
rank writes its own ``zero_pp_rank_<r>_mp_rank_00optim_states.pt``: its
shards of the canonical ``{"master", "inner"}`` state, with
``num_shards`` and the layout that cut them (``layout``: each leaf's
shard dim, or the members and padded size of a flat int8 group). Rank 0
writes the model file (the full parameters: at stage 3 gathered from the
shards). A barrier comes before the manifest, which rank 0 writes over
every file; then rank 0's outcome (published, or the error its
verification or publish raised) is all-reduced, so every rank returns or
raises alike. A load first has the ranks agree on the tag they staged
(else every rank loads nothing). A load merges
every saved shard into the canonical layout of one rank (the state a
dp = 1 engine holds) and cuts this engine's shards from it, so a
checkpoint saved at one data-parallel size loads at any other, and
master and non-master layouts cross.

MoE experts and pipeline stages keep the global form too (the JAX
engine's pipelined tree equals its scanned one): before a save, every
tensor keyed by an expert leaf's name is joined over the data group along
its expert dim, and every pipe rank's part of each tree (its stage's
blocks) is gathered onto the pipe line's first rank, which alone writes
(the files are those of the layout without the pipe axis, the expert
leaves whole in each shard file). A load keeps this rank's experts and
its stage's blocks of the global state, so a checkpoint saved at one
expert-data or pipe size loads at any other.

int8 moments whose JAX leaf spans ranks (a stage's layers, a data rank's
experts: the engine's block maps) save the whole JAX leaf, joined from
every rank's runs, and a load cuts this rank's runs from it. Over ZeRO
shards such an engine writes the files of ZeRO stage 0's layout (one
optimizer file, its data group's first rank's; :func:`_file_layout` says
why), each leaf joined over the data group one at a time.
"""

import dataclasses
import hashlib
import io
import logging
import os
import time

import math

import torch

from ..ops import quant
from ..ops.optimizers import jax_element_order
from ..resilience import atomic_io
from ..resilience import manifest as manifest_lib
from ..resilience import retention
from ..resilience.manager import ResilienceManager
from ..parallel import tensor as tp_lib
from ..utils.logging import log_dist, warn_once
from . import dist as dist_lib
from .zero import from_chunks, shard_of

MODEL_FILE = "mp_rank_{mp:02d}_model_states.pt"
OPTIM_FILE = "zero_pp_rank_{dp}_mp_rank_{mp:02d}optim_states.pt"
LATEST_FILE = "latest"

# engines without a resilience manager (bare test doubles, the serving
# path without one) share one default-policy manager
_default_manager = None


def _resilience_of(engine):
    global _default_manager
    manager = getattr(engine, "resilience", None)
    if manager is not None:
        return manager
    if _default_manager is None:
        _default_manager = ResilienceManager()
    return _default_manager


def _write_blob(res, path, data):
    """One checkpoint file write under the active protocol: atomic +
    fsynced + retried when resilience is enabled, the bare write
    otherwise. The ``checkpoint.write`` fault site fires INSIDE the
    retried operation."""
    def op():
        res.faults.maybe_raise("checkpoint.write")
        atomic_io.atomic_write_bytes(path, data, fsync=res.fsync)

    if res.enabled:
        res.retrying(op, op_name=f"write:{os.path.basename(path)}")
    else:
        res.faults.maybe_raise("checkpoint.write")
        with open(path, "wb") as f:
            f.write(data)


def _read_blob(res, path):
    def op():
        res.faults.maybe_raise("checkpoint.read")
        return atomic_io.read_bytes(path)

    if res.enabled:
        return res.retrying(op, op_name=f"read:{os.path.basename(path)}")
    res.faults.maybe_raise("checkpoint.read")
    with open(path, "rb") as f:
        return f.read()


def _serialize(obj):
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _deserialize(blob):
    """Parse one checkpoint file: tensors, primitives and containers only
    (``weights_only``), every tensor on the host."""
    return torch.load(io.BytesIO(blob), weights_only=True,
                      map_location="cpu")


_PRIMITIVES = (type(None), bool, int, float, str)


def check_client_state(value, where="client_state"):
    """Refuse, at save, what a ``weights_only`` load would refuse (and
    what the JAX package's msgpack would not carry): anything but tensors,
    primitives, and dicts with string keys, lists and tuples of them."""
    if isinstance(value, _PRIMITIVES) or isinstance(value, torch.Tensor):
        return
    if isinstance(value, dict):
        for k, v in value.items():
            if not isinstance(k, str):
                raise TypeError(
                    f"{where}: key {k!r} is not a string; a checkpoint's "
                    "client_state maps strings to tensors and primitives"
                )
            check_client_state(v, f"{where}[{k!r}]")
        return
    if isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            check_client_state(v, f"{where}[{i}]")
        return
    raise TypeError(
        f"{where} is a {type(value).__name__}: a checkpoint's client_state "
        "holds only tensors, None/bool/int/float/str and dicts, lists and "
        "tuples of them (convert numpy arrays with torch.from_numpy)"
    )


def _host(t):
    """A tensor's values on the host, detached from the engine's storage
    (the engine keeps updating its tensors in place)."""
    t = t.detach()
    return t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()


def _host_tree(tree):
    if isinstance(tree, torch.Tensor):
        return _host(tree)
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree


def _module_params(engine):
    """The parameters the module file holds (see the module docstring)."""
    return getattr(engine, "module_params", engine.params)


def _layout(engine):
    """The engine's ZeRO layout when its optimizer steps shards, else
    None (one rank, or stage 0)."""
    zero = getattr(engine, "_zero", None)
    return zero if zero is not None and zero.sharded else None


def _file_layout(engine):
    """The layout the optimizer files are cut by: the ZeRO layout, but
    None for an engine whose int8 leaves span ranks, which writes one
    rank's state (:func:`_one_rank_opt_state`). A shard file holds each
    leaf's block range of one flat order, which a load joins by
    concatenating the ranks' ranges, and a pipe line's first rank writes
    its stages' leaves united by parameter name. A stage's int8 group is
    one leaf named by its group on every stage, each its share of that
    stage's runs: the stages' leaves would meet under one name, and their
    ranges are not ranges of one flat order (a block two stages share is
    in both)."""
    return None if getattr(engine, "_quant_maps", None) else _layout(engine)


def _leaf_names(engine):
    """The names of the optimizer's leaves (the masters', held or cut
    from the stage-3 shards)."""
    zero = getattr(engine, "_zero", None)
    return list(zero.leaves) if zero is not None else list(engine.params)


def _host_masters(engine):
    """The float32 masters on the host, one leaf at a time (a leaf cut
    from the stage-3 shards is a collective of the data group)."""
    leaf = getattr(engine, "_master_leaf", engine.params.__getitem__)
    return {n: _host(leaf(n)).float() for n in _leaf_names(engine)}


def _model_dims(engine):
    """``{name: model dim}`` of the module's tensors (empty when the
    engine holds no model shards)."""
    return getattr(engine, "_model_dims", None) or {}


def _world(engine):
    """``(size, group)`` of every rank of the engine's mesh."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        dp = int(getattr(engine, "dp_world_size", 1))
        return dp, getattr(engine, "_dp_group", None)
    return mesh.topology.world_size, mesh.world_group


def _param_keyed(engine, tree):
    """Whether ``tree`` is a dict keyed by (global) parameter names."""
    names = getattr(engine, "_global_names", None)
    return (isinstance(tree, dict) and bool(tree) and names is not None
            and set(tree) <= set(names))


def _global_tree(engine, tree):
    """A tree of this engine's layout -> the global form (a collective of
    the data group with MoE experts, of the pipe group with stages):
    expert tensors joined along dim 0 over the data group, then every
    stage's entries gathered (on the host) and merged."""
    experts = getattr(engine, "_expert_names", frozenset())
    pipe = getattr(engine, "_pipe", None)
    if experts:
        tree = _join_experts(engine, tree, experts)
    if pipe is None:
        return tree
    import torch.distributed as dist

    parts = [None] * pipe.size
    dist.all_gather_object(parts, _host_tree(tree), group=pipe.group)
    return _merge_stages(engine, parts)


def _join_experts(engine, tree, experts):
    if _param_keyed(engine, tree):
        out = {}
        for k, v in tree.items():
            if k in experts and isinstance(v, torch.Tensor):
                # on the engine's device (NCCL gathers device memory)
                home = v.device
                v = v.detach().to(engine.device).contiguous()
                buf = torch.empty((engine.dp_world_size,) + tuple(v.shape),
                                  dtype=v.dtype, device=v.device)
                dist_lib.all_gather(buf.view(-1), v.view(-1),
                                    engine._dp_group)
                v = buf.reshape((-1,) + tuple(v.shape[1:])).to(home)
            out[k] = v
        return out
    if isinstance(tree, dict):
        return {k: _join_experts(engine, v, experts) for k, v in tree.items()}
    return tree


def _merge_stages(engine, parts):
    """Every stage's tree -> one: parameter-keyed dicts united in the
    global names' order, anything else stage 0's."""
    first = parts[0]
    if _param_keyed(engine, first):
        joined = {}
        for p in parts:
            joined.update(p)
        return {n: joined[n] for n in engine._global_names if n in joined}
    if isinstance(first, dict):
        return {k: _merge_stages(engine, [p[k] for p in parts])
                for k in first}
    return first


def _stage_local(engine, tree):
    """A global tree cut to this rank's experts (dim 0 of each expert
    tensor) and its stage's entries."""
    experts = getattr(engine, "_expert_names", frozenset())
    pipe = getattr(engine, "_pipe", None)
    if not experts and pipe is None:
        return tree
    if _param_keyed(engine, tree):
        local = {n for n, _ in engine.module.named_parameters()}
        out = {}
        for k, v in tree.items():
            if k not in local:
                continue  # another stage's
            if k in experts and isinstance(v, torch.Tensor):
                n = v.shape[0] // engine.dp_world_size
                v = v[engine.data_rank * n:(engine.data_rank + 1) * n]
            out[k] = v
        return out
    if isinstance(tree, dict):
        return {k: _stage_local(engine, v) for k, v in tree.items()}
    return tree


def _full_module_params(engine):
    """The module file's parameters in full: at stage 3 gathered from
    every rank's shards, joined over the model group, the experts over
    the data group and the stages over the pipe group (a collective:
    every rank calls it)."""
    params = _module_params(engine)
    zero = _layout(engine)
    if zero is not None and zero.stage >= 3:
        params = {n: zero.gather_full(n, p) for n, p in params.items()}
    dims = _model_dims(engine)
    if dims:
        tp = engine._tp
        params = {n: tp_lib.gather_shards(n, p, dims.get(n), tp)
                  for n, p in params.items()}
    return _global_tree(engine, params)


def _full_shapes(engine):
    """The global shapes of the module's tensors."""
    zero = getattr(engine, "_zero", None)
    if zero is not None and zero.stage >= 3:
        shapes = dict(zero.persist_shapes)
    else:
        shapes = {n: tuple(p.shape)
                  for n, p in _module_params(engine).items()}
    mp = int(getattr(engine, "mp_world_size", 1))
    for n, d in _model_dims(engine).items():
        if d is not None and n in shapes:
            s = list(shapes[n])
            s[d] *= mp
            shapes[n] = tuple(s)
    return shapes


def _model_local(engine, tree, module=False):
    """A canonical (global) tree cut to this engine's model shards: the
    tensors of dicts keyed by parameter names, by their model dims (the
    module's with ``module``, else the optimizer's leaves'; a leaf the
    optimizer steps whole stays whole)."""
    tree = _stage_local(engine, tree)
    dims = _model_dims(engine)
    if not dims or not isinstance(tree, dict):
        return tree
    if tree and all(k in dims for k in tree):
        mp, rank = engine.mp_world_size, engine.model_rank
        out = {}
        for k, v in tree.items():
            d = dims[k] if module else engine._opt_model_dim(k)
            out[k] = (tp_lib.shard_for_rank(k, v, d, mp, rank).contiguous()
                      if isinstance(v, torch.Tensor) else v)
        return out
    return {k: _model_local(engine, v, module) for k, v in tree.items()}


def _join_model_tree(dims, vals):
    """Every model rank's copy of one canonical (sub)tree -> the global
    tree: tensors of dicts keyed by parameter names joined along their
    model dim (-1: whole on every rank, model rank 0's), anything else
    model rank 0's."""
    first = vals[0]
    if isinstance(first, dict) and first and all(k in dims for k in first):
        return {k: (tp_lib.join_shards(k, [v[k] for v in vals], dims[k])
                    if dims[k] >= 0 and isinstance(first[k], torch.Tensor)
                    else first[k])
                for k in first}
    if isinstance(first, dict):
        return {k: _join_model_tree(dims, [v[k] for v in vals])
                for k in first}
    return first


def _describe(zero):
    """The layout an optimizer shard file records (primitives only)."""
    return {name: {"dim": -1 if leaf.dim is None else int(leaf.dim),
                   "pad_to": int(leaf.pad_to),
                   "members": [[n, list(shape)] for n, shape in leaf.members]}
            for name, leaf in zero.leaves.items()}


def _is_quantized(v):
    return isinstance(v, dict) and set(v) == {"q", "scale"}


def _member_from_flat(name, shape, flat):
    """Tensor ``name`` of ``shape`` from its part of a flat group (JAX
    element order)."""
    like = jax_element_order(name, torch.empty(shape, device="meta"))
    t = flat.reshape(like.shape)
    return jax_element_order(name, t).contiguous()


def _merge_leaf(name, info, vals):
    """One leaf-keyed entry of every rank's shard -> its canonical
    entries (one per parameter; a quantized group keeps its group key,
    trimmed to one rank's block count)."""
    members = [(n, tuple(shape)) for n, shape in info["members"]]
    if _is_quantized(vals[0]):
        total = sum(math.prod(s) for _, s in members)
        nb = max(1, math.ceil(total / quant.BLOCK))
        return {name: {
            "q": torch.cat([v["q"] for v in vals])[:nb * quant.BLOCK],
            "scale": torch.cat([v["scale"] for v in vals])[:nb]}}
    if info["pad_to"]:
        flat = torch.cat([v.reshape(-1) for v in vals])
        out, off = {}, 0
        for n, shape in members:
            k = math.prod(shape)
            out[n] = _member_from_flat(n, shape, flat[off:off + k])
            off += k
        return out
    if info["dim"] < 0:
        return {name: vals[0]}
    (n, shape), = members
    return {name: from_chunks(torch.cat([v.reshape(-1) for v in vals]),
                              shape, info["dim"]).contiguous()}


def _merge_tree(layout, vals):
    """Every rank's copy of one state (sub)tree -> the canonical tree:
    dicts keyed by leaf names are merged leaf by leaf, anything else is
    rank 0's."""
    first = vals[0]
    if isinstance(first, dict) and first and set(first) <= set(layout):
        out = {}
        for name in first:
            out.update(_merge_leaf(name, layout[name],
                                   [v[name] for v in vals]))
        return out
    if isinstance(first, dict):
        return {k: _merge_tree(layout, [v[k] for v in vals]) for k in first}
    return first


def _merge_shards(payloads):
    """The optimizer files of every rank -> one canonical payload."""
    layout = payloads[0]["layout"]
    states = [p["optimizer_state"] for p in payloads]
    return {"num_shards": 1,
            "optimizer_state": {
                "master": _merge_tree(layout, [s["master"] for s in states]),
                "inner": _merge_tree(layout, [s["inner"] for s in states])}}


def _shard_leaf(zero, name, canonical, template):
    """This rank's shard of leaf ``name`` from the canonical entries."""
    leaf = zero.leaves.get(name)
    if _is_quantized(template) and (leaf is None or leaf.runs is not None):
        # a group that spans ranks: this rank's runs (_local_int8_moments)
        return canonical[name]
    if _is_quantized(template):
        c = canonical[name]
        q = torch.zeros(leaf.pad_to, dtype=c["q"].dtype)
        q[:c["q"].numel()] = c["q"]
        sc = torch.zeros(leaf.pad_to // quant.BLOCK, dtype=c["scale"].dtype)
        sc[:c["scale"].numel()] = c["scale"]
        e = leaf.numel
        return {"q": q[zero.rank * e:(zero.rank + 1) * e].clone(),
                "scale": sc[zero.rank * e // quant.BLOCK:
                            (zero.rank + 1) * e // quant.BLOCK].clone()}
    if leaf.flat:
        buf = zero._pack(leaf, canonical)
        return buf.reshape(zero.dp, -1)[zero.rank].clone()
    if leaf.replicated:
        return canonical[name]
    return shard_of(canonical[name], leaf.dim, zero.dp, zero.rank)


def _reshard_tree(zero, canonical, template, groups=()):
    """The canonical tree cut to this rank's shards, in the shape of the
    engine's ``template`` (``groups``: the int8 groups whose leaves span
    ranks, keys of a first moment beside the leaves')."""
    if (isinstance(template, dict) and template
            and set(template) <= set(zero.leaves) | set(groups)):
        return {n: _shard_leaf(zero, n, canonical, t)
                for n, t in template.items()}
    if isinstance(template, dict):
        return {k: _reshard_tree(zero, canonical[k], t, groups)
                for k, t in template.items()}
    return canonical


def _data_joined(engine, t):
    """This data rank's block range ``t`` of a flat leaf joined with every
    data rank's (a collective of the data group), on the host."""
    v = t.detach().to(engine.device).contiguous()
    buf = torch.empty(engine.dp_world_size * v.numel(), dtype=v.dtype,
                      device=v.device)
    dist_lib.all_gather(buf, v, engine._dp_group)
    return buf.cpu()


def whole_int8_moments(engine, mu):
    """``mu`` (an int8 first moment keyed by group, on the host) as the
    whole JAX leaves, the ones a single rank holds: a group that spans
    ranks (the engine's ``_quant_maps``: a stage's layers, a data rank's
    experts) joined from every rank's runs (a collective of the world),
    and over ZeRO shards every other group's block ranges joined over the
    data group (a collective of the data group), trimmed to the leaf's
    blocks."""
    maps = getattr(engine, "_quant_maps", None) or {}
    zero = _layout(engine)
    out = dict(mu)
    for g, leaf in (zero.leaves.items() if zero is not None else ()):
        if g in maps or not leaf.flat:
            continue
        total = sum(math.prod(s) for _, s in leaf.members)
        nb = max(1, math.ceil(total / quant.BLOCK))
        out[g] = {k: _data_joined(engine, mu[g][k])[:n]
                  for k, n in (("q", nb * quant.BLOCK), ("scale", nb))}
    if not maps:
        return out
    import torch.distributed as dist

    mine = {g: maps[g].to_pieces(mu[g]) for g in maps}
    world, group = _world(engine)
    parts = [None] * world
    dist.all_gather_object(parts, mine, group=group)
    for g, bmap in maps.items():
        out[g] = quant.whole_from_pieces(bmap.total, [p[g] for p in parts])
    return out


def _one_rank_opt_state(engine):
    """The optimizer file's payload of an engine over ZeRO shards whose
    int8 leaves span ranks, as one rank of its stage (or its data rank's
    experts) at ZeRO stage 0 holds it (:func:`_canonical_opt_state`'s
    form): the int8 first moment as the whole JAX leaves, every other
    leaf joined over the data group into its tensors one leaf at a time,
    on the host of the data group's first rank, which writes (the other
    ranks take part in the collectives and keep only their experts, which
    the experts' join reads)."""
    zero = engine._zero
    keep = engine.data_rank == 0

    def joined(leaf_of):
        out = {}
        for name, leaf in zero.leaves.items():
            src = leaf_of(name)
            full = {n: torch.empty(s, dtype=src.dtype, device=src.device)
                    for n, s in leaf.members}
            zero.gather_into({name: src}, full, names=(name,))
            if keep or leaf.local:
                out.update(_host_tree(full))
            del full
        return out

    inner = {}
    for k, v in engine.optimizer_state.items():
        if k == "mu":
            inner[k] = whole_int8_moments(engine, _host_tree(v))
        elif isinstance(v, dict) and v and set(v) <= set(zero.leaves):
            inner[k] = joined(v.__getitem__)
        else:
            inner[k] = _host_tree(v)
    if engine.compute_dtype == torch.float32:
        return inner  # the module file is the master
    master = joined(engine._master_leaf)
    return {"master": {n: t.float() for n, t in master.items()},
            "inner": inner}


def _local_int8_moments(engine, inner):
    """A canonical inner state's whole int8 leaves cut to this rank's part
    of each group that spans ranks (:func:`whole_int8_moments`'s
    inverse)."""
    maps = getattr(engine, "_quant_maps", None)
    if not maps or not isinstance(inner, dict) or "mu" not in inner:
        return inner
    mu = dict(inner["mu"])
    for g, bmap in maps.items():
        mu[g] = bmap.from_whole(mu[g])
    return dict(inner, mu=mu)


def _canonical_opt_state(engine):
    """The optimizer file's payload: ``{"master", "inner"}`` when the fp32
    masters differ from what the module computes with (or are this rank's
    shards), the bare inner state for an fp32 engine without offload (its
    module file is the master). An int8 group that spans ranks is the
    whole JAX leaf (:func:`whole_int8_moments`); over ZeRO shards the
    whole state is one rank's then (:func:`_one_rank_opt_state`)."""
    if getattr(engine, "_quant_maps", None) and _layout(engine) is not None:
        return _one_rank_opt_state(engine)
    inner = _host_tree(engine.optimizer_state)
    if getattr(engine, "_quant_maps", None):
        inner = dict(inner, mu=whole_int8_moments(engine, inner["mu"]))
    if (engine.compute_dtype == torch.float32
            and not getattr(engine, "host_offload", False)
            and _layout(engine) is None):
        return inner
    return {"master": _host_masters(engine), "inner": inner}


# rank 0's commit outcome, all-reduced to the other ranks at dp > 1
_COMMITTED = 0
_COMMIT_CORRUPT = 1  # the post-save verification failed
_COMMIT_IO = 2       # an I/O error outlasted its retries
_COMMIT_FAILED = 3   # anything else


def _commit(res, save_dir, ckpt_dir, tag, engine):
    """Rank 0's commit: the manifest over every file, its re-verification
    and the publish of ``latest``."""
    if not res.enabled:
        with open(os.path.join(save_dir, LATEST_FILE), "w") as f:
            f.write(str(tag))
        return
    # commit record LAST: hash the completed directory, publish the
    # manifest atomically, then re-verify the whole checkpoint from disk
    # before the tag becomes reachable
    manifest_lib.write_manifest(
        ckpt_dir, tag,
        meta={"global_steps": int(engine.global_steps),
              "mp_world_size": int(getattr(engine, "mp_world_size", 1))},
        fsync=res.fsync, retry=res.retry, on_retry=res.on_retry,
    )
    status, reason = manifest_lib.verify_checkpoint(ckpt_dir)
    if status != manifest_lib.VALID:
        raise manifest_lib.CheckpointCorruptionError(
            f"post-save verification of {ckpt_dir} failed "
            f"({reason}); 'latest' not published — the previous "
            "checkpoint remains the resume point"
        )
    res.retrying(
        lambda: atomic_io.atomic_write_text(
            os.path.join(save_dir, LATEST_FILE), str(tag),
            fsync=res.fsync,
        ),
        op_name="publish_latest",
    )


def _share_commit_outcome(engine, group, outcome):
    """All-reduce rank 0's outcome (the others send 0) in place of a
    bare barrier; returns it on every rank."""
    t = torch.tensor([outcome], dtype=torch.int32, device=engine.device)
    dist_lib.all_reduce(t, group)
    return int(t.item())


def _raise_commit_outcome(outcome, ckpt_dir):
    """On a rank other than 0: raise what rank 0 raised, by class."""
    if outcome == _COMMITTED:
        return
    what = f"rank 0 failed to commit {ckpt_dir}; 'latest' not published"
    if outcome == _COMMIT_CORRUPT:
        raise manifest_lib.CheckpointCorruptionError(
            f"{what} (its post-save verification failed)")
    if outcome == _COMMIT_IO:
        raise OSError(f"{what} (an I/O error outlasted its retries)")
    raise RuntimeError(what)


def save_checkpoint(engine, save_dir, tag=None, client_state=None):
    """Write the model and optimizer files, then the manifest, re-verify
    it and publish ``latest``; retention GC last. Raises
    :class:`~deepspeed_tpu_torch.resilience.CheckpointCorruptionError`
    when the post-save verification fails (the tag is not published)."""
    res = _resilience_of(engine)
    started = time.monotonic()
    client_state = client_state or {}
    check_client_state(client_state)
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    mp_rank = int(getattr(engine, "model_rank", 0))
    mp = int(getattr(engine, "mp_world_size", 1))
    ckpt_dir = os.path.join(save_dir, str(tag))
    os.makedirs(ckpt_dir, exist_ok=True)
    zero = _file_layout(engine)
    dp = int(getattr(engine, "dp_world_size", 1))
    rank = int(getattr(engine, "data_rank", 0))
    world, group = _world(engine)
    # the ranks of a sequence line hold the same state: its first writes;
    # a pipe line's first writes its stages' gathered state
    writer = (int(getattr(engine, "seq_rank", 0)) == 0
              and int(getattr(engine, "pipe_rank", 0)) == 0)
    first = rank == 0 and mp_rank == 0 and writer

    # ---- model states file (rank 0) -----------------------------------
    scaler = engine.loss_scale_state
    sched = engine.lr_scheduler
    module = {n: _host(p) for n, p in _full_module_params(engine).items()}
    state = {
        "module": module,
        "global_steps": int(engine.global_steps),
        "skipped_steps": int(engine.skipped_steps),
        "micro_steps": int(engine.micro_steps),
        "dp_world_size": dp,
        "mp_world_size": mp,
        "zero_stage": int(engine.zero_stage),
        "loss_scaler": {
            "loss_scale": float(scaler.loss_scale),
            "good_steps": int(scaler.good_steps),
            "hysteresis": int(scaler.hysteresis),
        },
        "lr_scheduler": (
            sched.state_dict()
            if sched is not None and hasattr(sched, "state_dict") else None
        ),
        "client_state": client_state,
        # the dropout-seed generator: a resume (and a supervisor rollback)
        # draws the seeds the original run would have
        "rng_state": engine._rng.get_state(),
    }
    if first:
        # the global module: one model file, whatever the layout
        model_path = os.path.join(ckpt_dir, MODEL_FILE.format(mp=0))
        _write_blob(res, model_path, _serialize(state))
    del state, module

    # ---- optimizer state files: one per rank over shards, else one per
    # model rank; each with the model dims that join them
    model = {}
    if mp > 1:
        model = {"model_dims": {
            n: (-1 if engine._opt_model_dim(n) is None
                else int(engine._opt_model_dim(n)))
            for n in _leaf_names(engine)}}
    # a rank that writes an optimizer file, and every rank when the
    # experts' or the stages' gathers make the file a collective
    writes = writer and (zero is not None or rank == 0)
    if writes or getattr(engine, "_expert_names", None) or (
            getattr(engine, "_pipe", None) is not None):
        payload = {"num_shards": 1, "optimizer_state": _global_tree(
            engine, _canonical_opt_state(engine)), **model}
        if zero is not None:
            payload.update(num_shards=dp, rank=rank,
                           layout=_global_tree(engine, _describe(zero)))
        if writes:
            optim_path = os.path.join(ckpt_dir, OPTIM_FILE.format(
                dp=rank if zero is not None else 0, mp=mp_rank))
            _write_blob(res, optim_path, _serialize(payload))
        del payload
    if world > 1:
        # every rank's file is written before the manifest covers them
        dist_lib.barrier(group)
    if not first:
        # rank 0 commits; the others wait for its outcome and fail alike
        _raise_commit_outcome(_share_commit_outcome(engine, group, 0),
                              ckpt_dir)
        res.observe_save(started)
        return True

    outcome = _COMMIT_FAILED
    try:
        _commit(res, save_dir, ckpt_dir, tag, engine)
        outcome = _COMMITTED
    except manifest_lib.CheckpointCorruptionError:
        outcome = _COMMIT_CORRUPT
        raise
    except OSError:
        outcome = _COMMIT_IO
        raise
    finally:
        # reached even when the commit raises, so no rank is left waiting
        if world > 1:
            _share_commit_outcome(engine, group, outcome)
    if res.enabled and res.keep_last_n > 0:
        retention.prune_checkpoints(
            save_dir, res.keep_last_n, protect={str(tag)},
            on_delete=res.count_pruned,
        )
    res.observe_save(started)
    log_dist(f"Saved checkpoint {tag} to {save_dir}", ranks=[0])
    return True


# ---------------------------------------------------------------------------
# load: stage (parse everything on host) -> check -> apply (mutate)
# ---------------------------------------------------------------------------
class _Staged:
    """Host-side parse of one checkpoint candidate: nothing here has
    touched the engine yet."""

    __slots__ = ("tag", "ckpt_dir", "state", "shards")

    def __init__(self, tag, ckpt_dir, state, shards):
        self.tag = tag
        self.ckpt_dir = ckpt_dir
        self.state = state
        self.shards = shards  # list of optimizer payloads, or None


def _stage_checkpoint(load_dir, tag, load_optimizer_states, res):
    """Read and parse EVERY file of checkpoint ``tag`` into host memory.
    Raises on any verification, read or parse failure; the engine is
    untouched either way."""
    ckpt_dir = os.path.join(load_dir, str(tag))
    if res.enabled and res.verify_on_load:
        status, reason = manifest_lib.verify_checkpoint(ckpt_dir)
        if status in (manifest_lib.CORRUPT, manifest_lib.MISSING):
            raise manifest_lib.CheckpointCorruptionError(
                f"checkpoint {tag}: {reason}"
            )
        if status == manifest_lib.LEGACY:
            warn_once(
                ("legacy-checkpoint", ckpt_dir),
                "checkpoint %s has no manifest (saved with resilience "
                "off); loading with parse-time validation only", ckpt_dir,
            )
    model_path = os.path.join(ckpt_dir, MODEL_FILE.format(mp=0))
    if not os.path.exists(model_path):
        raise manifest_lib.CheckpointCorruptionError(
            f"checkpoint {tag}: model-states file {model_path} not found"
        )
    state = _deserialize(_read_blob(res, model_path))
    if not isinstance(state, dict) or not isinstance(
        state.get("module"), dict
    ):
        raise manifest_lib.CheckpointCorruptionError(
            f"checkpoint {tag}: {model_path} holds no module state dict"
        )

    shards = None
    if load_optimizer_states:
        saved_dp = (
            int(state["dp_world_size"]) if state["zero_stage"] >= 1 else 1
        )
        saved_mp = int(state.get("mp_world_size", 1))
        per_model = []
        for mp_rank in range(saved_mp):
            merged = _stage_model_rank(ckpt_dir, tag, saved_dp, mp_rank, res)
            if merged is None:
                break
            per_model.append(merged)
        if per_model:
            if len(per_model) < saved_mp:
                raise manifest_lib.CheckpointCorruptionError(
                    f"checkpoint {tag}: {saved_mp} model ranks saved but "
                    f"only {len(per_model)} have optimizer files"
                )
            if saved_mp > 1:
                # every model rank's state joined into the global one; the
                # engine cuts its own shards from it at apply time
                dims = per_model[0][1]
                per_model = [({"num_shards": 1, "optimizer_state":
                               _join_model_tree(dims, [
                                   p["optimizer_state"]
                                   for p, _ in per_model])}, dims)]
            shards = [per_model[0][0]]
    return _Staged(str(tag), ckpt_dir, state, shards)


def _stage_model_rank(ckpt_dir, tag, saved_dp, mp_rank, res):
    """Model rank ``mp_rank``'s optimizer files merged over the data
    ranks: ``(payload, model dims)``, or None when it has none."""
    rank0_path = os.path.join(ckpt_dir, OPTIM_FILE.format(dp=0, mp=mp_rank))
    if not os.path.exists(rank0_path):
        return None
    shards = []
    for rank in range(saved_dp):
        p = os.path.join(ckpt_dir, OPTIM_FILE.format(dp=rank, mp=mp_rank))
        if not os.path.exists(p):
            break
        shards.append(_deserialize(_read_blob(res, p)))
    num_shards = int(shards[0]["num_shards"])
    if len(shards) < num_shards:
        raise manifest_lib.CheckpointCorruptionError(
            f"checkpoint {tag}: optimizer state declares "
            f"{num_shards} shard files but only {len(shards)} "
            "are present"
        )
    dims = shards[0].get("model_dims", {})
    if num_shards > 1:
        # every rank's shards merged into one rank's layout; the
        # engine cuts its own shards from it at apply time
        return _merge_shards(shards[:num_shards]), dims
    return shards[0], dims


def _check_tree(saved, current, where):
    """Raise unless ``saved`` has ``current``'s keys and every tensor its
    shape (dtypes are cast on copy)."""
    if isinstance(current, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: expected a tensor, found "
                             f"{type(saved).__name__}")
        if tuple(saved.shape) != tuple(current.shape):
            raise ValueError(f"{where}: shape {tuple(saved.shape)} != the "
                             f"engine's {tuple(current.shape)}")
        return
    if isinstance(current, dict):
        if not isinstance(saved, dict) or set(saved) != set(current):
            raise ValueError(
                f"{where}: keys differ from the engine's (missing "
                f"{sorted(set(current) - set(saved or {}))[:5]}, extra "
                f"{sorted(set(saved or {}) - set(current))[:5]})"
            )
        for k in current:
            _check_tree(saved[k], current[k], f"{where}[{k!r}]")


def _split_optimizer_payload(staged):
    """``(master or None, inner)`` of the staged optimizer file."""
    opt = staged.shards[0]["optimizer_state"]
    if isinstance(opt, dict) and set(opt) == {"master", "inner"}:
        return opt["master"], opt["inner"]
    return None, opt


def _resharded(engine, staged, load_optimizer_states):
    """``(master, inner)`` of the staged (canonical) checkpoint in the
    engine's layout: as saved on one rank, or cut to this rank's shards
    (the master from the module file when the file has none). ``(None,
    None)`` without optimizer state to load."""
    if not (load_optimizer_states and staged.shards):
        return None, None
    master, inner = _split_optimizer_payload(staged)
    master = _model_local(engine, master)
    inner = _local_int8_moments(engine, _model_local(engine, inner))
    zero = _layout(engine)
    if zero is None:
        return master, inner
    if master is None:
        master = _model_local(engine, {
            n: t.float() for n, t in staged.state["module"].items()})
    return (_reshard_tree(zero, master, engine.params),
            _reshard_tree(zero, inner, engine.optimizer_state,
                          getattr(engine, "_quant_maps", None) or ()))


def _check_compatible(engine, staged, load_optimizer_states):
    """Every shape and key of the staged checkpoint against the engine,
    before anything is applied."""
    module = _stage_local(engine, staged.state["module"])
    _check_tree(module, {n: torch.empty(s, device="meta")
                         for n, s in _full_shapes(engine).items()}, "module")
    master, inner = _resharded(engine, staged, load_optimizer_states)
    if inner is not None:
        if master is not None:
            _check_tree(master, dict(engine.params), "optimizer master")
        _check_tree(inner, engine.optimizer_state, "optimizer state")


@torch.no_grad()
def _copy_tree(dst, src):
    """Copy ``src`` into ``dst`` in place: tensors by ``copy_``, other
    leaves (the step count) by assignment into the same dict."""
    for k, cur in dst.items():
        new = src[k]
        if isinstance(cur, torch.Tensor):
            cur.copy_(new)
        elif isinstance(cur, dict):
            _copy_tree(cur, new)
        else:
            dst[k] = new


def _apply_checkpoint(engine, staged, load_optimizer_states,
                      load_lr_scheduler_states):
    """Mutate the engine from a fully staged and checked checkpoint. No
    file I/O (and no torn-state abort path) exists past this point."""
    state = staged.state
    master, inner = _resharded(engine, staged, load_optimizer_states)
    if inner is not None:
        _copy_tree(engine.optimizer_state, inner)
    zero = _layout(engine)
    if zero is not None:
        # this rank's master shards, and the module's compute-dtype
        # parameters (stage 3: its persistent shards) from the full
        # masters of the canonical state
        full = None
        if load_optimizer_states and staged.shards:
            full = _split_optimizer_payload(staged)[0]
        if full is None:
            full = state["module"]
        if master is None:
            master = _reshard_tree(
                zero, _model_local(engine, {n: t.float()
                                            for n, t in full.items()}),
                engine.params)
        _copy_tree(engine.params, master)
        full = _model_local(engine, full, module=True)
        with torch.no_grad():
            for n, p in engine.module_params.items():
                p.copy_(full[n] if zero.stage < 3
                        else zero.persistent_shard(n, full[n]))
    else:
        # exact fp32 resume: the optimizer file's master, else the
        # module's (the same values; fp32 engines save no separate master)
        _copy_tree(engine.params, master if master is not None
                   else _model_local(engine, state["module"]))
        if getattr(engine, "_tp_full_opt", False):
            # the module's shards from the whole masters
            engine._publish_model_slices(engine.params)
    if getattr(engine, "host_offload", False):
        # the device's compute-dtype parameters from the restored masters
        engine.publish_params()
    engine.global_steps = int(state["global_steps"])
    engine.skipped_steps = int(state["skipped_steps"])
    engine.micro_steps = int(state["micro_steps"])
    sc = state["loss_scaler"]
    engine.loss_scale_state = dataclasses.replace(
        engine.loss_scale_state,
        loss_scale=float(sc["loss_scale"]),
        good_steps=int(sc["good_steps"]),
        hysteresis=int(sc["hysteresis"]),
    )
    if state.get("rng_state") is not None:
        engine._rng.set_state(state["rng_state"])
    if (
        load_lr_scheduler_states
        and state.get("lr_scheduler") is not None
        and engine.lr_scheduler is not None
        and hasattr(engine.lr_scheduler, "load_state_dict")
    ):
        engine.lr_scheduler.load_state_dict(state["lr_scheduler"])


def _stage_with_fallback(load_dir, tag, load_optimizer_states, res,
                         engine=None):
    """Resolve ``tag`` (None => the 'latest' pointer), walk candidates
    newest-first on corruption, and stage the first loadable one entirely
    on host. The shared verified-load front half of ``load_checkpoint``
    and ``load_module_state``. Returns a ``_Staged`` or None.

    Across ranks (``engine`` in a mesh of more than one rank) the ranks
    then compare what they staged: on a flaky shared mount they can see
    different corruption and fall back to different tags. Every rank
    gathers the first 8 bytes of each rank's tag's sha256 (a rank that
    staged nothing sends 0) and, if any differ, every rank logs the
    disagreement and returns None, as the JAX package does."""
    staged = _stage_walk(load_dir, tag, load_optimizer_states, res)
    world, group = (_world(engine) if engine is not None else (1, None))
    if world > 1:
        mine = 0
        if staged is not None:
            mine = int.from_bytes(
                hashlib.sha256(staged.tag.encode()).digest()[:8], "little",
                signed=True)
        everyone = torch.empty(world, dtype=torch.int64,
                               device=engine.device)
        dist_lib.all_gather(
            everyone, torch.tensor([mine], dtype=torch.int64,
                                   device=engine.device), group)
        if len(set(everyone.tolist())) > 1:
            log_dist(
                f"checkpoint tag disagreement across ranks (this rank "
                f"staged {staged.tag if staged is not None else 'nothing'} "
                f"from {load_dir}); failing the load on every rank — "
                "inspect the shared filesystem and retry",
                ranks=[-1], level=logging.ERROR,
            )
            return None
    return staged


def _stage_walk(load_dir, tag, load_optimizer_states, res):
    """One rank's candidate walk of :func:`_stage_with_fallback`."""
    explicit_tag = tag is not None
    if tag is None:
        latest = os.path.join(load_dir, LATEST_FILE)
        if not os.path.exists(latest):
            log_dist(f"No 'latest' file in {load_dir}", ranks=[0])
            return None
        if res.enabled:
            tag = res.retrying(
                lambda: atomic_io.read_text(latest), op_name="read:latest"
            ).strip()
        else:
            tag = atomic_io.read_text(latest).strip()

    # the requested tag first; for latest-driven loads with fallback
    # enabled, every other tag follows, newest first. An EXPLICITLY
    # requested tag never silently substitutes.
    candidates = [str(tag)]
    if not explicit_tag and res.enabled and res.fallback_on_corruption:
        candidates += [
            t for t in manifest_lib.ordered_tags(load_dir) if t != str(tag)
        ]

    staged = None
    for candidate in candidates:
        try:
            staged = _stage_checkpoint(
                load_dir, candidate, load_optimizer_states, res
            )
            break
        except Exception as e:
            level = (logging.ERROR if candidate == str(tag)
                     else logging.WARNING)
            log_dist(
                f"checkpoint {candidate} in {load_dir} is not loadable: {e}",
                ranks=[0], level=level,
            )
            res.count_corruption_fallback()
            continue
    if staged is None:
        log_dist(
            f"no loadable checkpoint found in {load_dir} "
            f"(tried {len(candidates)} candidate tag(s))",
            ranks=[0], level=logging.ERROR,
        )
        return None
    if staged.tag != str(tag):
        log_dist(
            f"FALLBACK: checkpoint {tag} was corrupt/missing; resuming "
            f"from newest valid tag {staged.tag}",
            ranks=[0], level=logging.WARNING,
        )
    return staged


def load_checkpoint(engine, load_dir, tag=None, load_optimizer_states=True,
                    load_lr_scheduler_states=True):
    """Restore the engine from ``load_dir`` (``tag`` or ``latest``).
    Returns ``(path, client_state)``, or ``(None, {})`` with the engine
    untouched when nothing is loadable. A checkpoint of another model
    (names or shapes that differ from the engine's) raises ValueError,
    with the engine untouched too."""
    res = _resilience_of(engine)
    started = time.monotonic()
    staged = _stage_with_fallback(load_dir, tag, load_optimizer_states, res,
                                  engine)
    if staged is None:
        return None, {}
    _check_compatible(engine, staged, load_optimizer_states)
    # everything parsed and checked; only now does the engine mutate
    _apply_checkpoint(engine, staged, load_optimizer_states,
                      load_lr_scheduler_states)
    res.observe_load(started)
    log_dist(f"Loaded checkpoint {staged.tag} from {load_dir}", ranks=[0])
    return (
        os.path.join(staged.ckpt_dir, ""),
        staged.state.get("client_state", {}),
    )


def load_module_state(load_dir, params_template, tag=None, resilience=None):
    """Verified MODEL-state load for serving: the same manifest verify,
    host-side parse and newest-valid fallback as ``load_checkpoint``, but
    only the model file is read and nothing mutates. The saved module
    state must have ``params_template``'s names (ValueError otherwise);
    shapes are the caller's to check. It returns as host tensors for the
    caller to cast and place.

    Returns ``(params, client_state, tag)``; ``(None, {}, None)`` when no
    loadable checkpoint exists."""
    res = resilience if resilience is not None else _resilience_of(None)
    started = time.monotonic()
    staged = _stage_with_fallback(load_dir, tag, False, res)
    if staged is None:
        return None, {}, None
    module = staged.state["module"]
    if set(module) != set(params_template):
        raise ValueError(
            f"checkpoint {staged.tag} in {load_dir}: its module state "
            f"names differ from the model's (missing "
            f"{sorted(set(params_template) - set(module))[:5]}, extra "
            f"{sorted(set(module) - set(params_template))[:5]})"
        )
    res.observe_load(started)
    log_dist(
        f"Loaded model state {staged.tag} from {load_dir} for inference",
        ranks=[0],
    )
    return dict(module), staged.state.get("client_state", {}), staged.tag
