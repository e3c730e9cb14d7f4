"""Sequence parallelism: ring attention and Ulysses all-to-all over the
sequence process group.

Port of deepspeed_tpu/parallel/sequence.py. The token dimension is cut
over the mesh's ``sequence`` axis: rank ``i`` of a sequence line holds
global positions ``[i*Sl, (i+1)*Sl)`` of its rows, and attention stays
exact through one of two decompositions:

  * **ring attention** (:func:`ring_attention_local`): K/V (and the key
    validity vector) move one hop along the ring, ``j -> j+1``, per step
    (``batch_isend_irecv``; sp - 1 hops), while each rank folds one
    [Sl, Sl] score block a step into a float32 online softmax over its
    local queries. Any head count; causal masking by global position; a
    per-key padding mask that travels with the K/V chunks. The score
    block is a plain product, as in the JAX package (an einsum there, no
    Pallas kernel), and each step is recomputed in the backward
    (``remat_steps``), so the memory a step keeps is one score block.
  * **Ulysses** (:func:`ulysses_attention_local`): one all-to-all
    (``all_to_all_single``) re-shards q, k and v from [B, H, Sl, D] to
    [B, H/sp, S, D], the port's attention dispatcher (ops/attention.py:
    on the card the flash forward, dQ and dK/dV kernels) runs on the
    whole sequence with a head subset, and a second all-to-all shards the
    context back. Needs ``H % sp == 0``.

The JAX package differentiates its scan and collectives by autodiff. Here
each collective that carries a gradient is an ``autograd.Function``: the
ring's hop sends the gradients of K and V back the other way (JAX's
transpose of ``ppermute``), and an all-to-all's backward is the inverse
all-to-all. K and V move in one hop, and q, k and v in one all-to-all,
so that every rank's backward issues the same collectives in the same
order.

The local forms take the rank's shards and a :class:`SequenceParallel`
(the rank's sequence line: its process group, size, index and the global
ranks of the line). The global forms (:func:`ring_attention`,
:func:`ulysses_attention`, :func:`sequence_parallel_attention`) take the
whole sequence on every rank of the line and a ``ProcessMesh`` (or a
line), cut this rank's chunk, and return the whole output on every rank
(its gradient whole on every rank too), as the JAX package's
``shard_map`` wrappers take and return global arrays. The data and model
axes are not cut there: in the port a rank's tensors already are its data
rows and its heads.

Two ranks that share one card talk over gloo, which sends and receives
only host memory: on a gloo group the hops and the all-to-alls stage CUDA
tensors through host copies.
"""

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.attention import NEG_INF, attention, dropout_keep_mask
from ..runtime import dist as dist_lib
from .mesh import SEQ_AXIS

#: The offset of a ring step's dropout seed per (rank, step) pair, so that
#: every score block of the ring draws its own mask.
RING_STEP_SEED_STRIDE = 1_000_003


@dataclasses.dataclass(frozen=True)
class SequenceParallel:
    """A rank's place on its sequence-axis line: the process ``group``,
    its ``size`` (sp), this rank's index ``rank`` in it and the global
    ``ranks`` of the line in sequence order."""

    group: object
    size: int
    rank: int
    ranks: tuple


def sequence_line(mesh):
    """The :class:`SequenceParallel` of ``mesh``'s sequence axis (a
    ``ProcessMesh``), None at a sequence axis of 1; a line is returned as
    it is."""
    if mesh is None or isinstance(mesh, SequenceParallel):
        return mesh
    if mesh.sp_size <= 1:
        return None
    return SequenceParallel(mesh.seq_group, mesh.sp_size, mesh.seq_rank,
                            mesh.line_ranks(SEQ_AXIS))


def _through_host(t, line):
    """Whether ``t`` goes through a host copy on ``line``'s group: gloo
    reads and writes host memory only."""
    return t.is_cuda and dist.get_backend(line.group) == "gloo"


def _shift(tensors, line, step):
    """Each of ``tensors`` sent ``step`` places along the ring (to index
    ``rank + step``) and the one from index ``rank - step`` received, in
    one batch of point-to-point operations, the ``i``-th tensor's pair
    under tag ``i`` (gloo matches a receive by peer and tag only)."""
    dst = line.ranks[(line.rank + step) % line.size]
    src = line.ranks[(line.rank - step) % line.size]
    ops, received = [], []
    for tag, t in enumerate(tensors):
        t = t.contiguous()
        send = t.cpu() if _through_host(t, line) else t
        recv = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, dst, line.group, tag))
        ops.append(dist.P2POp(dist.irecv, recv, src, line.group, tag))
        received.append((recv, t.device))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(r.to(device) for r, device in received)


class _RingHop(torch.autograd.Function):
    """K, V and the key validity one hop along the ring (``j -> j+1``);
    the backward sends K's and V's gradients the other way."""

    @staticmethod
    def forward(ctx, k, v, kv_valid, line):
        ctx.line = line
        k, v, kv_valid = _shift((k, v, kv_valid), line, 1)
        ctx.mark_non_differentiable(kv_valid)
        return k, v, kv_valid

    @staticmethod
    def backward(ctx, gk, gv, _):
        gk, gv = _shift((gk, gv), ctx.line, -1)
        return gk, gv, None, None


def _ring_step(q, k_c, v_c, kvv, m, l, acc, *, gq, gk, causal, sm_scale,
               have_valid, dropout_rate, step_seed):
    """One ring step: fold the score block of the K/V chunk at global
    key positions ``gk`` into the online softmax ``(m, l, acc)``."""
    s = torch.matmul(q.float(), k_c.float().transpose(-1, -2)) * sm_scale
    if causal:
        s = torch.where(gk[None, None, None, :] <= gq[None, None, :, None],
                        s, NEG_INF)
    if have_valid:
        s = torch.where(kvv[:, None, None, :] > 0, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    # zero masked entries: for an all-masked row m_new == NEG_INF and
    # exp(s - m_new) would be exp(0) = 1 everywhere
    p = torch.where(s > NEG_INF / 2, p, torch.zeros((), device=p.device))
    p_use = p
    if step_seed is not None:
        keep = dropout_keep_mask(step_seed, p.shape, dropout_rate, p.device)
        p_use = torch.where(keep, p / (1.0 - dropout_rate),
                            torch.zeros((), device=p.device))
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.matmul(
        p_use.to(v_c.dtype).float(), v_c.float())
    return m_new, l_new, acc_new


def ring_attention_local(q, k, v, kv_valid=None, *, line, causal=False,
                         sm_scale: Optional[float] = None,
                         dropout_rate=0.0, dropout_seed=None,
                         remat_steps=True):
    """Exact attention over a sequence-sharded [B, H, Sl, D] layout.

    Index ``i`` of ``line`` holds global positions ``[i*Sl, (i+1)*Sl)``
    of q, k, v and ``kv_valid`` [B, Sl] (nonzero = attend). At step ``t``
    it holds the K/V chunk of index ``(i - t) % sp``. The bookkeeping
    (``m``, ``l``, ``acc``) is float32; a fully masked row gives zeros;
    dropout (a ``dropout_seed`` and a rate above 0) drops the
    probabilities after the undropped normaliser, each (rank, step)
    block with a mask of its own (ops/attention.py's hash of the step's
    seed), so the masks differ from one device's at the same seed: the
    distribution is kept, not the bits. ``remat_steps`` recomputes each
    step in the backward."""
    B, H, Sl, D = q.shape
    sp, idx = line.size, line.rank
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    device = q.device
    gq = idx * Sl + torch.arange(Sl, device=device)
    have_valid = kv_valid is not None
    kvv = (kv_valid.to(torch.int32) if have_valid
           else torch.zeros((B, 1), dtype=torch.int32, device=device))
    use_dropout = dropout_rate > 0.0 and dropout_seed is not None
    m = torch.full((B, H, Sl), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((B, H, Sl), dtype=torch.float32, device=device)
    acc = torch.zeros((B, H, Sl, D), dtype=torch.float32, device=device)
    remat = remat_steps and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    k_c, v_c = k, v
    for t in range(sp):
        chunk = (idx - t) % sp
        step = functools.partial(
            _ring_step, gq=gq,
            gk=chunk * Sl + torch.arange(Sl, device=device), causal=causal,
            sm_scale=sm_scale, have_valid=have_valid,
            dropout_rate=dropout_rate,
            step_seed=((int(dropout_seed) + (idx * sp + t + 1)
                        * RING_STEP_SEED_STRIDE) % (2**31 - 1)
                       if use_dropout else None))
        if remat:
            from torch.utils.checkpoint import checkpoint

            m, l, acc = checkpoint(step, q, k_c, v_c, kvv, m, l, acc,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            m, l, acc = step(q, k_c, v_c, kvv, m, l, acc)
        if t < sp - 1:
            k_c, v_c, kvv = _RingHop.apply(k_c, v_c, kvv, line)
    l = torch.where(l == 0.0, torch.ones((), device=device), l)
    return (acc / l[..., None]).to(q.dtype)


def _exchange(chunks, line):
    """All-to-all over ``line``: ``chunks`` [sp, ...], chunk ``j`` to
    index ``j``; returns [sp, ...] with chunk ``j`` from index ``j``."""
    chunks = chunks.contiguous()
    if _through_host(chunks, line):
        host = chunks.cpu()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=line.group)
        return out.to(chunks.device)
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=line.group)
    return out


def _all_to_all(x, line, scatter, gather):
    """Cut dim ``scatter`` of ``x`` into sp chunks, send chunk ``j`` to
    index ``j``, and join the chunks received along dim ``gather`` in
    index order."""
    sp = line.size
    shape = list(x.shape)
    split = shape[:scatter] + [sp, shape[scatter] // sp] + shape[scatter + 1:]
    out = _exchange(x.reshape(split).movedim(scatter, 0), line)
    out = out.movedim(0, gather)
    joined = list(out.shape)
    joined[gather:gather + 2] = [joined[gather] * joined[gather + 1]]
    return out.reshape(joined)


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all`, differentiable: the backward is the inverse
    exchange (``scatter`` and ``gather`` swapped)."""

    @staticmethod
    def forward(ctx, x, line, scatter, gather):
        ctx.args = (line, scatter, gather)
        return _all_to_all(x, line, scatter, gather)

    @staticmethod
    def backward(ctx, g):
        line, scatter, gather = ctx.args
        return _all_to_all(g, line, gather, scatter), None, None, None


def _gather_valid(kv_valid, line):
    """Every index's [B, Sl] key validity joined in sequence order:
    [B, S] int32."""
    local = kv_valid.to(torch.int32).contiguous()
    flat = torch.empty(local.numel() * line.size, dtype=torch.int32,
                       device=local.device)
    dist_lib.all_gather(flat, local.reshape(-1), line.group)
    return flat.view(line.size, *local.shape).movedim(0, 1).reshape(
        local.shape[0], -1)


def ulysses_attention_local(q, k, v, kv_valid=None, *, line, causal=False,
                            sm_scale: Optional[float] = None,
                            dropout_rate=0.0, dropout_seed=None,
                            use_flash=True):
    """All-to-all sequence parallelism: [B, H, Sl, D] -> attention over
    the whole sequence with H/sp heads on each index -> shard back.
    Requires ``H % sp == 0``. The attention in between is the port's
    dispatcher (ops/attention.py) with the line's gathered key validity;
    its dropout draws from ``dropout_seed`` (each index owns other heads,
    so the caller's seed should differ per index)."""
    H = q.shape[1]
    sp = line.size
    if H % sp != 0:
        raise ValueError(f"ulysses needs heads % sp == 0, got H={H}, sp={sp}")
    qkv = _AllToAll.apply(torch.stack((q, k, v)), line, 2, 3)
    qg, kg, vg = qkv.unbind(0)
    mask = None
    if kv_valid is not None:
        full = _gather_valid(kv_valid, line)
        mask = torch.where(full > 0, 0.0, NEG_INF)[:, None, None, :].to(
            torch.float32)
    ctx = attention(qg, kg, vg, mask=mask, causal=causal, sm_scale=sm_scale,
                    dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                    use_flash=use_flash)
    return _AllToAll.apply(ctx, line, 2, 1)


def choose_impl(local_heads, sp, impl="auto"):
    """The decomposition ``impl`` names, with ``auto`` resolved: Ulysses
    when the rank's heads (global heads / the model axis) divide by sp
    (fewer collectives), else the ring."""
    if impl == "auto":
        return "ulysses" if local_heads % sp == 0 else "ring"
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel impl {impl!r}")
    return impl


def sequence_parallel_attention_local(q, k, v, kv_valid=None, *, line,
                                      impl="auto", use_flash=True, **kw):
    """The local form of :func:`sequence_parallel_attention`: 'ring' |
    'ulysses' | 'auto' (:func:`choose_impl` on ``q``'s heads, which are
    this rank's). ``use_flash`` affects Ulysses only."""
    impl = choose_impl(q.shape[1], line.size, impl)
    if impl == "ulysses":
        return ulysses_attention_local(q, k, v, kv_valid, line=line,
                                       use_flash=use_flash, **kw)
    return ring_attention_local(q, k, v, kv_valid, line=line, **kw)


# ---------------------------------------------------------------------------
# global forms: the whole sequence on every rank of the line
# ---------------------------------------------------------------------------
class _ScatterSeq(torch.autograd.Function):
    """This index's chunk of dim ``dim``; the backward gathers every
    index's chunk gradient, so the whole input's gradient is whole on
    every rank."""

    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.args = (line, dim)
        return x.chunk(line.size, dim)[line.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        line, dim = ctx.args
        return _gather_seq(g, line, dim), None, None


def _gather_seq(x, line, dim):
    x = x.contiguous()
    flat = torch.empty(x.numel() * line.size, dtype=x.dtype, device=x.device)
    dist_lib.all_gather(flat, x.reshape(-1), line.group)
    return torch.cat(list(flat.view(line.size, *x.shape)), dim=dim)


class _GatherSeq(torch.autograd.Function):
    """Every index's chunk joined along dim ``dim``; the backward keeps
    this index's chunk."""

    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.args = (line, dim)
        return _gather_seq(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        line, dim = ctx.args
        return g.chunk(line.size, dim)[line.rank].contiguous(), None, None


def _line_of(mesh):
    line = sequence_line(mesh)
    if line is None:
        raise ValueError(
            "sequence-parallel attention needs a sequence axis above 1 on "
            "the mesh")
    return line


def _global_form(local_fn, q, k, v, mesh, kv_valid=None, **kw):
    line = _line_of(mesh)
    cut = [_ScatterSeq.apply(t, line, 2) for t in (q, k, v)]
    if kv_valid is not None:
        kv_valid = kv_valid.chunk(line.size, 1)[line.rank]
    return _GatherSeq.apply(local_fn(*cut, kv_valid, line=line, **kw),
                            line, 2)


def ring_attention(q, k, v, mesh, kv_valid=None, **kw):
    """:func:`ring_attention_local` over the whole sequence ([B, H, S, D]
    and ``kv_valid`` [B, S], the same on every rank of ``mesh``'s
    sequence line); the whole output on every rank."""
    return _global_form(ring_attention_local, q, k, v, mesh, kv_valid, **kw)


def ulysses_attention(q, k, v, mesh, kv_valid=None, **kw):
    """:func:`ulysses_attention_local` over the whole sequence, as
    :func:`ring_attention`."""
    return _global_form(ulysses_attention_local, q, k, v, mesh, kv_valid,
                        **kw)


def sequence_parallel_attention(q, k, v, mesh, kv_valid=None, *,
                                impl="auto", use_flash=True, **kw):
    """Dispatcher over the whole sequence: 'ring' | 'ulysses' | 'auto'
    (Ulysses when ``q``'s heads, this rank's, divide by the sequence
    size, else the ring), as :func:`ring_attention`."""
    return _global_form(sequence_parallel_attention_local, q, k, v, mesh,
                        kv_valid, impl=impl, use_flash=use_flash, **kw)
