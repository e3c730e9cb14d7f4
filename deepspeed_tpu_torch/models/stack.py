"""ZeRO-3's layer stack: the blocks over data-parallel shards, gathered
one block of layers at a time.

Port of deepspeed_tpu/models/stack.py (``zero3_scan_stack``,
``resolve_gather_block``). At ZeRO stage 3 every block tensor persists
as this rank's shard (runtime/zero.py); GPT-2's and BERT's block loops
then run through :func:`zero3_stack`, which walks the layers in gather
blocks of ``stage3_gather_block`` layers:

  persistent shard [k, ...]          (1/dp of the tensor, every step)
      | all-gather, every tensor of the block issued at once
      | the block's layers compute on the gathered tensors
      v
  the gathered tensors are freed after the block: the steady state holds
  one gather block of full layers, not the stack.

The backward gathers again instead of keeping the gathered tensors: with
remat off, a ``saved_tensors_hooks`` pair stores a gathered tensor that
autograd saves (a weight a matmul needs for its input's gradient) as a
reference, and the backward re-gathers its block when it unpacks one;
only the gathers re-run, as under the JAX package's ``save_anything_
except_these_names("zero3_gathered")`` policy. With remat on, the gather
block (its gathers included) is the checkpointed region, under the
model's remat policy, and the recompute gathers again; a remat spec that
names ``zero3_gathered`` (ops/transformer.py:resolve_remat_policy) keeps
the gathered tensors as residuals instead, as the JAX policy saves the
tagged gathers: the gather runs outside the checkpointed region, and the
recompute takes the forward's tensors. Either way the
gradient of a gathered tensor is reduce-scattered back to its shard
(:class:`_Gather`'s backward), summed over the data group.

Latency hiding (``stage3_latency_hiding``, runtime/overlap.py): the JAX
package asks XLA's scheduler to run gather i+1 under compute i. Here the
gathers of block i+1 are issued asynchronously before block i computes
(and in the backward, block i-1's before block i's gradients); with the
flag off, each gather runs synchronously when its block needs it.

The block's dropout draws (the attention seed and two keep masks a
layer) are made before its gathers, in the order of the plain loop, and
replayed into the layers, so a recompute draws nothing and stage 3 draws
the masks of the stages below.
"""

import dataclasses
import types

import torch

from ..ops.transformer import TRANSFORMER_PARAM_LAYOUT
from ..runtime import dist as dist_lib
from ..runtime.zero import from_chunks

BLOCK_TENSORS = tuple(n for n, _, _ in TRANSFORMER_PARAM_LAYOUT)


def resolve_gather_block(n_layer, requested):
    """Largest divisor of ``n_layer`` that is <= the requested gather
    block: the loop sees whole blocks, and rounding up would gather more
    layers than the config asked to hold."""
    gb = max(1, min(int(requested), n_layer))
    while n_layer % gb:
        gb -= 1
    return gb


@dataclasses.dataclass
class Zero3Arming:
    """The engine's descriptor of a model's stage-3 stack
    (runtime/engine.py:_arm_zero3_gather): ``dims`` {block tensor name:
    shard dim, or None for a replicated tensor}, ``shapes`` {name: full
    shape}, the data ``group`` and its size ``dp``, the gather ``block``
    (layers) and ``latency_hiding``."""

    dims: dict
    shapes: dict
    group: object
    dp: int
    block: int = 2
    latency_hiding: bool = True


class _Gathers:
    """The all-gathers of one forward's stack: issued per block (async
    when latency hiding is on), taken by the block's compute, and in the
    backward re-issued for the block being differentiated."""

    def __init__(self, arming, blocks):
        self.arming = arming
        self.blocks = blocks  # [[(tensor name, shard)], ...] per block
        self.pending = {}
        self.backward = False
        self.held = None  # (block, gathered) of the backward's re-gather
        # (block, {storage pointer: index}) of the forward's gathered block
        self.live = None

    def issue(self, b):
        if b in self.pending or not 0 <= b < len(self.blocks):
            return
        a = self.arming
        out = []
        for name, shard in self.blocks[b]:
            flat = shard.detach().reshape(-1)
            buf = torch.empty(flat.numel() * a.dp, dtype=flat.dtype,
                              device=flat.device)
            handle = dist_lib.all_gather(buf, flat, a.group,
                                         async_op=a.latency_hiding)
            out.append((name, buf, handle))
        self.pending[b] = out

    def take(self, b):
        """Block ``b``'s gathered tensors, in full shapes; with latency
        hiding, the next block's gathers (the previous block's in the
        backward) are issued before this one computes."""
        self.issue(b)
        got = self.pending.pop(b)
        full = []
        for name, buf, handle in got:
            if handle is not None:
                handle.wait()
            full.append(from_chunks(buf, self.arming.shapes[name],
                                    self.arming.dims[name]))
        if not self.backward:
            self.live = (b, {t.untyped_storage().data_ptr(): i
                             for i, t in enumerate(full)})
        if self.arming.latency_hiding:
            self.issue(b - 1 if self.backward else b + 1)
        return full

    def regathered(self, b):
        """Block ``b``'s gathered tensors for the backward's unpacks (one
        block held at a time)."""
        if self.held is None or self.held[0] != b:
            self.held = None  # free the last block's before gathering
            self.held = (b, self.take(b))
        return self.held[1]


class _Gather(torch.autograd.Function):
    """Shards -> gathered full tensors; the backward reduce-scatters each
    full gradient to its shard (a sum over the data group)."""

    @staticmethod
    def forward(ctx, gathers, b, *shards):
        ctx.gathers = gathers
        ctx.b = b
        return tuple(gathers.take(b))

    @staticmethod
    def backward(ctx, *grads):
        a = ctx.gathers.arming
        out = []
        for (name, shard), g in zip(ctx.gathers.blocks[ctx.b], grads):
            if g is None:
                out.append(None)
                continue
            d = a.dims[name]
            chunks = g.movedim(d, 0).contiguous() if d else g.contiguous()
            res = torch.empty(shard.shape, dtype=g.dtype, device=g.device)
            dist_lib.reduce_scatter(res.view(-1), chunks.view(-1), a.group)
            out.append(res)
        return (None, None, *out)


def gather_tensors(arming, named):
    """``[(name, shard), ...]`` -> their full tensors, all gathered at
    once, differentiable (the backward reduce-scatters to the shards):
    the stage-3 engine's gather of the tensors outside a model's stack."""
    gathers = _Gathers(arming, [named])
    gathers.backward = True  # one block: nothing to prefetch
    return _Gather.apply(gathers, 0, *(t for _, t in named))


class _Replay:
    """A layer's pre-drawn dropout randomness, handed out in the order
    transformer_block_apply draws it (the seed, then the keep masks)."""

    def __init__(self, seed, keeps):
        self._seed = seed
        self._keeps = list(keeps)

    def attn_seed(self):
        return self._seed

    def keep(self, shape, rate):
        del shape, rate
        return self._keeps.pop(0)


def _predraw(layer_cfg, rng, shape):
    """A layer's draws from ``rng`` (None: no dropout), as
    transformer_block_apply would make them."""
    if rng is None:
        return None
    seed = rng.attn_seed()
    keeps = ()
    if layer_cfg.hidden_dropout_ratio > 0:
        b, s, h = shape
        keeps = (rng.keep((b, s, h), layer_cfg.hidden_dropout_ratio),
                 rng.keep((b, s, h), layer_cfg.hidden_dropout_ratio))
    return seed, keeps


def zero3_stack(arming, layer_cfg, layers, x, layer_fn, rng=None):
    """Run ``layer_fn(inner_cfg, p, x, rng)`` over ``layers`` (modules
    whose block tensors are this rank's shards) in gather blocks.

    ``p`` is a namespace of the layer's gathered tensors (replicated ones
    as they are); ``inner_cfg`` is ``layer_cfg`` without its memory modes,
    since the gather block is the remat region; ``rng`` is the layer's
    replayed dropout draws. Returns the last layer's output."""
    from torch.utils.checkpoint import checkpoint

    from ..ops.transformer import resolve_remat_policy

    n_layer = len(layers)
    gb = resolve_gather_block(n_layer, arming.block)
    sharded = [n for n in BLOCK_TENSORS if arming.dims.get(n) is not None]
    blocks = [[(n, getattr(layers[i], n)) for i in range(b0, b0 + gb)
               for n in sharded] for b0 in range(0, n_layer, gb)]
    gathers = _Gathers(arming, blocks)
    inner_cfg = dataclasses.replace(
        layer_cfg, normalize_invertible=False, gelu_checkpoint=False,
        attn_dropout_checkpoint=False)
    grad = torch.is_grad_enabled()
    remat = grad and layer_cfg.use_remat

    def compute(b, x, draws, *full):
        it = iter(full)
        for j in range(gb):
            layer = layers[b * gb + j]
            p = types.SimpleNamespace(**{
                n: (next(it) if n in sharded else getattr(layer, n))
                for n in BLOCK_TENSORS})
            d = draws[j]
            x = layer_fn(inner_cfg, p, x,
                         None if d is None else _Replay(d[0], d[1]))
        return x

    def run_block(b, x, draws, shards):
        return compute(b, x, draws, *_Gather.apply(gathers, b, *shards))

    policy = None
    if remat and layer_cfg.remat_policy != "full":
        policy = resolve_remat_policy(layer_cfg.remat_policy)
    for b in range(len(blocks)):
        draws = [_predraw(layer_cfg, rng, x.shape) for _ in range(gb)]
        shards = [t for _, t in blocks[b]]
        if remat:
            kw = dict(use_reentrant=False, preserve_rng_state=False)
            if policy is not None:
                kw["context_fn"] = policy.context_fn
            if policy is not None and policy.keep_gathered:
                # the gathered tensors are the region's inputs: kept for
                # the backward, which gathers nothing again
                full = _Gather.apply(gathers, b, *shards)
                x = checkpoint(compute, b, x, draws, *full, **kw)
            else:
                x = checkpoint(run_block, b, x, draws, shards, **kw)
        elif grad:
            with torch.autograd.graph.saved_tensors_hooks(
                    *_regather_hooks(gathers, b)):
                x = run_block(b, x, draws, shards)
        else:
            x = run_block(b, x, draws, shards)
    gathers.backward = True
    return x


def _regather_hooks(gathers, b):
    """The pack/unpack pair of block ``b``'s forward: a saved tensor that
    lies in one of the block's gathered buffers is stored as (block,
    buffer index, size, stride, offset) and re-gathered when the backward
    unpacks it."""
    def pack(t):
        live = gathers.live
        if live is not None and live[0] == b and t.layout == torch.strided:
            idx = live[1].get(t.untyped_storage().data_ptr())
            if idx is not None:
                return ("zero3", b, idx, tuple(t.shape), t.stride(),
                        t.storage_offset())
        return t

    def unpack(saved):
        if isinstance(saved, tuple):
            _, blk, idx, size, stride, offset = saved
            return gathers.regathered(blk)[idx].as_strided(
                size, stride, offset)
        return saved

    return pack, unpack
