"""The transformer block: training and eval modes, and the decode paths.

Port of deepspeed_tpu/ops/transformer.py: the same computation — qkv
projection -> multi-head attention (with attention dropout) -> output
projection -> dropout + residual -> LayerNorm -> FF1 -> tanh-approx GeLU
-> FF2 -> dropout + residual -> LayerNorm, in pre- and post-LayerNorm
order — over the reference's 12-tensor parameter layout (attn_qkvw/qkvb,
attn_ow/ob, attn_nw/nb, inter_w/b, output_w/b, norm_w/b). Weights are
stored as ``F.linear`` takes them, ``[out, in]``; the JAX package keeps
``[in, out]``, and ``convert.py`` is the one place that transposes.

In training mode the block's parameters stay differentiable and it draws
three dropout streams from a :class:`DropoutRNG`: the attention kernels'
mask seed and the two hidden dropouts, all drawn before the block runs,
as the JAX block draws its keys. The memory modes (``normalize_invertible``,
``gelu_checkpoint``, ``attn_dropout_checkpoint``; GPT-2's ``remat``) wrap
the block in ``torch.utils.checkpoint`` under ``remat_policy``
(:func:`resolve_remat_policy`); since the block's randomness is drawn
outside the checkpointed region, the recompute repeats the forward's
masks and seeds exactly. ``stochastic_mode`` keeps the LayerNorm
statistics in bf16 under bf16 compute (:func:`layer_norm_apply`), plain
PyTorch as the JAX path is XLA. The
large projections stay ``F.linear`` (cuBLAS), as the JAX package left
them to XLA; attention goes through the kernels of ops/attention.py
(prefill, training) and ops/decode_attention.py (decode).

LoRA (:func:`apply_lora`) adds a low-rank delta to the four projection
matrices at the JAX package's four points (qkv; attention out before the
hidden dropout; ``inter_w`` before GeLU; ``output_w`` before dropout),
from per-layer ``{name}_lora_a``/``{name}_lora_b`` parameters (the
fine-tune path) or from a batched per-slot adapter pool (serving). The
LoRA factors keep the JAX orientation, A ``[in, r]`` and B ``[r, out]``
(delta = ``(x @ A) @ B``), unlike the base weights.

The paged functions update the KV pool IN PLACE (the JAX package returns
a new pool from ``.at[].set()``); they return only the hidden states.

Tensor parallelism (``tensor_parallel``) runs every block, the training
and the serving ones, on the rank's ``heads / mp`` heads; the batched
adapter pool then holds the rank's factor shards. Sequence parallelism
(``sequence_parallel``) runs the training block's attention as ring or
Ulysses attention over the sequence line (parallel/sequence.py).
"""

import dataclasses
import types

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.sequence import sequence_parallel_attention_local
from ..parallel.tensor import copy_to_region, reduce_from_region
from .attention import (  # the seed strides are re-exported here
    DATA_RANK_SEED_STRIDE,
    MODEL_RANK_SEED_STRIDE,
    NEG_INF,
    additive_mask_to_kv_valid,
    attention,
    routes_to_flash,
    shard_seed,
)
from .decode_attention import lora_sgmv_add, paged_flash_decode


class DropoutRNG:
    """One micro-step's dropout randomness, from ``seed``: attention-mask
    seeds (``attn_seed``, one per layer) from a CPU ``torch.Generator``,
    so drawing one never waits for the device, and hidden-dropout masks
    (``keep``) from a generator on ``device``. The JAX package splits a
    key per layer and per stream instead; the two give different masks
    from one seed.

    ``data_rank`` decorrelates data-parallel ranks, which draw the same
    ``seed``: every attention seed is offset by ``data_rank *``
    :data:`DATA_RANK_SEED_STRIDE`, and the keep masks' generator starts
    from ``seed`` offset the same way (rank 0 draws what a single process
    draws). ``model_rank`` (tensor parallelism) offsets the attention
    seeds only, by ``model_rank *`` :data:`MODEL_RANK_SEED_STRIDE`: each
    model rank drops its own heads' probabilities, while the hidden
    dropouts act on the replicated residual stream after the row-parallel
    reductions and must draw the same masks on every model rank
    (Megatron's rule: only model-parallel regions use the model-parallel
    stream)."""

    def __init__(self, seed, device, data_rank=0, model_rank=0):
        self._data_rank = int(data_rank)
        self._model_rank = int(model_rank)
        self._host = torch.Generator().manual_seed(int(seed))
        self._device = torch.Generator(device=device).manual_seed(
            (int(seed) + self._data_rank * DATA_RANK_SEED_STRIDE) % 2**63)
        self.device = torch.device(device)

    def attn_seed(self):
        drawn = int(torch.randint(0, 2**31 - 1, (), generator=self._host))
        return shard_seed(drawn, self._data_rank, self._model_rank)

    def keep(self, shape, rate):
        """A keep mask: each element kept with probability 1 - rate."""
        u = torch.rand(shape, generator=self._device, device=self.device)
        return u < (1.0 - rate)


def dropout(x, rate, rng):
    """The JAX package's hidden dropout: ``where(keep, x / (1 - rate),
    0)`` in x's dtype; identity when ``rng`` is None or ``rate`` is 0."""
    if rng is None or rate <= 0:
        return x
    return _apply_keep(x, rng.keep(x.shape, rate), rate)


def _apply_keep(x, keep, rate):
    """Hidden dropout with a keep mask drawn beforehand (None: identity)."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """The fields of the JAX package's DeepSpeedTransformerConfig that the
    block reads. Any memory-mode flag turns remat of the block on, with
    ``remat_policy`` (:func:`resolve_remat_policy`). ``lora_rank > 0``
    gives each layer per-layer LoRA factors for ``lora_targets`` (() =>
    all of :data:`LORA_TARGETS`)."""

    hidden_size: int = -1
    heads: int = -1
    intermediate_size: int = -1  # -1 => 4*hidden
    attn_dropout_ratio: float = 0.1
    hidden_dropout_ratio: float = 0.1
    initializer_range: float = 0.02
    pre_layer_norm: bool = True
    layer_norm_eps: float = 1e-12
    # the reference's memory modes: each maps onto remat of the block
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    attn_dropout_checkpoint: bool = False
    # "full" recomputes the whole block in the backward; any other value
    # is a '+'-separated spec of JAX checkpoint policies and checkpoint
    # names (resolve_remat_policy)
    remat_policy: str = "full"
    lora_rank: int = 0
    lora_alpha: float = 0.0  # 0 => rank (scaling 1.0)
    lora_targets: tuple = ()
    # the reference's relaxed-precision variant: under bf16 compute the
    # LayerNorm statistics stay in bf16 (layer_norm_apply); a no-op
    # otherwise
    stochastic_mode: bool = False
    # tensor parallelism (parallel/tensor.py:TensorParallel): the block's
    # parameters are this rank's Megatron shards and it computes on its
    # heads / mp local heads; None = the whole block on one rank
    tensor_parallel: object = dataclasses.field(
        default=None, compare=False, repr=False)
    # sequence parallelism (parallel/sequence.py:SequenceParallel): the
    # block's tokens are this rank's chunk of the sequence and attention
    # runs as ring or Ulysses attention over the line (the JAX layer's
    # ``mesh`` with a sequence axis above 1); None = the whole sequence
    sequence_parallel: object = dataclasses.field(
        default=None, compare=False, repr=False)
    # "auto" | "ring" | "ulysses" (the JAX layer's seq_parallel_impl)
    seq_parallel_impl: str = "auto"

    @property
    def intermediate(self):
        return (
            self.intermediate_size
            if self.intermediate_size > 0
            else 4 * self.hidden_size
        )

    @property
    def use_remat(self):
        """Any reference memory-mode flag maps onto remat of the block."""
        return (
            self.normalize_invertible
            or self.gelu_checkpoint
            or self.attn_dropout_checkpoint
        )

    def lora_dims(self, target):
        """``(in, out)`` of LoRA target ``target`` in this block."""
        dims = {"H": self.hidden_size, "3H": 3 * self.hidden_size,
                "I": self.intermediate}
        return tuple(dims[d] for d in LORA_TARGET_DIMS[target])


#: The public names of ``jax.checkpoint_policies`` (JAX 0.9): a remat
#: spec part the JAX package accepts. Those in :data:`_SAVED_OPS` are
#: mapped; the rest (:data:`JAX_POLICY_FACTORIES`) are refused.
JAX_CHECKPOINT_POLICIES = (
    "checkpoint_dots", "checkpoint_dots_with_no_batch_dims",
    "dots_saveable", "dots_with_no_batch_dims_saveable",
    "everything_saveable", "nothing_saveable",
    "offload_dot_with_no_batch_dims", "save_and_offload_only_these_names",
    "save_any_names_but_these", "save_anything_except_these_names",
    "save_from_both_policies", "save_only_these_names",
)
#: The names of :data:`JAX_CHECKPOINT_POLICIES` that are policy
#: factories: ``jax.checkpoint_policies.save_only_these_names("n")``
#: returns a policy, the factory itself is none. The JAX package accepts
#: one as a spec part, and its first backward raises ``TypeError`` (the
#: factory is called with a primitive's parameters); the port raises the
#: same class when the spec is resolved.
JAX_POLICY_FACTORIES = (
    "offload_dot_with_no_batch_dims", "save_and_offload_only_these_names",
    "save_any_names_but_these", "save_anything_except_these_names",
    "save_from_both_policies", "save_only_these_names",
)
#: The JAX package's checkpoint names (deepspeed_tpu/ops/attention.py:
#: CHECKPOINT_NAMES). ``zero3_gathered`` tags ZeRO-3's gathered weights
#: (models/stack.py).
CHECKPOINT_NAMES = ("attn_probs", "flash_out", "flash_lse", "zero3_gathered")

_EVERYTHING = "everything"
_aten = torch.ops.aten
#: What each mapped part saves in the block's recompute (the outputs of
#: these aten ops; everything else is recomputed): a JAX "dot" is a matmul
#: (``F.linear`` lowers to mm/addmm, ``einsum`` to bmm); one "with no batch
#: dims" has no batch dimension (mm/addmm); ``attn_probs`` is the plain
#: attention's softmax. ``flash_out``/``flash_lse`` are kept by the
#: block's structure instead (transformer_block_apply).
_SAVED_OPS = {
    "dots_saveable": (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm),
    "checkpoint_dots": (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm),
    "dots_with_no_batch_dims_saveable": (_aten.mm, _aten.addmm),
    "checkpoint_dots_with_no_batch_dims": (_aten.mm, _aten.addmm),
    "nothing_saveable": (),
    "everything_saveable": _EVERYTHING,
    "attn_probs": (_aten._softmax,),
    "flash_out": (),
    "flash_lse": (),
    "zero3_gathered": (),
}


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """A resolved remat spec: the aten ops whose outputs the recompute
    keeps (``saved_ops``, or ``everything``), and whether the flash
    kernels' output and log-sum-exp are kept (``keep_flash``: both
    ``flash_out`` and ``flash_lse`` named), in which case attention runs
    outside the checkpointed segments and its forward kernel is not run
    again, and whether ZeRO-3's gathered weights are kept as residuals
    (``keep_gathered``: ``zero3_gathered`` named), in which case the
    stage-3 stack gathers outside the checkpointed region and the
    backward does not gather again."""

    saved_ops: tuple = ()
    everything: bool = False
    keep_flash: bool = False
    keep_gathered: bool = False

    def policy_fn(self, ctx, op, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy

        del ctx, args, kwargs
        if self.everything or op.overloadpacket in self.saved_ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    def context_fn(self):
        from torch.utils.checkpoint import (
            create_selective_checkpoint_contexts,
        )

        return create_selective_checkpoint_contexts(self.policy_fn)


def resolve_remat_policy(spec):
    """Resolve a remat-policy spec: '+'-separated parts, each a
    ``jax.checkpoint_policies`` name or a checkpoint name to keep (e.g.
    "dots_with_no_batch_dims_saveable+flash_out+flash_lse" keeps the
    weight-matmul outputs and the flash kernel's residuals, so the
    backward recomputes only the cheap elementwise chains). Accepts and
    rejects what the JAX package does: a typo'd part is a ValueError, and
    a part the JAX package accepts but cannot run as a policy (a policy
    factory of :data:`JAX_POLICY_FACTORIES`, or a dunder attribute of the
    ``SimpleNamespace`` that ``jax.checkpoint_policies`` is) is a
    TypeError, raised here where the JAX package raises it at the first
    backward. Returns a :class:`RematPolicy`."""
    saved, everything, names = set(), False, set()
    for part in spec.split("+"):
        if part in _SAVED_OPS:
            ops = _SAVED_OPS[part]
            if ops is _EVERYTHING:
                everything = True
            else:
                saved.update(ops)
            if part in CHECKPOINT_NAMES:
                names.add(part)
        elif part in JAX_POLICY_FACTORIES or (
                part.startswith("__")
                and hasattr(types.SimpleNamespace(), part)):
            # jax.checkpoint_policies is a SimpleNamespace: its dunder
            # attributes pass the JAX package's hasattr check
            raise TypeError(
                f"remat policy part {part!r}: the JAX package accepts it "
                "(an attribute of jax.checkpoint_policies) but cannot run "
                "it as a policy (its first backward raises TypeError); "
                "name a policy such as 'dots_saveable', or a checkpoint "
                f"name of {CHECKPOINT_NAMES}"
            )
        else:
            # a typo'd policy name must fail loudly, not silently become a
            # never-matching name-saver that recomputes everything
            raise ValueError(
                f"unknown remat policy part {part!r}: neither a "
                f"jax.checkpoint_policies attribute nor a known checkpoint "
                f"name {CHECKPOINT_NAMES}"
            )
    return RematPolicy(
        saved_ops=tuple(sorted(saved, key=str)), everything=everything,
        keep_flash={"flash_out", "flash_lse"} <= names,
        keep_gathered="zero3_gathered" in names,
    )


#: The reference's 12-tensor layout: name, shape in (H, I) terms with
#: weights as [out, in], and init kind ("normal", "zeros", "ones").
TRANSFORMER_PARAM_LAYOUT = (
    ("attn_qkvw", ("3H", "H"), "normal"),
    ("attn_qkvb", ("3H",), "zeros"),
    ("attn_ow", ("H", "H"), "normal"),
    ("attn_ob", ("H",), "zeros"),
    ("attn_nw", ("H",), "ones"),
    ("attn_nb", ("H",), "zeros"),
    ("inter_w", ("I", "H"), "normal"),
    ("inter_b", ("I",), "zeros"),
    ("output_w", ("H", "I"), "normal"),
    ("output_b", ("H",), "zeros"),
    ("norm_w", ("H",), "ones"),
    ("norm_b", ("H",), "zeros"),
)


#: Projection matrices LoRA can target, with their (in, out) dims in the
#: shape vocabulary of TRANSFORMER_PARAM_LAYOUT — every weight MATRIX of
#: the block (biases/norms gain nothing from low-rank deltas).
LORA_TARGETS = ("attn_qkvw", "attn_ow", "inter_w", "output_w")
LORA_TARGET_DIMS = {
    "attn_qkvw": ("H", "3H"),
    "attn_ow": ("H", "H"),
    "inter_w": ("H", "I"),
    "output_w": ("I", "H"),
}
#: Each projection's Megatron split under tensor parallelism: a
#: column-parallel weight shards its output dim, a row-parallel one its
#: input dim (the JAX package's LORA_TARGET_PARALLEL)
LORA_TARGET_PARALLEL = {
    "attn_qkvw": "column", "inter_w": "column",
    "attn_ow": "row", "output_w": "row",
}


def resolve_lora_targets(targets):
    """Normalize + validate a lora_targets value: () / None => every
    target; anything naming an unknown matrix fails loudly (a typo'd
    target would otherwise silently train/serve a partial adapter)."""
    targets = tuple(targets) if targets else LORA_TARGETS
    unknown = [t for t in targets if t not in LORA_TARGETS]
    if unknown:
        raise ValueError(
            f"unknown LoRA target(s) {unknown}; valid: {list(LORA_TARGETS)}"
        )
    if len(set(targets)) != len(targets):
        raise ValueError(f"duplicate LoRA targets in {targets}")
    return targets


def lora_scaling(rank, alpha=0.0):
    """delta multiplier: alpha / rank (alpha 0/None => rank => 1.0)."""
    return (float(alpha) if alpha else float(rank)) / float(rank)


def apply_lora(cfg, p, lora, name, x, y):
    """``y`` (the base projection of ``x``) plus projection ``name``'s
    LoRA delta, from one of two adapter sources:

    - ``lora = (pools, ids, scale, fused)`` — the batched multi-adapter
      serving path: ``pools`` maps target -> (A [n_adapters+1, in, r],
      B [n_adapters+1, r, out]) for this layer, ``ids`` [B] int32 picks
      each slot's row (row 0 = the all-zeros identity). With ``fused``,
      decode-shaped calls (``x.shape[1] == 1``) go through the SGMV
      kernel with its epilogue
      (:func:`~deepspeed_tpu_torch.ops.decode_attention.lora_sgmv_add`:
      ``y + (scale * delta).to(y.dtype)`` with the float32 delta, in one
      launch); every other call gathers each slot's rows and runs both
      products in the input dtype, as the JAX package's XLA path does.
    - per-layer ``{name}_lora_a`` / ``{name}_lora_b`` parameters of ``p``
      (the fine-tune path, ``cfg.lora_rank > 0``): one shared adapter,
      differentiated with the rest of ``p``.

    Returns ``y`` untouched when neither source names this projection."""
    if lora is not None:
        pools, ids, scale, fused = lora
        ab = pools.get(name)
        if ab is None:
            return y
        a, b = ab
        if fused and x.shape[1] == 1:
            return lora_sgmv_add(x, a, b, ids, y, scale)
        rows = ids.long()
        t = torch.einsum("bsi,bir->bsr", x, a[rows])
        return y + (scale * torch.einsum("bsr,bro->bso", t, b[rows])).to(
            y.dtype
        )
    if cfg.lora_rank > 0:
        a = getattr(p, f"{name}_lora_a", None)
        if a is None:
            return y
        b = getattr(p, f"{name}_lora_b")
        scale = lora_scaling(cfg.lora_rank, cfg.lora_alpha)
        return y + (scale * ((x @ a) @ b)).to(y.dtype)
    return y


class DeepSpeedTransformerLayer(nn.Module):
    """One block's parameters (TRANSFORMER_PARAM_LAYOUT, plus the LoRA
    factors ``{t}_lora_a`` [in, r] / ``{t}_lora_b`` [r, out] when the
    config's ``lora_rank > 0``); the block functions below take it as
    ``p``."""

    def __init__(self, config, device=None, dtype=torch.float32):
        super().__init__()
        self.config = config
        dims = {"H": config.hidden_size, "3H": 3 * config.hidden_size,
                "I": config.intermediate}
        for name, shape, _ in TRANSFORMER_PARAM_LAYOUT:
            setattr(self, name, nn.Parameter(torch.empty(
                tuple(dims[d] for d in shape), device=device, dtype=dtype,
            )))
        if config.lora_rank > 0:
            self.add_lora_params()

    def add_lora_params(self):
        """Zero-filled LoRA factors for the config's rank and targets, on
        the block's device and in its dtype (factors it has are kept)."""
        r = int(self.config.lora_rank)
        like = self.attn_qkvw
        for t in resolve_lora_targets(self.config.lora_targets):
            din, dout = self.config.lora_dims(t)
            for suffix, shape in (("_lora_a", (din, r)),
                                  ("_lora_b", (r, dout))):
                if t + suffix not in self._parameters:
                    setattr(self, t + suffix, nn.Parameter(torch.zeros(
                        shape, device=like.device, dtype=like.dtype)))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """N(0, initializer_range) weights, zero biases, unit norms — the
        JAX layer's initializers (not its random stream). The LoRA
        factors are left to :meth:`reset_lora_parameters`."""
        for name, _, kind in TRANSFORMER_PARAM_LAYOUT:
            p = getattr(self, name)
            if kind == "normal":
                p.normal_(0.0, self.config.initializer_range,
                          generator=generator)
            elif kind == "ones":
                p.fill_(1.0)
            else:
                p.zero_()

    @torch.no_grad()
    def reset_lora_parameters(self, generator=None):
        """A ~ N(0, initializer_range), B = 0: the initial delta is exactly
        zero, so a fresh adapter starts from the base model."""
        for name, p in self.named_parameters(recurse=False):
            if name.endswith("_lora_a"):
                p.normal_(0.0, self.config.initializer_range,
                          generator=generator)
            elif name.endswith("_lora_b"):
                p.zero_()


_STOCHASTIC_NOTICED = [False, False]  # [active-path notice, no-op notice]


def _notice_stochastic_once(active, dtype=None):
    """The JAX package's one-time notice that ``stochastic_mode`` is on
    (``active``, under bf16) or ignored (any other compute dtype)."""
    idx = 0 if active else 1
    if _STOCHASTIC_NOTICED[idx]:
        return
    _STOCHASTIC_NOTICED[idx] = True
    from ..utils.logging import log_dist

    if active:
        log_dist(
            "stochastic_mode: relaxed-precision transformer path active — "
            "LayerNorm statistics in bf16 (fp32 upcast skipped). Matches "
            "the reference's __STOCHASTIC_MODE__ kernel contract: faster, "
            "pretraining-safe, not bit-deterministic vs the default path.",
            ranks=[0],
        )
    else:
        log_dist(
            f"stochastic_mode requested but compute dtype is {dtype}; the "
            "relaxed LayerNorm path applies only under bf16 (fp16's range "
            "would overflow the statistics) — running the default "
            "fp32-statistics path.",
            ranks=[0],
        )


def layer_norm_apply(cfg, x, scale, bias):
    """The block's LayerNorm (shared by every serving path): statistics,
    the epsilon and the affine in float32 (1e-12 underflows in bf16), the
    result in x's dtype. With ``cfg.stochastic_mode`` and a bf16 ``x``,
    the JAX package's relaxed path: the mean and variance (accumulated in
    float32, as ``jnp.mean``/``jnp.var`` do) rounded to bf16, the epsilon
    joined in float32, and the normalisation and affine in bf16."""
    if cfg.stochastic_mode and x.dtype == torch.bfloat16:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, unbiased=False, keepdim=True)
        inv = torch.rsqrt(var.to(x.dtype).float() + cfg.layer_norm_eps)
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        return y * scale.to(x.dtype) + bias.to(x.dtype)
    xs = x.float()
    mean = xs.mean(dim=-1, keepdim=True)
    var = xs.var(dim=-1, unbiased=False, keepdim=True)
    y = (xs - mean) * torch.rsqrt(var + cfg.layer_norm_eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _gelu(x):
    # tanh-approx gelu, as the JAX block (reference gelu_kernels.cu:38)
    return F.gelu(x, approximate="tanh")


def _project(cfg, p, lora, name, x, bias):
    """``x``'s projection through weight ``name`` plus its LoRA delta."""
    return apply_lora(
        cfg, p, lora, name, x, F.linear(x, getattr(p, name), bias)
    )


def _tp_lora(cfg, p, name):
    """The per-layer LoRA factors of ``name`` under tensor parallelism, or
    None."""
    if cfg.lora_rank <= 0 or getattr(p, f"{name}_lora_a", None) is None:
        return None
    return (getattr(p, f"{name}_lora_a"), getattr(p, f"{name}_lora_b"),
            lora_scaling(cfg.lora_rank, cfg.lora_alpha))


def _project_column(cfg, p, lora, name, x, bias):
    """A column-parallel projection (the qkv and ``inter_w``): ``x``, the
    replicated input, enters the region (its gradient is the model
    group's sum) and each rank computes its slice of the outputs with its
    weight and bias rows. A LoRA A factor [in, r] is replicated and used
    inside the region, so its gradient is summed too; B holds the rank's
    output columns. The batched serving pool (``lora``) holds the same
    shards, A whole and B the rank's columns (models/gpt2.py:
    adapter_pool_partition_specs), so its delta, and SGMV's epilogue,
    land on the rank's own columns."""
    tp = cfg.tensor_parallel
    if tp is None:
        return _project(cfg, p, lora, name, x, bias)
    x = copy_to_region(x, tp)
    y = F.linear(x, getattr(p, name), bias)
    if lora is not None:
        return apply_lora(cfg, p, lora, name, x, y)
    f = _tp_lora(cfg, p, name)
    if f is None:
        return y
    a, b, scale = f
    return y + (scale * ((x @ copy_to_region(a, tp)) @ b)).to(y.dtype)


def _project_row(cfg, p, lora, name, x, bias):
    """A row-parallel projection (``attn_ow``, ``output_w``): each rank's
    partial product of its input columns, summed over the model group;
    the replicated bias is added once, after the sum. A LoRA A factor
    holds the rank's input rows and its delta joins the partial sum; B
    [r, out] is replicated and used inside the region, so its gradient is
    summed. The batched serving pool (``lora``) holds A's rows of the
    rank's inputs and B whole: its delta (SGMV's epilogue in fused
    decode) is a partial sum too, added to the rank's partial product
    before the reduction."""
    tp = cfg.tensor_parallel
    if tp is None:
        return _project(cfg, p, lora, name, x, bias)
    y = F.linear(x, getattr(p, name))
    f = _tp_lora(cfg, p, name)
    if lora is not None:
        y = apply_lora(cfg, p, lora, name, x, y)
    elif f is not None:
        a, b, scale = f
        y = y + (scale * ((x @ a) @ copy_to_region(b, tp))).to(y.dtype)
    return reduce_from_region(y, tp) + bias


def _ffn_sublayer(cfg, p, x, keep=None, lora=None, ffn_fn=None):
    """The FFN sublayer; ``ffn_fn(ff_in) -> h`` or ``-> (h, aux)``
    replaces the dense FFN (pre-residual, pre-dropout), and with an aux
    the sublayer returns ``(x, aux)``."""
    residual = x
    ff_in = (
        layer_norm_apply(cfg, x, p.norm_w, p.norm_b)
        if cfg.pre_layer_norm else x
    )
    aux = None
    if ffn_fn is not None:
        h = ffn_fn(ff_in)
        if isinstance(h, tuple):
            h, aux = h
    else:
        h = _gelu(_project_column(cfg, p, lora, "inter_w", ff_in,
                                  p.inter_b))
        h = _project_row(cfg, p, lora, "output_w", h, p.output_b)
    x = residual + _apply_keep(h, keep, cfg.hidden_dropout_ratio)
    if not cfg.pre_layer_norm:
        x = layer_norm_apply(cfg, x, p.norm_w, p.norm_b)
    return x if aux is None else (x, aux)


def _block_tensors(p):
    """The block's parameter tensors by name (the layout's, and the LoRA
    factors ``p`` has). Read once, in the forward: ``functional_call``
    swaps the tensors in only for the forward's duration, so a recompute
    must not read them from ``p`` again."""
    names = [n for n, _, _ in TRANSFORMER_PARAM_LAYOUT]
    names += [n for n in LORA_TARGETS for n in (n + "_lora_a", n + "_lora_b")
              if getattr(p, n, None) is not None]
    return names, [getattr(p, n) for n in names]


def transformer_block_apply(cfg, p, hidden_states, attention_mask=None, *,
                            causal=False, return_kv=False, train=False,
                            dropout_rng=None, lora=None, use_flash=True,
                            ffn_fn=None):
    """The block over ``p`` (a :class:`DeepSpeedTransformerLayer`, or a
    module whose tensors ``torch.func.functional_call`` swapped in).

    ``train`` with a ``dropout_rng`` (:class:`DropoutRNG`) applies the
    attention dropout (in the flash kernels, or in ``mha_reference`` for
    short sequences) and the two hidden dropouts; without a
    ``dropout_rng`` there is no dropout, as in the JAX package. The seed
    and the two keep masks are drawn before the block runs. With a memory
    mode on (``cfg.use_remat``) and autograd recording, the block runs
    under ``torch.utils.checkpoint`` with ``cfg.remat_policy``: "full"
    recomputes it all in the backward (the flash forward kernel runs
    twice); a selective spec keeps what :func:`resolve_remat_policy` names,
    and with ``flash_out`` and ``flash_lse`` both named (and the flash
    route taken) only the segments before and after attention are
    checkpointed, so the forward kernel runs once. ``return_kv``
    additionally returns the block's split-head key/value projections
    ``(k, v)``, each [B, heads, S, hd] — the KV-cache prefill mode: exactly
    the values attention consumed (no remat). ``lora`` is the batched
    adapter source of :func:`apply_lora` (serving prefill); per-layer
    factors in ``p`` cover the fine-tune path. ``use_flash=False`` sends
    attention to the plain reference at every length (the JAX block's
    switch). ``ffn_fn(ff_in) -> h`` or ``-> (h, aux)`` replaces the dense
    FFN sublayer's projections (pre-residual, pre-dropout; ops/moe.py's
    expert FFN), as the JAX block's seam: with an aux the block returns
    ``(out, aux)``, and ``return_kv`` is refused.

    Under ``cfg.tensor_parallel`` the parameters are this rank's Megatron
    shards (parallel/tensor.py): the qkv projection gives the rank's
    ``heads / mp`` heads of q, k and v, attention runs on them through
    the same kernels, and each row-parallel product (``attn_ow``,
    ``output_w``) is summed over the model group before its bias and the
    hidden dropout, so the residual stream stays the same on every model
    rank.

    Under ``cfg.sequence_parallel`` (a line of more than one rank) the
    block's tokens are this rank's chunk of the sequence and attention
    runs as ring or Ulysses attention over the line
    (parallel/sequence.py; ``cfg.seq_parallel_impl``, "auto" choosing by
    the rank's heads), as the JAX block dispatches under a mesh with a
    sequence axis: ``return_kv`` and masks other than a padding mask are
    refused there, with the JAX block's messages."""
    H = cfg.hidden_size
    head_dim = H // cfg.heads
    if head_dim * cfg.heads != H:
        raise ValueError("hidden_size must divide into heads")
    tp = cfg.tensor_parallel
    mp = 1 if tp is None else tp.size
    if cfg.heads % mp:
        raise ValueError(f"{cfg.heads} heads do not split over a model "
                         f"axis of {mp}")
    heads = cfg.heads // mp  # this rank's
    H_local = heads * head_dim
    b, s, _ = hidden_states.shape
    if return_kv and ffn_fn is not None:
        raise ValueError(
            "return_kv does not compose with an aux-returning ffn_fn (MoE "
            "decode is not supported)")
    if cfg.stochastic_mode:
        _notice_stochastic_once(hidden_states.dtype == torch.bfloat16,
                                hidden_states.dtype)

    # every random draw before the (optionally checkpointed) block, so
    # that a recompute repeats the forward's seed and masks
    rng = dropout_rng if train else None
    attn_seed = keep_attn = keep_ffn = None
    if rng is not None:
        attn_seed = rng.attn_seed()
        if cfg.hidden_dropout_ratio > 0:
            keep_attn = rng.keep((b, s, H), cfg.hidden_dropout_ratio)
            keep_ffn = rng.keep((b, s, H), cfg.hidden_dropout_ratio)

    def qkv_heads(q_p, x):
        attn_in = (
            layer_norm_apply(cfg, x, q_p.attn_nw, q_p.attn_nb)
            if cfg.pre_layer_norm else x
        )
        qkv = _project_column(cfg, q_p, lora, "attn_qkvw", attn_in,
                              q_p.attn_qkvb)
        # [B,S,H] -> [B,heads,S,hd], contiguous for the kernel
        return tuple(
            t.reshape(b, s, heads, head_dim).transpose(1, 2).contiguous()
            for t in qkv.split(H_local, dim=-1)
        )

    line = cfg.sequence_parallel
    if line is not None and line.size <= 1:
        line = None
    kv_valid = None
    if line is not None:
        if return_kv:
            raise ValueError(
                "return_kv (KV-cache prefill) does not compose with "
                "sequence-parallel attention; decode with a mesh whose "
                "sequence axis is 1"
            )
        kv_valid = additive_mask_to_kv_valid(attention_mask)
        if attention_mask is not None and kv_valid is None:
            raise ValueError(
                "sequence-parallel attention supports padding-style "
                "masks only (broadcast over the query dim)"
            )

    def attend(qh, kh, vh):
        rate = cfg.attn_dropout_ratio if rng is not None else 0.0
        if line is not None:
            return sequence_parallel_attention_local(
                qh, kh, vh, kv_valid, line=line, impl=cfg.seq_parallel_impl,
                use_flash=use_flash, causal=causal, dropout_rate=rate,
                dropout_seed=attn_seed)
        return attention(
            qh, kh, vh, mask=attention_mask, causal=causal,
            dropout_rate=rate, dropout_seed=attn_seed, use_flash=use_flash,
        )

    def finish(o_p, x, ctx, keep_a, keep_f):
        ctx = ctx.transpose(1, 2).reshape(b, s, H_local)
        attn_out = _apply_keep(
            _project_row(cfg, o_p, lora, "attn_ow", ctx, o_p.attn_ob),
            keep_a, cfg.hidden_dropout_ratio)
        x = x + attn_out
        if not cfg.pre_layer_norm:
            x = layer_norm_apply(cfg, x, o_p.attn_nw, o_p.attn_nb)
        return _ffn_sublayer(cfg, o_p, x, keep_f, lora, ffn_fn)

    remat = (cfg.use_remat and not return_kv and torch.is_grad_enabled())
    if not remat:
        qh, kh, vh = qkv_heads(p, hidden_states)
        x = finish(p, hidden_states, attend(qh, kh, vh), keep_attn, keep_ffn)
        return (x, (kh, vh)) if return_kv else x

    from torch.utils.checkpoint import checkpoint

    names, tensors = _block_tensors(p)

    def params(ts):
        return types.SimpleNamespace(**dict(zip(names, ts)))

    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "full":
        policy = None
    else:
        policy = resolve_remat_policy(cfg.remat_policy)
        kw["context_fn"] = policy.context_fn
    if policy is not None and policy.keep_flash and use_flash and (
            line is None and routes_to_flash(attention_mask, s, s)):
        # attention outside the checkpointed segments: its autograd
        # Function keeps the kernel's out and lse, and the forward kernel
        # is not launched again
        def head(x, *ts):
            return qkv_heads(params(ts), x)

        def tail(x, ctx, keep_a, keep_f, *ts):
            return finish(params(ts), x, ctx, keep_a, keep_f)

        qh, kh, vh = checkpoint(head, hidden_states, *tensors, **kw)
        ctx = attend(qh, kh, vh)
        return checkpoint(tail, hidden_states, ctx, keep_attn, keep_ffn,
                          *tensors, **kw)

    def block(x, keep_a, keep_f, *ts):
        q_p = params(ts)
        return finish(q_p, x, attend(*qkv_heads(q_p, x)), keep_a, keep_f)

    return checkpoint(block, hidden_states, keep_attn, keep_ffn, *tensors,
                      **kw)


def _attend_gathered(q, k_full, v_full, positions, live=None):
    """Plain single-query attention over a gathered contiguous view: ``q``
    [B, heads, hd], ``k_full``/``v_full`` [B, heads, K, hd], masked to key
    indices ``<= positions``. The unfused decode path, and the reference
    the fused kernel is held against. ``live`` [B] bool forces the
    context of slots whose block table is empty to exact zeros (the
    fused kernel's dead-slot result)."""
    hd = q.shape[-1]
    max_len = k_full.shape[2]
    sm_scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k_full.float()) * sm_scale
    valid = (
        torch.arange(max_len, device=q.device)[None, None, :]
        <= positions.long()[:, None, None]
    )
    s = torch.where(valid, s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum(
        "bhk,bhkd->bhd", probs.to(v_full.dtype).float(), v_full.float()
    ).to(v_full.dtype)
    if live is not None:
        ctx = torch.where(live[:, None, None], ctx, 0.0)
    return ctx


def _local_heads(cfg):
    """``(heads, head_dim, heads * head_dim)`` of this rank: the block's
    heads over the model axis (all of them without tensor
    parallelism)."""
    tp = cfg.tensor_parallel
    mp = 1 if tp is None else tp.size
    if cfg.heads % mp:
        raise ValueError(f"{cfg.heads} heads do not split over a model "
                         f"axis of {mp}")
    heads, head_dim = cfg.heads // mp, cfg.hidden_size // cfg.heads
    return heads, head_dim, heads * head_dim


def _decode_block_core(cfg, p, hidden_states, attend, lora=None):
    """The shared single-token decode block: LN/qkv/attention/FFN, with
    the attention context behind ``attend(q, k_new, v_new) -> ctx``
    (each [B, heads, hd], this rank's heads under tensor parallelism)
    and ``lora`` the batched adapter source of :func:`apply_lora` (one
    adapter row per slot)."""
    heads, head_dim, H = _local_heads(cfg)
    b = hidden_states.shape[0]

    residual = hidden_states
    attn_in = (
        layer_norm_apply(cfg, hidden_states, p.attn_nw, p.attn_nb)
        if cfg.pre_layer_norm else hidden_states
    )
    qkv = _project_column(cfg, p, lora, "attn_qkvw", attn_in, p.attn_qkvb)
    q, k_new, v_new = (
        t.reshape(b, heads, head_dim) for t in qkv.split(H, dim=-1)
    )
    ctx = attend(q.contiguous(), k_new, v_new).reshape(b, 1, H)
    x = residual + _project_row(cfg, p, lora, "attn_ow", ctx, p.attn_ob)
    if not cfg.pre_layer_norm:
        x = layer_norm_apply(cfg, x, p.attn_nw, p.attn_nb)
    return _ffn_sublayer(cfg, p, x, lora=lora)


def transformer_block_decode(cfg, p, hidden_states, k_cache, v_cache,
                             positions, lora=None):
    """One incremental-decode step over a CONTIGUOUS KV cache.

    ``hidden_states`` [B, 1, H]; ``k_cache``/``v_cache`` [B, heads,
    max_len, hd] (one layer's cache); ``positions`` [B] int32, this
    token's position (== tokens already cached for the row). Writes the
    token's k/v at ``positions`` IN PLACE, then attends over cache
    positions ``<= positions`` through :func:`_attend_gathered`. A write
    at ``positions >= max_len`` is dropped (as JAX's scatter drops an
    out-of-bounds update), without a host sync: the row rewrites its own
    last entry. ``lora``: the batched adapter source. Returns [B, 1, H]."""
    b = hidden_states.shape[0]
    max_len = k_cache.shape[2]
    rows = torch.arange(b, device=hidden_states.device)
    pos = positions.long()
    keep = (pos < max_len)[:, None, None]
    idx = torch.clamp(pos, max=max_len - 1)

    def attend(q, k_new, v_new):
        k_cache[rows, :, idx] = torch.where(
            keep, k_new.to(k_cache.dtype), k_cache[rows, :, idx])
        v_cache[rows, :, idx] = torch.where(
            keep, v_new.to(v_cache.dtype), v_cache[rows, :, idx])
        return _attend_gathered(q, k_cache, v_cache, positions)

    return _decode_block_core(cfg, p, hidden_states, attend, lora=lora)


def transformer_block_decode_paged(cfg, p, hidden_states, k_pool, v_pool,
                                   block_tables, positions, fused=False,
                                   lora=None):
    """One incremental-decode step over a block-paged KV cache.

    ``hidden_states`` [B, 1, H]; ``k_pool``/``v_pool`` [num_blocks,
    block_size, heads, hd] (one layer's pool; physical page 0 the NULL
    page); ``block_tables`` [B, max_blocks] int32; ``positions`` [B]
    int32. Writes this token's k/v at ``(block_tables[b, pos //
    block_size], pos % block_size)`` IN PLACE, then attends: ``fused``
    launches the paged decode kernel over the pool; otherwise the slot's
    pages are gathered into a contiguous view for
    :func:`_attend_gathered`. A slot whose table starts at the NULL page
    gets an exact-zero context on both paths. ``lora``: the batched
    adapter source (its ``fused`` flag routes the deltas through the
    SGMV kernel). Returns [B, 1, H]."""
    block_size = k_pool.shape[1]
    max_blocks = block_tables.shape[1]
    b = hidden_states.shape[0]
    tables = block_tables.long()
    pos = positions.long()
    rows = torch.arange(b, device=hidden_states.device)
    block_idx = torch.clamp(pos // block_size, max=max_blocks - 1)
    phys = tables[rows, block_idx]
    offs = pos % block_size
    live = tables[:, 0] != 0

    def attend(q, k_new, v_new):
        k_pool[phys, offs] = k_new.to(k_pool.dtype)
        v_pool[phys, offs] = v_new.to(v_pool.dtype)
        if fused:
            return paged_flash_decode(
                q, k_pool, v_pool, block_tables, positions
            )
        shape = (b, max_blocks * block_size, k_pool.shape[2], k_pool.shape[3])
        k_full = k_pool[tables].reshape(shape).transpose(1, 2)
        v_full = v_pool[tables].reshape(shape).transpose(1, 2)
        return _attend_gathered(q, k_full, v_full, positions, live=live)

    return _decode_block_core(cfg, p, hidden_states, attend, lora=lora)


def transformer_block_prefill_paged(cfg, p, hidden_states, k_pool, v_pool,
                                    block_tables, start_pos, lora=None):
    """Suffix prefill through one block against cached prefix pages (the
    prefix-cache hit path). ``hidden_states`` [B, S, H] is the prompt's
    unique suffix padded to a bucket, its first token at absolute position
    ``start_pos`` [B]. Writes the suffix's k/v into the slot's pages IN
    PLACE (rows past the table's extent go to the NULL page), then runs
    causal attention over the whole gathered page view. Plain PyTorch, as
    the JAX package's path is plain XLA. ``lora``: the batched adapter
    source of :func:`apply_lora`. Under tensor parallelism the pool holds
    this rank's heads and the block runs on them. Returns [B, S, H]."""
    heads, head_dim, H = _local_heads(cfg)
    b, s, _ = hidden_states.shape
    block_size = k_pool.shape[1]
    max_blocks = block_tables.shape[1]
    kv_len = max_blocks * block_size
    tables = block_tables.long()

    residual = hidden_states
    attn_in = (
        layer_norm_apply(cfg, hidden_states, p.attn_nw, p.attn_nb)
        if cfg.pre_layer_norm else hidden_states
    )
    qkv = _project_column(cfg, p, lora, "attn_qkvw", attn_in, p.attn_qkvb)
    q, k_new, v_new = qkv.split(H, dim=-1)
    qh = q.reshape(b, s, heads, head_dim).transpose(1, 2)  # [B, heads, S, hd]

    positions = start_pos.long()[:, None] + torch.arange(
        s, device=hidden_states.device
    )[None, :]  # [B, S]
    block_idx = torch.clamp(positions // block_size, max=max_blocks - 1)
    phys = torch.gather(tables, 1, block_idx)
    phys = torch.where(positions < kv_len, phys, 0)
    offs = positions % block_size
    k_pool[phys, offs] = k_new.reshape(b, s, heads, head_dim).to(k_pool.dtype)
    v_pool[phys, offs] = v_new.reshape(b, s, heads, head_dim).to(v_pool.dtype)

    k_full = k_pool[tables].reshape(b, kv_len, heads, head_dim).transpose(1, 2)
    v_full = v_pool[tables].reshape(b, kv_len, heads, head_dim).transpose(1, 2)
    sm_scale = 1.0 / (head_dim ** 0.5)
    scores = torch.einsum(
        "bhsd,bhkd->bhsk", qh.float(), k_full.float()
    ) * sm_scale
    kpos = torch.arange(kv_len, device=hidden_states.device)
    valid = kpos[None, None, None, :] <= positions[:, None, :, None]
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum(
        "bhsk,bhkd->bhsd", probs.to(v_full.dtype).float(), v_full.float()
    ).to(v_full.dtype)
    ctx = ctx.transpose(1, 2).reshape(b, s, H)
    x = residual + _project_row(cfg, p, lora, "attn_ow", ctx, p.attn_ob)
    if not cfg.pre_layer_norm:
        x = layer_norm_apply(cfg, x, p.attn_nw, p.attn_nb)
    return _ffn_sublayer(cfg, p, x, lora=lora)
