"""GPT-2: config presets and the LM, for serving and training.

Port of deepspeed_tpu/models/gpt2.py: the same ``GPT2Config`` fields and
size presets, and a ``GPT2LMHeadModel`` whose forward is embeddings
(with dropout in training) -> a Python loop over the blocks
(ops/transformer.py; the JAX package scans a stacked layer) -> ``ln_f``
-> the tied LM head, or with ``labels`` the scalar next-token loss
through the blocked LM-head cross-entropy (ops/cross_entropy.py).
``remat`` (with ``remat_policy``) checkpoints every block as the JAX
model does (ops/transformer.py: the layer config's memory mode).
Data parallel
(:meth:`GPT2LMHeadModel.configure_data_parallel`, set by the training
engine): the rank decorrelates dropout, the loss divides by the data
group's token count, at ZeRO stage 3 the blocks run through the gather
stack of models/stack.py, and with the engine's ``sparse_gradients`` the
``wte`` lookup's gradient goes through runtime/sparse.py. ``lora_rank > 0`` gives every block
LoRA factors (ops/transformer.py:apply_lora), which the training and
eval forward apply; the training engine's ``adapters`` block arms it.

Tensor parallelism: :func:`partition_specs` gives the Megatron layout
of the JAX package's ``partition_specs`` in the port's parameter names
and orientation, and the training engine, given those specs at a model
axis above 1, cuts every parameter to this rank's shard and arms
:meth:`GPT2LMHeadModel.configure_model_parallel`. The forward then looks
``wte`` up over the vocab shards, runs each block on its ``heads / mp``
local heads (ops/transformer.py) and takes the loss as a vocab-parallel
cross entropy (ops/cross_entropy.py:vocab_parallel_lm_head_loss). The
serving caches and the adapter pool shard heads and the LoRA factors'
Megatron dims the same way (:func:`kv_cache_partition_specs`,
:func:`kv_pool_partition_specs`, :func:`adapter_pool_partition_specs`).

Sequence parallelism (:meth:`GPT2LMHeadModel.configure_sequence_parallel`,
armed by the training engine at a sequence axis above 1): the model's
inputs are this rank's chunk of the sequence (rank ``i`` of the line
holds positions ``i*Sl:(i+1)*Sl``), the position embeddings are looked
up at those global positions, each block's attention runs as ring or
Ulysses attention over the line (ops/transformer.py,
parallel/sequence.py), and the loss is the JAX model's over the whole
sequence: ``logits[:, :-1]`` against ``labels[:, 1:]``, the label of a
rank's last token being the next rank's first, the last global position
without one; each rank sums its NLL, and the line's sum divided by the
line's count of labels is the mean.

Mixture-of-Experts (``moe_experts > 0``): every block is an MoE block
(ops/moe.py: the attention sublayer of the dense block, the expert FFN in
place of its MLP), and the forward with labels returns the JAX model's
multi-output tuple ``(lm + aux, lm, aux)``, ``aux`` the blocks' summed
router losses. The training engine cuts the experts over the data axis
(:meth:`GPT2LMHeadModel.configure_expert_parallel`).

Pipeline stages (``pipeline_stages > 1``, armed by the training engine
at a pipe axis of that size: :meth:`GPT2LMHeadModel.configure_pipeline`):
stage ``p`` holds only blocks ``p*L/P .. (p+1)*L/P - 1`` (the others'
entries of ``h`` are empty modules) and runs them in the GPipe schedule of
parallel/pipeline.py over ``pipeline_microbatches`` microbatches of the
global batch (a rank's rows times the data size; 0: 4*P when they
divide, else 2*P), as the JAX model splits its global batch. A data rank
runs its share of every microbatch when a microbatch's rows divide over
the data axis, else the whole microbatches its rows hold, else the
pieces of the microbatches its rows cut (:func:`pipeline_plan`). Stage 0 looks up the embeddings;
the last stage runs ``ln_f``, the tied head and the JAX model's loss over
the whole batch (not a mean of the microbatches' means); the loss is
broadcast, so every stage returns it. Dropout is drawn per (seed,
microbatch, layer). ``wte``, ``wpe`` and ``ln_f`` are on every stage; the
engine sums their gradients over the pipe group. MoE with pipeline
stages is refused, as the JAX model refuses it.
"""

import dataclasses
import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cross_entropy import (
    blocked_lm_head_loss,
    cross_entropy_ignore_index,
    vocab_parallel_lm_head_loss,
)
from ..ops.moe import DeepSpeedMoETransformerLayer, MoEConfig, moe_block_apply
from ..ops.transformer import (
    LORA_TARGET_PARALLEL,
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
    DropoutRNG,
    dropout,
    layer_norm_apply,
    resolve_lora_targets,
    transformer_block_apply,
)
from ..utils.device import resolve_device
from ..parallel.tensor import (
    MODEL_AXIS,
    TensorParallel,
    copy_to_region,
    gather_from_region,
    reduce_from_region,
    vocab_parallel_lookup,
)
from ..parallel.mesh import DATA_AXIS
from ..parallel.pipeline import gpipe, pipe_broadcast
from ..runtime import dist as dist_lib
from ..runtime.sparse import sparse_embedding_lookup
from .stack import zero3_stack

def _spec_for(name, ndim):
    """One parameter's Megatron spec (a tuple, an axis name or None per
    dim of the port's tensor): the rule of the JAX package's
    ``partition_specs`` (deepspeed_tpu/models/gpt2.py:414-481) on the
    port's layout, linear weights ``[out, in]`` and LoRA factors A ``[in,
    r]``, B ``[r, out]``."""
    leaf = name.rpartition(".")[2]
    spec = [None] * ndim
    if leaf.startswith("expert_"):
        # MoE experts over the data axis (ops/moe.py), the JAX package's
        # moe_leaf_spec
        spec[0] = DATA_AXIS
    elif "_lora_" in leaf:
        # the factors ride their base's axis: B's out dim for a column-
        # parallel base, A's in dim for a row-parallel one
        target, ab = leaf.rsplit("_lora_", 1)
        parallel = LORA_TARGET_PARALLEL.get(target)
        if parallel == "column" and ab == "b":
            spec[1] = MODEL_AXIS
        elif parallel == "row" and ab == "a":
            spec[0] = MODEL_AXIS
    elif leaf in ("wte", "attn_qkvb", "inter_b") or (
            LORA_TARGET_PARALLEL.get(leaf) == "column"):
        spec[0] = MODEL_AXIS
    elif LORA_TARGET_PARALLEL.get(leaf) == "row":
        spec[1] = MODEL_AXIS
    return tuple(spec)


def partition_specs(model):
    """Megatron tensor-parallel specs for a :class:`GPT2LMHeadModel`:
    ``{parameter name: spec}``, a spec holding an axis name or None per
    dim of the parameter. Column-parallel (output dim): the qkv
    projection and ``inter_w`` with their biases; row-parallel (input
    dim): ``attn_ow`` and ``output_w``; ``wte`` over the vocab; LoRA
    factors on their base's axis; MoE experts (``h.<i>.moe.expert_*``,
    dim 0) over the data axis; everything else replicated. Pass it to
    ``initialize(param_specs=...)`` with a ``mesh`` block whose
    ``model_parallel_size`` is above 1."""
    return {n: _spec_for(n, p.dim())
            for n, p in model.named_parameters()}


def kv_cache_partition_specs():
    """The spec of the contiguous decode cache ``[layers, slots, heads,
    max_len, head_dim]`` (inference/decode.py): heads over the model
    axis, the Megatron head split of the qkv projection that writes them
    (the JAX package's ``kv_cache_partition_specs``). A rank holds its
    heads' rows (inference/decode.py:init_kv_cache)."""
    return (None, None, MODEL_AXIS, None, None)


def kv_pool_partition_specs():
    """The spec of the paged decode pool ``[layers, num_blocks + 1,
    block_size, heads, head_dim]``: heads over the model axis, as
    :func:`kv_cache_partition_specs`; a rank holds its heads' rows of
    every page."""
    return (None, None, None, MODEL_AXIS, None)


def adapter_pool_partition_specs(targets=None):
    """The specs of the serving adapter pool ``{target: (A [layers, n+1,
    in, r], B [layers, n+1, r, out])}``: the factor that carries its base
    matrix's Megatron dim rides the model axis, B's output columns for a
    column-parallel target (the qkv B cut per q|k|v column group, as
    ``attn_qkvw``: parallel/tensor.py:shard_for_rank), A's input rows for
    a row-parallel one; the rest is whole on every rank (the JAX
    package's ``adapter_pool_partition_specs``)."""
    out = {}
    for t in resolve_lora_targets(targets):
        if LORA_TARGET_PARALLEL[t] == "row":
            out[t] = ((None, None, MODEL_AXIS, None), (None,) * 4)
        else:
            out[t] = ((None,) * 4, (None, None, None, MODEL_AXIS))
    return out


#: The label of a position with none (the last global position under
#: sequence parallelism): an ignore value of the loss.
NO_LABEL = -100


def _round_up(x, multiple):
    return -(-x // multiple) * multiple


@dataclasses.dataclass(unsafe_hash=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    # blocked LM-head cross-entropy: sequence positions per chunk of the
    # tied head (ops/cross_entropy.py); 0 computes the whole logits plane
    ce_block_rows: int = 512
    # remat of every block in the backward (ops/transformer.py:
    # resolve_remat_policy reads the policy)
    remat: bool = False
    remat_policy: str = "full"
    # Mixture-of-Experts: >0 replaces every block's FFN with an
    # expert-parallel MoE of this many experts (ops/moe.py); experts shard
    # over the data axis, the router losses join the objective and the
    # forward returns the multi-output tuple
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 1e-2
    # Pipeline parallelism: the stack split into this many stages over the
    # mesh's pipe axis (parallel/pipeline.py); n_layer must divide evenly
    pipeline_stages: int = 1
    # microbatches of the global batch a forward through the pipeline;
    # 0 = 4*stages when the global rows divide, else 2*stages
    pipeline_microbatches: int = 0
    # LoRA adapters (adapters/): rank-r A/B pairs beside the block's
    # projection matrices. 0 = off — the forward is then exactly the
    # adapter-free model's. Usually armed by the training engine's
    # "adapters" block rather than set by hand.
    lora_rank: int = 0
    lora_alpha: float = 0.0  # 0 => rank (scaling 1.0)
    lora_targets: tuple = ()  # () => every LORA_TARGETS matrix

    @property
    def vocab_padded(self):
        # the JAX package pads the vocab to a multiple of 128 (its matrix
        # unit's width); kept so the two packages' weights line up
        return _round_up(self.vocab_size, 128)

    @staticmethod
    def small(**kw):
        return GPT2Config(**kw)

    @staticmethod
    def medium(**kw):
        return GPT2Config(n_embd=1024, n_layer=24, n_head=16, **kw)

    @staticmethod
    def large(**kw):
        return GPT2Config(n_embd=1280, n_layer=36, n_head=20, **kw)

    @staticmethod
    def xl_1_5b(**kw):
        # the reference perf harness's 1.5B: 48L/1600h (run_perf_test.py:18-35)
        return GPT2Config(n_embd=1600, n_layer=48, n_head=25, **kw)

    def layer_config(self):
        return DeepSpeedTransformerConfig(
            hidden_size=self.n_embd,
            heads=self.n_head,
            intermediate_size=4 * self.n_embd,
            attn_dropout_ratio=self.dropout,
            hidden_dropout_ratio=self.dropout,
            initializer_range=self.initializer_range,
            pre_layer_norm=True,  # GPT-2 is pre-LN
            layer_norm_eps=self.layer_norm_eps,
            normalize_invertible=self.remat,  # the JAX model's flag reuse
            remat_policy=self.remat_policy,
            lora_rank=self.lora_rank,
            lora_alpha=self.lora_alpha,
            lora_targets=tuple(self.lora_targets),
        )

    def moe_config(self):
        return MoEConfig(n_experts=self.moe_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor,
                         aux_loss_weight=self.moe_aux_loss_weight)


#: The pipeline's per-(microbatch, layer) dropout seed strides.
MICROBATCH_SEED_STRIDE = 7_919
LAYER_SEED_STRIDE = 104_729


def pipeline_plan(rows, stages, n_micro=0, data_size=1, data_rank=0):
    """How a data rank of ``rows`` rows runs the pipeline's microbatches of
    the global batch (``rows * data_size`` rows), as the JAX model splits
    it: ``(n_micro, local, first, mb)``, the global microbatch count (0
    resolves as the JAX model: 4*stages when the global rows divide, else
    2*stages), how many this rank runs, the global index of its first and
    the rows of each. A microbatch whose rows divide over the data axis
    is run in shares (every rank, every microbatch); else a rank runs the
    whole microbatches its rows hold. Any other split (the JAX model
    leaves it to GSPMD) runs the pieces of the microbatches that the
    rank's rows cut: ``mb`` is then the tuple of the pieces' row counts,
    consecutive microbatches from ``first`` (a rank's rows may hold parts
    of two microbatches, of different sizes)."""
    total = rows * data_size
    if not n_micro:
        n_micro = 4 * stages if total % (4 * stages) == 0 else 2 * stages
    if total % n_micro:
        raise ValueError(
            f"batch {total} must divide into pipeline microbatches {n_micro}"
        )
    per = total // n_micro
    if per % data_size == 0:
        return n_micro, n_micro, 0, per // data_size
    if rows % per == 0:
        local = rows // per
        return n_micro, local, data_rank * local, per
    start, stop = data_rank * rows, (data_rank + 1) * rows
    first = start // per
    sizes = tuple(min(stop, (m + 1) * per) - max(start, m * per)
                  for m in range(first, (stop - 1) // per + 1))
    return n_micro, len(sizes), first, sizes


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with a tied LM head. Parameters: ``wte`` [vocab_padded,
    n_embd], ``wpe`` [n_positions, n_embd], ``h.<i>.*`` (the 12-tensor
    block layout, weights [out, in]), ``ln_f.weight``/``ln_f.bias``, and
    with ``config.lora_rank > 0`` the blocks' ``h.<i>.<target>_lora_a``
    [in, r] / ``_lora_b`` [r, out]. An MoE block holds the attention and
    norm tensors and ``h.<i>.moe.*`` (ops/moe.py:MoEMLP) in place of
    ``inter_*``/``output_*``.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    Weights start N(0, initializer_range) from ``seed`` (biases zero,
    norms one), then LoRA A ~ N(0, initializer_range) and B = 0 — the JAX
    model's initializers, not its random stream."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        if config.pipeline_stages > 1 and config.moe_experts > 0:
            raise ValueError(
                "pipeline_stages > 1 with moe_experts > 0 is not "
                "supported yet; pick one of pp or ep for the stack"
            )
        device = resolve_device(device)
        self.config = config
        self.layer_config = config.layer_config()
        e = config.n_embd
        self.wte = nn.Parameter(torch.empty(
            config.vocab_padded, e, device=device, dtype=dtype
        ))
        self.wpe = nn.Parameter(torch.empty(
            config.n_positions, e, device=device, dtype=dtype
        ))
        if config.moe_experts > 0:
            moe = config.moe_config()
            self.h = nn.ModuleList(
                DeepSpeedMoETransformerLayer(self.layer_config, moe, device,
                                             dtype)
                for _ in range(config.n_layer))
        else:
            self.h = nn.ModuleList(
                DeepSpeedTransformerLayer(self.layer_config, device, dtype)
                for _ in range(config.n_layer)
            )
        self.ln_f = nn.LayerNorm(
            e, eps=config.layer_norm_eps, device=device, dtype=dtype
        )
        self.configure_data_parallel()
        self.configure_model_parallel()
        self.pipeline = None
        # the last pipelined forward's pipeline_plan
        self.last_pipeline_plan = None
        self.configure_sequence_parallel()
        self.reset_parameters(seed)

    #: the stage-3 stack's tensors: ``h.<i>.<block tensor>``
    zero3_block_prefix = "h."

    def configure_data_parallel(self, data_rank=0, count_fn=None,
                                zero3=None, sparse=None):
        """The data-parallel settings the training engine hands the model:
        ``data_rank`` (dropout decorrelation, ops/transformer.py:
        DropoutRNG), ``count_fn`` (the loss's divisor, ops/cross_entropy.
        py), ``zero3`` (a :class:`~.stack.Zero3Arming`, or None for the
        plain block loop) and ``sparse`` (``(group, world)``: ``wte``'s
        lookup gradient through runtime/sparse.py, or None)."""
        self.data_rank = int(data_rank)
        self.count_fn = count_fn
        self.zero3_gather = zero3
        self.sparse_lookup = sparse

    def configure_model_parallel(self, group=None, rank=0, size=1):
        """The tensor-parallel settings the training engine hands a model
        whose parameters it cut to Megatron shards (:func:`partition_
        specs`): the model ``group``, this rank's index and the size. At
        size 1 (the default) the model computes whole."""
        size = int(size)
        self.model_rank = int(rank) if size > 1 else 0
        self.tensor_parallel = (TensorParallel(group, size, int(rank))
                                if size > 1 else None)
        self.layer_config.tensor_parallel = self.tensor_parallel

    def configure_sequence_parallel(self, line=None):
        """The sequence-parallel setting the training engine hands the
        model: ``line`` (parallel/sequence.py:SequenceParallel, or None
        for the whole sequence on this rank). The model's inputs are then
        this rank's chunk of the sequence (see the module docstring).
        Refused with pipeline stages, as the JAX model refuses them."""
        if line is not None and line.size <= 1:
            line = None
        if line is not None and (self.config.pipeline_stages > 1
                                 or self.pipeline is not None):
            raise ValueError(
                "pipeline_stages > 1 does not compose with a >1 sequence "
                "axis yet; use sp or pp for the stack, not both"
            )
        self.sequence_parallel = line
        self.layer_config.sequence_parallel = line

    def configure_expert_parallel(self, line):
        """Keep this rank's experts of every MoE block and exchange tokens
        over ``line`` (the data axis's line, parallel/sequence.py's form;
        None keeps every expert)."""
        for layer in self.h:
            if isinstance(layer, DeepSpeedMoETransformerLayer):
                layer.moe.configure_expert_parallel(line)

    def expert_parameter_names(self):
        """The names of the expert-stacked tensors (cut over the expert
        axis)."""
        return [n for n, _ in self.named_parameters()
                if n.rpartition(".")[2].startswith("expert_")]

    def configure_pipeline(self, stage, data_size=1, data_rank=0):
        """Keep this stage's blocks only and run them in the GPipe
        schedule (``stage``: parallel/pipeline.py's
        :class:`~deepspeed_tpu_torch.parallel.pipeline.PipelineStage`),
        this rank the ``data_rank`` of ``data_size`` (the microbatches
        split the global batch: :func:`pipeline_plan`). The JAX model's
        checks: the pipe size must be ``pipeline_stages``,
        ``n_layer`` must divide into it, and a sequence axis above 1 does
        not compose."""
        cfg = self.config
        n_stages = cfg.pipeline_stages
        size = 1 if stage is None else stage.size
        if n_stages > 1 or size > 1:
            if size != n_stages:
                raise ValueError(
                    f"pipeline_stages={n_stages} needs a mesh whose 'pipe' "
                    f"axis has that size (got a pipe axis of {size})")
        self.pipeline_data = (int(data_size), int(data_rank))
        if stage is None or size <= 1:
            self.pipeline = None
            return
        if self.sequence_parallel is not None:
            raise ValueError(
                "pipeline_stages > 1 does not compose with a >1 sequence "
                "axis yet; use sp or pp for the stack, not both"
            )
        if cfg.n_layer % n_stages:
            raise ValueError(
                f"n_layer={cfg.n_layer} must divide into "
                f"pipeline_stages={n_stages}"
            )
        k = cfg.n_layer // n_stages
        lo = stage.rank * k
        for i in range(cfg.n_layer):
            if not lo <= i < lo + k:
                self.h[i] = nn.Module()  # another stage's block
        self.stage_layers = tuple(range(lo, lo + k))
        self.pipeline = stage

    def pipeline_shared_parameters(self):
        """The parameters every stage holds (the embeddings and ``ln_f``):
        their gradients are summed over the pipe group."""
        return [n for n, _ in self.named_parameters()
                if not n.startswith("h.")]

    def _dropout_index(self):
        """The index that decorrelates this rank's dropout from the other
        data and sequence ranks' (the data rank at a sequence axis of
        1)."""
        line = self.sequence_parallel
        if line is None:
            return self.data_rank
        return self.data_rank * line.size + line.rank

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        gen = torch.Generator(device=self.wte.device).manual_seed(int(seed))
        std = self.config.initializer_range
        self.wte.normal_(0.0, std, generator=gen)
        self.wpe.normal_(0.0, std, generator=gen)
        for layer in self.h:
            layer.reset_parameters(gen)
        self.ln_f.reset_parameters()
        # drawn after every base tensor, so the base weights from a seed
        # do not depend on whether LoRA is on
        for layer in self.h:
            layer.reset_lora_parameters(gen)

    def add_lora_params(self):
        """Carry ``config``'s LoRA fields (set after construction, as the
        training engine arms them) into the block config and give every
        block the zero-filled factors it lacks."""
        self.layer_config.lora_rank = self.config.lora_rank
        self.layer_config.lora_alpha = self.config.lora_alpha
        self.layer_config.lora_targets = tuple(self.config.lora_targets)
        for layer in self.h:
            layer.add_lora_params()

    def final_norm_and_logits(self, x):
        """``ln_f`` (statistics and epsilon in float32) and the tied head:
        [..., n_embd] -> [..., vocab_padded] logits in x's dtype."""
        x = layer_norm_apply(
            self.layer_config, x, self.ln_f.weight, self.ln_f.bias
        )
        return self._logits(x)

    def _logits(self, x):
        """The tied head: every vocab row's logit (over vocab shards, the
        rank's logits gathered from the model group)."""
        tp = self.tensor_parallel
        if tp is None:
            return F.linear(x, self.wte)
        return gather_from_region(F.linear(copy_to_region(x, tp), self.wte),
                                  tp)

    def hidden_states(self, input_ids, train=False, dropout_rng=None):
        """Embeddings -> the blocks -> ``ln_f``: [B, S, n_embd]. In training
        with a ``dropout_rng``, the embedding dropout and each block's
        three dropout streams are drawn from it. Under sequence
        parallelism ``input_ids`` is this rank's chunk of the sequence and
        the position embeddings are those of its global positions."""
        return self._hidden_and_aux(input_ids, train, dropout_rng)[0]

    def _embed(self, input_ids, rng):
        """The token and position embeddings with the embedding dropout."""
        s = input_ids.shape[1]
        line = self.sequence_parallel
        if line is None:
            pos = self.wpe[None, :s, :]
        else:
            first = line.rank * s
            pos = self.wpe[None, first:first + s, :]
        lookup = None
        if self.sparse_lookup is not None:
            def lookup(table, ids):
                return sparse_embedding_lookup(table, ids,
                                               *self.sparse_lookup)
        if self.tensor_parallel is not None:
            emb = vocab_parallel_lookup(input_ids, self.wte,
                                        self.tensor_parallel, lookup)
        else:
            emb = (self.wte[input_ids] if lookup is None
                   else lookup(self.wte, input_ids))
        return dropout(emb + pos, self.config.dropout, rng)

    def _hidden_and_aux(self, input_ids, train=False, dropout_rng=None):
        """:meth:`hidden_states` and the MoE blocks' summed router loss
        (None for dense blocks)."""
        rng = dropout_rng if train else None
        x = self._embed(input_ids, rng)
        aux = None
        if self.config.moe_experts > 0:
            for layer in self.h:
                x, a = moe_block_apply(self.layer_config, layer, x, None,
                                       causal=True, train=train,
                                       dropout_rng=rng)
                aux = a if aux is None else aux + a
        elif self.zero3_gather is not None:
            x = zero3_stack(
                self.zero3_gather, self.layer_config, list(self.h), x,
                lambda cfg, p, h, r: transformer_block_apply(
                    cfg, p, h, None, causal=True, train=train,
                    dropout_rng=r),
                rng)
        else:
            for layer in self.h:
                x = transformer_block_apply(
                    self.layer_config, layer, x, None, causal=True,
                    train=train, dropout_rng=rng,
                )
        return layer_norm_apply(
            self.layer_config, x, self.ln_f.weight, self.ln_f.bias
        ), aux

    def forward(self, input_ids, labels=None, train=False, dropout_seed=None):
        """``input_ids`` [B, S]. Without ``labels``: logits [B, S,
        vocab_padded] (eval mode runs without autograd, the serving
        path). With ``labels`` (usually ``input_ids``; the shift happens
        here): the scalar mean next-token loss, logits[:, :-1] against
        labels[:, 1:] (with MoE blocks the tuple ``(loss + aux, loss,
        aux)``). ``train`` with a ``dropout_seed`` applies dropout
        (:class:`~deepspeed_tpu_torch.ops.transformer.DropoutRNG`)."""
        if self.pipeline is not None:
            return self._pipelined_forward(input_ids, labels, train,
                                           dropout_seed)
        if labels is None and not train:
            with torch.no_grad():
                return self._logits(self.hidden_states(input_ids))
        rng = None
        if train and dropout_seed is not None and self.config.dropout > 0:
            rng = DropoutRNG(dropout_seed, input_ids.device,
                             self._dropout_index(), self.model_rank)
        x, aux = self._hidden_and_aux(input_ids, train, rng)
        if labels is None:
            return self._logits(x)
        loss = self._lm_loss(x, labels)
        if aux is None:
            return loss
        return loss + aux, loss, aux

    def _lm_loss(self, x, labels):
        """The next-token loss of the final hidden states ``x``."""
        line = self.sequence_parallel
        count_fn = self.count_fn
        if line is None:
            x, labels = x[:, :-1], labels[:, 1:]
        else:
            labels = self._next_labels(labels, line)
            count_fn = functools.partial(self._line_count, line)
        if self.tensor_parallel is not None:
            loss = vocab_parallel_lm_head_loss(
                x, self.wte, labels, self.tensor_parallel,
                block_rows=self.config.ce_block_rows, count_fn=count_fn)
        elif self.config.ce_block_rows > 0:
            loss = blocked_lm_head_loss(
                x, self.wte, labels, block_rows=self.config.ce_block_rows,
                count_fn=count_fn,
            )
        else:
            loss = cross_entropy_ignore_index(
                F.linear(x, self.wte), labels, count_fn=count_fn,
            )
        # the line's sum of its ranks' shares (each rank backpropagates
        # the whole loss through its own tokens)
        return loss if line is None else reduce_from_region(loss, line)

    def _pipelined_forward(self, input_ids, labels, train, dropout_seed):
        """The stack as this stage's part of the GPipe schedule (see the
        module docstring): the loss (or with no labels the logits) of the
        whole batch, the same on every stage."""
        cfg = self.config
        stage = self.pipeline
        b, s = input_ids.shape
        n_micro, local, first, mb_rows = pipeline_plan(
            b, stage.size, cfg.pipeline_microbatches, *self.pipeline_data)
        self.last_pipeline_plan = (n_micro, local, first, mb_rows)
        seed = (dropout_seed if train and dropout_seed is not None
                and cfg.dropout > 0 else None)
        device = input_ids.device
        dtype = self.wte.dtype
        # pieces of different sizes run concatenated along the rows
        sizes = mb_rows if isinstance(mb_rows, tuple) else None
        shape = ((b, s, cfg.n_embd) if sizes is not None
                 else (local, mb_rows, s, cfg.n_embd))
        if stage.first:
            rng = (None if seed is None else
                   DropoutRNG(seed, device, self._dropout_index()))
            microbatches = self._embed(input_ids, rng).reshape(shape)
        else:
            microbatches = torch.empty(shape, dtype=dtype, device="meta")
        layers = [(i, self.h[i]) for i in self.stage_layers]

        def stage_fn(params, h, mb, extras):
            for i, layer in params:
                rng = None
                if seed is not None:
                    rng = DropoutRNG(
                        (seed + (first + mb) * MICROBATCH_SEED_STRIDE
                         + i * LAYER_SEED_STRIDE) % (2**31 - 1),
                        device, self._dropout_index())
                h = transformer_block_apply(
                    self.layer_config, layer, h, None, causal=True,
                    train=train, dropout_rng=rng)
            return h

        out = gpipe(stage_fn, layers, microbatches, stage, broadcast=False,
                    dtype=dtype, device=device, sizes=sizes)
        if not stage.last:
            # no value; the graph that runs this stage's backward
            out = out.reshape(-1)[:1].float().sum() * 0.0
            if labels is None:
                out = out + torch.zeros(b, s, cfg.vocab_padded,
                                        device=device)
            return pipe_broadcast(out, stage)
        x = layer_norm_apply(self.layer_config, out.reshape(b, s, -1),
                             self.ln_f.weight, self.ln_f.bias)
        if labels is None:
            return pipe_broadcast(self._logits(x).float(), stage)
        return pipe_broadcast(self._lm_loss(x, labels).float(), stage)

    @staticmethod
    def _next_labels(labels, line):
        """Each local position's next-token label: ``labels[:, 1:]`` and
        the next rank's first label (:data:`NO_LABEL` on the last rank)."""
        first = labels[:, :1].contiguous()
        flat = torch.empty(first.numel() * line.size, dtype=first.dtype,
                           device=first.device)
        dist_lib.all_gather(flat, first.reshape(-1), line.group)
        firsts = flat.view(line.size, *first.shape)
        nxt = (firsts[line.rank + 1] if line.rank + 1 < line.size
               else torch.full_like(first, NO_LABEL))
        return torch.cat([labels[:, 1:], nxt], dim=1)

    def _line_count(self, line, count):
        """The loss's divisor under sequence parallelism: the line's count
        of labels, then the engine's ``count_fn`` (the data group's)."""
        total = count.detach().clone()
        dist_lib.all_reduce(total, line.group)
        if self.count_fn is not None:
            return self.count_fn(total)
        return total.clamp(min=1)
