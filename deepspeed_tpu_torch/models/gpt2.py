"""GPT-2: config presets and the LM, for serving and training.

Port of deepspeed_tpu/models/gpt2.py: the same ``GPT2Config`` fields and
size presets, and a ``GPT2LMHeadModel`` whose forward is embeddings
(with dropout in training) -> a Python loop over the blocks
(ops/transformer.py; the JAX package scans a stacked layer) -> ``ln_f``
-> the tied LM head, or with ``labels`` the scalar next-token loss
through the blocked LM-head cross-entropy (ops/cross_entropy.py).
``remat`` (with ``remat_policy``) checkpoints every block as the JAX
model does (ops/transformer.py: the layer config's memory mode).
``moe_experts`` and ``pipeline_stages`` are carried so that the training
engine can refuse them (not ported). Data parallel
(:meth:`GPT2LMHeadModel.configure_data_parallel`, set by the training
engine): the rank decorrelates dropout, the loss divides by the data
group's token count, at ZeRO stage 3 the blocks run through the gather
stack of models/stack.py, and with the engine's ``sparse_gradients`` the
``wte`` lookup's gradient goes through runtime/sparse.py. ``lora_rank > 0`` gives every block
LoRA factors (ops/transformer.py:apply_lora), which the training and
eval forward apply; the training engine's ``adapters`` block arms it.
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cross_entropy import blocked_lm_head_loss, cross_entropy_ignore_index
from ..ops.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
    DropoutRNG,
    dropout,
    layer_norm_apply,
    transformer_block_apply,
)
from ..utils.device import resolve_device
from ..runtime.sparse import sparse_embedding_lookup
from .stack import zero3_stack


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
    # JAX-package features the port does not have yet (the training
    # engine refuses a config that turns them on)
    moe_experts: int = 0
    pipeline_stages: int = 1
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


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with a tied LM head. Parameters: ``wte`` [vocab_padded,
    n_embd], ``wpe`` [n_positions, n_embd], ``h.<i>.*`` (the 12-tensor
    block layout, weights [out, in]), ``ln_f.weight``/``ln_f.bias``, and
    with ``config.lora_rank > 0`` the blocks' ``h.<i>.<target>_lora_a``
    [in, r] / ``_lora_b`` [r, out].

    ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    Weights start N(0, initializer_range) from ``seed`` (biases zero,
    norms one), then LoRA A ~ N(0, initializer_range) and B = 0 — the JAX
    model's initializers, not its random stream."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
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
        self.h = nn.ModuleList(
            DeepSpeedTransformerLayer(self.layer_config, device, dtype)
            for _ in range(config.n_layer)
        )
        self.ln_f = nn.LayerNorm(
            e, eps=config.layer_norm_eps, device=device, dtype=dtype
        )
        self.configure_data_parallel()
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
        return F.linear(x, self.wte)

    def hidden_states(self, input_ids, train=False, dropout_rng=None):
        """Embeddings -> the blocks -> ``ln_f``: [B, S, n_embd]. In training
        with a ``dropout_rng``, the embedding dropout and each block's
        three dropout streams are drawn from it."""
        s = input_ids.shape[1]
        rng = dropout_rng if train else None
        emb = (self.wte[input_ids] if self.sparse_lookup is None
               else sparse_embedding_lookup(self.wte, input_ids,
                                            *self.sparse_lookup))
        x = dropout(emb + self.wpe[None, :s, :], self.config.dropout, rng)
        if self.zero3_gather is not None:
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
        )

    def forward(self, input_ids, labels=None, train=False, dropout_seed=None):
        """``input_ids`` [B, S]. Without ``labels``: logits [B, S,
        vocab_padded] (eval mode runs without autograd, the serving
        path). With ``labels`` (usually ``input_ids``; the shift happens
        here): the scalar mean next-token loss, logits[:, :-1] against
        labels[:, 1:]. ``train`` with a ``dropout_seed`` applies dropout
        (:class:`~deepspeed_tpu_torch.ops.transformer.DropoutRNG`)."""
        if labels is None and not train:
            with torch.no_grad():
                return F.linear(self.hidden_states(input_ids), self.wte)
        rng = None
        if train and dropout_seed is not None and self.config.dropout > 0:
            rng = DropoutRNG(dropout_seed, input_ids.device, self.data_rank)
        x = self.hidden_states(input_ids, train, rng)
        if labels is None:
            return F.linear(x, self.wte)
        if self.config.ce_block_rows > 0:
            return blocked_lm_head_loss(
                x[:, :-1], self.wte, labels[:, 1:],
                block_rows=self.config.ce_block_rows, count_fn=self.count_fn,
            )
        return cross_entropy_ignore_index(
            F.linear(x[:, :-1], self.wte), labels[:, 1:],
            count_fn=self.count_fn,
        )
