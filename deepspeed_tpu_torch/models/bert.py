"""BERT: config presets, the encoder, and the pretraining and QA heads.

Port of deepspeed_tpu/models/bert.py: the same ``BertConfig`` fields and
size presets (the vocab padded to a multiple of 128: BERT-large's 30528
becomes 30592), embeddings (word + position + token type, LayerNorm,
dropout) -> a Python loop over post-LN blocks (ops/transformer.py,
``causal=False``; the JAX package scans a stacked layer) under the
additive padding mask ``where(mask > 0, 0, -1e30)``, then the pooler
``tanh(dense(x[:, 0]))``. ``BertForPreTraining`` adds the masked-LM head
(dense, tanh-approx GeLU, LayerNorm, the decoder tied to the word table
plus ``mlm_bias``) and next-sentence prediction; ``BertForQuestionAnswering``
the start/end span head. Both return the scalar loss when given labels,
the training engine's model contract.

Attention routes as everywhere in the port (ops/attention.py): the
flash kernels, non-causal with the padding mask as a per-key validity
vector and in-kernel dropout, at ``seq >= FLASH_MIN_SEQ``; the plain
reference below. ``use_flash=False`` sends every attention call to the
plain reference (``mha_reference``), as the JAX model's switch does.
``lora_rank > 0`` gives every block LoRA factors
(ops/transformer.py:apply_lora), as GPT-2's. The memory-mode flags (``normalize_invertible``,
``gelu_checkpoint``, ``attn_dropout_checkpoint``) turn on remat of every
block with ``remat_policy``, as in the JAX model.

Parameter names: ``bert.embeddings.{word_embeddings, position_embeddings,
token_type_embeddings, LayerNorm.weight, LayerNorm.bias}``,
``bert.encoder.layer.<i>.<the 12-tensor block layout>``,
``bert.pooler.{weight, bias}``; pretraining adds ``transform.*``,
``transform_ln.*``, ``mlm_bias`` and ``nsp.*``, QA ``qa_outputs.*``. Sorted
by name they fall in the JAX tree's order, so LAMB's per-group trust
ratios (ops/optimizers.py:param_groups) line up with the JAX leaves.
``convert.py:bert_params_from_jax`` carries JAX weights across.

Data parallel (``configure_data_parallel`` of the task models, set by
the training engine): the rank decorrelates dropout, every
cross-entropy divides by the data group's count of valid labels (which
differs between ranks on padded batches), at ZeRO stage 3 the encoder's
blocks run through the gather stack of models/stack.py, and with the
engine's ``sparse_gradients`` the word table's lookup gradient goes
through runtime/sparse.py.

Sequence parallelism (``configure_sequence_parallel`` of the task
models, set by the training engine at a sequence axis above 1): the
inputs are a rank's chunk of the tokens, the positions offset by the
chunk, attention runs over the line (ring or Ulysses) with the padding
mask's key validity, the masked-LM loss divides by the line's and data
group's count of labels, and the next-sentence loss is rank 0's (it
holds the [CLS] position); the line sums the shares. Question answering
joins the span logits over the line, and each rank takes the whole span
cross-entropy (its backward keeps the rank's positions).

Refused when the model is built: the config fields ``sparse_gradients``,
``zero3_gather`` and ``mesh`` (the training engine arms all three
itself: through ``configure_data_parallel`` and
``configure_sequence_parallel``).
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config.config import DeepSpeedConfigError
from ..ops.attention import NEG_INF
from ..ops.cross_entropy import cross_entropy_ignore_index
from ..ops.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
    DropoutRNG,
    dropout,
    layer_norm_apply,
    transformer_block_apply,
)
from ..parallel.tensor import gather_from_region, reduce_from_region
from ..runtime import dist as dist_lib
from ..runtime.sparse import sparse_embedding_lookup
from ..utils.device import resolve_device
from .stack import zero3_stack


def _round_up(x, m):
    return (x + m - 1) // m * m


@dataclasses.dataclass(unsafe_hash=True)
class BertConfig:
    vocab_size: int = 30528
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = False  # classic BERT is post-LN
    use_flash: bool = True
    # the reference's memory modes: any of them remats every block
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    attn_dropout_checkpoint: bool = False
    remat_policy: str = "full"
    # LoRA factors on every block (ops/transformer.py:apply_lora)
    lora_rank: int = 0
    lora_alpha: float = 0.0
    lora_targets: tuple = ()  # () => every LORA_TARGETS matrix
    # fields the model refuses when it is built (check_ported)
    mesh: object = dataclasses.field(default=None, hash=False, compare=False)
    sparse_gradients: bool = dataclasses.field(
        default=False, hash=False, compare=False)
    zero3_gather: object = dataclasses.field(
        default=None, hash=False, compare=False)

    @staticmethod
    def bert_large(**kw):
        return BertConfig(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, **kw,
        )

    @staticmethod
    def bert_base(**kw):
        return BertConfig(**kw)

    @property
    def vocab_padded(self):
        return _round_up(self.vocab_size, 128)

    @property
    def remat(self):
        """Whether the blocks remat (any memory-mode flag), as the
        training engine reads it."""
        return self.layer_config().use_remat

    def layer_config(self):
        return DeepSpeedTransformerConfig(
            hidden_size=self.hidden_size,
            heads=self.num_attention_heads,
            intermediate_size=self.intermediate_size,
            attn_dropout_ratio=self.attention_probs_dropout_prob,
            hidden_dropout_ratio=self.hidden_dropout_prob,
            initializer_range=self.initializer_range,
            pre_layer_norm=self.pre_layer_norm,
            layer_norm_eps=self.layer_norm_eps,
            normalize_invertible=self.normalize_invertible,
            gelu_checkpoint=self.gelu_checkpoint,
            attn_dropout_checkpoint=self.attn_dropout_checkpoint,
            remat_policy=self.remat_policy,
            lora_rank=self.lora_rank,
            lora_alpha=self.lora_alpha,
            lora_targets=tuple(self.lora_targets),
        )

    def check_ported(self):
        """Raise for a JAX config field the port's BERT takes from the
        training engine instead (``sparse_gradients``, ``zero3_gather``,
        ``mesh``)."""
        if self.sparse_gradients:
            raise DeepSpeedConfigError(
                "BERT with sparse_gradients set on its config: the port's "
                "training engine arms the word table's sparse gradient from "
                "its own sparse_gradients key (the JAX config field rides "
                "the JAX model's device mesh, which the port's models do "
                "not hold)")
        if self.zero3_gather is not None:
            raise DeepSpeedConfigError(
                "BERT with zero3_gather set on its config: ZeRO stage 3 in "
                "the port's training engine arms the encoder's gather itself "
                "(the JAX config field rides the JAX model's device mesh, "
                "which the port's models do not hold)")
        if self.mesh is not None:
            raise DeepSpeedConfigError(
                "BERT with a mesh set on its config: the port's training "
                "engine arms the sequence axis itself "
                "(configure_sequence_parallel; the JAX config field holds "
                "a jax.sharding.Mesh, which the port's models do not "
                "hold)")


class _LayerNorm(nn.Module):
    """A LayerNorm's parameters (``weight``, ``bias``); applied through
    ``layer_norm_apply`` (float32 statistics)."""

    def __init__(self, width, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(width, device=device,
                                             dtype=dtype))


class _Dense(nn.Module):
    """A dense layer's parameters, ``weight`` [out, in] and ``bias``."""

    def __init__(self, din, dout, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dout, din, device=device,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dout, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class BertEmbeddings(nn.Module):
    def __init__(self, config, device, dtype):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.word_embeddings = nn.Parameter(torch.empty(
            config.vocab_padded, h, device=device, dtype=dtype))
        self.position_embeddings = nn.Parameter(torch.empty(
            config.max_position_embeddings, h, device=device, dtype=dtype))
        self.token_type_embeddings = nn.Parameter(torch.empty(
            config.type_vocab_size, h, device=device, dtype=dtype))
        self.LayerNorm = _LayerNorm(h, device, dtype)
        self.sparse_lookup = None

    def forward(self, layer_cfg, input_ids, token_type_ids=None, rng=None,
                first=0):
        """[B, S] ids -> [B, S, H]: word + position (from position
        ``first``: a sequence rank's chunk) (+ token type), the LayerNorm,
        then the hidden dropout from ``rng``."""
        s = input_ids.shape[1]
        word = (self.word_embeddings[input_ids] if self.sparse_lookup is None
                else sparse_embedding_lookup(self.word_embeddings, input_ids,
                                             *self.sparse_lookup))
        x = word + self.position_embeddings[None, first:first + s]
        if token_type_ids is not None:
            x = x + self.token_type_embeddings[token_type_ids]
        x = layer_norm_apply(layer_cfg, x, self.LayerNorm.weight,
                             self.LayerNorm.bias)
        return dropout(x, self.config.hidden_dropout_prob, rng)


class BertEncoder(nn.Module):
    """The blocks, one module per layer (``layer.<i>``)."""

    def __init__(self, config, layer_cfg, device, dtype):
        super().__init__()
        self.layer = nn.ModuleList(
            DeepSpeedTransformerLayer(layer_cfg, device, dtype)
            for _ in range(config.num_hidden_layers)
        )
        self.zero3_gather = None

    def forward(self, layer_cfg, x, additive_mask, train, rng, use_flash):
        if self.zero3_gather is not None:
            return zero3_stack(
                self.zero3_gather, layer_cfg, list(self.layer), x,
                lambda cfg, p, h, r: transformer_block_apply(
                    cfg, p, h, additive_mask, causal=False, train=train,
                    dropout_rng=r, use_flash=use_flash),
                rng if train else None)
        for layer in self.layer:
            x = transformer_block_apply(
                layer_cfg, layer, x, additive_mask, causal=False,
                train=train, dropout_rng=rng, use_flash=use_flash,
            )
        return x


def additive_mask(attention_mask):
    """[B, S] padding mask (nonzero = attend) -> the additive [B, 1, 1, S]
    float32 mask: 0 where attended, -1e30 elsewhere."""
    if attention_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=attention_mask.device)
    return torch.where(attention_mask[:, None, None, :] > 0, zero,
                       torch.full_like(zero, NEG_INF))


class BertModel(nn.Module):
    def __init__(self, config, device=None, dtype=torch.float32):
        super().__init__()
        config.check_ported()
        device = resolve_device(device)
        self.config = config
        self.layer_config = config.layer_config()
        self.embeddings = BertEmbeddings(config, device, dtype)
        self.encoder = BertEncoder(config, self.layer_config, device, dtype)
        self.pooler = _Dense(config.hidden_size, config.hidden_size, device,
                             dtype)

    @torch.no_grad()
    def reset_parameters(self, gen):
        std = self.config.initializer_range
        emb = self.embeddings
        for p in (emb.word_embeddings, emb.position_embeddings,
                  emb.token_type_embeddings):
            p.normal_(0.0, std, generator=gen)
        for layer in self.encoder.layer:
            layer.reset_parameters(gen)
        self.pooler.weight.normal_(0.0, std, generator=gen)
        # drawn after every base tensor, as GPT-2's
        for layer in self.encoder.layer:
            layer.reset_lora_parameters(gen)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                train=False, rng=None):
        """``(sequence output [B, S, H], pooled [B, H], word table)``; at a
        sequence axis the rank's chunk of the tokens, and the pooled first
        token is meaningful on the line's rank 0 only (it holds the
        [CLS] position)."""
        rng = rng if train else None
        line = self.layer_config.sequence_parallel
        first = 0 if line is None else line.rank * input_ids.shape[1]
        x = self.embeddings(self.layer_config, input_ids, token_type_ids, rng,
                            first)
        x = self.encoder(self.layer_config, x, additive_mask(attention_mask),
                         train, rng, self.config.use_flash)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled, self.embeddings.word_embeddings


class _BertHead(nn.Module):
    """Shared by the two task models: the encoder under ``bert``, the
    data-parallel settings, the dropout generator of a training forward,
    and the initializers."""

    #: the stage-3 stack's tensors: ``bert.encoder.layer.<i>.<tensor>``
    zero3_block_prefix = "bert.encoder.layer."
    data_rank = 0
    count_fn = None
    sequence_parallel = None

    def configure_data_parallel(self, data_rank=0, count_fn=None,
                                zero3=None, sparse=None):
        """As GPT2LMHeadModel.configure_data_parallel: the rank, the
        losses' divisor, the stage-3 arming of the encoder and the sparse
        word-table gradient."""
        self.data_rank = int(data_rank)
        self.count_fn = count_fn
        self.bert.encoder.zero3_gather = zero3
        self.bert.embeddings.sparse_lookup = sparse

    def configure_sequence_parallel(self, line=None):
        """The sequence-parallel setting the training engine hands the
        model: ``line`` (parallel/sequence.py:SequenceParallel, or None):
        the inputs are then this rank's chunk of the tokens, attention runs
        over the line (ring or Ulysses, with the padding mask's key
        validity) and the losses are the line's (the JAX BERT runs
        sequence-parallel attention through its mesh)."""
        if line is not None and line.size <= 1:
            line = None
        self.sequence_parallel = line
        self.bert.layer_config.sequence_parallel = line

    def _rng(self, input_ids, train, dropout_seed):
        cfg = self.config
        if (train and dropout_seed is not None
                and (cfg.hidden_dropout_prob > 0
                     or cfg.attention_probs_dropout_prob > 0)):
            # decorrelated from the other data and sequence ranks'
            line = self.sequence_parallel
            index = (self.data_rank if line is None
                     else self.data_rank * line.size + line.rank)
            return DropoutRNG(dropout_seed, input_ids.device, index)
        return None

    def _line_count(self, count):
        """The masked-LM loss's divisor at a sequence axis: the line's
        count of labels, then the engine's ``count_fn`` (the data
        group's)."""
        total = count.detach().clone()
        dist_lib.all_reduce(total, self.sequence_parallel.group)
        if self.count_fn is not None:
            return self.count_fn(total)
        return total.clamp(min=1)

    @torch.no_grad()
    def _reset_dense(self, gen, *denses):
        for d in denses:
            d.weight.normal_(0.0, self.config.initializer_range,
                             generator=gen)
            d.bias.zero_()


class BertForPreTraining(_BertHead):
    """Masked-LM + next-sentence pretraining. ``forward(input_ids,
    attention_mask, token_type_ids, masked_lm_labels,
    next_sentence_label, train=, dropout_seed=)`` returns the scalar loss:
    the masked-LM cross-entropy over labels that are not -1/-100, plus the
    NSP cross-entropy when its labels are given.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    Weights start N(0, initializer_range) from ``seed`` (biases zero,
    norms one): the JAX model's initializers, not its random stream."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        h = config.hidden_size
        self.bert = BertModel(config, device, dtype)
        self.transform = _Dense(h, h, device, dtype)
        self.transform_ln = _LayerNorm(h, device, dtype)
        self.mlm_bias = nn.Parameter(torch.zeros(config.vocab_padded,
                                                 device=device, dtype=dtype))
        self.nsp = _Dense(h, 2, device, dtype)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        gen = torch.Generator(device=self.mlm_bias.device).manual_seed(
            int(seed))
        self.bert.reset_parameters(gen)
        self._reset_dense(gen, self.transform, self.nsp)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                masked_lm_labels=None, next_sentence_label=None, train=False,
                dropout_seed=None):
        seq_out, pooled, word = self.bert(
            input_ids, attention_mask, token_type_ids, train,
            self._rng(input_ids, train, dropout_seed))
        h = F.gelu(self.transform(seq_out), approximate="tanh")
        h = layer_norm_apply(self.bert.layer_config, h,
                             self.transform_ln.weight, self.transform_ln.bias)
        logits = F.linear(h, word, self.mlm_bias)
        line = self.sequence_parallel
        loss = torch.zeros((), dtype=torch.float32, device=input_ids.device)
        if masked_lm_labels is not None:
            loss = loss + cross_entropy_ignore_index(
                logits, masked_lm_labels, count_fn=(
                    self.count_fn if line is None else self._line_count))
        if next_sentence_label is not None and (line is None
                                                or line.rank == 0):
            # at a sequence axis rank 0 holds the [CLS] position
            loss = loss + cross_entropy_ignore_index(
                self.nsp(pooled), next_sentence_label,
                count_fn=self.count_fn)
        # the line's sum of its ranks' shares (each rank backpropagates
        # the whole loss through its own tokens)
        return loss if line is None else reduce_from_region(loss, line)


class BertForQuestionAnswering(_BertHead):
    """Extractive QA: start/end span logits over the sequence.
    ``forward(input_ids, attention_mask, token_type_ids, start_positions,
    end_positions, train=, dropout_seed=)`` returns the scalar loss (the
    mean of the start and end cross-entropies) when both positions are
    given, else ``(start_logits, end_logits)``, each [B, S]. ``device``
    and ``seed`` as :class:`BertForPreTraining`."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BertModel(config, device, dtype)
        self.qa_outputs = _Dense(config.hidden_size, 2, device, dtype)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        gen = torch.Generator(
            device=self.qa_outputs.weight.device).manual_seed(int(seed))
        self.bert.reset_parameters(gen)
        self._reset_dense(gen, self.qa_outputs)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                start_positions=None, end_positions=None, train=False,
                dropout_seed=None):
        seq_out, _, _ = self.bert(
            input_ids, attention_mask, token_type_ids, train,
            self._rng(input_ids, train, dropout_seed))
        logits = self.qa_outputs(seq_out)  # [B, S, 2]
        # at a sequence axis the line's logits joined in sequence order
        # (the backward keeps this rank's positions): every rank takes the
        # whole span cross-entropy
        start_logits, end_logits = (
            gather_from_region(logits[..., i].contiguous(),
                               self.sequence_parallel) for i in (0, 1))
        if start_positions is None or end_positions is None:
            return start_logits, end_logits
        return 0.5 * (
            cross_entropy_ignore_index(start_logits, start_positions,
                                       count_fn=self.count_fn)
            + cross_entropy_ignore_index(end_logits, end_positions,
                                         count_fn=self.count_fn))
