"""GPT-2 for serving: config presets and the eval-mode LM.

Port of deepspeed_tpu/models/gpt2.py for the serving slice: the same
``GPT2Config`` fields that decode reads and the same size presets, and a
``GPT2LMHeadModel`` whose eval forward is embeddings -> a Python loop
over the blocks (ops/transformer.py) -> ``ln_f`` -> the tied LM head.
The training fields (dropout, pipeline, MoE, remat, sparse gradients,
ZeRO-3) wait for the training slice.
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
    layer_norm_apply,
    transformer_block_apply,
)
from ..utils.device import resolve_device


def _round_up(x, multiple):
    return -(-x // multiple) * multiple


@dataclasses.dataclass(unsafe_hash=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5

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
            initializer_range=self.initializer_range,
            pre_layer_norm=True,  # GPT-2 is pre-LN
            layer_norm_eps=self.layer_norm_eps,
        )


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with a tied LM head. Parameters: ``wte`` [vocab_padded,
    n_embd], ``wpe`` [n_positions, n_embd], ``h.<i>.*`` (the 12-tensor
    block layout, weights [out, in]), ``ln_f.weight``/``ln_f.bias``.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    Weights start N(0, initializer_range) from ``seed`` (biases zero,
    norms one) — the JAX model's initializers, not its random stream."""

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
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        gen = torch.Generator(device=self.wte.device).manual_seed(int(seed))
        std = self.config.initializer_range
        self.wte.normal_(0.0, std, generator=gen)
        self.wpe.normal_(0.0, std, generator=gen)
        for layer in self.h:
            layer.reset_parameters(gen)
        self.ln_f.reset_parameters()

    def final_norm_and_logits(self, x):
        """``ln_f`` (statistics and epsilon in float32) and the tied head:
        [..., n_embd] -> [..., vocab_padded] logits in x's dtype."""
        x = layer_norm_apply(
            self.layer_config, x, self.ln_f.weight, self.ln_f.bias
        )
        return F.linear(x, self.wte)

    @torch.no_grad()
    def forward(self, input_ids):
        """Eval forward: ``input_ids`` [B, S] -> logits [B, S,
        vocab_padded]."""
        s = input_ids.shape[1]
        x = self.wte[input_ids] + self.wpe[None, :s, :]
        for layer in self.h:
            x = transformer_block_apply(
                self.layer_config, layer, x, None, causal=True
            )
        return self.final_norm_and_logits(x)
