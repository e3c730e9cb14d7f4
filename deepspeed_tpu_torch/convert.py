"""Carry the JAX package's GPT-2 and BERT parameters into the port's
modules.

The JAX tree (``GPT2LMHeadModel.init(...)["params"]``, as numpy arrays)
is ``transformer/{wte, wpe, ln_f/{scale, bias}, h/<12 keys>}``: the block
parameters are stacked over layers (``[L, ...]``) and the weight matrices
are ``[in, out]`` (``x @ W``). The port keeps one module per layer and
stores the base weights ``[out, in]`` (``F.linear``): :func:`params_from_jax`
is the only place that transposes them. The LoRA factors keep the JAX
orientation, A ``[in, r]`` and B ``[r, out]`` (delta = ``(x @ A) @ B``),
in the adapter pool and in per-layer parameters alike, so
:func:`adapters_from_jax` only unstacks layers and never transposes.
:func:`bert_params_from_jax` does for BERT what :func:`params_from_jax`
does for GPT-2: ``bert/encoder/layer/<12 keys>`` unstacked into
``bert.encoder.layer.<i>.<key>`` (matrices transposed; a LoRA model's
``<target>_lora_a``/``_lora_b`` factors carried untransposed), flax's Dense
``kernel`` [in, out] into ``weight`` [out, in] and LayerNorm ``scale``
into ``weight``.

Tensor parallelism: ``params_from_jax(tree, specs, model_rank, mp)``
gives one model rank's shards, cut by parallel/tensor.py (the strided qkv
slice included) as the training engine and the checkpoints cut them.

Mixture-of-Experts: the JAX MoE block's ``h/moe/{gate_w, expert_in_w,
expert_in_b, expert_out_w, expert_out_b}`` (stacked on the layers axis,
``[L, E, ...]``) become ``h.<i>.moe.*`` in the JAX orientation (the expert
products are batched matmuls of ``[E, M, I]``/``[E, I, M]``, not
``F.linear``); ``params_from_jax(tree, data_rank=r, dp=n)`` keeps expert
rank ``r``'s ``E / n`` experts, as the training engine cuts them.
"""

import numpy as np
import torch

from .parallel.tensor import model_dim, shard_for_rank

# block weight matrices: [L, in, out] in JAX, [out, in] per layer here
_MATRICES = ("attn_qkvw", "attn_ow", "inter_w", "output_w")


def _tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _unstack_blocks(stacked_tree, prefix, state):
    """A JAX block tree stacked over layers into ``prefix.<i>.<key>`` (a
    sub-tree, the MoE block's ``moe``, into ``prefix.<i>.<sub>.<key>``,
    untransposed)."""
    for name, stacked in stacked_tree.items():
        if isinstance(stacked, dict):
            for key, sub in stacked.items():
                sub = np.asarray(sub)
                for i in range(sub.shape[0]):
                    state[f"{prefix}.{i}.{name}.{key}"] = _tensor(sub[i])
            continue
        stacked = np.asarray(stacked)
        for i in range(stacked.shape[0]):
            leaf = stacked[i]
            if name in _MATRICES:
                leaf = leaf.T
            state[f"{prefix}.{i}.{name}"] = _tensor(leaf)


def params_from_jax(tree, specs=None, model_rank=0, mp=1, data_rank=0,
                    dp=1):
    """JAX GPT-2 parameter tree (numpy leaves) -> a state dict for
    :class:`deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel` (float32 CPU
    tensors; ``load_state_dict`` casts and moves them). With ``specs``
    (the port's ``partition_specs``) and ``mp`` > 1: model rank
    ``model_rank``'s shards (a LoRA factor without a spec stays whole).
    With ``dp`` > 1: expert rank ``data_rank``'s experts of every MoE
    block."""
    tp = tree["transformer"]
    state = {
        "wte": _tensor(tp["wte"]),
        "wpe": _tensor(tp["wpe"]),
        "ln_f.weight": _tensor(tp["ln_f"]["scale"]),
        "ln_f.bias": _tensor(tp["ln_f"]["bias"]),
    }
    _unstack_blocks(tp["h"], "h", state)
    if specs is not None and mp > 1:
        state = {n: shard_for_rank(n, t, model_dim(specs.get(n)), mp,
                                   model_rank).contiguous()
                 for n, t in state.items()}
    if dp > 1:
        for n, t in state.items():
            if n.rpartition(".")[2].startswith("expert_"):
                k = t.shape[0] // dp
                state[n] = t[data_rank * k:(data_rank + 1) * k].contiguous()
    return state


def _flax_module(tree, prefix, state):
    """A flax Dense (``kernel``, ``bias``) or LayerNorm (``scale``,
    ``bias``) into ``prefix.weight`` / ``prefix.bias``."""
    if "kernel" in tree:
        state[f"{prefix}.weight"] = _tensor(np.asarray(tree["kernel"]).T)
    else:
        state[f"{prefix}.weight"] = _tensor(tree["scale"])
    state[f"{prefix}.bias"] = _tensor(tree["bias"])


def bert_params_from_jax(tree):
    """JAX BERT parameter tree (``BertForPreTraining`` or
    ``BertForQuestionAnswering``, numpy leaves) -> a state dict for the
    port's model of the same kind (float32 CPU tensors)."""
    bert = tree["bert"]
    emb = bert["embeddings"]
    state = {
        f"bert.embeddings.{k}": _tensor(emb[k])
        for k in ("word_embeddings", "position_embeddings",
                  "token_type_embeddings")
    }
    _flax_module(emb["LayerNorm"], "bert.embeddings.LayerNorm", state)
    _unstack_blocks(bert["encoder"]["layer"], "bert.encoder.layer", state)
    _flax_module(bert["pooler"], "bert.pooler", state)
    for head in ("transform", "transform_ln", "nsp", "qa_outputs"):
        if head in tree:
            _flax_module(tree[head], head, state)
    if "mlm_bias" in tree:
        state["mlm_bias"] = _tensor(tree["mlm_bias"])
    return state


def adapters_from_jax(tree, specs=None, model_rank=0, mp=1):
    """JAX adapter tree (``init_lora_params`` output, or a LoRA fine-tune
    engine's ``engine.params``, as numpy) -> the port's adapter state dict
    ``{"h.<i>.<target>_lora_a": [in, r], "h.<i>.<target>_lora_b": [r,
    out]}`` (float32 CPU tensors): the layer stacks split per layer, the
    factors untransposed; with ``specs`` and ``mp`` > 1 model rank
    ``model_rank``'s shards, as :func:`params_from_jax`."""
    state = {}
    for name, stacked in tree["transformer"]["h"].items():
        if not name.endswith(("_lora_a", "_lora_b")):
            continue
        stacked = np.asarray(stacked)
        for i in range(stacked.shape[0]):
            n = f"h.{i}.{name}"
            t = torch.from_numpy(np.array(stacked[i], dtype=np.float32))
            if specs is not None and mp > 1:
                t = shard_for_rank(n, t, model_dim(specs.get(n)), mp,
                                   model_rank).contiguous()
            state[n] = t
    return state
