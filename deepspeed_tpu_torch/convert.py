"""Carry the JAX package's GPT-2 parameters into the port's modules.

The JAX tree (``GPT2LMHeadModel.init(...)["params"]``, as numpy arrays)
is ``transformer/{wte, wpe, ln_f/{scale, bias}, h/<12 keys>}``: the block
parameters are stacked over layers (``[L, ...]``) and the weight matrices
are ``[in, out]`` (``x @ W``). The port keeps one module per layer and
stores the base weights ``[out, in]`` (``F.linear``): :func:`params_from_jax`
is the only place that transposes them. The LoRA factors keep the JAX
orientation, A ``[in, r]`` and B ``[r, out]`` (delta = ``(x @ A) @ B``),
in the adapter pool and in per-layer parameters alike, so
:func:`adapters_from_jax` only unstacks layers and never transposes.
"""

import numpy as np
import torch

# block weight matrices: [L, in, out] in JAX, [out, in] per layer here
_MATRICES = ("attn_qkvw", "attn_ow", "inter_w", "output_w")


def params_from_jax(tree):
    """JAX GPT-2 parameter tree (numpy leaves) -> a state dict for
    :class:`deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel` (float32 CPU
    tensors; ``load_state_dict`` casts and moves them)."""
    tp = tree["transformer"]

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {
        "wte": tensor(tp["wte"]),
        "wpe": tensor(tp["wpe"]),
        "ln_f.weight": tensor(tp["ln_f"]["scale"]),
        "ln_f.bias": tensor(tp["ln_f"]["bias"]),
    }
    for name, stacked in tp["h"].items():
        stacked = np.asarray(stacked)
        for i in range(stacked.shape[0]):
            leaf = stacked[i]
            if name in _MATRICES:
                leaf = leaf.T
            state[f"h.{i}.{name}"] = tensor(leaf)
    return state


def adapters_from_jax(tree):
    """JAX adapter tree (``init_lora_params`` output, or a LoRA fine-tune
    engine's ``engine.params``, as numpy) -> the port's adapter state dict
    ``{"h.<i>.<target>_lora_a": [in, r], "h.<i>.<target>_lora_b": [r,
    out]}`` (float32 CPU tensors): the layer stacks split per layer, the
    factors untransposed."""
    state = {}
    for name, stacked in tree["transformer"]["h"].items():
        if not name.endswith(("_lora_a", "_lora_b")):
            continue
        stacked = np.asarray(stacked)
        for i in range(stacked.shape[0]):
            state[f"h.{i}.{name}"] = torch.from_numpy(
                np.array(stacked[i], dtype=np.float32)
            )
    return state
