"""LoRA adapter state dicts: init, split/merge, pool stacking.

Port of deepspeed_tpu/adapters/lora.py over the port's FLAT state dicts
(``h.<i>.attn_qkvw_lora_a``) instead of nested pytrees. The low-rank math
lives in ``ops/transformer.py`` (``apply_lora`` inside every block path);
this module owns the bookkeeping around it:

  init   — :func:`init_lora_params` grows fresh factors beside a base
           state dict (A ~ N(0, std), B = 0: the initial delta is exactly
           zero, so fine-tuning starts from the base model).
  split  — :func:`split_lora_params` separates a mixed state dict into
           ``(base, adapters)`` by the ``*_lora_a`` / ``*_lora_b`` names.
           The training engine freezes the base and hands ONLY the adapter
           tensors to the optimizer.
  merge  — :func:`merge_lora_params` overlays adapters back onto a base.
  stacks — :func:`adapter_layer_stacks` stacks a fine-tuned adapter's
           per-layer factors into the ``{target: (A [L, in, r], B [L, r,
           out])}`` rows the serving engine writes into its adapter pool.

The factors keep the JAX orientation, A ``[in, r]`` and B ``[r, out]``
(delta = ``(x @ A) @ B``); the base weights are ``[out, in]``.
"""

import re

import torch

from ..ops.transformer import (  # noqa: F401  (re-exported)
    LORA_TARGET_DIMS,
    LORA_TARGETS,
    lora_scaling,
    resolve_lora_targets,
)

_LORA_SUFFIXES = ("_lora_a", "_lora_b")
_LAYER_KEY = re.compile(r"^h\.(\d+)\.(\w+)_lora_([ab])$")


def is_lora_name(name):
    """True for the adapter tensor names the transformer layer creates."""
    return str(name).endswith(_LORA_SUFFIXES)


def split_lora_params(state):
    """Split a flat state dict into ``(base, adapters)`` by name. Tensors
    are returned by reference — no copies."""
    base, adapters = {}, {}
    for k, v in state.items():
        (adapters if is_lora_name(k) else base)[k] = v
    return base, adapters


def merge_lora_params(base, adapters):
    """Overlay an adapter state dict onto a base state dict (a new dict,
    shared tensors)."""
    return {**base, **adapters}


def init_lora_params(base_state, rank, targets=None, generator=None,
                     stddev=0.02, dtype=torch.float32):
    """Fresh adapter state dict shaped to ``base_state``'s blocks.

    Every block weight ``h.<i>.<target>`` ([out, in]) gains
    ``h.<i>.<target>_lora_a`` [in, rank] ~ N(0, ``stddev``) and
    ``_lora_b`` [rank, out] = 0, so the initial delta is exactly zero.
    A is drawn on the CPU from ``generator`` (a CPU ``torch.Generator``;
    default seed 0) in name order and moved to the base tensor's device,
    so a seed gives the same factors on every device."""
    rank = int(rank)
    if rank < 1:
        raise ValueError(f"LoRA rank must be >= 1, got {rank}")
    targets = resolve_lora_targets(targets)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    out = {}
    for name, w in base_state.items():
        parts = name.split(".")
        if len(parts) != 3 or parts[0] != "h" or parts[2] not in targets:
            continue
        dout, din = w.shape
        a = torch.randn((din, rank), generator=generator) * stddev
        out[f"{name}_lora_a"] = a.to(device=w.device, dtype=dtype)
        out[f"{name}_lora_b"] = torch.zeros(
            (rank, dout), device=w.device, dtype=dtype
        )
    if not out:
        raise ValueError(
            f"no LoRA target matrices {list(targets)} found in the state "
            "dict — is this a GPT-2 state dict (h.<i>.<name> keys)?"
        )
    return out


def adapter_layer_stacks(adapter_state, targets=None):
    """Stack an adapter state dict's per-layer factors into ``{target: (A
    [layers, in, r], B [layers, r, out])}`` pool rows for the serving
    engine. Raises when a target's factors are missing for a layer, a
    layer is missing, or a factor is not 2-D."""
    targets = resolve_lora_targets(targets)
    found = {}  # (target, a|b) -> {layer: tensor}
    for k, v in adapter_state.items():
        m = _LAYER_KEY.match(str(k))
        if m is None:
            continue
        layer, target, ab = int(m.group(1)), m.group(2), m.group(3)
        if target in targets:
            found.setdefault((target, ab), {})[layer] = v
    out = {}
    for t in targets:
        pair = []
        for ab in ("a", "b"):
            layers = found.get((t, ab))
            if not layers:
                raise ValueError(
                    f"adapter state is missing {t}_lora_{ab} (targets "
                    f"{list(targets)}; found "
                    f"{sorted({key[0] for key in found})})"
                )
            if sorted(layers) != list(range(len(layers))):
                raise ValueError(
                    f"adapter {t}_lora_{ab} covers layers {sorted(layers)}, "
                    f"not 0..{len(layers) - 1}"
                )
            mats = [layers[i] for i in range(len(layers))]
            if any(getattr(m, "ndim", 0) != 2 for m in mats):
                raise ValueError(
                    f"adapter {t}_lora_{ab} factors must be 2-D per layer"
                )
            pair.append(torch.stack([torch.as_tensor(m) for m in mats]))
        out[t] = tuple(pair)
    return out


def adapter_num_params(adapter_state):
    """Total adapter parameters (the share-of-base bookkeeping number)."""
    return sum(int(v.numel()) for v in adapter_state.values())
