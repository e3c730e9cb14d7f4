"""Blockwise-quantized optimizer-state storage and compensated masters.

Port of deepspeed_tpu/ops/quant.py. Adam's and LAMB's moments can be
stored as bfloat16 or as int8 with one absmax scale per block of
``BLOCK`` elements (the 8-bit-optimizer formulation of Dettmers et al.,
2022); the update math runs in float32 and only the compressed form
persists between steps. A quantized leaf is the dict ``{"q":
int8[nb * BLOCK], "scale": float32[nb]}`` over a flattened tensor, its
padded tail zero. The JAX package stacks every block parameter over the
layers, so one quantized leaf spans all of a group's layers; the
optimizers (ops/optimizers.py) keep one such leaf per parameter group,
flattened in layer order, so that the codes and scales are the JAX
package's.

Compensated masters keep the parameters in the compute dtype (bfloat16
or float16) and a one-byte code of the rounding error the store dropped:

    master = p + code * ulp(p) / 127,   code in [-127, 127] int8

Each update decodes the master, applies the float32 update, rounds to
the compute dtype's grid and encodes the new error (Kahan summation,
quantized). The JAX package rounds with ``lax.reduce_precision``, which
flushes float16 subnormals to zero; :func:`_round_to_grid` reproduces
that rounding bit for bit.

Everything here is elementwise work and small reductions in plain
PyTorch; no kernel is involved.
"""

import math

import torch

BLOCK = 2048  # absmax granularity (the 8-bit-optimizer default)


def quantized_zeros_like(p, pad_blocks=1, numel=None):
    """Zeros quantized leaf for ``p`` (or for ``numel`` elements on
    ``p``'s device). ``pad_blocks`` rounds the block count up to a
    multiple, as the JAX package's ZeRO layout does; the padded tail
    decodes to zero and never receives updates."""
    n = p.numel() if numel is None else int(numel)
    nb = max(1, math.ceil(n / BLOCK))
    nb = -(-nb // pad_blocks) * pad_blocks
    return {
        "q": torch.zeros(nb * BLOCK, dtype=torch.int8, device=p.device),
        "scale": torch.zeros(nb, dtype=torch.float32, device=p.device),
    }


def is_quantized(state_leaf):
    return isinstance(state_leaf, dict) and set(state_leaf) == {"q", "scale"}


def dequantize(state_leaf, shape):
    """float32 values of the first ``prod(shape)`` elements."""
    n = math.prod(shape) if shape else 1
    q = state_leaf["q"].float().reshape(-1, BLOCK)
    x = q * state_leaf["scale"][:, None]
    return x.reshape(-1)[:n].reshape(shape)


def quantize(x, nb=None):
    """Symmetric blockwise int8: scale = absmax / 127 per BLOCK elements.
    ``nb`` pins the block count (>= the minimum) so that re-encoding a
    padded leaf keeps its storage shape."""
    n = x.numel()
    if nb is None:
        nb = max(1, math.ceil(n / BLOCK))
    flat = x.reshape(-1).float()
    if nb * BLOCK > n:
        flat = torch.cat([flat, flat.new_zeros(nb * BLOCK - n)])
    blocks = flat.reshape(nb, BLOCK)
    absmax = blocks.abs().amax(dim=1)
    scale = absmax / 127.0
    positive = scale > 0
    inv = torch.where(positive, 1.0 / torch.where(positive, scale, 1.0),
                      0.0)
    q = torch.clamp(torch.round(blocks * inv[:, None]), -127, 127)
    return {"q": q.to(torch.int8).reshape(-1), "scale": scale}


def quantize_into(leaf, x):
    """Encode ``x`` into the existing quantized ``leaf`` in place (its
    block count kept)."""
    new = quantize(x, nb=leaf["scale"].numel())
    leaf["q"].copy_(new["q"])
    leaf["scale"].copy_(new["scale"])


def moments_zeros_like(params, state_dtype, role="mu", pad_blocks=1):
    """A zeros moment per tensor of ``params`` (a dict) in the requested
    storage: float32, bfloat16, or for ``int8`` blockwise int8 for the
    first moment (``role="mu"``) and bfloat16 for the second. The second
    moment sits in the update's denominator, 1 / (sqrt(v) + eps): linear
    int8 decodes the small v of a block with a large absmax to 0, which
    turns the update into m / eps and diverges, while bfloat16 keeps
    float32's exponent. A first moment quantized per group is made by
    the optimizer (:func:`quantized_zeros_like` over the group)."""
    if state_dtype == "fp32":
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()}
    if state_dtype == "bf16" or (state_dtype == "int8" and role == "nu"):
        return {n: torch.zeros_like(p, dtype=torch.bfloat16)
                for n, p in params.items()}
    if state_dtype == "int8":
        return {n: quantized_zeros_like(p, pad_blocks=pad_blocks)
                for n, p in params.items()}
    raise ValueError(f"unknown optimizer state_dtype {state_dtype!r}")


def decode_moment(state_leaf, shape):
    """Storage -> float32 working value (a cast for float32 and bfloat16,
    the blockwise decode for int8)."""
    if is_quantized(state_leaf):
        return dequantize(state_leaf, shape)
    return state_leaf.float()


def encode_moment(value_f32, like_leaf):
    """float32 working value -> the storage format of ``like_leaf`` (a
    new tensor or quantized leaf; the optimizers write theirs in place)."""
    if is_quantized(like_leaf):
        return quantize(value_f32, nb=like_leaf["scale"].numel())
    return value_f32.to(like_leaf.dtype)


# ---------------------------------------------------------------------------
# compensated masters: compute-dtype params + an int8 rounding-error code
# ---------------------------------------------------------------------------
_ULP_FRAC = 2.0 ** -8  # bfloat16's mantissa step relative to |x|
_CODE_MAX = 127.0


def _ulp_of(p_f32):
    # the magnitude-relative ulp, floored so that a zero parameter still
    # carries a (vanishing) error range
    return torch.clamp(p_f32.abs(), min=1e-30) * _ULP_FRAC


def comp_zeros_like(params):
    return {n: torch.zeros_like(p, dtype=torch.int8)
            for n, p in params.items()}


def decode_master(p, comp_code):
    """Compute-dtype param + int8 code -> the float32 master value."""
    p32 = p.float()
    return p32 + comp_code.float() * (_ulp_of(p32) / _CODE_MAX)


# (exponent bits, mantissa bits) of each compute dtype's grid
_GRIDS = {torch.bfloat16: (8, 7), torch.float16: (5, 10)}


def _round_to_grid(x, dtype):
    """float32 ``x`` rounded to ``dtype``'s grid, as XLA's
    ``reduce_precision(x, exponent_bits, mantissa_bits)`` rounds: the
    mantissa to nearest even on the bit pattern, then a magnitude above
    the largest exponent goes to a signed infinity and one below the
    smallest normal exponent to a signed zero (float16's subnormals are
    flushed, where ``.half()`` keeps them). NaNs pass through."""
    exp_bits, man_bits = _GRIDS[dtype]
    bits = x.float().contiguous().view(torch.int32)
    shift = 23 - man_bits
    last = (bits >> shift) & 1
    bias = (1 << (shift - 1)) - 1 + last
    # two's-complement addition is the unsigned one modulo 2**32, and a
    # finite pattern's carry never reaches the sign bit
    rounded = (bits + bias) & ~((1 << shift) - 1)
    if exp_bits < 8:
        exponent = rounded & 0x7F800000
        sign = rounded & -0x80000000
        half = (1 << (exp_bits - 1)) - 1
        overflow = exponent > ((127 + half) << 23)
        underflow = exponent <= ((127 - half) << 23)
        rounded = torch.where(overflow, sign | 0x7F800000,
                              torch.where(underflow, sign, rounded))
    out = rounded.view(torch.float32)
    return torch.where(torch.isnan(x), x.float(), out)


def encode_master(master_f32, p_dtype):
    """float32 master -> ``(param in p_dtype, int8 error code)``."""
    p32 = _round_to_grid(master_f32, p_dtype)
    p_new = p32.to(p_dtype)  # exact: p32 lies on the target grid
    err = master_f32 - p32
    code = torch.clamp(torch.round(err / (_ulp_of(p32) / _CODE_MAX)),
                       -_CODE_MAX, _CODE_MAX).to(torch.int8)
    return p_new, code
