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
    return _encode(blocks, blocks.abs().amax(dim=1))


def _encode(blocks, absmax):
    """Blocks ``[nb, BLOCK]`` float32 and their absmax -> the leaf."""
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


class BlockMap:
    """A rank's part of one group's flat int8 leaf, on the whole (JAX)
    leaf's block grid. The JAX engine's leaf of a stacked group runs over
    all its layers and experts, so where a pipeline stage holds some of
    the layers or a data rank some of the experts, a block can hold
    elements of two ranks. ``members`` ``[(name, numel, global offset)]``
    are this rank's tensors of the group, each a contiguous run of the
    whole leaf (``total`` elements) in the JAX element order; ``shared``
    the sorted global blocks that hold elements of more than one rank
    (the same list on every rank); ``reduce`` a function that takes the
    max of a float32 vector over every rank in place.

    The members' runs are the maximal runs of consecutive global blocks
    they touch, laid end to end (``run_offsets``: each member's element
    offset there; the elements no member holds stay zero). Without
    ``shard`` the rank's leaf is those runs, and the optimizer steps each
    member at its run offset. With ``shard`` ``(rank, dp, name)`` (ZeRO
    over the data group) the runs' block count is padded to a multiple of
    ``dp`` and the rank's leaf is its ``rank``-th contiguous ``1/dp`` of
    the blocks, cut on block boundaries as the JAX engine cuts its flat
    leaves over the data axis, and the optimizer steps it as one flat
    tensor ``name`` (a ZeRO leaf); ``first`` is that share's first
    element in the runs. ``offsets`` gives the offset in the rank's leaf
    of each tensor the optimizer steps. Every local block is one global
    block (``global_blocks``, None for a padding block), ``segments``
    ``[(local offset, global offset, numel)]`` the members' elements the
    leaf holds. A shared block takes its scale from the max of its ranks'
    absmax (one ``reduce`` of the shared blocks a step), so the codes and
    scales are the whole leaf's."""

    def __init__(self, members, total, shared=(), reduce=None, shard=None):
        self.total = int(total)
        windows = []  # [first global block, end global block)
        for a, b in sorted((off, off + n) for _, n, off in members):
            first, end = a // BLOCK, -(-b // BLOCK)
            if windows and first <= windows[-1][1]:
                windows[-1][1] = max(windows[-1][1], end)
            else:
                windows.append([first, end])
        starts, blocks = [], []
        for first, end in windows:
            starts.append((first, len(blocks)))
            blocks.extend(range(first, end))
        self.run_offsets = {}
        for name, _, off in members:
            first, local = max(w for w in starts if w[0] * BLOCK <= off)
            self.run_offsets[name] = (local - first) * BLOCK + off
        rank, dp, flat = shard or (0, 1, None)
        self.nb = -(-len(blocks) // dp)
        self.run_numel = self.nb * dp * BLOCK
        self.first = rank * self.nb * BLOCK
        mine = blocks[rank * self.nb:(rank + 1) * self.nb]
        self.global_blocks = mine + [None] * (self.nb - len(mine))
        self.numel = self.nb * BLOCK
        self.segments = []
        for name, n, off in members:
            ro = self.run_offsets[name]
            a, b = max(ro, self.first), min(ro + n, self.first + self.numel)
            if a < b:
                self.segments.append((a - self.first, off + a - ro, b - a))
        self.offsets = ({flat: 0} if shard is not None
                        else dict(self.run_offsets))
        slot = {g: i for i, g in enumerate(shared)}
        self.n_shared = len(slot)
        self._pairs = [(k, slot[g]) for k, g in enumerate(self.global_blocks)
                       if g in slot]
        self.reduce = reduce
        self._index = {}

    def zeros(self, device):
        return {"q": torch.zeros(self.numel, dtype=torch.int8, device=device),
                "scale": torch.zeros(self.nb, dtype=torch.float32,
                                     device=device)}

    def _indices(self, device):
        if device not in self._index:
            local, slots = zip(*self._pairs) if self._pairs else ((), ())
            self._index[device] = tuple(
                torch.tensor(x, dtype=torch.long, device=device)
                for x in (local, slots))
        return self._index[device]

    def quantize_into(self, leaf, x):
        """Encode the rank's flat working values ``x`` (``numel``
        elements, zero where the rank holds none) into ``leaf`` in place,
        the shared blocks' absmax first maxed over every rank."""
        blocks = x.reshape(self.nb, BLOCK).float()
        absmax = blocks.abs().amax(dim=1)
        if self.n_shared:
            local, slots = self._indices(absmax.device)
            vec = absmax.new_zeros(self.n_shared)
            vec[slots] = absmax[local]
            self.reduce(vec)
            absmax[local] = vec[slots]
        new = _encode(blocks, absmax)
        leaf["q"].copy_(new["q"])
        leaf["scale"].copy_(new["scale"])

    def to_pieces(self, leaf):
        """This rank's codes and scales as whole-leaf pieces (host):
        ``([(global offset, codes)], [(global block, scale)])``."""
        q, scale = leaf["q"].detach().cpu(), leaf["scale"].detach().cpu()
        return ([(off, q[local:local + n].clone())
                 for local, off, n in self.segments],
                [(g, float(scale[k]))
                 for k, g in enumerate(self.global_blocks) if g is not None])

    def from_whole(self, whole):
        """This rank's leaf cut from the whole leaf ``whole`` (host)."""
        out = self.zeros("cpu")
        for local, off, n in self.segments:
            out["q"][local:local + n] = whole["q"][off:off + n]
        held = [(k, g) for k, g in enumerate(self.global_blocks)
                if g is not None]
        if held:
            local, glob = zip(*held)
            out["scale"][list(local)] = whole["scale"][list(glob)]
        return out


def whole_from_pieces(total, parts):
    """The whole leaf of ``total`` elements from every rank's
    :meth:`BlockMap.to_pieces` (ranks that hold the same elements hold the
    same codes)."""
    nb = max(1, math.ceil(total / BLOCK))
    q = torch.zeros(nb * BLOCK, dtype=torch.int8)
    scale = torch.zeros(nb, dtype=torch.float32)
    for codes, scales in parts:
        for off, c in codes:
            q[off:off + c.numel()] = c
        for g, v in scales:
            if g < nb:
                scale[g] = v
    return {"q": q, "scale": scale}


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
