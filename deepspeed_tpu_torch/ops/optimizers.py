"""Adam, LAMB, SGD and Lion, updating parameters in place.

Port of deepspeed_tpu/ops/optimizers.py (``Adam``, ``Lamb``, ``SGD``,
``Lion``, ``build_optimizer``). The JAX optimizers are pure functions
over a pytree; here ``apply`` updates the parameters and the optimizer
state IN PLACE (no second copy of either) and returns only the aux dict.
The update arithmetic is the JAX package's, written in the same order,
in float32: ``g32 = f32(g) * grad_scale`` (the engine's unscale and clip
folded into one factor), the moments, bias correction, and for LAMB the
trust ratio ``clamp(||p|| / ||u||, min_coeff, max_coeff)``.

Parameters come as a dict ``{name: tensor}``. LAMB's trust ratio is one
ratio per *group*: the JAX GPT-2 and BERT stack every block parameter
over the layers (``nn.scan``), so ``h/attn_qkvw`` is one leaf and one
norm over all layers, where the port keeps one module per layer.
``param_groups`` puts ``h.<i>.<name>`` for every ``i`` into the group
``h.*.<name>``; groups are ordered by name, which for GPT-2 and BERT is
the JAX tree's order.

Optimizer-state layouts (ops/quant.py), as in the JAX package:
  - ``state_dtype`` (Adam, Lamb): the moments stored as ``"fp32"``,
    ``"bf16"``, or ``"int8"`` (blockwise int8 first moment, bfloat16
    second moment); the math runs in float32 and only the stored form
    persists. An int8 first moment is one quantized leaf per group, over
    the group's tensors flattened in layer order (``state["mu"]`` is then
    keyed by group name), each in the JAX package's element order (a
    linear weight, stored [out, in] here, flattened as JAX's [in, out];
    :func:`jax_element_order`), so that its blocks and scales are the JAX
    package's, whose stacked leaf blocks across layers.
  - ``master_compensation`` (Adam): the parameters stay in the compute
    dtype and ``state["comp"]`` holds an int8 code of each one's rounding
    error (compensated masters).
  - the chunked update (Adam): a tensor above ``chunk_elements`` (33.5M)
    elements updates in groups of leading-axis rows, views written in
    place, so that only one group's float32 temporaries are alive at once
    (GPT-2's ``wte`` [50304, 768] in two halves). It changes memory, never
    values. ``flat_quant_update`` updates an int8 group in one pass over
    its flat storage instead of in row groups (the same values).
"""

import dataclasses
import re
from collections import OrderedDict

import numpy as np
import torch

from . import quant

_LAYER_INDEX = re.compile(r"\.\d+\.")
# the port's linear weights, stored [out, in] for F.linear where the JAX
# package keeps [in, out] (convert.py transposes them): the block matrices
# and the 2-d ``weight`` of a dense layer
_TRANSPOSED_NAMES = ("attn_qkvw", "attn_ow", "inter_w", "output_w", "weight")

# Tensors above this many elements update in leading-axis row groups
# (the JAX package's _CHUNK_ELEMENTS): bounds the float32 temporaries of a
# large tensor's update to one row group's.
_CHUNK_ELEMENTS = 1 << 25  # 33.5M


def param_groups(names):
    """``{group name: [param name, ...]}``, ordered by group name: the
    layer index of a ``ModuleList`` entry (``h.3.attn_qkvw``) becomes
    ``*`` (``h.*.attn_qkvw``), so a group is one stacked JAX leaf.
    Within a group the names keep their given (layer) order."""
    groups = {}
    for name in names:
        groups.setdefault(_LAYER_INDEX.sub(".*.", name), []).append(name)
    return OrderedDict(sorted(groups.items()))


def jax_element_order(name, t):
    """``t`` as a view in the JAX package's element order: a linear
    weight (a 2-d tensor named like one of ``_TRANSPOSED_NAMES``)
    transposed to JAX's [in, out], anything else as it is. Flattening
    this view gives the order the JAX leaf's int8 blocks cover."""
    if t.dim() == 2 and name.rsplit(".", 1)[-1] in _TRANSPOSED_NAMES:
        return t.t()
    return t


def bias_corrections(b1, b2, step, enabled=True):
    """``(1 - b1**step, 1 - b2**step)`` in float32, as the JAX update
    computes them; ``(1, 1)`` without bias correction."""
    if not enabled:
        return 1.0, 1.0
    one, s = np.float32(1.0), np.float32(step)
    return (float(one - np.float32(b1) ** s), float(one - np.float32(b2) ** s))


def _slice_count(L, size, threshold=None):
    """Fewest slices ``n`` dividing the leading axis ``L`` that bound each
    slice to about ``threshold`` elements; 0 when no reasonable divisor
    exists (a large prime ``L``), which leaves the whole-tensor update.
    The JAX package's rule."""
    if threshold is None:
        threshold = _CHUNK_ELEMENTS
    want = max(1, -(-size // threshold))
    if want >= L:
        return L
    for n in range(want, min(L, max(64, 8 * want)) + 1):
        if L % n == 0:
            return n
    return 0


def chunk_rows(p, threshold=None, quantized=False):
    """The leading-axis row ranges ``[(start, stop), ...]`` of ``p``'s
    chunked update, or None for the whole-tensor update (a tensor below
    ``threshold``, one without a usable divisor, or, with an int8 moment,
    a slice that would split a quantization block)."""
    if threshold is None:
        threshold = _CHUNK_ELEMENTS
    if p.dim() < 2 or p.shape[0] <= 1 or p.numel() < threshold:
        return None
    L = p.shape[0]
    n = _slice_count(L, p.numel(), threshold)
    if n <= 1:
        return None
    if quantized and (p.numel() // n) % quant.BLOCK:
        return None
    rows = L // n
    return [(i * rows, (i + 1) * rows) for i in range(n)]


def _group_slice(name, p, flat, off):
    """Tensor ``name``'s part of a group's flat first moment, as a view
    of ``p``'s shape (the flat part holds it in JAX element order)."""
    like = jax_element_order(name, p)
    part = flat[off:off + p.numel()].view(like.shape)
    return jax_element_order(name, part) if like is not p else part


def _quant_rows(leaf, row_elems, start, stop):
    """Views of an int8 leaf's codes and scales for rows [start, stop)."""
    a, b = start * row_elems, stop * row_elems
    return {"q": leaf["q"][a:b],
            "scale": leaf["scale"][a // quant.BLOCK:b // quant.BLOCK]}


class Optimizer:
    """Base class. ``init(params) -> state``; ``apply(params, grads,
    state, lr, grad_scale=None, mom=None) -> aux`` updates ``params`` and
    ``state`` in place. ``mom`` (optimizers with ``supports_mom``)
    overrides the first-moment coefficient for this step (OneCycle's
    momentum cycling)."""

    supports_mom = False

    def init(self, params):
        return {
            "step": 0,
            "mu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()},
        }

    def apply(self, params, grads, state, lr, grad_scale=None, mom=None):
        raise NotImplementedError


class _Divisors:
    """The bias corrections as 0-d float32 tensors on each parameter's
    device. PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal, which can differ from the division in the last bit; as
    device tensors the card divides as the host does, so an offloaded
    (host) step equals the on-device one bit for bit."""

    def __init__(self, c1, c2):
        self._c = (c1, c2)
        self._by_device = {}

    def __call__(self, device):
        if device not in self._by_device:
            self._by_device[device] = tuple(
                torch.full((), c, dtype=torch.float32, device=device)
                for c in self._c)
        return self._by_device[device]


def _sqrt(x):
    """The correctly rounded float32 square root on every device.
    PyTorch's CPU ``sqrt`` (its AVX-512 path) is off by an ulp in about
    0.6% of elements, numpy's is exact (as XLA's is); on the card
    ``torch.sqrt`` is exact. An offloaded (host) step then equals the
    on-device one bit for bit."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


def _scaled_f32(g, grad_scale):
    g32 = g.float()
    return g32 if grad_scale is None else g32 * grad_scale


class _Moments:
    """Moment storage for Adam and Lamb (``state_dtype``). ``quant_maps``
    (``{group: quant.BlockMap}``, set by the engine) places an int8
    group that spans ranks (a pipeline stage's layers, a data rank's
    experts) on the whole JAX leaf's block grid."""

    quant_maps = None

    def _quant_map(self, group):
        return (self.quant_maps or {}).get(group)

    def _flat_moment(self, group, names, params, state):
        """An int8 group's working first moment: ``(float32 flat values,
        a zero buffer of the same size for the new ones, each member's
        offset in them)``."""
        bmap = self._quant_map(group)
        stored = state["mu"][group]
        if bmap is not None:
            m_flat = quant.dequantize(stored, (bmap.numel,))
            return m_flat, torch.zeros_like(m_flat), bmap.offsets
        offsets, off = {}, 0
        for n in names:
            offsets[n] = off
            off += params[n].numel()
        m_flat = quant.dequantize(stored, (off,))
        return m_flat, torch.empty_like(m_flat), offsets

    def _store_flat_moment(self, group, state, m_new_flat):
        bmap = self._quant_map(group)
        if bmap is not None:
            bmap.quantize_into(state["mu"][group], m_new_flat)
        else:
            quant.quantize_into(state["mu"][group], m_new_flat)

    def _init_moments(self, params):
        if self.state_dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(
                f"unknown optimizer state_dtype {self.state_dtype!r}")
        nu = quant.moments_zeros_like(params, self.state_dtype, "nu")
        if self.state_dtype != "int8":
            return quant.moments_zeros_like(params, self.state_dtype,
                                            "mu"), nu
        # one quantized first moment per group, over its tensors in order
        mu = {}
        for group, names in param_groups(params).items():
            bmap = self._quant_map(group)
            mu[group] = (bmap.zeros(params[names[0]].device)
                         if bmap is not None else quant.quantized_zeros_like(
                             params[names[0]],
                             numel=sum(params[n].numel() for n in names)))
        return mu, nu


@dataclasses.dataclass
class Adam(Optimizer, _Moments):
    """Adam / AdamW. ``adam_w_mode`` decouples the weight decay (AdamW);
    False adds it to the gradient (classic Adam with L2). ``state_dtype``
    and ``master_compensation``: see the module docstring."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = True
    adam_w_mode: bool = True
    state_dtype: str = "fp32"
    master_compensation: bool = False
    chunk_elements: int = _CHUNK_ELEMENTS
    flat_quant_update: bool = False
    supports_mom = True

    def init(self, params):
        mu, nu = self._init_moments(params)
        state = {"step": 0, "mu": mu, "nu": nu}
        if self.master_compensation:
            state["comp"] = quant.comp_zeros_like(params)
        return state

    @torch.no_grad()
    def apply(self, params, grads, state, lr, grad_scale=None, mom=None):
        state["step"] += 1
        b1 = self.b1 if mom is None else mom
        b2 = self.b2
        divisors = _Divisors(*bias_corrections(b1, b2, state["step"],
                                               self.bias_correction))
        wd = self.weight_decay
        comp = state.get("comp") if self.master_compensation else None

        def leaf(p, g, m, v_store, code):
            """One tensor (or row group): writes p, v and the code in
            place and returns the new float32 first moment."""
            g32 = _scaled_f32(g, grad_scale)
            p32 = quant.decode_master(p, code) if code is not None else p.float()
            if wd and not self.adam_w_mode:
                g32 = g32 + wd * p32
            m_new = b1 * m + (1.0 - b1) * g32
            v_new = b2 * v_store.float() + (1.0 - b2) * g32 * g32
            c1, c2 = divisors(p.device)
            update = (m_new / c1) / (_sqrt(v_new / c2) + self.eps)
            if wd and self.adam_w_mode:
                update = update + wd * p32
            master_new = p32 - lr * update
            if code is not None:
                p_new, code_new = quant.encode_master(master_new, p.dtype)
                p.copy_(p_new)
                code.copy_(code_new)
            else:
                p.copy_(master_new)
            v_store.copy_(v_new)
            return m_new

        def rows(x, a, b):
            return None if x is None else x[a:b]

        for group, names in param_groups(params).items():
            if self.state_dtype == "int8":
                self._apply_quantized_group(
                    leaf, params, grads, state, comp, group, names)
                continue
            for n in names:
                p, g, m_st, v_st = (params[n], grads[n], state["mu"][n],
                                    state["nu"][n])
                code = comp[n] if comp is not None else None
                spans = chunk_rows(p, self.chunk_elements) or [None]
                for span in spans:
                    if span is not None:
                        a, b = span
                        p_, g_, m_, v_, c_ = (p[a:b], g[a:b], m_st[a:b],
                                              v_st[a:b], rows(code, a, b))
                    else:
                        p_, g_, m_, v_, c_ = p, g, m_st, v_st, code
                    m_.copy_(leaf(p_, g_, m_.float(), v_, c_))
        return {}

    def _apply_quantized_group(self, leaf, params, grads, state, comp,
                               group, names):
        """An int8 group: a lone large tensor in row groups (each decoded
        and re-encoded over its own blocks), else the whole group decoded
        over its flat storage, each tensor updated from its slice, and the
        new first moment encoded over the group."""
        stored = state["mu"][group]
        if (len(names) == 1 and not self.flat_quant_update
                and self._quant_map(group) is None):
            n = names[0]
            p = params[n]
            spans = chunk_rows(p, self.chunk_elements, quantized=True)
            if jax_element_order(n, p) is not p:
                spans = None  # row groups of [out, in] are not JAX's blocks
            if spans is not None:
                row_elems = p.numel() // p.shape[0]
                code = comp[n] if comp is not None else None
                for a, b in spans:
                    sub = _quant_rows(stored, row_elems, a, b)
                    m = quant.dequantize(sub, tuple(p[a:b].shape))
                    m_new = leaf(p[a:b], grads[n][a:b], m,
                                 state["nu"][n][a:b],
                                 None if code is None else code[a:b])
                    quant.quantize_into(sub, m_new)
                return
        m_flat, m_new_flat, offsets = self._flat_moment(group, names,
                                                        params, state)
        for n in names:
            p = params[n]
            m = _group_slice(n, p, m_flat, offsets[n])
            m_new = leaf(p, grads[n], m, state["nu"][n],
                         comp[n] if comp is not None else None)
            _group_slice(n, p, m_new_flat, offsets[n]).copy_(m_new)
        self._store_flat_moment(group, state, m_new_flat)


def trust_ratio(w_norm, u_norm, min_coeff, max_coeff):
    """LAMB's clamped ratio, 1.0 where either norm is 0."""
    return torch.where(
        (w_norm > 0) & (u_norm > 0),
        torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
        torch.ones_like(w_norm),
    )


@dataclasses.dataclass
class Lamb(Optimizer, _Moments):
    """LAMB with the reference's clamped trust ratio, one ratio per
    parameter group (see :func:`param_groups`):
      u = adam_update(g) (+ wd * p)
      ratio = clamp(||p|| / ||u||, min_coeff, max_coeff)  if both > 0
      p <- p - lr * ratio * u
    ``aux['lamb_coeffs']`` holds the ratios in group order.
    ``state_dtype``: see the module docstring.

    Over ZeRO shards (runtime/zero.py), and wherever one JAX leaf spans
    ranks (model shards, a rank's MoE experts of ``h.*.moe.expert_*``, a
    pipeline stage's part of ``h.*.<name>``), the engine sets
    ``norm_reduce``, a function that sums a ``[groups, 2]`` tensor of
    partial ``(||p||^2, ||u||^2)`` over every rank in place, and
    ``norm_skip``, the tensors another rank counts (replicated ones):
    every group's phase 1 runs first, one reduction follows, then the
    ratios and the updates."""

    norm_reduce = None
    norm_skip = frozenset()

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = True
    max_coeff: float = 10.0
    min_coeff: float = 0.01
    eps_inside_sqrt: bool = False
    state_dtype: str = "fp32"
    supports_mom = True

    def init(self, params):
        mu, nu = self._init_moments(params)
        return {"step": 0, "mu": mu, "nu": nu}

    def _update(self, p, g32, m, v_store, b1, divisors):
        """The new float32 first moment and the update ``u`` of one
        tensor; the second moment is written in place."""
        b2 = self.b2
        c1, c2 = divisors(p.device)
        m_new = b1 * m + (1.0 - b1) * g32
        v_new = b2 * v_store.float() + (1.0 - b2) * g32 * g32
        if self.eps_inside_sqrt:
            denom = _sqrt(v_new / c2 + self.eps)
        else:
            denom = _sqrt(v_new / c2) + self.eps
        update = (m_new / c1) / denom
        if self.weight_decay:
            update = update + self.weight_decay * p
        v_store.copy_(v_new)
        return m_new, update

    def _phase1(self, group, names, params, grads, state, b1, divisors,
                grad_scale):
        """One group's moments (written) and updates ``u`` (returned)."""
        quantized = self.state_dtype == "int8"
        if quantized:
            m_flat, m_new_flat, offsets = self._flat_moment(
                group, names, params, state)
        updates = []
        for n in names:
            p = params[n]
            m = (_group_slice(n, p, m_flat, offsets[n]) if quantized
                 else state["mu"][n].float())
            m_new, u = self._update(p, _scaled_f32(grads[n], grad_scale),
                                    m, state["nu"][n], b1, divisors)
            if quantized:
                _group_slice(n, p, m_new_flat, offsets[n]).copy_(m_new)
            else:
                state["mu"][n].copy_(m_new)
            updates.append(u)
        if quantized:
            self._store_flat_moment(group, state, m_new_flat)
        return updates

    def _apply_ratio(self, names, params, updates, w_sq, u_sq, lr):
        ratio = trust_ratio(torch.sqrt(w_sq), torch.sqrt(u_sq),
                            self.min_coeff, self.max_coeff)
        for n, u in zip(names, updates):
            params[n].copy_(params[n] - lr * ratio * u)
        return ratio

    @torch.no_grad()
    def apply(self, params, grads, state, lr, grad_scale=None, mom=None):
        state["step"] += 1
        b1 = self.b1 if mom is None else mom
        divisors = _Divisors(*bias_corrections(b1, self.b2, state["step"],
                                               self.bias_correction))
        groups = param_groups(params)
        if self.norm_reduce is None:
            coeffs = []
            for group, names in groups.items():
                updates = self._phase1(group, names, params, grads, state,
                                       b1, divisors, grad_scale)
                w_sq = sum(torch.sum(params[n] * params[n]) for n in names)
                u_sq = sum(torch.sum(u * u) for u in updates)
                coeffs.append(self._apply_ratio(names, params, updates,
                                                w_sq, u_sq, lr))
            return {"lamb_coeffs": coeffs}
        # over shards: every group's partial sums, one reduction, then
        # the ratios (the same for every rank) and the updates
        pending, sums = [], []
        for group, names in groups.items():
            updates = self._phase1(group, names, params, grads, state, b1,
                                   divisors, grad_scale)
            zero = torch.zeros((), dtype=torch.float32,
                               device=params[names[0]].device)
            kept = [(n, u) for n, u in zip(names, updates)
                    if n not in self.norm_skip]
            sums.append(torch.stack([
                sum((torch.sum(params[n] * params[n]) for n, _ in kept),
                    zero),
                sum((torch.sum(u * u) for _, u in kept), zero)]))
            pending.append((names, updates))
        sums = torch.stack(sums)
        self.norm_reduce(sums)
        return {"lamb_coeffs": [
            self._apply_ratio(names, params, updates, s[0], s[1], lr)
            for (names, updates), s in zip(pending, sums)]}


@dataclasses.dataclass
class SGD(Optimizer):
    """SGD with optional momentum (``m = mom * m + g``), Nesterov
    (``d = g + mom * m``) and weight decay added to the gradient."""

    momentum: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False

    @property
    def supports_mom(self):
        # momentum cycling needs the momentum buffer, which exists only
        # when momentum != 0 at init (the JAX rule): at 0 the engine warns
        # instead of silently ignoring a cycled momentum
        return bool(self.momentum)

    def init(self, params):
        if self.momentum:
            return {"step": 0,
                    "mom": {n: torch.zeros_like(p, dtype=torch.float32)
                            for n, p in params.items()}}
        return {"step": 0, "mom": None}

    @torch.no_grad()
    def apply(self, params, grads, state, lr, grad_scale=None, mom=None):
        state["step"] += 1
        mu_coeff = self.momentum if mom is None else mom
        wd = self.weight_decay
        for n, p in params.items():
            g32 = _scaled_f32(grads[n], grad_scale)
            p32 = p.float()
            if wd:
                g32 = g32 + wd * p32
            if self.momentum:
                m = state["mom"][n]
                m_new = mu_coeff * m + g32
                d = g32 + mu_coeff * m_new if self.nesterov else m_new
                m.copy_(m_new)
            else:
                d = g32
            p.copy_(p32 - lr * d)
        return {}


@dataclasses.dataclass
class Lion(Optimizer):
    """Lion (sign momentum): one moment,
      u = sign(b1 * m + (1 - b1) * g) (+ wd * p);  m <- b2 * m + (1 - b2) * g
      p <- p - lr * u"""

    b1: float = 0.9
    b2: float = 0.99
    weight_decay: float = 0.0

    def init(self, params):
        return {"step": 0,
                "mu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()}}

    @torch.no_grad()
    def apply(self, params, grads, state, lr, grad_scale=None, mom=None):
        state["step"] += 1
        for n, p in params.items():
            g32 = _scaled_f32(grads[n], grad_scale)
            p32 = p.float()
            m = state["mu"][n]
            update = torch.sign(self.b1 * m + (1.0 - self.b1) * g32)
            if self.weight_decay:
                update = update + self.weight_decay * p32
            m.copy_(self.b2 * m + (1.0 - self.b2) * g32)
            p.copy_(p32 - lr * update)
        return {}


def build_optimizer(name, params_dict):
    """The optimizer a config names (Adam, AdamW, Lamb, FusedLamb, SGD,
    Lion), with its params; ``lr`` is supplied per step by the engine."""
    name = name.lower()
    kw = dict(params_dict)
    kw.pop("lr", None)
    betas = kw.pop("betas", None)
    if betas is not None:
        kw["b1"], kw["b2"] = betas
    kw.pop("torch_adam", None)
    kw.pop("amsgrad", None)
    if name in ("adam", "adamw", "lamb", "fusedlamb", "fused_lamb"):
        kw.pop("max_grad_norm", None)
    if name == "adam":
        return Adam(adam_w_mode=kw.pop("adam_w_mode", True), **kw)
    if name == "adamw":
        return Adam(adam_w_mode=True, **kw)
    if name == "lamb":
        return Lamb(**kw)
    if name in ("fusedlamb", "fused_lamb"):
        from .fused_lamb import FusedLamb

        return FusedLamb(**kw)
    if name == "sgd":
        return SGD(**kw)
    if name == "lion":
        return Lion(**kw)
    raise ValueError(f"Unknown optimizer '{name}'")
