"""Adam and LAMB, updating parameters in place.

Port of deepspeed_tpu/ops/optimizers.py (``Adam``, ``Lamb``,
``build_optimizer``). The JAX optimizers are pure functions over a
pytree; here ``apply`` updates the fp32 parameters and the fp32 moments
IN PLACE (no second copy of either) and returns only the aux dict. The
update arithmetic is the JAX package's, written in the same order, in
float32: ``g32 = f32(g) * grad_scale`` (the engine's unscale and clip
folded into one factor), the moments, bias correction, and for LAMB the
trust ratio ``clamp(||p|| / ||u||, min_coeff, max_coeff)``.

Parameters come as a dict ``{name: tensor}``. LAMB's trust ratio is one
ratio per *group*: the JAX GPT-2 stacks every block parameter over the
layers (``nn.scan``), so ``h/attn_qkvw`` is one leaf and one norm over
all layers, where the port keeps one module per layer. ``param_groups``
puts ``h.<i>.<name>`` for every ``i`` into the group ``h.*.<name>``;
groups are ordered by name, which for GPT-2 is the JAX tree's order.

The JAX package's reduced-precision moment storage (``state_dtype``),
compensated masters and the chunked leaf update are not ported (the
engine refuses those configs); SGD and Lion wait for a later slice.
"""

import dataclasses
import re
from collections import OrderedDict

import numpy as np
import torch

_LAYER_INDEX = re.compile(r"\.\d+\.")


def param_groups(names):
    """``{group name: [param name, ...]}``, ordered by group name: the
    layer index of a ``ModuleList`` entry (``h.3.attn_qkvw``) becomes
    ``*`` (``h.*.attn_qkvw``), so a group is one stacked JAX leaf.
    Within a group the names keep their given (layer) order."""
    groups = {}
    for name in names:
        groups.setdefault(_LAYER_INDEX.sub(".*.", name), []).append(name)
    return OrderedDict(sorted(groups.items()))


def bias_corrections(b1, b2, step, enabled=True):
    """``(1 - b1**step, 1 - b2**step)`` in float32, as the JAX update
    computes them; ``(1, 1)`` without bias correction."""
    if not enabled:
        return 1.0, 1.0
    one, s = np.float32(1.0), np.float32(step)
    return (float(one - np.float32(b1) ** s), float(one - np.float32(b2) ** s))


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


def _scaled_f32(g, grad_scale):
    g32 = g.float()
    return g32 if grad_scale is None else g32 * grad_scale


@dataclasses.dataclass
class Adam(Optimizer):
    """Adam / AdamW. ``adam_w_mode`` decouples the weight decay (AdamW);
    False adds it to the gradient (classic Adam with L2)."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = True
    adam_w_mode: bool = True
    supports_mom = True

    @torch.no_grad()
    def apply(self, params, grads, state, lr, grad_scale=None, mom=None):
        state["step"] += 1
        b1 = self.b1 if mom is None else mom
        b2 = self.b2
        c1, c2 = bias_corrections(b1, b2, state["step"], self.bias_correction)
        wd = self.weight_decay
        for name, p in params.items():
            g32 = _scaled_f32(grads[name], grad_scale)
            m, v = state["mu"][name], state["nu"][name]
            if wd and not self.adam_w_mode:
                g32 = g32 + wd * p
            m_new = b1 * m + (1.0 - b1) * g32
            v_new = b2 * v + (1.0 - b2) * g32 * g32
            update = (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps)
            if wd and self.adam_w_mode:
                update = update + wd * p
            p.copy_(p - lr * update)
            m.copy_(m_new)
            v.copy_(v_new)
        return {}


def trust_ratio(w_norm, u_norm, min_coeff, max_coeff):
    """LAMB's clamped ratio, 1.0 where either norm is 0."""
    return torch.where(
        (w_norm > 0) & (u_norm > 0),
        torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
        torch.ones_like(w_norm),
    )


@dataclasses.dataclass
class Lamb(Optimizer):
    """LAMB with the reference's clamped trust ratio, one ratio per
    parameter group (see :func:`param_groups`):
      u = adam_update(g) (+ wd * p)
      ratio = clamp(||p|| / ||u||, min_coeff, max_coeff)  if both > 0
      p <- p - lr * ratio * u
    ``aux['lamb_coeffs']`` holds the ratios in group order."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = True
    max_coeff: float = 10.0
    min_coeff: float = 0.01
    eps_inside_sqrt: bool = False
    supports_mom = True

    def _update(self, p, g32, m, v, b1, c1, c2):
        """Moments (in place) and the update ``u`` of one tensor."""
        b2 = self.b2
        m.copy_(b1 * m + (1.0 - b1) * g32)
        v.copy_(b2 * v + (1.0 - b2) * g32 * g32)
        if self.eps_inside_sqrt:
            denom = torch.sqrt(v / c2 + self.eps)
        else:
            denom = torch.sqrt(v / c2) + self.eps
        update = (m / c1) / denom
        if self.weight_decay:
            update = update + self.weight_decay * p
        return update

    @torch.no_grad()
    def apply(self, params, grads, state, lr, grad_scale=None, mom=None):
        state["step"] += 1
        b1 = self.b1 if mom is None else mom
        c1, c2 = bias_corrections(b1, self.b2, state["step"],
                                  self.bias_correction)
        coeffs = []
        for names in param_groups(params).values():
            updates = [
                self._update(params[n], _scaled_f32(grads[n], grad_scale),
                             state["mu"][n], state["nu"][n], b1, c1, c2)
                for n in names
            ]
            w_norm = torch.sqrt(sum(torch.sum(params[n] * params[n])
                                    for n in names))
            u_norm = torch.sqrt(sum(torch.sum(u * u) for u in updates))
            ratio = trust_ratio(w_norm, u_norm, self.min_coeff, self.max_coeff)
            coeffs.append(ratio)
            for n, u in zip(names, updates):
                params[n].copy_(params[n] - lr * ratio * u)
        return {"lamb_coeffs": coeffs}


def build_optimizer(name, params_dict):
    """The optimizer a config names (Adam, AdamW, Lamb, FusedLamb), with
    its params; ``lr`` is supplied per step by the engine."""
    name = name.lower()
    kw = dict(params_dict)
    kw.pop("lr", None)
    betas = kw.pop("betas", None)
    if betas is not None:
        kw["b1"], kw["b2"] = betas
    for unused in ("torch_adam", "amsgrad", "max_grad_norm"):
        kw.pop(unused, None)
    if name == "adam":
        return Adam(adam_w_mode=kw.pop("adam_w_mode", True), **kw)
    if name == "adamw":
        return Adam(adam_w_mode=True, **kw)
    if name == "lamb":
        return Lamb(**kw)
    if name in ("fusedlamb", "fused_lamb"):
        from .fused_lamb import FusedLamb

        return FusedLamb(**kw)
    raise ValueError(f"Unknown optimizer '{name}'")
