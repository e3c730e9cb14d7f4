"""Fused LAMB over a hand-written CUDA phase-1 kernel.

Port of deepspeed_tpu/ops/pallas.py. Phase 1 of LAMB (Adam moments, the
update ``u``, and per-block partial sums of p*p and u*u) is one pass of
the kernel ``csrc/lamb_phase1.cu``, which replaces the Pallas kernel
``_lamb_phase1_kernel`` at both of its launch sites:

  - ``lamb_leaf_update``: one parameter group per launch (the JAX
    package's per-leaf launch);
  - ``lamb_multi_tensor_update``: many small groups in one launch (the
    JAX package's packed multi-leaf launch with a block -> segment map).

Phase 2 (the sum of each group's block partials with ``index_add_``,
then the clamped trust ratio) and phase 3 (``p -= lr * ratio * u``) stay
in PyTorch, as the JAX package leaves them to XLA.

A "group" is what the JAX tree holds as one leaf: ``h.*.attn_qkvw`` is
the twelve per-layer tensors of the port (``ops/optimizers.py:
param_groups``), and its trust ratio is one norm over all of them. The
functions here take each group as a list of tensors; they update the
parameters and the moments IN PLACE (the JAX functions return new
arrays) and write ``u`` into caller-provided scratch tensors.

``lamb_phase1`` is the kernel's wrapper: on CUDA tensors it launches the
kernel (or raises), on CPU tensors it runs ``lamb_phase1_plain``.
"""

import ctypes
import dataclasses

import numpy as np
import torch

from .optimizers import Lamb, bias_corrections, param_groups, trust_ratio

#: elements per kernel block (csrc/lamb_phase1.cu kBlock); the unit of the
#: partial sums
BLOCK = 4096


def _nblocks(n):
    return max(1, -(-n // BLOCK))


def _upload(array, device):
    """A host numpy array on ``device``; to a GPU through pinned memory,
    without waiting for the stream's queued work."""
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _block_sums(x):
    """Sums of ``x``'s consecutive BLOCK-element blocks, float32."""
    flat = x.reshape(-1)
    pad = _nblocks(flat.numel()) * BLOCK - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK).sum(dim=1)


def lamb_phase1_plain(ps, gs, ms, vs, us, c1, c2, grad_scale, *, b1, b2,
                      eps, weight_decay, eps_inside_sqrt):
    """The kernel's function in plain PyTorch over parallel lists of
    tensors: updates ``ms``/``vs`` in place, writes ``us``, and returns
    the per-block partials ``(wsq, usq)`` (float32, the blocks of each
    tensor in list order)."""
    wsq, usq = [], []
    for p, g, m, v, u in zip(ps, gs, ms, vs, us):
        g32 = (g.float() * grad_scale).to(g.dtype).float()
        m.copy_(b1 * m + (1.0 - b1) * g32)
        v.copy_(b2 * v + (1.0 - b2) * g32 * g32)
        if eps_inside_sqrt:
            denom = torch.sqrt(v / c2 + eps)
        else:
            denom = torch.sqrt(v / c2) + eps
        upd = (m / c1) / denom
        if weight_decay:
            upd = upd + weight_decay * p
        u.copy_(upd)
        wsq.append(_block_sums(p * p))
        usq.append(_block_sums(upd * upd))
    return torch.cat(wsq), torch.cat(usq)


def _check_lists(ps, gs, ms, vs, us):
    dev = ps[0].device
    if gs[0].dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(
            f"lamb_phase1 takes float32, bfloat16 or float16 grads, got "
            f"{gs[0].dtype}"
        )
    for name, ts in (("p", ps), ("g", gs), ("m", ms), ("v", vs), ("u", us)):
        for t in ts:
            if not t.is_cuda or t.device != dev:
                raise RuntimeError(
                    f"lamb_phase1's CUDA kernel needs every tensor on {dev}, "
                    f"got {name} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError(f"lamb_phase1 needs contiguous tensors ({name})")
            want = gs[0].dtype if name == "g" else torch.float32
            if t.dtype != want:
                raise TypeError(
                    f"lamb_phase1 takes float32 p/m/v/u and one grad dtype "
                    f"for every g, got {name} {t.dtype}"
                )
    for p, g, m, v, u in zip(ps, gs, ms, vs, us):
        if not (p.numel() == g.numel() == m.numel() == v.numel() == u.numel()):
            raise ValueError("lamb_phase1: p, g, m, v and u differ in size")


def _lamb_phase1_cuda(ps, gs, ms, vs, us, c1, c2, grad_scale, *, b1, b2,
                      eps, weight_decay, eps_inside_sqrt):
    """Launch csrc/lamb_phase1.cu over the tensors, through a device
    table of descriptors. Raises on what the kernel does not take."""
    from . import kernel_lib

    _check_lists(ps, gs, ms, vs, us)
    device = ps[0].device
    table = np.zeros((len(ps), 8), dtype=np.int64)
    first = 0
    for i, (p, g, m, v, u) in enumerate(zip(ps, gs, ms, vs, us)):
        table[i, :7] = (p.data_ptr(), g.data_ptr(), m.data_ptr(),
                        v.data_ptr(), u.data_ptr(), p.numel(), first)
        first += _nblocks(p.numel())
    if first >= 2**31:
        raise ValueError(f"lamb_phase1: {first} blocks exceed the grid")
    table_d = _upload(table, device)
    wsq = torch.empty(first, dtype=torch.float32, device=device)
    usq = torch.empty(first, dtype=torch.float32, device=device)
    lib = kernel_lib.load("lamb_phase1")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ds_lamb_phase1(
            table_d.data_ptr(), len(ps), first, wsq.data_ptr(),
            usq.data_ptr(), kernel_lib.dtype_code(gs[0].dtype),
            ctypes.c_float(c1), ctypes.c_float(c2),
            ctypes.c_float(grad_scale), ctypes.c_float(b1),
            ctypes.c_float(1.0 - b1), ctypes.c_float(b2),
            ctypes.c_float(1.0 - b2), ctypes.c_float(eps),
            ctypes.c_float(weight_decay), int(bool(eps_inside_sqrt)), stream,
        )
    kernel_lib.check(err, "lamb_phase1")
    lamb_phase1.launches += 1
    return wsq, usq


def lamb_phase1(ps, gs, ms, vs, us, c1, c2, grad_scale=None, *, b1, b2, eps,
                weight_decay, eps_inside_sqrt):
    """LAMB phase 1 (replaces the Pallas ``_lamb_phase1_kernel``) over
    parallel lists of p (float32), g (float32, bfloat16 or float16; one
    dtype for all), m, v (float32,
    updated in place) and u (float32, written). Returns per-block partial
    sums ``(wsq, usq)`` of p*p and u*u. CPU tensors run
    :func:`lamb_phase1_plain`; CUDA tensors launch the kernel."""
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              eps_inside_sqrt=eps_inside_sqrt)
    grad_scale = 1.0 if grad_scale is None else float(grad_scale)
    if ps[0].device.type == "cpu":
        return lamb_phase1_plain(ps, gs, ms, vs, us, c1, c2, grad_scale, **kw)
    return _lamb_phase1_cuda(ps, gs, ms, vs, us, c1, c2, grad_scale, **kw)


# launches of the CUDA kernel (the plain version is not counted)
lamb_phase1.launches = 0


def lamb_multi_tensor_update(ps, gs, ms, vs, us, c1, c2, lr, grad_scale=None,
                             *, b1, b2, eps, weight_decay, min_coeff,
                             max_coeff, eps_inside_sqrt):
    """LAMB over MANY groups in ONE phase-1 launch. ``ps``, ``gs``, ``ms``,
    ``vs``, ``us`` are lists of groups, each a list of tensors. Updates
    p, m and v in place; returns the trust ratios, one 0-d tensor per
    group."""
    flat = [[t for grp in lst for t in grp] for lst in (ps, gs, ms, vs, us)]
    wsq, usq = lamb_phase1(
        *flat, c1, c2, grad_scale, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, eps_inside_sqrt=eps_inside_sqrt,
    )
    # phase 2: per-group sums of the block partials
    blocks = [_nblocks(t.numel()) for t in flat[0]]
    groups = [gi for gi, grp in enumerate(ps) for _ in grp]
    seg = _upload(np.repeat(groups, blocks), wsq.device)
    zeros = torch.zeros(len(ps), dtype=torch.float32, device=wsq.device)
    w_norm = torch.sqrt(zeros.index_add(0, seg, wsq))
    u_norm = torch.sqrt(zeros.index_add(0, seg, usq))
    ratios = trust_ratio(w_norm, u_norm, min_coeff, max_coeff)
    # phase 3: p -= lr * ratio * u, group by group
    for gi, (grp_p, grp_u) in enumerate(zip(ps, us)):
        coef = lr * ratios[gi]
        for p, u in zip(grp_p, grp_u):
            p.sub_(coef * u)
    return [ratios[gi] for gi in range(len(ps))]


def lamb_leaf_update(ps, gs, ms, vs, us, c1, c2, lr, grad_scale=None, **kw):
    """LAMB over ONE group (one JAX leaf: a list of tensors) in one
    phase-1 launch; returns its trust ratio."""
    return lamb_multi_tensor_update(
        [ps], [gs], [ms], [vs], [us], c1, c2, lr, grad_scale, **kw
    )[0]


@dataclasses.dataclass
class FusedLamb(Lamb):
    """LAMB over the phase-1 kernel; the trust ratio and ``lamb_coeffs``
    of :class:`Lamb`. Groups of at most ``multi_tensor_max`` elements
    share one launch (when there are two or more); each larger group
    gets a launch of its own. For GPT-2 small that is five large groups
    (wte, attn_qkvw, attn_ow, inter_w, output_w) and one launch for the
    other eleven: six launches per step."""

    # b1 is fixed per launch, as the JAX kernel bakes it in: momentum
    # cycling needs 'Lamb'
    supports_mom = False
    multi_tensor_max: int = 1 << 21

    def __post_init__(self):
        self._scratch = {}  # name -> u, float32, the size of the param

    @torch.no_grad()
    def apply(self, params, grads, state, lr, grad_scale=None, mom=None):
        state["step"] += 1
        c1, c2 = bias_corrections(self.b1, self.b2, state["step"],
                                  self.bias_correction)
        for n, p in params.items():
            if n not in self._scratch:
                self._scratch[n] = torch.empty_like(p, dtype=torch.float32)
        kw = dict(b1=self.b1, b2=self.b2, eps=self.eps,
                  weight_decay=self.weight_decay, min_coeff=self.min_coeff,
                  max_coeff=self.max_coeff,
                  eps_inside_sqrt=self.eps_inside_sqrt)

        def lists(names):
            return ([params[n] for n in names], [grads[n] for n in names],
                    [state["mu"][n] for n in names],
                    [state["nu"][n] for n in names],
                    [self._scratch[n] for n in names])

        groups = param_groups(params)
        small = [
            g for g, names in groups.items()
            if self.multi_tensor_max
            and sum(params[n].numel() for n in names) <= self.multi_tensor_max
        ]
        if len(small) < 2:
            small = []
        ratios = {}
        if small:
            packed = [lists(groups[g]) for g in small]
            got = lamb_multi_tensor_update(
                *(list(col) for col in zip(*packed)), c1, c2, lr, grad_scale,
                **kw,
            )
            ratios.update(zip(small, got))
        for g, names in groups.items():
            if g not in ratios:
                ratios[g] = lamb_leaf_update(
                    *lists(names), c1, c2, lr, grad_scale, **kw
                )
        return {"lamb_coeffs": [ratios[g] for g in groups]}
