"""Fused LAMB over a hand-written CUDA phase-1 kernel.

Port of deepspeed_tpu/ops/pallas.py. Phase 1 of LAMB (Adam moments, the
update ``u``, and per-block partial sums of p*p and u*u) is one pass of
the kernel ``csrc/lamb_phase1.cu``, which replaces the Pallas kernel
``_lamb_phase1_kernel`` at both of its launch sites:

  - ``lamb_leaf_update``: one parameter group per launch (the JAX
    package's per-leaf launch);
  - ``lamb_multi_tensor_update``: many small groups in one launch (the
    JAX package's packed multi-leaf launch with a block -> segment map).

Phase 2 (the sum of each group's block partials, then the clamped trust
ratio) and phase 3 (``p -= lr * ratio * u``) stay in PyTorch, as the JAX
package leaves them to XLA. Phase 2 gathers each group's partials into a
row and sums the rows (``sum(dim=1)``), a fixed order on the card, so a
step is bitwise repeatable and a resumed run continues bit for bit
(``index_add_``, which it replaced, adds with atomics on CUDA).

A "group" is what the JAX tree holds as one leaf: ``h.*.attn_qkvw`` is
the twelve per-layer tensors of the port (``ops/optimizers.py:
param_groups``), and its trust ratio is one norm over all of them. The
functions here take each group as a list of tensors; they update the
parameters and the moments IN PLACE (the JAX functions return new
arrays) and write ``u`` into caller-provided scratch tensors.

``lamb_phase1`` is the kernel's wrapper: on CUDA tensors it launches the
kernel (or raises), on CPU tensors it runs ``lamb_phase1_plain``. The
kernel's descriptor table and block map, and phase 2's segment map, are
built once per set of tensor pointers and lengths and kept on the device,
so a step whose tensors have not moved copies nothing to the GPU
(``lamb_phase1.table_builds`` counts the builds).
"""

import collections
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


# the device tables, least recently used first: (device, grad size,
# pointers and lengths) -> descriptor table and block map, and (device,
# blocks, groups) -> phase 2's block -> group map
_tables = collections.OrderedDict()
_segments = collections.OrderedDict()
_CACHED_TABLES = 64


def _cached(cache, key):
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
    return hit


def _keep(cache, key, value):
    cache[key] = value
    if len(cache) > _CACHED_TABLES:
        cache.popitem(last=False)


def _device_table(ps, gs, ms, vs, us, device):
    """``(table, block_map, nblocks)`` on ``device`` for these tensors:
    the kernel's 64-byte descriptors (p, g, m, v, u, n, first block, a
    vector flag) and an int32 block -> tensor map. Built and uploaded once
    per set of pointers and lengths and kept, so a step whose tensors have
    not moved copies nothing to the device; every build counts on
    ``lamb_phase1.table_builds``."""
    gsize = gs[0].element_size()
    key = (device.index, gsize, tuple(
        (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
         u.data_ptr(), p.numel())
        for p, g, m, v, u in zip(ps, gs, ms, vs, us)))
    hit = _cached(_tables, key)
    if hit is not None:
        return hit
    table = np.zeros((len(ps), 8), dtype=np.int64)
    blocks = np.empty(len(ps), dtype=np.int64)
    first = 0
    for i, (*ptrs, n) in enumerate(key[2]):
        # 16-byte vectors of 4 elements: p/m/v/u 16-byte aligned, g
        # 4 * its element size, n a multiple of 4; else the scalar path
        vec = (n % 4 == 0 and ptrs[1] % (4 * gsize) == 0
               and all(ptr % 16 == 0 for ptr in ptrs[:1] + ptrs[2:]))
        table[i] = (*ptrs, n, first, int(vec))
        blocks[i] = _nblocks(n)
        first += int(blocks[i])
    if first >= 2**31:
        raise ValueError(f"lamb_phase1: {first} blocks exceed the grid")
    block_map = np.repeat(np.arange(len(ps), dtype=np.int32), blocks)
    hit = (_upload(table, device), _upload(block_map, device), first)
    _keep(_tables, key, hit)
    lamb_phase1.table_builds += 1
    return hit


def _lamb_phase1_cuda(ps, gs, ms, vs, us, c1, c2, grad_scale, *, b1, b2,
                      eps, weight_decay, eps_inside_sqrt):
    """Launch csrc/lamb_phase1.cu over the tensors, through the cached
    device table (:func:`_device_table`). Raises on what the kernel does
    not take."""
    from . import kernel_lib
    from .attention import _launch, _stream

    _check_lists(ps, gs, ms, vs, us)
    device = ps[0].device
    table_d, map_d, nblocks = _device_table(ps, gs, ms, vs, us, device)
    wsq = torch.empty(nblocks, dtype=torch.float32, device=device)
    usq = torch.empty(nblocks, dtype=torch.float32, device=device)
    lib = kernel_lib.load("lamb_phase1")
    err = _launch(
        device, lib.ds_lamb_phase1,
        table_d.data_ptr(), map_d.data_ptr(), nblocks, wsq.data_ptr(),
        usq.data_ptr(), kernel_lib.dtype_code(gs[0].dtype),
        # 1/c1 and 1/c2 in float32: PyTorch's CUDA ops divide by a scalar
        # through its reciprocal, and the kernel repeats their roundings
        ctypes.c_float(np.float32(1.0) / np.float32(c1)),
        ctypes.c_float(np.float32(1.0) / np.float32(c2)),
        ctypes.c_float(grad_scale),
        ctypes.c_float(b1), ctypes.c_float(1.0 - b1), ctypes.c_float(b2),
        ctypes.c_float(1.0 - b2), ctypes.c_float(eps),
        ctypes.c_float(weight_decay), int(bool(eps_inside_sqrt)),
        _stream(device),
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


# launches of the CUDA kernel (the plain version is not counted), and
# builds of the device tables (the descriptor table with its block map, and
# phase 2's segment map), each an upload to a GPU: none on a step whose
# tensors have not moved
lamb_phase1.launches = 0
lamb_phase1.table_builds = 0


def _segment_map(blocks, groups, device):
    """Phase 2's gather index on ``device``: row g holds the positions of
    group g's block partials, padded with one past the last block (where
    phase 2 appends a zero). Uploaded once per layout (counted on
    ``lamb_phase1.table_builds``)."""
    key = (device, tuple(blocks), tuple(groups))
    seg = _cached(_segments, key)
    if seg is None:
        total = int(sum(blocks))
        starts = np.cumsum([0] + list(blocks[:-1]))
        rows = [[] for _ in range(max(groups) + 1)]
        for start, n, g in zip(starts, blocks, groups):
            rows[g].extend(range(int(start), int(start) + int(n)))
        index = np.full((len(rows), max(len(r) for r in rows)), total,
                        np.int64)
        for g, r in enumerate(rows):
            index[g, :len(r)] = r
        seg = _upload(index, device)
        _keep(_segments, key, seg)
        lamb_phase1.table_builds += 1
    return seg


def _group_sums(partials, seg):
    """Per-group sums of the block partials in a fixed order."""
    padded = torch.cat([partials, partials.new_zeros(1)])
    return padded[seg].sum(dim=1)


def lamb_multi_tensor_update(ps, gs, ms, vs, us, c1, c2, lr, grad_scale=None,
                             *, b1, b2, eps, weight_decay, min_coeff,
                             max_coeff, eps_inside_sqrt, norm_reduce=None,
                             skip=None):
    """LAMB over MANY groups in ONE phase-1 launch. ``ps``, ``gs``, ``ms``,
    ``vs``, ``us`` are lists of groups, each a list of tensors. Updates
    p, m and v in place; returns the trust ratios, one 0-d tensor per
    group. Over ZeRO shards, ``skip`` (lists of bools like ``ps``) leaves
    out of the norms the tensors another rank counts, and ``norm_reduce``
    sums the ``[groups, 2]`` partial squared norms over the ranks a
    group spans (the data group's shards and experts, the pipeline's
    stages: the engine's world) in place before the ratios."""
    flat = [[t for grp in lst for t in grp] for lst in (ps, gs, ms, vs, us)]
    wsq, usq = lamb_phase1(
        *flat, c1, c2, grad_scale, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, eps_inside_sqrt=eps_inside_sqrt,
    )
    # phase 2: per-group sums of the block partials
    blocks = [_nblocks(t.numel()) for t in flat[0]]
    if skip is not None:
        first = 0
        for n, out in zip(blocks, (s for grp in skip for s in grp)):
            if out:
                wsq[first:first + n] = 0.0
                usq[first:first + n] = 0.0
            first += n
    groups = [gi for gi, grp in enumerate(ps) for _ in grp]
    seg = _segment_map(blocks, groups, wsq.device)
    sums = torch.stack([_group_sums(wsq, seg), _group_sums(usq, seg)])
    if norm_reduce is not None:
        sums = sums.t().contiguous()
        norm_reduce(sums)
        sums = sums.t()
    ratios = trust_ratio(torch.sqrt(sums[0]), torch.sqrt(sums[1]),
                         min_coeff, max_coeff)
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
        if self.state_dtype != "fp32":
            # the kernel reads and writes float32 moments
            raise ValueError("FusedLamb's kernel reads fp32 moments; use "
                             "'Lamb' for a reduced state_dtype")
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
        sharded = self.norm_reduce is not None

        def lists(names):
            return ([params[n] for n in names], [grads[n] for n in names],
                    [state["mu"][n] for n in names],
                    [state["nu"][n] for n in names],
                    [self._scratch[n] for n in names])

        def over_shards(names_of_groups):
            if not sharded:
                return {}
            return {"norm_reduce": self.norm_reduce,
                    "skip": [[n in self.norm_skip for n in names]
                             for names in names_of_groups]}

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
                **kw, **over_shards([groups[g] for g in small]),
            )
            ratios.update(zip(small, got))
        for g, names in groups.items():
            if g not in ratios:
                ratios[g] = lamb_leaf_update(
                    *lists(names), c1, c2, lr, grad_scale, **kw,
                    **over_shards([names]),
                )
        return {"lamb_coeffs": [ratios[g] for g in groups]}
