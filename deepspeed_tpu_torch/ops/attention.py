"""Attention: the flash-attention kernels (forward, backward, dropout) and
the plain reference.

Port of deepspeed_tpu/ops/attention.py. The JAX package streams K/V
blocks through Pallas kernels with an online softmax (``_fwd_kernel``)
and differentiates them with two more (``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) under a ``jax.custom_vjp``; here the same three
functions are CUDA kernels written for Hopper (csrc/flash_fwd.cu,
csrc/flash_bwd.cu), bound through ctypes (ops/kernel_lib.py), under a
``torch.autograd.Function``. The C entry points route by dtype: bfloat16
and float16 take the tensor-core forward, dQ and dK/dV kernels (wgmma +
TMA, which need 16-byte-aligned operands); float32 takes the FMA kernels
(the tensor cores take float32 only as TF32).

Entry points:
  - ``mha_reference``: plain attention over an additive mask (the
    numerics oracle, and the path for short sequences and
    query-dependent biases).
  - ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``: the kernels'
    wrappers. On CUDA tensors each launches its kernel (or raises); on
    CPU tensors it runs its ``*_plain`` version, the same function in
    plain PyTorch.
  - ``flash_attention``: the JAX package's signature, differentiable.
  - ``attention``: dispatcher between the two (padding masks and
    ``FLASH_MIN_SEQ``, as in the JAX package).

Dropout: the TPU kernels seed the chip's generator per tile, so their
masks depend on the tiling and cannot be reproduced. The port's keep bit
is a hash of (seed, batch*head, query index, key index)
(``dropout_keep_mask``, csrc/dropout.cuh), so every kernel, every plain
version and ``mha_reference`` draw the same mask from the same seed.
"""

import ctypes

import torch

NEG_INF = -1e30

# Below this sequence length the dispatcher takes ``mha_reference``.
# Inherited from the JAX package, which measured it on a TPU v5e (BERT-large
# seq 128 trained ~9% faster through XLA); not measured on the card.
FLASH_MIN_SEQ = 256

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32): the product split
    at 16 bits of ``c`` so that no int64 intermediate overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    """The 32-bit mixing hash of csrc/dropout.cuh (lowbias32), on int64
    tensors holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_threshold(rate):
    """A pair is kept when its 32 bits are >= this (the JAX rule)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    return int(rate * (2**32))


def dropout_keep_mask(seed, shape, rate, device):
    """The attention-dropout keep mask, bool [B, H, Sq, Sk]: pair (q, k) of
    batch*head ``bh`` is kept when mix(mix(mix(mix(seed) ^ bh) ^ q) ^ k)
    >= ``dropout_threshold(rate)`` — the function the kernels compute."""
    b, h, sq, sk = shape
    seed_t = torch.tensor(int(seed) & _M32, dtype=torch.int64, device=device)
    bh = torch.arange(b * h, dtype=torch.int64, device=device)
    qi = torch.arange(sq, dtype=torch.int64, device=device)
    kj = torch.arange(sk, dtype=torch.int64, device=device)
    row = _mix32(_mix32(_mix32(seed_t) ^ bh)[:, None] ^ qi[None, :])
    bits = _mix32(row[:, :, None] ^ kj[None, None, :])
    return (bits >= dropout_threshold(rate)).reshape(b, h, sq, sk)


def _visible(sq, sk, kv_mask, causal, device):
    """Which (query, key) pairs attend: the causal mask aligned
    bottom-right (``diag_offset = sk - sq``) and the key validity vector;
    bool, broadcastable to [B, H, Sq, Sk]."""
    valid = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        idx_q = torch.arange(sq, device=device)[:, None]
        idx_k = torch.arange(sk, device=device)[None, :]
        valid = idx_k <= idx_q + (sk - sq)
    valid = valid[None, None]
    if kv_mask is not None:
        valid = valid & (kv_mask != 0)[:, None, None, :]
    return valid


def _scores(q, k, sm_scale):
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale


def mha_reference(q, k, v, mask=None, causal=False, sm_scale=None,
                  dropout_rate=0.0, dropout_seed=None):
    """Plain attention. q,k,v: [B, H, S, D]; mask: additive, broadcastable
    to [B, H, Sq, Sk]. Scores and softmax in float32; the probabilities
    are cast to v's dtype before the value product, as in the JAX path.
    Dropout (``dropout_rate > 0`` with a ``dropout_seed``) uses the
    kernels' mask, :func:`dropout_keep_mask`."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores(q, k, sm_scale)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        idx_q = torch.arange(sq, device=s.device)[:, None]
        idx_k = torch.arange(sk, device=s.device)[None, :]
        s = torch.where(idx_k <= idx_q + (sk - sq), s, NEG_INF)
    if mask is not None:
        s = s + mask.to(s.dtype)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0 and dropout_seed is not None:
        keep = dropout_keep_mask(dropout_seed, p.shape, dropout_rate, p.device)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()
    ).to(v.dtype)


def additive_mask_to_kv_valid(mask):
    """Convert a padding-style additive mask (broadcast over the query
    dim, shape [B, 1, 1, Sk] or [B, Sk]) to a [B, Sk] int32 validity
    vector. Returns None if the mask depends on the query position."""
    if mask is None:
        return None
    if mask.ndim == 2:
        return (mask > NEG_INF / 2).to(torch.int32)
    if mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        return (mask[:, 0, 0, :] > NEG_INF / 2).to(torch.int32)
    return None


def flash_fwd_plain(q, k, v, kv_mask=None, causal=False, sm_scale=None,
                    dropout_rate=0.0, dropout_seed=0):
    """The forward kernel's function in plain PyTorch: attention with a
    causal mask aligned bottom-right and a per-key validity vector
    ``kv_mask`` [B, Sk]; a row with no valid key gives exact zeros. With
    dropout the kept probabilities that weight V are divided by
    ``1 - rate`` and the dropped ones are 0, while ``l`` (and so ``lse``)
    comes from the undropped ``p``. Returns ``(out [B,H,Sq,D] in q's
    dtype, lse [B,H,Sq] float32)``, ``lse = m + log(l)`` (``l`` taken as
    1 where it is 0, as the kernel does)."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    valid = _visible(q.shape[2], k.shape[2], kv_mask, causal, q.device)
    s = torch.where(valid, _scores(q, k, sm_scale), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, p.shape, dropout_rate, q.device)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    return out, lse


def _bwd_terms(q, k, v, kv_mask, dout, lse, delta, causal, sm_scale,
               dropout_rate, dropout_seed):
    """``(p_drop, ds)`` of the backward kernels, float32 [B, H, Sq, Sk]:
    p = exp(s - lse) on visible pairs, dp = dO v^T with the forward's
    dropout, ds = p * (dp - delta)."""
    valid = _visible(q.shape[2], k.shape[2], kv_mask, causal, q.device)
    s = _scores(q, k, sm_scale)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    p_drop = p
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, p.shape, dropout_rate, q.device)
        dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
        p_drop = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return p_drop, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, kv_mask, dout, lse, delta, causal=False,
                       sm_scale=None, dropout_rate=0.0, dropout_seed=0):
    """The dQ kernel's function in plain PyTorch: dQ = scale * ds K, ds
    rounded to the storage type before the product."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    _, ds = _bwd_terms(q, k, v, kv_mask, dout, lse, delta, causal, sm_scale,
                       dropout_rate, dropout_seed)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(q.dtype).float(), k.float())
    return (sm_scale * dq).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, kv_mask, dout, lse, delta, causal=False,
                        sm_scale=None, dropout_rate=0.0, dropout_seed=0):
    """The dK/dV kernel's function in plain PyTorch: dK = scale * ds^T Q,
    dV = p_drop^T dO, each operand rounded to the storage type first."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    p_drop, ds = _bwd_terms(q, k, v, kv_mask, dout, lse, delta, causal,
                            sm_scale, dropout_rate, dropout_seed)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p_drop.to(dout.dtype).float(),
                      dout.float())
    return (sm_scale * dk).to(k.dtype), dv.to(v.dtype)


def _check_cuda(name, q, k, v, kv_mask, *more):
    """Validate the operands a flash kernel takes; returns ``(b, h, sq, sk,
    d, kv_mask pointer or None)``. Raises on anything else."""
    # plain loops and get_device(): this runs on every launch, and the
    # serving path's prefill pays its host time once a layer
    tensors = (q, k, v) + more
    for t in tensors:
        if not t.is_cuda:
            raise RuntimeError(
                f"{name}'s CUDA kernel needs CUDA tensors, got "
                f"{'/'.join(str(t.device) for t in tensors)}"
            )
    index = q.get_device()
    for t in tensors:
        if t.get_device() != index:
            raise ValueError(f"{name}: every operand must lie on one device")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(
            f"{name} takes float32, bfloat16 or float16, got {q.dtype}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError("q, k and v must share a dtype")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be [B, H, S, D]")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    if d not in (64, 128):
        raise ValueError(f"{name} takes head_dim 64 or 128, got {d}")
    if b * h > 65535:
        raise ValueError(f"{name} takes B*H <= 65535, got {b * h}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous operands")
    if q.dtype != torch.float32:
        for t in tensors:
            if t.dtype == q.dtype and t.data_ptr() % 16:
                raise ValueError(
                    f"{name}: the tensor-core kernel loads its {q.dtype} "
                    "operands by TMA, which needs 16-byte-aligned storage (a "
                    "view with an odd storage offset is refused; pass "
                    ".clone())"
                )
    if kv_mask is None:
        return b, h, sq, sk, d, None
    if (
        kv_mask.device != q.device
        or kv_mask.dtype != torch.int32
        or tuple(kv_mask.shape) != (b, sk)
        or not kv_mask.is_contiguous()
    ):
        raise ValueError(
            f"kv_mask must be a contiguous int32 [{b}, {sk}] tensor on "
            f"{q.device}, got {kv_mask.dtype} {tuple(kv_mask.shape)} on "
            f"{kv_mask.device}"
        )
    return b, h, sq, sk, d, kv_mask.data_ptr()


def _check_rows(name, q, dout, lse, delta):
    b, h, sq, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{name}: dout must match q's shape and dtype")
    for what, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq):
            raise ValueError(
                f"{name}: {what} must be float32 [{b}, {h}, {sq}], got "
                f"{t.dtype} {tuple(t.shape)}"
            )


def _dropout_args(rate, seed):
    """The kernels' dropout arguments: on/off, threshold, keep, seed."""
    if rate <= 0.0:
        return 0, 0, ctypes.c_float(1.0), 0
    return (1, dropout_threshold(rate), ctypes.c_float(1.0 - rate),
            int(seed) & _M32)


def _stream(device):
    """The raw handle of ``device``'s current stream: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(device, fn, *args):
    """Call a C entry point with ``device`` current (the kernels launch on
    the current device); the switch is skipped when it already is, since
    the serving path pays this host time on every prefill layer."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def _flash_fwd_cuda(q, k, v, kv_mask, causal, sm_scale, dropout_rate=0.0,
                    dropout_seed=0):
    """Launch csrc/flash_fwd.cu on CUDA tensors. Raises on anything the
    kernel does not take; never runs the plain version."""
    from . import kernel_lib

    b, h, sq, sk, d, mask_ptr = _check_cuda("flash_fwd", q, k, v, kv_mask)
    lib = kernel_lib.load("flash_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _launch(
        q.device, lib.ds_flash_fwd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
        out.data_ptr(), lse.data_ptr(),
        b, h, sq, sk, d, kernel_lib.dtype_code(q.dtype),
        int(bool(causal)), ctypes.c_float(sm_scale),
        *_dropout_args(dropout_rate, dropout_seed), _stream(q.device),
    )
    kernel_lib.check(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_fwd(q, k, v, kv_mask=None, causal=False, sm_scale=None,
              dropout_rate=0.0, dropout_seed=0):
    """Flash-attention forward (replaces the JAX package's Pallas
    ``_fwd_kernel``). q,k,v: [B, H, S, D]; ``kv_mask`` [B, Sk] int32
    (nonzero = attend) or None; attention dropout at ``dropout_rate``
    with the mask of ``dropout_seed``. Returns ``(out, lse)``. CPU
    tensors run :func:`flash_fwd_plain`; CUDA tensors launch the
    kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, kv_mask, causal, sm_scale,
                               dropout_rate, dropout_seed)
    return _flash_fwd_cuda(q, k, v, kv_mask, causal, float(sm_scale),
                           dropout_rate, dropout_seed)


def _flash_bwd_cuda(which, q, k, v, kv_mask, dout, lse, delta, causal,
                    sm_scale, dropout_rate, dropout_seed):
    """Launch one of csrc/flash_bwd.cu's kernels ("dq" or "dkv")."""
    from . import kernel_lib

    name = f"flash_bwd_{which}"
    b, h, sq, sk, d, mask_ptr = _check_cuda(name, q, k, v, kv_mask, dout,
                                            lse, delta)
    _check_rows(name, q, dout, lse, delta)
    lib = kernel_lib.load("flash_bwd")
    outs = (torch.empty_like(q),) if which == "dq" else (
        torch.empty_like(k), torch.empty_like(v))
    fn = lib.ds_flash_bwd_dq if which == "dq" else lib.ds_flash_bwd_dkv
    err = _launch(
        q.device, fn,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(t.data_ptr() for t in outs),
        b, h, sq, sk, d, kernel_lib.dtype_code(q.dtype),
        int(bool(causal)), ctypes.c_float(sm_scale),
        *_dropout_args(dropout_rate, dropout_seed), _stream(q.device),
    )
    kernel_lib.check(err, name)
    return outs


def flash_bwd_dq(q, k, v, kv_mask, dout, lse, delta, causal=False,
                 sm_scale=None, dropout_rate=0.0, dropout_seed=0):
    """dQ of flash attention (replaces the Pallas ``_bwd_dq_kernel``)
    from the forward's ``lse`` and ``delta = rowsum(dO * O)`` (both
    [B, H, Sq] float32). CPU tensors run :func:`flash_bwd_dq_plain`;
    CUDA tensors launch the kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, kv_mask, dout, lse, delta, causal,
                                  sm_scale, dropout_rate, dropout_seed)
    (dq,) = _flash_bwd_cuda("dq", q, k, v, kv_mask, dout, lse, delta, causal,
                            float(sm_scale), dropout_rate, dropout_seed)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, kv_mask, dout, lse, delta, causal=False,
                  sm_scale=None, dropout_rate=0.0, dropout_seed=0):
    """``(dK, dV)`` of flash attention (replaces the Pallas
    ``_bwd_dkv_kernel``). CPU tensors run :func:`flash_bwd_dkv_plain`;
    CUDA tensors launch the kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, kv_mask, dout, lse, delta, causal,
                                   sm_scale, dropout_rate, dropout_seed)
    dk, dv = _flash_bwd_cuda("dkv", q, k, v, kv_mask, dout, lse, delta,
                             causal, float(sm_scale), dropout_rate,
                             dropout_seed)
    flash_bwd_dkv.launches += 1
    return dk, dv


# launches of the CUDA kernels (the plain versions are not counted)
flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """The JAX package's ``_flash`` custom VJP: the forward kernel saves
    ``(out, lse)`` as residuals; the backward forms ``delta =
    rowsum(dO * O)`` in PyTorch (the JAX package leaves it to XLA) and
    launches the dQ and dK/dV kernels. ``kv_mask`` and the seed take no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, sm_scale, dropout_rate,
                dropout_seed):
        out, lse = flash_fwd(q, k, v, kv_mask, causal, sm_scale,
                             dropout_rate, dropout_seed)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.args = (causal, sm_scale, dropout_rate, dropout_seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        causal, sm_scale, rate, seed = ctx.args
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, kv_mask, dout, lse, delta, causal,
                          sm_scale, rate, seed)
        dk, dv = flash_bwd_dkv(q, k, v, kv_mask, dout, lse, delta, causal,
                               sm_scale, rate, seed)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, mask=None, kv_mask=None, causal=False,
                    sm_scale=None, dropout_rate=0.0, dropout_seed=0):
    """Blockwise flash attention, differentiable in q, k and v. q,k,v:
    [B, H, S, D]. Masking: ``kv_mask`` [B, Sk] (nonzero = attend) or a
    padding-style additive ``mask`` (converted). Attention dropout at
    ``dropout_rate`` with the mask of ``dropout_seed``."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if kv_mask is None and mask is not None:
        kv_mask = additive_mask_to_kv_valid(mask)
        if kv_mask is None:
            raise ValueError(
                "flash_attention only supports padding-style masks "
                "(broadcast over the query dim); use mha_reference for "
                "query-dependent additive biases"
            )
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.int32).contiguous()
    dropout_threshold(dropout_rate)  # validates the rate
    return FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), kv_mask, causal,
        float(sm_scale), float(dropout_rate), int(dropout_seed),
    )


def attention(q, k, v, mask=None, causal=False, sm_scale=None,
              dropout_rate=0.0, dropout_seed=None):
    """Dispatcher: the flash kernels when the mask is a padding mask and
    ``max(sq, sk) >= FLASH_MIN_SEQ``; the plain reference otherwise.
    Without a ``dropout_seed`` there is no dropout (the JAX path's
    no-rng rule). The JAX package also required both lengths to split
    into TPU tiles (the CUDA kernels mask a ragged last tile themselves,
    so any length routes) and sent dropout to its reference off the TPU
    (interpret mode has no generator; the port's mask is the same on
    every route, so dropout goes to the kernels)."""
    if dropout_seed is None:
        dropout_rate = 0.0
    sq, sk = q.shape[2], k.shape[2]
    kv_mask = additive_mask_to_kv_valid(mask)
    can_flash = (
        (mask is None or kv_mask is not None)
        and max(sq, sk) >= FLASH_MIN_SEQ
    )
    if can_flash:
        return flash_attention(
            q, k, v, kv_mask=kv_mask, causal=causal, sm_scale=sm_scale,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed or 0,
        )
    return mha_reference(
        q, k, v, mask=mask, causal=causal, sm_scale=sm_scale,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
    )
