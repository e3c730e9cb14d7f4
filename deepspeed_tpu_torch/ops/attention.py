"""Attention: the flash-attention forward kernel and the plain reference.

Port of deepspeed_tpu/ops/attention.py. The JAX package streams K/V
blocks through a Pallas kernel (``_fwd_kernel``) with an online softmax;
here the same function is a CUDA kernel written for Hopper
(csrc/flash_fwd.cu), bound through ctypes (ops/kernel_lib.py).

Entry points:
  - ``mha_reference``: plain attention over an additive mask (the
    numerics oracle, and the path for short sequences and
    query-dependent biases).
  - ``flash_fwd``: the kernel's wrapper. On a CUDA tensor it launches the
    kernel (or raises); on a CPU tensor it runs ``flash_fwd_plain``, the
    same function in plain PyTorch. Returns ``(out, lse)``.
  - ``flash_attention``: the JAX package's signature over ``flash_fwd``.
  - ``attention``: dispatcher between the two (padding masks and
    ``FLASH_MIN_SEQ``, as in the JAX package).

Only the forward is ported: the backward kernels and in-kernel dropout
arrive with the training slice, so ``dropout_rate > 0`` raises.
"""

import ctypes

import torch

NEG_INF = -1e30

# Below this sequence length the dispatcher takes ``mha_reference``.
# Inherited from the JAX package, which measured it on a TPU v5e (BERT-large
# seq 128 trained ~9% faster through XLA); not measured on the card.
FLASH_MIN_SEQ = 256


def mha_reference(q, k, v, mask=None, causal=False, sm_scale=None,
                  dropout_rate=0.0):
    """Plain attention. q,k,v: [B, H, S, D]; mask: additive, broadcastable
    to [B, H, Sq, Sk]. Scores and softmax in float32; the probabilities
    are cast to v's dtype before the value product, as in the JAX path."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout arrives with the training slice"
        )
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        idx_q = torch.arange(sq, device=s.device)[:, None]
        idx_k = torch.arange(sk, device=s.device)[None, :]
        s = torch.where(idx_k <= idx_q + (sk - sq), s, NEG_INF)
    if mask is not None:
        s = s + mask.to(s.dtype)
    p = torch.softmax(s, dim=-1)
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


def flash_fwd_plain(q, k, v, kv_mask=None, causal=False, sm_scale=None):
    """The kernel's function in plain PyTorch: attention with a causal
    mask aligned bottom-right (``diag_offset = sk - sq``) and a per-key
    validity vector ``kv_mask`` [B, Sk]; a row with no valid key gives
    exact zeros. Returns ``(out [B,H,Sq,D] in q's dtype, lse [B,H,Sq]
    float32)``, with ``lse = m + log(l)`` (``l`` taken as 1 where it is
    0, as the kernel does)."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    sq, sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    valid = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        idx_q = torch.arange(sq, device=q.device)[:, None]
        idx_k = torch.arange(sk, device=q.device)[None, :]
        valid = idx_k <= idx_q + (sk - sq)
    valid = valid[None, None]
    if kv_mask is not None:
        valid = valid & (kv_mask != 0)[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    return out, lse


def _flash_fwd_cuda(q, k, v, kv_mask, causal, sm_scale):
    """Launch csrc/flash_fwd.cu on CUDA tensors. Raises on anything the
    kernel does not take; never runs the plain version."""
    from . import kernel_lib

    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise RuntimeError(
            "flash_fwd's CUDA kernel needs CUDA tensors, got "
            f"{q.device}/{k.device}/{v.device}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_fwd takes float32 or bfloat16, got {q.dtype}")
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
        raise ValueError(f"flash_fwd takes head_dim 64 or 128, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash_fwd takes B*H <= 65535, got {b * h}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd needs a contiguous {name}")
    mask_ptr = None
    if kv_mask is not None:
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
        mask_ptr = kv_mask.data_ptr()
    lib = kernel_lib.load("flash_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ds_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
            out.data_ptr(), lse.data_ptr(),
            b, h, sq, sk, d, kernel_lib.dtype_code(q.dtype),
            int(bool(causal)), ctypes.c_float(sm_scale), stream,
        )
    kernel_lib.check(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_fwd(q, k, v, kv_mask=None, causal=False, sm_scale=None):
    """Flash-attention forward (replaces the JAX package's Pallas
    ``_fwd_kernel``). q,k,v: [B, H, S, D]; ``kv_mask`` [B, Sk] int32
    (nonzero = attend) or None. Returns ``(out, lse)``. CPU tensors run
    :func:`flash_fwd_plain`; CUDA tensors launch the kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, kv_mask, causal, sm_scale)
    return _flash_fwd_cuda(q, k, v, kv_mask, causal, float(sm_scale))


# launches of the CUDA kernel (the plain version is not counted)
flash_fwd.launches = 0


def flash_attention(q, k, v, mask=None, kv_mask=None, causal=False,
                    sm_scale=None, dropout_rate=0.0):
    """Blockwise flash attention. q,k,v: [B, H, S, D]. Masking:
    ``kv_mask`` [B, Sk] (nonzero = attend) or a padding-style additive
    ``mask`` (converted). ``dropout_rate > 0`` raises."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "in-kernel attention dropout arrives with the training slice"
        )
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
    out, _ = flash_fwd(q, k, v, kv_mask, causal, sm_scale)
    return out


def attention(q, k, v, mask=None, causal=False, sm_scale=None,
              dropout_rate=0.0):
    """Dispatcher: the flash kernel when the mask is a padding mask and
    ``max(sq, sk) >= FLASH_MIN_SEQ``; the plain reference otherwise. The
    JAX package also required both lengths to split into TPU tiles; the
    CUDA kernel masks a ragged last tile itself, so any length routes."""
    sq, sk = q.shape[2], k.shape[2]
    kv_mask = additive_mask_to_kv_valid(mask)
    can_flash = (
        (mask is None or kv_mask is not None)
        and max(sq, sk) >= FLASH_MIN_SEQ
    )
    if can_flash:
        return flash_attention(
            q, k, v, kv_mask=kv_mask, causal=causal, sm_scale=sm_scale,
            dropout_rate=dropout_rate,
        )
    return mha_reference(
        q, k, v, mask=mask, causal=causal, sm_scale=sm_scale,
        dropout_rate=dropout_rate,
    )
