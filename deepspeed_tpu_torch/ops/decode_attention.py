"""The decode kernels: single-query attention over the paged KV pool, and
the multi-LoRA SGMV product.

Port of ``paged_flash_decode`` in deepspeed_tpu/ops/decode_attention.py.
The JAX package runs a Pallas kernel (``_flash_decode_kernel``) whose
grid walks (slot, logical page) with the block table as a scalar-prefetch
operand; here the same function is a CUDA kernel written for Hopper
(csrc/paged_decode.cu): one thread block per (head, slot), whose warps
read the slot's block-table row and position themselves and walk its
live pages in place.

Semantics (both versions): keys at logical index ``<= positions[b]``
attend; a page whose physical id is 0 (the NULL page: dead slots,
unallocated table entries, wherever it sits in the table) is skipped
whole; a slot with no live key gives exact zeros. The caller has already
written this step's k/v into the pool.

:func:`lora_sgmv` ports the same JAX module's ``lora_sgmv`` (the Pallas
``_sgmv_kernel``, Punica's SGMV shape): each slot's LoRA delta
``x @ A[id] @ B[id]`` read straight from the adapter pool by the slot's
id, with no gathered ``[B, in, r]`` / ``[B, r, out]`` weight stacks. Here
it is csrc/sgmv.cu: one thread block per (slot, tile of 1024 output
columns), which reads its slot's id itself; id 0 (the identity row)
writes exact zeros without reading the pool.
"""

import ctypes

import torch

from .attention import NEG_INF


def paged_flash_decode_plain(q, k_pool, v_pool, block_tables, positions,
                             sm_scale=None):
    """The kernel's function in plain PyTorch: gather each slot's pages,
    mask keys past its position and keys on the NULL page, softmax in
    float32, probabilities cast to the pool's dtype before the value
    product. ``q`` [B, heads, hd]; pools [num_blocks, block_size, heads,
    hd]; ``block_tables`` [B, max_blocks]; ``positions`` [B]. Returns
    [B, heads, hd] in the pool's dtype."""
    b, heads, hd = q.shape
    block_size = k_pool.shape[1]
    max_blocks = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (hd ** 0.5)
    tables = block_tables.long()
    n = max_blocks * block_size
    k_full = k_pool[tables].reshape(b, n, heads, hd)
    v_full = v_pool[tables].reshape(b, n, heads, hd)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k_full.float()) * sm_scale
    tok = torch.arange(n, device=q.device)
    live_page = (tables != 0).repeat_interleave(block_size, dim=1)  # [B, n]
    valid = (tok[None, :] <= positions.long()[:, None]) & live_page
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum(
        "bhk,bkhd->bhd", p.to(v_pool.dtype).float(), v_full.float()
    )
    return (acc / l).to(v_pool.dtype)


def _paged_decode_cuda(q, k_pool, v_pool, block_tables, positions,
                       sm_scale):
    """Launch csrc/paged_decode.cu on CUDA tensors. Raises on anything the
    kernel does not take; never runs the plain version."""
    from . import kernel_lib

    tensors = (q, k_pool, v_pool, block_tables, positions)
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError(
            "paged_decode's CUDA kernel needs CUDA tensors, got "
            + "/".join(str(t.device) for t in tensors)
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_decode's operands must lie on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"paged_decode takes float32 or bfloat16, got {q.dtype}"
        )
    if not (k_pool.dtype == v_pool.dtype == q.dtype):
        raise TypeError("q and the k/v pools must share a dtype")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("block_tables and positions must be int32")
    if q.ndim != 3 or k_pool.ndim != 4:
        raise ValueError(
            "q must be [B, heads, hd] and the pools [num_blocks, "
            "block_size, heads, hd]"
        )
    b, heads, hd = q.shape
    num_blocks, block_size = k_pool.shape[0], k_pool.shape[1]
    if tuple(k_pool.shape) != (num_blocks, block_size, heads, hd) or (
        v_pool.shape != k_pool.shape
    ):
        raise ValueError(
            f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
            f"not match q {tuple(q.shape)}"
        )
    if hd not in (64, 128):
        raise ValueError(f"paged_decode takes head_dim 64 or 128, got {hd}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b or (
        tuple(positions.shape) != (b,)
    ):
        raise ValueError(
            f"block_tables must be [{b}, max_blocks] and positions [{b}]"
        )
    if b > 65535:
        raise ValueError(f"paged_decode takes B <= 65535, got {b}")
    for name, t in zip(("q", "k_pool", "v_pool", "block_tables",
                        "positions"), tensors):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode needs a 16-byte aligned {name}")
    lib = kernel_lib.load("paged_decode")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ds_paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            b, heads, hd, block_size, block_tables.shape[1],
            kernel_lib.dtype_code(q.dtype), ctypes.c_float(sm_scale), stream,
        )
    kernel_lib.check(err, "paged_decode")
    paged_flash_decode.launches += 1
    return out


def paged_flash_decode(q, k_pool, v_pool, block_tables, positions,
                       sm_scale=None):
    """Fused single-query attention over the paged KV pool (replaces the
    JAX package's Pallas ``_flash_decode_kernel``). ``q`` [B, heads, hd];
    ``k_pool``/``v_pool`` [num_blocks, block_size, heads, hd] (one layer's
    pool, physical page 0 the NULL page); ``block_tables`` [B,
    max_blocks] int32; ``positions`` [B] int32. Returns [B, heads, hd].
    CPU tensors run :func:`paged_flash_decode_plain`; CUDA tensors launch
    the kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return paged_flash_decode_plain(
            q, k_pool, v_pool, block_tables, positions, sm_scale
        )
    return _paged_decode_cuda(
        q, k_pool, v_pool, block_tables, positions, float(sm_scale)
    )


# launches of the CUDA kernel (the plain version is not counted)
paged_flash_decode.launches = 0


#: The largest LoRA rank csrc/sgmv.cu takes: its t vector ([rank] float32)
#: sits in the 48 KB of dynamic shared memory a launch gets without an
#: opt-in, the kernel's own refusal (``launch`` in sgmv.cu).
#: ``init_inference`` refuses a larger rank under ``fused_decode`` instead
#: of falling back to the gathered path.
SGMV_MAX_RANK = 48 * 1024 // 4


def lora_sgmv_plain(x, a_pool, b_pool, ids):
    """The SGMV kernel's function in plain PyTorch: ``t = x @ A[id]``
    accumulated in float32 and ROUNDED to B's dtype (the Pallas kernel's
    ``t.astype(b_ref.dtype)``), then ``t @ B[id]`` accumulated in float32.
    ``x`` [B, in]; ``a_pool`` [n+1, in, r]; ``b_pool`` [n+1, r, out];
    ``ids`` [B] int32 (row 0 the all-zeros identity). Returns the UNSCALED
    delta [B, out] in float32."""
    rows = ids.long()
    t = torch.einsum("bi,bir->br", x.float(), a_pool[rows].float())
    t = t.to(b_pool.dtype).float()
    return torch.einsum("br,bro->bo", t, b_pool[rows].float())


def _sgmv_cuda(x, a_pool, b_pool, ids):
    """Launch csrc/sgmv.cu on CUDA tensors. Raises on anything the kernel
    does not take; never runs the plain version."""
    from . import kernel_lib

    tensors = (x, a_pool, b_pool, ids)
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError(
            "sgmv's CUDA kernel needs CUDA tensors, got "
            + "/".join(str(t.device) for t in tensors)
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError("sgmv's operands must lie on one device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sgmv takes float32 or bfloat16, got {x.dtype}")
    if not (a_pool.dtype == b_pool.dtype == x.dtype):
        raise TypeError("x and the A/B pools must share a dtype")
    if ids.dtype != torch.int32:
        raise TypeError("sgmv's ids must be int32")
    if x.ndim != 2 or a_pool.ndim != 3 or b_pool.ndim != 3 or ids.ndim != 1:
        raise ValueError(
            "sgmv takes x [B, in], a_pool [n+1, in, r], b_pool [n+1, r, "
            "out] and ids [B]"
        )
    b, din = x.shape
    rows, _, rank = a_pool.shape
    dout = b_pool.shape[2]
    if tuple(a_pool.shape) != (rows, din, rank) or (
        tuple(b_pool.shape[:2]) != (rows, rank)
    ) or ids.shape[0] != b:
        raise ValueError(
            f"sgmv shapes do not match: x {tuple(x.shape)}, a_pool "
            f"{tuple(a_pool.shape)}, b_pool {tuple(b_pool.shape)}, ids "
            f"{tuple(ids.shape)}"
        )
    if not 1 <= rank <= SGMV_MAX_RANK:
        raise ValueError(
            f"sgmv takes ranks 1..{SGMV_MAX_RANK} (SGMV_MAX_RANK), got {rank}"
        )
    if b > 65535:
        raise ValueError(f"sgmv takes B <= 65535, got {b}")
    for name, t in zip(("x", "a_pool", "b_pool", "ids"), tensors):
        if not t.is_contiguous():
            raise ValueError(f"sgmv needs a contiguous {name}")
    lib = kernel_lib.load("sgmv")
    out = torch.empty((b, dout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ds_sgmv(
            x.data_ptr(), a_pool.data_ptr(), b_pool.data_ptr(),
            ids.data_ptr(), out.data_ptr(), b, rows, din, rank, dout,
            kernel_lib.dtype_code(x.dtype), stream,
        )
    kernel_lib.check(err, "sgmv")
    lora_sgmv.launches += 1
    return out


def lora_sgmv(x, a_pool, b_pool, ids):
    """Per-slot LoRA delta for the decode step (replaces the JAX package's
    Pallas ``_sgmv_kernel``): ``x`` [B, in] (one token per slot),
    ``a_pool`` [n+1, in, r] / ``b_pool`` [n+1, r, out] (row 0 the
    all-zeros identity), ``ids`` [B] int32. Returns the UNSCALED delta
    ``x @ A[id] @ B[id]`` [B, out] in float32; the caller applies the
    (alpha / r) scale and adds it to the base projection. CPU tensors run
    :func:`lora_sgmv_plain`; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return lora_sgmv_plain(x, a_pool, b_pool, ids)
    return _sgmv_cuda(x, a_pool, b_pool, ids)


# launches of the CUDA kernel (the plain version is not counted)
lora_sgmv.launches = 0
