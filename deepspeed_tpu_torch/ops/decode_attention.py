"""The decode kernels: single-query attention over the paged KV pool, and
the multi-LoRA SGMV product.

Port of ``paged_flash_decode`` in deepspeed_tpu/ops/decode_attention.py.
The JAX package runs a Pallas kernel (``_flash_decode_kernel``) whose
grid walks (slot, logical page) with the block table as a scalar-prefetch
operand; here the same function is a CUDA kernel written for Hopper
(csrc/paged_decode.cu): a grid of (head, slot, split) blocks, each of
which reads its slot's block-table row and position itself and walks a
fixed run of the slot's live pages in place; the splits of a (slot,
head) merge in the same launch (:func:`decode_splits`).

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

from . import kernel_lib
from .attention import NEG_INF, _launch, _stream


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


#: Blocks of csrc/paged_decode.cu that one SM holds at once (its 64 KB
#: cp.async ring each, in the 227 KB of shared memory). The grid aims at
#: one wave of them for the longest possible slot.
DECODE_BLOCKS_PER_SM = 3

_sm_counts = {}     # device index -> SM count
_configs = {}       # (b, heads, hd, max_blocks, device) -> launch config
_checked_pools = {}  # pool key -> (heads, hd, dtype, device index)


def decode_splits(b, heads, max_blocks, device):
    """``(splits, pages_per_split)`` of the paged decode grid: as many
    blocks per (slot, head) as fit ``b * heads * splits`` blocks into one
    wave (:data:`DECODE_BLOCKS_PER_SM` on each SM), at least one, never
    more splits than table columns. Depends on the shapes alone, never on
    the positions (reading them would sync with the device)."""
    index = device.index
    sms = _sm_counts.get(index)
    if sms is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _sm_counts[index] = sms
    fit = DECODE_BLOCKS_PER_SM * sms // (b * heads)
    splits = max(1, min(max_blocks, fit))
    per = -(-max_blocks // splits)
    return -(-max_blocks // per), per


def _launch_config(b, heads, hd, max_blocks, index):
    """``(splits, workspace pointer, counters pointer)`` for one launch
    shape on device ``index``, made once: the split merge's float32
    workspace and int32 ticket counters are allocated here (the counters
    zeroed once; every launch leaves them zero again) and kept alive in
    the cache. Calls of one shape on one device share them, so they must
    not overlap on two streams."""
    key = (b, heads, hd, max_blocks, index)
    config = _configs.get(key)
    if config is None:
        device = torch.device("cuda", index)
        splits, _ = decode_splits(b, heads, max_blocks, device)
        if splits == 1:
            config = (1, None, None)
        else:
            ws = torch.empty(b * heads * splits * (hd + 2),
                             dtype=torch.float32, device=device)
            counters = torch.zeros(b * heads, dtype=torch.int32,
                                   device=device)
            config = (splits, ws.data_ptr(), counters.data_ptr(), ws,
                      counters)
        if len(_configs) >= 64:
            _configs.clear()
        _configs[key] = config
    return config


def _check_pools(k_pool, v_pool):
    """Validate the pools once per (storage, shape, stride, dtype,
    device) — the engine allocates them once — and return ``(heads, hd,
    dtype, device index)`` for the per-call match with q."""
    key = (k_pool.data_ptr(), v_pool.data_ptr(), k_pool.shape,
           v_pool.shape, k_pool.stride(), v_pool.stride(), k_pool.dtype,
           v_pool.dtype, k_pool.get_device(), v_pool.get_device())
    info = _checked_pools.get(key)
    if info is not None:
        return info
    if not (k_pool.is_cuda and v_pool.is_cuda):
        raise RuntimeError(
            "paged_decode's CUDA kernel needs CUDA tensors, got pools on "
            f"{k_pool.device}/{v_pool.device}"
        )
    if k_pool.device != v_pool.device:
        raise ValueError("paged_decode's operands must lie on one device")
    if k_pool.dtype != v_pool.dtype:
        raise TypeError("q and the k/v pools must share a dtype")
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"the pools must be [num_blocks, block_size, heads, hd], got "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
        )
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode needs a 16-byte aligned {name}")
    info = (k_pool.shape[2], k_pool.shape[3], k_pool.dtype,
            k_pool.get_device())
    if len(_checked_pools) >= 64:
        _checked_pools.clear()
    _checked_pools[key] = info
    return info


def _paged_decode_cuda(q, k_pool, v_pool, block_tables, positions,
                       sm_scale):
    """Launch csrc/paged_decode.cu on CUDA tensors. Raises on anything the
    kernel does not take; never runs the plain version. The pools are
    checked once (:func:`_check_pools`); q, the table and the positions on
    every call."""
    if not q.is_cuda:
        raise RuntimeError(
            f"paged_decode's CUDA kernel needs CUDA tensors, got q on "
            f"{q.device}"
        )
    dtype = q.dtype
    if dtype != torch.float32 and dtype != torch.bfloat16:
        raise TypeError(f"paged_decode takes float32 or bfloat16, got {dtype}")
    shape = q.shape
    if len(shape) != 3:
        raise ValueError("q must be [B, heads, hd]")
    b, heads, hd = shape
    if hd != 64 and hd != 128:
        raise ValueError(f"paged_decode takes head_dim 64 or 128, got {hd}")
    if b > 65535:
        raise ValueError(f"paged_decode takes B <= 65535, got {b}")
    q_ptr = q.data_ptr()
    if q_ptr % 16 or not q.is_contiguous():
        raise ValueError("paged_decode needs a contiguous, 16-byte aligned q")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("block_tables and positions must be int32")
    t_shape = block_tables.shape
    if len(t_shape) != 2 or t_shape[0] != b or positions.shape != (b,):
        raise ValueError(
            f"block_tables must be [{b}, max_blocks] and positions [{b}]"
        )
    index = q.get_device()
    if block_tables.get_device() != index or positions.get_device() != index:
        raise ValueError("paged_decode's operands must lie on one device")
    if not (block_tables.is_contiguous() and positions.is_contiguous()):
        raise ValueError(
            "paged_decode needs a contiguous block_tables and positions")
    p_heads, p_hd, p_dtype, p_index = _check_pools(k_pool, v_pool)
    if p_dtype != dtype:
        raise TypeError("q and the k/v pools must share a dtype")
    if p_index != index:
        raise ValueError("paged_decode's operands must lie on one device")
    if p_heads != heads or p_hd != hd:
        raise ValueError(
            f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
            f"not match q {tuple(shape)}"
        )
    lib = kernel_lib.load("paged_decode")
    max_blocks = t_shape[1]
    splits, ws_ptr, counters_ptr = _launch_config(b, heads, hd, max_blocks,
                                                  index)[:3]
    out = torch.empty_like(q)
    err = _launch(
        q.device, lib.ds_paged_decode,
        q_ptr, k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        ws_ptr, counters_ptr, b, heads, hd, k_pool.shape[1], max_blocks,
        splits, kernel_lib.dtype_code(dtype), ctypes.c_float(sm_scale),
        _stream(q.device),
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
