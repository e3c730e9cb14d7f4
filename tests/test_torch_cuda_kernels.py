"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a GPU each test skips (the fixture decides
at run time). On the card run

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

bfloat16 and float16 run the tensor-core forward, dQ and dK/dV kernels
(wgmma + TMA), float32 the FMA kernels. Tolerances as in chip_smoke.py: float32 atol = rtol = 1e-4 (another
summation order), bfloat16 atol = rtol = 1e-2 (p and the output rounded
to bfloat16 at different points of the online softmax; rtol 1e-2 covers
one bf16 ulp, 2**-7 relative, at any magnitude), float16 atol = rtol =
2e-3 (the same for float16, whose ulp is 2**-10 relative). The backward kernels'
gradients take atol = tol * max|plain| (their scale is ~1e-2, where an
absolute 1e-2 would pass anything); LAMB's moments, update and block
partials rtol 1e-5 (the same float32 roundings, sums in another order).
SGMV: float32 1e-4; bfloat16 atol = 1e-2 x each row's largest magnitude
(t is rounded to bfloat16 before the second product, and another
summation order can move it by one bf16 ulp); identity rows exactly 0.
"""

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.ops.attention import (
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    flash_fwd,
    flash_fwd_plain,
)
from deepspeed_tpu_torch.ops.decode_attention import (
    SGMV_MAX_RANK,
    decode_splits,
    lora_sgmv,
    lora_sgmv_plain,
    paged_flash_decode,
    paged_flash_decode_plain,
)
from deepspeed_tpu_torch.ops.fused_lamb import lamb_phase1, lamb_phase1_plain

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype, scaled=False):
    tol = TOL[dtype]
    atol = tol * float(want.float().abs().max()) if scaled else tol
    torch.testing.assert_close(
        got.float(), want.float(), atol=atol, rtol=tol
    )


def _attention_case(cuda, dtype, d, sq, sk, masked, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, h = 2, 3
    q, k, v, dout = (
        torch.randn(b, h, s, d, device=cuda, generator=g).to(dtype)
        for s in (sq, sk, sk, sq)
    )
    kv_mask = None
    if masked:
        kv_mask = torch.ones(b, sk, dtype=torch.int32, device=cuda)
        kv_mask[0, sk // 2:] = 0
        kv_mask[1] = 0  # a fully masked batch row
    return q, k, v, dout, kv_mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,masked", [
    (1024, 1024, True, False),
    (200, 333, True, True),     # ragged tiles, diag offset, key mask
    (333, 200, True, True),     # negative diag offset: rows with no key
    (256, 256, False, True),
    (1, 77, True, False),
    (1000, 1000, True, False),  # not a multiple of the 128-row tiles
])
def test_flash_fwd_kernel_matches_plain(cuda, dtype, d, sq, sk, causal,
                                        masked):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h = 2, 3
    q, k, v = (
        torch.randn(b, h, s, d, device=cuda, generator=g).to(dtype)
        for s in (sq, sk, sk)
    )
    kv_mask = None
    if masked:
        kv_mask = torch.ones(b, sk, dtype=torch.int32, device=cuda)
        kv_mask[0, sk // 2:] = 0
        kv_mask[1] = 0  # a fully masked batch row
    before = flash_fwd.launches
    out, lse = flash_fwd(q, k, v, kv_mask, causal)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    ref, ref_lse = flash_fwd_plain(q, k, v, kv_mask, causal)
    _close(out, ref, dtype)
    rows = ref_lse > -1e29
    _close(lse[rows], ref_lse[rows], torch.float32)
    assert bool((out[~rows] == 0).all())  # rows that see no key
    if masked:
        assert bool((out[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,bs", [(64, 16), (128, 8), (64, 5)])
def test_paged_decode_kernel_matches_plain(cuda, dtype, hd, bs):
    g = torch.Generator(device=cuda).manual_seed(1)
    slots, heads, mb = 6, 4, 12
    pages = slots * mb + 1
    q = torch.randn(slots, heads, hd, device=cuda, generator=g).to(dtype)
    kp = torch.randn(pages, bs, heads, hd, device=cuda, generator=g).to(dtype)
    vp = torch.randn(pages, bs, heads, hd, device=cuda, generator=g).to(dtype)
    tables = (torch.randperm(pages - 1, device=cuda, generator=g) + 1)
    tables = tables.reshape(slots, mb).to(torch.int32)
    tables[1] = 0           # dead slot
    tables[4, 2] = 0        # NULL page mid-table
    positions = torch.tensor(
        [0, 0, bs * mb - 1, 7, 3 * bs + 2, bs], dtype=torch.int32, device=cuda
    )
    before = paged_flash_decode.launches
    out = paged_flash_decode(q, kp, vp, tables.contiguous(), positions)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    ref = paged_flash_decode_plain(q, kp, vp, tables, positions)
    _close(out, ref, dtype)
    assert bool((out[1] == 0).all())


def _decode_pool(cuda, dtype, slots, heads, hd, bs, mb, seed):
    """q, pools and full random block tables (every page distinct)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    pages = slots * mb + 1
    q = torch.randn(slots, heads, hd, device=cuda, generator=g).to(dtype)
    kp = torch.randn(pages, bs, heads, hd, device=cuda, generator=g).to(dtype)
    vp = torch.randn(pages, bs, heads, hd, device=cuda, generator=g).to(dtype)
    tables = (torch.randperm(pages - 1, device=cuda, generator=g) + 1)
    return q, kp, vp, tables.reshape(slots, mb).to(torch.int32)


def _decode_split_case(cuda, dtype, hd, bs, case):
    """``boundaries``: positions on the split boundaries the wrapper picks
    (the last token of a run of pages, the first of the next, the one
    after), the first and the last token of the table. ``long``: one slot
    at position 1023 over a 128-page table. ``holes``: a dead slot, a NULL
    page inside a split, a split whose pages are all NULL, position 0.
    ``unsplit``: so many slots that one block per (slot, head) fills the
    card (one split), a dead slot and mixed positions."""
    heads = 12
    if case == "long":
        q, kp, vp, tables = _decode_pool(cuda, dtype, 1, heads, hd, bs, 128, 7)
        positions = [1023]
    elif case == "unsplit":
        slots, mb = 48, 8
        q, kp, vp, tables = _decode_pool(cuda, dtype, slots, heads, hd, bs,
                                         mb, 10)
        assert decode_splits(slots, heads, mb, cuda)[0] == 1
        tables[0] = 0
        positions = [(7 * i) % (mb * bs) for i in range(slots)]
    else:
        slots, mb = (8, 64) if case == "boundaries" else (4, 40)
        q, kp, vp, tables = _decode_pool(cuda, dtype, slots, heads, hd, bs,
                                         mb, 8)
        splits, per = decode_splits(slots, heads, mb, cuda)
        assert splits > 1
        if case == "boundaries":
            first, last = per * bs, (splits - 1) * per * bs
            positions = [first - 1, first, first + 1, last - 1, last,
                         last + 1, 0, mb * bs - 1]
        else:
            tables[0] = 0                  # dead slot
            tables[1, per + 1] = 0         # a NULL page inside split 1
            tables[2, per:2 * per] = 0     # split 1 all NULL pages
            positions = [mb * bs - 1, mb * bs - 1, mb * bs - 1, 0]
    positions = torch.tensor(positions, dtype=torch.int32, device=cuda)
    return q, kp, vp, tables.contiguous(), positions


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,bs", [(64, 16), (128, 16), (64, 5), (64, 32)])
@pytest.mark.parametrize("case", ["boundaries", "long", "holes", "unsplit"])
def test_paged_decode_splits_match_plain(cuda, dtype, hd, bs, case):
    """The context split across blocks and merged in the same launch (or
    not split at all when the slots alone fill the card): one launch a
    call, the plain version's result at the split boundaries, at a long
    context, around NULL pages and dead slots, with pages of several
    steps; garbage on the NULL page changes nothing."""
    q, kp, vp, tables, positions = _decode_split_case(cuda, dtype, hd, bs,
                                                      case)
    before = paged_flash_decode.launches
    out = paged_flash_decode(q, kp, vp, tables, positions)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    _close(out, paged_flash_decode_plain(q, kp, vp, tables, positions),
           dtype)
    if case in ("holes", "unsplit"):
        assert bool((out[0] == 0).all())
        kp2, vp2 = kp.clone(), vp.clone()
        kp2[0], vp2[0] = 1e4, -1e4
        assert torch.equal(
            paged_flash_decode(q, kp2, vp2, tables, positions), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_is_bitwise_repeatable(cuda, dtype):
    """The last block of a (slot, head) merges every split in split
    order, whichever block that is: 10 calls give the same bits."""
    q, kp, vp, tables = _decode_pool(cuda, dtype, 8, 12, 64, 16, 64, 9)
    positions = torch.full((8,), 1023, dtype=torch.int32, device=cuda)
    first = paged_flash_decode(q, kp, vp, tables, positions)
    for _ in range(9):
        assert torch.equal(paged_flash_decode(q, kp, vp, tables, positions),
                           first)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 2, 256, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(q, q, q)
    with pytest.raises(TypeError):
        flash_fwd(q.double()[..., :64], q.double()[..., :64],
                  q.double()[..., :64])
    qd = torch.randn(2, 4, 64, device=cuda)
    pool = torch.randn(5, 8, 4, 64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        paged_flash_decode(
            qd, pool, pool, torch.zeros(2, 3, dtype=torch.int64, device=cuda),
            torch.zeros(2, dtype=torch.int32, device=cuda),
        )


ATTENTION_CASES = [
    (1024, 1024, True, False, 0.0),
    (1024, 1024, True, False, 0.1),
    (200, 333, True, True, 0.2),    # ragged tiles, diag offset, key mask
    (333, 200, True, True, 0.0),    # negative diag offset: rows with no key
    (256, 256, False, True, 0.1),
    (1, 77, True, False, 0.0),
    (1000, 1000, True, False, 0.1),  # not a multiple of the 128-row tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,masked,rate", ATTENTION_CASES)
def test_flash_fwd_dropout_kernel_matches_plain(cuda, dtype, d, sq, sk,
                                                causal, masked, rate):
    """The forward with dropout: the kernel regenerates the plain
    version's mask (csrc/dropout.cuh's hash), so the two agree to the
    usual tolerance, and l/lse come from the undropped probabilities."""
    q, k, v, _, kv_mask = _attention_case(cuda, dtype, d, sq, sk, masked, 2)
    args = (q, k, v, kv_mask, causal, None, rate, 99)
    out, lse = flash_fwd(*args)
    torch.cuda.synchronize()
    ref, ref_lse = flash_fwd_plain(*args)
    _close(out, ref, dtype)
    rows = ref_lse > -1e29
    _close(lse[rows], ref_lse[rows], torch.float32)
    assert bool((out[~rows] == 0).all())  # rows that see no key
    if rate:
        clean, clean_lse = flash_fwd_plain(q, k, v, kv_mask, causal)
        _close(lse[rows], clean_lse[rows], torch.float32)
        assert not torch.allclose(out.float(), clean.float(), atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,masked,rate", ATTENTION_CASES)
def test_flash_bwd_kernels_match_plain(cuda, dtype, d, sq, sk, causal,
                                       masked, rate):
    q, k, v, dout, kv_mask = _attention_case(cuda, dtype, d, sq, sk, masked,
                                             3)
    out, lse = flash_fwd_plain(q, k, v, kv_mask, causal, None, rate, 5)
    delta = (dout.float() * out.float()).sum(dim=-1)
    args = (q, k, v, kv_mask, dout, lse, delta, causal, None, rate, 5)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    dq = flash_bwd_dq(*args)
    dk, dv = flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = (flash_bwd_dq_plain(*args), *flash_bwd_dkv_plain(*args))
    for got, ref in zip((dq, dk, dv), want):
        _close(got, ref, dtype, scaled=True)
        if masked:
            assert bool((got[1] == 0).all())
    assert bool((dq[lse <= -1e29] == 0).all())  # rows that see no key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_kernels_are_bitwise_repeatable(cuda, dtype, d):
    """The tensor-core forward, dQ and dK/dV kernels use no atomics: two
    launches on the same inputs give the same out, lse, dQ, dK and dV bit
    for bit."""
    q, k, v, dout, kv_mask = _attention_case(cuda, dtype, d, 1000, 1000,
                                             True, 6)
    fargs = (q, k, v, kv_mask, True, None, 0.1, 11)
    out, lse = flash_fwd(*fargs)
    delta = (dout.float() * out.float()).sum(dim=-1)
    bargs = (q, k, v, kv_mask, dout, lse, delta, True, None, 0.1, 11)
    first = (out, lse, flash_bwd_dq(*bargs), *flash_bwd_dkv(*bargs))
    again = (*flash_fwd(*fargs), flash_bwd_dq(*bargs), *flash_bwd_dkv(*bargs))
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_tensor_core_wrappers_refuse_misaligned_storage(cuda):
    """TMA needs 16-byte-aligned operands: a bf16 view that starts 2 bytes
    into its storage is refused, not sent to another route."""
    flat = torch.randn(1 * 2 * 256 * 64 + 1, device=cuda).to(torch.bfloat16)
    q = flat[1:].view(1, 2, 256, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        flash_fwd(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
@pytest.mark.parametrize("eps_inside_sqrt,weight_decay", [
    (False, 0.0), (False, 0.01), (True, 0.01),
])
def test_lamb_phase1_kernel_matches_plain(cuda, gdtype, eps_inside_sqrt,
                                          weight_decay):
    """Tensors of 5, 1000, 4096, 40 000 and 70 000 elements in one launch
    (ragged last blocks, a tensor of exactly one block)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    sizes = [5, 1000, 4096, 40_000, 70_000]

    def noise(scale):
        return [torch.randn(n, device=cuda, generator=g) * scale
                for n in sizes]

    ps, gs, m0 = noise(1.0), [x.to(gdtype) for x in noise(1e-2)], noise(1e-3)
    v0 = [x * x for x in noise(1e-2)]
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
              eps_inside_sqrt=eps_inside_sqrt)
    runs = []
    for fn in (lamb_phase1, lamb_phase1_plain):
        ms, vs = [x.clone() for x in m0], [x.clone() for x in v0]
        us = [torch.empty_like(p) for p in ps]
        before = lamb_phase1.launches
        wsq, usq = fn(ps, gs, ms, vs, us, 0.271, 0.003, 0.5, **kw)
        torch.cuda.synchronize()
        runs.append((wsq, usq, ms, vs, us, lamb_phase1.launches - before))
    (kw_, ku, km, kv, kuu, n), (pw, pu, pm, pv, puu, n_plain) = runs
    assert (n, n_plain) == (1, 0)
    for got, want in zip(km + kv + kuu, pm + pv + puu):
        torch.testing.assert_close(
            got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(kw_, pw, rtol=1e-5, atol=0)
    torch.testing.assert_close(ku, pu, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_training_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 2, 128, 64, device=cuda)
    lse = torch.zeros(1, 2, 128, device=cuda)
    with pytest.raises(TypeError):
        h = q.double()
        flash_bwd_dq(h, h, h, None, h, lse, lse)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd_dkv(q, q, q, None, q, lse.double(), lse)
    with pytest.raises(ValueError, match="dout"):
        flash_bwd_dq(q, q, q, None, q[:, :1].contiguous(), lse, lse)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        flash_bwd_dkv(t, t, t, None, t, lse, lse)
    p = [torch.zeros(10, device=cuda)]
    with pytest.raises(TypeError):
        lamb_phase1(p, [p[0].double()], p, p, p, 1.0, 1.0, b1=0.9, b2=0.999,
                    eps=1e-8, weight_decay=0.0, eps_inside_sqrt=False)
    with pytest.raises(RuntimeError):
        lamb_phase1(p, [torch.zeros(10)], p, p, p, 1.0, 1.0, b1=0.9,
                    b2=0.999, eps=1e-8, weight_decay=0.0,
                    eps_inside_sqrt=False)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [
    {"fp16": {"enabled": True, "initial_scale_power": 12}},
    {"bf16": {"enabled": True}},
])
def test_reduced_precision_training_runs_through_the_kernels(cuda, block):
    """initialize() on a 2-layer GPT-2 at S=256 (the flash route) in real
    float16 (with loss scaling) or bfloat16: every micro-step launches the
    three attention kernels once a layer, every step FusedLamb's phase-1
    kernel, and the loss stays finite."""
    model = GPT2LMHeadModel(GPT2Config(vocab_size=256, n_positions=256,
                                       n_embd=128, n_layer=2, n_head=2,
                                       dropout=0.1), device=cuda)
    cfg = dict({"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "FusedLamb", "params": {"lr": 1e-3}}},
               **block)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config_params=cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(0, 256, (4, 256), device=cuda, generator=g)
    before = {fn: fn.launches for fn in (flash_fwd, flash_bwd_dq,
                                         flash_bwd_dkv, lamb_phase1)}
    for _ in range(3):
        loss = engine.train_batch([(ids[:2], ids[:2]), (ids[2:], ids[2:])])
        assert torch.isfinite(loss)
    torch.cuda.synchronize()
    got = {fn: fn.launches - n for fn, n in before.items()}
    assert got[flash_fwd] == got[flash_bwd_dq] == got[flash_bwd_dkv] == 12
    # every group of this model is below multi_tensor_max: one packed launch
    assert got[lamb_phase1] == engine.global_steps
    assert engine.global_steps + engine.skipped_steps == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("din,dout,rank", [
    (768, 2304, 16), (768, 768, 16), (768, 3072, 16), (3072, 768, 16),
    (40, 1100, 1), (130, 70, 33),
])
def test_sgmv_kernel_matches_plain(cuda, dtype, din, dout, rank):
    g = torch.Generator(device=cuda).manual_seed(2)
    n, b = 4, 8
    a_pool = (torch.randn(n + 1, din, rank, device=cuda, generator=g)
              * 0.05).to(dtype)
    b_pool = (torch.randn(n + 1, rank, dout, device=cuda, generator=g)
              * 0.05).to(dtype)
    a_pool[0] = 0
    b_pool[0] = 0
    x = torch.randn(b, din, device=cuda, generator=g).to(dtype)
    ids = torch.tensor([0, 3, 3, n, 1, 0, 2, n], dtype=torch.int32,
                       device=cuda)
    before = lora_sgmv.launches
    out = lora_sgmv(x, a_pool, b_pool, ids)
    torch.cuda.synchronize()
    assert lora_sgmv.launches == before + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, dout)
    ref = lora_sgmv_plain(x, a_pool, b_pool, ids)
    tol = TOL[dtype]
    scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    torch.testing.assert_close(out / scale, ref / scale, atol=tol, rtol=0)
    assert bool((out[0] == 0).all()) and bool((out[5] == 0).all())
    if dtype == torch.bfloat16:
        # the kernel rounds t to bf16 where the plain version does: its
        # output lies far nearer that than the arithmetic with t unrounded
        rows = ids.long()
        t = torch.einsum("bi,bir->br", x.float(), a_pool[rows].float())
        unrounded = torch.einsum("br,bro->bo", t, b_pool[rows].float())
        err_rounded = ((out - ref) / scale).abs().max()
        err_unrounded = ((out - unrounded) / scale).abs().max()
        assert err_rounded < 0.1 * err_unrounded


@pytest.mark.cuda
def test_sgmv_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn(2, 16, device=cuda)
    a = torch.zeros(3, 16, 4, device=cuda)
    b = torch.zeros(3, 4, 8, device=cuda)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        lora_sgmv(x, a, b, ids.long())
    with pytest.raises(TypeError, match="share a dtype"):
        lora_sgmv(x, a.bfloat16(), b, ids)
    with pytest.raises(ValueError, match="shapes"):
        lora_sgmv(x, a[:, :8], b, ids)
    with pytest.raises(ValueError, match="SGMV_MAX_RANK"):
        big = torch.zeros(2, 16, SGMV_MAX_RANK + 1, device=cuda)
        lora_sgmv(x, big, torch.zeros(2, SGMV_MAX_RANK + 1, 8, device=cuda),
                  ids)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        lora_sgmv(x, a.cpu(), b, ids)
