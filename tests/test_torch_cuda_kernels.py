"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a GPU each test skips (the fixture decides
at run time). On the card run

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

bfloat16 and float16 run the tensor-core forward, dQ and dK/dV kernels
(wgmma + TMA) at every compiled width, float32 the FMA kernels. The D = 256
tensor-core cases alone, and the dK/dV cases:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py -k 256
    python -m pytest -m cuda tests/test_torch_cuda_kernels.py -k dkv

The forward and dQ at D = 128 and 256 (d = 96 and 192 zero-padded to
them):

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py \
        -k "d256_tensor_core_forward_and_dq"

The padding-mask patterns (lengths at the tiles' edges, left padding,
holes, dead rows, an all-ones mask bit for bit against no mask, and rows
longer than a block sorts in shared memory):

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py -k mask

Tolerances as in chip_smoke.py: float32 atol = rtol = 1e-4 (another
summation order), bfloat16 atol = rtol = 1e-2 (p and the output rounded
to bfloat16 at different points of the online softmax; rtol 1e-2 covers
one bf16 ulp, 2**-7 relative, at any magnitude), float16 atol = rtol =
2e-3 (the same for float16, whose ulp is 2**-10 relative). The backward kernels'
gradients take atol = tol * max|plain| (their scale is ~1e-2, where an
absolute 1e-2 would pass anything); LAMB's moments, update and block
partials rtol 1e-5 (the same float32 roundings, sums in another order),
and on ragged or misaligned tensors m, v and u bit for bit and the
partials 1e-6. SGMV: float32 1e-4; bfloat16 atol = 1e-2 x each row's
largest magnitude (t is rounded to bfloat16 before the second product,
and another summation order can move it by one bf16 ulp); identity rows
exactly 0; the epilogue form TOL of its dtype against its plain version
and bit for bit against PyTorch's scale, cast and add on the kernel's
own delta. Head dims the kernels are not compiled at (d = 32, 48, 96,
192; hd 1-127) and D = 256 take the same tolerances as 64 and 128.
"""

import time

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
    lora_sgmv_add,
    lora_sgmv_add_plain,
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,masked,rate", [
    (1024, 1024, True, False, 0.0),
    (200, 333, True, True, 0.0),
    (333, 200, True, True, 0.1),
    (256, 256, False, True, 0.1),
])
def test_flash_fwd_64_key_form_matches_plain(cuda, dtype, d, sq, sk, causal,
                                             masked, rate):
    """The forward's 64-key tile form (the autotuner's second candidate)
    against the plain version, dropout included."""
    q, k, v, _, kv_mask = _attention_case(cuda, dtype, d, sq, sk, masked, 3)
    before = flash_fwd.launches
    out, lse = flash_fwd(q, k, v, kv_mask, causal, None, rate, 5,
                         block_k=64)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    ref, ref_lse = flash_fwd_plain(q, k, v, kv_mask, causal, None, rate, 5)
    _close(out, ref, dtype)
    rows = ref_lse > -1e29
    _close(lse[rows], ref_lse[rows], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,bs", [(64, 16), (128, 8), (64, 5), (16, 16),
                                   (32, 16), (48, 16), (80, 16), (96, 8),
                                   (112, 16),
                                   # tails: rows that are not whole 16-byte
                                   # chunks (8-, 4- and 2-byte copies)
                                   (8, 16), (12, 16), (40, 5), (72, 16),
                                   (1, 16), (3, 8), (10, 16), (127, 8)])
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
@pytest.mark.parametrize("hd,bs", [(64, 16), (128, 16), (64, 5), (64, 32),
                                   (32, 16), (48, 5), (8, 16), (12, 16),
                                   (40, 5), (5, 16)])
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
    q = torch.randn(1, 2, 256, 260, device=cuda)  # above 256: no width
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):  # above 128
        qd, pool = (torch.randn(2, 4, 160, device=cuda),
                    torch.randn(5, 8, 4, 160, device=cuda))
        paged_flash_decode(
            qd, pool, pool, torch.zeros(2, 3, dtype=torch.int32, device=cuda),
            torch.zeros(2, dtype=torch.int32, device=cuda))
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [32, 48, 96, 192, 256])
@pytest.mark.parametrize("sq,sk,causal,masked,rate", [
    (1024, 1024, True, False, 0.1),
    (200, 333, True, True, 0.2),
    (256, 256, False, True, 0.0),
])
def test_flash_kernels_take_padded_head_dims(cuda, dtype, d, sq, sk, causal,
                                             masked, rate):
    """Head dims the kernels are not compiled at run zero-padded to 64, 128
    or 256 (pad_head_dim): one launch each, d columns out, and the plain
    versions' forward and gradients at d."""
    q, k, v, dout, kv_mask = _attention_case(cuda, dtype, d, sq, sk, masked,
                                             12)
    before = (flash_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    out, lse = flash_fwd(q, k, v, kv_mask, causal, None, rate, 9)
    ref, ref_lse = flash_fwd_plain(q, k, v, kv_mask, causal, None, rate, 9)
    delta = (dout.float() * ref.float()).sum(dim=-1)
    args = (q, k, v, kv_mask, dout, ref_lse, delta, causal, None, rate, 9)
    dq = flash_bwd_dq(*args)
    dk, dv = flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    assert out.shape == q.shape and dq.shape == q.shape
    assert dk.shape == k.shape and dv.shape == v.shape
    _close(out, ref, dtype)
    rows = ref_lse > -1e29
    _close(lse[rows], ref_lse[rows], torch.float32)
    want = (flash_bwd_dq_plain(*args), *flash_bwd_dkv_plain(*args))
    for got, want_g in zip((dq, dk, dv), want):
        _close(got, want_g, dtype, scaled=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [96, 128, 192, 256])
@pytest.mark.parametrize("sq,sk", [(200, 328), (333, 200), (1000, 1000)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_d256_tensor_core_forward_and_dq_match_plain(cuda, dtype, d, sq, sk,
                                                     causal, masked, rate):
    """bfloat16/float16 at D = 128 (d = 96 zero-padded to it: the forward
    in a 256-thread block with 128-key tiles, dQ in the 384-thread block
    of D = 64) and D = 256 (d = 192 zero-padded to it: 256-thread blocks,
    64- and 32-key tiles): the tensor-core forward and dQ, one launch
    each, against their plain versions at the tolerances of D = 64.
    Sq != Sk with ragged last tiles: (200, 328) puts the causal diagonal
    128 keys right, (333, 200) leaves rows that see no key, which stay
    exact zeros, and (1000, 1000) is not a multiple of any tile."""
    q, k, v, dout, kv_mask = _attention_case(cuda, dtype, d, sq, sk, masked,
                                             21)
    fargs = (q, k, v, kv_mask, causal, None, rate, 13)
    before = (flash_fwd.launches, flash_bwd_dq.launches)
    out, lse = flash_fwd(*fargs)
    ref, ref_lse = flash_fwd_plain(*fargs)
    delta = (dout.float() * ref.float()).sum(dim=-1)
    bargs = (q, k, v, kv_mask, dout, ref_lse, delta, causal, None, rate, 13)
    dq = flash_bwd_dq(*bargs)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.shape == q.shape and dq.shape == q.shape
    _close(out, ref, dtype)
    rows = ref_lse > -1e29
    _close(lse[rows], ref_lse[rows], torch.float32)
    assert bool((out[~rows] == 0).all())  # rows that see no key
    _close(dq, flash_bwd_dq_plain(*bargs), dtype, scaled=True)
    assert bool((dq[~rows] == 0).all())
    if masked:
        assert bool((out[1] == 0).all()) and bool((dq[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [128, 192, 256])
@pytest.mark.parametrize("sq,sk", [(200, 328), (333, 200), (1000, 1000)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tensor_core_dkv_matches_plain(cuda, dtype, d, sq, sk, causal,
                                       masked, rate):
    """bfloat16/float16 dK/dV at D = 128 (256-thread blocks, dK and dV in
    one pass) and D = 256 (two passes; d = 192 zero-padded to it): one
    launch, against the plain version at the scaled tolerances. (200, 328)
    puts the causal diagonal 128 keys right, (333, 200) leaves rows that
    see no key, and no length is a multiple of the 32-query or 128-key
    tiles; the mask drops the second half of batch row 0's keys and every
    key of row 1, whose dK and dV rows stay exact zeros."""
    q, k, v, dout, kv_mask = _attention_case(cuda, dtype, d, sq, sk, masked,
                                             31)
    ref, lse = flash_fwd_plain(q, k, v, kv_mask, causal, None, rate, 17)
    delta = (dout.float() * ref.float()).sum(dim=-1)
    args = (q, k, v, kv_mask, dout, lse, delta, causal, None, rate, 17)
    before = flash_bwd_dkv.launches
    dk, dv = flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert flash_bwd_dkv.launches == before + 1
    assert dk.shape == k.shape and dv.shape == v.shape
    want_k, want_v = flash_bwd_dkv_plain(*args)
    _close(dk, want_k, dtype, scaled=True)
    _close(dv, want_v, dtype, scaled=True)
    if masked:
        for grad in (dk, dv):
            assert bool((grad[1] == 0).all())
            assert bool((grad[0, :, sk // 2:] == 0).all())


@pytest.mark.cuda
def test_tma_alignment_check_follows_the_route(cuda):
    """At D = 256 the bfloat16 forward, dQ and dK/dV load by TMA and refuse
    a view that starts 2 bytes into its storage; float32 takes the FMA
    kernels, which take a view 4 bytes in."""
    n = 1 * 2 * 256 * 256
    flat = torch.randn(n + 1, device=cuda).to(torch.bfloat16)
    x = flat[1:].view(1, 2, 256, 256)
    assert x.is_contiguous() and x.data_ptr() % 16
    lse = torch.zeros(1, 2, 256, device=cuda)
    args = (x, x, x, None, x, lse, lse, True)
    with pytest.raises(ValueError, match="16-byte"):
        flash_fwd(x, x, x)
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dq(*args)
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dkv(*args)
    flat32 = torch.randn(4 * n + 1, device=cuda)
    q, k, v, dout = (flat32[1 + i * n:1 + (i + 1) * n].view(1, 2, 256, 256)
                     for i in range(4))
    assert q.is_contiguous() and q.data_ptr() % 16
    out, lse32 = flash_fwd(q, k, v, None, True)
    delta = (dout * out).sum(dim=-1)
    fargs = (q, k, v, None, dout, lse32, delta, True)
    got = (flash_bwd_dq(*fargs), *flash_bwd_dkv(*fargs))
    torch.cuda.synchronize()
    _close(out, flash_fwd_plain(q, k, v, None, True)[0], torch.float32)
    want = (flash_bwd_dq_plain(*fargs), *flash_bwd_dkv_plain(*fargs))
    for g, w in zip(got, want):
        _close(g, w, torch.float32, scaled=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_tensor_core_kernels_are_bitwise_repeatable(cuda, dtype, d):
    """The tensor-core forward, dQ and dK/dV kernels use no atomics: two
    launches on the same inputs give the same out, lse, dQ, dK and dV bit
    for bit, in every form: the 384-thread one at D = 64 (and dQ's at
    128), the 256-thread ones at D = 128 and 256 (dK/dV's two passes at
    256, one output each)."""
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


# lengths at the key tiles' edges (64-key dQ tiles, 128-key forward and
# dK/dV tiles; 32- and 64-key tiles at D = 256)
EDGE_LENGTHS = (63, 64, 65, 127, 128, 129, 255, 256, 257)


def mask_pattern(pattern, s):
    """A [B, s] int32 key mask (host): ``edges`` right padding at
    EDGE_LENGTHS; ``left`` left padding at those lengths; ``hole`` rows
    whose middle keys are masked (one spans a whole 128-key tile) beside a
    full row; ``dead`` a row with no valid key between ragged ones;
    ``ones`` every key valid."""
    b = len(EDGE_LENGTHS)
    mask = torch.zeros(b, s, dtype=torch.int32)
    if pattern == "ones":
        mask[:] = 1
    for row, n in enumerate(EDGE_LENGTHS):
        if pattern == "edges":
            mask[row, :n] = 1
        elif pattern == "left":
            mask[row, s - n:] = 1
        elif pattern == "hole":
            mask[row] = 1
            if row % 2:
                mask[row, n // 2:n // 2 + 64 + n] = 0
        elif pattern == "dead":
            mask[row, :max(0, n - 8 * row)] = 1 if row != 4 else 0
    return mask


def _mask_case(cuda, dtype, d, s, pattern, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    mask = mask_pattern(pattern, s).to(cuda)
    q, k, v, dout = (
        torch.randn(mask.shape[0], 2, s, d, device=cuda, generator=g)
        .to(dtype) for _ in range(4))
    return q, k, v, dout, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("pattern", ["edges", "left", "hole", "dead"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_mask_patterns_match_plain(cuda, dtype, d, pattern, causal,
                                         rate):
    """The forward, dQ and dK/dV under padding masks whose valid keys end,
    start or stop at the key tiles' edges (the tensor-core kernels walk
    only the tiles with a valid key and mask only the mixed ones), one
    launch each, against the plain versions: rows that see no key and
    masked keys' gradient rows exact zeros."""
    s = 384
    q, k, v, dout, mask = _mask_case(cuda, dtype, d, s, pattern, 41)
    fargs = (q, k, v, mask, causal, None, rate, 23)
    before = (flash_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    out, lse = flash_fwd(*fargs)
    ref, ref_lse = flash_fwd_plain(*fargs)
    delta = (dout.float() * ref.float()).sum(dim=-1)
    bargs = (q, k, v, mask, dout, ref_lse, delta, causal, None, rate, 23)
    dq = flash_bwd_dq(*bargs)
    dk, dv = flash_bwd_dkv(*bargs)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    _close(out, ref, dtype)
    rows = ref_lse > -1e29
    _close(lse[rows], ref_lse[rows], torch.float32)
    want = (flash_bwd_dq_plain(*bargs), *flash_bwd_dkv_plain(*bargs))
    for got, ref_g in zip((dq, dk, dv), want):
        _close(got, ref_g, dtype, scaled=True)
    assert bool((out[~rows] == 0).all()) and bool((dq[~rows] == 0).all())
    masked = (mask == 0)[:, None, :, None].expand_as(dk)
    assert bool((dk[masked] == 0).all()) and bool((dv[masked] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_all_ones_mask_equals_no_mask_bitwise(cuda, dtype, d, causal,
                                                    rate):
    """A mask that keeps every key sorts every tile full, so the
    tensor-core kernels take the mask-free path: out, lse, dQ, dK and dV
    equal kv_mask=None's bit for bit (Sk = 1000 leaves a ragged tile)."""
    s = 1000
    q, k, v, dout, _ = _attention_case(cuda, dtype, d, s, s, False, 43)
    ones = torch.ones(q.shape[0], s, dtype=torch.int32, device=cuda)
    results = []
    for mask in (ones, None):
        out, lse = flash_fwd(q, k, v, mask, causal, None, rate, 29)
        delta = (dout.float() * out.float()).sum(dim=-1)
        bargs = (q, k, v, mask, dout, lse, delta, causal, None, rate, 29)
        results.append((out, lse, flash_bwd_dq(*bargs),
                        *flash_bwd_dkv(*bargs)))
    torch.cuda.synchronize()
    for a, b in zip(*results):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,sk", [(128, 8192 + 200), (256, 2048 + 52),
                                  (64, 16384 + 72)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_mask_past_the_tile_room(cuda, dtype, d, sk, rate):
    """A mask row longer than a block sorts in shared memory (the forward
    at D = 128 above 8192 keys, dQ at D = 256 above 2048, both at D = 64
    above 16384) is walked whole, each warp forming a mixed tile's bits
    from the mask in device memory: still the plain versions' results,
    dead rows zeros."""
    g = torch.Generator(device=cuda).manual_seed(47)
    b, h, sq = 3, 1, 100
    q, dout = (torch.randn(b, h, sq, d, device=cuda, generator=g).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    mask = torch.ones(b, sk, dtype=torch.int32, device=cuda)
    mask[0, sk // 3:sk // 2] = 0  # a hole
    mask[0, sk - 70:] = 0         # a ragged tail
    mask[1] = 0                   # a dead row
    fargs = (q, k, v, mask, False, None, rate, 31)
    out, lse = flash_fwd(*fargs)
    ref, ref_lse = flash_fwd_plain(*fargs)
    delta = (dout.float() * ref.float()).sum(dim=-1)
    bargs = (q, k, v, mask, dout, ref_lse, delta, False, None, rate, 31)
    dq = flash_bwd_dq(*bargs)
    dk, dv = flash_bwd_dkv(*bargs)
    torch.cuda.synchronize()
    _close(out, ref, dtype)
    rows = ref_lse > -1e29
    _close(lse[rows], ref_lse[rows], torch.float32)
    want = (flash_bwd_dq_plain(*bargs), *flash_bwd_dkv_plain(*bargs))
    for got, ref_g in zip((dq, dk, dv), want):
        _close(got, ref_g, dtype, scaled=True)
    assert bool((out[1] == 0).all()) and bool((dq[1] == 0).all())


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
    (40, 1100, 1), (130, 70, 33), (768, 3072, 8), (768, 768, 64),
    (768, 768, SGMV_MAX_RANK),
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
        lora_sgmv(x[:, :8].contiguous(), a, b, ids)
    with pytest.raises(ValueError, match="contiguous"):
        lora_sgmv(x, a.transpose(1, 2).contiguous().transpose(1, 2), b, ids)
    with pytest.raises(ValueError, match="SGMV_MAX_RANK"):
        big = torch.zeros(2, 16, SGMV_MAX_RANK + 1, device=cuda)
        lora_sgmv(x, big, torch.zeros(2, SGMV_MAX_RANK + 1, 8, device=cuda),
                  ids)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        lora_sgmv(x, a.cpu(), b, ids)


# GPT-2 small's four LoRA targets at rank 16, and the ranks 1, 8, 64 and
# SGMV_MAX_RANK (the vector and the scalar phases of the kernel)
SGMV_SHAPES = [
    (768, 2304, 16), (768, 768, 16), (768, 3072, 16), (3072, 768, 16),
    (768, 2304, 1), (768, 3072, 8), (3072, 768, 64),
    (768, 768, SGMV_MAX_RANK),
]


def _sgmv_operands(cuda, dtype, din, dout, rank, b, seed=3, n=4):
    """Pools with the zero identity row, x, y and ids mixing the identity,
    repeats and the highest row (ids [n] at B = 1)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    a_pool = (torch.randn(n + 1, din, rank, device=cuda, generator=g)
              * 0.05).to(dtype)
    b_pool = (torch.randn(n + 1, rank, dout, device=cuda, generator=g)
              * 0.05).to(dtype)
    a_pool[0] = 0
    b_pool[0] = 0
    x = torch.randn(b, din, device=cuda, generator=g).to(dtype)
    y = torch.randn(b, dout, device=cuda, generator=g).to(dtype)
    pattern = [0, 3, 3, n, 1, 0, 2, n]
    ids = [n] if b == 1 else [pattern[i % len(pattern)] for i in range(b)]
    return x, a_pool, b_pool, torch.tensor(ids, dtype=torch.int32,
                                           device=cuda), y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("din,dout,rank,b", [
    # B = 48 at SGMV_MAX_RANK would gather 2 x 1.8 GB in the plain version
    (*shape, b) for shape in SGMV_SHAPES for b in (1, 8, 48)
    if not (shape[2] == SGMV_MAX_RANK and b == 48)
])
def test_sgmv_both_forms_match_plain(cuda, dtype, din, dout, rank, b):
    """The delta form and the epilogue form (y + (scale * delta).to(T) in
    the kernel) against their plain versions, one launch each; the
    epilogue form bit for bit what PyTorch's scale, cast and add give on
    the kernel's own delta; identity rows exact zeros (epilogue: y
    unchanged)."""
    x, a_pool, b_pool, ids, y = _sgmv_operands(cuda, dtype, din, dout, rank,
                                               b)
    scale = 0.625
    before = lora_sgmv.launches
    delta = lora_sgmv(x, a_pool, b_pool, ids)
    out = lora_sgmv_add(x, a_pool, b_pool, ids, y, scale)
    torch.cuda.synchronize()
    assert lora_sgmv.launches == before + 2
    assert out.dtype == dtype and out.shape == y.shape
    ref = lora_sgmv_plain(x, a_pool, b_pool, ids)
    row = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    torch.testing.assert_close(delta / row, ref / row, atol=TOL[dtype],
                               rtol=0)
    _close(out, lora_sgmv_add_plain(x, a_pool, b_pool, ids, y, scale), dtype)
    assert torch.equal(out, y + (scale * delta).to(dtype))
    zero = (ids == 0).nonzero().flatten()
    assert bool((delta[zero] == 0).all())
    assert torch.equal(out[zero], y[zero])
    # [B, 1, in] / [B, 1, out], as apply_lora passes them
    out3 = lora_sgmv_add(x[:, None], a_pool, b_pool, ids, y[:, None], scale)
    assert torch.equal(out3[:, 0], out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgmv_out_of_range_id_gives_nan(cuda, dtype):
    x, a_pool, b_pool, ids, y = _sgmv_operands(cuda, dtype, 768, 3072, 16, 8)
    ids[2], ids[5] = a_pool.shape[0], -1
    delta = lora_sgmv(x, a_pool, b_pool, ids)
    out = lora_sgmv_add(x, a_pool, b_pool, ids, y, 2.0)
    for t in (delta, out):
        assert bool(t[[2, 5]].isnan().all())
        assert not bool(t[[0, 1, 3, 4, 6, 7]].isnan().any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("din,dout,rank", [(3072, 768, 16),
                                           (768, 768, SGMV_MAX_RANK)])
def test_sgmv_is_bitwise_repeatable(cuda, dtype, din, dout, rank):
    """Every sum runs in a fixed order: 10 calls of each form give the
    same bits."""
    x, a_pool, b_pool, ids, y = _sgmv_operands(cuda, dtype, din, dout, rank,
                                               8)
    first = (lora_sgmv(x, a_pool, b_pool, ids),
             lora_sgmv_add(x, a_pool, b_pool, ids, y, 0.5))
    for _ in range(9):
        assert torch.equal(lora_sgmv(x, a_pool, b_pool, ids), first[0])
        assert torch.equal(lora_sgmv_add(x, a_pool, b_pool, ids, y, 0.5),
                           first[1])


@pytest.mark.cuda
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
@pytest.mark.parametrize("misaligned", [False, True])
def test_lamb_phase1_kernel_ragged_and_misaligned_tensors(cuda, gdtype,
                                                          misaligned):
    """Lengths 1, 3, 4097 and 4099 (a ragged last vector, the scalar path)
    beside 4096 and 40 000 (the vector path), all in one launch; with
    ``misaligned`` every tensor is a view 4 bytes (one element) into its
    storage, off the 16-byte grid, so every descriptor takes the scalar
    path. Against lamb_phase1_plain: m, v and u bit for bit (the kernel
    repeats PyTorch's roundings, its division by a scalar through the
    float32 reciprocal included), the block partials within 1e-6
    relative."""
    g = torch.Generator(device=cuda).manual_seed(6)
    sizes = [1, 3, 4097, 4099, 4096, 40_000]
    off = 1 if misaligned else 0

    def make(scale, dtype=torch.float32):
        out = []
        for n in sizes:
            base = torch.randn(n + off, device=cuda, generator=g) * scale
            out.append(base.to(dtype)[off:])
        return out

    ps, gs, m0 = make(1.0), make(1e-2, gdtype), make(1e-3)
    v0 = [x * x for x in make(1e-2)]
    if misaligned:
        assert all(t.data_ptr() % 16 for t in ps + m0)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              eps_inside_sqrt=False)
    runs = []
    for fn in (lamb_phase1, lamb_phase1_plain):
        ms = [x.clone() for x in m0]
        vs = [x.clone() for x in v0]
        us = [torch.empty(n + off, device=cuda)[off:] for n in sizes]
        wsq, usq = fn(ps, gs, ms, vs, us, 0.271, 0.003, 0.5, **kw)
        torch.cuda.synchronize()
        runs.append((wsq, usq, ms, vs, us))
    (kw_, ku, km, kv, kuu), (pw, pu, pm, pv, puu) = runs
    for got, want in zip(km + kv + kuu, pm + pv + puu):
        assert torch.equal(got, want)
    torch.testing.assert_close(kw_, pw, rtol=1e-6, atol=0)
    torch.testing.assert_close(ku, pu, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the data path and remat on the card
# ---------------------------------------------------------------------------
REMAT_FWD_PER_LAYER = {None: 1, "full": 2,
                       "dots_with_no_batch_dims_saveable+flash_out+flash_lse":
                       1, "dots_saveable": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", list(REMAT_FWD_PER_LAYER))
def test_remat_launches_per_layer_and_gradients(cuda, policy):
    """A 2-layer GPT-2 at S=256 (the flash route), bf16, one micro-step
    with dropout: the forward kernel launches once a layer without remat
    and under a spec that keeps flash_out and flash_lse, twice under
    "full" and a spec that recomputes attention; dQ and dK/dV once. The
    gradients equal the remat-off model's bit for bit (the same kernels on
    the same inputs, the seed and masks drawn before the block)."""
    from deepspeed_tpu_torch.ops import attention as A

    def grads(remat_policy):
        kw = {} if remat_policy is None else {"remat": True,
                                              "remat_policy": remat_policy}
        model = GPT2LMHeadModel(GPT2Config(
            vocab_size=256, n_positions=256, n_embd=128, n_layer=2,
            n_head=2, dropout=0.1, **kw), device=cuda, dtype=torch.bfloat16)
        ids = torch.randint(0, 256, (2, 256), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(0))
        counts = (A.flash_fwd.launches, A.flash_bwd_dq.launches,
                  A.flash_bwd_dkv.launches)
        loss = model(ids, ids, train=True, dropout_seed=7)
        loss.backward()
        torch.cuda.synchronize()
        got = tuple(f.launches - c for f, c in zip(
            (A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv), counts))
        return got, [p.grad for p in model.parameters()]

    launches, got = grads(policy)
    assert launches == (2 * REMAT_FWD_PER_LAYER[policy], 2, 2)
    _, want = grads(None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_stager_copies_on_its_own_stream(cuda):
    """The window stager copies pinned host windows to the card on a copy
    stream other than the compute stream, records an event per window that
    the compute stream waits on, keeps its slots to ``buffers`` and hands
    back the host values exactly."""
    from deepspeed_tpu_torch.runtime.staging import WindowStager

    host = [(torch.arange(i * 1000, (i + 1) * 1000).reshape(10, 100),
             torch.full((10,), float(i))) for i in range(6)]
    stager = WindowStager(iter(host), accum=2, device=cuda, buffers=2)
    try:
        assert stager._copy_stream != torch.cuda.current_stream()
        for w in range(3):
            window = stager.get_window()
            assert window.event is not None
            window.wait()
            for (ids, x), (hid, hx) in zip(window.arrays,
                                           host[2 * w: 2 * w + 2]):
                assert ids.is_cuda and x.is_cuda
                assert torch.equal(ids.cpu(), hid) and torch.equal(x.cpu(), hx)
        assert len([s for s in stager._pinned if s is not None]) <= 2
        assert all(t.is_pinned() for s in stager._pinned if s for t in s)
        with pytest.raises(StopIteration):
            stager.get_window()
    finally:
        stager.close()
    assert not stager.alive()


@pytest.mark.cuda
def test_staged_training_equals_unstaged_on_the_card(cuda):
    """initialize() with training_data on the card: the loader's batches
    are pinned, and a staged run (accum 2: the engine's stager over the
    loader) equals the unstaged one bit for bit with dropout on."""
    import numpy as np

    ids = np.random.default_rng(0).integers(0, 256, (16, 256))
    runs = []
    for staged in (False, True):
        model = GPT2LMHeadModel(GPT2Config(
            vocab_size=256, n_positions=256, n_embd=128, n_layer=2,
            n_head=2, dropout=0.1), device=cuda)
        engine, _, loader, _ = deepspeed_tpu_torch.initialize(
            model=model, training_data=(ids, ids.copy()), config_params={
                "train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": 2,
                "bf16": {"enabled": True},
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "data_pipeline": {"enabled": staged}})
        first = next(iter(loader))
        assert first[0].is_pinned() and not first[0].is_cuda
        it = iter(loader)
        losses = [float(engine.train_batch(it)) for _ in range(4)]
        assert (engine._stager is not None) == staged
        runs.append((losses, [p.detach().clone() for p in
                              engine.module.parameters()],
                     engine._rng.get_state()))
        engine.close_data_pipeline()
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert torch.equal(runs[0][2], runs[1][2])


@pytest.mark.cuda
def test_stager_copy_overlaps_a_held_compute_stream(cuda):
    """With the compute stream held in a spin kernel, the window the
    stager stages meanwhile finishes its copy before the spin does: the
    copy runs on the copy stream, beside the compute stream's work (a
    copy queued on the compute stream would wait for the spin)."""
    from deepspeed_tpu_torch.runtime.staging import WindowStager

    host = [(torch.arange(i * 4096, (i + 1) * 4096).reshape(4, 1024),)
            for i in range(4)]
    stager = WindowStager(iter(host), accum=1, device=cuda, buffers=2)
    try:
        stager.get_window().wait()  # windows 1 and 2 staged: slots warm
        torch.cuda.synchronize()
        held = torch.cuda.Event()
        torch.cuda._sleep(1_000_000_000)
        held.record()
        before = list(stager._slot_events)
        window = stager.get_window()  # frees a slot: window 3 is staged
        deadline = time.monotonic() + 30.0
        while all(e is b for e, b in zip(stager._slot_events, before)):
            assert time.monotonic() < deadline, "window 3 was not staged"
            time.sleep(0.001)
        new = [e for e, b in zip(stager._slot_events, before) if e is not b]
        new[0].synchronize()
        assert not held.query(), "the copy waited for the compute stream"
        window.wait()
        torch.cuda.synchronize()
        assert torch.equal(window.arrays[0][0].cpu(), host[1][0])
    finally:
        stager.close()


@pytest.mark.cuda
def test_loader_staged_training_equals_unstaged_at_accum_1_on_the_card(
        cuda):
    """At one micro-batch a window the loader stages its own batches (on
    the card when handed over) and train_batch adds no stager; the run
    equals the unstaged one bit for bit with dropout on, and
    close_data_pipeline stops the loader's stager."""
    import numpy as np

    ids = np.random.default_rng(0).integers(0, 256, (12, 256))
    runs = []
    for staged in (False, True):
        model = GPT2LMHeadModel(GPT2Config(
            vocab_size=256, n_positions=256, n_embd=128, n_layer=2,
            n_head=2, dropout=0.1), device=cuda)
        engine, _, loader, _ = deepspeed_tpu_torch.initialize(
            model=model, training_data=(ids, ids.copy()), config_params={
                "train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": 1,
                "bf16": {"enabled": True},
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "data_pipeline": {"enabled": staged}})
        it = iter(loader)
        first = next(it)
        assert first[0].is_cuda == staged
        assert first[0].is_pinned() != staged
        losses = [float(engine.train_batch(it)) for _ in range(5)]
        assert engine._stager is None
        assert (getattr(it, "stager", None) is not None) == staged
        runs.append((losses, [p.detach().clone() for p in
                              engine.module.parameters()],
                     engine._rng.get_state()))
        engine.close_data_pipeline()
        if staged:
            assert it.stager.closed
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert torch.equal(runs[0][2], runs[1][2])


# ---------------------------------------------------------------------------
# BERT's route: non-causal, padded, dropout; the optimizer state layouts
# ---------------------------------------------------------------------------
def _bert_mask(cuda, b, s):
    """Ragged valid lengths with a dead row (index 1)."""
    lengths = [s, 0, s // 2 + 7, 128][:b]
    mask = torch.zeros(b, s, dtype=torch.int32, device=cuda)
    for row, n in enumerate(lengths):
        mask[row, :n] = 1
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_noncausal_padded_at_the_bert_shape(cuda, dtype, rate):
    """BERT-large's attention (16 heads, D = 64, S = 512), non-causal with
    a padding mask of ragged lengths and a dead row: the forward, dQ and
    dK/dV kernels against their plain versions; the dead row's output and
    gradients exact zeros, and query rows past a row's length still
    attend to its valid keys (nonzero output)."""
    b, h, s, d = 4, 16, 512, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, dout = (torch.randn(b, h, s, d, device=cuda, generator=g)
                     .to(dtype) for _ in range(4))
    mask = _bert_mask(cuda, b, s)
    args = (q, k, v, mask, False, None, rate, 17)
    out, lse = flash_fwd(*args)
    torch.cuda.synchronize()
    ref, ref_lse = flash_fwd_plain(*args)
    _close(out, ref, dtype)
    assert bool((out[1] == 0).all())
    assert bool((out[2, :, s - 1] != 0).any())  # a query past the length
    delta = (dout.float() * ref.float()).sum(dim=-1)
    bargs = (q, k, v, mask, dout, ref_lse, delta, False, None, rate, 17)
    dq = flash_bwd_dq(*bargs)
    dk, dv = flash_bwd_dkv(*bargs)
    torch.cuda.synchronize()
    want = (flash_bwd_dq_plain(*bargs), *flash_bwd_dkv_plain(*bargs))
    for got, ref_g in zip((dq, dk, dv), want):
        _close(got, ref_g, dtype, scaled=True)
        assert bool((got[1] == 0).all())
    # padded keys take no gradient
    assert bool((dk[2, :, s // 2 + 7:] == 0).all())
    assert bool((dv[2, :, s // 2 + 7:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pretraining", "qa"])
def test_bert_gradients_through_the_kernels(cuda, kind):
    """A 2-layer BERT at seq 256 (the flash route), float32, dropout 0,
    padded rows: each attention kernel launches once a layer, and the
    gradients through the kernels equal those through the plain versions
    to 1e-4 of each tensor's scale, or 1e-7 where that scale is below
    1e-3 (gradients that are zero in exact arithmetic, the QA head's bias
    and the last norm bias under QA, carry ~3e-8 of rounding on both
    routes)."""
    from deepspeed_tpu_torch import (BertConfig, BertForPreTraining,
                                     BertForQuestionAnswering)
    from deepspeed_tpu_torch.ops import attention as A

    cfg = BertConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     max_position_embeddings=256, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    cls = BertForPreTraining if kind == "pretraining" else (
        BertForQuestionAnswering)
    model = cls(cfg, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(0, 512, (3, 256), device=cuda, generator=g)
    mask = _bert_mask(cuda, 3, 256)
    mask[1, :40] = 1  # no dead row in a model batch
    tt = torch.zeros_like(ids)
    if kind == "pretraining":
        labels = torch.where(torch.rand(ids.shape, device=cuda, generator=g)
                             < 0.15, ids, -100)
        extra = (labels, torch.tensor([0, 1, 0], device=cuda))
    else:
        extra = (torch.tensor([3, 10, 50], device=cuda),
                 torch.tensor([5, 20, 60], device=cuda))

    def grads(plain):
        kernels = (A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv)
        if plain:
            A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = (
                A.flash_fwd_plain, A.flash_bwd_dq_plain,
                A.flash_bwd_dkv_plain)
        try:
            counts = [f.launches for f in kernels]
            loss = model(ids, mask, tt, *extra, train=True)
            out = torch.autograd.grad(loss, list(model.parameters()),
                                      allow_unused=True)
            torch.cuda.synchronize()
            return out, [f.launches - c for f, c in zip(kernels, counts)]
        finally:
            A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = kernels

    got, launches = grads(False)
    assert launches == [2, 2, 2]
    want, _ = grads(True)
    for (name, _), a, w in zip(model.named_parameters(), got, want):
        if w is None:
            assert a is None
            continue
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-4 * max(scale, 1e-3), name


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["offload", "int8", "compensated"])
def test_state_layouts_on_the_card(cuda, layout):
    """A 2-layer GPT-2 (seq 256, bf16, dropout 0.1), Adam, 3 windows.
    Offload: the masters and moments in pinned host memory and the run
    equal to the on-device one bit for bit (losses, masters, published
    parameters). int8 and compensated: finite falling losses and a
    bit-for-bit resume through a checkpoint."""
    import tempfile

    def engine_for(extra, seed=0):
        model = GPT2LMHeadModel(GPT2Config(
            vocab_size=256, n_positions=256, n_embd=128, n_layer=2,
            n_head=2, dropout=0.1), device=cuda, seed=seed)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config_params=dict({
            "train_micro_batch_size_per_gpu": 4,
            "gradient_accumulation_steps": 2,
            "bf16": {"enabled": True}, "gradient_clipping": 1.0,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}, **extra))
        return engine

    g = torch.Generator(device=cuda).manual_seed(1)
    ids = torch.randint(0, 256, (8, 256), device=cuda, generator=g)
    micro = [(ids[:4], ids[:4]), (ids[4:], ids[4:])]

    def run(engine, n):
        return [float(engine.train_batch(iter(micro))) for _ in range(n)]

    if layout == "offload":
        on_dev = engine_for({})
        off = engine_for({"zero_optimization": {
            "offload_optimizer": {"device": "cpu"}}})
        for n, p in off.params.items():
            assert p.is_pinned() and not p.is_cuda and p.dtype == torch.float32
            assert off.module_params[n].is_cuda
            assert off.module_params[n].dtype == torch.bfloat16
        assert all(t.is_pinned() for t in off.optimizer_state["mu"].values())
        assert run(off, 3) == run(on_dev, 3)
        for n, p in on_dev.params.items():
            assert torch.equal(off.params[n], p.cpu()), n
            assert torch.equal(off.module_params[n],
                               p.to(torch.bfloat16)), n
        return
    extra = ({"data_types": {"optimizer_state_dtype": "int8"}}
             if layout == "int8"
             else {"data_types": {"master_dtype": "compensated"}})
    first = engine_for(extra)
    losses = run(first, 3)
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]
    with tempfile.TemporaryDirectory() as d:
        first.save_checkpoint(d, tag="t")
        cont = run(first, 2)
        fresh = engine_for(extra, seed=5)
        fresh.load_checkpoint(d, tag="t")
        assert run(fresh, 2) == cont
    for n, p in first.params.items():
        assert torch.equal(fresh.params[n], p), n


# ---------------------------------------------------------------------------
# the rest of inference on the card: the contiguous cache, the host tier
# and speculative decoding
# ---------------------------------------------------------------------------
def _serving_model(cuda, n_head, n_embd=256, n_layer=2, seed=0):
    cfg = GPT2Config(vocab_size=512, n_positions=256, n_embd=n_embd,
                     n_layer=n_layer, n_head=n_head)
    return GPT2LMHeadModel(cfg, device=cuda, seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, 128])
def test_contiguous_decode_step_matches_the_paged_kernel_step(cuda,
                                                             head_dim):
    """Eight decode steps over the contiguous cache (plain attention)
    against the paged cache through the paged decode kernel, from the
    same prefilled k/v: float32 logits within TOL, the same greedy
    tokens fed to both, and the kernel launched once a layer a step."""
    from deepspeed_tpu_torch.inference import decode as D

    model = _serving_model(cuda, n_head=256 // head_dim)
    model.requires_grad_(False)
    gen = torch.Generator(device=cuda).manual_seed(3)
    lengths = [37, 5, 64]
    slots, max_len, bs = len(lengths), 128, 16
    cache = D.init_kv_cache(model.config, slots, max_len, device=cuda)
    pool = D.init_kv_pool(model.config, slots * max_len // bs, bs,
                          device=cuda)
    tables = torch.zeros(slots, max_len // bs, dtype=torch.int32,
                         device=cuda)
    for s, n in enumerate(lengths):
        ids = torch.randint(0, 512, (1, 64), device=cuda, generator=gen)
        _, ks, vs = D.gpt2_prefill(model, ids)
        D.write_prefill_to_cache(cache, s, ks, vs)
        pages = torch.arange(1 + s * (max_len // bs),
                             1 + (s + 1) * (max_len // bs), device=cuda)
        tables[s] = pages.to(torch.int32)
        pos = torch.arange(64, device=cuda)
        D.write_prefill_to_pool(pool, ks, vs,
                                tables[s].long()[pos // bs].int(),
                                (pos % bs).int())
    tokens = torch.tensor([1, 2, 3], dtype=torch.int32, device=cuda)
    positions = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    paged_flash_decode.launches = 0
    for _ in range(8):
        lc, _ = D.gpt2_decode_step(model, tokens, positions, cache)
        lp, _ = D.gpt2_decode_step_paged(model, tokens, positions, pool,
                                         tables, fused=True)
        _close(lc, lp, torch.float32)
        tokens = lc.argmax(-1).to(torch.int32)
        positions = positions + 1
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == 8 * model.config.n_layer


def _tier_engine(model, dtype, group, **inference):
    block = {"max_batch_slots": 4, "max_seq_len": 64, "prefill_len": 48,
             "kv_block_size": 16, "kv_pool_blocks": 6, "dtype": dtype,
             "sampling": {"greedy": True},
             "host_tier": {"enabled": True, "share_group": group}}
    block.update(inference)
    return deepspeed_tpu_torch.init_inference(
        model=model, config={"inference": block})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_host_tier_page_round_trip_is_bitwise_on_the_card(cuda, dtype):
    """A template's pages spill to pinned host memory under churn and
    promote back through the copy stream: every parked entry holds the
    bytes its page held, every promoted page holds its entry's bytes,
    and the template's second serve equals its first."""
    model = _serving_model(cuda, n_head=4)
    engine = _tier_engine(model, dtype, f"card-rt-{dtype}")
    gen = torch.Generator().manual_seed(5)

    def prompt(n):
        return torch.randint(0, 512, (n,), generator=gen).tolist()

    try:
        template = prompt(32) + prompt(8)
        first = engine.generate([template], max_new_tokens=8)[0]
        pages = {h: (engine._cache.k[:, b].clone(),
                     engine._cache.v[:, b].clone())
                 for h, b in engine.block_pool._registry.items()}
        rs = [engine.submit(prompt(32), max_new_tokens=8)
              for _ in range(3)]
        engine.scheduler.run_until_idle()
        assert all(len(r.result(0)) == 8 for r in rs)
        tier = engine.host_tier
        assert engine.kv_snapshot()["host_tier_spills"] >= 2
        for h, (k, v) in pages.items():
            if tier.contains(h):
                parked = tier._entries[h].arrays
                assert all(t.is_pinned() for t in parked)
                assert torch.equal(parked[0].to(cuda), k)
                assert torch.equal(parked[1].to(cuda), v)
        parked = {h: tier._entries[h].arrays for h in tier.keys()}
        second = engine.generate([template], max_new_tokens=8)[0]
        assert engine.kv_snapshot()["host_tier_promotions"] >= 1
        promoted = [h for h in parked if h in engine.block_pool._registry]
        assert promoted
        for h in promoted:
            b = engine.block_pool._registry[h]
            assert torch.equal(engine._cache.k[:, b].cpu(), parked[h][0])
            assert torch.equal(engine._cache.v[:, b].cpu(), parked[h][1])
        assert second == first
    finally:
        engine.close()


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["agreeing", "random"])
def test_speculative_equals_nonspeculative_on_the_card(cuda, draft):
    """Float32, a 2-layer target: the speculative engine's greedy tokens
    equal the non-speculative engine's (fused paged decode), with an
    agreeing 1-layer draft (the target's first block; the second block's
    output projections zero) and with an independent random draft."""
    target = _serving_model(cuda, n_head=4)
    target.requires_grad_(False)
    dmodel = _serving_model(cuda, n_head=4, n_layer=1, seed=7)
    if draft == "agreeing":
        with torch.no_grad():
            for name in ("attn_ow", "output_w", "attn_ob", "output_b"):
                getattr(target.h[1], name).zero_()
        state = {k: v for k, v in target.state_dict().items()
                 if not k.startswith("h.1.")}
        dmodel.load_state_dict(state)
    block = {"max_batch_slots": 4, "max_seq_len": 128, "kv_block_size": 16,
             "sampling": {"greedy": True}}
    ref = deepspeed_tpu_torch.init_inference(
        model=target, config={"inference": dict(block, fused_decode=True)})
    spec = deepspeed_tpu_torch.init_inference(
        model=target, draft_model=dmodel,
        config={"inference": dict(block, speculative={"k": 4})})
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, 512, (n,), generator=gen).tolist()
               for n in (9, 30, 17)]
    try:
        assert spec.generate(prompts, max_new_tokens=24) == \
            ref.generate(prompts, max_new_tokens=24)
        snap = spec.metrics.snapshot()
        assert snap["infer/spec_proposed"] > 0
        if draft == "agreeing":
            assert snap["infer/spec_acceptance_rate"] > 0.8, snap
    finally:
        ref.close()
        spec.close()


@pytest.mark.cuda
def test_two_replica_fleet_equals_one_engine_on_the_card(cuda):
    """Float32: an in-process fleet of two engines on the card (one
    driver thread each, prefix affinity) answers every request with the
    greedy tokens of one engine alone, through the flash forward at
    prefill (prefill_len 256) and the paged decode kernel."""
    model = _serving_model(cuda, n_head=4)
    model.requires_grad_(False)
    block = {"max_batch_slots": 4, "max_seq_len": 256, "prefill_len": 256,
             "kv_block_size": 16, "fused_decode": True,
             "sampling": {"greedy": True}}

    def factory():
        return deepspeed_tpu_torch.init_inference(
            model=model, config={"inference": dict(block)})

    gen = torch.Generator().manual_seed(11)
    head = torch.randint(0, 512, (48,), generator=gen).tolist()
    prompts = [head + torch.randint(0, 512, (n,), generator=gen).tolist()
               for n in (5, 9, 14)]
    prompts += [torch.randint(0, 512, (n,), generator=gen).tolist()
                for n in (20, 33, 7)]
    single = factory()
    try:
        want = single.generate(prompts, max_new_tokens=16)
    finally:
        single.close()
    flash_fwd.launches = paged_flash_decode.launches = 0
    router = deepspeed_tpu_torch.init_fleet(
        engine_factory=factory,
        config={"serving": {"replicas": 2, "placement": "prefix_affinity",
                            "affinity_prefix_tokens": 32}})
    try:
        reqs = [router.submit(p, max_new_tokens=16) for p in prompts]
        assert [r.result(120.0) for r in reqs] == want
        assert {r.replica_id for r in reqs} <= {"0", "1"}
        assert all(r.reroutes == 0 for r in reqs)
        assert router.evicted_ids == set()
    finally:
        router.shutdown()
    assert flash_fwd.launches > 0 and paged_flash_decode.launches > 0
