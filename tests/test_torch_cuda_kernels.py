"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a GPU each test skips (the fixture decides
at run time). On the card run

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances as in chip_smoke.py: float32 atol = rtol = 1e-4 (another
summation order), bfloat16 atol = rtol = 1e-2 (p and the output rounded
to bfloat16 at different points of the online softmax; rtol 1e-2 covers
one bf16 ulp, 2**-7 relative, at any magnitude).
"""

import pytest
import torch

from deepspeed_tpu_torch.ops.attention import flash_fwd, flash_fwd_plain
from deepspeed_tpu_torch.ops.decode_attention import (
    paged_flash_decode,
    paged_flash_decode_plain,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(
        got.float(), want.float(), atol=tol, rtol=tol
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,masked", [
    (1024, 1024, True, False),
    (200, 333, True, True),     # ragged tiles, diag offset, key mask
    (256, 256, False, True),
    (1, 77, True, False),
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


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 2, 256, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(q, q, q)
    with pytest.raises(TypeError):
        flash_fwd(q.half()[..., :64], q.half()[..., :64], q.half()[..., :64])
    qd = torch.randn(2, 4, 64, device=cuda)
    pool = torch.randn(5, 8, 4, 64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        paged_flash_decode(
            qd, pool, pool, torch.zeros(2, 3, dtype=torch.int64, device=cuda),
            torch.zeros(2, dtype=torch.int32, device=cuda),
        )
