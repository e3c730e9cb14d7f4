"""Port parity for the flash tile autotuner (deepspeed_tpu_torch.ops.
autotune against deepspeed_tpu.ops.autotune).

On the CPU the port's autotuner runs the plain version (no tiles) for
every candidate that tiles ``seq``: the smoke test is the JAX package's
``test_autotune_flash_blocks_smoke`` with the same arguments, and both
packages keep the same candidates (the tiling filter and the clamping of
each to ``seq``). Which tile forms the card's kernel has is
``flash_block_forms``; a form it lacks is refused by the wrapper.
Timings are not compared: they are the host's.
"""

import importlib

import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops import autotune as tautotune
from torch_test_env import jax_compile_cache  # noqa: F401

jautotune = importlib.import_module("deepspeed_tpu.ops.autotune")

SMOKE = dict(causal=True, candidates=((64, 64), (128, 128)), steps=1)


def test_autotune_flash_blocks_smoke():
    """The JAX smoke test's call: a valid best pair among the two kept
    candidates, and a cached second call."""
    (bq, bk), table = tautotune.autotune_flash_blocks(
        2, 2, 128, 64, dtype=torch.float32, device="cpu", **SMOKE)
    assert (bq, bk) in table and len(table) == 2
    assert all(t > 0 for t in table.values())
    again, table2 = tautotune.autotune_flash_blocks(
        2, 2, 128, 64, dtype=torch.float32, device="cpu", **SMOKE)
    assert again == (bq, bk) and table2 is table


def test_autotune_keeps_the_jax_candidates():
    """The same ``seq`` and candidates keep the same (clamped) pairs in
    both packages."""
    _, want = jautotune.autotune_flash_blocks(
        2, 2, 128, 64, dtype=jnp.float32, **SMOKE)
    _, got = tautotune.autotune_flash_blocks(
        2, 2, 128, 64, dtype=torch.float32, device="cpu", **SMOKE)
    assert set(got) == set(want) == {(64, 64), (128, 128)}


@pytest.mark.parametrize("seq,candidates,kept", [
    # 96 is not tiled by 64: only the clamped (96, 96) stays
    (96, ((64, 64), (128, 128)), {(96, 96)}),
    # 256 and 512 both clamp to the whole sequence: timed once
    (128, ((256, 256), (512, 512), (64, 32)), {(128, 128), (64, 32)}),
])
def test_autotune_filters_and_clamps(seq, candidates, kept):
    _, table = tautotune.autotune_flash_blocks(
        1, 1, seq, 16, causal=False, dtype=torch.float32,
        candidates=candidates, steps=1, include_backward=False,
        device="cpu")
    assert set(table) == kept


def test_autotune_raises_when_no_candidate_tiles():
    with pytest.raises(RuntimeError, match="no flash block candidate"):
        tautotune.autotune_flash_blocks(
            1, 1, 100, 16, dtype=torch.float32, candidates=((64, 64),),
            steps=1, device="cpu")


def test_autotune_caches_per_key():
    """A different ``include_backward`` is another entry."""
    args = (1, 2, 64, 16)
    kw = dict(dtype=torch.float32, candidates=((32, 32),), steps=1,
              device="cpu")
    fwd = tautotune.autotune_flash_blocks(*args, include_backward=False, **kw)
    both = tautotune.autotune_flash_blocks(*args, **kw)
    assert fwd[1] is not both[1]
    assert tautotune.autotune_flash_blocks(*args, **kw)[1] is both[1]


@pytest.mark.parametrize("dtype,d,forms", [
    (torch.bfloat16, 64, ((128, 128), (128, 64))),
    (torch.float16, 128, ((128, 128), (128, 64))),
    (torch.bfloat16, 96, ((128, 128), (128, 64))),  # runs at width 128
    (torch.bfloat16, 256, ((128, 64),)),
    (torch.float32, 64, ((32, 64),)),
    (torch.float32, 256, ((32, 16),)),
])
def test_flash_block_forms(dtype, d, forms):
    assert tattn.flash_block_forms(dtype, d) == forms
    assert tattn._block_k_arg(dtype, d, None) == 0
    for _, bk in forms:
        assert tattn._block_k_arg(dtype, d, bk) == bk


@pytest.mark.parametrize("dtype,d,block_k", [
    (torch.bfloat16, 64, 32),
    (torch.bfloat16, 128, 256),
    (torch.bfloat16, 256, 128),  # D = 256 has 64-key tiles only
    (torch.float32, 128, 128),
])
def test_flash_refuses_a_form_the_kernels_lack(dtype, d, block_k):
    with pytest.raises(ValueError, match="has no block_k ="):
        tattn._block_k_arg(dtype, d, block_k)


def test_flash_attention_blocks_leave_the_plain_version_unchanged():
    """On CPU tensors the forms change nothing: the plain version has no
    tiles."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 64, 16, generator=g) for _ in range(3))
    want = tattn.flash_attention(q, k, v, causal=True)
    got = tattn.flash_attention(q, k, v, causal=True, block_q=128,
                                block_k=64)
    assert torch.equal(got, want)
