"""Port parity: deepspeed_tpu_torch.ops.decode_attention against the JAX
package's paged flash-decode kernel (Pallas, interpret mode on the CPU)
and against a numpy oracle. The port runs on CPU tensors, i.e. its plain
PyTorch version. float32; atol = rtol = 1e-5 (the JAX package's tolerance
for its kernel against the oracle, test_paged_kv.py): the versions differ
only in summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.decode_attention import paged_flash_decode as jax_decode
from deepspeed_tpu_torch.ops.decode_attention import (
    paged_flash_decode,
    paged_flash_decode_plain,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, b=4, heads=4, hd=64, bs=4, mb=6, pages=20):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, heads, hd)).astype(np.float32)
    kp = rng.normal(size=(pages, bs, heads, hd)).astype(np.float32)
    vp = rng.normal(size=(pages, bs, heads, hd)).astype(np.float32)
    tables = np.zeros((b, mb), np.int32)
    tables[0, :2] = [3, 7]
    tables[2] = [1, 2, 4, 5, 6, 8]  # slot 1 stays dead
    tables[3, :4] = [9, 0, 11, 12]  # a NULL page in the middle
    positions = np.asarray([5, 0, 22, 14], np.int32)
    return q, kp, vp, tables, positions


def _oracle(q, kp, vp, tables, positions, slot):
    """Single-slot softmax attention over the slot's pages, keys past the
    position and keys on NULL pages masked out."""
    b, heads, hd = q.shape
    bs, mb = kp.shape[1], tables.shape[1]
    k_full = kp[tables[slot]].reshape(mb * bs, heads, hd).transpose(1, 0, 2)
    v_full = vp[tables[slot]].reshape(mb * bs, heads, hd).transpose(1, 0, 2)
    s = np.einsum("hd,hkd->hk", q[slot], k_full) / np.sqrt(hd)
    tok = np.arange(mb * bs)
    valid = (tok <= positions[slot]) & (np.repeat(tables[slot], bs) != 0)
    s = np.where(valid, s, -1e30)
    p = np.where(valid, np.exp(s - s.max(-1, keepdims=True)), 0.0)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("hk,hkd->hd", p, v_full)


def _port(q, kp, vp, tables, positions):
    return paged_flash_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(positions),
    ).numpy()


def test_paged_decode_matches_jax_kernel_and_oracle():
    q, kp, vp, tables, positions = _case(0)
    got = _port(q, kp, vp, tables, positions)
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(positions),
    ))
    np.testing.assert_allclose(got, want, **TOL)
    for slot in (0, 2, 3):
        np.testing.assert_allclose(
            got[slot], _oracle(q, kp, vp, tables, positions, slot), **TOL
        )


def test_dead_slot_gives_exact_zeros():
    q, kp, vp, tables, positions = _case(1)
    got = _port(q, kp, vp, tables, positions)
    assert np.all(got[1] == 0.0), "dead slot must emit exact zeros"


def test_null_page_mid_table_is_skipped():
    """Slot 3's table has the NULL page at logical page 1: its keys are
    skipped, so rewriting the NULL page's contents changes nothing."""
    q, kp, vp, tables, positions = _case(2)
    before = _port(q, kp, vp, tables, positions)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = 1e3
    vp2[0] = -1e3
    after = _port(q, kp2, vp2, tables, positions)
    np.testing.assert_array_equal(before, after)
    # and it differs from attending the page's tokens as if they were live
    dense = tables.copy()
    dense[3, 1] = 10
    assert not np.allclose(
        _port(q, kp, vp, dense, positions)[3], before[3], **TOL
    )


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    q, kp, vp, tables, positions = _case(3)
    args = [torch.from_numpy(x) for x in (q, kp, vp, tables, positions)]
    np.testing.assert_array_equal(
        paged_flash_decode(*args).numpy(),
        paged_flash_decode_plain(*args).numpy(),
    )
    assert paged_flash_decode.launches == 0  # the plain version is uncounted


@pytest.mark.parametrize("dtype", [torch.bfloat16])
def test_plain_version_keeps_pool_dtype(dtype):
    q, kp, vp, tables, positions = _case(4)
    out = paged_flash_decode(
        torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
        torch.from_numpy(vp).to(dtype), torch.from_numpy(tables),
        torch.from_numpy(positions),
    )
    assert out.dtype == dtype and torch.all(out[1] == 0)
