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
from deepspeed_tpu_torch.ops.attention import NEG_INF
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


def _paged_decode_split_plain(q, k_pool, v_pool, block_tables, positions,
                              splits, sm_scale=None):
    """The split kernel's algebra in plain PyTorch, for the tests only:
    the table's pages cut into ``splits`` runs of ceil(max_blocks /
    splits) pages (runs past the last page are empty), each run's softmax
    partial taken on its own (its max m, its normaliser l, its value sum
    of p rounded to the pool's dtype), then the partials merged in split
    order. An empty run or one that sees no key is (m = -1e30, l = 0,
    acc = 0)."""
    b, heads, hd = q.shape
    bs, mb = k_pool.shape[1], block_tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (hd ** 0.5)
    tables = block_tables.long()
    n = mb * bs
    k_full = k_pool[tables].reshape(b, n, heads, hd).float()
    v_full = v_pool[tables].reshape(b, n, heads, hd).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k_full) * sm_scale
    tok = torch.arange(n)
    live = (tables != 0).repeat_interleave(bs, dim=1)
    valid = (tok[None, :] <= positions.long()[:, None]) & live
    s = torch.where(valid[:, None, :], s, NEG_INF)
    per = -(-mb // splits)
    parts = []
    for z in range(splits):
        run = (tok // bs >= z * per) & (tok // bs < (z + 1) * per)
        if not bool(run.any()):
            parts.append((torch.full((b, heads, 1), NEG_INF),
                          torch.zeros(b, heads, 1), torch.zeros(b, heads, hd)))
            continue
        sz = s[..., run]
        m = sz.amax(dim=-1, keepdim=True)
        p = torch.where(sz > NEG_INF / 2, torch.exp(sz - m), 0.0)
        acc = torch.einsum("bhk,bkhd->bhd", p.to(v_pool.dtype).float(),
                           v_full[:, run])
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_all = torch.zeros(b, heads, 1)
    acc_all = torch.zeros(b, heads, hd)
    for m, l, acc in parts:
        f = torch.exp(m - m_all)
        l_all = l_all + l * f
        acc_all = acc_all + acc * f
    l_all = torch.where(l_all == 0.0, 1.0, l_all)
    return (acc_all / l_all).to(v_pool.dtype)


def _torch(*arrays):
    return [torch.from_numpy(x) for x in arrays]


# split counts: one run, two and three runs of _case's 6 pages, and more
# runs than pages (empty runs)
SPLITS = [1, 2, 3, 8]


@pytest.mark.parametrize("splits", SPLITS)
def test_split_algebra_matches_jax_kernel_and_oracle(splits):
    q, kp, vp, tables, positions = _case(5)
    got = _paged_decode_split_plain(
        *_torch(q, kp, vp, tables, positions), splits
    ).numpy()
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(positions),
    ))
    np.testing.assert_allclose(got, want, **TOL)
    for slot in (0, 2, 3):
        np.testing.assert_allclose(
            got[slot], _oracle(q, kp, vp, tables, positions, slot), **TOL
        )


def _boundary_case(splits, seed, bs=4, mb=12):
    """Every slot live over a full table, positions on the run boundaries
    of ``splits`` (the last token of a run, the first of the next and the
    one after), one slot dead and one with a NULL page inside a run."""
    rng = np.random.default_rng(seed)
    per = -(-mb // splits)
    starts = [z * per * bs for z in range(1, splits) if z * per < mb]
    pos = sorted({p for t in starts or [mb * bs // 2]
                  for p in (t - 1, t, t + 1) if 0 <= p < mb * bs})
    pos += [mb * bs - 1, 0]
    b, heads, hd = len(pos) + 2, 2, 64
    pages = b * mb + 1
    q = rng.normal(size=(b, heads, hd)).astype(np.float32)
    kp = rng.normal(size=(pages, bs, heads, hd)).astype(np.float32)
    vp = rng.normal(size=(pages, bs, heads, hd)).astype(np.float32)
    tables = (rng.permutation(pages - 1) + 1).reshape(b, mb).astype(np.int32)
    dead, holed = len(pos), len(pos) + 1
    tables[dead] = 0
    tables[holed, min(per, mb - 1)] = 0
    positions = np.asarray(pos + [0, mb * bs - 1], np.int32)
    return q, kp, vp, tables, positions, dead


@pytest.mark.parametrize("splits", SPLITS)
def test_split_algebra_matches_plain_on_split_boundaries(splits):
    q, kp, vp, tables, positions, _ = _boundary_case(splits, 6)
    args = _torch(q, kp, vp, tables, positions)
    np.testing.assert_allclose(
        _paged_decode_split_plain(*args, splits).numpy(),
        paged_flash_decode_plain(*args).numpy(), **TOL,
    )


@pytest.mark.parametrize("splits", SPLITS)
def test_split_algebra_keeps_a_dead_slot_exact_zeros(splits):
    q, kp, vp, tables, positions, dead = _boundary_case(splits, 7)
    got = _paged_decode_split_plain(
        *_torch(q, kp, vp, tables, positions), splits
    ).numpy()
    assert np.all(got[dead] == 0.0), "dead slot must emit exact zeros"
    assert np.all(np.isfinite(got))
