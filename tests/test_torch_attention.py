"""Port parity: deepspeed_tpu_torch.ops.attention against the JAX package.

The same numpy inputs go through the JAX flash kernel (Pallas, in
interpret mode on the CPU, as the JAX package's own tests run it) and
through the port's ``flash_attention`` on CPU tensors (its plain PyTorch
version). float32; atol = rtol = 1e-5, the JAX package's own tolerance
for its kernel against its reference (test_transformer.py): both sides
compute the same softmax in float32 and differ only in summation order.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu_torch.ops import attention as tattn
from torch_test_env import jax_compile_cache  # noqa: F401

jattn = importlib.import_module("deepspeed_tpu.ops.attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    return q, k, v


def _padding_mask(b, sk, lengths):
    """Additive [B, 1, 1, Sk] padding mask: row i attends keys < lengths[i]."""
    valid = np.arange(sk)[None, :] < np.asarray(lengths)[:, None]
    return np.where(valid, 0.0, -1e30).astype(np.float32)[:, None, None, :]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_flash_attention_matches_jax_kernel(causal, with_mask):
    b, h, s, d = 2, 2, 256, 64
    q, k, v = _qkv(0, b, h, s, s, d)
    mask = _padding_mask(b, s, [200, 150]) if with_mask else None
    o_jax = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), causal=causal,
    )
    o_port = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask),
        causal=causal,
    )
    np.testing.assert_allclose(o_port.numpy(), np.asarray(o_jax), **TOL)


def test_flash_fwd_lse_and_diagonal_offset_match_jax_kernel():
    """sq != sk under causal (diagonal aligned bottom-right, diag_offset
    = sk - sq), with a key mask: out and the log-sum-exp both agree with
    the JAX kernel's (its lse rides a 128-lane trailing dim)."""
    b, h, sq, sk, d = 2, 2, 128, 256, 64
    q, k, v = _qkv(1, b, h, sq, sk, d)
    kv_mask = (np.arange(sk)[None, :] < np.array([[230], [256]])).astype(
        np.int32
    )
    sm_scale = 1.0 / np.sqrt(d)
    out_j, lse_j = jattn._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_mask), 0, True, sm_scale, 0.0, 128, 256,
    )
    out_t, lse_t = tattn.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_mask), causal=True,
    )
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(
        lse_t.numpy(), np.asarray(lse_j)[..., 0].reshape(b, h, sq), **TOL
    )


def test_fully_masked_rows_are_exact_zeros_like_jax_kernel():
    """A batch row with no valid key comes out as exact zeros from both
    kernels (l == 0 -> output 0), not a uniform average."""
    b, h, s, d = 2, 2, 256, 64
    q, k, v = _qkv(2, b, h, s, s, d)
    kv_mask = np.ones((b, s), np.int32)
    kv_mask[1] = 0
    o_jax = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=jnp.asarray(kv_mask),
    ))
    o_port = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=torch.from_numpy(kv_mask),
    ).numpy()
    assert np.all(o_jax[1] == 0.0) and np.all(o_port[1] == 0.0)
    np.testing.assert_allclose(o_port, o_jax, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax(causal):
    b, h, s, d = 2, 3, 64, 32
    q, k, v = _qkv(3, b, h, s, s, d)
    mask = _padding_mask(b, s, [40, 64])
    o_jax = jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask), causal=causal,
    )
    o_port = tattn.mha_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(mask), causal=causal,
    )
    np.testing.assert_allclose(o_port.numpy(), np.asarray(o_jax), **TOL)


@pytest.mark.parametrize("shape", [(2, 16), (2, 1, 1, 16), (2, 1, 16, 16)])
def test_additive_mask_to_kv_valid_matches_jax(shape):
    rng = np.random.default_rng(4)
    mask = np.where(rng.random(shape) < 0.3, -1e30, 0.0).astype(np.float32)
    got_j = jattn.additive_mask_to_kv_valid(jnp.asarray(mask))
    got_t = tattn.additive_mask_to_kv_valid(torch.from_numpy(mask))
    if got_j is None:
        assert got_t is None  # query-dependent masks are refused by both
    else:
        assert got_t.dtype == torch.int32
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(got_j))


@pytest.mark.parametrize(
    "s,routes_to_flash", [(256, True), (128, False), (521, True)]
)
def test_attention_dispatch_follows_the_jax_routing_rule(s, routes_to_flash):
    """At S >= FLASH_MIN_SEQ the dispatcher takes the flash path (a row
    with no valid key -> zeros); below it the reference (-> a uniform
    average over the masked keys), as the JAX package routes on one
    device. A length with no tile-sized divisor (521, prime) also takes
    the flash path: the CUDA kernel masks a ragged last tile itself,
    where the JAX package fell back to its reference."""
    b, h, d = 2, 2, 64
    q, k, v = _qkv(5, b, h, s, s, d)
    mask = _padding_mask(b, s, [s, 0])
    args = [torch.from_numpy(x) for x in (q, k, v)]
    out = tattn.attention(*args, mask=torch.from_numpy(mask)).numpy()
    want = (
        tattn.flash_attention(*args, mask=torch.from_numpy(mask))
        if routes_to_flash
        else tattn.mha_reference(*args, mask=torch.from_numpy(mask))
    ).numpy()
    np.testing.assert_array_equal(out, want)
    assert np.all(out[1] == 0.0) == routes_to_flash


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal,padded", [
    (True, False), (False, True), (True, True),
])
def test_flash_gradients_match_jax_kernels(s, causal, padded):
    """dQ, dK and dV: jax.grad through the JAX package's flash kernels
    (forward and the _bwd_dq/_bwd_dkv Pallas kernels, interpret mode,
    64-wide blocks) against autograd through the port's FlashAttention
    (the plain versions of its three kernels). float32, 1e-5."""
    import jax

    b, h, d = 2, 2, 64
    q, k, v = _qkv(10, b, h, s, s, d)
    dout = np.random.default_rng(11).normal(size=(b, h, s, d)).astype(
        np.float32)
    kv_mask = None
    if padded:
        kv_mask = (np.arange(s)[None, :]
                   < np.array([[s], [3 * s // 4]])).astype(np.int32)

    def jax_loss(q, k, v):
        out = jattn.flash_attention(
            q, k, v, kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
            causal=causal, block_q=64, block_k=64,
        )
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(
        qt, kt, vt,
        kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask),
        causal=causal,
    )
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_rows_above_a_negative_diagonal_match_jax_kernels():
    """Sq = 256 > Sk = 128 under causal, with a key mask: the diagonal is
    aligned bottom-right (diag_offset = -128), so the first 128 query rows
    see no key. The JAX kernels (_flash_fwd_impl and jax.grad through
    flash_attention, interpret mode, 64-wide blocks) and the port's plain
    versions, which the card holds the tensor-core kernels against, both
    give exact zeros there (output and dQ), and agree everywhere to 1e-5
    (out, lse of the rows that see a key, dQ, dK, dV); float32."""
    import jax

    b, h, sq, sk, d = 2, 2, 256, 128, 64
    q, k, v = _qkv(12, b, h, sq, sk, d)
    dout = np.random.default_rng(13).normal(size=(b, h, sq, d)).astype(
        np.float32)
    kv_mask = (np.arange(sk)[None, :] < np.array([[sk], [100]])).astype(
        np.int32)
    sm_scale = 1.0 / np.sqrt(d)
    out_j, lse_j = jattn._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_mask), 0, True, sm_scale, 0.0, 64, 64,
    )
    out_j = np.asarray(out_j)
    lse_j = np.asarray(lse_j)[..., 0].reshape(b, h, sq)
    out_t, lse_t = tattn.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_mask), causal=True,
    )
    dead = slice(0, sq - sk)
    assert np.all(out_j[:, :, dead] == 0.0)
    assert np.all(out_t.numpy()[:, :, dead] == 0.0)
    np.testing.assert_allclose(out_t.numpy(), out_j, **TOL)
    live = slice(sq - sk, sq)
    np.testing.assert_allclose(lse_t.numpy()[:, :, live], lse_j[:, :, live],
                               **TOL)

    def jax_loss(q, k, v):
        out = jattn.flash_attention(q, k, v, kv_mask=jnp.asarray(kv_mask),
                                    causal=True, block_q=64, block_k=64)
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(qt, kt, vt,
                                kv_mask=torch.from_numpy(kv_mask), causal=True)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    assert np.all(np.asarray(want[0])[:, :, dead] == 0.0)
    assert np.all(got[0].numpy()[:, :, dead] == 0.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_dropout_mask_is_the_kernels_hash():
    """dropout_keep_mask spells out csrc/dropout.cuh's hash (lowbias32,
    row key mix(mix(mix(seed) ^ bh) ^ q), bit mix(row ^ k)) in int64
    tensor ops; here it is held against the same hash in Python ints."""
    m32 = 0xFFFFFFFF

    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & m32
        x ^= x >> 15
        x = (x * 0x846CA68B) & m32
        return x ^ (x >> 16)

    seed, rate, (b, h, sq, sk) = 2**31 - 5, 0.3, (2, 3, 5, 7)
    got = tattn.dropout_keep_mask(seed, (b, h, sq, sk), rate, "cpu")
    threshold = int(rate * 2**32)
    for bh in range(b * h):
        for qi in range(sq):
            row = mix(mix(mix(seed) ^ bh) ^ qi)
            for kj in range(sk):
                want = mix(row ^ kj) >= threshold
                assert bool(got[bh // h, bh % h, qi, kj]) == want


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_within_four_sigma(rate):
    """The keep rate over 2*12*256*256 pairs, overall and for each
    (batch, head), lies within 4 sigma of 1 - rate; two seeds give
    different masks."""
    shape = (2, 12, 256, 256)
    keep = tattn.dropout_keep_mask(1234, shape, rate, "cpu").double()
    p = 1.0 - rate
    n = keep.numel()
    assert abs(keep.mean().item() - p) < 4 * (p * rate / n) ** 0.5
    per_bh = keep.mean(dim=(2, 3))
    n_bh = shape[2] * shape[3]
    assert (per_bh - p).abs().max().item() < 4 * (p * rate / n_bh) ** 0.5
    # two independent masks disagree on a pair with probability 2 p rate
    other = tattn.dropout_keep_mask(1235, shape, rate, "cpu").double()
    differ = 2 * p * rate
    assert abs((keep != other).double().mean().item() - differ) < (
        4 * (differ * (1 - differ) / n) ** 0.5
    )


@pytest.mark.parametrize("causal", [False, True])
def test_flash_dropout_forward_equals_reference_with_the_same_mask(causal):
    """One dropout meaning on every route: the flash forward (plain
    version) with a seed equals mha_reference with the same seed."""
    b, h, s, d = 2, 2, 256, 32
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, b, h, s, s, d))
    mask = torch.from_numpy(_padding_mask(b, s, [256, 180]))
    out = tattn.flash_attention(q, k, v, mask=mask, causal=causal,
                                dropout_rate=0.1, dropout_seed=99)
    ref = tattn.mha_reference(q, k, v, mask=mask, causal=causal,
                              dropout_rate=0.1, dropout_seed=99)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    undropped = tattn.flash_attention(q, k, v, mask=mask, causal=causal)
    assert not np.allclose(out.numpy(), undropped.numpy(), atol=1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_dropout_gradient_equals_autograd_through_reference(causal):
    """The plain backward versions (dQ and dK/dV with the forward's mask
    regenerated from the seed) give the gradients that autograd gives
    through mha_reference with the same mask; float32, 1e-5."""
    b, h, s, d = 2, 2, 256, 32
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(7, b, h, s, s, d))
    mask = torch.from_numpy(_padding_mask(b, s, [256, 200]))
    dout = torch.from_numpy(
        np.random.default_rng(8).normal(size=(b, h, s, d)).astype(np.float32)
    )
    out = tattn.flash_attention(q, k, v, mask=mask, causal=causal,
                                dropout_rate=0.2, dropout_seed=5)
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = tattn.mha_reference(q, k, v, mask=mask, causal=causal,
                              dropout_rate=0.2, dropout_seed=5)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_attention_routes_dropout_to_the_flash_path():
    """The JAX rule sent dropout to its reference off the TPU; the port's
    mask is the same on every route, so attention() keeps dropout on the
    flash path (and has none without a seed, as the JAX path without an
    rng)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 1, 2, 256, 256, 64))
    out = tattn.attention(q, k, v, causal=True, dropout_rate=0.1,
                          dropout_seed=3)
    want = tattn.flash_attention(q, k, v, causal=True, dropout_rate=0.1,
                                 dropout_seed=3)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    no_seed = tattn.attention(q, k, v, causal=True, dropout_rate=0.1)
    np.testing.assert_array_equal(
        no_seed.numpy(), tattn.flash_attention(q, k, v, causal=True).numpy()
    )


# ---------------------------------------------------------------------------
# head dims the kernels are not compiled at: zero-padded to 64, 128 or 256
# ---------------------------------------------------------------------------
PAD_TOL = dict(atol=1e-6, rtol=1e-6)
# Widths whose padded and unpadded float32 products agree to PAD_TOL on any
# BLAS. Past them (d = 192 pads to 256) the two products' summation order
# can differ by a few float32 roundings (2.03e-6 absolute seen on one host),
# so there both are held to a float64 oracle instead: the padded result's
# max error may exceed the unpadded one's by at most PAD_SLACK ulps of the
# largest reference value.
PAD_TOL_WIDTHS = (8, 32, 48, 96, 130)
PAD_ORACLE_TOL = dict(atol=2e-5, rtol=2e-5)
PAD_SLACK = 4


def _attention64(q, k, v, kv_mask, dout, causal, scale, rate, seed):
    """out, lse, dQ, dK, dV of masked (dropout) attention in float64, the
    plain formulas written out here: the oracle the padded and unpadded
    float32 results are both held to."""
    q, k, v, dout = (t.double() for t in (q, k, v, dout))
    sq, sk = q.shape[2], k.shape[2]
    valid = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        valid = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + (sk - sq)
    valid = valid[None, None]
    if kv_mask is not None:
        valid = valid & (kv_mask != 0)[:, None, None, :]
    s = torch.where(valid, (q @ k.transpose(-1, -2)) * scale, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = torch.ones_like(p, dtype=torch.bool)
    if rate > 0.0:
        keep = tattn.dropout_keep_mask(seed, p.shape, rate, q.device)
    p = p / l
    p_drop = torch.where(keep, p / (1.0 - rate), 0.0)
    out = p_drop @ v
    lse = (m + torch.log(l))[..., 0]
    dp = torch.where(keep, (dout @ v.transpose(-1, -2)) / (1.0 - rate), 0.0)
    ds = p * (dp - (dout * out).sum(dim=-1, keepdim=True))
    return (out, lse, scale * ds @ k, scale * ds.transpose(-1, -2) @ q,
            p_drop.transpose(-1, -2) @ dout)


@pytest.mark.parametrize("d", [8, 32, 48, 96, 130, 192])
@pytest.mark.parametrize("causal,masked,rate", [
    (True, False, 0.0), (False, True, 0.0), (True, True, 0.2),
])
def test_pad_head_dim_around_plain_equals_unpadded(d, causal, masked, rate):
    """``pad_head_dim`` (what the CUDA wrappers run the kernels through at
    d < 64, 64 < d < 128 and 128 < d < 256) around the plain forward, dQ
    and dK/dV equals the unpadded plain functions up to rounding: out, lse
    and the three gradients, with the caller's sm_scale = 1/sqrt(d). The
    padded columns add exact zeros; only the summation's blocking may
    differ. So both float32 results are held to a float64 oracle, and the
    padded one may be no further from it than the unpadded one (up to
    ``PAD_SLACK`` ulps); at the widths of ``PAD_TOL_WIDTHS`` the two also
    agree to 1e-6 directly."""
    b, h, s = 2, 2, 96
    q, k, v = (torch.from_numpy(x) for x in _qkv(20 + d, b, h, s, s, d))
    dout = torch.from_numpy(np.random.default_rng(d).normal(
        size=(b, h, s, d)).astype(np.float32))
    kv_mask = None
    if masked:
        kv_mask = torch.from_numpy(
            (np.arange(s)[None, :] < np.array([[s], [40]])).astype(np.int32))
    scale = 1.0 / np.sqrt(d)
    drop = dict(dropout_rate=rate, dropout_seed=3)
    out, lse = tattn.pad_head_dim(tattn.flash_fwd_plain, q, k, v, kv_mask,
                                  causal, sm_scale=scale, **drop)
    want_out, want_lse = tattn.flash_fwd_plain(q, k, v, kv_mask, causal,
                                               scale, **drop)
    assert out.shape == (b, h, s, d) and lse.shape == (b, h, s)
    delta = (dout * want_out).sum(dim=-1)
    bargs = (kv_mask, dout, want_lse, delta, causal)
    dq = tattn.pad_head_dim(tattn.flash_bwd_dq_plain, q, k, v, *bargs,
                            sm_scale=scale, **drop)
    dk, dv = tattn.pad_head_dim(tattn.flash_bwd_dkv_plain, q, k, v, *bargs,
                                sm_scale=scale, **drop)
    want = (tattn.flash_bwd_dq_plain(q, k, v, *bargs, scale, **drop),
            *tattn.flash_bwd_dkv_plain(q, k, v, *bargs, scale, **drop))
    oracle = _attention64(q, k, v, kv_mask, dout, causal, scale, rate, 3)
    for got, ref, exact in zip((out, lse, dq, dk, dv),
                               (want_out, want_lse, *want), oracle):
        assert got.shape == ref.shape
        exact = exact.numpy()
        np.testing.assert_allclose(ref.numpy(), exact, **PAD_ORACLE_TOL)
        np.testing.assert_allclose(got.numpy(), exact, **PAD_ORACLE_TOL)
        err_pad = np.abs(got.numpy() - exact).max()
        err_plain = np.abs(ref.numpy() - exact).max()
        ulp = np.finfo(np.float32).eps * np.abs(exact).max()
        assert err_pad <= err_plain + PAD_SLACK * ulp, (err_pad, err_plain)
        if d in PAD_TOL_WIDTHS:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), **PAD_TOL)


def test_kernel_head_dim_widths():
    assert [tattn.kernel_head_dim(d)
            for d in (8, 32, 64, 80, 128, 129, 160, 192, 256)] == [
        64, 64, 64, 128, 128, 256, 256, 256, 256]
    with pytest.raises(ValueError, match="head_dim"):
        tattn.kernel_head_dim(257)


def test_flash_route_table():
    """bfloat16/float16 run the tensor-core (wgmma + TMA) forward, dQ and
    dK/dV at every compiled width; only the float32 kernels run on the FMA
    units."""
    table = {
        (dtype, d, kernel): tattn.flash_route(dtype, d, kernel)
        for dtype in (torch.float32, torch.bfloat16, torch.float16)
        for d in tattn.FLASH_HEAD_DIMS
        for kernel in ("fwd", "dq", "dkv")
    }
    fma = {key for key, route in table.items() if route == "fma"}
    assert fma == {(torch.float32, d, k) for d in (64, 128, 256)
                   for k in ("fwd", "dq", "dkv")}
    assert set(table.values()) == {"fma", "wgmma"}
    with pytest.raises(ValueError, match="head dim"):
        tattn.flash_route(torch.bfloat16, 192, "fwd")
    with pytest.raises(ValueError, match="kernel"):
        tattn.flash_route(torch.bfloat16, 256, "bwd")


@pytest.mark.parametrize("causal,with_mask", [(True, False), (False, True)])
def test_head_dim_32_matches_jax_kernel(causal, with_mask):
    """A GPT-2 with 768 over 24 heads has head dim 32. The JAX flash kernel
    (interpret mode) and reference against the port: its flash_attention
    on CPU tensors, and the padded path the CUDA wrappers take
    (``pad_head_dim`` around the plain forward). float32, 1e-5."""
    b, h, s, d = 2, 2, 256, 32
    q, k, v = _qkv(30, b, h, s, s, d)
    mask = _padding_mask(b, s, [200, 150]) if with_mask else None
    jmask = None if mask is None else jnp.asarray(mask)
    o_jax = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jmask,
        causal=causal))
    o_ref = np.asarray(jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jmask,
        causal=causal))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    o_port = tattn.flash_attention(*args, mask=tmask, causal=causal).numpy()
    o_pad, _ = tattn.pad_head_dim(
        tattn.flash_fwd_plain, *args, tattn.additive_mask_to_kv_valid(tmask),
        causal, sm_scale=1.0 / np.sqrt(d))
    for got in (o_port, o_pad.numpy()):
        np.testing.assert_allclose(got, o_jax, **TOL)
        np.testing.assert_allclose(got, o_ref, **TOL)


def test_initialize_refuses_a_head_dim_the_flash_kernels_cannot_take():
    """On a CUDA device, initialize() refuses a model whose head dim is
    above 256 once its n_positions reaches FLASH_MIN_SEQ, when the engine
    is built (no GPU needed: the decision comes before the device). Head
    dims 32 and 129-256 are accepted, and CPU engines take any head dim."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.config import DeepSpeedConfigError
    from deepspeed_tpu_torch.ops.head_dims import check_head_dim

    cfg = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}

    def model(n_embd, n_head, n_positions=256):
        return GPT2LMHeadModel(GPT2Config(
            vocab_size=64, n_positions=n_positions, n_embd=n_embd,
            n_layer=1, n_head=n_head), device="cpu")

    with pytest.raises(DeepSpeedConfigError, match="head dim 320"):
        deepspeed_tpu_torch.initialize(model=model(640, 2), config_params=cfg,
                                       device="cuda")
    with pytest.raises(DeepSpeedConfigError, match="up to 256"):
        check_head_dim(257, 256, "cuda")
    check_head_dim(320, 255, "cuda")  # attention never reaches the kernels
    check_head_dim(32, 1024, "cuda")
    check_head_dim(32, 1024, None)
    check_head_dim(320, 1024, "cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model(640, 2), config_params=cfg, device="cpu")
    assert engine.device.type == "cpu"


@pytest.mark.parametrize("head_dim", [129, 160, 192, 255, 256])
def test_check_head_dim_takes_129_to_256_on_cuda(head_dim):
    """The D = 256 kernels take head dims 129-256 on the card: no refusal
    on a CUDA device argument at any n_positions, and 257 still refused."""
    from deepspeed_tpu_torch.config import DeepSpeedConfigError
    from deepspeed_tpu_torch.ops.head_dims import check_head_dim

    for n_positions in (256, 1024, 4096):
        check_head_dim(head_dim, n_positions, "cuda")
        check_head_dim(head_dim, n_positions, None)
    with pytest.raises(DeepSpeedConfigError, match="head dim 257"):
        check_head_dim(257, 1024, "cuda")


def _check_head_dim_vs_jax(d, causal, with_mask):
    """The JAX flash kernel (interpret mode) against the port's function on
    CPU tensors and the padded path the CUDA wrappers take (pad_head_dim),
    forward and the three gradients, at head dim ``d``. float32, 1e-5."""
    b, h, s = 1, 2, 256
    q, k, v = _qkv(40 + d, b, h, s, s, d)
    mask = _padding_mask(b, s, [200]) if with_mask else None
    jmask = None if mask is None else jnp.asarray(mask)
    o_jax = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jmask,
        causal=causal))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    kv = tattn.additive_mask_to_kv_valid(tmask)
    o_pad, lse = tattn.pad_head_dim(tattn.flash_fwd_plain, *args, kv, causal,
                                    sm_scale=1.0 / np.sqrt(d))
    assert o_pad.shape == (b, h, s, d)
    np.testing.assert_allclose(o_pad.numpy(), o_jax, **TOL)
    np.testing.assert_allclose(
        tattn.flash_attention(*args, mask=tmask, causal=causal).numpy(),
        o_jax, **TOL)
    dout = torch.from_numpy(np.random.default_rng(d).normal(
        size=(b, h, s, d)).astype(np.float32))
    delta = (dout * o_pad).sum(dim=-1)
    bargs = (kv, dout, lse, delta, causal)
    dq = tattn.pad_head_dim(tattn.flash_bwd_dq_plain, *args, *bargs,
                            sm_scale=1.0 / np.sqrt(d))
    dk, dv = tattn.pad_head_dim(tattn.flash_bwd_dkv_plain, *args, *bargs,
                                sm_scale=1.0 / np.sqrt(d))

    def jloss(q_, k_, v_):
        o = jattn.flash_attention(q_, k_, v_, mask=jmask, causal=causal)
        return jnp.sum(o * jnp.asarray(dout.numpy()))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("d", [160, 192, 256])
@pytest.mark.parametrize("causal,with_mask", [(True, False), (False, True)])
def test_head_dims_above_128_match_jax_kernel(d, causal, with_mask):
    """Head dims the card runs at D = 256, and 256 itself (the kernels' own
    width, where pad_head_dim pads nothing)."""
    _check_head_dim_vs_jax(d, causal, with_mask)


@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("causal,with_mask", [(True, False), (False, True)])
def test_head_dims_65_to_128_match_jax_kernel(d, causal, with_mask):
    """Head dims the card runs at D = 128 (the tensor-core forward in a
    256-thread block), and 128 itself, where pad_head_dim pads
    nothing."""
    _check_head_dim_vs_jax(d, causal, with_mask)
