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

import jax.numpy as jnp

from deepspeed_tpu_torch.ops import attention as tattn

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


def test_dropout_is_refused_until_the_training_slice():
    q = torch.zeros(1, 1, 256, 64)
    with pytest.raises(NotImplementedError):
        tattn.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(NotImplementedError):
        tattn.attention(q, q, q, dropout_rate=0.1)
