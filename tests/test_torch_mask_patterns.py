"""Port parity under the padding-mask patterns that the tensor-core
kernels sort into empty, full and mixed key tiles (csrc/key_tiles.cuh):
valid lengths at the 64-key tiles' edges, left padding, a hole in the
middle of a row, and a row with no valid key.

The same numpy inputs go through the JAX package's flash kernels (Pallas,
interpret mode on the CPU, 64-wide blocks) and through the port's
``flash_attention`` on CPU tensors (the plain versions of its three
kernels): the output, and dQ, dK and dV by ``jax.grad`` and autograd.
float32, atol = rtol = 1e-5 (tests/test_torch_attention.py's tolerance:
the same softmax, summed in another order). The CUDA kernels are held to
the plain versions under the same patterns on the card
(tests/test_torch_cuda_kernels.py -k mask).
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
S = 192
LENGTHS = (63, 64, 65, 127, 128, 129)


def pattern_mask(pattern):
    """A [6, S] int32 key mask."""
    mask = np.zeros((len(LENGTHS), S), np.int32)
    for row, n in enumerate(LENGTHS):
        if pattern == "edges":
            mask[row, :n] = 1
        elif pattern == "left":
            mask[row, S - n:] = 1
        elif pattern == "hole":
            mask[row] = 1
            mask[row, n // 2:n // 2 + 64] = 0
        elif pattern == "dead":
            mask[row, :n] = 0 if row == 2 else 1
    return mask


@pytest.mark.parametrize("pattern", ["edges", "left", "hole", "dead"])
@pytest.mark.parametrize("causal", [False, True])
def test_mask_patterns_match_jax_kernels(pattern, causal):
    b, h, d = len(LENGTHS), 1, 32
    rng = np.random.default_rng(7)
    q, k, v, dout = (rng.normal(size=(b, h, S, d)).astype(np.float32)
                     for _ in range(4))
    mask = pattern_mask(pattern)

    def jax_out(q, k, v):
        return jattn.flash_attention(q, k, v, kv_mask=jnp.asarray(mask),
                                     causal=causal, block_q=64, block_k=64)

    want_out = jax_out(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_out(q, k, v) * jnp.asarray(dout)),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(qt, kt, vt, kv_mask=torch.from_numpy(mask),
                                causal=causal)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # masked keys' gradients, and a dead row's everything, exact zeros
    dead_keys = np.broadcast_to((mask == 0)[:, None, :, None], q.shape)
    for g in got[1:]:
        assert not g.numpy()[dead_keys].any()
    if pattern == "dead":
        assert not out.detach().numpy()[2].any() and not got[0].numpy()[2].any()
