"""Port parity: deepspeed_tpu_torch.inference.sampling against the JAX
package on the same numpy logits. The filters are selections, not
arithmetic that rounds differently, so they must agree EXACTLY; greedy
``sample_tokens`` must give identical tokens. Sampled tokens come from a
``torch.Generator`` (the JAX package threads a PRNG key), so only their
support is checked.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu_torch.inference import sampling as tsamp
from torch_test_env import jax_compile_cache  # noqa: F401

jsamp = importlib.import_module("deepspeed_tpu.inference.sampling")

VOCAB = 97
PADDED = 128


def _logits(seed, rows=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, PADDED)) * 3.0).astype(np.float32)


def test_mask_padded_vocab_matches_jax_exactly():
    x = _logits(0)
    got = tsamp.mask_padded_vocab(torch.from_numpy(x), VOCAB).numpy()
    want = np.asarray(jsamp.mask_padded_vocab(jnp.asarray(x), VOCAB))
    np.testing.assert_array_equal(got, want)
    assert tsamp.mask_padded_vocab(torch.from_numpy(x), PADDED) is not None


@pytest.mark.parametrize("top_k", [1, 5, 40])
def test_top_k_matches_jax_exactly(top_k):
    x = _logits(1)
    got = tsamp._apply_top_k(torch.from_numpy(x), top_k).numpy()
    want = np.asarray(jsamp._apply_top_k(jnp.asarray(x), top_k))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9])
def test_top_p_matches_jax_exactly(top_p):
    x = _logits(2)
    got = tsamp._apply_top_p(torch.from_numpy(x), top_p).numpy()
    want = np.asarray(jsamp._apply_top_p(jnp.asarray(x), top_p))
    np.testing.assert_array_equal(got, want)


def test_greedy_sample_tokens_identical_to_jax():
    x = _logits(3)
    temps = np.zeros(x.shape[0], np.float32)
    got = tsamp.sample_tokens(
        torch.from_numpy(x), torch.Generator().manual_seed(0),
        torch.from_numpy(temps), vocab_size=VOCAB, top_k=5, top_p=0.9,
    )
    want = jsamp.sample_tokens(
        jnp.asarray(x), jax.random.PRNGKey(0), jnp.asarray(temps),
        vocab_size=VOCAB, top_k=5, top_p=0.9,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) < VOCAB  # padded columns never win


def test_sampled_rows_stay_in_top_k_and_greedy_rows_stay_greedy():
    x = _logits(4)
    temps = np.asarray([0.0, 1.0, 0.7, 0.0, 2.0, 1.0], np.float32)
    gen = torch.Generator().manual_seed(1)
    top = np.argsort(-np.where(np.arange(PADDED) < VOCAB, x, -np.inf), -1)
    for _ in range(20):
        got = tsamp.sample_tokens(
            torch.from_numpy(x), gen, torch.from_numpy(temps),
            vocab_size=VOCAB, top_k=3,
        ).numpy()
        for row, t in enumerate(got):
            if temps[row] > 0:
                assert t in top[row, :3]
            else:
                assert t == top[row, 0]
