"""Port parity for the optimizer-state storage of ops/quant.py: blockwise
int8 quantization and the compensated masters' encode/decode, each
against the JAX package's function on the same numpy inputs.

Tolerance: none. The codes, scales, rounded parameters and decoded
values must equal the JAX package's bit for bit: every step is one
float32 operation per element (the absmax, a division, a multiply, a
round to nearest even, a clamp) in the same order in both packages.
Decoded masters are compared on float32-normal values: XLA's CPU backend
flushes float32 subnormals in arithmetic (1e-40 decodes to 0 there), a
property of that backend, not of the function.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops import quant as jq
from deepspeed_tpu_torch.ops import quant as tq
from torch_test_env import jax_compile_cache  # noqa: F401

FP16_MIN_NORMAL = 2.0 ** -14


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _values(seed, n, scale):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * scale
            * rng.uniform(0.0, 3.0, size=n)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2048, 9216, 10_000])
@pytest.mark.parametrize("scale", [1e-6, 1.0, 300.0])
def test_quantize_and_dequantize_match_jax(n, scale):
    """Whole blocks, a padded tail (9216 = 4.5 blocks, 10 000) and one
    element, at three magnitudes."""
    x = _values(n, n, scale)
    jl = jq.quantize(jnp.asarray(x))
    tl = tq.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tl["q"].numpy(), np.asarray(jl["q"]))
    np.testing.assert_array_equal(_bits(tl["scale"].numpy()),
                                  _bits(jl["scale"]))
    nb = -(-n // tq.BLOCK)
    assert tl["q"].shape == (nb * tq.BLOCK,) and tl["scale"].shape == (nb,)
    np.testing.assert_array_equal(
        _bits(tq.dequantize(tl, (n,)).numpy()),
        _bits(jq.dequantize(jl, (n,))))
    # the padded tail encodes and decodes to zero
    assert not tl["q"][n:].any()


def test_zero_blocks_and_pinned_block_count_match_jax():
    """An all-zero block has scale 0 and decodes to 0; ``nb`` pins a
    larger (padded) block count, as a re-encode of stored state does."""
    x = _values(3, 3 * tq.BLOCK, 1.0)
    x[tq.BLOCK:2 * tq.BLOCK] = 0.0
    jl = jq.quantize(jnp.asarray(x), nb=5)
    tl = tq.quantize(torch.from_numpy(x), nb=5)
    np.testing.assert_array_equal(tl["q"].numpy(), np.asarray(jl["q"]))
    np.testing.assert_array_equal(_bits(tl["scale"].numpy()),
                                  _bits(jl["scale"]))
    assert float(tl["scale"][1]) == 0.0 and not tl["q"][tq.BLOCK:2 * tq.BLOCK].any()
    assert tl["scale"].shape == (5,) and not tl["scale"][3:].any()
    back = tq.dequantize(tl, x.shape)
    assert not back[tq.BLOCK:2 * tq.BLOCK].any()


def test_quantize_into_keeps_the_storage():
    leaf = tq.quantized_zeros_like(torch.zeros(5000))
    q_ptr, s_ptr = leaf["q"].data_ptr(), leaf["scale"].data_ptr()
    x = torch.from_numpy(_values(4, 5000, 2.0))
    tq.quantize_into(leaf, x)
    want = tq.quantize(x, nb=3)
    assert leaf["q"].data_ptr() == q_ptr and leaf["scale"].data_ptr() == s_ptr
    assert torch.equal(leaf["q"], want["q"])
    assert torch.equal(leaf["scale"], want["scale"])


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_moment_storage_matches_jax(state_dtype):
    """moments_zeros_like's dtypes and shapes (int8: blockwise first
    moment, bf16 second), and encode/decode of a value through each."""
    shapes = {"a": (3, 700), "b": (5,)}
    jp = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    tp = {k: torch.zeros(s) for k, s in shapes.items()}
    for role in ("mu", "nu"):
        jm = jq.moments_zeros_like(jp, state_dtype, role)
        tm = tq.moments_zeros_like(tp, state_dtype, role)
        for k in shapes:
            if jq.is_quantized(jm[k]):
                assert tq.is_quantized(tm[k])
                assert tm[k]["q"].shape == jm[k]["q"].shape
                assert tm[k]["scale"].shape == jm[k]["scale"].shape
            else:
                assert str(tm[k].dtype)[6:] == str(jm[k].dtype)
                assert tuple(tm[k].shape) == jm[k].shape
            x = _values(7, int(np.prod(shapes[k])), 1e-2).reshape(shapes[k])
            je = jq.encode_moment(jnp.asarray(x), jm[k])
            te = tq.encode_moment(torch.from_numpy(x), tm[k])
            np.testing.assert_array_equal(
                _bits(tq.decode_moment(te, shapes[k]).numpy()),
                _bits(jq.decode_moment(je, shapes[k])))


def _across_the_fp16_edge():
    """Values around float16's smallest normal 2**-14: subnormals, the
    band [2**-14 - 2**-25, 2**-14 - 2**-26) where ``.half()`` rounds up to
    the normal and XLA's reduce_precision flushes, the edge itself, the
    values from the trap table (1e-6, 6.0976e-5), overflow (65520 rounds
    to inf) and random values of both signs."""
    e = FP16_MIN_NORMAL
    edge = [1e-6, 6.0976e-5, e, e * (1 - 2**-11), e - 2**-25, e - 2**-26,
            e - 3 * 2**-27, e - 2**-24, e + 2**-24, 2**-24, 2**-25,
            65504.0, 65519.0, 65520.0, 1e5, 0.0, -0.0]
    rng = np.random.default_rng(11)
    random = np.concatenate([rng.normal(size=4000) * 1e-4,
                             rng.normal(size=4000) * e * 3,
                             rng.normal(size=4000)])
    vals = np.concatenate([edge, -np.asarray(edge), random])
    return vals.astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_encode_master_matches_jax_across_the_subnormal_edge(dtype):
    """The rounded parameters and the int8 codes equal JAX's bit for bit;
    in float16 every value below 2**-14 in magnitude (after rounding)
    becomes a zero of its sign, where ``.half()`` would keep a
    subnormal."""
    vals = _across_the_fp16_edge()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pj, cj = jq.encode_master(jnp.asarray(vals), jdt)
    pt, ct = tq.encode_master(torch.from_numpy(vals), tdt)
    assert pt.dtype == tdt and ct.dtype == torch.int8
    np.testing.assert_array_equal(_bits(pt.float().numpy()),
                                  _bits(pj.astype(jnp.float32)))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    finite = np.isfinite(np.asarray(pj.astype(jnp.float32)))
    np.testing.assert_array_equal(
        _bits(tq.decode_master(pt, ct).numpy()[finite]),
        _bits(np.asarray(jq.decode_master(pj, cj))[finite]))
    if dtype == "float16":
        got = pt.float()
        flushed = got.abs() < FP16_MIN_NORMAL
        assert (got[flushed] == 0).all()
        # the band where .half() keeps 2**-14 and reduce_precision flushes
        band = torch.tensor([FP16_MIN_NORMAL - 2**-25])
        assert tq.encode_master(band, torch.float16)[0].item() == 0.0
        assert band.half().item() == FP16_MIN_NORMAL
        neg = tq.encode_master(torch.tensor([-1e-6]), torch.float16)[0]
        assert torch.signbit(neg.float()).item() and neg.item() == 0.0


def test_compensation_round_trip_bound():
    """The JAX package's property: after compensation the decoded master
    lies within ulp/200 of the float32 value (one code step is ulp/127)."""
    m = torch.from_numpy(_values(1, 4096, 1.0))
    p, code = tq.encode_master(m, torch.bfloat16)
    err = (tq.decode_master(p, code) - m).abs()
    ulp = m.abs() * 2**-8
    assert float((err / ulp.clamp(min=1e-30)).max()) < 1.0 / 200
    assert int((code != 0).sum()) > 3000
