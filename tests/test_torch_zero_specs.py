"""The port's ZeRO spec functions against deepspeed_tpu.runtime.zero.

runtime/zero.py returns ``{name: shard dim or None}`` where the JAX
package returns PartitionSpecs; on the same shapes they choose the same
dimension (the one the JAX spec names ``data``) at every stage, data
size and ``prefer_leading`` setting, over the shapes of
tests/unit/test_zero3.py:46-139 and tests/unit/test_zero_specs.py and a
GPT-2 block's. A port parameter ``[out, in]`` of a layer picks the same
tensor dimension as the JAX stacked leaf ``[L, in, out]`` whenever the
layer count is not the largest dim. Also: the flat int8 layout's block
ranges, the stage-3 accounting, and ``resolve_gather_block`` at every
divisor.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config import constants as JC
from deepspeed_tpu.models.stack import (
    resolve_gather_block as jax_resolve_gather_block,
)
from deepspeed_tpu.runtime import zero as jzero
from deepspeed_tpu_torch.models.stack import resolve_gather_block
from deepspeed_tpu_torch.ops import quant
from deepspeed_tpu_torch.runtime import zero
from torch_test_env import jax_compile_cache  # noqa: F401

SHAPES = {
    "odd": (3, 5), "ok": (8, 16), "col": (16, 48), "row": (16, 16),
    "w64": (16, 64), "bias": (10,), "vec": (64,), "scalar": (),
    "qkv": (192, 64), "ffn": (64, 256), "emb": (50304, 768),
    "wide": (6, 12, 20),
}


def _jax_dim(spec):
    dims = [i for i, e in enumerate(spec) if e == JC.DATA_AXIS]
    return dims[0] if dims else None


@pytest.mark.parametrize("prefer_leading", [False, True])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_spec_functions_choose_the_jax_dims(dp, stage, prefer_leading):
    params = {n: jnp.zeros(s, jnp.float32) for n, s in SHAPES.items()}
    for jfn, fn in ((jzero.zero_param_specs, zero.zero_param_specs),
                    (jzero.zero_grad_specs, zero.zero_grad_specs),
                    (jzero.zero_optstate_specs, zero.zero_optstate_specs)):
        want = jfn(params, dp, stage, prefer_leading=prefer_leading)
        got = fn(SHAPES, dp, stage, prefer_leading=prefer_leading)
        assert got == {n: _jax_dim(s) for n, s in want.items()}, fn.__name__


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_leaf_partition_spec_matches_jax(dp):
    for shape in SHAPES.values():
        for lead in (False, True):
            want = jzero.leaf_partition_spec(shape, dp, prefer_leading=lead)
            assert zero.leaf_partition_spec(shape, dp, lead) == _jax_dim(
                want), shape


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_stage3_undivisible_leaf_stays_replicated(dp):
    specs = zero.zero_param_specs({"odd": (3, 5), "ok": (8, 16)}, dp, 3)
    assert specs["odd"] is None and specs["ok"] is not None
    from deepspeed_tpu_torch.utils.logging import _warned_keys

    assert "zero3-replicated-leaves" in _warned_keys


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("tensor,port_shape,layers", [
    ("attn_qkvw", (192, 64), 2), ("attn_ow", (64, 64), 2),
    ("inter_w", (256, 64), 2), ("output_w", (64, 256), 2),
    ("attn_qkvb", (192,), 2), ("norm_w", (64,), 12),
])
def test_a_port_layer_tensor_shards_the_jax_leafs_dim(dp, tensor,
                                                      port_shape, layers):
    """The port's per-layer [out, in] tensor and the JAX stacked [L, in,
    out] leaf: the same tensor dimension by size (the layer count below
    the widths)."""
    jax_shape = (layers,) + tuple(reversed(port_shape))
    jdim = _jax_dim(jzero.leaf_partition_spec(jax_shape, dp))
    pdim = zero.zero_param_specs({f"h.0.{tensor}": port_shape}, dp, 3)[
        f"h.0.{tensor}"]
    # JAX dim j >= 1 of [L, in, out] is port dim (ndim - j) of [out, in]
    assert jdim >= 1 and pdim == len(port_shape) - jdim


def test_gathered_spec_strips_the_data_axis():
    assert zero.gathered_spec(0) is None and zero.gathered_spec(None) is None
    assert _jax_dim(jzero.gathered_spec(jzero.leaf_partition_spec(
        (8, 16), 2))) is None


@pytest.mark.parametrize("dp", [2, 4])
def test_shards_cover_the_tensor_in_order(dp):
    t = torch.arange(8 * 12 * 4, dtype=torch.float32).reshape(8, 12, 4)
    for dim in range(3):
        if t.shape[dim] % dp:
            continue
        parts = [zero.shard_of(t, dim, dp, r) for r in range(dp)]
        flat = torch.cat([p.reshape(-1) for p in parts])
        assert torch.equal(zero.from_chunks(flat, t.shape, dim), t)
        assert torch.equal(zero.to_chunks(t, dim).reshape(-1), flat)


@pytest.mark.parametrize("dp", [2, 4])
def test_flat_int8_groups_cut_jax_order_block_ranges(dp):
    """Stage >= 1 with int8 moments: one leaf per group, the group's
    tensors in JAX element order, padded to a multiple of max(256, dp)
    blocks, every rank one contiguous range of whole blocks."""
    shapes = {"h.0.attn_qkvw": (192, 64), "h.1.attn_qkvw": (192, 64),
              "wte": (256, 64)}
    full = {n: torch.randn(s) for n, s in shapes.items()}
    layouts = [zero.ZeroLayout(shapes, dp, r, None, 1, flat_groups=True)
               for r in range(dp)]
    leaf = layouts[0].leaves["h.*.attn_qkvw"]
    total = 2 * 192 * 64
    nb = -(-math.ceil(total / quant.BLOCK) // max(256, dp)) * max(256, dp)
    assert leaf.pad_to == nb * quant.BLOCK
    assert leaf.numel == nb * quant.BLOCK // dp
    assert leaf.numel % quant.BLOCK == 0
    want = torch.cat([full["h.0.attn_qkvw"].t().reshape(-1),
                      full["h.1.attn_qkvw"].t().reshape(-1)])
    got = torch.cat([lay.shard_leaves(full)["h.*.attn_qkvw"]
                     for lay in layouts])
    assert torch.equal(got[:total], want)
    assert not got[total:].any()


@pytest.mark.parametrize("dp", [2, 4])
def test_zero3_bytes_follow_the_jax_formula(dp):
    shapes = {"a": (64, 256), "b": (10,), "c": (48, 16)}
    lay = zero.ZeroLayout(shapes, dp, 0, None, 3)
    resident, gather = lay.zero3_bytes(2)
    want_res = want_gather = 0
    for n, s in shapes.items():
        nbytes = int(np.prod(s)) * 2
        if jzero.has_axis(jzero.leaf_partition_spec(s, dp)):
            want_res += nbytes // dp
            want_gather += 2 * (nbytes * (dp - 1) // dp)
        else:
            want_res += nbytes
    assert (resident, gather) == (want_res, want_gather)


@pytest.mark.parametrize("n_layer", [1, 2, 3, 4, 6, 12, 24])
def test_resolve_gather_block_at_every_request(n_layer):
    for requested in range(1, n_layer + 3):
        got = resolve_gather_block(n_layer, requested)
        assert got == jax_resolve_gather_block(n_layer, requested)
        assert n_layer % got == 0 and got <= max(1, requested)
    divisors = [d for d in range(1, n_layer + 1) if n_layer % d == 0]
    assert [resolve_gather_block(n_layer, d) for d in divisors] == divisors
