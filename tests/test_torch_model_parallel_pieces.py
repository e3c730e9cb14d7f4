"""The pieces of tensor parallelism, each against its JAX counterpart or
its whole-tensor form.

- ``partition_specs`` covers every parameter of the port's GPT-2 (LoRA
  factors too) and equals the JAX package's specs name for name, mapped
  onto the port's names and orientation (``torch_mp_gpt2.
  specs_from_jax``), as tests/unit/test_models.py:146 checks the JAX
  tree's;
- the strided qkv slice: each rank holds its own heads of q, of k and of
  v, and joining the shards (what the checkpoints do) gives the tensor
  back, for every sharded parameter;
- ``params_from_jax(tree, specs, rank, mp)`` gives exactly the shards the
  engine cuts;
- the ZeRO spec composition: the data axis lands only on a dim the model
  axis left free, on tests/unit/test_zero3.py:68's cases;
- the sharded attention at dp 4 x mp 2 (tests/unit/test_attention_
  sharded.py's shapes): every shard's attention as the block calls it
  (the dispatcher, routed to the flash kernels, with the shard's seed
  from ``DropoutRNG``), put together, equals the reference (plain and
  causal, with a key mask, and the gradients); heads that do not divide
  the model axis are refused when the engine is built;
- on a model line of 2 gloo ranks: the vocab-parallel loss equals
  ``cross_entropy_ignore_index`` over the whole logits plane, and so do
  its gradients (the hidden states' whole, the table's by rows); the
  gathered eval logits are the whole plane; and ``partition_activations``
  keeps 1/mp of a checkpointed segment's inputs with the numbers of the
  unpartitioned recompute.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
import torch_dp_gpt2 as g
import torch_dp_ranks as ranks
from torch_mp_gpt2 import specs_from_jax
from deepspeed_tpu.models.gpt2 import partition_specs as jpartition_specs
from deepspeed_tpu.runtime import zero as jzero
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops.cross_entropy import cross_entropy_ignore_index
from deepspeed_tpu_torch.ops.transformer import DropoutRNG
from deepspeed_tpu_torch.parallel import tensor as tpl
from deepspeed_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    MeshTopology,
    ProcessMesh,
)
from deepspeed_tpu_torch.runtime import zero as tzero
from torch_test_env import jax_compile_cache  # noqa: F401

jattn = importlib.import_module("deepspeed_tpu.ops.attention")
jlora = importlib.import_module("deepspeed_tpu.adapters.lora")

MP = 2
TOL = dict(rtol=2e-4, atol=1e-5)
ATTN_TOL = dict(rtol=0, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


# ---------------------------------------------------------------------------
# the specs and the shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lora", [False, True])
def test_partition_specs_equal_the_jax_trees_name_for_name(lora):
    _, params = g.jmodel()
    params = jax.device_get(params)
    model = dst.GPT2LMHeadModel(dst.GPT2Config(
        vocab_size=ranks.VOCAB, n_positions=ranks.SEQ, n_embd=64,
        n_layer=2, n_head=4, lora_rank=4 if lora else 0), device="cpu")
    if lora:
        params = jlora.merge_lora_params(
            jax.tree_util.tree_map(np.asarray, params),
            jax.device_get(jlora.init_lora_params(
                params, 4, rng=jax.random.PRNGKey(0))))
    want = specs_from_jax(jpartition_specs(params), params)
    got = dst.partition_specs(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    assert set(got) == set(want)
    for n, spec in got.items():
        assert len(spec) == dict(model.named_parameters())[n].dim(), n
        assert _strip(spec) == _strip(want[n]), n
    sharded = [n for n, s in got.items() if tpl.model_dim(s) is not None]
    # the big projections, their column biases and wte (and LoRA factors)
    assert len(sharded) == 1 + 2 * 6 + (2 * 4 if lora else 0)


def test_the_strided_qkv_slice_gives_each_rank_its_heads():
    h, heads, hd = 64, 4, 16
    w = torch.arange(3 * h * h, dtype=torch.float32).reshape(3 * h, h)
    for rank in range(MP):
        got = tpl.shard_for_rank("h.0.attn_qkvw", w, 0, MP, rank)
        local = heads // MP * hd
        for part in range(3):  # q, k, v
            want = w[part * h + rank * local: part * h + (rank + 1) * local]
            assert torch.equal(got[part * local:(part + 1) * local], want)
    b = torch.arange(4 * 3 * h, dtype=torch.float32).reshape(4, 3 * h)
    got = tpl.shard_for_rank("h.1.attn_qkvw_lora_b", b, 1, MP, 1)
    assert torch.equal(got[:, :h // MP], b[:, h // MP:h])


def test_joining_the_shards_inverts_the_cut_for_every_parameter():
    _, params = g.jmodel()
    full = dst.params_from_jax(jax.device_get(params))
    model = dst.GPT2LMHeadModel(dst.GPT2Config(
        vocab_size=ranks.VOCAB, n_positions=ranks.SEQ, n_embd=64,
        n_layer=2, n_head=4), device="cpu")
    specs = dst.partition_specs(model)
    for mp in (2, 4):
        shards = [dst.params_from_jax(jax.device_get(params), specs, r, mp)
                  for r in range(mp)]
        for n, t in full.items():
            d = tpl.model_dim(specs[n])
            pieces = [s[n] for s in shards]
            if d is None:
                assert all(torch.equal(p, t) for p in pieces)
                continue
            assert all(p.shape[d] * mp == t.shape[d] for p in pieces)
            assert torch.equal(tpl.join_shards(n, pieces, d), t), n
            # the engine's cut is the converter's
            for r in range(mp):
                assert torch.equal(tpl.shard_for_rank(n, t, d, mp, r),
                                   pieces[r])


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_zero_composes_with_the_model_axis_on_free_dims_only(dp):
    # tests/unit/test_zero3.py:68: column-parallel [H, 3H] with the model
    # axis on dim 1 -> data on dim 0; row-parallel [H, H] with model on
    # dim 0 -> data on dim 1. The port's tensors are the transposes (a
    # linear weight [out, in]); its rule picks the JAX dims
    jspec = jzero.zero_param_specs(
        {"w": jnp.zeros((16, 48))}, dp, stage=3,
        model_specs={"w": jax.sharding.PartitionSpec(None, "model")})["w"]
    assert tuple(jspec) == ("data", "model")
    col = tzero.zero_param_specs({"h.0.attn_qkvw": (48, 16)}, dp, 3,
                                 model_dims={"h.0.attn_qkvw": 0})
    assert col == {"h.0.attn_qkvw": 1}  # the JAX dim 0
    row = tzero.zero_param_specs({"h.0.attn_ow": (16, 16)}, dp, 3,
                                 model_dims={"h.0.attn_ow": 1})
    assert row == {"h.0.attn_ow": 0}  # the JAX dim 1
    # the whole rule for every GPT-2 tensor at dp x mp 2: never the
    # model dim, and the JAX package's free dim
    model = dst.GPT2LMHeadModel(dst.GPT2Config(
        vocab_size=ranks.VOCAB, n_positions=ranks.SEQ, n_embd=64,
        n_layer=2, n_head=4), device="cpu")
    specs = dst.partition_specs(model)
    dims = {n: tpl.model_dim(s) for n, s in specs.items()}
    shapes = {}
    for n, p in model.named_parameters():
        s = list(p.shape)
        if dims[n] is not None:
            s[dims[n]] //= MP
        shapes[n] = tuple(s)
    got = tzero.zero_param_specs(shapes, dp, 3, model_dims=dims)
    _, params = g.jmodel()
    jspecs = jzero.zero_param_specs(params, dp, 3,
                                    model_specs=jpartition_specs(params))
    want = specs_from_jax(jspecs, jax.device_get(params))
    for n, d in got.items():
        assert d is None or d != dims[n], n
        jd = [i for i, e in enumerate(want[n]) if e == "data"
              or (isinstance(e, tuple) and "data" in e)]
        if n.startswith("h."):
            if jd and d is not None:
                assert [d] == jd, n
        else:
            assert ([d] if d is not None else []) == jd, n


# ---------------------------------------------------------------------------
# attention on the rank's heads
# ---------------------------------------------------------------------------
def _qkv(b=8, h=4, s=256, d=64, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(np.array(jax.random.normal(k, (b, h, s, d)) * 0.5,
                          np.float32) for k in ks)


def _shard_attention(q, k, v, data_rank, model_rank, mask=None, **kw):
    """One (data, model) shard's attention as the block calls it: the
    dispatcher, which routes it to the flash kernels, with the attention
    seed the shard's ``DropoutRNG`` draws (ops/transformer.py)."""
    assert tattn.routes_to_flash(mask, q.shape[2], k.shape[2])
    seed = DropoutRNG(0, "cpu", data_rank=data_rank,
                      model_rank=model_rank).attn_seed()
    return tattn.attention(q, k, v, mask=mask, dropout_seed=seed, **kw)


def _sharded(q, k, v, dp=4, mp=MP, kv=None, **kw):
    """Every (data, model) shard's attention, put together."""
    b, h = q.shape[:2]
    out = torch.empty(q.shape)
    bl, hl = b // dp, h // mp
    for d in range(dp):
        for m in range(mp):
            rows, heads = slice(d * bl, (d + 1) * bl), slice(m * hl,
                                                             (m + 1) * hl)
            mask = None if kv is None else torch.where(
                kv[rows][:, None, None, :] > 0, 0.0, tattn.NEG_INF)
            out[rows, heads] = _shard_attention(
                *(torch.from_numpy(x[rows, heads].copy()) for x in (q, k, v)),
                d, m, mask=mask, **kw)
    return out


@pytest.mark.parametrize("mode", ["plain", "causal", "kv_mask"])
def test_sharded_flash_at_dp4_mp2_matches_the_reference(mode):
    q, k, v = _qkv(seed={"plain": 0, "causal": 1, "kv_mask": 2}[mode])
    b, _, s, _ = q.shape
    kw, mask, kv = {}, None, None
    if mode == "causal":
        kw["causal"] = True
    if mode == "kv_mask":
        kv_np = (np.arange(s)[None, :] < np.asarray([s, s // 2] * (b // 2))[
            :, None]).astype(np.int32)
        kv = torch.from_numpy(kv_np)
        mask = jnp.where(jnp.asarray(kv_np)[:, None, None, :] > 0, 0.0,
                         jattn.NEG_INF)
    got = _sharded(q, k, v, kv=kv, **kw).numpy()
    want = np.asarray(jattn.mha_reference(q, k, v, mask=mask, **kw))
    np.testing.assert_allclose(got, want, **ATTN_TOL)


def test_sharded_flash_gradients_at_dp4_mp2_match_the_reference():
    q, k, v = _qkv(b=4, h=2, s=256, d=64, seed=3)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    dp, mp = 4, 2
    total = 0.0
    for d in range(dp):
        for m in range(mp):
            loc = [t[d:d + 1, m:m + 1] for t in ts]
            out = _shard_attention(*loc, d, m)
            total = total + (out ** 2).sum()
    total.backward()
    want = jax.grad(lambda q, k, v: jnp.sum(
        jattn.mha_reference(q, k, v) ** 2), argnums=(0, 1, 2))(q, k, v)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL)


def test_heads_that_do_not_divide_the_model_axis_are_refused():
    # the JAX dispatcher falls back to XLA here (tests/unit/test_attention_
    # sharded.py:test_dispatcher_falls_back_when_heads_do_not_divide);
    # there is no Megatron split of 3 heads over 2 ranks, and the port
    # refuses it when the engine is built
    model = dst.GPT2LMHeadModel(dst.GPT2Config(
        vocab_size=ranks.VOCAB, n_positions=ranks.SEQ, n_embd=48,
        n_layer=1, n_head=3), device="cpu")
    mesh = ProcessMesh(MeshTopology(1, 1, 1, MP), 0,
                       {"pipe": 0, "data": 0, "sequence": 0, MODEL_AXIS: 0})
    with pytest.raises(DeepSpeedConfigError, match="3 attention heads"):
        dst.initialize(model=model, device="cpu", mesh=mesh,
                       param_specs=dst.partition_specs(model),
                       config_params={"train_batch_size": 2})


def test_the_shard_seed_offsets_match_the_jax_kernels():
    # deepspeed_tpu/ops/attention.py:633-638
    assert tattn.DATA_RANK_SEED_STRIDE == 7_368_787
    assert tattn.MODEL_RANK_SEED_STRIDE == 15_485_863
    assert tattn.shard_seed(5, 2, 1) == 5 + 2 * 7_368_787 + 15_485_863


# ---------------------------------------------------------------------------
# on a model line of 2 ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def line(tmp_path_factory):
    rng = np.random.default_rng(4)
    b, t, h, v = 2, 12, 16, 64
    labels = rng.integers(0, v, (b, t)).astype(np.int64)
    labels[0, 3] = -100
    labels[1, 7] = -1
    data = {"hidden": rng.normal(size=(b, t, h)).astype(np.float32),
            "table": (0.5 * rng.normal(size=(v, h))).astype(np.float32),
            "labels": labels,
            "x": rng.normal(size=(4, 8)).astype(np.float32),
            "w": (0.5 * rng.normal(size=(8, 6))).astype(np.float32)}
    d = tmp_path_factory.mktemp("mp_pieces")
    np.savez(d / "pieces.npz", **data)
    got = ranks.finish(ranks.start(MP, [
        {"name": "pieces", "kind": "mp_pieces", "data": "pieces.npz",
         "block_rows": 5}], d), timeout=120)
    return [r["pieces"] for r in got], data


def test_the_vocab_parallel_loss_equals_the_whole_planes(line):
    got, data = line
    h = torch.from_numpy(data["hidden"]).requires_grad_()
    table = torch.from_numpy(data["table"]).requires_grad_()
    loss = cross_entropy_ignore_index(h @ table.t(),
                                      torch.from_numpy(data["labels"]))
    loss.backward()
    rows = table.shape[0] // MP
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["loss"], loss.item(), rtol=1e-6)
        np.testing.assert_allclose(res["grad_hidden"], h.grad.numpy(),
                                   **GRAD_TOL)
        np.testing.assert_allclose(
            res["grad_table"], table.grad.numpy()[r * rows:(r + 1) * rows],
            **GRAD_TOL)
        np.testing.assert_allclose(
            res["logits"], (h @ table.t()).detach().numpy(), rtol=1e-6,
            atol=1e-6)


def test_partition_activations_keep_one_mp_th_with_the_same_numbers(line):
    got, data = line
    for res in got:
        off, on = res["partition"][False], res["partition"][True]
        for a, b in zip(off[:3], on[:3]):
            np.testing.assert_array_equal(a, b)
        # the unpartitioned segment keeps its inputs by reference (no
        # saved tensor); the partitioned one saves 1/mp of each
        assert on[3] == res["input_bytes"] // MP
    # the segment is one computation over the line: both ranks agree
    np.testing.assert_array_equal(got[0]["partition"][True][0],
                                  got[1]["partition"][True][0])
