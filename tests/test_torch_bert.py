"""Port parity for BERT (models/bert.py): ``BertForPreTraining`` and
``BertForQuestionAnswering`` against the JAX package's models on the same
weights (carried over with ``bert_params_from_jax``) and the same numpy
batches, at dropout 0 in float32, on both attention routes: seq 16 (the
plain reference in both packages) and seq 256 with padded rows (the
flash route: the JAX kernels in interpret mode with ``FLASH_MODE =
"always"`` on one device, the port's kernels' plain versions); then
``cross_entropy_ignore_index``, the LAMB groups' order, 3 engine windows
of Lamb against the JAX engine, and what the port refuses.

Tolerances: losses rtol 1e-5; gradients rtol 1e-4, atol 1e-6 (float32
through two post-LN layers, a masked softmax and the tied decoder,
summed in other orders; some true gradients are zero, the attention key
bias's and the last LayerNorm bias's under QA, where both packages carry
~1e-8 of rounding); the cross-entropy 1e-6; engine losses rtol 1e-5 and
LAMB trust ratios rtol 1e-5, as tests/test_torch_engine.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import (
    BertConfig,
    BertForPreTraining,
    BertForQuestionAnswering,
    bert_params_from_jax,
)
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops.cross_entropy import cross_entropy_ignore_index
from deepspeed_tpu_torch.ops.optimizers import param_groups
from torch_test_env import jax_compile_cache  # noqa: F401

jattn = importlib.import_module("deepspeed_tpu.ops.attention")

VOCAB = 100
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
CE_TOL = dict(rtol=1e-6, atol=1e-6)
COEFF_TOL = dict(rtol=1e-5, atol=0.0)
KINDS = {"pretraining": (jbert.BertForPreTraining, BertForPreTraining),
         "qa": (jbert.BertForQuestionAnswering, BertForQuestionAnswering)}


def _kw(seq, dropout=0.0):
    return dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=seq, hidden_dropout_prob=dropout,
                attention_probs_dropout_prob=dropout)


def _batch(kind, seq, b=3, seed=0):
    """ids, a padding mask of ragged lengths (one row full, one three
    quarters, one half plus one), segment ids, and the task's labels:
    15% masked-LM labels (the rest -100) and NSP labels, or start/end
    positions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, seq)).astype(np.int32)
    mask = np.zeros((b, seq), np.int32)
    for i, n in enumerate((seq, seq * 3 // 4, seq // 2 + 1)[:b]):
        mask[i, :n] = 1
    tt = np.broadcast_to((np.arange(seq) >= seq // 3).astype(np.int32),
                         (b, seq)).copy()
    if kind == "pretraining":
        labels = np.where(rng.random((b, seq)) < 0.15, ids, -100)
        labels[:, 0] = -1  # both ignore values
        return ids, mask, tt, labels.astype(np.int32), rng.integers(
            0, 2, (b,)).astype(np.int32)
    start = rng.integers(0, seq // 2, (b,)).astype(np.int32)
    return ids, mask, tt, start, start + 2


def _models(kind, seq, dropout=0.0):
    jcls, tcls = KINDS[kind]
    jmodel = jcls(jbert.BertConfig(**_kw(seq, dropout)))
    args = [jnp.asarray(a) for a in _batch(kind, seq)]
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, *args,
                         train=False)["params"]
    tmodel = tcls(BertConfig(**_kw(seq, dropout)), device="cpu")
    tmodel.load_state_dict(bert_params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("seq", [16, 256])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_loss_and_gradients_match_jax(kind, seq, monkeypatch):
    if seq >= jattn.FLASH_MIN_SEQ:
        # one device: the JAX dispatcher may take its kernels
        monkeypatch.setattr(jattn, "FLASH_MODE", "always")
        assert tattn.routes_to_flash(None, seq, seq)
    else:
        assert not tattn.routes_to_flash(None, seq, seq)
    jmodel, params, tmodel = _models(kind, seq)
    batch = _batch(kind, seq)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, *map(jnp.asarray, batch),
                               train=False))(params)
    tloss = tmodel(*(torch.from_numpy(a).long() for a in batch), train=False)
    names = [n for n, _ in tmodel.named_parameters()]
    grads = torch.autograd.grad(tloss, list(tmodel.parameters()),
                                allow_unused=True)
    want = bert_params_from_jax(jax.device_get(jgrads))
    assert set(want) == set(names)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    for n, g in zip(names, grads):
        if g is None:  # the pooler under QA: no path to the loss
            assert kind == "qa" and n.startswith("bert.pooler")
            g = torch.zeros_like(want[n])
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), err_msg=n,
                                   **GRAD_TOL)


@pytest.mark.parametrize("seq", [16, 256])
def test_qa_span_logits_match_jax(seq, monkeypatch):
    """Without positions the QA model returns (start, end) logits [B, S]."""
    if seq >= jattn.FLASH_MIN_SEQ:
        monkeypatch.setattr(jattn, "FLASH_MODE", "always")
    jmodel, params, tmodel = _models("qa", seq)
    ids, mask, tt, _, _ = _batch("qa", seq)
    js, je = jmodel.apply({"params": params}, jnp.asarray(ids),
                          jnp.asarray(mask), jnp.asarray(tt), train=False)
    with torch.no_grad():
        ts, te = tmodel(*(torch.from_numpy(a).long() for a in (ids, mask, tt)))
    assert ts.shape == (3, seq)
    for got, want in ((ts, js), (te, je)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_ignore_index_matches_jax(dtype):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 7, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 2:] = -100
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    want = jbert.cross_entropy_ignore_index(jl, jnp.asarray(labels))
    got = cross_entropy_ignore_index(tl, torch.from_numpy(labels).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **CE_TOL)
    # every label ignored: zero (the count is floored at one)
    none = np.full((2, 3), -100, np.int32)
    assert float(cross_entropy_ignore_index(
        tl[:2, :3], torch.from_numpy(none).long())) == 0.0 == float(
        jbert.cross_entropy_ignore_index(jl[:2, :3], jnp.asarray(none)))


def _jax_leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_lamb_groups_are_the_jax_leaves_in_order(kind):
    """The port's parameter groups, sorted by name, are the JAX tree's
    leaves in its (sorted) order: LAMB's per-group trust ratios line up."""
    _, params, tmodel = _models(kind, 16)
    groups = list(param_groups(dict(tmodel.named_parameters())))
    jax_leaves = ["/".join(p) for p in _jax_leaf_paths(
        jax.device_get(params))]
    assert len(groups) == len(jax_leaves)
    rename = {"layer.*.": "layer/", "LayerNorm.weight": "LayerNorm/scale",
              "transform_ln.weight": "transform_ln/scale"}
    for g, leaf in zip(groups, jax_leaves):
        name = g
        for a, b in rename.items():
            name = name.replace(a, b)
        name = name.replace(".weight", ".kernel").replace(".", "/")
        assert name == leaf, (g, leaf)


def _engine_config(optimizer="Lamb"):
    return {
        "train_batch_size": 6,
        "train_micro_batch_size_per_gpu": 3,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": optimizer,
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "gradient_clipping": 1.0,
        "steps_per_print": 1000,
    }


@pytest.mark.parametrize("kind,seq", [("pretraining", 16), ("qa", 256)])
def test_engine_windows_match_jax_engine(kind, seq, monkeypatch):
    """3 windows of 2 micro-batches through initialize() in both packages:
    losses and LAMB's trust ratios, one per JAX leaf."""
    if seq >= jattn.FLASH_MIN_SEQ:
        monkeypatch.setattr(jattn, "FLASH_MODE", "always")
    jmodel, params, tmodel = _models(kind, seq)
    cfg = _engine_config()
    jengine, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params, config_params=cfg,
        mesh=build_mesh(devices=jax.devices()[:1]))
    tengine, *_ = deepspeed_tpu_torch.initialize(
        model=tmodel, config_params=cfg, device="cpu")
    jl, tl = [], []
    for w in range(3):
        windows = [_batch(kind, seq, seed=10 * w + i) for i in range(2)]
        jl.append(float(jengine.train_batch(
            iter([tuple(map(jnp.asarray, b)) for b in windows]))))
        tl.append(float(tengine.train_batch(
            iter([tuple(torch.from_numpy(a).long() for a in b)
                  for b in windows]))))
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    want = np.asarray(jengine.lamb_coeffs)
    assert want.shape == (len(list(_jax_leaf_paths(params))),)
    np.testing.assert_allclose(tengine.lamb_coeffs.numpy(), want, **COEFF_TOL)
    assert tengine.global_steps == jengine.global_steps == 3


def test_dropout_trains_and_is_seeded():
    """At dropout 0.1 on the flash route (seq 256), a training forward
    differs from the eval forward, repeats for the same seed and differs
    for another: the masks come from the dropout seed."""
    _, _, tmodel = _models("pretraining", 256, dropout=0.1)
    batch = [torch.from_numpy(a).long() for a in _batch("pretraining", 256)]
    with torch.no_grad():
        ev = float(tmodel(*batch, train=False))
        a = float(tmodel(*batch, train=True, dropout_seed=5))
        b = float(tmodel(*batch, train=True, dropout_seed=5))
        c = float(tmodel(*batch, train=True, dropout_seed=6))
    assert a == b and a != c and a != ev


def test_presets_and_the_padded_vocab():
    large = BertConfig.bert_large()
    assert (large.hidden_size, large.num_hidden_layers,
            large.num_attention_heads, large.intermediate_size) == (
        1024, 24, 16, 4096)
    assert large.vocab_padded == 30592
    base = BertConfig.bert_base()
    assert (base.hidden_size, base.num_hidden_layers) == (768, 12)
    for field in ("vocab_size", "hidden_size", "intermediate_size",
                  "max_position_embeddings", "layer_norm_eps"):
        assert getattr(large, field) == getattr(
            jbert.BertConfig.bert_large(), field)


@pytest.mark.parametrize("field,value", [
    ("sparse_gradients", True), ("zero3_gather", object()),
    ("mesh", object()), ("lora_rank", 4),
])
def test_what_bert_refuses(field, value):
    cfg = BertConfig(**_kw(16))
    setattr(cfg, field, value)
    if field == "lora_rank":
        # taken since LoRA on BERT was ported: the blocks carry the JAX
        # model's factors, by name and shape
        jmodel = jbert.BertForPreTraining(jbert.BertConfig(
            **_kw(16), lora_rank=value))
        args = [jnp.asarray(a) for a in _batch("pretraining", 16)]
        params = jmodel.init({"params": jax.random.PRNGKey(0)}, *args,
                             train=False)["params"]
        want = {n: tuple(t.shape) for n, t in bert_params_from_jax(
            jax.device_get(params)).items() if "_lora_" in n}
        got = {n: tuple(p.shape) for n, p in BertForPreTraining(
            cfg, device="cpu").named_parameters() if "_lora_" in n}
        assert got == want and len(got) == 2 * 4 * 2
        return
    # the engine arms the three JAX fields itself
    match = {"sparse_gradients": "arms the word table's sparse gradient",
             "zero3_gather": "arms the encoder's gather itself",
             "mesh": "arms the sequence axis itself"}[field]
    with pytest.raises(DeepSpeedConfigError, match=match):
        BertForPreTraining(cfg, device="cpu")


def test_engine_refuses_an_adapters_block_and_a_wide_head_on_the_card():
    _, _, tmodel = _models("pretraining", 16)
    cfg = dict(_engine_config(), adapters={"enabled": True, "rank": 4})
    with pytest.raises(DeepSpeedConfigError, match="GPT-2 family"):
        deepspeed_tpu_torch.initialize(model=tmodel, config_params=cfg,
                                       device="cpu")
    wide = BertForPreTraining(BertConfig(**dict(
        _kw(512), hidden_size=1040, num_attention_heads=2,
        intermediate_size=64)), device="cpu")
    with pytest.raises(DeepSpeedConfigError, match="head dim 520"):
        deepspeed_tpu_torch.initialize(model=wide,
                                       config_params=_engine_config(),
                                       device="cuda")
