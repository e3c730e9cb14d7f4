"""BERT's global loss across ranks, and dropout decorrelated by rank.

BERT's ``cross_entropy_ignore_index`` divides by the count of valid
labels, which differs between ranks on padded batches: the global
batch's loss is the sum of every rank's NLL over the data group's
count, not the mean of the ranks' means. Two gloo ranks run one
micro-step of BertForPreTraining (2 layers, width 64, seq 16) on their
rows of a global batch whose ranks hold 2 and 16 masked-LM labels and 1
and 2 next-sentence labels; the mean of their losses and the sum of
their gradients equal the JAX engine's loss and gradient buffer at
dp = 2 on the global batch (losses rtol 1e-5, gradients rtol 1e-4 atol
1e-6, as tests/test_torch_bert.py).

Dropout: two ranks given the same rows draw different masks (the data
rank offsets every dropout seed, as the JAX package's sharded flash
attention adds ``data_rank * 7_368_787``), and rank 0 draws what a
single process draws.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
import torch_dp_ranks as ranks
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import bert_params_from_jax
from deepspeed_tpu_torch.ops.transformer import (
    DATA_RANK_SEED_STRIDE,
    DropoutRNG,
)
from torch_test_env import jax_compile_cache  # noqa: F401

SEQ, MICRO, DP = 16, 2, 2
BERT = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=SEQ, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _batch():
    """4 rows: rank 0's two with one masked-LM label each, rank 1's with
    eight; rank 0 has one NSP label ignored (-1)."""
    rng = np.random.default_rng(0)
    b = MICRO * DP
    ids = rng.integers(0, 100, (b, SEQ)).astype(np.int32)
    mask = np.ones((b, SEQ), np.int32)
    mask[1, 10:] = 0
    mask[3, 12:] = 0
    types = np.zeros((b, SEQ), np.int32)
    types[:, SEQ // 2:] = 1
    mlm = np.full((b, SEQ), -100, np.int32)
    for row, n in ((0, 1), (1, 1), (2, 8), (3, 8)):
        pos = rng.choice(np.arange(1, 10), n, replace=False)
        mlm[row, pos] = ids[row, pos]
    nsp = np.array([-1, 1, 0, 1], np.int32)
    return dict(ids=ids, mask=mask, types=types, mlm=mlm, nsp=nsp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("bert")
    batch = _batch()
    np.savez(work / "batch.npz", **batch)
    jmodel = jbert.BertForPreTraining(jbert.BertConfig(**BERT))
    args = [jnp.asarray(batch[k]) for k in ("ids", "mask", "types", "mlm",
                                             "nsp")]
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, *args,
                         train=False)["params"]
    torch.save(bert_params_from_jax(jax.device_get(params)),
               work / "bert.pt")
    gpt2 = deepspeed_tpu_torch.GPT2LMHeadModel(deepspeed_tpu_torch.GPT2Config(
        vocab_size=ranks.VOCAB, n_positions=ranks.SEQ, n_embd=64, n_layer=2,
        n_head=4, dropout=0.1), device="cpu")
    torch.save(gpt2.state_dict(), work / "gpt2.pt")
    cases = [{"name": "bert", "kind": "bert", "model": "bert",
              "bert": BERT, "weights": "bert.pt", "batch": "batch.npz",
              "micro": MICRO},
             {"name": "dropout", "kind": "dropout", "model": "gpt2",
              "dropout": 0.1, "weights": "gpt2.pt"}]
    handle = ranks.start(DP, cases, work)
    cfg = ranks.config(0, "Adam", "fp32", MICRO, 1, DP)
    jengine, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params, config_params=cfg,
        mesh=build_mesh(devices=jax.devices()[:DP]))
    jloss = jengine(*args)
    jengine.backward(jloss)
    want = (float(jloss),
            {n: t.numpy() for n, t in bert_params_from_jax(
                jax.device_get(jengine._grad_buffer)).items()})
    return ranks.finish(handle, timeout=120), want, work


def test_unequal_label_counts_give_the_global_loss(runs):
    port, (jloss, _), _ = runs
    counts = [(_batch()["mlm"][r * MICRO:(r + 1) * MICRO] >= 0).sum()
              for r in range(DP)]
    assert counts == [2, 16]
    for r in port:
        np.testing.assert_allclose(r["bert"]["loss"], jloss, **LOSS_TOL)


def test_summed_gradients_equal_the_jax_global_gradient(runs):
    port, (_, jgrads), _ = runs
    got = port[0]["bert"]["grads"]
    assert set(got) == set(jgrads)
    for n, want in jgrads.items():
        np.testing.assert_allclose(got[n], want, err_msg=n, **GRAD_TOL)


def test_two_ranks_with_the_same_rows_draw_different_masks(runs):
    port, _, work = runs
    losses = [r["dropout"]["loss"] for r in port]
    assert losses[0] != losses[1]
    # rank 0 draws what a single process draws from the same seed
    model = deepspeed_tpu_torch.GPT2LMHeadModel(
        deepspeed_tpu_torch.GPT2Config(
            vocab_size=ranks.VOCAB, n_positions=ranks.SEQ, n_embd=64,
            n_layer=2, n_head=4, dropout=0.1), device="cpu")
    model.load_state_dict(torch.load(work / "gpt2.pt", weights_only=True))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config_params=ranks.config(0, "Adam", "fp32", 2, 1, 1))
    ids = torch.from_numpy(ranks.windows("gpt2", 1, 1, 2)[0][0][0]).long()
    assert float(engine(ids, ids).detach()) == losses[0]


@pytest.mark.parametrize("rank", [1, 3])
def test_the_rank_offsets_every_dropout_seed(rank):
    base, mine = DropoutRNG(1234, "cpu"), DropoutRNG(1234, "cpu", rank)
    for _ in range(3):
        assert mine.attn_seed() == (
            base.attn_seed() + rank * DATA_RANK_SEED_STRIDE) % (2**31 - 1)
    assert not torch.equal(mine.keep((64,), 0.5), base.keep((64,), 0.5))
    assert torch.equal(DropoutRNG(7, "cpu", 0).keep((64,), 0.5),
                       DropoutRNG(7, "cpu").keep((64,), 0.5))
