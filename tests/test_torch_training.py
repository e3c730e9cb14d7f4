"""The port's training engine and model on the CPU, where the JAX package
has no counterpart to compare with: the engine's API contract (the
train_batch window, eval mode, the errors of a misused loop), dropout on
the training path, and reduced-precision training. Parity with the JAX
engine is in test_torch_engine.py."""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.ops.transformer import DropoutRNG, dropout
from torch_test_env import jax_compile_cache  # noqa: F401


def _model(dropout_rate=0.0, seq=32, seed=0):
    cfg = GPT2Config(vocab_size=61, n_positions=seq, n_embd=32, n_layer=2,
                     n_head=4, dropout=dropout_rate, ce_block_rows=8)
    return GPT2LMHeadModel(cfg, device="cpu", seed=seed)


def _engine(model=None, **cfg):
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
              "steps_per_print": 1000}
    config.update(cfg)
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=model or _model(), config_params=config, device="cpu")
    assert loader is None
    return engine, opt, sched


def _batches(n, seq=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = [torch.randint(0, 61, (2, seq), generator=g) for _ in range(n)]
    return [(x, x) for x in ids]


def test_train_batch_is_the_forward_backward_step_loop():
    a, _, _ = _engine()
    b, _, _ = _engine()
    micro = _batches(4)
    losses_a = [float(a.train_batch(iter(micro[i:i + 2])))
                for i in (0, 2)]
    losses_b = []
    for i in (0, 2):
        window = []
        for batch in micro[i:i + 2]:
            loss = b(*batch)
            b.backward(loss)
            window.append(float(loss.detach()))
        b.step()
        losses_b.append(np.mean(window))
    np.testing.assert_allclose(losses_a, losses_b, rtol=1e-6)
    assert a.global_steps == b.global_steps == 2
    for (n, p), (_, q) in zip(a.module.named_parameters(),
                              b.module.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)


def test_memorizing_one_batch_lowers_the_loss():
    engine, _, _ = _engine(model=_model(dropout_rate=0.1))
    micro = _batches(2)
    losses = [float(engine.train_batch(iter(micro))) for _ in range(12)]
    assert losses[-1] < 0.7 * losses[0]
    assert engine.skipped_steps == 0


def test_dropout_is_drawn_per_micro_step_and_reproducible():
    """Dropout seeds come from the engine's generator (rng_seed): two
    engines with one seed give the same losses, and within an engine two
    micro-steps on one batch give different ones."""
    def run():
        engine, _, _ = _engine(model=_model(dropout_rate=0.2))
        batch = _batches(1)[0]
        out = []
        for _ in range(2):
            loss = engine(*batch)
            engine.backward(loss)
            out.append(float(loss.detach()))
        return out

    first, second = run(), run()
    assert first == second
    assert first[0] != first[1]


def test_eval_mode_runs_without_dropout_or_gradients():
    engine, _, _ = _engine(model=_model(dropout_rate=0.5))
    batch = _batches(1)[0]
    engine.eval()
    a = engine(*batch)
    b = engine(*batch)
    assert not a.requires_grad and float(a) == float(b)
    with torch.no_grad():
        want = engine.module(*batch)  # the model's eval path: no dropout
    torch.testing.assert_close(a, want)
    with pytest.raises(RuntimeError, match="without a preceding forward"):
        engine.backward(a)
    engine.train()
    loss = engine(*batch)
    assert loss.requires_grad


def test_misused_loops_raise():
    engine, _, _ = _engine()
    batch = _batches(1)[0]
    with pytest.raises(RuntimeError, match="without a preceding forward"):
        engine.backward(None)
    engine(*batch)
    with pytest.raises(RuntimeError, match="two forward"):
        engine(*batch)
    engine.backward(None)
    with pytest.raises(RuntimeError, match="ran dry"):
        engine.train_batch(iter([batch]))


@pytest.mark.parametrize("block,accum", [
    ({"bf16": {"enabled": True}}, "fp32"),
    ({"bf16": {"enabled": True}}, "bf16"),
    ({"fp16": {"enabled": True, "initial_scale_power": 8}}, "fp32"),
])
def test_reduced_precision_training_runs(block, accum):
    engine, opt, _ = _engine(data_types={"grad_accum_dtype": accum}, **block)
    micro = _batches(2)
    for _ in range(3):
        assert torch.isfinite(engine.train_batch(iter(micro)))
    assert engine.global_steps + engine.skipped_steps == 3
    assert all(p.dtype == torch.float32 for p in engine.module.parameters())
    assert opt.loss_scale == (256.0 if "fp16" in block else 1.0)


def test_cast_gradient_buffer_keeps_its_storage_across_windows():
    """When the gradients are cast into the accumulation dtype (bf16
    compute, fp32 accumulation), every window accumulates into the same
    buffer, so FusedLamb's cached device table of pointers stays valid; a
    run with the buffer dropped between windows takes the same steps."""
    a, _, _ = _engine(bf16={"enabled": True},
                      optimizer={"type": "FusedLamb", "params": {"lr": 1e-2}})
    b, _, _ = _engine(bf16={"enabled": True},
                      optimizer={"type": "FusedLamb", "params": {"lr": 1e-2}})
    micro = _batches(2)
    ptrs = []
    for _ in range(3):
        a.train_batch(iter(micro))
        b._grad_store = None  # the buffer made anew every window
        b.train_batch(iter(micro))
        ptrs.append([g.data_ptr() for g in a._grad_store.values()])
        assert all(g.dtype == torch.float32 for g in a._grad_store.values())
    assert ptrs[0] == ptrs[1] == ptrs[2]
    for (n, p), (_, q) in zip(a.module.named_parameters(),
                              b.module.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    same, _, _ = _engine()  # float32: the gradients are adopted, not cast
    same.train_batch(iter(micro))
    assert same._grad_store is None


def test_lamb_coeffs_cover_every_group():
    engine, opt, _ = _engine(optimizer={"type": "FusedLamb",
                                        "params": {"lr": 1e-2}})
    engine.train_batch(iter(_batches(2)))
    coeffs = opt.get_lamb_coeffs()
    assert coeffs.shape == (16,)  # 12 stacked block leaves + ln_f x2, wpe, wte
    assert bool(((coeffs >= 0.01) & (coeffs <= 10.0)).all())


def test_block_dropout_streams_and_gradients():
    """The training block draws three streams from its DropoutRNG (the
    attention mask seed, and the two hidden dropouts); every block
    parameter gets a finite gradient, and the same seed gives the same
    output."""
    model = _model(dropout_rate=0.3, seq=256)
    ids = _batches(1, seq=256)[0][0]
    outs = []
    for seed in (7, 7, 8):
        model.zero_grad()
        loss = model(ids, ids, train=True, dropout_seed=seed)
        loss.backward()
        outs.append(float(loss))
        for n, p in model.named_parameters():
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
    assert outs[0] == outs[1] != outs[2]
    with torch.no_grad():
        clean = float(model(ids, ids))
    assert clean != outs[0]


def test_hidden_dropout_keeps_one_minus_rate_and_rescales():
    rng = DropoutRNG(3, "cpu")
    x = torch.ones(200, 500)
    y = dropout(x, 0.25, rng)
    kept = (y != 0).double().mean().item()
    assert abs(kept - 0.75) < 4 * (0.75 * 0.25 / x.numel()) ** 0.5
    assert torch.all((y == 0) | (y == 1 / 0.75))
    assert dropout(x, 0.25, None) is x
    seeds = {rng.attn_seed() for _ in range(12)}
    assert len(seeds) == 12  # one attention-mask seed per layer

