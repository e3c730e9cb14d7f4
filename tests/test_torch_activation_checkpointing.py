"""Port parity for the activation API (deepspeed_tpu_torch/checkpointing.py
against deepspeed_tpu/checkpointing.py): ``checkpoint``'s value and
gradient against the JAX package's on the same numpy inputs (rtol 1e-5:
float32 through three tanh layers, in other summation orders), its modes
(cpu_checkpointing, profile, partition_activations at model-parallel
size 1 and above), ``configure`` from a config, the contiguous-buffer
rule, the RNG tracker's fork streams, its model-parallel seeds and its
duplicate-seed rejection, and the engine's call to ``configure``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu import checkpointing as jckpt
from deepspeed_tpu_torch import checkpointing as ckpt
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from torch_test_env import jax_compile_cache  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    for mod in (ckpt, jckpt):
        mod.configure(
            None, partition_activations=False, checkpoint_in_cpu=False,
            contiguous_checkpointing=False, num_checkpoints=1,
            profile=False, synchronize=False,
        )
    ckpt.get_rng_tracker().reset()


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((8, 16)).astype(np.float32),
            (rng.standard_normal((16, 16)) * 0.1).astype(np.float32))


def _jfn(x, w):
    for _ in range(3):
        x = jnp.tanh(x @ w)
    return jnp.sum(x ** 2)


def _tfn(x, w):
    for _ in range(3):
        x = torch.tanh(x @ w)
    return (x ** 2).sum()


def _torch_value_and_grad(fn, x, w):
    w = torch.from_numpy(w).requires_grad_()
    val = fn(torch.from_numpy(x), w)
    val.backward()
    return val.detach().numpy(), w.grad.numpy()


@pytest.mark.parametrize("mode", ["plain", "cpu", "profile", "partition"])
def test_checkpoint_value_and_grad_match_jax(mode):
    x, w = _inputs()
    ckpt.configure(None, checkpoint_in_cpu=mode == "cpu",
                   profile=mode == "profile",
                   partition_activations=mode == "partition")
    jckpt.configure(None)
    want_val, want_grad = jax.value_and_grad(
        lambda x, w: jckpt.checkpoint(_jfn, x, w), argnums=1)(
            jnp.asarray(x), jnp.asarray(w))
    got_val, got_grad = _torch_value_and_grad(
        lambda x, w: ckpt.checkpoint(_tfn, x, w), x, w)
    np.testing.assert_allclose(got_val, np.asarray(want_val), **TOL)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), **TOL)
    # and bit for bit the port's own function without the checkpoint
    plain_val, plain_grad = _torch_value_and_grad(_tfn, x, w)
    assert np.array_equal(got_val, plain_val)
    assert np.array_equal(got_grad, plain_grad)


def test_checkpoint_recomputes_and_profiles_its_segment():
    from torch.profiler import ProfilerActivity, profile

    calls = []

    def fn(x, w):
        calls.append(1)
        return _tfn(x, w)

    x, w = _inputs()
    ckpt.configure(None, profile=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _torch_value_and_grad(lambda x, w: ckpt.checkpoint(fn, x, w), x, w)
    assert len(calls) == 2  # the forward and the backward's recompute
    names = {e.key for e in prof.key_averages()}
    assert "ds_checkpoint_segment" in names


def test_cpu_checkpointing_keeps_the_inputs_through_save_on_cpu(
        monkeypatch):
    packed = []
    real = torch.autograd.graph.save_on_cpu

    class Spy(real):
        def __init__(self, pin_memory=False, device_type="cuda"):
            super().__init__(pin_memory=pin_memory, device_type=device_type)
            pack = self.pack_hook

            def counted(t):
                packed.append(tuple(t.shape))
                return pack(t)

            self.pack_hook = counted

    monkeypatch.setattr(torch.autograd.graph, "save_on_cpu", Spy)
    ckpt.configure(None, checkpoint_in_cpu=True)
    x, w = _inputs()
    _torch_value_and_grad(lambda x, w: ckpt.checkpoint(_tfn, x, w), x, w)
    assert (8, 16) in packed and (16, 16) in packed


def test_partition_activations_above_model_parallel_one_is_not_ported():
    # the refusal is lifted: configure takes partition_activations at a
    # model axis above 1 (the partitioned recompute itself runs on gloo
    # ranks in tests/test_torch_model_parallel_pieces.py)
    class Mpu:
        def get_model_parallel_world_size(self):
            return 2

        def get_model_parallel_rank(self):
            return 0

    try:
        ckpt.configure(Mpu(), partition_activations=True)
        assert ckpt.PARTITION_ACTIVATIONS
        assert ckpt._model_parallel_size() == 2
    finally:
        ckpt.configure(None, partition_activations=False)


def test_configure_from_a_config_matches_jax(tmp_path):
    import json

    from deepspeed_tpu.config import DeepSpeedConfig as JConfig

    path = tmp_path / "ds.json"
    path.write_text(json.dumps({
        "train_batch_size": 8,
        "activation_checkpointing": {
            "partition_activations": True, "cpu_checkpointing": True,
            "profile": True, "number_checkpoints": 4,
            "contiguous_memory_optimization": True,
            "synchronize_checkpoint_boundary": True,
        },
    }))
    jckpt.configure(None, deepspeed_config=JConfig(str(path), world_size=1))
    ckpt.configure(None, deepspeed_config=DeepSpeedConfig(
        str(path), world_size=1, training=True))
    assert ckpt.is_configured()
    for flag in ("PARTITION_ACTIVATIONS", "CPU_CHECKPOINT", "PROFILE_TIME",
                 "CONTIGUOUS_CHECKPOINTING", "SYNCHRONIZE", "_NUM_LAYERS"):
        assert getattr(ckpt, flag) == getattr(jckpt, flag), flag


def test_contiguous_checkpointing_needs_the_number_of_checkpoints():
    msgs = []
    for mod in (jckpt, ckpt):
        with pytest.raises(AssertionError) as info:
            mod.configure(None, contiguous_checkpointing=True,
                          num_checkpoints=-1)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and "number of checkpoints" in msgs[1]


def test_rng_tracker_fork_streams():
    tracker = ckpt.model_parallel_seed(1234, device="cpu")
    with tracker.fork():
        a = torch.randn(4)
    with tracker.fork():
        b = torch.randn(4)
    assert not torch.equal(a, b)  # consecutive forks advance the stream
    outside = torch.default_generator.get_state()
    tracker = ckpt.model_parallel_seed(1234, device="cpu")
    with tracker.fork() as gen:
        assert gen is torch.default_generator
        a2 = torch.randn(4)
    assert torch.equal(a, a2)  # re-seeding reproduces the stream
    # the fork leaves the default generator as it found it
    assert torch.equal(torch.default_generator.get_state(), outside)


def test_rng_tracker_model_parallel_rank_dependence():
    class Mpu:
        def __init__(self, r):
            self.r = r

        def get_model_parallel_rank(self):
            return self.r

    draws, defaults = [], []
    for rank in (0, 1):
        tracker = ckpt.model_parallel_seed(7, mpu=Mpu(rank), device="cpu")
        with tracker.fork():
            draws.append(torch.randn(4))
        defaults.append(tracker.get_states()["default"])
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(defaults[0], defaults[1])


def test_duplicate_seed_and_state_are_rejected_as_jax_does():
    for tracker in (jckpt.RNGStatesTracker(),
                    ckpt.RNGStatesTracker(device="cpu")):
        tracker.add("a", 1)
        with pytest.raises(ValueError, match="seed 1 already present"):
            tracker.add("b", 1)
        with pytest.raises(ValueError, match="rng state a already present"):
            tracker.add("a", 2)
        with pytest.raises(KeyError):
            with tracker.fork("missing"):
                pass


def test_a_forked_dropout_inside_checkpoint_repeats_its_mask():
    """The recompute runs on the tracker's states of the forward, so a
    dropout drawn from a forked stream inside the segment repeats its mask
    and the gradient equals the un-checkpointed one."""
    x, w = _inputs()

    def fn(x, w):
        with ckpt.get_rng_tracker().fork():
            return (torch.nn.functional.dropout(x @ w, 0.5) ** 2).sum()

    grads = []
    for wrap in (False, True):
        ckpt.model_parallel_seed(5, device="cpu")
        wt = torch.from_numpy(w).requires_grad_()
        out = ckpt.checkpoint(fn, torch.from_numpy(x), wt) if wrap else fn(
            torch.from_numpy(x), wt)
        out.backward()
        grads.append(wt.grad)
    assert torch.equal(grads[0], grads[1])


def test_the_engine_configures_checkpointing():
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    model = GPT2LMHeadModel(GPT2Config(vocab_size=64, n_positions=16,
                                       n_embd=16, n_layer=1, n_head=2),
                            device="cpu")
    deepspeed_tpu_torch.initialize(
        model=model, device="cpu", config_params={
            "train_batch_size": 2,
            "activation_checkpointing": {"partition_activations": True,
                                         "profile": True}})
    assert ckpt.is_configured()
    assert ckpt.PARTITION_ACTIVATIONS and ckpt.PROFILE_TIME
