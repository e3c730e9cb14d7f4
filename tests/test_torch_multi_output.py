"""The engine's multi-output contract, held to the JAX engine on the CPU
(tests/unit/test_multi_output.py's two-head model, the reference's
MultiOutputModel): a tuple return trains on element 0 and the rest rides
as ``last_aux``: the latest micro-step's raw aux between ``forward()``
and ``step()``, the window's aux ``[accum]``-stacked after a step (on
both train paths), the raw aux in eval. Both engines start from the same
weights on one device (the JAX engine on a one-device mesh) and see the
same batches; losses and aux agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.parallel.mesh import build_mesh
from torch_test_env import jax_compile_cache  # noqa: F401

HIDDEN, W1, W2 = 16, 1.0, 0.5
CONFIG = {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 16,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
          "steps_per_print": 10_000}


class JaxTwoHead(nn.Module):
    @nn.compact
    def __call__(self, x, y1, y2, train=True):
        h = nn.relu(nn.Dense(HIDDEN, name="body")(x))

        def ce(logits, y):
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))

        l1 = ce(nn.Dense(4, name="head1")(h), y1)
        l2 = ce(nn.Dense(4, name="head2")(h), y2)
        return W1 * l1 + W2 * l2, l1, l2


class TorchTwoHead(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.body = torch.nn.Linear(8, HIDDEN)
        self.head1 = torch.nn.Linear(HIDDEN, 4)
        self.head2 = torch.nn.Linear(HIDDEN, 4)
        with torch.no_grad():
            for name in ("body", "head1", "head2"):
                layer = getattr(self, name)
                layer.weight.copy_(torch.tensor(
                    np.asarray(params[name]["kernel"]).T))
                layer.bias.copy_(torch.tensor(np.asarray(params[name]["bias"])))

    def forward(self, x, y1, y2):
        h = F.relu(self.body(x))
        l1 = F.cross_entropy(self.head1(h), y1.long())
        l2 = F.cross_entropy(self.head2(h), y2.long())
        return W1 * l1 + W2 * l2, l1, l2


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return x, (x[:, 0] > 0).astype(np.int32) * 3, (
        x[:, 1] > 0).astype(np.int32) * 2


@pytest.fixture(scope="module")
def engines():
    def make():
        model = JaxTwoHead()
        x, y1, y2 = _data(4)
        params = jax.jit(model.init)(jax.random.PRNGKey(0), x, y1,
                                     y2)["params"]
        je, *_ = deepspeed_tpu.initialize(
            model=model, model_parameters=params, config_params=CONFIG,
            mesh=build_mesh(devices=jax.devices()[:1]))
        te, *_ = dst.initialize(model=TorchTwoHead(jax.device_get(params)),
                                config_params=CONFIG, device="cpu")
        return je, te
    return make


def _halves(step):
    x, y1, y2 = _data(32, seed=step % 4)
    return (x[:16], y1[:16], y2[:16]), (x[16:], y1[16:], y2[16:])


def test_two_heads_train_and_expose_their_losses(engines):
    je, te = engines()
    first = None
    for step in range(6):
        b1, b2 = _halves(step)
        for e in (je, te):
            e.backward(e(*b1))
        # mid-window: this micro-step's raw aux
        np.testing.assert_allclose([float(a) for a in te.last_aux],
                                   [float(a) for a in je.last_aux],
                                   rtol=1e-5)
        for e in (je, te):
            e.backward(e(*b2))
            e.step()
        # after the step: the window's aux, [accum]-stacked
        assert [tuple(a.shape) for a in te.last_aux] == [(2,), (2,)]
        np.testing.assert_allclose(np.stack([a.numpy() for a in te.last_aux]),
                                   np.stack(jax.device_get(je.last_aux)),
                                   rtol=1e-5, atol=1e-6)
        if first is None:
            first = [float(a.mean()) for a in te.last_aux]
    last = [float(a.mean()) for a in te.last_aux]
    assert last[0] < first[0] and last[1] < first[1]


def test_train_batch_stacks_the_window_aux(engines):
    je, te = engines()
    b1, b2 = _halves(1)
    jl = float(je.train_batch(iter([b1, b2])))
    tl = float(te.train_batch(iter([b1, b2])))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    l1, l2 = te.last_aux
    assert l1.shape == (2,) and l2.shape == (2,)
    np.testing.assert_allclose(tl, float(torch.mean(W1 * l1 + W2 * l2)),
                               rtol=1e-5)
    np.testing.assert_allclose(np.stack([l1.numpy(), l2.numpy()]),
                               np.stack(jax.device_get(je.last_aux)),
                               rtol=1e-5, atol=1e-6)


def test_eval_mode_splits_aux_too(engines):
    je, te = engines()
    b1, _ = _halves(2)
    for e in (je, te):
        e.eval()
    tl = te(*b1)
    jl = je(*b1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert all(a.dim() == 0 for a in te.last_aux)
    np.testing.assert_allclose([float(a) for a in te.last_aux],
                               [float(a) for a in je.last_aux], rtol=1e-5)
    np.testing.assert_allclose(
        float(tl), W1 * float(te.last_aux[0]) + W2 * float(te.last_aux[1]),
        rtol=1e-6)
