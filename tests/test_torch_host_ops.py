"""Port parity for runtime/host_ops.py: the port's numpy and thread paths
against the JAX package's on the same inputs. ``shuffled_indices`` is the
data order a resumed run replays, so it must be the same permutation for
every ``n`` and seed, negative seeds included; the rest must give equal
bytes and rows, and the prefetch queue the same stream."""

import threading
import time

import numpy as np
import pytest

from deepspeed_tpu.runtime import host_ops as jhost
from deepspeed_tpu_torch.runtime import host_ops
from torch_test_env import jax_compile_cache  # noqa: F401


@pytest.mark.parametrize("n", [0, 1, 7, 1000])
@pytest.mark.parametrize("seed", [0, 3, -5])
def test_shuffled_indices_equal_jax(n, seed):
    got = host_ops.shuffled_indices(n, seed)
    want = jhost.shuffled_indices(n, seed)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


def test_shuffled_indices_depend_on_the_seed():
    a = host_ops.shuffled_indices(100, 1)
    assert not np.array_equal(a, host_ops.shuffled_indices(100, 2))
    np.testing.assert_array_equal(a, host_ops.shuffled_indices(100, 1))


def test_flatten_and_unflatten_equal_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3, 5)).astype(np.float32),
              np.arange(7, dtype=np.int64),
              rng.integers(0, 9, (2, 2, 2)).astype(np.int8)]
    flat = host_ops.flatten(arrays)
    np.testing.assert_array_equal(flat, jhost.flatten(arrays))
    out = [np.zeros_like(a) for a in arrays]
    host_ops.unflatten_into(flat, out)
    for a, b in zip(arrays, out):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="does not match"):
        host_ops.unflatten_into(flat, out[:2])
    assert host_ops.flatten([]).shape == (0,)


@pytest.mark.parametrize("rows", [[3, 0, 3, 9], []])
def test_gather_rows_equal_jax(rows):
    src = np.arange(40, dtype=np.float32).reshape(10, 4)
    np.testing.assert_array_equal(host_ops.gather_rows(src, rows),
                                  jhost.gather_rows(src, rows))


def test_prefetch_queue_orders_and_exhausts():
    it = iter(range(20))
    q = host_ops.make_prefetch_queue(lambda: next(it), capacity=3)
    got = []
    while True:
        try:
            got.append(q.get(timeout=5.0))
        except StopIteration:
            break
    assert got == list(range(20))
    q.stop()


def test_prefetch_queue_surfaces_the_producer_error():
    def producer():
        raise KeyError("boom")

    q = host_ops.make_prefetch_queue(producer, capacity=2)
    with pytest.raises(KeyError, match="boom"):
        q.get(timeout=5.0)
    q.stop()


def test_prefetch_queue_stop_mid_stream_ends_the_thread():
    q = host_ops.make_prefetch_queue(lambda: time.sleep(0.001) or 1,
                                     capacity=2)
    assert q.get(timeout=5.0) == 1
    q.stop()
    assert not q.alive()
    assert not [t for t in threading.enumerate()
                if t.name == "ds-prefetch" and t.is_alive()]
