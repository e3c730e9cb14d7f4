"""Port parity for runtime/dataloader.py: the port's DeepSpeedDataLoader
against the JAX package's (``mesh=None``: host batches) on the same numpy
dataset, batch for batch and bit for bit, in every mode (arrays, map,
iterable), with the shuffle on and off, over two epochs; then the
loader's own rules (the refused mesh, the replayable stream,
the staged epoch, the timer and the queue-depth gauge)."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JLoader
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from torch_test_env import jax_compile_cache  # noqa: F401


def _arrays(n=22):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 100, (n, 5)).astype(np.int32),
            rng.standard_normal((n, 3)).astype(np.float32))


class _Map:
    """A map dataset of (ids, x) examples over the arrays."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)


class _Iterable:
    """An iterable dataset of ready batches (a fresh pass each epoch)."""

    def __init__(self, arrays, batch):
        self.arrays, self.batch = arrays, batch

    def __iter__(self):
        n = len(self.arrays[0])
        for s in range(0, n - self.batch + 1, self.batch):
            yield tuple(a[s:s + self.batch] for a in self.arrays)


def _dataset(mode, arrays):
    if mode == "arrays":
        return arrays
    if mode == "map":
        return _Map(arrays)
    return _Iterable(arrays, 4)


def _as_numpy(batch):
    if isinstance(batch, (tuple, list)):
        return [_as_numpy(x) for x in batch]
    return batch.numpy() if isinstance(batch, torch.Tensor) else np.asarray(
        batch)


@pytest.mark.parametrize("mode", ["arrays", "map", "iterable"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_equal_jax_over_two_epochs(mode, shuffle, drop_last):
    arrays = _arrays()
    got_loader = DeepSpeedDataLoader(_dataset(mode, arrays), batch_size=4,
                                     shuffle=shuffle, seed=3,
                                     drop_last=drop_last, device="cpu")
    want_loader = JLoader(_dataset(mode, arrays), batch_size=4, mesh=None,
                          shuffle=shuffle, seed=3, drop_last=drop_last)
    if mode != "iterable":
        assert len(got_loader) == len(want_loader)
    for epoch in range(2):
        got_loader.set_epoch(epoch)
        want_loader.set_epoch(epoch)
        got = [_as_numpy(b) for b in got_loader]
        want = [_as_numpy(b) for b in want_loader]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        if shuffle and mode != "iterable" and epoch == 0:
            first = got
    if shuffle and mode != "iterable":
        # the epoch reseeds the permutation
        assert not np.array_equal(first[0][0], got[0][0])


def test_batches_are_cpu_tensors_and_prefetch_changes_nothing():
    arrays = _arrays()
    a = list(DeepSpeedDataLoader(arrays, batch_size=4, prefetch=0,
                                 shuffle=True, device="cpu"))
    b = list(DeepSpeedDataLoader(arrays, batch_size=4, prefetch=3,
                                 shuffle=True, device="cpu"))
    for x, y in zip(a, b):
        for s, t in zip(x, y):
            assert isinstance(s, torch.Tensor) and s.device.type == "cpu"
            assert torch.equal(s, t)


def test_collate_fn_batches_a_map_dataset():
    arrays = _arrays()

    def collate(samples):
        return np.stack([s[0] for s in samples]).sum(axis=1)

    got = list(DeepSpeedDataLoader(_Map(arrays), batch_size=4,
                                   collate_fn=collate, device="cpu"))
    want = list(JLoader(_Map(arrays), batch_size=4, mesh=None,
                        collate_fn=collate))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_a_mesh_is_refused_as_not_ported():
    """Any mesh but the port's ProcessMesh, with the reason the port
    differs."""
    with pytest.raises(DeepSpeedConfigError, match="takes a deepspeed_tpu_"
                                                   "torch.parallel.ProcessMesh"):
        DeepSpeedDataLoader(_arrays(), batch_size=4, mesh=object())


@pytest.mark.parametrize("stage_to_device", [False, True])
def test_the_loader_and_the_stager_default_to_the_card(stage_to_device):
    """Entry points: with no ``device`` the loader and the window stager
    take "cuda", raise without a GPU, and never quietly keep "staged"
    batches on the host; on the card the loader pins by default."""
    from deepspeed_tpu_torch.runtime.staging import WindowStager

    if torch.cuda.is_available():
        loader = DeepSpeedDataLoader(_arrays(), batch_size=4,
                                     stage_to_device=stage_to_device)
        assert loader.device.type == "cuda" and loader.pin_memory
        WindowStager(iter(()), accum=1).close()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepSpeedDataLoader(_arrays(), batch_size=4,
                            stage_to_device=stage_to_device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WindowStager(iter(()), accum=1)
    assert not DeepSpeedDataLoader(_arrays(), batch_size=4,
                                   device="cpu").pin_memory


def test_iter_from_replays_the_epoch_stream():
    """``iter_from(p)`` is the stream of epochs 0, 1, ... from micro-batch
    ``p``: a ReplayableDataSource over the loader rewinds to any
    position."""
    from deepspeed_tpu_torch.resilience import ReplayableDataSource

    loader = DeepSpeedDataLoader(_arrays(), batch_size=4, shuffle=True,
                                 device="cpu")
    stream = []
    for epoch in range(3):
        loader.set_epoch(epoch)
        stream += list(loader)
    loader.set_epoch(0)
    src = ReplayableDataSource(loader.iter_from)
    assert len(loader) == 5
    first = [next(src) for _ in range(12)]
    for g, w in zip(first, stream):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    src.rewind(3)
    for g, w in zip([next(src) for _ in range(9)], stream[3:12]):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def test_staged_epoch_is_marked_and_equals_the_host_epoch():
    arrays = _arrays()
    staged = DeepSpeedDataLoader(arrays, batch_size=4, shuffle=True,
                                 stage_to_device=True, device="cpu")
    it = iter(staged)
    assert getattr(it, "already_staged", False)
    got = list(it)
    want = list(DeepSpeedDataLoader(arrays, batch_size=4, shuffle=True,
                                    device="cpu"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    # a half-consumed staged epoch stops with close_staging
    it = iter(staged)
    assert it.stager is None
    next(it)
    assert it.stager.alive()
    staged.close_staging()
    assert it.stager.closed
    with pytest.raises(StopIteration):
        next(it)


def test_throughput_timer_and_queue_depth_gauge():
    class Timer:
        def __init__(self):
            self.epochs = self.starts = 0

        def update_epoch_count(self):
            self.epochs += 1

        def start(self):
            self.starts += 1

    class Telemetry:
        def __init__(self):
            self.depths = []

        def set_dataloader_depth(self, depth):
            self.depths.append(depth)

    timer, tel = Timer(), Telemetry()
    loader = DeepSpeedDataLoader(
        (np.arange(64, dtype=np.float32).reshape(16, 4),), batch_size=4,
        prefetch=2, tput_timer=timer, telemetry=tel, device="cpu")
    list(loader)
    first = len(tel.depths)
    # producer-side samples, not only the 4 handoffs
    assert first > 4 and any(d > 0 for d in tel.depths)
    list(loader)
    assert any(d > 0 for d in tel.depths[first:])
    assert timer.epochs == 2 and timer.starts == 8
