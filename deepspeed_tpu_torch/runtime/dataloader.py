"""Data loader: host batching, pinned for the card.

Port of deepspeed_tpu/runtime/dataloader.py (the reference's
DeepSpeedDataLoader, deepspeed/pt/deepspeed_dataloader.py): one batch of
``batch_size`` rows at a time, from

- a tuple or list of arrays (numpy arrays or tensors, sliced along dim 0
  with ``gather_rows``),
- a map dataset (``__len__``/``__getitem__``), batched by ``collate_fn``
  (default: stack each field), or
- any iterable of ready batches,

with the seeded epoch shuffle of ``host_ops.shuffled_indices`` (seed +
epoch, the JAX package's permutation), ``drop_last``, ``set_epoch``, a
background ``prefetch`` queue, the throughput timer (started at each
batch handoff) and the ``dataloader/queue_depth`` gauge.

It yields CPU tensors (the dataset's dtypes). ``device`` is the card
unless the caller passes ``device="cpu"``; with ``pin_memory`` (by default
when ``device`` is CUDA) the batches sit in pinned memory, so the copy to
the card can run asynchronously. With ``stage_to_device`` (the
engine's ``data_pipeline`` block at one micro-batch a window) the batches
go through the window stager (runtime/staging.py) instead: assembled and
copied to ``device`` on its worker thread, they arrive on the card, and
the iterator is marked ``already_staged`` so that ``train_batch`` adds no
second stager.

Across data-parallel processes (a ``mesh`` whose data axis is above 1,
or an initialised torch.distributed world of more than one process),
``batch_size`` is the global batch and each rank loads its own rows: every
rank computes the same seeded order, and rank ``r`` of ``n`` takes rows
``r*batch_size/n`` to ``(r+1)*batch_size/n`` of each batch, as the JAX
loader's processes do (the reference's DistributedSampler contract). A
ragged last batch cannot split evenly, so ``drop_last`` is forced on.
Under a mesh the rows split over the data axis only: the ranks of a
pipe, sequence or model line (the stages of one pipeline, say) load the
same rows, their data rank's.
"""

import weakref

import numpy as np
import torch

from ..config.config import DeepSpeedConfigError
from ..utils.device import resolve_device
from . import host_ops


def _default_collate(samples):
    """Stack a list of per-example tuples into batch arrays."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(
            np.stack([np.asarray(s[i]) for s in samples])
            for i in range(len(first))
        )
    return (np.stack([np.asarray(s) for s in samples]),)


def _host_array(a):
    """A dataset array as a C-contiguous numpy array (a tensor through
    its CPU copy)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a)


class _StagedEpochIterator:
    """Iterator over one staged epoch. ``already_staged`` tells
    ``train_batch`` the batches are on the card already (the loader's
    staging worker put them there), so it must not add a second stager.
    ``stager`` is the epoch's window stager from the first ``next`` on."""

    already_staged = True

    def __init__(self, loader):
        self.stager = None
        self._gen = loader._iter_impl(self)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        self._gen.close()


class DeepSpeedDataLoader:
    def __init__(
        self,
        dataset,
        batch_size,
        mesh=None,
        collate_fn=None,
        shuffle=False,
        seed=0,
        drop_last=True,
        tput_timer=None,
        prefetch=2,
        telemetry=None,
        stage_to_device=False,
        staging_buffers=2,
        device=None,
        pin_memory=None,
    ):
        import torch.distributed as dist

        # this process's share of each global batch: the mesh's data rank,
        # else the initialised world's rank
        from ..parallel.mesh import ProcessMesh

        if mesh is not None and not isinstance(mesh, ProcessMesh):
            raise DeepSpeedConfigError(
                f"a data loader that places batches on a "
                f"{type(mesh).__name__} mesh: the port's loader takes a "
                "deepspeed_tpu_torch.parallel.ProcessMesh and yields this "
                "rank's rows (the JAX loader places one process's global "
                "batch over a jax.sharding.Mesh, which has no counterpart "
                "here)")
        if mesh is not None:
            self.rank, self.num_ranks = mesh.data_rank, mesh.dp_size
        elif dist.is_available() and dist.is_initialized():
            self.rank, self.num_ranks = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.num_ranks = 0, 1
        if self.num_ranks > 1:
            if batch_size % self.num_ranks != 0:
                raise ValueError(
                    f"batch_size={batch_size} must divide across "
                    f"{self.num_ranks} processes"
                )
            if not drop_last:
                from ..utils.logging import log_dist

                log_dist(
                    "multi-process loader forces drop_last=True (a ragged "
                    "final batch cannot split evenly across processes)",
                    ranks=[0],
                )
                drop_last = True
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.tput_timer = tput_timer
        self.prefetch = prefetch
        # the dataloader/queue_depth gauge samples the prefetch queue at
        # each batch handoff and from the producer (each enqueue), so an
        # epoch's refill shows; a queue pinned at 0 means the host data
        # path bounds throughput
        self.telemetry = telemetry
        self.stage_to_device = stage_to_device
        self.staging_buffers = staging_buffers
        # an entry point: the card unless the caller asks for the CPU
        self.device = resolve_device(device)
        self.pin_memory = (self.device.type == "cuda" if pin_memory is None
                           else bool(pin_memory))
        self._epoch = 0
        # every live staged epoch iterator (a user can hold a partly
        # consumed epoch while starting another): close_staging reaches
        # every worker
        self._live_staged_iters = weakref.WeakSet()

        if isinstance(dataset, (tuple, list)) and dataset and all(
            hasattr(a, "shape") for a in dataset
        ):
            self._mode = "arrays"
            self._num_samples = int(dataset[0].shape[0])
        elif hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__"):
            self._mode = "map"
            self._num_samples = len(dataset)
        else:
            self._mode = "iterable"
            self._num_samples = None

    def __len__(self):
        if self._num_samples is None:
            raise TypeError("length of an iterable dataset is unknown")
        if self.drop_last:
            return self._num_samples // self.batch_size
        return (self._num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __iter__(self):
        if not self.stage_to_device:
            return self._iter_impl()
        it = _StagedEpochIterator(self)
        self._live_staged_iters.add(it)
        return it

    def iter_from(self, position):
        """An iterator that starts at micro-batch ``position`` of the
        stream of epochs ``set_epoch``'s epoch, +1, +2, ... (each epoch
        shuffled by its own seed): the factory of a
        :class:`~deepspeed_tpu_torch.resilience.ReplayableDataSource`
        over this loader, which a supervisor's rollback rewinds to the
        restored ``micro_steps``. Host batches, without prefetch or
        staging (the engine's stager stages the replayable source)."""
        n = len(self)
        if n == 0:
            raise ValueError("an empty loader has no batch to replay")
        first = self._epoch

        def gen(position):
            epoch, skip = divmod(int(position), n)
            while True:
                order = self._order(first + epoch)
                batches = self._assembler(order)
                for b in range(skip, n):
                    yield self._to_tensors(batches(b))
                epoch, skip = epoch + 1, 0

        return gen(position)

    def close_staging(self):
        """Stop this loader's staging workers mid-epoch (idempotent; a
        no-op for exhausted epochs and unstaged loaders). The engine's
        ``close_data_pipeline`` and the preemption drain call it, so a
        loader-owned worker cannot outlive the teardown."""
        for it in list(self._live_staged_iters):
            it.close()
        self._live_staged_iters.clear()

    def _order(self, epoch):
        if self.shuffle:
            # the JAX package's permutation, so a resume replays the data
            # order
            return host_ops.shuffled_indices(
                self._num_samples, self.seed + epoch)
        return np.arange(self._num_samples, dtype=np.int64)

    def _assembler(self, order):
        """``assemble(b)``: batch ``b`` of the epoch in ``order``, as host
        arrays."""
        if self._mode == "arrays":
            # one host conversion an epoch, not a batch
            arrays = [_host_array(a) for a in self.dataset]

        per_rank = self.batch_size // self.num_ranks

        def assemble(b):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            if self.num_ranks > 1:
                idx = idx[self.rank * per_rank : (self.rank + 1) * per_rank]
            if self._mode == "arrays":
                return tuple(
                    host_ops.gather_rows(a, idx) if a.ndim >= 1 else a
                    for a in arrays
                )
            return self.collate_fn([self.dataset[int(i)] for i in idx])

        return assemble

    def _to_tensors(self, batch):
        """A batch's arrays as CPU tensors, pinned with ``pin_memory``."""
        def leaf(x):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            return t.pin_memory() if self.pin_memory else t

        if isinstance(batch, (tuple, list)):
            return tuple(leaf(x) for x in batch)
        return leaf(batch)

    def _iter_impl(self, staged=None):
        """One epoch's batches; through the stager with ``staged``, the
        epoch's :class:`_StagedEpochIterator`."""
        if self.tput_timer is not None:
            self.tput_timer.update_epoch_count()
        if self._mode == "iterable":
            if self.stage_to_device:
                yield from self._iter_staged(iter(self.dataset), staged)
                return
            for batch in self.dataset:
                yield self._handoff(self._to_tensors(batch))
            return
        assemble = self._assembler(self._order(self._epoch))
        nb = len(self)

        if self.stage_to_device:
            yield from self._iter_staged(
                (assemble(b) for b in range(nb)), staged)
            return

        if self.prefetch and self.prefetch > 0:
            counter = iter(range(nb))
            qref = []

            def producer():
                b = next(counter)  # StopIteration ends the stream
                batch = self._to_tensors(assemble(b))
                if self.telemetry is not None:
                    # producer-side depth (+1 for the batch about to go
                    # in); before the queue exists, the one in flight
                    q = qref[0] if qref else None
                    self.telemetry.set_dataloader_depth(
                        q.qsize() + 1 if q is not None else 1
                    )
                return batch

            q = host_ops.make_prefetch_queue(producer, capacity=self.prefetch)
            qref.append(q)
            try:
                while True:
                    try:
                        batch = q.get(timeout=60.0)
                    except TimeoutError:
                        # a slow producer is not an error while it lives; a
                        # dead one (no end-of-stream sentinel) is
                        if not q.alive() and q.qsize() == 0:
                            raise RuntimeError(
                                "prefetch producer thread died without "
                                "signalling end-of-stream"
                            ) from None
                        continue
                    except StopIteration:
                        break
                    if self.telemetry is not None:
                        self.telemetry.set_dataloader_depth(q.qsize())
                    yield self._handoff(batch)
            finally:
                q.stop()
        else:
            for b in range(nb):
                yield self._handoff(self._to_tensors(assemble(b)))

    def _iter_staged(self, host_batches, owner):
        """One epoch through the window stager with one micro-batch a
        window: assembly and the copy to ``device`` run on its worker, and
        each batch is handed over once the consuming stream has been told
        to wait for its copy. The stager is published on ``owner`` (the
        epoch's iterator). A break mid-epoch closes the worker."""
        from .staging import WindowStager

        # a disabled facade is withheld, so the worker skips its
        # bookkeeping
        tel = self.telemetry
        if tel is not None and not getattr(tel, "enabled", True):
            tel = None
        stager = WindowStager(
            # 1-tuple-wrapped so that the raw batch (tuple or bare array)
            # comes back unchanged
            source=((b,) for b in host_batches),
            accum=1,
            device=self.device,
            buffers=self.staging_buffers,
            stage_to_device=True,
            telemetry=tel,
            name="dataloader",
        )
        owner.stager = stager
        try:
            while True:
                try:
                    window = stager.get_window()
                except StopIteration:
                    break
                window.wait()
                if self.telemetry is not None:
                    # the stager's occupancy on the prefetch-depth gauge
                    self.telemetry.set_dataloader_depth(stager.occupancy())
                if self.tput_timer is not None:
                    self.tput_timer.start()
                yield window.arrays[0][0]
        finally:
            stager.close()

    def _handoff(self, batch):
        if self.tput_timer is not None:
            self.tput_timer.start()
        return batch
