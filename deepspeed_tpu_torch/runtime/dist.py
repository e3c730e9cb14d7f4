"""Distributed bootstrap and the port's collectives, over torch.distributed.

Port of deepspeed_tpu/runtime/dist.py. The port's launcher
(``python -m deepspeed_tpu_torch.launcher.runner``, launcher/launch.py)
starts one process per GPU slot and exports ``DS_TPU_COORDINATOR_ADDRESS``
(``host:port``), ``DS_TPU_NUM_PROCESSES`` and ``DS_TPU_PROCESS_ID`` (the
global rank), and ``LOCAL_RANK`` (the process's index on its host);
:func:`init_distributed` turns them into
``torch.distributed.init_process_group(init_method="tcp://<address>",
rank=, world_size=)``, one process per device: ``nccl`` when the engine's
device is CUDA, bound to ``cuda:<LOCAL_RANK>``, ``gloo`` on the CPU. A
group the caller already made is used as it is (the JAX package accepts
a ``jax.distributed`` the user started the same way).

Two parts of the JAX module are left out:

- ``maybe_auto_init`` at import. JAX needs it because its backend can be
  initialised only once, before any computation; torch.distributed has no
  such window, and ``initialize()`` calls :func:`init_distributed`.
- ``shard_map``, a shim over two JAX versions' spelling of one function.

The collectives are a few functions on tensors over a process group:
:func:`all_reduce` (a sum in place, or another reduce op),
:func:`reduce_scatter` (a sum of ``dp`` equal chunks, this rank's chunk
out), :func:`all_gather` (every rank's chunk, in rank order) and
:func:`barrier`. Each can be issued
asynchronously (``async_op=True`` returns the work handle; its
``wait()`` finishes it). Two ranks that share one card talk over gloo
(NCCL refuses two ranks on one device): gloo takes all three ops on CUDA
tensors (probed with torch 2.11 on an H100 and torch 2.13 on the CPU),
so they pass CUDA tensors to it as they are.
"""

import os

import torch
import torch.distributed as dist

from ..utils.logging import logger

COORD_ENV = "DS_TPU_COORDINATOR_ADDRESS"
NPROC_ENV = "DS_TPU_NUM_PROCESSES"
PID_ENV = "DS_TPU_PROCESS_ID"
LOCAL_RANK_ENV = "LOCAL_RANK"

def is_initialized():
    return dist.is_available() and dist.is_initialized()


def process_index():
    """This process's global rank: its rank in the initialised group, 0
    without one (the JAX package's ``jax.process_index()``)."""
    return dist.get_rank() if is_initialized() else 0


def local_device_index(process_id):
    """The CUDA device a process binds: ``LOCAL_RANK`` when the launcher
    exported it (its index among its host's slots, which its
    ``CUDA_VISIBLE_DEVICES`` lists), else ``process_id`` modulo the
    visible devices, for a process started by hand without it."""
    local = os.environ.get(LOCAL_RANK_ENV)
    if local is not None and local.strip():
        return int(local)
    return process_id % torch.cuda.device_count()


def init_distributed(dist_init_required=None, device=None):
    """Initialise torch.distributed from the launcher's environment, once.

    Returns True when a process group is active, False for a single
    process without one. ``dist_init_required=False`` skips entirely (the
    caller manages torch.distributed itself); ``True`` raises if a
    multi-process run was requested but cannot be set up, and with a
    coordinator in the environment starts a group even at world size 1
    (the one-card run of the NCCL path); otherwise world size 1 has
    nothing to rendezvous. ``device`` picks the backend: ``nccl`` for
    CUDA, ``gloo`` otherwise."""
    if dist_init_required is False:
        return is_initialized()
    if is_initialized():
        return True
    coordinator = os.environ.get(COORD_ENV)
    num_processes = int(os.environ.get(NPROC_ENV, "1"))
    process_id = int(os.environ.get(PID_ENV, "0"))
    if num_processes <= 1 and not (dist_init_required and coordinator):
        # world size 1: nothing to rendezvous (even under the launcher)
        return False
    if coordinator is None:
        if dist_init_required:
            raise RuntimeError(
                f"dist_init_required=True with {NPROC_ENV}={num_processes} "
                f"but {COORD_ENV} is unset; start via python -m "
                "deepspeed_tpu_torch.launcher.runner or export the DS_TPU_* "
                "variables"
            )
        return False
    if not dist.is_available():
        raise RuntimeError(
            f"{NPROC_ENV}={num_processes} asks for a multi-process run, but "
            "this torch build has no torch.distributed; install a build "
            "with distributed support or run one process"
        )
    device = torch.device("cpu" if device is None else device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.index is None:
        torch.cuda.set_device(local_device_index(process_id))
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        rank=process_id, world_size=num_processes,
    )
    logger.info(
        "torch.distributed initialized (%s): process %d/%d via %s",
        backend, process_id, num_processes, coordinator,
    )
    return True


def all_reduce(tensor, group=None, async_op=False, op=None):
    """Sum ``tensor`` over ``group`` in place (or reduce it with ``op``, a
    ``torch.distributed.ReduceOp``)."""
    return dist.all_reduce(tensor, op=dist.ReduceOp.SUM if op is None else op,
                           group=group, async_op=async_op)


def reduce_scatter(out, inp, group=None, async_op=False):
    """``out`` <- the sum over ``group`` of every rank's chunk ``rank`` of
    ``inp`` (``inp`` is ``world`` chunks of ``out``'s size, flat or along
    dim 0). Newer torch names the flat forms ``reduce_scatter_single`` and
    ``all_gather_single`` (the old names warn there); older torch has only
    ``reduce_scatter_tensor`` and ``all_gather_into_tensor``."""
    op = getattr(dist, "reduce_scatter_single", None) or (
        dist.reduce_scatter_tensor)
    return op(out, inp, group=group, async_op=async_op)


def all_gather(out, inp, group=None, async_op=False):
    """``out`` <- every rank's ``inp`` in rank order (``out`` is ``world``
    chunks of ``inp``'s size)."""
    op = getattr(dist, "all_gather_single", None) or (
        dist.all_gather_into_tensor)
    return op(out, inp, group=group, async_op=async_op)


def barrier(group=None):
    dist.barrier(group=group)
