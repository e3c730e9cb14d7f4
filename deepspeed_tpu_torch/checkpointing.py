"""Activation checkpointing: upstream DeepSpeed's ``deepspeed.checkpointing``
API.

Port of deepspeed_tpu/checkpointing.py (the reference's
deepspeed_checkpointing.py). What each part maps to here:

  * recompute -> ``torch.utils.checkpoint.checkpoint(...,
    use_reentrant=False)``, which restores the default generators' states
    for the recompute, so dropout drawn from them repeats its masks; the
    tracker's named states are restored for the recompute too, as the
    reference's CheckpointFunction does.
  * RNG tracking -> :class:`RNGStatesTracker`: named ``torch.Generator``
    states of one device (the tracker's, ``"cuda"`` unless
    :func:`model_parallel_seed` is told otherwise). ``fork(name)`` runs its
    body on the named stream (the device's default generator is swapped
    to it and back) and advances the stream, as the reference's CUDA fork
    does.
  * ``cpu_checkpointing`` -> ``torch.autograd.graph.save_on_cpu(
    pin_memory=True)`` around the segment: the inputs the checkpoint keeps
    for its recompute wait in pinned host memory.
  * ``profile`` -> ``torch.profiler.record_function("ds_checkpoint_segment")``
    around each segment.
  * ``partition_activations`` -> a no-op at model-parallel size 1 (there
    is nothing to slice); above it each model rank keeps 1/mp of every
    saved input of a checkpointed segment (the first dim mp divides, as
    the JAX package shards it over the model axis) and the model group
    all-gathers the inputs before the recompute. As in Megatron, the
    inputs are activations of the replicated stream, the same on every
    rank of the model group; a rank's own tensors (its weight shards)
    reach the segment as its parameters, not as its arguments
    (:class:`_PartitionedCheckpoint`, the reference's
    ``partition_activations`` path of CheckpointFunction). The numbers
    are unchanged; the memory kept between the forward and the backward
    falls.
  * ``contiguous_memory_optimization`` / ``synchronize_checkpoint_boundary``
    -> accepted no-ops (PyTorch's caching allocator packs the buffers; a
    boundary sync would only stall the stream), with the reference's rule
    that contiguous checkpointing needs the number of checkpoints.

The training engine calls :func:`configure` with its parsed config, as
the JAX engine does.
"""

import contextlib

import torch

from .utils.logging import logger

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"

# module state mirroring the reference's globals
_CONFIGURED = False
_MPU = None
PARTITION_ACTIVATIONS = False
CPU_CHECKPOINT = False
CONTIGUOUS_CHECKPOINTING = False
SYNCHRONIZE = False
PROFILE_TIME = False
_NUM_LAYERS = -1


def _default_generator(device):
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        return torch.cuda.default_generators[index]
    return torch.default_generator


class RNGStatesTracker:
    """Named generator states of one device (the reference's
    CudaRNGStatesTracker). ``device`` None means ``"cuda"``, resolved at
    the first :meth:`add`."""

    def __init__(self, device=None):
        self.device = device
        self.states_ = {}
        self.seeds_ = set()

    def _device(self):
        from .utils.device import resolve_device

        self.device = resolve_device(self.device)
        return self.device

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def get_states(self):
        return {name: state.clone() for name, state in self.states_.items()}

    def set_states(self, states):
        self.states_ = {name: state.clone() for name, state in states.items()}

    def _state_of(self, seed):
        device = self._device()
        return torch.Generator(device=device).manual_seed(int(seed)).get_state()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already present")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"rng state {name} already present")
        self.states_[name] = self._state_of(seed)

    @contextlib.contextmanager
    def fork(self, name=_MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Run the body on the named stream: the device's default
        generator takes the stream's state (and is yielded), and the
        advanced state is kept for the next fork."""
        if name not in self.states_:
            raise KeyError(f"rng state {name} is not added")
        gen = _default_generator(self._device())
        outer = gen.get_state()
        gen.set_state(self.states_[name])
        try:
            yield gen
        finally:
            self.states_[name] = gen.get_state()
            gen.set_state(outer)


_RNG_TRACKER = RNGStatesTracker()


def get_rng_tracker():
    return _RNG_TRACKER


# the reference's name
get_cuda_rng_tracker = get_rng_tracker


def model_parallel_seed(seed, mpu=None, device=None):
    """Seed the default and model-parallel streams of this rank (the
    reference's ``model_parallel_cuda_manual_seed``): replicated regions
    share ``seed``; model-parallel regions get ``seed + 2718 +
    mp_rank``."""
    mpu = mpu if mpu is not None else _MPU
    mp_rank = mpu.get_model_parallel_rank() if mpu is not None else 0
    offset = seed + 2718
    model_parallel_seed_ = offset + mp_rank
    _RNG_TRACKER.reset()
    if device is not None:
        _RNG_TRACKER.device = device
    _RNG_TRACKER.states_["default"] = _RNG_TRACKER._state_of(seed)
    _RNG_TRACKER.seeds_.add(seed)
    _RNG_TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME, model_parallel_seed_)
    return _RNG_TRACKER


model_parallel_cuda_manual_seed = model_parallel_seed


def _model_parallel_size():
    if _MPU is None:
        return 1
    get = getattr(_MPU, "get_model_parallel_world_size", None)
    return int(get()) if get is not None else 1


def _partition_dim(t, mp):
    """The first dim of ``t`` that ``mp`` divides (None: keep it whole)."""
    for d in range(t.dim()):
        if t.shape[d] >= mp and t.shape[d] % mp == 0:
            return d
    return None


def _device_rng(tensors):
    """The CUDA device whose generator the segment draws from, if any."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            return t.device
    return None


class _PartitionedCheckpoint(torch.autograd.Function):
    """A checkpointed segment whose saved inputs are partitioned over the
    model group: the forward runs ``function`` without autograd and keeps
    this rank's 1/mp slice of each tensor input (along
    :func:`_partition_dim`); the backward all-gathers the inputs, replays
    the default generators' states of the forward, runs ``function``
    again with autograd and differentiates it."""

    @staticmethod
    def forward(ctx, function, mpu, *args):
        group = mpu.get_model_parallel_group()
        mp = int(mpu.get_model_parallel_world_size())
        rank = int(mpu.get_model_parallel_rank())
        ctx.function, ctx.group, ctx.mp = function, group, mp
        device = _device_rng(args)
        ctx.rng = (torch.get_rng_state(),
                   None if device is None else
                   (device, torch.cuda.get_rng_state(device)))
        with torch.no_grad():
            out = function(*args)
        ctx.layout, kept = [], []
        for a in args:
            if not isinstance(a, torch.Tensor):
                ctx.layout.append(("const", a))
                continue
            d = _partition_dim(a, mp)
            piece = (a.detach() if d is None
                     else a.detach().chunk(mp, d)[rank].clone())
            ctx.layout.append(("tensor", d, a.requires_grad))
            kept.append(piece)
        ctx.save_for_backward(*kept)
        return out

    @staticmethod
    def backward(ctx, *grads):
        from .runtime import dist as dist_lib

        kept = iter(ctx.saved_tensors)
        inputs = []
        for entry in ctx.layout:
            if entry[0] == "const":
                inputs.append(entry[1])
                continue
            _, d, wants_grad = entry
            piece = next(kept)
            if d is not None:
                buf = torch.empty((ctx.mp,) + tuple(piece.shape),
                                  dtype=piece.dtype, device=piece.device)
                dist_lib.all_gather(buf.view(-1),
                                    piece.contiguous().view(-1), ctx.group)
                piece = torch.cat(list(buf), dim=d)
            inputs.append(piece.detach().requires_grad_(wants_grad))
        cpu_state, dev = ctx.rng
        outer_cpu = torch.get_rng_state()
        outer_dev = None if dev is None else torch.cuda.get_rng_state(dev[0])
        torch.set_rng_state(cpu_state)
        if dev is not None:
            torch.cuda.set_rng_state(dev[1], dev[0])
        try:
            with torch.enable_grad():
                out = ctx.function(*inputs)
        finally:
            torch.set_rng_state(outer_cpu)
            if dev is not None:
                torch.cuda.set_rng_state(outer_dev, dev[0])
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if isinstance(o, torch.Tensor) and o.requires_grad
                 and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None, None, *[
            x.grad if isinstance(x, torch.Tensor) else None
            for x in inputs])


def checkpoint(function, *args):
    """Checkpoint ``function(*args)``: the result is returned, and under
    autograd the activations inside ``function`` are recomputed in the
    backward instead of kept. With ``partition_activations`` at a model
    axis above 1, the inputs kept for the recompute are partitioned over
    the model group (:class:`_PartitionedCheckpoint`)."""
    # the recompute runs on the tracker's states as they were at the
    # forward (a fork inside ``function`` repeats its stream), and leaves
    # them as it found them
    states = _RNG_TRACKER.get_states()
    ran = []

    def fn(*xs):
        if not ran:
            ran.append(True)
            return function(*xs)
        current = _RNG_TRACKER.get_states()
        _RNG_TRACKER.set_states(states)
        try:
            return function(*xs)
        finally:
            _RNG_TRACKER.set_states(current)

    if PROFILE_TIME:
        timed = fn

        def fn(*xs):
            with torch.profiler.record_function("ds_checkpoint_segment"):
                return timed(*xs)

    offload = (torch.autograd.graph.save_on_cpu(pin_memory=True)
               if CPU_CHECKPOINT else contextlib.nullcontext())
    with offload:
        if (PARTITION_ACTIVATIONS and _model_parallel_size() > 1
                and torch.is_grad_enabled()):
            return _PartitionedCheckpoint.apply(fn, _MPU, *args)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False)


def partition_activations_in_checkpoint(partition_activation):
    global PARTITION_ACTIVATIONS
    PARTITION_ACTIVATIONS = partition_activation
    logger.info("**************Partition Activations %s************",
                PARTITION_ACTIVATIONS)


def set_num_layers(nlayers):
    global _NUM_LAYERS
    _NUM_LAYERS = nlayers


def reset():
    """Per-iteration reset (the reference frees its contiguous buffers
    here). Nothing is kept between iterations; the RNG tracker survives,
    as in the reference."""


def configure(
    mpu_=None,
    deepspeed_config=None,
    partition_activations=None,
    contiguous_checkpointing=None,
    num_checkpoints=None,
    checkpoint_in_cpu=None,
    synchronize=None,
    profile=None,
):
    """Configure the module's flags from a DeepSpeedConfig and/or explicit
    arguments (explicit arguments win)."""
    global _CONFIGURED, _MPU, PARTITION_ACTIVATIONS, CPU_CHECKPOINT
    global CONTIGUOUS_CHECKPOINTING, SYNCHRONIZE, PROFILE_TIME, _NUM_LAYERS

    _MPU = mpu_
    acfg = None
    if deepspeed_config is not None:
        acfg = getattr(
            deepspeed_config, "activation_checkpointing_config", None
        )
    if acfg is not None:
        PARTITION_ACTIVATIONS = acfg.partition_activations
        CONTIGUOUS_CHECKPOINTING = acfg.contiguous_memory_optimization
        CPU_CHECKPOINT = acfg.cpu_checkpointing
        SYNCHRONIZE = acfg.synchronize_checkpoint_boundary
        PROFILE_TIME = acfg.profile
        if acfg.number_checkpoints is not None:
            _NUM_LAYERS = acfg.number_checkpoints
    if partition_activations is not None:
        PARTITION_ACTIVATIONS = partition_activations
    if contiguous_checkpointing is not None:
        CONTIGUOUS_CHECKPOINTING = contiguous_checkpointing
    if num_checkpoints is not None:
        _NUM_LAYERS = num_checkpoints
    if checkpoint_in_cpu is not None:
        CPU_CHECKPOINT = checkpoint_in_cpu
    if synchronize is not None:
        SYNCHRONIZE = synchronize
    if profile is not None:
        PROFILE_TIME = profile

    if CONTIGUOUS_CHECKPOINTING and not (
            _NUM_LAYERS is not None and _NUM_LAYERS > 0):
        # the JAX package's (and the reference's) error type
        raise AssertionError(
            "must specify the number of checkpoints with contiguous memory "
            "optimization"
        )
    _CONFIGURED = True


def is_configured():
    return _CONFIGURED


def see_memory_usage(message, force=False, device=None):
    """Device-memory snapshot (the reference's allocator stats)."""
    if not force:
        return
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return
    logger.info(
        "%s | allocated=%.2fGB peak=%.2fGB reserved=%.2fGB",
        message, torch.cuda.memory_allocated(device) / 2**30,
        torch.cuda.max_memory_allocated(device) / 2**30,
        torch.cuda.memory_reserved(device) / 2**30,
    )
