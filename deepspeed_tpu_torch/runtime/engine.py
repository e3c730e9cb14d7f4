"""DeepSpeedEngine: the training engine, on one device or data parallel.

Port of deepspeed_tpu/runtime/engine.py, with the reference's contract:

    engine, optimizer, _, scheduler = deepspeed_tpu_torch.initialize(...)
    loss = engine(batch)        # forward
    engine.backward(loss)       # accumulate gradients
    engine.step()               # optimizer step at the accumulation boundary

or ``engine.train_batch(batches)`` for one whole window.

What a step does, as in the JAX engine:
  - the module's parameters are the fp32 masters; each micro-step casts
    them to the compute dtype (fp32, bf16 or fp16: real float16 on every
    device; the JAX engine's bf16 stand-in for fp16 is a TPU rule), and the
    loss is differentiated with respect to those casts
    (``torch.func.functional_call``), scaled by ``loss_scale / accum``;
  - gradients accumulate in ``data_types.grad_accum_dtype``;
  - at the boundary: the global gradient norm, the overflow test (fp16:
    an inf/nan scan; bf16/fp32: the norm's -1 sentinel), unscale and clip
    folded into one ``grad_scale`` for the optimizer, or the skip,
    counted in ``skipped_steps``; then ``update_scale`` and the LR
    schedule.

There is no ``jit``: ``train_batch`` is a loop of forward/backward and
one step, and the step reads its overflow decision on the host at once
(the JAX engine defers it a window for bf16/fp32), so ``global_steps``
and ``skipped_steps`` are exact after every step. Parameters, moments
and the optimizer's scratch are updated in place.

LoRA fine-tune (the ``adapters`` block): the base is frozen once in the
compute dtype (no gradients, no optimizer state, no per-micro-step
cast); only the ``*_lora_*`` factors are fp32 masters, differentiated
and stepped; :meth:`DeepSpeedEngine.adapter_state_dict` hands them to a
serving engine's ``load_adapter``.

Observability, as in the JAX engine: ``tensorboard`` writes the
``Train/*`` scalars (utils/monitor.py) at each applied step;
``wall_clock_breakdown`` times forward, backward and step (and a
``train_batch`` window) with CUDA events (utils/timers.py) and logs them
every ``steps_per_print`` steps; ``memory_breakdown`` logs the device's
allocated and peak bytes there; the ``telemetry`` block
(telemetry/manager.py) feeds the ``train/*`` catalog, its exporters, the
profiler window, the watchdog and the tracer from the window hooks. The
micro-step loop of ``train_batch`` runs inside a ``window_fwd_bwd``
profiler range and the update inside ``window_optimizer_update``, the
names of the JAX engine's ``named_scope``s. None of it adds a host sync:
the step's one sync also carries the window loss when the monitor
needs it, the timers read their events only when they log, and the
telemetry settles device values only at its export boundaries.

Checkpoints and resilience, as in the JAX engine (runtime/checkpointing.py,
resilience/): ``save_checkpoint`` / ``load_checkpoint`` write and read the
``.pt`` layout under the atomic commit protocol (manifest last, ``latest``
published after re-verification, retention GC after the publish) and
restore in place, the dropout-seed generator included, so a resumed run
continues bit for bit. The ``resilience`` block arms the retry policy,
``keep_last_n``, the preemption drain (SIGTERM/SIGINT save at the next
step boundary), fault injection at the JAX engine's seams (``grads.nan``
and ``staging.device_put`` at a ``train_batch`` window's placement,
``checkpoint.write``/``read`` in the blob I/O, ``step.stall`` at the step
boundary) and the run supervisor: ``train_batch`` becomes its retry loop,
which rolls back to the last committed checkpoint on a non-finite or
spiking window, a watchdog stall or a recoverable window failure. Under
the adapters block a checkpoint holds only the LoRA factors and their
moments, with the adapter geometry in ``client_state["adapters"]``.

The data path, as in the JAX engine: ``training_data`` builds a
:class:`~.dataloader.DeepSpeedDataLoader` (``deepspeed_io``; pinned CPU
batches on a CUDA device), which ``initialize()`` returns third. The
``data_pipeline`` block stages ``train_batch`` windows from a persistent
iterator on a background worker (runtime/staging.py): window N+1 is pulled
and copied to the card on a copy stream while window N computes, with the
dropout seeds pre-drawn in the unstaged order, so a staged run equals an
unstaged one bit for bit (losses, parameters and the seed generator). At
one micro-batch a window the loader stages itself. ``close_data_pipeline``
stops every worker; the preemption drain and a supervisor's rollback call
it. The ``compile_cache`` block points the kernel build cache
(runtime/compile_cache.py), and ``activation_checkpointing`` configures
the activation API (checkpointing.py). A model with ``remat`` checkpoints
its blocks (ops/transformer.py).

Optimizers and state layouts, as in the JAX engine: Adam, AdamW, Lamb,
FusedLamb, SGD and Lion (ops/optimizers.py); ``data_types.
optimizer_state_dtype`` stores Adam's and Lamb's moments as bf16 or int8
(ops/quant.py); ``data_types.master_dtype = "compensated"`` keeps the
parameters in the compute dtype with int8 Kahan codes in place of fp32
masters; ``zero_optimization.offload_optimizer`` keeps the fp32 masters
and the optimizer state in pinned host memory: at the boundary the
gradients are copied to the host (queued before the step's one sync),
the overflow test and the norm run on the device as on the on-device
path, the update runs on the host, and the new compute-dtype parameters
are copied back only after a step that was taken. ``train_batch`` then
bypasses the window stager, as the JAX engine does.

Data parallel across processes (one rank per device, runtime/dist.py;
the process mesh of parallel/mesh.py, a ``mesh`` argument or config
block whose only axis above 1 is data): each rank feeds its own rows of
the global batch, and the loss and the update are the global batch's,
as the JAX engine's on a mesh of the same data size. ZeRO (runtime/
zero.py): stage 0 all-reduces the gradients at the boundary; from stage
1 the fp32 masters and the optimizer state exist only for this rank's
shards (outside fp32 the module holds compute-dtype parameters), the
gradients are reduce-scattered to the shards and the new parameters
all-gathered after the update; at stage 2 every gradient is
reduce-scattered into the shard buffer as soon as the backward produces
it (a hook on each parameter) and freed; at stage 3 the parameters
persist as shards and the model gathers them a block of layers at a time
(models/stack.py). Every rank takes the same decision at the boundary:
the global norm and the fp16 overflow flag are reduced over the data
group, LAMB's per-group norms too. The model's losses divide by the data
group's label count (BERT's differs between ranks) and its dropout draws
are offset by the data rank. ``sparse_gradients`` routes the embedding
tables' gradients through the CSR all-gather of runtime/sparse.py. At
world size 1 every stage is stage 0, as in the JAX engine.

Compensated masters at data parallel > 1 keep the compute-dtype
parameters replicated at stages 0-2 (sharded at stage 3) and their int8
codes in the sharded optimizer state, as the moments; the adapters block
at data parallel > 1 keeps its frozen base replicated, and only the LoRA
factors go through the ZeRO layout, the gradient reduction and the
checkpoints (at stage 3 the layer-wise gather is not armed, as in the
JAX engine: the factors are gathered at the forward). The adapters block
takes optimizer offload and compensated masters, which then hold only
the factors.

Tensor parallelism (a ``model_parallel_size`` above 1, with
``param_specs``, GPT-2's ``models.partition_specs``): the engine cuts
every parameter to this rank's Megatron shard (parallel/tensor.py) and
arms the model's ``configure_model_parallel``; ZeRO then runs over the
data group on the model-local tensors, the data axis on a dim the model
axis left free, as the JAX rule composes them. Every decision is the
world's: the global norm sums the model-sharded tensors over the model
group and counts each replicated one once, the fp16 overflow flag, LAMB's
per-group norms and the drain flag reduce over every rank; the window
loss is the data group's mean. Without ``param_specs`` the model is
replicated over the model axis (the JAX engine's leaves without a spec):
each model rank computes the whole step on its data rank's rows. With
int8 moments the optimizer steps whole (model-gathered) tensors, as the
JAX engine keeps its flat int8 leaves replicated over the model axis
(at ZeRO stage 3 each rank steps its data shard of them).

Sequence parallelism (a ``sequence_parallel_size`` above 1, GPT-2 and
BERT's task models): the
ranks of a sequence line read the same rows (the data rank's) and each
keeps its chunk of the tokens (dim 1 of every input, cut in sequence
order, as the JAX engine's sequence-sharded batch); the model arms
:meth:`~deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel.configure_sequence_parallel`
(ring or Ulysses attention, the loss over the whole sequence). Every
parameter is replicated over the sequence axis, so each window's
gradients are summed over the sequence group once, after the data
group's reduction (ZeRO's shards are the same on every rank of a line:
ZeRO partitions over the data axis only); the world norms count a
sequence line once; the optimizer state (bf16 or int8 moments,
compensated masters included) steps the summed gradients, the same on
every rank of a line; under the adapters block only the LoRA factors'
gradients are summed; ``sparse_gradients`` reduces the lookup's CSR
pairs over the data group first, as at a sequence axis of 1; offload's
host masters step the line's sum. A model without the sequence seam
(``configure_sequence_parallel``) is replicated over the sequence axis,
as the JAX engine runs it; so is a model without stages over a pipe
axis.

Multi-output models (the JAX engine's contract): a forward that returns
a tuple trains on element 0, and ``last_aux`` holds the rest: the raw
aux of the last micro-step between ``forward()`` and ``step()``, after a
step the window's aux stacked ``[accum, ...]`` (both ``forward/backward/
step`` and ``train_batch``), and in eval the raw aux; at data parallel
> 1 each value is the data group's mean, as the loss is.

Mixture-of-Experts (GPT-2 with ``moe_experts``, ops/moe.py): the experts
shard over the data axis (each data rank keeps ``E / dp`` of every
block's experts, the model's ``configure_expert_parallel``), and tokens
reach them through an all-to-all over the data group. An expert leaf's
gradient arrives whole from that all-to-all's backward, with the dense
leaves' scaling, so it is never reduced over the data group and ZeRO does
not partition it again (runtime/zero.py's ``local`` leaves); the router
and the dense leaves are reduced as ever. The world norms count each
rank's experts, and LAMB's ``h.*.moe.expert_*`` group sums its norms over
the data ranks, one JAX leaf. At ZeRO stage 3 the layer-wise gather is
not armed (the JAX engine disarms it for MoE too): every sharded dense
tensor is gathered at the forward, and the experts stay whole on their
rank. At a model axis above 1 the attention is Megatron-sharded and the
experts are not (the JAX layer shards only the expert dim): each model
rank routes every token of its data rank. bf16 moments and compensated
masters step the experts as any leaf. int8 moments keep each
``h.*.moe.expert_*`` group on the JAX leaf's block grid: a rank holds its
experts' runs of the whole leaf, and a block that holds elements of two
ranks takes the max of their absmax (ops/quant.py:BlockMap); at ZeRO
stage 1 and above the rank's runs are its int8 leaf, never reduced over
the data group, while the dense groups shard as without experts. At a
sequence axis above 1 each MoE layer
gathers its rows over the line and routes them whole, as the JAX layer
routes the global row (ops/moe.py). The adapters
block is refused with the reason: the JAX MoE blocks run without their
factors.

Pipeline parallelism (a ``pipeline_parallel_size`` above 1, GPT-2 with
``pipeline_stages`` of that size): each pipe rank keeps its stage's
blocks (the model's ``configure_pipeline``) and runs them in the GPipe
schedule of parallel/pipeline.py. Every stage reads the same rows (its
data rank's) and returns the same loss. The embeddings and ``ln_f`` are
on every stage: their gradients are summed over the pipe group once a
window, after the data group's reduction, so every stage applies one
update. The overflow skip, the clipping norm, LAMB's group norms (a
``h.*`` group spans the stages) and the drain flag are the world's, each
tensor counted once. The microbatches split the global batch (a rank's
rows times the data size), as the JAX model's do: a data rank runs its
share of each, or the whole ones its rows hold (models/gpt2.py:
pipeline_plan). At ZeRO stage 3 the layer-wise gather is not armed (the
JAX engine disarms it with stages): every sharded tensor is gathered at
the forward. A model axis composes (the pipe group is a (data, model)
coordinate's stages). ``sparse_gradients`` reduces stage 0's lookup
over its data group. int8 moments keep each ``h.*`` group on the JAX
leaf's block grid, as with experts (a block straddling two stages takes
the max of their absmax); at ZeRO stage 1 and above each data rank of a
stage holds its contiguous ``1/dp`` of the stage's blocks, as the JAX
engine cuts its flat leaves over the data axis. The adapters block is
refused with the reason:
the JAX pipelined stack runs the blocks without their factors.

Optimizer offload at data parallel > 1 is refused with the JAX engine's
message.
"""

import functools
import inspect
import weakref
from collections.abc import Mapping

import numpy as np
import torch
from torch.func import functional_call

from ..adapters import lora as lora_lib
from ..config import constants as C
from ..config.config import DeepSpeedConfig, DeepSpeedConfigError
from ..config.config_utils import load_config_json
from ..ops.head_dims import check_head_dim, model_head_dim, model_max_positions
from ..models.gpt2 import GPT2LMHeadModel
from ..models.gpt2 import partition_specs as gpt2_partition_specs
from ..models.stack import BLOCK_TENSORS, Zero3Arming, gather_tensors
from ..ops import quant as quant_lib
from ..ops.optimizers import Optimizer, build_optimizer, param_groups
from ..ops.transformer import resolve_remat_policy
from ..parallel import tensor as tp_lib
from ..parallel.mesh import DATA_AXIS, ProcessMesh, mesh_from_config
from ..parallel.pipeline import pipeline_line
from ..parallel.sequence import SequenceParallel, sequence_line
from ..parallel.mpu import as_mpu
from ..resilience import SupervisorEscalation, build_resilience
from ..resilience.supervisor import build_supervisor
from ..telemetry.manager import build_telemetry
from ..utils.device import resolve_device
from ..utils.logging import log_dist, warn_once
from ..utils.monitor import Monitor
from ..utils.numerics import global_norm, has_overflow
from ..utils.timers import (
    SynchronizedWallClockTimer,
    ThroughputTimer,
    device_fence,
)
from . import dist as dist_lib
from .compile_cache import configure_compile_cache
from .dataloader import DeepSpeedDataLoader
from .lr_schedules import build_lr_scheduler
from .precision import loss_scale_state_from_config, update_scale
from .staging import WindowStager, ragged_window_error
from .zero import (
    ZERO_OPTIMIZATION_GRADIENTS,
    ZERO_OPTIMIZATION_OPTIMIZER_STATES,
    ZERO_OPTIMIZATION_WEIGHTS,
    ZeroLayout,
)

# the JAX engine's timer names
FORWARD_TIMER = "forward"
BACKWARD_TIMER = "backward"
STEP_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch_window"


def _poison_first_float_leaf(batch):
    """Fault site ``grads.nan`` (resilience/faults.py): NaN-multiply the
    micro-batch's first floating input so its loss AND gradients go
    non-finite through the production path. Integer-only batches (token
    ids) have nothing poisonable; the fault then fires as a no-op, warned
    once, as in the JAX engine."""
    out = list(batch)
    for i, x in enumerate(out):
        if isinstance(x, torch.Tensor):
            floating = x.is_floating_point()
        else:
            floating = np.issubdtype(np.asarray(x).dtype, np.floating)
        if floating:
            out[i] = torch.as_tensor(x) * float("nan")
            return tuple(out)
    warn_once(
        "grads-nan-no-float-leaf",
        "fault site 'grads.nan' fired but the batch has no floating leaf "
        "to poison — the injected fault had no effect",
    )
    return tuple(out)


def _split_model_output(out):
    """Multi-output contract: a tuple return trains on element 0; the
    rest ride along as aux."""
    if isinstance(out, (tuple, list)):
        return out[0], tuple(out[1:])
    return out, ()


def _draw_seed(gen):
    """One micro-step's dropout seed from the engine's generator."""
    return int(torch.randint(0, 2**31 - 1, (), generator=gen))


def _split_window_keys(gen, accum):
    """One window's seed draws: ``(gen, [accum] seeds)``. The single
    authority for the window stager's pre-draw (runtime/staging.py),
    which must draw exactly what the unstaged micro-steps draw."""
    return gen, [_draw_seed(gen) for _ in range(accum)]


class EngineOptimizerFacade:
    """What ``initialize()`` returns as ``optimizer``: the reference's
    optimizer duck-type (loss_scale, overflow, lamb_coeffs) backed by
    engine state."""

    def __init__(self, engine):
        self._engine = engine

    @property
    def loss_scale(self):
        return float(self._engine.loss_scale_state.loss_scale)

    @property
    def cur_scale(self):
        return self.loss_scale

    @property
    def overflow(self):
        return self._engine.last_overflow

    def get_lamb_coeffs(self):
        return self._engine.lamb_coeffs

    @property
    def state(self):
        return self._engine.optimizer_state

    def zero_grad(self):
        self._engine.zero_grad()


class DeepSpeedEngine:
    def __init__(self, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, config_params=None,
                 mesh=None, rng_seed=0, device=None, args=None,
                 collate_fn=None, mpu=None, dist_init_required=None,
                 param_specs=None):
        # ---- config ---------------------------------------------------
        raw = config_params
        if raw is None and args is not None:
            # the launcher's flag, or its deprecated alias
            raw = (getattr(args, C.DEEPSPEED_CONFIG_ARG, None)
                   or getattr(args, C.DEEPSCALE_CONFIG_ARG, None))
        if isinstance(raw, str):
            raw = load_config_json(raw)
        raw = dict(raw or {})
        # what the card's kernels cannot take is refused here, not mid-step
        mcfg = getattr(model, "config", None)
        check_head_dim(model_head_dim(mcfg), model_max_positions(mcfg),
                       device)
        self.device = resolve_device(device)
        # ---- data parallel: the process group, then the mesh (its data
        # size is the batch triangle's world size) ------------------------
        dist_lib.init_distributed(dist_init_required, device=self.device)
        if mesh is None:
            mesh = mesh_from_config(raw.get(C.MESH) or {})
        elif not isinstance(mesh, ProcessMesh):
            raise DeepSpeedConfigError(
                f"training over a {type(mesh).__name__} mesh: the port runs "
                "one process a rank and takes a deepspeed_tpu_torch.parallel."
                "ProcessMesh (build_mesh, or the config's mesh block); the "
                "JAX engine's jax.sharding.Mesh lays one process's arrays "
                "over its devices, which has no counterpart here")
        self.mesh = mesh
        self.mpu = as_mpu(mpu, mesh)
        self.dp_world_size = mesh.dp_size
        self.data_rank = mesh.data_rank
        self._dp_group = mesh.data_group
        self.mp_world_size = mesh.mp_size
        self.model_rank = mesh.model_rank
        self._mp_group = mesh.model_group
        self.seq_rank = mesh.seq_rank
        self.pp_world_size = mesh.pp_size
        self.pipe_rank = mesh.pipe_rank
        self._pipe = pipeline_line(mesh)
        self._world_group = mesh.world_group
        self.config = DeepSpeedConfig(None, param_dict=raw, training=True,
                                      world_size=self.dp_world_size)
        cfg = self.config
        # the kernel build cache, before anything builds (a no-op unless
        # the block enables it)
        configure_compile_cache(cfg)
        # the activation API's flags (checkpointing.py), as the JAX engine
        # sets them
        from .. import checkpointing as act_ckpt

        act_ckpt.configure(self.mpu if self.mp_world_size > 1 else None,
                           deepspeed_config=cfg)

        # ---- model ----------------------------------------------------
        if not isinstance(model, torch.nn.Module):
            raise TypeError("model must be a torch.nn.Module whose forward "
                            "returns the scalar loss")
        policy = getattr(mcfg, "remat_policy", "full")
        if getattr(mcfg, "remat", False) and policy != "full":
            # a typo or a policy the port cannot map fails here, not in
            # the first backward
            resolve_remat_policy(policy)
        self.module = model.to(device=self.device, dtype=torch.float32)
        if model_parameters is not None and not isinstance(
            model_parameters, Mapping
        ):
            raise TypeError("model_parameters must be None or a state "
                            "dict for the model")
        if model_parameters is not None and not cfg.adapters_enabled:
            self.module.load_state_dict(model_parameters)
        sig = inspect.signature(self.module.forward).parameters
        self._takes_train = "train" in sig
        self._takes_seed = "dropout_seed" in sig

        # ---- precision ------------------------------------------------
        if cfg.fp16_enabled:
            self.compute_dtype = torch.float16
        elif cfg.bf16_enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        self.grad_accum_dtype = (
            torch.float32 if cfg.grad_accum_dtype == "fp32"
            else self.compute_dtype
        )
        self.loss_scale_state = loss_scale_state_from_config(cfg)
        self.zero_stage = cfg.zero_optimization_stage
        # int8 moments: the client optimizer's storage, else the config's
        self._int8_moments = (
            getattr(optimizer, "state_dtype", "fp32") if optimizer is not None
            else cfg.optimizer_state_dtype) == "int8"
        # the masters' layout, by the JAX engine's rules. Compensated
        # masters (data_types.master_dtype): the parameters stored in the
        # compute dtype with an int8 rounding-error code each in the
        # optimizer state, no float32 master and no cast copies. Optimizer
        # offload (zero_optimization.offload_optimizer): the float32
        # masters and the optimizer state in pinned host memory, the
        # compute-dtype parameters on the device.
        self.compensated_master = (
            cfg.master_dtype == "compensated"
            and self.compute_dtype != torch.float32
        )
        self.host_offload = (
            cfg.zero_config.offload_optimizer_device == "cpu")
        if self.host_offload and self.compensated_master:
            raise DeepSpeedConfigError(
                "offload_optimizer and master_dtype='compensated' are "
                "alternative memory strategies — pick one (docs/memory.md)"
            )
        if self.dp_world_size > 1:
            if self.host_offload:
                # the JAX engine's refusal of offload on a multi-process mesh
                raise DeepSpeedConfigError(
                    "offload_optimizer requires a single-process mesh; on "
                    "multi-host pods use ZeRO sharding (stage>=1 divides "
                    "optimizer state by dp) or "
                    "data_types.master_dtype='compensated' instead"
                )
        self.frozen_base_params = {}
        self._refuse_with_stages_or_experts()
        if cfg.adapters_enabled:
            self._configure_adapters(model_parameters, rng_seed)
        # tensor parallelism: this rank's Megatron shards (None: the model
        # is whole on every rank)
        self._tp = None
        self._sp_line = None
        self._model_dims = {}
        self._tp_full_opt = False
        self._full_masters = None
        # the names of every trainable tensor before the pipeline keeps
        # this stage's (the checkpoints' global form)
        self._expert_names = frozenset()
        self._pipe_shared = ()
        self._global_names = tuple(n for n, _ in self.module.named_parameters())
        self._global_shapes = {n: tuple(p.shape)
                               for n, p in self.module.named_parameters()}
        self._configure_pipeline_and_experts()
        self._configure_model_parallel(param_specs)
        self._configure_sequence_parallel()
        if self.compensated_master:
            self.module.to(dtype=self.compute_dtype)

        # ---- optimizer and schedule -------------------------------------
        # the trainable masters: every parameter, or under the adapters
        # block only the LoRA factors (float32 on the device; in the
        # compute dtype when compensated; with offload, float32 copies in
        # pinned host memory while the module holds the compute dtype)
        self.params = self._trainable_module_params()
        # the module's compute-dtype parameters beside host masters, and
        # the pinned buffers of the step's copies (offload on the card)
        self._compute_params = None
        self._host_grads = self._host_out = None
        self._n_params = sum(
            p.numel() for p in self.module.parameters())
        if self._tp_full_opt:
            self._model_full_masters()
        if self.host_offload:
            # after the model gather: the host masters and moments hold
            # the model-gathered tensors of int8 moments at mp > 1
            self._offload_masters()
        # ZeRO's layout over the data group (None in one process) and the
        # gradient shards of a window
        self._zero = None
        self._shard_store = None
        # the optimizer leaves that are the module's tensors themselves,
        # and at stage 3 those cut from its shards at each update
        self._masters_alias = self._cut_masters = frozenset()
        self.zero3_gather_enabled = False
        self._zero3_shard_bytes = self._zero3_gather_bytes = 0
        self._engine_gather = None
        self._quant_maps = self._int8_block_maps()
        if self.dp_world_size > 1:
            self._shard_over_data()
        elif hasattr(self.module, "configure_data_parallel"):
            # one process: the model's defaults, whatever an earlier
            # data-parallel engine set on it
            self.module.configure_data_parallel()
        # the tensors each rank leaves out of a norm (another rank counts
        # them), when the norms are the world's
        self._norm_skip = self._norm_skip_set()
        self.optimizer_obj = self._configure_optimizer(optimizer)
        if self._quant_maps:
            self.optimizer_obj.quant_maps = self._quant_maps
        masters = self._masters()
        self.optimizer_state = self.optimizer_obj.init(masters)
        if self.host_offload:
            self.optimizer_state = self._pinned(self.optimizer_state)
        self._n_groups = len(param_groups(masters))
        del masters
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is None and cfg.scheduler_name is not None:
            self.lr_scheduler = build_lr_scheduler(
                cfg.scheduler_name, cfg.scheduler_params
            )
        self._base_lr = float(cfg.optimizer_params.get("lr", 1e-3))
        self._use_mom = self.optimizer_obj.supports_mom
        if (not self._use_mom and self.lr_scheduler is not None
                and getattr(self.lr_scheduler, "get_mom", lambda: None)()
                is not None):
            log_dist(
                "WARNING: the LR scheduler cycles momentum but optimizer "
                f"{type(self.optimizer_obj).__name__} takes no per-step "
                "coefficient (use 'Lamb' or 'Adam'); momentum cycling is "
                "ignored", ranks=[0],
            )

        # ---- state ----------------------------------------------------
        # the multi-output contract's extra outputs
        self.last_aux = ()
        self._window_aux = []
        self._rng = torch.Generator().manual_seed(int(rng_seed))
        self._grad_buffer = None
        # the accumulation buffer kept across windows when the gradients
        # are cast into it (compute dtype != accumulation dtype)
        self._grad_store = None
        self._pending = None  # (loss, compute-dtype params, aux) of a forward
        self._window_losses = []  # the window's unscaled losses (device)
        self._last_window_loss = None
        self.micro_steps = 0
        self.global_steps = 0
        self.skipped_steps = 0
        self.last_overflow = False
        self.lamb_coeffs = torch.zeros(0)
        self._training = True
        # the seeds of a staged window's micro-steps, pre-drawn by the
        # stager (consumed by _call in order)
        self._window_seeds = []

        # ---- observability ---------------------------------------------
        # the rank-0 Train/* scalar stream (the tensorboard block)
        self.monitor = Monitor(
            enabled=cfg.tensorboard_enabled,
            output_path=cfg.tensorboard_output_path,
            job_name=cfg.tensorboard_job_name,
        )
        self.wall_clock_breakdown = cfg.wall_clock_breakdown
        self.memory_breakdown = cfg.memory_breakdown
        self.timers = SynchronizedWallClockTimer(device=self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=cfg.train_micro_batch_size_per_gpu
            * cfg.gradient_accumulation_steps,
            num_workers=self.dp_world_size,
            steps_per_output=cfg.steps_per_print,
            fence_fn=device_fence(self.device),
        )
        self._tb_windows = 0  # train_batch windows since the last print
        self._window_timed = False  # a train_batch window timer runs
        self._window_open = False  # the telemetry's window has started
        # the telemetry block: a no-op facade when it is absent
        self.telemetry = build_telemetry(
            cfg, rank=self.mesh.rank, n_params=self._n_params,
            timers=self.timers, fence_fn=device_fence(self.device),
            device=self.device,
        )
        if self._zero3_shard_bytes or self._zero3_gather_bytes:
            # static stage-3 layout gauges: what the dp sharding buys per
            # rank and what each window pays in gather traffic for it
            self.telemetry.set_zero3_layout(self._zero3_shard_bytes,
                                            self._zero3_gather_bytes)

        # ---- resilience (docs/resilience.md) ---------------------------
        # the commit protocol's policy, handed to the checkpoint paths; its
        # metrics share the telemetry registry when there is one
        self.resilience = build_resilience(cfg, telemetry=self.telemetry)
        # SIGTERM/SIGINT arm a save-at-next-step-boundary flag checked in
        # _finish_step (no-op unless the config enables the drain)
        self.resilience.install_preemption()
        # the drain's default save target when the config names none: the
        # last directory this engine saved to or resumed from
        self._last_checkpoint_dir = None
        # NULL unless the config armed sites: consulted at a window's
        # placement, at the step boundary and in the checkpoint I/O
        self.faults = self.resilience.faults
        # the run supervisor: None unless the config enables it
        self.supervisor = build_supervisor(
            cfg,
            registry=(self.telemetry.registry if self.telemetry.enabled
                      else self.resilience.registry),
            tracer=self.telemetry.tracer,
            trace_ctx_fn=self.telemetry.train_trace_ctx,
        )
        # set by _finish_step when the supervisor discarded this window's
        # timeline (the supervised train_batch loop re-runs the window)
        self._window_rolled_back = False
        self._last_grad_norm = None
        if (self.supervisor is not None
                and getattr(self.telemetry, "watchdog", None) is not None):
            # a watchdog stall report arms a rollback at the next boundary
            self.telemetry.watchdog.add_stall_listener(
                self.supervisor.notify_stall)

        # ---- input staging (runtime/staging.py) ------------------------
        # made at the first iterator-fed train_batch, torn down on a source
        # change, exhaustion, the preemption drain or a rollback
        self._staging_enabled = cfg.data_pipeline_enabled
        self._staging_buffers = cfg.data_pipeline_staging_buffers
        self._stage_to_device = cfg.data_pipeline_stage_to_device
        self._stager = None
        self._stager_source = None
        self._stager_finalizer = None
        # consecutive source replacements whose stager served <= 1
        # window: the mark of a fresh iterator per call (_ensure_stager)
        self._stager_churn = 0
        self._last_unstaged_source = None
        # loaders built by deepspeed_io, weakly held: close_data_pipeline
        # reaches their staging workers too
        self._data_loaders = []
        self.collate_fn = collate_fn
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)
        log_dist(
            f"DeepSpeedEngine initialized: device={self.device} "
            f"dp={self.dp_world_size} mp={self.mp_world_size} "
            f"pp={self.pp_world_size} "
            f"zero_stage={self.zero_stage} "
            f"dtype={self.compute_dtype} "
            f"optimizer={type(self.optimizer_obj).__name__}", ranks=[0],
        )

    # ------------------------------------------------------------------
    # configuration accessors (reference API surface)
    # ------------------------------------------------------------------
    def train_batch_size(self):
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def steps_per_print(self):
        return self.config.steps_per_print

    def gradient_clipping(self):
        return self.config.gradient_clipping

    def fp16_enabled(self):
        return self.config.fp16_enabled

    def bfloat16_enabled(self):
        return self.config.bf16_enabled

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() == 0

    def train(self, mode=True):
        self._training = mode

    def eval(self):
        self._training = False

    def get_lr(self):
        return [self._current_lr()]

    def _current_lr(self):
        if self.lr_scheduler is None:
            return self._base_lr
        lr = self.lr_scheduler.get_lr()
        return float(lr[0] if isinstance(lr, (list, tuple)) else lr)

    def _current_mom(self):
        """OneCycle's cycled momentum when the schedule has one, else the
        optimizer's own coefficient (``b1``, or SGD's ``momentum``)."""
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                     "get_mom"):
            mom = self.lr_scheduler.get_mom()
            if mom is not None:
                return float(mom[0] if isinstance(mom, (list, tuple)) else mom)
        opt = self.optimizer_obj
        if hasattr(opt, "b1"):
            return float(opt.b1)
        return float(getattr(opt, "momentum", 0.0))

    def _check_zero_optimizer_tested(self, name):
        """ZeRO with an optimizer outside the tested set needs the
        ``zero_allow_untested_optimizer`` opt-in, as in the JAX engine."""
        if (self.zero_stage < 1 or name in C.ZERO_TESTED_OPTIMIZERS
                or name in C.FUSED_LAMB_OPTIMIZERS):
            return
        if not self.config.zero_allow_untested_optimizer:
            raise DeepSpeedConfigError(
                f"optimizer {name!r} is untested with ZeRO (sharded "
                "optimizer-state specs are derived per optimizer). Add "
                f'{{"{C.ZERO_ALLOW_UNTESTED_OPTIMIZER}": true}} to the '
                "config to proceed anyway."
            )
        log_dist(
            f"WARNING: running ZeRO with untested optimizer {name!r} "
            f"({C.ZERO_ALLOW_UNTESTED_OPTIMIZER}=true) — proceed with "
            "caution", ranks=[0],
        )

    def _configure_optimizer(self, client):
        """The client optimizer, or the config's with its state layout:
        ``optimizer_state_dtype`` for the optimizers that store moments
        (Adam, AdamW, Lamb; FusedLamb's kernel reads float32 moments) and
        compensation for Adam/AdamW under compensated masters. The JAX
        engine's checks and messages."""
        if client is not None:
            if not isinstance(client, Optimizer):
                raise TypeError("client optimizer must be a "
                                "deepspeed_tpu_torch.ops.optimizers.Optimizer")
            self._check_zero_optimizer_tested(type(client).__name__.lower())
            self._apply_zero_state_policies(client)
            return client
        cfg = self.config
        name = cfg.optimizer_name or C.ADAM_OPTIMIZER
        self._check_zero_optimizer_tested(name)
        opt = build_optimizer(name, cfg.optimizer_params)
        sd = cfg.optimizer_state_dtype
        if sd != "fp32":
            if not hasattr(opt, "state_dtype"):
                raise DeepSpeedConfigError(
                    f"optimizer {name!r} does not support "
                    f"{C.OPTIMIZER_STATE_DTYPE}={sd!r} (Adam/AdamW/Lamb do)"
                )
            if type(opt).__name__ == "FusedLamb":
                raise DeepSpeedConfigError(
                    "FusedLamb's Pallas kernel reads fp32 moments; use "
                    "optimizer type 'Lamb' with reduced "
                    f"{C.OPTIMIZER_STATE_DTYPE}"
                )
            opt.state_dtype = sd
            log_dist(f"optimizer moments stored as {sd} (fp32 update math; "
                     "ops/quant.py)", ranks=[0])
        if self.compensated_master:
            if not hasattr(opt, "master_compensation"):
                raise DeepSpeedConfigError(
                    f"optimizer {name!r} does not support "
                    f"{C.MASTER_DTYPE}='compensated' (Adam/AdamW do)"
                )
            opt.master_compensation = True
            log_dist(
                "compensated master weights: params stored in the compute "
                "dtype + int8 Kahan error codes in the optimizer state "
                "(ops/quant.py)", ranks=[0],
            )
        self._apply_zero_state_policies(opt)
        return opt

    def _apply_zero_state_policies(self, opt):
        """What an optimizer over ZeRO shards needs (built and client
        optimizers alike), as the JAX engine's policies: no chunked
        updates (a single-device memory measure; the shards already divide
        the working set by dp), and for LAMB the reduction of its per-group
        norms over every rank, each tensor counted once (a replicated one
        on the first rank of its line only; under tensor parallelism the
        model shards of one JAX leaf summed into its ratio). FusedLamb's
        kernel runs on this rank's shards: the JAX engine gathers the
        sharded state at its kernel's boundary and warns; the port does
        not gather."""
        if self._distributed_norms() and hasattr(opt, "norm_reduce"):
            opt.norm_reduce = self._all_reduce
            opt.norm_skip = self._norm_skip
        if self._zero is None or not self._zero.sharded:
            return
        if hasattr(opt, "chunk_elements"):
            opt.chunk_elements = 1 << 62
        if getattr(opt, "state_dtype", "fp32") == "int8":
            log_dist(
                "int8 optimizer moments shard over the data axis (flat "
                "layout in the JAX element order, blocks padded to a "
                f"multiple of {max(256, self.dp_world_size)})", ranks=[0],
            )
        if type(opt).__name__ == "FusedLamb":
            log_dist(
                "FusedLamb at ZeRO stage >= 1: the phase-1 kernel runs on "
                "this rank's shards and the per-group partial norms are "
                "all-reduced (no gather at the kernel boundary)", ranks=[0],
            )

    def _all_reduce(self, t):
        """A sum over every rank (the world's norms)."""
        dist_lib.all_reduce(t, self._world_group)

    def _distributed_norms(self):
        """Whether the gradient norm and LAMB's group norms are sums over
        ranks: over ZeRO shards, and at any model axis above 1 (model
        shards, or at least one overflow decision shared)."""
        return ((self._zero is not None and self._zero.sharded)
                or self.mp_world_size > 1 or self._pipe is not None
                or bool(self._expert_names))

    def _norm_skip_set(self):
        """The optimizer's leaves this rank leaves out of a world norm:
        one replicated over the data group on a data rank other than 0
        (a rank's experts are its own), one replicated over the model
        group on a model rank other than 0, one every stage holds on a
        pipe rank other than 0, and every leaf on a sequence rank other
        than 0 (the line's gradients are the same on each of its ranks)
        and on a pipe rank other than 0 of a model without stages (it is
        replicated over the pipe axis)."""
        if not self._distributed_norms():
            return frozenset()
        data_sharded = (self._zero is not None and self._zero.sharded)
        shared = set(self._pipe_shared)
        skip = set()
        for n in (self._zero.leaves if self._zero is not None
                  else self.params):
            over_data = (n in self._expert_names or (
                data_sharded and not self._zero.leaves[n].replicated))
            over_model = self._opt_model_dim(n) is not None
            if ((not over_data and self.data_rank)
                    or (not over_model and self.model_rank)
                    or (n in shared and self.pipe_rank)
                    or (self._pipe is None and self.pipe_rank)
                    or self.seq_rank):
                skip.add(n)
        return frozenset(skip)

    def _opt_model_dim(self, name):
        """The model dim of optimizer leaf ``name`` (None: the leaf is
        whole on every model rank: replicated, a flat int8 group, or any
        tensor when the optimizer steps model-gathered tensors)."""
        if self._tp_full_opt:
            return None
        return self._model_dims.get(name)

    def _global_count(self, count):
        """A loss's divisor on this rank: max(the data group's count of
        valid labels, 1) / dp, so that the ranks' mean loss is the global
        batch's (models' ``count_fn``)."""
        total = count.detach().clone()
        dist_lib.all_reduce(total, self._dp_group)
        return total.clamp(min=1) / self.dp_world_size

    def _shard_over_data(self):
        """ZeRO over the data group (dp > 1): the layout; the model's
        data-parallel settings; from stage 1 this rank's fp32 master
        shards (``self.params``) beside the module's compute-dtype
        parameters (``module_params``), at stage 3 the persistent shards,
        the gather arming and the layout gauges."""
        cfg = self.config
        stage = self.zero_stage
        full = self.params
        persist = {}
        if self._tp_full_opt:
            # the module's model shards persist (stage 3: their data
            # shards); the optimizer's leaves cut the whole tensors
            persist = dict(
                persist_shapes={n: tuple(p.shape) for n, p
                                in self._compute_params.items()},
                persist_model_dims=dict(self._model_dims))
        zero = self._zero = ZeroLayout(
            {n: tuple(p.shape) for n, p in full.items()},
            self.dp_world_size, self.data_rank, self._dp_group, stage,
            flat_groups=self._int8_moments,
            model_dims={n: self._opt_model_dim(n) for n in full},
            local=self._expert_names, quant_maps=self._quant_maps, **persist)
        module = self.module
        zero3 = None
        if zero.sharded:
            zero3 = self._shard_params(full)
        if hasattr(module, "configure_data_parallel"):
            # the rank (dropout), the losses' divisor, the stage-3 stack
            # and the sparse embedding gradients (``sparse_gradients``)
            module.configure_data_parallel(
                data_rank=self.data_rank, count_fn=self._global_count,
                zero3=zero3,
                sparse=((self._dp_group, self.dp_world_size)
                        if cfg.sparse_gradients_enabled else None))

    def _configure_model_parallel(self, param_specs):
        """A model axis above 1: with ``param_specs``, cut every parameter
        of the module (the frozen base too) to this rank's shard by its
        spec (parallel/tensor.py; a parameter the specs leave out, such as
        a LoRA factor the engine grew, takes GPT-2's
        :func:`~deepspeed_tpu_torch.models.gpt2.partition_specs` rule,
        else stays replicated) and arm the model's
        seam; without, the model stays whole (replicated over the model
        axis). At model size 1 the model's seam is reset, whatever an
        earlier engine armed on it."""
        module = self.module
        if self.mp_world_size <= 1 or param_specs is None:
            if param_specs is not None:
                log_dist("param_specs at model_parallel_size 1: nothing to "
                         "shard", ranks=[0])
            elif self.mp_world_size > 1:
                log_dist(
                    f"model_parallel_size {self.mp_world_size} without "
                    "param_specs: the model is replicated over the model "
                    "axis (every model rank computes the whole step)",
                    ranks=[0])
            if hasattr(module, "configure_model_parallel"):
                module.configure_model_parallel()
            return
        if not hasattr(module, "configure_model_parallel"):
            raise DeepSpeedConfigError(
                f"param_specs for a {type(module).__name__}: tensor "
                "parallelism needs a model with the configure_model_parallel "
                "seam (GPT2LMHeadModel); leave param_specs out to replicate "
                "the model over the model axis")
        mcfg = getattr(module, "config", None)
        heads = getattr(mcfg, "n_head", None)
        mp, rank = self.mp_world_size, self.model_rank
        if heads is not None and heads % mp:
            # the JAX dispatcher falls back to XLA here; there is no
            # Megatron split of the heads to run the kernels on
            raise DeepSpeedConfigError(
                f"{heads} attention heads do not split over a model axis "
                f"of {mp}: tensor parallelism shards whole heads")
        own = (gpt2_partition_specs(module)
               if isinstance(module, GPT2LMHeadModel) else {})
        self._model_dims = {
            n: tp_lib.model_dim(param_specs.get(n, own.get(n)))
            for n, _ in module.named_parameters()}
        with torch.no_grad():
            for n, p in module.named_parameters():
                d = self._model_dims[n]
                if d is not None:
                    p.data = tp_lib.shard_for_rank(
                        n, p.data, d, mp, rank).contiguous().clone()
            for n in list(self.frozen_base_params):
                d = self._model_dims[n]
                if d is not None:
                    self.frozen_base_params[n] = tp_lib.shard_for_rank(
                        n, self.frozen_base_params[n], d, mp,
                        rank).contiguous().clone()
        self._tp = tp_lib.TensorParallel(self._mp_group, mp, rank)
        module.configure_model_parallel(self._mp_group, rank, mp)
        if self._int8_moments:
            # the JAX engine's flat int8 leaves are whole over the model
            # axis: their blocks cross the model split, so the optimizer
            # steps the model-gathered tensors (under offload on the host;
            # at ZeRO stage 3 each rank's data shard of them, while the
            # module keeps its persistent shards of its model shards)
            self._tp_full_opt = True
        log_dist(
            f"tensor parallel: model axis {mp}, "
            f"{sum(d is not None for d in self._model_dims.values())} of "
            f"{len(self._model_dims)} parameters sharded"
            + (" (the optimizer steps model-gathered tensors: int8 "
               "moments)" if self._tp_full_opt else ""), ranks=[0])

    def _configure_sequence_parallel(self):
        """A sequence axis above 1: refuse what is not ported there and arm
        the model's sequence-parallel seam; at sequence size 1 the seam is
        reset, whatever an earlier engine armed on it."""
        module = self.module
        line = sequence_line(self.mesh)
        if line is None:
            if hasattr(module, "configure_sequence_parallel"):
                module.configure_sequence_parallel(None)
            return
        if not hasattr(module, "configure_sequence_parallel"):
            # replicated over the sequence axis, as the JAX engine runs a
            # model without a sequence-parallel layer: every sequence rank
            # computes the whole step on its data rank's rows
            log_dist(
                f"sequence axis {line.size}: a {type(module).__name__} has "
                "no sequence-parallel seam; it is replicated over the "
                "sequence axis", ranks=[0])
            return
        module.configure_sequence_parallel(line)
        self._sp_line = line
        log_dist(f"sequence parallel: sequence axis {line.size}", ranks=[0])

    def _refuse_with_stages_or_experts(self):
        """What a pipe axis above 1 (or a model with pipeline stages) and
        a model with MoE experts refuse: the adapters block, with the JAX
        engine's behaviour as the reason. int8 moments train there on the
        whole JAX leaf's block grid (:meth:`_int8_block_maps`), at every
        ZeRO stage."""
        module = self.module
        cfg = self.config
        mcfg = getattr(module, "config", None)
        stages = getattr(mcfg, "pipeline_stages", 1)
        experts = getattr(mcfg, "moe_experts", 0)
        staged = stages > 1 or (self._pipe is not None
                                and hasattr(module, "configure_pipeline"))
        # a model without stages is replicated over a pipe axis
        # (_configure_pipeline_and_experts)
        if staged:
            if cfg.adapters_enabled:
                # the JAX pipelined stack runs its blocks without their
                # factors: the JAX engine trains nothing there
                raise DeepSpeedConfigError(
                    "the adapters block at a pipe axis above 1: the JAX "
                    "engine's pipelined stack runs the blocks without their "
                    "LoRA factors, so its fine-tune leaves them as they "
                    "were; the port refuses it rather than train something "
                    "else")
        if experts > 0:
            if cfg.adapters_enabled:
                # the JAX MoE block runs its attention without the factors
                raise DeepSpeedConfigError(
                    "the adapters block with MoE experts: the JAX engine's "
                    "MoE blocks run without their LoRA factors, so its "
                    "fine-tune leaves them as they were; the port refuses "
                    "it rather than train something else")

    def _int8_block_maps(self):
        """int8 moments whose JAX leaf spans ranks: ``{group: BlockMap}``
        (ops/quant.py) of each group that a pipeline stage holds part of
        (``h.*`` over the layers) or a data rank (``h.*.moe.expert_*``
        over the layers and experts), else None. The whole leaf runs over
        the group's tensors in layer order (and expert order within a
        tensor), each in the JAX element order; a block that holds
        elements of two ranks is shared, and its scale is the max of their
        absmax over every rank of the world. Over ZeRO shards (stage 1
        and above at a data axis above 1) the optimizer steps a stage's
        map as one flat tensor named by its group, its runs cut to this
        data rank's contiguous share of their blocks; an expert group's
        runs are this data rank's already, its tensors stepped whole."""
        if not self._int8_moments:
            return None
        module = self.module
        stage_of = None
        if self._pipe is not None and hasattr(module, "stage_layers"):
            per = module.config.n_layer // self.pp_world_size
            stage_of = {i: i // per for i in range(module.config.n_layer)}
        experts = self._expert_names
        if stage_of is None and not experts:
            return None
        dp, maps = self.dp_world_size, {}
        sharded = (self.zero_stage >= ZERO_OPTIMIZATION_OPTIMIZER_STATES
                   and dp > 1)
        for group, names in param_groups(
                [n for n in self._global_names
                 if n not in self.frozen_base_params]).items():
            pieces, mine, off = [], [], 0
            for n in names:
                k = int(np.prod(self._global_shapes[n]))
                if n in experts:
                    each = k // dp
                    pieces += [(off + r * each, r) for r in range(dp)]
                    mine.append((n, each, off + self.data_rank * each))
                elif stage_of is not None and n.startswith("h."):
                    owner = stage_of[int(n.split(".")[1])]
                    pieces.append((off, owner))
                    if owner == self.pipe_rank:
                        mine.append((n, k, off))
                else:
                    pieces.append((off, None))
                    mine.append((n, k, off))
                off += k
            if all(owner is None for _, owner in pieces):
                continue
            shared = sorted({b // quant_lib.BLOCK for (b, o), (_, prev)
                             in zip(pieces[1:], pieces) if o != prev
                             and b % quant_lib.BLOCK})
            cut = sharded and not any(n in experts for n in names)
            maps[group] = quant_lib.BlockMap(
                mine, off, shared, functools.partial(
                    dist_lib.all_reduce, group=self._world_group,
                    op=torch.distributed.ReduceOp.MAX),
                shard=(self.data_rank, dp, group) if cut else None)
        return maps or None

    def _configure_pipeline_and_experts(self):
        """A pipe axis above 1: keep this stage's blocks (the model's
        ``configure_pipeline``, which makes the JAX model's checks); MoE
        experts at a data axis above 1: keep this rank's experts (the
        model's ``configure_expert_parallel``)."""
        module = self.module
        mcfg = getattr(module, "config", None)
        stages = getattr(mcfg, "pipeline_stages", 1)
        experts = getattr(mcfg, "moe_experts", 0)
        if self._pipe is not None and not hasattr(module,
                                                  "configure_pipeline"):
            # a model without stages: replicated over the pipe axis, as
            # the JAX engine runs it (every pipe rank computes the whole
            # step on its data rank's rows)
            log_dist(
                f"pipe axis {self.pp_world_size}: a "
                f"{type(module).__name__} has no pipeline stages; it is "
                "replicated over the pipe axis", ranks=[0])
            self._pipe = None
        if self._pipe is not None or stages > 1:
            module.configure_pipeline(self._pipe, self.dp_world_size,
                                      self.data_rank)
            self._pipe_shared = tuple(module.pipeline_shared_parameters())
            log_dist(
                f"pipeline: {self.pp_world_size} stages, this stage's "
                f"blocks {list(module.stage_layers)}", ranks=[-1])
        elif hasattr(module, "configure_pipeline"):
            module.configure_pipeline(None)
        if hasattr(module, "configure_expert_parallel"):
            line = None
            if experts > 0 and self.dp_world_size > 1:
                line = SequenceParallel(self._dp_group, self.dp_world_size,
                                        self.data_rank,
                                        self.mesh.line_ranks(DATA_AXIS))
            module.configure_expert_parallel(line)
            if line is not None:
                self._expert_names = frozenset(
                    module.expert_parameter_names())
                log_dist(
                    f"expert parallel: {experts // self.dp_world_size} of "
                    f"{experts} experts a data rank", ranks=[0])

    def _model_full_masters(self):
        """The model-gathered optimizer: float32 masters of the whole
        tensors (a collective over the model group) beside the module's
        shards, which compute; the module holds the compute dtype."""
        local = self.params
        self.params = {
            n: tp_lib.gather_shards(n, p.detach(), self._model_dims.get(n),
                                    self._tp).float().clone()
            for n, p in local.items()}
        self.module.to(dtype=self.compute_dtype)
        self._compute_params = self._trainable_module_params()

    def _model_gathered(self, name, t):
        """Model shard ``t`` of ``name`` joined over the model group."""
        return tp_lib.gather_shards(name, t, self._model_dims.get(name),
                                    self._tp)

    def _model_slice(self, name, t):
        """This model rank's shard of the whole tensor ``t``."""
        return tp_lib.shard_for_rank(name, t, self._model_dims.get(name),
                                     self.mp_world_size, self.model_rank)

    @torch.no_grad()
    def _publish_model_slices(self, full):
        """The module's shards cut from whole tensors ``full`` (the
        model-gathered optimizer's masters after an update)."""
        for n, t in full.items():
            self._compute_params[n].copy_(self._model_slice(n, t))

    def _shard_params(self, full):
        """From stage 1: this rank's master shards, the module's
        compute-dtype parameters beside them (stage 3: its persistent
        shards), the stage-3 gather arming (returned) and gauges."""
        zero = self._zero
        stage = self.zero_stage
        module = self.module
        # compensated masters are the compute-dtype parameters themselves,
        # their int8 codes sharded with the optimizer state
        masters = zero.shard_leaves(
            full, dtype=(self.compute_dtype if self.compensated_master
                         else torch.float32))
        if stage >= ZERO_OPTIMIZATION_WEIGHTS:
            # the module's tensors (apart from the masters when the
            # optimizer steps model-gathered ones)
            held = self._compute_params if self._tp_full_opt else full
            with torch.no_grad():
                for n, p in held.items():
                    p.data = zero.persistent_shard(n, p.data)
        module.to(dtype=self.compute_dtype)
        self._compute_params = self._trainable_module_params()
        if self.compute_dtype == torch.float32 or self.compensated_master:
            if stage >= ZERO_OPTIMIZATION_WEIGHTS:
                # the persistent shards are the masters, as the JAX
                # engine's sharded fp32 (or compensated) params are: a
                # leaf of their layout is the shard itself, any other (a
                # flat int8 group, a model-gathered tensor's data shard)
                # is cut from the shards at each update and not kept
                # (:meth:`_master_leaf`)
                self._masters_alias = frozenset(
                    n for n in masters if zero.persistent_leaf(n))
                self._cut_masters = frozenset(masters) - self._masters_alias
                masters = {n: self._compute_params[n].data for n in masters
                           if n in self._masters_alias}
            else:
                # stages 1-2 in fp32 (or compensated): a master that is a
                # contiguous part of the module's parameter (a dim-0
                # shard, a replicated tensor) is a view of it, not a copy;
                # the update writes the module's slice, the all-gather the
                # rest
                for n in masters:
                    if n not in self._compute_params:
                        continue  # a flat int8 group
                    view = zero.leaf_view(n, self._compute_params[n].data)
                    if view is not None:
                        masters[n] = view
        self.params = masters
        if stage < ZERO_OPTIMIZATION_WEIGHTS:
            return None
        itemsize = torch.finfo(self.compute_dtype).bits // 8
        (self._zero3_shard_bytes,
         self._zero3_gather_bytes) = zero.zero3_bytes(itemsize)
        return self._arm_zero3_gather()

    def _master_leaf(self, name):
        """Master leaf ``name``: the one held, or at stage 3 one cut from
        the module's persistent shards through the full tensors (a
        collective of the data group, and of the model group when the
        optimizer steps model-gathered tensors)."""
        if name not in self._cut_masters:
            return self.params[name]
        zero = self._zero
        full = {}
        for n, _ in zero.leaves[name].members:
            t = zero.gather_full(n, self._compute_params[n].data)
            full[n] = self._model_gathered(n, t) if self._tp_full_opt else t
        return zero.shard_leaves(
            full, dtype=(self.compute_dtype if self.compensated_master
                         else torch.float32), names=(name,))[name]

    def _masters(self):
        """Every master leaf, in the optimizer's order: ``params``, with
        the leaves cut from the stage-3 shards (:meth:`_master_leaf`)."""
        if not self._cut_masters:
            return self.params
        return {n: self._master_leaf(n) for n in self._zero.leaves}

    def _arm_zero3_gather(self):
        """The arming of the model's stage-3 stack (models/stack.py) over
        its block tensors (returned; None without a seam), and the gather
        of every other sharded parameter at the forward here. A model
        without the seam (``zero3_block_prefix``) trains all the same,
        with every sharded parameter gathered at the forward."""
        zero = self._zero
        zc = self.config.zero_config
        module = self.module
        seam = prefix = getattr(module, "zero3_block_prefix", None)
        if prefix is not None and (
                self.frozen_base_params or self._expert_names
                or self._pipe is not None
                or getattr(getattr(module, "config", None), "lora_rank", 0)):
            # the stack gathers the dense block layout only, not the
            # factors, an MoE block or a stage's blocks inside the pipeline
            # schedule (the JAX engine disarms it for all three)
            log_dist(
                "ZeRO-3: layer-wise gather seam not armed (LoRA adapters, "
                "MoE blocks and pipeline stages do not compose with the "
                "zero3 stack yet); params stay dp-sharded and every sharded "
                "parameter is gathered at the forward", ranks=[0])
            prefix = None
        dims, shapes, block = {}, {}, set()
        if prefix is not None:
            for n, shape in zero.persist_shapes.items():
                tensor = n.rpartition(".")[2]
                if n.startswith(prefix) and tensor in BLOCK_TENSORS:
                    d = zero.param_specs[n]
                    if dims.setdefault(tensor, d) != d or shapes.setdefault(
                            tensor, shape) != shape:
                        raise ValueError(
                            f"ZeRO-3: block tensor {tensor} differs "
                            "between layers; the stack needs one layout")
                    block.add(n)
        arming = None
        if block:
            arming = Zero3Arming(
                dims, shapes, self._dp_group, self.dp_world_size,
                block=int(zc.stage3_gather_block),
                latency_hiding=bool(zc.stage3_latency_hiding))
            self.zero3_gather_enabled = True
            log_dist(
                f"ZeRO-3: layer-wise gather armed over {len(dims)} block "
                f"tensors (gather_block={zc.stage3_gather_block}; the "
                "backward re-gathers)", ranks=[0])
        elif seam is None:
            log_dist(
                "ZeRO-3: model exposes no layer-gather seam "
                "(zero3_block_prefix); every sharded parameter is gathered "
                "at the forward", ranks=[0])
        rest = [n for n in zero.persist_shapes
                if n not in block and zero.param_specs[n] is not None]
        if rest:
            self._engine_gather = Zero3Arming(
                {n: zero.param_specs[n] for n in rest},
                {n: zero.persist_shapes[n] for n in rest}, self._dp_group,
                self.dp_world_size,
                latency_hiding=bool(zc.stage3_latency_hiding))
        return arming

    def _offload_masters(self):
        """Optimizer offload: copy the float32 masters into pinned host
        memory, turn the module's parameters into the compute dtype on the
        device, and keep pinned buffers for the step's gradient copies in
        and parameter copies out. Pinning needs the card: a CPU engine's
        masters are plain host tensors."""
        pin = self.device.type == "cuda"
        masters = {}
        for n, p in self.params.items():
            host = torch.empty(p.shape, dtype=torch.float32, pin_memory=pin)
            host.copy_(p.detach())
            masters[n] = host
        self.module.to(dtype=self.compute_dtype)
        self._compute_params = self._trainable_module_params()
        self.params = masters
        if pin:
            self._host_grads = {
                n: torch.empty(p.shape, dtype=self.grad_accum_dtype,
                               pin_memory=True)
                for n, p in masters.items()}
            self._host_out = {
                n: torch.empty(p.shape, dtype=self.compute_dtype,
                               pin_memory=True)
                for n, p in self._compute_params.items()}
        log_dist(
            "ZeRO-Offload: fp32 master + optimizer moments on host cpu; "
            "accelerator holds compute-dtype params/grads (per-step d2h "
            "grads + h2d params)", ranks=[0],
        )

    def _trainable_module_params(self):
        """The module's parameters that are trained (under the adapters
        block the frozen base is not among them)."""
        return {n: p for n, p in self.module.named_parameters()
                if n not in self.frozen_base_params}

    def _pinned(self, tree):
        """``tree`` with every tensor in pinned host memory (offload on a
        CUDA engine; unchanged on a CPU engine)."""
        if self.device.type != "cuda":
            return tree
        if isinstance(tree, torch.Tensor):
            return tree.pin_memory()
        if isinstance(tree, dict):
            return {k: self._pinned(v) for k, v in tree.items()}
        return tree

    def full_parameters(self):
        """The module's trainable parameters in full, in the dtype it
        computes with: at ZeRO stage 3 gathered from every rank's shards,
        and under tensor parallelism joined over the model group in the
        JAX package's element order (a collective: every rank calls
        it)."""
        from .checkpointing import _full_module_params

        return _full_module_params(self)

    @property
    def module_params(self):
        """The module's trainable parameters as the model computes with
        them: the masters, or under offload the device's compute-dtype
        copies (what a checkpoint's module file holds)."""
        return (self._compute_params if self._compute_params is not None
                else self.params)

    @torch.no_grad()
    def publish_params(self):
        """Offload: the host masters cast to the compute dtype and copied
        into the device's parameters (through pinned buffers, without
        waiting, on a CUDA engine)."""
        for n, master in self.params.items():
            dst = self._compute_params[n]
            if self._tp_full_opt:
                # the model-gathered master's shard for this rank
                master = self._model_slice(n, master)
            if self._host_out is not None:
                staged = self._host_out[n]
                staged.copy_(master)
                dst.copy_(staged, non_blocking=True)
            else:
                dst.copy_(master)

    def _configure_adapters(self, model_parameters, rng_seed):
        """LoRA fine-tune wiring: arm the model config (or reject a
        mismatch), split the ``*_lora_*`` tensors out of the parameters or
        grow fresh factors from ``rng_seed`` (A ~ N(0, 0.02), B = 0, so the
        first forward is the base model's), and freeze the base once in
        the compute dtype. Only the factors stay trainable."""
        cfg = self.config
        rank = int(cfg.adapters_rank)
        alpha = float(cfg.adapters_alpha or 0.0)
        targets = lora_lib.resolve_lora_targets(cfg.adapters_targets)
        module = self.module
        mcfg = getattr(module, "config", None)
        if not hasattr(mcfg, "lora_rank") or not hasattr(
            module, "add_lora_params"
        ):
            raise DeepSpeedConfigError(
                "the adapters block fine-tunes the GPT-2 family: pass a "
                "GPT2LMHeadModel (its config carries lora_rank)"
            )
        if int(mcfg.lora_rank) == 0:
            mcfg.lora_rank = rank
            mcfg.lora_alpha = alpha
            mcfg.lora_targets = targets
        elif (
            int(mcfg.lora_rank) != rank
            or lora_lib.resolve_lora_targets(mcfg.lora_targets) != targets
        ):
            raise DeepSpeedConfigError(
                f"model config carries lora_rank={mcfg.lora_rank}/targets="
                f"{tuple(mcfg.lora_targets)} but the adapters block asks "
                f"for rank={rank}/targets={targets}; make them agree (or "
                "leave the model at lora_rank=0 and let the engine arm it)"
            )
        # split BEFORE arming adds zero-filled factors: a model built at
        # lora_rank 0 brings no adapter, and grows a fresh one below
        state = (
            module.state_dict() if model_parameters is None
            else model_parameters
        )
        base, adapters = lora_lib.split_lora_params(state)
        module.add_lora_params()
        if not adapters:
            adapters = lora_lib.init_lora_params(
                base, rank, targets=targets,
                generator=torch.Generator().manual_seed(int(rng_seed)),
            )
        module.load_state_dict({**base, **adapters})
        # the frozen base: read-only compute-dtype copies, never
        # differentiated, never stepped, never cast again
        self._adapters_meta = {
            "rank": rank, "alpha": alpha, "targets": list(targets),
        }
        self.frozen_base_params = {}
        for n, p in module.named_parameters():
            if not lora_lib.is_lora_name(n):
                p.requires_grad_(False)
                self.frozen_base_params[n] = p.detach().to(self.compute_dtype)
        n_adapter = sum(
            p.numel() for n, p in module.named_parameters()
            if lora_lib.is_lora_name(n)
        )
        n_base = sum(p.numel() for p in self.frozen_base_params.values())
        log_dist(
            f"adapters: LoRA fine-tune — rank {rank} on {list(targets)}; "
            f"{n_adapter} trainable adapter params, {n_base} base params "
            f"frozen ({100.0 * n_adapter / max(n_base, 1):.2f}%)",
            ranks=[0],
        )

    def adapter_state_dict(self):
        """The fine-tuned LoRA factors (``h.<i>.<target>_lora_a`` /
        ``_lora_b``, fp32 copies), the ``adapter_state`` that a serving
        engine's ``load_adapter`` takes."""
        if not self.frozen_base_params:
            raise DeepSpeedConfigError(
                "this engine fine-tunes no adapters; enable the "
                '"adapters" config block'
            )
        return {n: p.detach().clone() for n, p in self.params.items()}

    # ------------------------------------------------------------------
    # checkpoints (runtime/checkpointing.py)
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir, tag=None, client_state=None):
        """Commit a checkpoint of the engine under ``save_dir/tag`` (tag
        defaults to ``global_step<N>``). Under the adapters block only the
        LoRA factors and their moments are saved, and
        ``client_state["adapters"]`` records their geometry for
        ``load_adapter(load_dir=...)``."""
        from .checkpointing import save_checkpoint as _save

        if self.frozen_base_params:
            client_state = dict(client_state or {})
            client_state.setdefault("adapters", dict(self._adapters_meta))
        # a large save can outlast the watchdog timeout
        with self.telemetry.liveness_exempt():
            with self.telemetry.tracer.span(
                "train.checkpoint_commit",
                ctx=self.telemetry.train_trace_ctx(),
                attrs={"save_dir": str(save_dir), "tag": tag},
            ):
                result = _save(self, save_dir, tag=tag,
                               client_state=client_state or {})
        # the preemption drain's default sink
        self._last_checkpoint_dir = save_dir
        if self.supervisor is not None:
            # this directory's newest valid tag is the rollback point
            self.supervisor.on_checkpoint(save_dir)
        return result

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore the engine from ``load_dir`` (``tag``, or the newest
        valid tag from ``latest``). Returns ``(path, client_state)``, or
        ``(None, {})`` with the engine untouched when nothing is
        loadable."""
        from .checkpointing import load_checkpoint as _load

        del load_module_strict
        with self.telemetry.liveness_exempt():
            result = _load(
                self, load_dir, tag=tag,
                load_optimizer_states=load_optimizer_states,
                load_lr_scheduler_states=load_lr_scheduler_states,
            )
        if result[0] is not None:
            self._last_checkpoint_dir = load_dir
            if self.supervisor is not None:
                self.supervisor.on_checkpoint(load_dir)
        return result

    def discard_window(self):
        """Drop a half-run window (the stashed forward, the gradient
        buffer, the window's losses): the supervisor's rollback discards
        that timeline. The cast gradient store keeps its storage (its next
        window overwrites it), so FusedLamb's table stays valid."""
        self._pending = None
        self._grad_buffer = None
        self._window_losses = []
        self._window_aux = []
        self._window_seeds = []
        self._window_open = False
        if self._window_timed:
            self.timers(TRAIN_BATCH_TIMER).stop()
            self._window_timed = False

    # ------------------------------------------------------------------
    # training API
    # ------------------------------------------------------------------
    def _batch(self, inputs):
        """Inputs on the engine's device; floating ones in the compute
        dtype (integer ids and labels untouched). At a sequence axis above
        1, this rank's chunk of dim 1 of every input with one (the
        tokens), in sequence order."""
        out = []
        line = self._sp_line
        for x in inputs:
            x = torch.as_tensor(x, device=self.device)
            if x.is_floating_point():
                x = x.to(self.compute_dtype)
            if line is not None and x.dim() >= 2:
                if x.shape[1] % line.size:
                    raise ValueError(
                        f"an input of shape {tuple(x.shape)}: sequence "
                        f"parallelism cuts dim 1 of every input over "
                        f"{line.size} ranks")
                x = x.chunk(line.size, dim=1)[line.rank]
            out.append(x)
        return tuple(out)

    def _call(self, params, batch):
        if self._engine_gather is not None:
            # stage 3: the sharded tensors outside the model's stack,
            # gathered for this forward (their backward reduce-scatters)
            names = list(self._engine_gather.dims)
            full = gather_tensors(self._engine_gather,
                                  [(n, params[n]) for n in names])
            params = {**params, **dict(zip(names, full))}
        kwargs = {}
        if self._takes_train:
            kwargs["train"] = self._training
        if self._takes_seed:
            kwargs["dropout_seed"] = (
                self._window_seeds.pop(0) if self._window_seeds
                else _draw_seed(self._rng)
            )
        return functional_call(self.module, params, batch, kwargs)

    def forward(self, *inputs):
        """Run the model on one micro-batch and return its loss (a tuple
        output's element 0; the rest goes to ``last_aux``). In train mode
        the graph is kept for the following ``backward()``."""
        if self._training and self._pending is not None:
            raise RuntimeError(
                "two forward() calls without backward() inside an "
                "accumulation window"
            )
        if self._training and self.telemetry.enabled:
            # every micro-step is liveness, not just the window's end
            self.telemetry.heartbeat()
            self._open_window()
            self.telemetry.count_batch(*self._batch_tokens(inputs))
        elif not self._training:
            # eval forwards are liveness, not windows
            self.telemetry.heartbeat()
        if self.wall_clock_breakdown:
            self.timers(FORWARD_TIMER).start()
        batch = self._batch(inputs)
        if not self._training:
            with torch.no_grad():
                loss, aux = _split_model_output(
                    self._call(self._cast_params(grad=False), batch))
        else:
            params = self._cast_params(grad=True)
            loss, aux = _split_model_output(self._call(params, batch))
            self._pending = (loss, params, aux)
        if aux:
            self.last_aux = self._data_mean(aux)
        if self.wall_clock_breakdown:
            self.timers(FORWARD_TIMER).stop()
        return loss

    __call__ = forward

    def _data_mean(self, aux):
        """The aux outputs (detached) averaged over the data group, as the
        window loss is."""
        aux = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                    for a in aux)
        if self.dp_world_size <= 1 or not all(
                isinstance(a, torch.Tensor) for a in aux):
            return aux
        flat = torch.cat([a.float().reshape(-1) for a in aux])
        dist_lib.all_reduce(flat, self._dp_group)
        flat = flat / self.dp_world_size
        out, off = [], 0
        for a in aux:
            out.append(flat[off:off + a.numel()].view(a.shape).to(a.dtype))
            off += a.numel()
        return tuple(out)

    def _open_window(self):
        """The telemetry's window start, once a window, at its first
        micro-step: ``train_batch`` opens it before its profiler ranges,
        so that a profiler window armed there holds the whole window."""
        if (self.telemetry.enabled and not self._window_open
                and self.micro_steps % self.gradient_accumulation_steps()
                == 0):
            self._window_open = True
            self.telemetry.on_window_start()

    @staticmethod
    def _batch_tokens(inputs):
        """(tokens, samples) of one micro-batch from its first tensor-like
        input: rows are samples; rows x dim 1 are tokens only for a 2-d
        integer input (the (batch, seq) ids of an LM batch), else tokens
        == samples (the JAX engine's rule)."""
        for x in inputs:
            shape = getattr(x, "shape", None)
            if shape:
                samples = int(shape[0])
                dtype = getattr(x, "dtype", None)
                if isinstance(dtype, torch.dtype):
                    integer = not (dtype.is_floating_point
                                   or dtype.is_complex or dtype == torch.bool)
                else:
                    integer = dtype is not None and np.issubdtype(
                        dtype, np.integer)
                is_ids = len(shape) == 2 and integer
                return (samples * int(shape[1]) if is_ids else samples,
                        samples)
        return 0, 0

    def _cast_params(self, grad):
        """The trainable parameters in the compute dtype, as leaf tensors
        (with ``grad``, requiring gradients) for ``functional_call``,
        beside the frozen base under the adapters block. The fp32 masters
        are cast; compensated and offloaded layouts already hold the
        compute dtype, and are used without a copy."""
        out = dict(self.frozen_base_params)
        hook = (grad and self._zero is not None and not self._tp_full_opt
                and self.zero_stage == ZERO_OPTIMIZATION_GRADIENTS)
        for name, p in self.module_params.items():
            t = p.detach().to(self.compute_dtype)
            out[name] = t.requires_grad_() if grad else t
            if hook:
                # stage 2: each gradient is reduce-scattered the moment
                # the backward has produced it, and freed
                t.register_post_accumulate_grad_hook(
                    functools.partial(self._grad_ready, name))
        return out

    def _grad_ready(self, name, t):
        """Stage 2's hook: the fresh gradient of ``name`` into the shard
        buffer (its leaf's members all in, for a flat int8 group)."""
        g = t.grad.to(self.grad_accum_dtype)
        t.grad = None
        self._zero.reduce_one(name, g, self._shards(), self._hooked)

    def backward(self, loss, allreduce_gradients=True):
        """Differentiate the stashed forward's loss, scaled by
        ``loss_scale / gradient_accumulation_steps``, and add the
        gradients into the buffer in the accumulation dtype."""
        del loss, allreduce_gradients
        if self._pending is None:
            raise RuntimeError(
                "backward() called without a preceding forward() in train mode"
            )
        if self.wall_clock_breakdown:
            self.timers(BACKWARD_TIMER).start()
        loss, params, aux = self._pending
        self._pending = None
        self._window_losses.append(loss.detach().float())
        if aux:
            self._window_aux.append(self.last_aux)
        scale = self.loss_scale_state.loss_scale
        # data parallel: each rank's share of the global batch's mean (the
        # collectives sum over the ranks)
        denom = self.gradient_accumulation_steps() * self.dp_world_size
        hooked = (self._zero is not None and self.zero_stage == 2
                  and not self._tp_full_opt)
        if hooked:
            # what the stage-2 hooks reduced this micro-step, and whether
            # they copy into the shard buffer or add to it
            self._hooked = {"first": self._grad_buffer is None, "done": set(),
                            "pending": {}, "flushed": set()}
        (loss.float() * scale / denom).backward()
        if hooked:
            # a parameter the loss does not reach reduces zeros, so that
            # every rank issues every collective
            self._zero.reduce_missing(
                {n: torch.empty(self._zero.shapes[n], device="meta")
                 for n in params if n not in self.frozen_base_params},
                self._shards(), self._hooked)
            self._grad_buffer = self._shards()
            self.micro_steps += 1
            if self.wall_clock_breakdown:
                self.timers(BACKWARD_TIMER).stop()
            return
        grads = {
            n: t.grad if t.grad is not None else torch.zeros_like(t)
            for n, t in params.items() if n not in self.frozen_base_params
        }
        if self._zero is not None and self.zero_stage >= 3:
            # the accumulation buffer is this rank's shards (of the
            # model-gathered tensors, for int8 moments at mp > 1)
            self._grad_buffer = self._zero.add_persistent_grads(
                {n: g.to(self.grad_accum_dtype) for n, g in grads.items()},
                self._shards(), self._grad_buffer is None,
                to_full=self._model_gathered if self._tp_full_opt else None)
        elif self._grad_buffer is not None:
            for n, g in grads.items():
                self._grad_buffer[n].add_(g)
        elif self._grad_store is not None:
            # a window's first micro-step casts into the buffer kept from
            # the last window: its storage never moves, so FusedLamb's
            # cached device table of pointers stays valid
            for n, g in grads.items():
                self._grad_store[n].copy_(g)
            self._grad_buffer = self._grad_store
        else:
            self._grad_buffer = {
                n: g.to(self.grad_accum_dtype) for n, g in grads.items()}
            if any(g.dtype != self.grad_accum_dtype for g in grads.values()):
                # the cast copied: keep the buffer for the next windows
                self._grad_store = self._grad_buffer
        self.micro_steps += 1
        if self.wall_clock_breakdown:
            self.timers(BACKWARD_TIMER).stop()

    def _shards(self):
        """The persistent buffer of this rank's gradient shards (the
        accumulation dtype), made at first use."""
        if self._shard_store is None:
            self._shard_store = self._zero.empty_leaves(
                self.grad_accum_dtype, self.device)
        return self._shard_store

    def _reduce_at_boundary(self, grads):
        """The window's gradients summed over the data group: stage 0
        all-reduces the full buffer in place, stage 1 reduce-scatters it
        to the shards; from stage 2 the buffer already is the shards
        (but for the model-gathered optimizer, whose stage 2 reduces as
        stage 1 does)."""
        if self.zero_stage == 0:
            for n, g in grads.items():
                if n not in self._expert_names:
                    dist_lib.all_reduce(g, self._dp_group)
            return grads
        if self.zero_stage == 1 or (self._tp_full_opt
                                    and self.zero_stage < 3):
            # fresh shards: only the full buffer persists between windows
            return self._zero.reduce_grads(grads, {}, True)
        return grads

    def _norm_and_overflow(self, grads):
        """``(raw_norm, overflow)`` as device tensors: the global norm of
        the unscaled-by-nothing gradients (-1.0 when inf/nan) and the skip
        flag (fp16: any inf/nan; else the norm's sentinel). Over shards or
        a model axis both are reduced over every rank, each tensor counted
        once (:meth:`_norm_skip_set`), so every rank decides alike."""
        if not self._distributed_norms():
            raw_norm = global_norm(grads.values())  # -1.0 if inf/nan
            if self.config.fp16_enabled:
                return raw_norm, has_overflow(grads.values())
            return raw_norm, raw_norm < 0.0
        skip = self._norm_skip
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for n, g in grads.items():
            if n not in skip:
                g = g.float()
                sq = sq + torch.sum(g * g)
        both = torch.stack([sq, has_overflow(grads.values()).float()])
        dist_lib.all_reduce(both, self._world_group)
        norm = torch.sqrt(both[0])
        raw_norm = torch.where(torch.isfinite(norm), norm,
                               torch.full_like(norm, -1.0))
        if self.config.fp16_enabled:
            return raw_norm, both[1] > 0
        return raw_norm, raw_norm < 0.0

    @torch.no_grad()
    def _publish_shards(self, params):
        """After an update over shards: the module's parameters from the
        new masters ``params`` (all-gathered at stages 1-2; at stage 3
        this rank's persistent shards, through the full tensors one leaf
        at a time where the layouts differ)."""
        zero = self._zero
        if self._tp_full_opt:
            # whole tensors gathered over the data group, then the
            # module's model shards cut from them (stage 3: their
            # persistent shards)
            full = {n: torch.empty(shape, dtype=self.compute_dtype,
                                   device=self.device)
                    for n, shape in zero.shapes.items()}
            zero.gather_into(params, full)
            if self.zero_stage >= ZERO_OPTIMIZATION_WEIGHTS:
                full = {n: zero.persistent_shard(n, self._model_slice(n, t))
                        for n, t in full.items()}
                for n, t in full.items():
                    self._compute_params[n].copy_(t)
            else:
                self._publish_model_slices(full)
        elif self.zero_stage < ZERO_OPTIMIZATION_WEIGHTS:
            zero.gather_into(params, self._compute_params)
        elif zero.persistent_matches_leaves():
            for n, master in params.items():
                if n not in self._masters_alias:
                    self._compute_params[n].copy_(master)
        else:
            for name, leaf in zero.leaves.items():
                if name in self._masters_alias:
                    continue
                full = {n: torch.empty(shape, dtype=self.compute_dtype,
                                       device=self.device)
                        for n, shape in leaf.members}
                zero.gather_into(params, full, names=(name,))
                for n, t in full.items():
                    self._compute_params[n].copy_(
                        zero.persistent_shard(n, t))

    def zero_grad(self):
        self._grad_buffer = None
        self._window_losses = []
        self._window_aux = []

    @torch.no_grad()
    def step(self):
        """At the accumulation boundary: the overflow test, the update or
        the skip, the loss scale and the LR schedule; then the step line,
        the timers, the monitor and the telemetry."""
        accum = self.gradient_accumulation_steps()
        if (self.micro_steps == 0 or self.micro_steps % accum != 0
                or self._grad_buffer is None):
            return
        if self.wall_clock_breakdown:
            self.timers(STEP_TIMER).start()
        with torch.profiler.record_function("window_optimizer_update"):
            overflow, grad_norm, window_loss, host_loss = self._update()
        if self.wall_clock_breakdown:
            self.timers(STEP_TIMER).stop()
            if self._window_timed:
                # a train_batch window ends with its update, before the
                # step line reads the timers
                self.timers(TRAIN_BATCH_TIMER).stop()
                self._window_timed = False
                self._tb_windows += 1
        self._finish_step(overflow, grad_norm, window_loss, host_loss)

    def _update(self):
        """The update or the skip. Returns ``(overflow, grad_norm,
        window_loss, host_loss)``: the post-unscale gradient norm as a
        host float (-1.0 on a skip), the window's mean unscaled loss as a
        device tensor, and that loss as a host float when the monitor
        needs it (else None)."""
        grads = self._grad_buffer
        window_loss = None
        if self._window_losses:
            window_loss = torch.stack(self._window_losses).mean()
        self._window_losses = []
        if self._window_aux:
            # the window's aux [accum]-stacked, the layout on both train
            # paths
            self.last_aux = tuple(torch.stack(list(xs))
                                  for xs in zip(*self._window_aux))
            self._window_aux = []
        if self._tp_full_opt and self.zero_stage < 3:
            # the window's model shards joined once over the model group,
            # for the optimizer's whole tensors (stage 3's buffer already
            # holds the leaves)
            grads = {n: self._model_gathered(n, g) for n, g in grads.items()}
        if self._zero is not None:
            grads = self._reduce_at_boundary(grads)
        if self._sp_line is not None:
            # every parameter is replicated over the sequence axis: the
            # line's sum, on the data group's result (its shards are the
            # same on every rank of the line)
            for g in grads.values():
                dist_lib.all_reduce(g, self._sp_line.group)
        for n in self._pipe_shared:
            # the embeddings and ln_f are on every stage, each stage's
            # gradient its own part: the pipe line's sum
            dist_lib.all_reduce(grads[n], self._pipe.group)
        if self._host_grads is not None:
            # offload on the card: the summed gradients' copies to pinned
            # host buffers are queued here, and the step's one sync below
            # waits for them (a CPU engine's gradients are on the host)
            for n, g in grads.items():
                self._host_grads[n].copy_(g, non_blocking=True)
        # the overflow test and the norm run where the gradients are, as
        # on the on-device path, so that offload's clip factor is that
        # path's bit for bit
        raw_norm, overflow = self._norm_and_overflow(grads)
        # the step's one host sync: the skip decision and the norm, and
        # the window loss when the monitor writes it
        if window_loss is not None and self.dp_world_size > 1:
            # the global batch's mean: the ranks' losses averaged
            window_loss = window_loss.clone()
            dist_lib.all_reduce(window_loss, self._dp_group)
            window_loss = window_loss / self.dp_world_size
        synced = [overflow.float(), raw_norm.float()]
        want_loss = self.monitor.enabled and window_loss is not None
        if want_loss:
            synced.append(window_loss)
        synced = torch.stack(synced).tolist()
        overflow, raw = bool(synced[0]), synced[1]
        host_loss = synced[2] if want_loss else None
        inv_scale = np.float32(1.0) / np.float32(
            self.loss_scale_state.loss_scale)
        grad_norm = -1.0
        if overflow:
            self.lamb_coeffs = torch.zeros(
                self._n_groups if hasattr(self.optimizer_obj, "max_coeff")
                else 0
            )
        else:
            # unscale and clip as one factor (the JAX engine's grad_scale)
            grad_norm = np.float32(raw) * inv_scale
            gscale = inv_scale
            clip = float(self.config.gradient_clipping or 0.0)
            if clip > 0 and grad_norm > clip and grad_norm > 0:
                gscale = gscale * (np.float32(clip) / grad_norm)
            kw = {"mom": self._current_mom()} if self._use_mom else {}
            if self._host_grads is not None:
                grads = self._host_grads
            params = self._masters()
            aux = self.optimizer_obj.apply(
                params, grads, self.optimizer_state,
                self._current_lr(), grad_scale=float(gscale), **kw,
            )
            if self.host_offload:
                # the new compute-dtype parameters go to the device only
                # after a step that was taken
                self.publish_params()
            elif self._zero is not None and self._zero.sharded:
                self._publish_shards(params)
            elif self._tp_full_opt:
                self._publish_model_slices(self.params)
            coeffs = aux.get("lamb_coeffs", [])
            self.lamb_coeffs = (torch.stack(coeffs) if coeffs
                                else torch.zeros(0))
            grad_norm = float(grad_norm)
        self._grad_buffer = None
        # the gradient shards live from a window's first backward to its
        # update only: between windows the forward's activations have the
        # memory
        self._shard_store = None
        self.loss_scale_state = update_scale(self.loss_scale_state, overflow)
        self.last_overflow = overflow
        return overflow, grad_norm, window_loss, host_loss

    def _finish_step(self, overflow, grad_norm, window_loss, host_loss):
        """Post-update host bookkeeping (the JAX engine's _finish_step):
        step counters and the LR schedule, the step line and the
        breakdowns, the monitor's Train/* scalars and the telemetry's
        window end."""
        self._last_window_loss = window_loss
        self._last_grad_norm = grad_norm
        self._window_open = False
        # the JAX engine's async bf16/fp32 path queues the LR read before
        # the schedule steps, its fp16 path reads it after; the monitor
        # follows each (the JAX engine writes each at the step index the
        # window settles at, which the port knows at once)
        lr_before = self._current_lr()
        if overflow:
            self.skipped_steps += 1
            log_dist(
                f"OVERFLOW: skipping step; loss scale -> "
                f"{self.loss_scale_state.loss_scale}", ranks=[0],
            )
        else:
            self.global_steps += 1
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
        # close the samples/s window the data loader opened at its handoff
        self.tput_timer.stop(report_speed=True)
        if self.global_steps and self.global_steps % self.steps_per_print() == 0:
            log_dist(
                f"step={self.global_steps}, skipped={self.skipped_steps}, "
                f"lr={self.get_lr()}, loss_scale="
                f"{self.loss_scale_state.loss_scale}", ranks=[0],
            )
            if self.wall_clock_breakdown:
                self._log_breakdown()
            if self.memory_breakdown:
                log_dist(SynchronizedWallClockTimer.memory_usage(self.device),
                         ranks=[0])
        if self.monitor.enabled and not overflow:
            lr = (self._current_lr() if self.config.fp16_enabled
                  else lr_before)
            scalars = {"Train/lr": lr,
                       "Train/loss_scale": float(
                           self.loss_scale_state.loss_scale)}
            if host_loss is not None:
                scalars["Train/loss"] = host_loss
            if grad_norm >= 0.0:
                scalars["Train/grad_norm"] = grad_norm
            self.monitor.write_scalars(scalars, self.global_steps)
        if self.telemetry.enabled:
            # the window loss goes in as a device tensor: the telemetry
            # settles it only at its export boundaries
            self.telemetry.on_window_end(
                loss=window_loss,
                grad_norm=grad_norm,
                loss_scale=self.loss_scale_state.loss_scale,
                lr=self.get_lr()[0],
                global_steps=self.global_steps,
                skipped_steps=self.skipped_steps,
                micro_steps=self.micro_steps,
            )
        # the step boundary, in the JAX engine's order: the injected stall
        # (before the supervisor, so that a long one escalates in the same
        # window), the supervisor's detectors, then the preemption drain
        if self.faults.enabled:
            self.faults.maybe_stall("step.stall")
        if self.supervisor is not None:
            self._window_rolled_back = self.supervisor.on_window(
                self, window_loss)
            if self._window_rolled_back:
                # the boundary no longer exists: no drain on it
                return
        self._maybe_preemption_save()

    def _maybe_preemption_save(self):
        """Honour an armed preemption drain: commit one final checkpoint
        at this step boundary, then exit through the original signal
        disposition (or disarm and train on with ``exit_after_save``
        false)."""
        res = self.resilience
        if res.preemption is None:
            return
        armed = res.preemption_armed
        if self.mesh.topology.world_size > 1:
            # every rank sees the OR of the ranks' flags at the same step
            # boundary: a signal reaches one process, and a rank that
            # entered save_checkpoint alone would wait in its barrier while
            # the others ran the next window's collectives (the JAX
            # engine's allgather of the flag; one int a boundary, only
            # with the drain enabled)
            flag = torch.tensor([int(armed)], dtype=torch.int32,
                                device=self.device)
            dist_lib.all_reduce(flag, self._world_group,
                                op=torch.distributed.ReduceOp.MAX)
            armed = bool(flag.item())
            if armed and not res.preemption_armed:
                res.preemption.arm()  # mirror the other rank's signal
        if not armed:
            return
        save_dir = res.preemption_save_dir or self._last_checkpoint_dir
        if not save_dir:
            warn_once(
                "preemption-no-save-dir",
                "preemption drain armed but no save target is known (no "
                "resilience.preemption.save_dir configured and the engine "
                "has not saved or loaded a checkpoint yet) — no final "
                "checkpoint will be written",
            )
            return
        if res.preemption_exit_after_save:
            # the process exits after this save: stop the staging workers
            # (bounded waits). The staged-but-unconsumed windows are
            # dropped; the restart replays the data order from this
            # checkpoint. A drain that keeps training keeps the pipeline,
            # whose pulled windows it still needs.
            self.close_data_pipeline()
        tag = f"{res.preemption_tag_prefix}_global_step{self.global_steps}"
        log_dist(
            f"preemption drain: saving final checkpoint {tag} to "
            f"{save_dir}", ranks=[-1],
        )
        self.save_checkpoint(save_dir, tag=tag)
        # counts the save, then exits by re-raising the captured signal
        # (or just disarms when exit_after_save is off)
        res.finish_preemption_save()

    def _log_breakdown(self):
        """The wall-clock breakdown at a print boundary: the train_batch
        window's mean and samples/s, then forward/backward/step per
        printed step (the JAX engine's lines). Reading the timers waits
        for their last events: the breakdown's only syncs."""
        if self.timers.has_timer(TRAIN_BATCH_TIMER):
            n_windows = max(1, self._tb_windows)
            win_s = self.timers(TRAIN_BATCH_TIMER).elapsed(
                reset=True) / n_windows
            self._tb_windows = 0
            if win_s > 0:
                sps = self.train_batch_size() / win_s
                log_dist(
                    f"train_batch window: {win_s * 1e3:.1f} ms avg "
                    f"| {sps:.1f} samples/s", ranks=[0],
                )
        names = [n for n in (FORWARD_TIMER, BACKWARD_TIMER, STEP_TIMER)
                 if self.timers.has_timer(n)]
        if names:
            self.timers.log(names, normalizer=self.steps_per_print())

    def flush_monitor(self):
        """Flush the monitor's scalars and settle the telemetry's trailing
        windows (one host sync) into its exporters. Call before reading
        the sinks at the end of training."""
        if self.monitor.enabled and self.monitor.writer is not None:
            self.monitor.writer.flush()
        self.telemetry.flush()

    def close(self):
        """Stop the data pipeline's workers, then flush and close the
        monitor and the telemetry (its exporters, trace files, profiler
        window and watchdog)."""
        self.close_data_pipeline()
        self.flush_monitor()
        self.monitor.close()
        self.telemetry.close()

    def train_batch(self, batch_iter_or_batches):
        """One accumulation window: ``gradient_accumulation_steps``
        micro-batches from the iterable (each a tuple of model inputs, or
        one input), forward/backward each, then ``step()``. Returns the
        window's mean unscaled loss (a device tensor).

        With the run supervisor (``resilience.supervisor``) this is the
        self-healing entry point: an anomalous window or a recoverable
        window failure rolls the engine back to the last committed
        checkpoint and the window re-runs (from the rewound
        :class:`~deepspeed_tpu_torch.resilience.ReplayableDataSource`, or
        from a fresh iterator over a list); when the budget is spent,
        :class:`~deepspeed_tpu_torch.resilience.SupervisorEscalation`."""
        sup = self.supervisor
        if sup is None:
            return self._train_batch_once(batch_iter_or_batches)
        sup.note_source(batch_iter_or_batches)
        while True:
            self._window_rolled_back = False
            try:
                loss = self._train_batch_once(batch_iter_or_batches)
            except (StopIteration, SupervisorEscalation):
                raise
            except Exception as exc:
                if not sup.on_failure(self, exc):
                    raise
                continue  # rolled back; re-run from the rewound source
            if self._window_rolled_back:
                # the returned loss belongs to the discarded timeline
                continue
            return loss

    def _train_batch_once(self, batch_iter_or_batches):
        """One window: ``accum`` micro-batches, forward/backward each, then
        the step. With the ``data_pipeline`` block and a persistent
        iterator (the same object across calls: a generator, a loader's
        iterator), the window comes from the stager, already on the card;
        the numerics are the same either way."""
        accum = self.gradient_accumulation_steps()
        if self._staging_enabled and not self.host_offload:
            # offload steps on the host: the JAX engine bypasses its
            # stager there, and so does the port
            stager = self._ensure_stager(batch_iter_or_batches)
            if stager is not None:
                return self._train_batch_staged(stager)
        it = iter(batch_iter_or_batches)
        batches = []
        for _ in range(accum):
            try:
                batch = next(it)
            except StopIteration:
                if not batches:
                    # a clean end of the data at a window boundary: the
                    # end-of-stream signal of a loop "until the data runs
                    # out"
                    raise
                # mid-window dry is a data-sizing bug; a bare StopIteration
                # would silently end an enclosing generator
                raise ragged_window_error(len(batches), accum) from None
            if not isinstance(batch, (tuple, list)):
                batch = (batch,)
            batches.append(tuple(batch))
        if self.faults.enabled:
            # the window's placement on the device: the JAX engine's
            # staging.device_put seam
            self.faults.maybe_raise("staging.device_put")
        return self._run_window(batches)

    def _run_window(self, batches):
        """Forward/backward over the window's micro-batches, then the
        step: the shared tail of the staged and unstaged paths. Returns
        the window's mean unscaled loss (a device tensor)."""
        poison = (self.faults.enabled
                  and self.faults.fire("grads.nan") is not None)
        if self._training:
            self._open_window()
        if self.wall_clock_breakdown:
            self.timers(TRAIN_BATCH_TIMER).start()
            self._window_timed = True
        with torch.profiler.record_function("window_fwd_bwd"):
            for batch in batches:
                if poison:
                    batch = _poison_first_float_leaf(batch)
                loss = self.forward(*batch)
                self.backward(loss)
        self.step()
        return self._last_window_loss

    def _ensure_stager(self, source):
        """The window stager serving ``source``, made at its first sight.
        None (= run unstaged) when staging cannot help: a source that is
        not an iterator, batches a loader staged already, or a caller
        passing a fresh iterator object every window (detected by churn),
        which leaves the stager nothing to pull ahead."""
        if self._stager is not None:
            if source is self._stager_source:
                return self._stager
            # a new source: the old stream's staged windows belong to a
            # dead timeline, and their pulled-ahead data is lost
            dropped = self._stager.unconsumed_micro_batches()
            if dropped:
                warn_once(
                    "stager-source-changed-dropped-data",
                    "window stager torn down on a source change with %d "
                    "staged-but-unconsumed micro-batches (already pulled "
                    "from the previous iterator) — alternating live "
                    "iterators across train_batch() calls loses their "
                    "prefetched items; exhaust one stream before "
                    "switching, or disable data_pipeline staging",
                    dropped,
                )
            churned = self._stager.windows_served <= 1
            self._close_stager()
            self._stager_churn = self._stager_churn + 1 if churned else 0
        if self._stager_churn >= 2:
            # two single-window stagers in a row: the caller passes a new
            # iterator each call. Not a latch: the same source seen twice
            # re-engages staging.
            if source is not self._last_unstaged_source:
                self._last_unstaged_source = source
                warn_once(
                    "stager-fresh-iterator-churn",
                    "data_pipeline staging paused for this engine: "
                    "train_batch() keeps receiving a NEW iterator object "
                    "per window, so nothing can be staged ahead — pass "
                    "one persistent iterator (a generator / "
                    "itertools.cycle / a dataloader iterator) to overlap "
                    "input staging",
                )
                return None
            self._stager_churn = 0
            self._last_unstaged_source = None
        if getattr(source, "already_staged", False):
            # the loader's worker staged these batches (one micro-batch a
            # window): a second stager would copy them again
            return None
        try:
            if iter(source) is not source:
                return None
        except TypeError:
            return None
        # The stager owns the seed chain while attached: it draws each
        # window's seeds from its own copy of the generator, and the state
        # after the draw comes back with the window. It holds no engine
        # reference (the fault hook closes over the injector only), and
        # the finalizer closes it when the engine is collected: an
        # abandoned engine leaks no thread.
        rng = None
        if self._takes_seed:
            rng = torch.Generator()
            rng.set_state(self._rng.get_state())
        faults = self.faults
        fault_fn = faults.maybe_raise if faults.enabled else None
        tel_on = self.telemetry.enabled
        self._stager = WindowStager(
            source=source,
            accum=self.gradient_accumulation_steps(),
            device=self.device,
            rng=rng,
            split_fn=_split_window_keys if rng is not None else None,
            buffers=self._staging_buffers,
            stage_to_device=self._stage_to_device,
            telemetry=self.telemetry if tel_on else None,
            fault_fn=fault_fn,
        )
        self._stager_source = source
        self._stager_finalizer = weakref.finalize(self, self._stager.close)
        return self._stager

    def close_data_pipeline(self):
        """Stop the staging workers (the engine's window stager and those
        of loaders ``deepspeed_io`` built) and drop their staged-but-
        unconsumed windows. Runs on source exhaustion or change, engine
        collection, the preemption drain and a supervisor's rollback;
        call it when abandoning an engine mid-stream."""
        self._close_stager()
        for ref in self._data_loaders:
            loader = ref()
            if loader is not None:
                loader.close_staging()

    def _close_stager(self):
        if self._stager is not None:
            if self._stager_finalizer is not None:
                self._stager_finalizer.detach()
                self._stager_finalizer = None
            self._stager.close()
            self._stager = None
            self._stager_source = None

    def _train_batch_staged(self, stager):
        """Consume one staged window: its micro-batches are on the card
        (or copied now, without stage_to_device) and its seeds drawn."""
        try:
            window = stager.get_window()
        except Exception:
            # a clean end (StopIteration) and a staging failure alike end
            # this stream
            self._close_stager()
            raise
        # the compute stream waits for the window's copy
        window.wait()
        if window.keys is not None:
            # adopt the pre-drawn chain
            self._window_seeds = list(window.keys)
            self._rng.set_state(window.rng_after)
        return self._run_window(window.arrays)

    def deepspeed_io(self, dataset, batch_size=None, route=C.ROUTE_TRAIN):
        """Build the data loader (the reference's deepspeed_io). Training
        loaders shuffle (seeded) and feed the throughput timer and the
        ``dataloader/*`` telemetry; their batches are pinned on a CUDA
        device. With the ``data_pipeline`` block at one micro-batch a
        window (and ``stage_to_device``) the loader stages itself and
        ``train_batch`` adds no stager; otherwise the engine's stager
        consumes its host batches."""
        if batch_size is None:
            # the global micro-batch: each rank loads its own rows of it
            batch_size = (self.train_micro_batch_size_per_gpu()
                          * self.dp_world_size)
        is_train = route == C.ROUTE_TRAIN
        loader_stages = (
            is_train and self._staging_enabled and self._stage_to_device
            and self.gradient_accumulation_steps() == 1
        )
        loader = DeepSpeedDataLoader(
            dataset,
            batch_size=batch_size,
            mesh=self.mesh,
            collate_fn=self.collate_fn,
            shuffle=is_train,
            tput_timer=self.tput_timer if is_train else None,
            telemetry=self.telemetry if is_train else None,
            stage_to_device=loader_stages,
            staging_buffers=self._staging_buffers,
            device=self.device,
        )
        # weak: close_data_pipeline must not pin the loader (and its
        # dataset) to the engine
        self._data_loaders.append(weakref.ref(loader))
        return loader
