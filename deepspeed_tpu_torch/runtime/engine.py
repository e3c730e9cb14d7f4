"""DeepSpeedEngine: the training engine, on one device.

Port of the single-device subset of deepspeed_tpu/runtime/engine.py,
with the reference's contract:

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

Not ported, refused with ``DeepSpeedConfigError("... not yet ported")``:
more than one device (world size > 1, a mesh), the ``resilience``,
``data_pipeline`` and ``compile_cache`` blocks,
``zero_optimization.offload_optimizer``, compensated masters,
reduced-precision optimizer state, sparse gradients, ``training_data``
(the dataloader), checkpoints, optimizers other than Adam/AdamW/Lamb/
FusedLamb, and a model with remat, MoE or pipeline stages. ZeRO stages
0-3 are accepted: at world size 1 the JAX engine lays every stage out as
stage 0.
"""

import inspect
from collections.abc import Mapping

import numpy as np
import torch
from torch.func import functional_call

from ..adapters import lora as lora_lib
from ..config import constants as C
from ..config.config import DeepSpeedConfig, DeepSpeedConfigError, not_ported
from ..config.config_utils import load_config_json
from ..ops.head_dims import check_head_dim, model_head_dim
from ..ops.optimizers import Optimizer, build_optimizer, param_groups
from ..telemetry.manager import build_telemetry
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from ..utils.monitor import Monitor
from ..utils.numerics import global_norm, has_overflow
from ..utils.timers import SynchronizedWallClockTimer, device_fence
from .lr_schedules import build_lr_scheduler
from .precision import loss_scale_state_from_config, update_scale

_REFUSED_BLOCKS = (C.RESILIENCE, C.DATA_PIPELINE, C.COMPILE_CACHE)

# the JAX engine's timer names
FORWARD_TIMER = "forward"
BACKWARD_TIMER = "backward"
STEP_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch_window"


def _requested(raw, key):
    """A config block is asked for unless absent, empty, or
    ``{"enabled": false}``."""
    block = raw.get(key)
    if not block:
        return False
    return not (isinstance(block, dict) and block.get("enabled") is False)


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
                 mesh=None, rng_seed=0, device=None, args=None):
        # ---- config ---------------------------------------------------
        raw = config_params
        if raw is None and args is not None:
            raw = getattr(args, "deepspeed_config", None)
        if isinstance(raw, str):
            raw = load_config_json(raw)
        raw = dict(raw or {})
        for key in _REFUSED_BLOCKS:
            if _requested(raw, key):
                raise not_ported(f"the {key!r} block")
        if mesh is not None or raw.get(C.MESH):
            raise not_ported("training over a device mesh")
        self.config = DeepSpeedConfig(None, param_dict=raw, training=True)
        cfg = self.config
        if cfg.world_size > 1:
            raise not_ported(
                f"training across devices (world size {cfg.world_size})"
            )
        if cfg.zero_config.offload_optimizer_device != "none":
            raise not_ported("zero_optimization.offload_optimizer")
        if cfg.master_dtype != "fp32":
            raise not_ported(f"data_types.master_dtype={cfg.master_dtype!r}")
        if cfg.optimizer_state_dtype != "fp32":
            raise not_ported(
                f"data_types.optimizer_state_dtype="
                f"{cfg.optimizer_state_dtype!r}"
            )
        if cfg.sparse_gradients_enabled:
            raise not_ported("sparse_gradients")
        if training_data is not None:
            raise not_ported("training_data (the dataloader)")
        # what the card's kernels cannot take is refused here, not mid-step
        mcfg = getattr(model, "config", None)
        check_head_dim(model_head_dim(mcfg),
                       getattr(mcfg, "n_positions", 0), device)
        self.device = resolve_device(device)

        # ---- model ----------------------------------------------------
        if not isinstance(model, torch.nn.Module):
            raise TypeError("model must be a torch.nn.Module whose forward "
                            "returns the scalar loss")
        for field, off in (("remat", False), ("moe_experts", 0),
                           ("pipeline_stages", 1)):
            if getattr(mcfg, field, off) != off:
                raise not_ported(f"a model with {field}="
                                 f"{getattr(mcfg, field)!r}")
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
        self.frozen_base_params = {}
        if cfg.adapters_enabled:
            self._configure_adapters(model_parameters, rng_seed)

        # ---- optimizer and schedule -------------------------------------
        # the trainable fp32 masters: every parameter, or under the
        # adapters block only the LoRA factors
        self.params = {
            n: p for n, p in self.module.named_parameters()
            if n not in self.frozen_base_params
        }
        if optimizer is not None:
            if not isinstance(optimizer, Optimizer):
                raise TypeError("client optimizer must be a "
                                "deepspeed_tpu_torch.ops.optimizers.Optimizer")
            self.optimizer_obj = optimizer
        else:
            name = cfg.optimizer_name or C.ADAM_OPTIMIZER
            if name not in C.PORTED_OPTIMIZERS:
                raise not_ported(f"optimizer {name!r}")
            self.optimizer_obj = build_optimizer(name, cfg.optimizer_params)
        self.optimizer_state = self.optimizer_obj.init(self.params)
        self._n_groups = len(param_groups(self.params))
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
        self._rng = torch.Generator().manual_seed(int(rng_seed))
        self._grad_buffer = None
        # the accumulation buffer kept across windows when the gradients
        # are cast into it (compute dtype != accumulation dtype)
        self._grad_store = None
        self._pending = None  # (loss, compute-dtype params) of a forward
        self._window_losses = []  # the window's unscaled losses (device)
        self._last_window_loss = None
        self.micro_steps = 0
        self.global_steps = 0
        self.skipped_steps = 0
        self.last_overflow = False
        self.lamb_coeffs = torch.zeros(0)
        self._training = True

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
        self._tb_windows = 0  # train_batch windows since the last print
        self._window_timed = False  # a train_batch window timer runs
        self._window_open = False  # the telemetry's window has started
        self._n_params = sum(
            p.numel() for p in self.module.parameters())
        # the telemetry block: a no-op facade when it is absent
        self.telemetry = build_telemetry(
            cfg, rank=0, n_params=self._n_params, timers=self.timers,
            fence_fn=device_fence(self.device), device=self.device,
        )
        log_dist(
            f"DeepSpeedEngine initialized: device={self.device} "
            f"zero_stage={self.zero_stage} dtype={self.compute_dtype} "
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
        optimizer's own b1."""
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                     "get_mom"):
            mom = self.lr_scheduler.get_mom()
            if mom is not None:
                return float(mom[0] if isinstance(mom, (list, tuple)) else mom)
        return float(self.optimizer_obj.b1)

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

    def save_checkpoint(self, *args, **kwargs):
        raise not_ported("save_checkpoint")

    def load_checkpoint(self, *args, **kwargs):
        raise not_ported("load_checkpoint")

    # ------------------------------------------------------------------
    # training API
    # ------------------------------------------------------------------
    def _batch(self, inputs):
        """Inputs on the engine's device; floating ones in the compute
        dtype (integer ids and labels untouched)."""
        out = []
        for x in inputs:
            x = torch.as_tensor(x, device=self.device)
            if x.is_floating_point():
                x = x.to(self.compute_dtype)
            out.append(x)
        return tuple(out)

    def _call(self, params, batch):
        kwargs = {}
        if self._takes_train:
            kwargs["train"] = self._training
        if self._takes_seed:
            kwargs["dropout_seed"] = int(
                torch.randint(0, 2**31 - 1, (), generator=self._rng)
            )
        return functional_call(self.module, params, batch, kwargs)

    def forward(self, *inputs):
        """Run the model on one micro-batch and return its loss. In train
        mode the graph is kept for the following ``backward()``."""
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
                loss = self._call(self._cast_params(grad=False), batch)
        else:
            params = self._cast_params(grad=True)
            loss = self._call(params, batch)
            self._pending = (loss, params)
        if self.wall_clock_breakdown:
            self.timers(FORWARD_TIMER).stop()
        return loss

    __call__ = forward

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
        """The fp32 masters in the compute dtype, as leaf tensors (with
        ``grad``, requiring gradients) for ``functional_call``, beside the
        frozen base under the adapters block."""
        out = dict(self.frozen_base_params)
        for name, p in self.params.items():
            t = p.detach().to(self.compute_dtype)
            out[name] = t.requires_grad_() if grad else t
        return out

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
        loss, params = self._pending
        self._pending = None
        self._window_losses.append(loss.detach().float())
        scale = self.loss_scale_state.loss_scale
        (loss.float() * scale / self.gradient_accumulation_steps()).backward()
        grads = {
            n: t.grad if t.grad is not None else torch.zeros_like(t)
            for n, t in params.items() if n in self.params
        }
        if self._grad_buffer is not None:
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

    def zero_grad(self):
        self._grad_buffer = None
        self._window_losses = []

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
        raw_norm = global_norm(grads.values())  # -1.0 if inf/nan
        if self.config.fp16_enabled:
            overflow = has_overflow(grads.values())
        else:
            overflow = raw_norm < 0.0
        # the step's one host sync: the skip decision and the norm, and
        # the window loss when the monitor writes it
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
            aux = self.optimizer_obj.apply(
                self.params, grads, self.optimizer_state,
                self._current_lr(), grad_scale=float(gscale), **kw,
            )
            coeffs = aux.get("lamb_coeffs", [])
            self.lamb_coeffs = (torch.stack(coeffs) if coeffs
                                else torch.zeros(0))
            grad_norm = float(grad_norm)
        self._grad_buffer = None
        self.loss_scale_state = update_scale(self.loss_scale_state, overflow)
        self.last_overflow = overflow
        return overflow, grad_norm, window_loss, host_loss

    def _finish_step(self, overflow, grad_norm, window_loss, host_loss):
        """Post-update host bookkeeping (the JAX engine's _finish_step):
        step counters and the LR schedule, the step line and the
        breakdowns, the monitor's Train/* scalars and the telemetry's
        window end."""
        self._last_window_loss = window_loss
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
        """Flush and close the monitor and the telemetry (its exporters,
        trace files, profiler window and watchdog)."""
        self.flush_monitor()
        self.monitor.close()
        self.telemetry.close()

    def train_batch(self, batch_iter_or_batches):
        """One accumulation window: ``gradient_accumulation_steps``
        micro-batches from the iterable (each a tuple of model inputs, or
        one input), forward/backward each, then ``step()``. Returns the
        window's mean unscaled loss (a device tensor)."""
        accum = self.gradient_accumulation_steps()
        it = iter(batch_iter_or_batches)
        # a clean end of the data (StopIteration at a window boundary)
        # leaves here, before the window opens
        batch = next(it)
        if self._training:
            self._open_window()
        if self.wall_clock_breakdown:
            self.timers(TRAIN_BATCH_TIMER).start()
            self._window_timed = True
        with torch.profiler.record_function("window_fwd_bwd"):
            for i in range(accum):
                if i:
                    try:
                        batch = next(it)
                    except StopIteration:
                        raise RuntimeError(
                            f"data iterator ran dry mid-window: collected "
                            f"{i} of gradient_accumulation_steps={accum} "
                            "micro-batches"
                        ) from None
                if not isinstance(batch, (tuple, list)):
                    batch = (batch,)
                loss = self.forward(*batch)
                self.backward(loss)
        self.step()
        return self._last_window_loss
