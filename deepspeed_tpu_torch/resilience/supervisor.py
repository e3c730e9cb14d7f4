"""Self-healing run supervision: detect a live run going bad, roll back.

Port of deepspeed_tpu/resilience/supervisor.py. The commit protocol makes
checkpoints survive kills; this module makes the *process*
survive the failures that don't kill it — sustained non-finite losses, a
loss blowup, a wedged input stager, a watchdog-escalated stall. The shape
generalizes DeepSpeed's dynamic loss scaling (detect overflow, skip,
adapt — PAPER.md) from one window to the whole run: detect an anomaly at
the step boundary, roll the engine back to the last committed checkpoint
through the existing verified-load path, rewind the data pipeline
deterministically, and keep training — with a bounded retry budget and a
typed terminal escalation (:class:`SupervisorEscalation`) when healing
stops helping.

Detectors (config ``"resilience": {"supervisor": {...}}``):

- **consecutive non-finite windows**: a window whose loss is non-finite
  or whose global grad norm came back as the -1.0 skip sentinel counts
  as bad; ``nonfinite_window`` consecutive bad windows trigger a
  rollback. One-off overflows stay the loss scaler's job — the threshold
  is the budget beyond which skipping is no longer adapting.
- **relative loss spike**: with ``spike_factor > 0``, a finite loss more
  than ``spike_factor`` times the rolling-window mean (``spike_window``
  samples, armed after ``min_history``) triggers a rollback before the
  spike can poison the parameters.
- **stall escalation**: the telemetry watchdog's stall report arms a
  rollback at the next completed boundary (a wedged stager that recovers
  late, a transient hang) via :meth:`TrainingSupervisor.notify_stall`.

Rollback semantics (bitwise-reproducible — tests pin this):

1. the staged input pipeline closes (``engine.close_data_pipeline``: its
   prefetched windows belong to the discarded timeline), and the engine's
   half-run window is discarded (``engine.discard_window``: the stashed
   forward, the gradient buffer and the window's losses);
2. ``engine.load_checkpoint(resume_dir)`` restores params, optimizer
   state, loss scale, counters AND the dropout-seed generator (the model
   file carries its state) through the manifest-verified,
   corruption-fallback load path;
3. the registered :class:`ReplayableDataSource` rewinds to the restored
   ``micro_steps`` — the replayed run pulls exactly the micro-batches
   the original run trained on after that checkpoint.

A rolled-back run is therefore bitwise-identical to a fresh run resumed
from the same checkpoint. The cost of supervision: one host sync per
window (the detectors read the loss/grad-norm as floats) — enable it on
runs where self-healing beats peak async throughput.
"""

import math
import threading
import time
from collections import deque

from ..telemetry.registry import (
    MetricsRegistry,
    suppressed_errors_snapshot,
)
from ..telemetry.tracing import NOOP_TRACER
from ..utils.logging import log_dist, warn_once


class SupervisorEscalation(RuntimeError):
    """Terminal escalation: the rollback budget is exhausted, no usable
    resume point exists, or the resume point is unloadable. Carries the
    triggering ``reason`` and the ``rollbacks`` spent."""

    def __init__(self, message, reason="", rollbacks=0):
        super().__init__(message)
        self.reason = reason
        self.rollbacks = rollbacks


class ReplayableDataSource:
    """Deterministically rewindable micro-batch stream for supervised runs.

    ``factory(start)`` must return an iterator positioned at micro-batch
    ``start`` of a deterministic stream. The source is a plain persistent
    iterator (``train_batch`` and its window stager consume it
    unchanged), tracks its position, and rebuilds from the factory on
    :meth:`rewind` — the supervisor rewinds it to the restored
    checkpoint's ``micro_steps`` after a rollback. Rewind only with the
    stager closed (the supervisor orders this); position updates are
    GIL-atomic int bumps. Over a data loader the factory is
    ``loader.iter_from``.
    """

    def __init__(self, factory, start=0):
        self._factory = factory
        self.position = int(start)
        self._it = factory(self.position)

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._it)
        self.position += 1
        return item

    def rewind(self, position):
        self.position = int(position)
        self._it = self._factory(self.position)


class TrainingSupervisor:
    """Engine-side anomaly detection + bounded in-process rollback.

    The engine calls :meth:`on_window` at every step boundary and
    :meth:`on_failure` when a window raises; both return True when they
    rolled the engine back (the finished window belongs to a discarded
    timeline — ``train_batch`` retries instead of returning its loss).
    """

    # exception classes a rollback can heal: worker/storage/runtime
    # faults. Config and type errors are the caller's bug — re-raised.
    RECOVERABLE = (RuntimeError, OSError)

    def __init__(self, max_rollbacks=2, nonfinite_window=3,
                 spike_factor=0.0, spike_window=32, min_history=8,
                 registry=None, tracer=None, trace_ctx_fn=None):
        self.max_rollbacks = int(max_rollbacks)
        self.nonfinite_window = int(nonfinite_window)
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        # request/step tracer (telemetry/tracing.py): rollbacks record
        # spans and terminal escalations dump the flight recorder; the
        # NOOP passthrough when tracing is off. trace_ctx_fn (the
        # telemetry facade's train_trace_ctx) parents rollback spans
        # under the run's train trace.
        self._tracer = tracer if tracer is not None else NOOP_TRACER
        self._trace_ctx_fn = trace_ctx_fn
        self.rollbacks = 0
        self._consecutive_bad = 0
        self._history = deque(maxlen=int(spike_window))
        self._resume_dir = None
        self._source = None
        self._stalled = threading.Event()
        reg = registry if registry is not None else MetricsRegistry()
        self._rollbacks_c = reg.counter(
            "resilience/rollbacks",
            help="in-process rollbacks to the last committed checkpoint",
        )
        self._anomalies_c = reg.counter(
            "resilience/anomalies",
            help="anomalous windows detected by the run supervisor",
        )

    # -- engine hooks ---------------------------------------------------
    def note_source(self, source):
        """Track the rewindable data source feeding ``train_batch`` (any
        object with a ``rewind(position)`` method; plain iterators train
        fine but cannot be rewound deterministically)."""
        if hasattr(source, "rewind"):
            self._source = source

    def on_checkpoint(self, save_dir):
        """A checkpoint committed (or loaded): this directory's newest
        valid tag is now the rollback resume point."""
        self._resume_dir = save_dir

    def notify_stall(self, waited=None, last_step=None):
        """Watchdog stall listener: arm a rollback at the next completed
        step boundary (callable from the watchdog's polling thread)."""
        del waited, last_step
        self._stalled.set()

    def on_window(self, engine, loss):
        """Step-boundary anomaly check. Returns True when it rolled the
        engine back. Materializes ``loss`` and the window grad norm
        (the supervisor's per-window host sync)."""
        loss_f = float(loss) if loss is not None else None
        gn = getattr(engine, "_last_grad_norm", None)
        gn_f = float(gn) if gn is not None else 0.0
        # -1.0 is the engine's non-finite-grad-norm skip sentinel
        bad = gn_f < 0.0 or (
            loss_f is not None and not math.isfinite(loss_f)
        )
        reason = None
        if self._stalled.is_set():
            reason = "watchdog-escalated stall"
        elif bad:
            self._consecutive_bad += 1
            if self._consecutive_bad >= self.nonfinite_window:
                reason = (
                    f"{self._consecutive_bad} consecutive non-finite "
                    f"windows (budget {self.nonfinite_window})"
                )
        else:
            self._consecutive_bad = 0
            if (
                self.spike_factor > 0
                and loss_f is not None
                and len(self._history) >= self.min_history
            ):
                mean = sum(self._history) / len(self._history)
                if mean > 0 and loss_f > self.spike_factor * mean:
                    reason = (
                        f"loss spike: {loss_f:.6g} > {self.spike_factor}x "
                        f"rolling mean {mean:.6g}"
                    )
            if reason is None and loss_f is not None:
                self._history.append(loss_f)
        if reason is None:
            return False
        self._anomalies_c.inc()
        self.rollback(engine, reason)
        return True

    def on_failure(self, engine, exc):
        """A window raised. Returns True when the failure was healed by a
        rollback, False when it is not the supervisor's to heal (the
        caller re-raises). Exceptions marked ``ds_unrecoverable`` (e.g.
        the ragged-window data-sizing error) always re-raise: rolling
        back from dataset exhaustion would re-train old windows until
        the budget drains and bury the actionable error."""
        if getattr(exc, "ds_unrecoverable", False):
            return False
        if not isinstance(exc, self.RECOVERABLE):
            return False
        self._anomalies_c.inc()
        self.rollback(engine, f"window failed: {exc!r}")
        return True

    # -- the rollback itself --------------------------------------------
    def _escalate(self, message, reason):
        """Terminal escalation: dump the flight recorder (the last-N
        spans/events around the anomaly) and attach the suppressed-error
        diagnostics — the deliberately swallowed exceptions surface at
        exactly the moment someone starts debugging — then raise."""
        suppressed = suppressed_errors_snapshot()
        dump = self._tracer.dump_flight("supervisor_escalation")
        if suppressed:
            message += f"; suppressed errors: {suppressed}"
        if dump:
            message += f"; flight recorder: {dump}"
        raise SupervisorEscalation(
            message, reason=reason, rollbacks=self.rollbacks
        )

    def rollback(self, engine, reason):
        """Bounded in-process rollback to the last committed checkpoint;
        raises :class:`SupervisorEscalation` when out of budget or
        resume points."""
        resume = self._resume_dir or getattr(
            engine, "_last_checkpoint_dir", None
        )
        if not resume:
            self._escalate(
                f"run anomaly ({reason}) but no committed checkpoint "
                "exists to roll back to — save one before the supervised "
                "loop, or disable the supervisor",
                reason,
            )
        if self.rollbacks >= self.max_rollbacks:
            self._escalate(
                f"rollback budget exhausted ({self.rollbacks}/"
                f"{self.max_rollbacks}) and the run is still anomalous: "
                f"{reason}",
                reason,
            )
        t0 = time.monotonic()
        log_dist(
            f"SUPERVISOR ROLLBACK ({self.rollbacks + 1}/"
            f"{self.max_rollbacks}): {reason}; restoring from {resume}",
            ranks=[-1],
        )
        # staged windows and the half-run window belong to the discarded
        # timeline
        close = getattr(engine, "close_data_pipeline", None)
        if close is not None:
            close()
        engine.discard_window()
        path, _ = engine.load_checkpoint(resume)
        if path is None:
            self._escalate(
                f"rollback failed: no loadable checkpoint under "
                f"{resume!r} (see resilience/corruption_fallbacks)",
                reason,
            )
        if self._source is not None:
            self._source.rewind(engine.micro_steps)
        else:
            warn_once(
                "supervisor-no-rewindable-source",
                "rollback restored model state but the data source has "
                "no rewind(position) — the replay is NOT "
                "bitwise-reproducible (wrap the stream in "
                "ReplayableDataSource for deterministic healing)",
            )
        self._history.clear()
        self._consecutive_bad = 0
        self._stalled.clear()
        self.rollbacks += 1
        self._rollbacks_c.inc()
        self._tracer.record(
            "train.supervisor_rollback", t0, time.monotonic(),
            ctx=self._trace_ctx_fn() if self._trace_ctx_fn else None,
            attrs={"reason": reason, "rollback": self.rollbacks,
                   "resume_dir": str(resume)},
        )


def build_supervisor(config, registry=None, tracer=None,
                     trace_ctx_fn=None):
    """Construct the engine's supervisor from a validated
    DeepSpeedConfig; None unless the config block enables it."""
    if not getattr(config, "resilience_supervisor_enabled", False):
        return None
    return TrainingSupervisor(
        max_rollbacks=config.resilience_supervisor_max_rollbacks,
        nonfinite_window=config.resilience_supervisor_nonfinite_window,
        spike_factor=config.resilience_supervisor_spike_factor,
        spike_window=config.resilience_supervisor_spike_window,
        min_history=config.resilience_supervisor_min_history,
        registry=registry,
        tracer=tracer,
        trace_ctx_fn=trace_ctx_fn,
    )
