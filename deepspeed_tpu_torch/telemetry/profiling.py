"""Config-driven profiler window.

Port of deepspeed_tpu/telemetry/profiling.py over ``torch.profiler``:
the trace starts when training reaches window ``start_step`` (0-based,
counted in accumulation windows) and stops after ``num_steps`` windows,
then exports a Chrome trace (``trace.json`` under ``output_path``).
Every traced window is wrapped in a ``record_function`` range
(``train_window#<index>``, where the JAX package used
``StepTraceAnnotation``), and the engine labels its phases inside it
(``window_fwd_bwd``, ``window_optimizer_update``).

The window opens at a window's first micro-step and closes after the
last traced window's update, behind ``fence`` (the engine passes a
``torch.cuda.synchronize()`` of its device): a trace that started or
stopped inside a window would lose that window's kernels, whose device
events land after the host has moved on. On a CUDA device the trace
records the CPU and CUDA activities; on the CPU (the caller asked for
it) the CPU activity only.
"""

import os

import torch

from ..utils.logging import log_dist


class ProfilerWindow:
    """Step-counted trace window around the engine's accumulation
    windows. ``fence`` is called before the trace stops."""

    def __init__(self, start_step, num_steps, output_path, fence=None,
                 enabled=True, device=None):
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self.output_path = output_path
        self.trace_path = os.path.join(output_path, "trace.json")
        self.fence = fence
        self.device = torch.device("cpu" if device is None else device)
        self.enabled = enabled and self.start_step >= 0 and self.num_steps > 0
        self._window_index = 0  # windows BEGUN so far
        self._tracing = False
        self._in_window = False
        self._profile = None
        self._annotation = None

    @property
    def tracing(self):
        return self._tracing

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def on_window_start(self):
        """Call when an accumulation window begins (first micro-step's
        forward, or train_batch). Idempotent within a window."""
        if not self.enabled or self._in_window:
            return
        self._in_window = True
        if not self._tracing and self._window_index == self.start_step:
            self._profile = torch.profiler.profile(
                activities=self._activities())
            self._profile.start()
            self._tracing = True
            log_dist(
                f"telemetry profiler: trace window armed at step "
                f"{self._window_index} for {self.num_steps} step(s) -> "
                f"{self.trace_path}",
                ranks=[0],
            )
        if self._tracing:
            self._annotation = torch.profiler.record_function(
                f"train_window#{self._window_index}")
            self._annotation.__enter__()

    def on_window_end(self):
        """Call when the window's update has been issued. Stops the trace
        once the window count is exhausted."""
        if not self.enabled or not self._in_window:
            return
        self._in_window = False
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        self._window_index += 1
        if (
            self._tracing
            and self._window_index >= self.start_step + self.num_steps
        ):
            self._stop()

    def _stop(self):
        if self.fence is not None:
            self.fence()  # the window's kernels land inside the trace
        self._profile.stop()
        os.makedirs(self.output_path, exist_ok=True)
        self._profile.export_chrome_trace(self.trace_path)
        self._profile = None
        self._tracing = False
        self.enabled = False  # one window per run; re-arm via a new config
        log_dist(
            f"telemetry profiler: trace window complete -> "
            f"{self.trace_path}",
            ranks=[0],
        )

    def close(self):
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        if self._tracing:
            self._stop()
