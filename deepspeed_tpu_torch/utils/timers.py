"""Wall-clock and throughput timers.

Port of deepspeed_tpu/utils/timers.py (DeepSpeed's deepspeed_timer.py):

- ``SynchronizedWallClockTimer``: named start/stop timers. On a CUDA
  device each ``start()``/``stop()`` records a CUDA event on the device's
  current stream and returns at once; the time between the events is
  read only when the timer is read (``elapsed()``, ``log()``), which
  waits for the last stop event. So the timers add no host sync to the
  steps they time: the device time of each phase is summed from its
  event pairs. On the CPU (the caller asked for it) they read the host
  clock. Where the JAX package swallowed a failing fence, a timer that
  cannot record or read its events raises.
- ``ThroughputTimer``: samples/sec with a warmup ``start_step`` and
  periodic reporting, fenced (``torch.cuda.synchronize``) only at its
  report boundaries.
"""

import time

import torch

from .logging import log_dist, logger


def _cuda_device(device):
    """``device`` as a CUDA ``torch.device``, or None for the CPU (host
    clock). A CUDA device without a GPU raises."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA-event timers need a CUDA device; pass device='cpu' for "
            "host-clock timers"
        )
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class SynchronizedWallClockTimer:
    class Timer:
        def __init__(self, name, device=None):
            self.name_ = name
            self._device = _cuda_device(device)
            self.elapsed_ = 0.0  # settled seconds
            self.started_ = False
            self.start_time = 0.0  # host clock at start()
            self._host_elapsed = 0.0  # host seconds (the snapshot's view)
            self._start_event = None
            self._pairs = []  # recorded (start, stop) events not yet read

        def start(self):
            if self.started_:
                raise RuntimeError(f"timer {self.name_} has already been started")
            if self._device is not None:
                self._start_event = torch.cuda.Event(enable_timing=True)
                self._start_event.record(
                    torch.cuda.current_stream(self._device))
            self.start_time = time.time()
            self.started_ = True

        def stop(self):
            if not self.started_:
                raise RuntimeError(f"timer {self.name_} is not started")
            now = time.time()
            self._host_elapsed += now - self.start_time
            if self._device is not None:
                stop_event = torch.cuda.Event(enable_timing=True)
                stop_event.record(torch.cuda.current_stream(self._device))
                self._pairs.append((self._start_event, stop_event))
                self._start_event = None
            else:
                self.elapsed_ += now - self.start_time
            self.started_ = False

        def _settle(self):
            """Fold the recorded event pairs into ``elapsed_``: waits for
            the last stop event (the timer's only sync)."""
            if not self._pairs:
                return
            self._pairs[-1][1].synchronize()
            for begin, end in self._pairs:
                self.elapsed_ += begin.elapsed_time(end) / 1000.0
            self._pairs = []

        def reset(self):
            self.elapsed_ = 0.0
            self._host_elapsed = 0.0
            self._pairs = []
            self._start_event = None
            self.started_ = False

        def elapsed(self, reset=True):
            started = self.started_
            if started:
                self.stop()
            self._settle()
            elapsed = self.elapsed_
            if reset:
                self.reset()
            if started:
                self.start()
            return elapsed

    def __init__(self, device=None):
        """``device``: a CUDA device times with CUDA events on its current
        stream; None or the CPU times with the host clock."""
        self.timers = {}
        self.device = device
        _cuda_device(device)  # a CUDA device without a GPU raises here

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name, device=self.device)
        return self.timers[name]

    def has_timer(self, name):
        return name in self.timers

    def snapshot(self):
        """Non-destructive ``{name: elapsed_seconds}`` view on the host
        clock, including the running portion of started timers. No
        device sync and no timer state change: safe to call from another
        thread (the telemetry watchdog reads this for stall reports)."""
        now = time.time()
        out = {}
        # list(): the training thread may register a first-use timer while
        # the watchdog thread iterates
        for name, timer in list(self.timers.items()):
            elapsed = timer._host_elapsed
            if timer.started_:
                elapsed += now - timer.start_time
            out[name] = elapsed
        return out

    def log(self, names, normalizer=1.0, reset=True, ranks=None):
        if not normalizer > 0.0:
            raise ValueError(f"normalizer must be > 0, got {normalizer}")
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed:.2f}"
        log_dist(string, ranks=ranks or [0])

    @staticmethod
    def memory_usage(device=None):
        """The device's allocated and peak allocated bytes (PyTorch's
        caching allocator), or ``n/a`` without a CUDA device."""
        if device is None:
            if not torch.cuda.is_available():
                return "device mem: n/a"
            device = torch.cuda.current_device()
        device = torch.device(device)
        if device.type != "cuda":
            return "device mem: n/a"
        in_use = torch.cuda.memory_allocated(device) / (1024**3)
        peak = torch.cuda.max_memory_allocated(device) / (1024**3)
        return f"device mem: {in_use:.2f} GB in use | {peak:.2f} GB peak"


def device_fence(device):
    """The fence of ``device``: ``torch.cuda.synchronize`` on a CUDA
    device, nothing on the CPU (PyTorch's CPU ops are synchronous)."""
    cuda = _cuda_device(device)
    if cuda is None:
        return lambda: None
    return lambda: torch.cuda.synchronize(cuda)


class ThroughputTimer:
    def __init__(
        self,
        batch_size,
        num_workers,
        start_step=2,
        steps_per_output=50,
        monitor_memory=True,
        logging_fn=None,
        fence_fn=None,
    ):
        # fence_fn: drains the device before a report boundary (the
        # engine passes device_fence(its device)); none on the CPU
        self.fence_fn = fence_fn or (lambda: None)
        self.start_time = 0.0
        self.end_time = 0.0
        self.started = False
        self.batch_size = max(1, batch_size or 1)
        self.num_workers = num_workers
        self.start_step = start_step
        self.epoch_count = 0
        self.local_step_count = 0
        self.total_step_count = 0
        self.total_elapsed_time = 0.0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or logger.info
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.local_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        self._init_timer()
        self.started = True
        if self.total_step_count >= self.start_step:
            if self.total_step_count == self.start_step:
                # open the measurement on a quiet device; later steps run
                # unfenced (a per-step fence would throttle the loop it
                # observes)
                self.fence_fn()
            self.start_time = time.time()

    def stop(self, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.total_step_count += 1
        self.local_step_count += 1
        if self.total_step_count > self.start_step:
            if (
                report_speed
                and self.local_step_count % self.steps_per_output == 0
            ):
                # fence only at report boundaries: the queue drain lands in
                # this window's duration, so the accumulated elapsed time
                # stays truthful without a sync every step
                self.fence_fn()
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            if report_speed and self.local_step_count % self.steps_per_output == 0:
                avg = self.avg_samples_per_sec()
                if avg > 0:
                    self.logging(
                        "{}/{}, SamplesPerSec={:.3f}".format(
                            self.epoch_count,
                            self.local_step_count,
                            avg,
                        )
                    )
                if self.monitor_memory:
                    try:
                        import psutil
                    except ImportError:
                        pass
                    else:
                        vm = psutil.virtual_memory()
                        self.logging(
                            f"{self.epoch_count}/{self.local_step_count}, "
                            f"vm percent: {vm.percent}"
                        )

    def avg_samples_per_sec(self):
        if self.total_step_count > self.start_step and self.total_elapsed_time > 0:
            samples = self.batch_size * (self.total_step_count - self.start_step)
            return samples / self.total_elapsed_time
        # pre-warmup there is no measurement: 0.0 is the no-data-yet
        # sentinel (stop() skips the report line while it holds)
        return 0.0
