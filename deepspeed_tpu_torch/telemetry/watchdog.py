"""Step-heartbeat watchdog: turn silent hangs into actionable logs.

Port of deepspeed_tpu/telemetry/watchdog.py. A hung collective, a
deadlocked input queue or a wedged kernel look identical from the
outside: the job stops stepping and its scheduler eventually kills it
with nothing in the logs. The watchdog records the time of each
completed accumulation window; if no window lands within ``timeout``
seconds it emits a rank-tagged stall report (live timer snapshot,
device memory, last exported metric values) while the process is still
alive to be inspected, and calls its stall listeners.

The first window is exempt: ``beat()`` with no step never arms an
unarmed watchdog, since the first window owns the CUDA kernels' build at
first use (minutes with a cold build directory). Detection policy
(``check()``) is separated from the polling thread so tests drive it
with a fake clock; the thread is a daemon and never blocks interpreter
exit.
"""

import logging
import threading
import time

from ..utils.logging import log_dist

from .registry import count_suppressed


class StepHeartbeatWatchdog:
    def __init__(
        self,
        timeout,
        poll_interval=None,
        clock=time.monotonic,
        context_fn=None,
        report_fn=None,
    ):
        """``timeout``: seconds without a completed window before a stall
        report fires (once per stall; a subsequent ``beat`` re-arms).
        ``clock``: injectable monotonic time source (tests pass a fake).
        ``context_fn``: zero-arg callable returning a dict of diagnostic
        context merged into the report. ``report_fn``: override for the
        default rank-tagged ERROR log (tests capture reports with it)."""
        if timeout <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout}")
        if poll_interval is not None and poll_interval <= 0:
            # Event.wait(<=0) returns immediately: the polling thread
            # would busy-spin a host core
            raise ValueError(
                f"watchdog poll_interval must be > 0, got {poll_interval}"
            )
        self.timeout = float(timeout)
        self.poll_interval = (
            float(poll_interval)
            if poll_interval is not None
            else max(1.0, self.timeout / 4.0)
        )
        self._clock = clock
        self._context_fn = context_fn
        self._report_fn = report_fn or self._default_report
        self._lock = threading.Lock()
        self._last_beat = None
        self._last_step = None
        self._paused = 0
        self._stall_reported = False
        self.stall_count = 0
        self._stall_listeners = []
        self._thread = None
        self._stop_event = threading.Event()

    def add_stall_listener(self, callback):
        """Register ``callback(waited, last_step)`` to run (on the polling
        thread) after every stall report — the run supervisor's
        stall-escalation hook (resilience/supervisor.py)."""
        self._stall_listeners.append(callback)

    # -- heartbeat ------------------------------------------------------
    def beat(self, step=None):
        """Record liveness. Called with ``step`` from the training loop at
        each completed window; called with ``step=None`` for non-window
        progress (eval forwards) — those keep an ARMED watchdog alive
        without advancing the last-completed-window index. A ``step=None``
        beat never arms an unarmed watchdog: a job that runs a baseline
        eval before its first training window is still owed the
        first-window compilation grace. Also re-arms the stall report
        after a recovery."""
        with self._lock:
            if step is None and self._last_beat is None:
                return
            self._last_beat = self._clock()
            if step is not None:
                self._last_step = step
            self._stall_reported = False

    def pause(self):
        """Suspend stall detection for a phase with no step cadence of its
        own (a checkpoint save can legitimately outlast the timeout).
        Nestable; pair every pause with a resume."""
        with self._lock:
            self._paused += 1

    def resume(self):
        """Re-enable detection; the stall clock restarts NOW, so the
        paused phase's duration never counts against the timeout."""
        with self._lock:
            self._paused = max(0, self._paused - 1)
            if self._paused == 0 and self._last_beat is not None:
                self._last_beat = self._clock()

    def check(self):
        """Evaluate the stall condition now. Returns True when a stall
        report fired on this call. Unarmed (no beat yet) is never a stall:
        the first window legitimately spends minutes in compilation."""
        with self._lock:
            if self._last_beat is None or self._paused or self._stall_reported:
                return False
            waited = self._clock() - self._last_beat
            if waited < self.timeout:
                return False
            self._stall_reported = True
            self.stall_count += 1
            last_step = self._last_step
        self._fire(waited, last_step)
        return True

    def _fire(self, waited, last_step):
        context = {}
        if self._context_fn is not None:
            try:
                context = dict(self._context_fn())
            except Exception as e:
                context = {"context_error": repr(e)}
        try:
            self._report_fn(waited, last_step, context)
        except Exception as e:
            # a failing reporter must not kill the polling thread
            count_suppressed("watchdog.report_fn", e)
        for cb in list(self._stall_listeners):
            try:
                cb(waited, last_step)
            except Exception as e:
                count_suppressed("watchdog.stall_listener", e)

    def _default_report(self, waited, last_step, context):
        lines = [
            f"STEP HEARTBEAT STALL: no training window completed for "
            f"{waited:.1f}s (timeout {self.timeout:.1f}s); last completed "
            f"window index: {last_step}"
        ]
        for key, value in context.items():
            lines.append(f"  {key}: {value}")
        lines.append(
            "  likely causes: hung collective (check every host's log), "
            "dead dataloader producer, a kernel that never returns, or "
            "host-side deadlock"
        )
        # every rank reports: on a pod the MISSING rank's silence is the
        # diagnostic, so the report must not be rank-0-gated
        log_dist("\n".join(lines), ranks=[-1], level=logging.ERROR)

    # -- polling thread -------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_event.clear()

        def _loop():
            while not self._stop_event.wait(self.poll_interval):
                self.check()

        self._thread = threading.Thread(
            target=_loop, name="deepspeed-tpu-step-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop_event.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=self.poll_interval + 1.0)
        self._thread = None
