"""Monitoring: scalar event streams (TensorBoard, with a JSONL writer).

Port of deepspeed_tpu/utils/monitor.py: the engine's rank-0 ``Train/*``
scalar streams behind the ``tensorboard`` config block. PyTorch's
``SummaryWriter`` is used when the ``tensorboard`` package is installed;
otherwise events append to ``events.jsonl`` in the same directory (one
``{tag, value, step, wall_time}`` object per line), so a machine without
that package still records the training curves.
"""

import json
import math
import os
import time

from .logging import logger


class JsonlSummaryWriter:
    """Minimal SummaryWriter-compatible scalar sink: one JSON object per
    line {tag, value, step, wall_time}. Also the backing writer of the
    telemetry JSONL exporter (telemetry/exporters.py)."""

    def __init__(self, log_dir, filename="events.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, filename)
        self._fd = open(self._path, "a")

    def add_scalar(self, tag, value, global_step=None):
        value = float(value)
        record = {
            "tag": tag,
            "value": value,
            "step": global_step,
            "wall_time": time.time(),
        }
        if not math.isfinite(value):
            # json.dumps would emit bare NaN/Infinity — valid Python, not
            # RFC 8259 JSON, and strict downstream parsers choke on it.
            # Non-finite scalars serialize as null with an explicit marker.
            record["value"] = None
            record["finite"] = False
        self._fd.write(json.dumps(record, allow_nan=False) + "\n")

    def add_record(self, record):
        """Write one pre-built JSON object (telemetry histogram records)."""
        self._fd.write(json.dumps(record, allow_nan=False) + "\n")

    def flush(self):
        self._fd.flush()

    def close(self):
        self._fd.close()


def get_summary_writer(
    name="DeepSpeedJobName",
    base=os.path.join(os.path.expanduser("~"), "tensorboard"),
):
    """Create a scalar writer under ``base/name`` (reference
    deepspeed_light.py:374-381's directory convention)."""
    log_dir = os.path.join(base, name)
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except ImportError:
        logger.info(
            "torch tensorboard unavailable; writing scalar events to %s",
            os.path.join(log_dir, "events.jsonl"),
        )
        return JsonlSummaryWriter(log_dir)


class Monitor:
    """Engine-facing facade: no-ops unless enabled on this process (rank 0
    writes, like the reference's ``self.tensorboard_enabled() and
    self.global_rank == 0`` guards)."""

    def __init__(self, enabled, output_path="", job_name="DeepSpeedJobName"):
        self.enabled = enabled
        self.writer = None
        if enabled:
            base = output_path or os.path.join(
                os.path.expanduser("~"), "tensorboard"
            )
            self.writer = get_summary_writer(name=job_name, base=base)

    def write_scalars(self, scalars, step):
        if not self.writer:
            return
        for tag, value in scalars.items():
            self.writer.add_scalar(tag, value, global_step=step)
        self.writer.flush()

    def close(self):
        if self.writer:
            self.writer.close()
