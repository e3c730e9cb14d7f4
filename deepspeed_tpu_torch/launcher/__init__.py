"""Launcher: the multi-host runner and the per-node launch, one process
per GPU slot (port of deepspeed_tpu/launcher/; upstream bin/deepspeed,
deepspeed_run.py and deepspeed_launch.py).

    python -m deepspeed_tpu_torch.launcher.runner [-H hostfile]
        [--num_gpus N] [-i/-e filter] script.py [script args]
"""

from .runner import (
    encode_world_info,
    fetch_hostfile,
    parse_inclusion_exclusion,
    parse_resource_filter,
)

__all__ = [
    "encode_world_info",
    "fetch_hostfile",
    "parse_inclusion_exclusion",
    "parse_resource_filter",
]
