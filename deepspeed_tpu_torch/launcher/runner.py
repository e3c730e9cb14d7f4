"""Multi-host runner: ``python -m deepspeed_tpu_torch.launcher.runner
<script> ...`` for GPU hosts.

Port of deepspeed_tpu/launcher/runner.py (upstream deepspeed_run.py:
88-335): an MPI-style hostfile (``hostname slots=N``, a slot being a
GPU), ``--include`` / ``--exclude`` node:slot filters, the base64 world
info handed to the per-node launch, a single-node exec or a fan-out over
pdsh (plain ssh when pdsh is absent, or with ``--launcher ssh``), and
``--force_multi``. Each node's launch (launcher/launch.py) starts one
process per slot.

Without a hostfile the run is local: its slots are ``--num_gpus`` when
given, else ``torch.cuda.device_count()`` (under ``CUDA_VISIBLE_DEVICES``
the slots are the devices it lists); with neither, one process. The JAX
runner's ``--tpu`` pod discovery and ``launcher/cloud.py`` provision and
find TPU VMs; a GPU host has no such metadata, and the hostfile is the
whole description of the pool, so the port offers neither.

Environment: variables under EXPORT_PREFIXES (upstream's NCCL and
PYTHON, and the port's DS_TPU) plus any ``KEY=VALUE`` lines in
``~/.deepspeed_env`` / ``./.deepspeed_env`` are exported to every worker
(upstream deepspeed_run.py:249-275).
"""

import argparse
import base64
import collections
import json
import os
import shlex
import shutil
import subprocess
import sys

from ..config.constants import TORCH_DISTRIBUTED_DEFAULT_PORT
from ..utils.logging import logger
from .launch import run_children

DLTS_HOSTFILE = "/job/hostfile"
# upstream exports NCCL*/PYTHON* (deepspeed_run.py:21); DS_TPU* carries the
# port's own switches
EXPORT_PREFIXES = ["NCCL", "PYTHON", "DS_TPU"]
DEEPSPEED_ENVIRONMENT_NAME = ".deepspeed_env"
DEEPSPEED_ENVIRONMENT_PATHS = [os.path.expanduser("~"), "."]


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="deepspeed_tpu_torch runner: launch multi-GPU, "
        "multi-host training jobs, one process per GPU."
    )
    parser.add_argument(
        "-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
        help="MPI-style hostfile defining the resource pool "
        "(e.g. 'worker-0 slots=8' — slots are GPUs).",
    )
    parser.add_argument(
        "-i", "--include", type=str, default="",
        help="Resources to use: NODE_SPEC[@NODE_SPEC ...] where "
        "NODE_SPEC=NAME[:SLOT[,SLOT ...]]; omitted :SLOT means all slots.",
    )
    parser.add_argument(
        "-e", "--exclude", type=str, default="",
        help="Resources to skip; same format as --include, mutually "
        "exclusive with it.",
    )
    parser.add_argument("--num_nodes", type=int, default=-1)
    parser.add_argument(
        "--num_gpus", type=int, default=-1,
        help="GPUs per node to use (without a hostfile: the local "
        "processes; default torch.cuda.device_count()).",
    )
    parser.add_argument(
        "--master_port", type=int, default=int(TORCH_DISTRIBUTED_DEFAULT_PORT),
        help="Port of the torch.distributed TCP store.",
    )
    parser.add_argument(
        "--master_addr", type=str, default="",
        help="Rendezvous address; inferred from `hostname -I` if empty.",
    )
    parser.add_argument(
        "--launcher", type=str, default="auto", choices=("auto", "pdsh", "ssh"),
        help="Multi-node fan-out mechanism.",
    )
    parser.add_argument(
        "--force_multi", action="store_true",
        help="Use the multi-node code path even on a single host.",
    )
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def fetch_hostfile(hostfile_path):
    """Parse 'hostname slots=N' lines -> OrderedDict(host -> slot count).
    Returns None when the file is absent (single-host local run)."""
    if not os.path.isfile(hostfile_path):
        logger.warning(
            "no hostfile at %s — falling back to a single-host run on "
            "local GPUs", hostfile_path,
        )
        return None
    resource_pool = collections.OrderedDict()
    with open(hostfile_path) as fd:
        for line in fd.readlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                hostname, slots = line.split()
                _, slot_count = slots.split("=")
                slot_count = int(slot_count)
            except ValueError:
                logger.error(
                    "bad hostfile line %r (expected 'hostname slots=N')", line
                )
                raise
            if hostname in resource_pool:
                raise ValueError(f"host {hostname} is already defined")
            resource_pool[hostname] = slot_count
    return resource_pool


def parse_resource_filter(host_info, include_str="", exclude_str=""):
    """Filter {host: [slot, ...]} by an include or exclude expression.

    Format: NODE_SPEC[@NODE_SPEC ...], NODE_SPEC = NAME[:SLOT[,SLOT ...]].
    Same semantics as the reference (deepspeed_run.py:116-205): include
    builds the pool from scratch, exclude subtracts; hosts left with zero
    slots are dropped; output preserves hostfile ordering.
    """
    if include_str and exclude_str:
        raise ValueError("include_str and exclude_str are mutually exclusive.")
    if not include_str and not exclude_str:
        return host_info

    filtered_hosts = {}
    if include_str:
        parse_str = include_str
    else:
        filtered_hosts = {h: list(s) for h, s in host_info.items()}
        parse_str = exclude_str

    for node_config in parse_str.split("@"):
        if ":" in node_config:
            hostname, slot_str = node_config.split(":")
            slots = [int(x) for x in slot_str.split(",")]
            if hostname not in host_info:
                raise ValueError(f"Hostname '{hostname}' not found in hostfile")
            for s in slots:
                if s not in host_info[hostname]:
                    raise ValueError(
                        f"No slot '{s}' specified on host '{hostname}'"
                    )
            if include_str:
                filtered_hosts[hostname] = slots
            else:
                for s in slots:
                    logger.info("excluding slot %s on host %s", s, hostname)
                    filtered_hosts[hostname].remove(s)
        else:
            hostname = node_config
            if hostname not in host_info:
                raise ValueError(f"Hostname '{hostname}' not found in hostfile")
            if include_str:
                filtered_hosts[hostname] = host_info[hostname]
            else:
                filtered_hosts[hostname] = []

    for hostname in list(filtered_hosts):
        filtered_hosts[hostname] = sorted(set(filtered_hosts[hostname]))
        if not filtered_hosts[hostname]:
            del filtered_hosts[hostname]

    ordered_hosts = collections.OrderedDict(
        (host, filtered_hosts[host]) for host in host_info if host in filtered_hosts
    )
    return ordered_hosts


def parse_inclusion_exclusion(resource_pool, inclusion, exclusion):
    active_resources = collections.OrderedDict(
        (hostname, list(range(slots))) for hostname, slots in resource_pool.items()
    )
    return parse_resource_filter(
        active_resources, include_str=inclusion, exclude_str=exclusion
    )


def encode_world_info(world_info):
    return base64.urlsafe_b64encode(json.dumps(world_info).encode()).decode()


def _infer_master_addr():
    result = subprocess.check_output("hostname -I", shell=True)
    return result.decode().split()[0]


def local_gpu_count():
    """The local GPUs torch sees (0 without CUDA)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _visible_slots(count):
    """The first ``count`` local slots: the ids ``CUDA_VISIBLE_DEVICES``
    lists when it is set (the launch sets it again for the children),
    else 0..count-1."""
    visible = [v.strip() for v in
               os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    if not visible:
        return list(range(count))
    return [int(v) if v.isdigit() else v for v in visible[:count]]


def _collect_exports():
    """Env vars to replicate on every worker: prefix-matched + .deepspeed_env."""
    exports = {}
    for var, val in os.environ.items():
        if any(var.startswith(p) for p in EXPORT_PREFIXES):
            exports[var] = val
    for path in DEEPSPEED_ENVIRONMENT_PATHS:
        env_file = os.path.join(path, DEEPSPEED_ENVIRONMENT_NAME)
        if os.path.isfile(env_file):
            with open(env_file) as fd:
                for line in fd.readlines():
                    line = line.strip()
                    if line and not line.startswith("#"):
                        key, val = line.split("=", 1)
                        exports[key.strip()] = val.strip()
    return exports


def main(args=None):
    args = parse_args(args)
    resource_pool = fetch_hostfile(args.hostfile)

    if not resource_pool and (args.include or args.exclude):
        raise ValueError(
            "include/exclude resource filters require a hostfile"
        )
    if args.num_nodes >= 0 or args.num_gpus >= 0:
        if args.include or args.exclude:
            raise ValueError("Cannot specify num_nodes/gpus with include/exclude")

    multi_node_exec = True
    local = not resource_pool
    if local:
        resource_pool = collections.OrderedDict()
        resource_pool["localhost"] = (
            args.num_gpus if args.num_gpus > 0 else local_gpu_count())
        args.master_addr = "127.0.0.1"
        multi_node_exec = False

    active_resources = parse_inclusion_exclusion(
        resource_pool, args.include, args.exclude
    )
    if args.num_nodes > 0:
        updated = collections.OrderedDict()
        for count, (host, slots) in enumerate(active_resources.items()):
            if count >= args.num_nodes:
                break
            updated[host] = slots
        active_resources = updated
    if args.num_gpus > 0:
        active_resources = collections.OrderedDict(
            (host, list(range(args.num_gpus))) for host in active_resources
        )
    if local:
        active_resources["localhost"] = _visible_slots(
            len(active_resources["localhost"]))

    if len(active_resources) <= 1 and not args.force_multi:
        multi_node_exec = False
    if not args.master_addr:
        args.master_addr = _infer_master_addr() if multi_node_exec else "127.0.0.1"

    world_info = encode_world_info(
        {host: slots for host, slots in active_resources.items()}
    )

    launch_cmd = [
        sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
        f"--world_info={world_info}",
        f"--master_addr={args.master_addr}",
        f"--master_port={args.master_port}",
    ]

    if not multi_node_exec:
        cmd = launch_cmd + ["--node_rank=0", args.user_script] + args.user_args
        logger.info("cmd = %s", " ".join(cmd))
        sys.exit(run_children([(cmd, os.environ.copy())]))

    exports = _collect_exports()
    export_str = " ".join(
        f"export {k}={shlex.quote(v)};" for k, v in exports.items()
    )
    hosts = list(active_resources.keys())

    def remote_command(node_rank_token):
        # node_rank may be pdsh's %n token (left unquoted so pdsh can
        # substitute it); everything user-supplied is shell-quoted.
        quoted_launch = " ".join(shlex.quote(p) for p in launch_cmd)
        quoted_user = " ".join(
            shlex.quote(p) for p in [args.user_script] + args.user_args
        )
        return (
            f"{export_str} cd {shlex.quote(os.getcwd())}; "
            f"{quoted_launch} --node_rank={node_rank_token} {quoted_user}"
        )

    use_pdsh = args.launcher == "pdsh" or (
        args.launcher == "auto" and shutil.which("pdsh") is not None
    )
    if use_pdsh:
        # pdsh hands every node the same command; %n (the sequential host
        # index) becomes the node rank, with a hostname-lookup fallback in
        # launch.resolve_node_rank.
        cmds = [[
            "pdsh", "-f", "1024", "-w", ",".join(hosts), remote_command("%n"),
        ]]
    else:
        cmds = [[
            "ssh", "-o", "StrictHostKeyChecking=no", host,
            remote_command(str(rank)),
        ] for rank, host in enumerate(hosts)]
    for cmd in cmds:
        logger.info("cmd = %s", " ".join(cmd))
    sys.exit(run_children([(cmd, os.environ.copy()) for cmd in cmds]))


if __name__ == "__main__":
    main()
