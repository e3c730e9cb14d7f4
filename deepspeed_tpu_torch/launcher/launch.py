"""Per-node launcher: decode the world info, start one process per GPU
slot of this node, and wait on them all.

Port of deepspeed_tpu/launcher/launch.py, with upstream's process model
(deepspeed_launch.py:105-118) in place of the JAX package's one process
per host. For node ``n`` whose slots are ``s_0..s_k``, child ``i`` gets:

  DS_TPU_PROCESS_ID, RANK      the slots of the hosts before ``n``, + i
  DS_TPU_NUM_PROCESSES,
  WORLD_SIZE                   every slot of every host
  LOCAL_RANK                   i (runtime/dist.py binds ``cuda:i``)
  CUDA_VISIBLE_DEVICES         s_0,...,s_k
  DS_TPU_COORDINATOR_ADDRESS,
  MASTER_ADDR, MASTER_PORT     the rendezvous of the TCP store

A host with no slots (no GPU was counted) runs one process. The user's
arguments pass through unchanged; scripts read ``LOCAL_RANK`` from the
environment (no ``--local_rank`` argument is added).

The children are started in sessions of their own. A SIGTERM or SIGINT
to the launcher is forwarded once to every child, so that each rank's
preemption drain (resilience/preemption.py) sees exactly one signal.
When a child exits non-zero before any signal came, the rest are
terminated (SIGTERM, then SIGKILL after a grace period) and the launcher
exits with that child's code: a rank left alone would block in its next
collective until the backend's timeout.

``DS_TPU_LATENCY_HIDING`` arms XLA's TPU scheduler flags in the JAX
launcher; they have no CUDA meaning, and the port ignores the variable.
"""

import argparse
import base64
import json
import os
import signal
import socket
import subprocess
import sys
import time

from ..config.constants import TORCH_DISTRIBUTED_DEFAULT_PORT
from ..utils.logging import logger

FORWARDED_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def parse_args(args=None):
    parser = argparse.ArgumentParser(description="per-node GPU launcher")
    parser.add_argument("--node_rank", type=str, default="0",
                        help="This node's rank; pdsh substitutes %%n.")
    parser.add_argument("--master_addr", type=str, default="127.0.0.1")
    parser.add_argument(
        "--master_port", type=int,
        default=int(TORCH_DISTRIBUTED_DEFAULT_PORT),
    )
    parser.add_argument("--world_info", type=str, default="e30=",
                        help="base64-encoded {host: [gpu, ...]} dict")
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def decode_world_info(encoded):
    return json.loads(base64.urlsafe_b64decode(encoded).decode())


def resolve_node_rank(args, world_info):
    """pdsh hands every node the same command line; %n (or a hostname
    lookup) recovers the per-node rank."""
    node_rank = args.node_rank
    if node_rank.isdigit():
        return int(node_rank)
    hosts = list(world_info.keys())
    hostname = socket.gethostname()
    for i, h in enumerate(hosts):
        if hostname == h or hostname.split(".")[0] == h.split(".")[0]:
            return i
    raise ValueError(
        f"cannot resolve node rank: hostname {hostname!r} not in world "
        f"info {hosts}"
    )


def _processes(slots):
    """The processes a host runs: one per slot, one for a host with none."""
    return max(len(slots), 1)


def build_env(args, world_info, node_rank, local_rank=0):
    """The environment of child ``local_rank`` on node ``node_rank``."""
    env = os.environ.copy()
    hosts = list(world_info.keys())
    world = sum(_processes(s) for s in world_info.values()) or 1
    first = sum(_processes(world_info[h]) for h in hosts[:node_rank])
    rank = first + local_rank
    env["DS_TPU_COORDINATOR_ADDRESS"] = f"{args.master_addr}:{args.master_port}"
    env["DS_TPU_NUM_PROCESSES"] = str(world)
    env["DS_TPU_PROCESS_ID"] = str(rank)
    # the names upstream's launcher exports, for scripts that read them
    env["RANK"] = str(rank)
    env["WORLD_SIZE"] = str(world)
    env["LOCAL_RANK"] = str(local_rank)
    env["MASTER_ADDR"] = args.master_addr
    env["MASTER_PORT"] = str(args.master_port)
    if hosts and world_info[hosts[node_rank]]:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(
            map(str, world_info[hosts[node_rank]]))
    return env


def build_envs(args, world_info, node_rank):
    """One environment per process of node ``node_rank``."""
    hosts = list(world_info.keys())
    n = _processes(world_info[hosts[node_rank]]) if hosts else 1
    return [build_env(args, world_info, node_rank, i) for i in range(n)]


def exit_code(returncode):
    """A child's return code as a shell reports it: 128 + N for a child
    that signal N ended."""
    return 128 - returncode if returncode < 0 else returncode


def run_children(cmds_envs, grace=10.0, poll=0.05):
    """Start one child per ``(cmd, env)`` in a session of its own, forward
    SIGTERM/SIGINT to every child, and wait on them all (terminating the
    rest when one fails first, see the module docstring). Returns the
    first non-zero exit code, in the order the children ended, else 0."""
    procs, signalled = [], []

    def forward(signum, frame):
        del frame
        signalled.append(signum)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = {s: signal.signal(s, forward) for s in FORWARDED_SIGNALS}
    try:
        for cmd, env in cmds_envs:
            procs.append(subprocess.Popen(cmd, env=env,
                                          start_new_session=True))
        rc, alive, terminated_at = 0, list(procs), None
        while alive:
            for p in [p for p in alive if p.poll() is not None]:
                alive.remove(p)
                code = exit_code(p.returncode)
                if not code or rc:
                    continue
                rc = code
                if alive and not signalled:
                    logger.error(
                        "process %d exited with code %d: terminating the "
                        "other %d", p.pid, code, len(alive))
                    for q in alive:
                        q.terminate()
                    terminated_at = time.monotonic()
            if (terminated_at is not None
                    and time.monotonic() - terminated_at > grace):
                for q in alive:
                    q.kill()
                terminated_at = None
            if alive:
                time.sleep(poll)
        return rc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for s, h in previous.items():
            signal.signal(s, h)


def main(args=None):
    args = parse_args(args)
    world_info = decode_world_info(args.world_info)
    node_rank = resolve_node_rank(args, world_info)
    envs = build_envs(args, world_info, node_rank)
    logger.info(
        "launch node_rank=%s world=%s processes=%d coordinator=%s:%s",
        node_rank, list(world_info.keys()) or ["localhost"], len(envs),
        args.master_addr, args.master_port,
    )
    cmd = [sys.executable, "-u", args.user_script] + args.user_args
    sys.exit(run_children([(cmd, env) for env in envs]))


if __name__ == "__main__":
    main()
