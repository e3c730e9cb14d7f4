"""Node provisioner: the whole-host lifecycle seam (docs/serving.md
"Node failure domain").

Port of deepspeed_tpu/serving/provisioner.py. The node agents and the
autoscaler give the fleet elastic REPLICAS — but only onto node agents
that already exist: without this module a dead node just evicts its
replicas and the fleet permanently shrinks. This module closes the loop
one tier up. A :class:`NodeProvisioner` owns node
AGENTS the way a replica provider owns replicas:

    launch_node(name, spec=None)  -> a health-confirmed NodeHandle
    terminate_node(name)          -> the drain-then-free counterpart
    list_nodes()                  -> {name: NodeHandle} still owned

The autoscaler's :class:`~.autoscaler.SocketNodeProvider` consults it
when a spawn finds zero placeable capacity: a known-dead node is
re-provisioned under the SAME name (new address, fresh process) so its
replacement replicas rejoin behind the breaker's half-open probation,
and a replica target past every live node's ceiling mints a NEW node.
Scale-down retires replicas first; a provisioner-owned node left empty
is terminated whole.

:class:`LocalSubprocessProvisioner` is the real implementation shipped
here: it drives ``python -m deepspeed_tpu_torch.serving.node`` subprocesses
on this host — the single-machine form of a cloud instance pool, and
exactly what the failover drills (``bench.py --smoke-node-failover``)
SIGKILL. The health-confirmed join is two gates: the node's one-line
stdout ``listening`` announcement (printed only after every engine is
built), then a live ``node_info`` round-trip over the control session —
a handle is never returned for a node that cannot answer.

Every launch carries the router incarnation's fencing ``epoch`` in the
confirm dial, so a freshly-provisioned node's high-water mark starts AT
the provisioning router's epoch: a stale incarnation cannot adopt a
node the live router just paid for.
"""

import json
import os
import subprocess
import sys
import threading
import time

from ..telemetry.registry import MetricsRegistry, count_suppressed
from ..utils.logging import logger
from .transport import NodeControlClient


class ProvisionFailed(RuntimeError):
    """A node launch that never reached the health-confirmed join: the
    process died before announcing, the announcement was garbage, or
    the confirm dial found nobody home. The partial launch is torn down
    before this raises — a failed provision leaks no process."""


class NodeHandle:
    """One provisioned node: its name, confirmed ``(host, port)``
    address, and (for process-backed provisioners) the live process."""

    __slots__ = ("name", "address", "proc", "spec")

    def __init__(self, name, address, proc=None, spec=None):
        self.name = str(name)
        self.address = (str(address[0]), int(address[1]))
        self.proc = proc
        self.spec = dict(spec or {})

    @property
    def alive(self):
        proc = self.proc
        return proc is None or proc.poll() is None

    def __repr__(self):
        return (
            f"NodeHandle({self.name!r}, "
            f"{self.address[0]}:{self.address[1]}, "
            f"{'alive' if self.alive else 'dead'})"
        )


class NodeProvisioner:
    """The seam. Implementations own node-agent lifecycles; callers
    (the autoscaler's node tier, the failover drills) see only
    health-confirmed handles."""

    def launch_node(self, name, spec=None):  # pragma: no cover - interface
        raise NotImplementedError

    def terminate_node(self, name):  # pragma: no cover - interface
        raise NotImplementedError

    def list_nodes(self):  # pragma: no cover - interface
        raise NotImplementedError

    def close(self):
        """Terminate everything still owned (shutdown sweep)."""
        for name in list(self.list_nodes()):
            try:
                self.terminate_node(name)
            except Exception as e:
                count_suppressed("serving.provisioner_close", e)


class LocalSubprocessProvisioner(NodeProvisioner):
    """Real node agents as local subprocesses.

    ``node_spec`` is the template each launch instantiates (node.py's
    spec schema); per-launch ``spec`` overrides merge over it and
    ``node_id`` is always forced to the requested name. Nodes launch
    with ``--port 0`` and the ephemeral port resolves from the stdout
    announcement, so N nodes never race for a port.

    ``epoch`` stamps the health-confirm control dial (and is what a
    re-provisioned node's fencing high-water starts at); ``registry``
    mints ``fleet/nodes_provisioned`` / ``fleet/nodes_terminated``.
    """

    def __init__(self, node_spec=None, *, host="127.0.0.1",
                 launch_timeout=120.0, terminate_grace=5.0,
                 epoch=None, registry=None):
        self._template = dict(node_spec or {})
        self._host = str(host)
        self._launch_timeout = float(launch_timeout)
        self._terminate_grace = float(terminate_grace)
        self.epoch = None if epoch is None else int(epoch)
        self._lock = threading.Lock()
        self._nodes = {}  # name -> NodeHandle
        reg = registry if registry is not None else MetricsRegistry()
        self._c_provisioned = reg.counter(
            "fleet/nodes_provisioned",
            help="node agents launched (and health-confirmed) by the "
                 "provisioner",
        )
        self._c_terminated = reg.counter(
            "fleet/nodes_terminated",
            help="node agents terminated by the provisioner",
        )

    # -- the seam --------------------------------------------------------
    def launch_node(self, name, spec=None):
        name = str(name)
        merged = dict(self._template)
        merged.update(spec or {})
        merged["node_id"] = name
        with self._lock:
            existing = self._nodes.get(name)
            if existing is not None and existing.alive:
                raise ProvisionFailed(
                    f"provisioner already owns a live node {name!r} at "
                    f"{existing.address[0]}:{existing.address[1]}"
                )
            # a dead handle under this name is the re-provision case:
            # the replacement supersedes it
            self._nodes.pop(name, None)
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.serving.node",
             "--spec", json.dumps(merged),
             "--host", self._host, "--port", "0"],
            stdout=subprocess.PIPE, stderr=None,
            env=dict(os.environ),
        )
        try:
            address = self._await_announce(name, proc)
            self._confirm_health(name, address)
        except Exception:
            self._kill(proc)
            raise
        handle = NodeHandle(name, address, proc=proc, spec=merged)
        with self._lock:
            self._nodes[name] = handle
        self._c_provisioned.inc()
        logger.info(
            "provisioner: node %s launched and health-confirmed at "
            "%s:%d (pid %d)", name, address[0], address[1], proc.pid,
        )
        return handle

    def terminate_node(self, name):
        with self._lock:
            handle = self._nodes.pop(str(name), None)
        if handle is None:
            raise KeyError(f"provisioner owns no node {name!r}")
        self._kill(handle.proc)
        self._c_terminated.inc()
        logger.info("provisioner: node %s terminated", handle.name)
        return handle

    def list_nodes(self):
        with self._lock:
            return dict(self._nodes)

    # -- internals -------------------------------------------------------
    def _await_announce(self, name, proc):
        """Gate 1 of the health-confirmed join: the node's single stdout
        JSON line, printed only after every engine is built. Read on a
        helper thread so a wedged launch costs ``launch_timeout``, not
        forever."""
        box = {}

        def read():
            try:
                box["line"] = proc.stdout.readline()
            except (OSError, ValueError) as e:  # pragma: no cover - race
                box["exc"] = e

        t = threading.Thread(
            target=read, name=f"ds-provision-{name}-announce", daemon=True,
        )
        t.start()
        t.join(self._launch_timeout)
        if t.is_alive():
            raise ProvisionFailed(
                f"node {name!r} did not announce within "
                f"{self._launch_timeout:.0f}s"
            )
        line = box.get("line")
        if not line:
            raise ProvisionFailed(
                f"node {name!r} exited before announcing its port "
                f"(rc {proc.poll()}, {box.get('exc')!r})"
            )
        try:
            info = json.loads(line)
        except ValueError as e:
            raise ProvisionFailed(
                f"node {name!r} announced garbage {line[:80]!r}: {e}"
            ) from None
        if info.get("event") != "listening":
            raise ProvisionFailed(
                f"node {name!r} announced {info.get('event')!r}, not "
                "'listening'"
            )
        return (str(info["host"]), int(info["port"]))

    def _confirm_health(self, name, address):
        """Gate 2: a live control round-trip. Also stamps this router
        incarnation's epoch as the fresh node's fencing high-water."""
        info = NodeControlClient(
            address, connect_timeout=self._launch_timeout,
            op_timeout=self._launch_timeout, epoch=self.epoch,
        ).node_info()
        if info.get("node") != name:
            raise ProvisionFailed(
                f"node at {address[0]}:{address[1]} answered as "
                f"{info.get('node')!r}, expected {name!r}"
            )

    def _kill(self, proc):
        if proc is None:
            return
        try:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(self._terminate_grace)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(self._terminate_grace)
        except OSError as e:  # pragma: no cover - platform
            count_suppressed("serving.provisioner_kill", e)
        finally:
            stdout = getattr(proc, "stdout", None)
            if stdout is not None:
                try:
                    stdout.close()
                except OSError:
                    pass


class StaticProvisioner(NodeProvisioner):
    """A provisioner over nodes something ELSE launched (tests, a fleet
    whose hosts an external orchestrator owns): launch_node re-confirms
    health at a pre-registered address instead of spawning, and
    terminate only forgets. The injectable seam for unit tests that
    must not fork."""

    def __init__(self, addresses=None, *, epoch=None,
                 confirm_timeout=10.0, control_client=None):
        self._addresses = {
            str(k): v for k, v in dict(addresses or {}).items()
        }
        self.epoch = None if epoch is None else int(epoch)
        self._confirm_timeout = float(confirm_timeout)
        self._ctl = control_client or NodeControlClient
        self._nodes = {}

    def register(self, name, address):
        self._addresses[str(name)] = address
        return self

    def launch_node(self, name, spec=None):
        del spec
        address = self._addresses.get(str(name))
        if address is None:
            raise ProvisionFailed(
                f"static provisioner knows no address for node {name!r}"
            )
        try:
            self._ctl(
                address, connect_timeout=self._confirm_timeout,
                op_timeout=self._confirm_timeout, epoch=self.epoch,
            ).node_info()
        except (OSError, RuntimeError, ValueError) as e:
            raise ProvisionFailed(
                f"node {name!r} at {address!r} failed the health "
                f"confirm: {e}"
            ) from None
        handle = NodeHandle(name, address if not isinstance(address, str)
                            else _split_address(address))
        self._nodes[str(name)] = handle
        return handle

    def terminate_node(self, name):
        handle = self._nodes.pop(str(name), None)
        if handle is None:
            raise KeyError(f"static provisioner owns no node {name!r}")
        return handle

    def list_nodes(self):
        return dict(self._nodes)


def _split_address(address):
    host, _, port = address.rpartition(":")
    return (host or "127.0.0.1", int(port))


def wait_for_node(address, timeout=30.0, poll=0.1, epoch=None):
    """Block until a node agent at ``address`` answers ``node_info``
    (drill/test helper). Returns the info dict; raises TimeoutError."""
    deadline = time.monotonic() + float(timeout)
    last = None
    while time.monotonic() < deadline:
        try:
            return NodeControlClient(
                address, connect_timeout=poll * 10, op_timeout=poll * 10,
                epoch=epoch,
            ).node_info()
        except (OSError, RuntimeError, ValueError) as e:
            last = e
            time.sleep(poll)
    raise TimeoutError(
        f"node at {address!r} not answering after {timeout}s ({last!r})"
    )
