"""The port stands alone: no file under deepspeed_tpu_torch/, and not
chip_smoke.py, imports jax, flax or the JAX package (deepspeed_tpu), and
none names a module of the JAX package to launch (``python -m``) or to
import by string (``importlib.import_module``)."""

import ast
from pathlib import Path

import pytest
from torch_test_env import jax_compile_cache  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "deepspeed_tpu")


def _sources():
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def _launched_modules(path):
    """Module names a source passes by string: the element after ``"-m"``
    in a list or tuple literal (a subprocess command line), and the first
    argument of ``import_module`` / ``__import__``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.List, ast.Tuple)):
            elts = node.elts
            for flag, name in zip(elts, elts[1:]):
                if (isinstance(flag, ast.Constant) and flag.value == "-m"
                        and isinstance(name, ast.Constant)
                        and isinstance(name.value, str)):
                    yield name.value
        elif isinstance(node, ast.Call) and node.args:
            func = node.func
            fname = getattr(func, "attr", None) or getattr(func, "id", None)
            arg = node.args[0]
            if (fname in ("import_module", "__import__")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                yield arg.value


def test_the_scan_covers_the_package():
    files = _sources()
    assert len(files) > 20 and all(f.exists() for f in files)


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_flax_or_deepspeed_tpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_package_module_launched_or_imported_by_name(path):
    bad = [m for m in _launched_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad} by string"


def test_the_launch_scan_sees_the_port_launches_and_a_jax_one(tmp_path):
    """The port's worker and node launches are seen (so the scan reads
    them), and a JAX module passed to ``-m`` or ``import_module`` is
    caught."""
    pkg = ROOT / "deepspeed_tpu_torch" / "serving"
    assert list(_launched_modules(pkg / "provisioner.py")) == [
        "deepspeed_tpu_torch.serving.node"]
    assert list(_launched_modules(pkg / "replica.py")) == [
        "deepspeed_tpu_torch.serving.worker"]
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import importlib, subprocess, sys\n"
        "subprocess.Popen([sys.executable, '-m',\n"
        "                  'deepspeed_tpu.serving.node', '--port', '0'])\n"
        "importlib.import_module('deepspeed_tpu.ops.attention')\n"
        "__import__('jax')\n"
        "cmd = ('python', '-m', 'deepspeed_tpu_torch.serving.worker')\n"
    )
    assert sorted(m for m in _launched_modules(probe) if _forbidden(m)) == [
        "deepspeed_tpu.ops.attention", "deepspeed_tpu.serving.node", "jax",
    ]


def test_the_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import os\nfrom deepspeed_tpu.ops import attention\n"
        "def f():\n    import jax.numpy as jnp\n"
    )
    assert [m for m in _imported_modules(probe) if _forbidden(m)] == [
        "deepspeed_tpu.ops", "jax.numpy",
    ]
    assert not _forbidden("deepspeed_tpu_torch.ops")


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    """The AST scan cannot see a module named in a string
    (``importlib.import_module``); a fresh interpreter that imports the
    port, its telemetry, timers, monitor, ZeRO config, resilience,
    checkpoints, data path, activation API, quantized optimizer state,
    BERT, the host spill tier, the serving fleet (its node agent
    included) and the fleet hub must end with
    neither ``jax`` nor ``deepspeed_tpu`` in ``sys.modules``."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import deepspeed_tpu_torch\n"
        "import deepspeed_tpu_torch.telemetry\n"
        "import deepspeed_tpu_torch.utils.timers\n"
        "import deepspeed_tpu_torch.utils.monitor\n"
        "import deepspeed_tpu_torch.config.zero_config\n"
        "import deepspeed_tpu_torch.config.activation_checkpointing_config\n"
        "import deepspeed_tpu_torch.version\n"
        "import deepspeed_tpu_torch.resilience\n"
        "import deepspeed_tpu_torch.runtime.checkpointing\n"
        "import deepspeed_tpu_torch.runtime.host_ops\n"
        "import deepspeed_tpu_torch.runtime.dataloader\n"
        "import deepspeed_tpu_torch.runtime.staging\n"
        "import deepspeed_tpu_torch.runtime.compile_cache\n"
        "import deepspeed_tpu_torch.checkpointing\n"
        "import deepspeed_tpu_torch.ops.quant\n"
        "import deepspeed_tpu_torch.models.bert\n"
        "import deepspeed_tpu_torch.inference.host_tier\n"
        "import deepspeed_tpu_torch.serving\n"
        "import deepspeed_tpu_torch.serving.node\n"
        "import deepspeed_tpu_torch.telemetry.hub\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deepspeed_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
