"""The kernel build cache, pointed from the ``"compile_cache"`` config
block at ``initialize()``.

Port of deepspeed_tpu/runtime/compile_cache.py. The JAX package arms
XLA's persistent compilation cache, so that a restart (a preemption
restart included) reuses compiled programs. The port's compiled programs
are the ``nvcc`` libraries of ``ops/kernel_lib.py``, one per CUDA source,
named by a digest of the source, its headers and the flags: the block
moves their directory (``kernel_lib.BUILD_DIR``), and a second
``initialize()`` with the same directory loads them with no rebuild.

    {"compile_cache": {"enabled": true, "cache_dir": "/var/cache/ds_kernels"}}

With the block off or ``cache_dir`` empty the libraries stay in
``build/torch_kernels/`` of the checkout, which ``.gitignore`` lists.
``min_compile_time_secs`` is validated as in the JAX package and has no
counterpart here: every library is cached whole, however fast it built.
An unwritable directory warns and keeps the default: the cache is an
optimization, never a failure. Libraries already loaded in the process
stay loaded; the directory decides where the next build goes and what it
finds.
"""

import os
from pathlib import Path

from ..ops import kernel_lib
from ..utils.logging import log_dist, warn_once

DEFAULT_BUILD_DIR = kernel_lib.BUILD_DIR


def default_cache_dir():
    return str(DEFAULT_BUILD_DIR)


def arm_compile_cache(cache_dir, min_compile_time_secs=1.0):
    """Point the kernel build cache at ``cache_dir``. Returns the armed
    directory, or None when the directory cannot be used (the default
    then stays). ``min_compile_time_secs`` has no counterpart (see the
    module docstring)."""
    del min_compile_time_secs
    if not cache_dir:
        return None
    path = Path(os.path.abspath(os.path.expanduser(cache_dir)))
    if path == kernel_lib.BUILD_DIR:
        return str(path)
    try:
        path.mkdir(parents=True, exist_ok=True)
        if not os.access(path, os.W_OK):
            raise PermissionError(f"{path} is not writable")
    except OSError as e:
        warn_once(
            "compile-cache-unavailable",
            "kernel build cache unavailable, keeping %s: %s",
            kernel_lib.BUILD_DIR, e,
        )
        return None
    kernel_lib.BUILD_DIR = path
    log_dist(f"kernel build cache: {path}", ranks=[0])
    return str(path)


def disarm_compile_cache():
    """Back to the default directory (tests arm it at temporary paths)."""
    kernel_lib.BUILD_DIR = DEFAULT_BUILD_DIR


def configure_compile_cache(config):
    """Arm the cache from a validated DeepSpeedConfig (the ``initialize()``
    entry point). No-op unless the block enables it; an empty
    ``cache_dir`` keeps the default directory."""
    if not getattr(config, "compile_cache_enabled", False):
        return None
    return arm_compile_cache(
        config.compile_cache_dir or default_cache_dir(),
        min_compile_time_secs=config.compile_cache_min_compile_time_secs,
    )
