"""The port tests' process settings (not a test module).

A port test module imports :func:`jax_compile_cache` (an autouse fixture)
and calls nothing else:

    from torch_test_env import jax_compile_cache  # noqa: F401

Importing this module runs PyTorch on one thread: the test workers share
the machine's cores, and the port's in-process references and rank
processes are too small to gain from threads (the rank spawns of
tests/torch_dp_ranks.py run on one thread as well, so an in-process
reference sums in their order).

The fixture gives the worker's JAX a persistent compilation cache under
the run's temporary directory (pytest's base temp of this worker, so no
state outlives the run and no two processes write one file). The JAX
engines of the oracles compile fresh ``jit`` closures for every engine,
so the same program compiles again case after case; with the cache the
second compile is a read. Every JAX test that runs later in the same
worker reads and writes the same cache: what a program computes does not
change, only where its executable comes from.
"""

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(scope="session", autouse=True)
def jax_compile_cache(tmp_path_factory):
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    path = tmp_path_factory.getbasetemp() / "jax_compile_cache"
    if jax.config.jax_compilation_cache_dir != str(path):
        path.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        # a compile before this point decided the process's cache use;
        # ask again at the next one
        compilation_cache.reset_cache()
    yield path
