"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
of its own with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries land in
``build/torch_kernels/`` at the root of the checkout, named by a digest
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source rebuilds and an unchanged one is reused. ``build()`` starts one ``nvcc`` per source, all
at once. Nothing here runs at import: the CPU tests import every module
on a machine with no ``nvcc``.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` turns a
nonzero return into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "--ptxas-options=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# the dropout arguments of the flash kernels: on/off, threshold, keep
# (1 - rate), seed
_DROPOUT = [_I, _U, _F, _U]

# source name -> {C entry point: argtypes}; every entry point returns int
SIGNATURES = {
    "flash_fwd": {
        # q, k, v, kv_mask (or NULL), out, lse, B, H, Sq, Sk, D, dtype,
        # causal, sm_scale, dropout..., block_k (0: the default form),
        # stream
        "ds_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _F, *_DROPOUT, _I, _P],
    },
    "flash_bwd": {
        # q, k, v, kv_mask (or NULL), dout, lse, delta, dq, B, H, Sq, Sk,
        # D, dtype, causal, sm_scale, dropout..., stream
        "ds_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _F, *_DROPOUT, _P],
        # as above with dk, dv in place of dq
        "ds_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _F, *_DROPOUT, _P],
    },
    "lamb_phase1": {
        # table, block_map, nblocks, wsq, usq, grad dtype, 1/c1, 1/c2,
        # grad_scale, b1, 1-b1, b2, 1-b2, eps, weight_decay,
        # eps_inside_sqrt, stream
        "ds_lamb_phase1": [_P, _P, _I, _P, _P, _I, _F, _F, _F, _F, _F, _F,
                           _F, _F, _F, _I, _P],
    },
    "paged_decode": {
        # q, k_pool, v_pool, block_tables, positions, out, workspace,
        # counters (both NULL with one split), B, heads, hd, block_size,
        # max_blocks, splits, dtype, sm_scale, stream
        "ds_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _F, _P],
    },
    "sgmv": {
        # x, a_pool, b_pool, ids, out, B, rows, in, rank, out_dim, dtype,
        # stream
        "ds_sgmv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # x, a_pool, b_pool, ids, y, y_out, scale, B, rows, in, rank,
        # out_dim, dtype, stream
        "ds_sgmv_add": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I,
                        _P],
    },
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_libs = {}
_lock = threading.Lock()


def dtype_code(dtype):
    """The C interface's dtype code: 0 float32, 1 bfloat16, 2 float16."""
    return _DTYPE_CODES[dtype]


def check(err, name):
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {err}"
        )


def nvcc_path():
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use"
    )


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to: keyed by source and flags."""
    src = CSRC_DIR / f"{name}.cu"
    data = src.read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        data += header.read_bytes()
    digest = hashlib.sha1(
        data + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None):
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns
    ``{name: compiler output}`` (the ptxas register/spill report) for what
    it compiled; raises with the compiler's output on a failure."""
    names = list(SIGNATURES) if names is None else list(names)
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, out,
        )
    if procs:
        # on stderr: a node agent's or worker's stdout is its protocol
        print(f"kernel_lib: building {', '.join(procs)} in {BUILD_DIR}",
              file=sys.stderr, flush=True)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        report[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name):
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed; argtypes and restype set from :data:`SIGNATURES`."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{name}: no CUDA device; the kernel runs only on the card"
            )
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib
