"""Build and load the CUDA kernels (``csrc/*.cu``) with nvcc + ctypes.

Each source compiles at first use into its own shared library with a plain
C interface under ``hydra_tpu_torch/_build/`` (listed in ``.gitignore``),
named by the hash of the source, the shared header and the flags, so an
edit rebuilds and an unchanged tree reuses the library. ``build`` starts
one nvcc per source at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
HEADERS = ("sweep_kernel.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# source -> its own extra flags. The BayesW draw follows the plain PyTorch
# version operation by operation, so that file forbids contraction into FMA.
SOURCES = {"sweep_kernel.cu": (), "sweep_kernel_bw.cu": ("-fmad=false",),
           "sweep_kernel_mt.cu": (), "planes_kernel.cu": ()}

_p, _i = ctypes.c_void_p, ctypes.c_int
# C entry point -> (argtypes, restype)
_SIGNATURES = {
    "sweep_kernel.cu": {
        "hydra_sweep_stale": ([_p] * 8 + [_i] * 5 + [_p], _i),
        "hydra_sweep_exact": ([_p] * 8 + [_i] * 5 + [_p], _i),
        "hydra_sweep_windows": ([_i] + [_p] * 8 + [_i] * 7 + [_p], _i),
        "hydra_sweep_workspace_bytes": ([_i] * 4, ctypes.c_longlong),
        "hydra_window_grams": ([_p] * 5 + [_i] * 4 + [_p], _i),
        "hydra_sweep_stale_sd": ([_p] * 8 + [_i] * 6 + [_p], _i),
        "hydra_sweep_sd_workspace_bytes": ([_i] * 3, ctypes.c_longlong),
        "hydra_window_stats": ([_p] * 10 + [_i] * 4 + [_p], _i),
        "hydra_window_gibbs": ([_p] * 14 + [_i] * 2 + [_p], _i),
        "hydra_window_workspace_bytes": ([_i] * 4, ctypes.c_longlong),
        "hydra_sweep_error_string": ([_i], ctypes.c_char_p),
    },
    "sweep_kernel_bw.cu": {
        "hydra_sweep_stale_bw": ([_p] * 8 + [_i] + [_p] * 3 + [_i] * 7 + [_p],
                                 _i),
        "hydra_window_level_sums": ([_p] * 7 + [_i] * 3 + [_p], _i),
        "hydra_window_axpy": ([_p] * 5 + [_i] * 3 + [_p], _i),
        "hydra_bw_workspace_bytes": ([_i] * 2, ctypes.c_longlong),
        "hydra_bw_error_string": ([_i], ctypes.c_char_p),
    },
    "sweep_kernel_mt.cu": {
        "hydra_sweep_stale_mt": ([_p] * 8 + [_i] * 6 + [_p], _i),
        "hydra_sweep_exact_mt": ([_p] * 8 + [_i] * 6 + [_p], _i),
        "hydra_sweep_windows_mt": ([_i] + [_p] * 8 + [_i] * 8 + [_p], _i),
        "hydra_window_stats_mt": ([_p] * 6 + [_i] * 4 + [_p], _i),
        "hydra_window_axpy_mt": ([_p] * 4 + [_i] * 4 + [_p], _i),
        "hydra_mt_window_recurrence": ([_p] * 6 + [_i] * 4 + [_p], _i),
        "hydra_mt_workspace_bytes": ([_i] * 5, ctypes.c_longlong),
        "hydra_mt_error_string": ([_i], ctypes.c_char_p),
    },
    "planes_kernel.cu": {
        "hydra_window_stats_planes": ([_p] * 5 + [_i] * 2 + [_p], _i),
        "hydra_window_axpy_planes": ([_p] * 4 + [_i] * 2 + [_p], _i),
        "hydra_planes_workspace_bytes": ([_i] * 2, ctypes.c_longlong),
        "hydra_planes_error_string": ([_i], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _flags(source: str):
    return NVCC_FLAGS + SOURCES[source]


def library_path(source: str) -> str:
    h = hashlib.sha256(" ".join(_flags(source)).encode())
    for name in (source,) + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libhydra_{stem}_{h.hexdigest()[:16]}.so")


def build(ptxas_verbose: bool = False) -> str:
    """Compile every source whose library is missing, one nvcc per source,
    all started together.

    Returns the compilers' stderr (with ``-Xptxas -v``: registers, shared
    memory and spills per kernel); "" when every library was cached.
    Processes that share the build directory (the ranks of one run) take
    turns through a file lock, so one of them builds and the rest find the
    libraries."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_missing(ptxas_verbose)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_missing(ptxas_verbose: bool) -> str:
    jobs = []
    for source in SOURCES:
        path = library_path(source)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags(source),
               *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", tmp, os.path.join(CSRC, source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((source, path, tmp, proc))
    logs, failed = [], []
    for source, path, tmp, proc in jobs:
        _, err = proc.communicate()
        logs.append(f"{source}:\n{err}")
        if proc.returncode != 0:
            failed.append(f"nvcc {source} failed ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "\n".join(logs)


def load(source: str = "sweep_kernel.cu") -> ctypes.CDLL:
    """The loaded kernel library of one source (all are built on the first
    call)."""
    with _lock:
        if source not in _libs:
            build()
            lib = ctypes.CDLL(library_path(source))
            for name, (argtypes, restype) in _SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[source] = lib
        return _libs[source]
