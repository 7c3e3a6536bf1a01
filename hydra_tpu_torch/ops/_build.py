"""Build and load the CUDA sweep kernels (``csrc/*.cu``) with nvcc + ctypes.

The sources compile at first use into ``hydra_tpu_torch/_build/`` (listed in
``.gitignore``) as a shared library with a plain C interface, named by the
hash of the sources, so an edit rebuilds and an unchanged tree reuses the
library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("sweep_kernel.cu",)
HEADERS = ("sweep_kernel.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA sweep kernels are built from csrc/ at first use")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libhydra_sweep_{h.hexdigest()[:16]}.so")


def build(ptxas_verbose: bool = False) -> str:
    """Compile the kernels unless a library for these sources exists.

    Returns the compiler's stderr (with ``-Xptxas -v``: registers, shared
    memory and spills per kernel) or "" when the cached library was used."""
    path = library_path()
    if os.path.exists(path):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
           "-o", tmp, *(os.path.join(CSRC, s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)
    return res.stderr


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(library_path())
            p, i = ctypes.c_void_p, ctypes.c_int
            for fn in (lib.hydra_sweep_stale, lib.hydra_sweep_exact):
                fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
                fn.restype = i
            lib.hydra_sweep_workspace_bytes.argtypes = [i, i, i]
            lib.hydra_sweep_workspace_bytes.restype = ctypes.c_longlong
            lib.hydra_sweep_error_string.argtypes = [i]
            lib.hydra_sweep_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
