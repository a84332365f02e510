"""Build and load the CUDA kernels at first use.

`nvcc` compiles `csrc/omnibus.cu` (a plain C interface, no PyTorch
headers) for sm_90a into `upmix_tpu_torch/_build/`, keyed by a hash of
the source and the flags, and the library is bound with ctypes.  Nothing
here runs at import time: machines without a GPU or nvcc import the
package and use the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "omnibus.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
# Filled by load(): seconds spent in nvcc (0.0 when the library was
# already built) and the compiler's report (registers, spills per kernel).
build_seconds = None
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first call."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"omnibus_{digest.hexdigest()[:16]}.so"
    build_seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.omni_forward.argtypes = [p, p, p, i, i, i, i, i, ll, i, p]
    lib.omni_mask.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.omni_inverse.argtypes = [p, p, p, i, i, i, i, i, ll, i, p]
    for fn in (lib.omni_forward, lib.omni_mask, lib.omni_inverse):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
