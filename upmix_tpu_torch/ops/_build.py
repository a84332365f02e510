"""Build and load the CUDA kernels at first use.

`nvcc` compiles every `csrc/*.cu` (a plain C interface, no PyTorch
headers) for sm_90a, one process per source, all started together, and
links the objects into one library, keyed by a hash of the flags and of
every source and header under `csrc/`; the library is bound with
ctypes.  It lives in `BUILD_DIR`, which is `utils/cache.py::
kernel_build_dir()` (the package's `_build/` in a checkout) unless set
before the first load; `fresh_build_dir` points it at a temporary
directory for the length of a block (the CLI's --no-compile-cache).  Nothing here
runs at import time: machines without a GPU or nvcc import the package
and use the plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = None  # a Path; kernel_build_dir() on the first load when None
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
# Filled by load(): seconds the last build spent in nvcc (0.0 when the
# library was already built) and the compiler's report (registers, spills
# per kernel).
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


def library_key() -> str:
    """Hash of the flags and of every source and header, by name and content."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


@contextlib.contextmanager
def fresh_build_dir():
    """Inside the block, build into a new temporary directory and reuse no
    library built before: the next `load` compiles afresh.  On leaving it,
    the directory is removed and the earlier `BUILD_DIR` and library come
    back."""
    global BUILD_DIR, _lib
    saved = BUILD_DIR, _lib
    fresh = Path(tempfile.mkdtemp(prefix="upmix_torch_build_"))
    BUILD_DIR, _lib = fresh, None
    try:
        yield fresh
    finally:
        BUILD_DIR, _lib = saved
        shutil.rmtree(fresh, ignore_errors=True)


@contextlib.contextmanager
def on_device(device):
    """Make `device` (a torch.device or a name; a CUDA device) the current
    device for the block, and the caller's current device again after it.

    Every call into the library runs inside this guard on the device of
    the tensors it is handed.  A launch goes to the stream handle of
    `torch.cuda.current_stream(device)`; PyTorch's default stream is
    handle 0, the legacy stream of whichever device is *current*, and
    `cudaFuncSetAttribute` acts on the current device too, so without
    the guard a launch for tensors on cuda:1 would run on cuda:0.  A CPU
    device (a plan built for the plain versions) makes no change."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"the kernels run on cuda devices, not {dev}")
        yield dev
        return
    with torch.cuda.device(dev):
        yield dev


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first call."""
    global _lib, build_seconds, build_log, BUILD_DIR
    if _lib is not None:
        return _lib
    if BUILD_DIR is None:
        from upmix_tpu_torch.utils.cache import ENV, kernel_build_dir

        found = kernel_build_dir()
        if not found:
            raise RuntimeError(f"no writable directory to build the CUDA kernels in; set {ENV}")
        BUILD_DIR = Path(found)
    so = BUILD_DIR / f"kernels_{library_key()}.so"
    build_seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [src.name for src, p in zip(SOURCES, procs) if p.returncode != 0]
        if not failed:
            res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                 capture_output=True, text=True)
            build_log += res.stdout + res.stderr
            if res.returncode != 0:
                failed = ["link"]
        build_seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.omni_bucket.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, ll, i, p]
    lib.omni_wide_forward.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, ll, p]
    lib.omni_wide_inverse.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, ll, i, p]
    lib.pool_bucket.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, ll, i, p]
    lib.pool_wide_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, ll, p]
    lib.pool_wide_inverse.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i, i, p]
    lib.pool_spectral_forward.argtypes = [p] * 8 + [i] * 9 + [ll, p]
    lib.pool_spectral_reg_fft.argtypes = [p, p, p, p, i, i, i, p]
    lib.pool_spectral_roots.argtypes = [p]
    lib.pool_spectral_mask.argtypes = [p] * 6 + [i] * 10 + [p]
    lib.pool_spectral_edge_gather.argtypes = [p, p, p, p, p, i, p, p, i, i, i, i, i, p]
    lib.pool_spectral_edge.argtypes = [p, p, p, p, p, i, p, p, i, i, i, i, i, p]
    lib.pool_spectral_inverse.argtypes = [p] * 6 + [i] * 11 + [p]
    lib.pool_spectral_wide_inverse.argtypes = [p] * 11 + [i] * 15 + [p]
    lib.pool_floor.argtypes = [p, p, i, i, i, i, p, p]
    lib.dot_chain.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.dot_chain_clusters.argtypes = [i, i, i]
    lib.dot_chain_resident.argtypes = [i, i]
    lib.overhead_probe.argtypes = [p, ll, p, p, i, i, i, i, p, p, i, p]
    lib.empty_launch.argtypes = [i, i, p]
    for fn in (lib.omni_bucket, lib.omni_wide_forward, lib.omni_wide_inverse, lib.pool_bucket,
               lib.pool_wide_forward, lib.pool_wide_inverse, lib.pool_spectral_forward, lib.pool_spectral_mask,
               lib.pool_spectral_edge_gather, lib.pool_spectral_edge, lib.pool_spectral_inverse,
               lib.pool_spectral_wide_inverse, lib.pool_spectral_reg_fft, lib.pool_spectral_roots, lib.pool_floor,
               lib.dot_chain, lib.dot_chain_clusters, lib.dot_chain_resident, lib.overhead_probe, lib.empty_launch):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
