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

Every call into the library goes through `with kernels(device) as k`:
it makes the device current once for the block, and `k.launch` appends
the device's current stream, checks the CUDA error and counts the
launch under its kernel in `utils/tracing.py::LAUNCHES`.  No other
module touches the library.
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

from upmix_tpu_torch.utils.tracing import LAUNCHES

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = None  # a Path; kernel_build_dir() on the first load when None
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The library's entries and their argument types, the type check at the
# foreign boundary; every entry returns an int (a cudaError; the two
# occupancy queries, their answer).  A launch entry takes its stream last.
ENTRIES = {
    "omni_bucket": [_p] * 6 + [_i] * 10 + [_ll, _i, _p],
    "omni_wide_forward": [_p] * 5 + [_i] * 8 + [_ll, _p],
    "omni_wide_inverse": [_p] * 10 + [_i] * 12 + [_ll, _i, _p],
    "pool_reg_bucket": [_p] * 9 + [_i] * 12 + [_ll, _i, _p],
    "pool_reg_roots": [_p],
    "pool_wide_forward": [_p] * 6 + [_i] * 10 + [_ll, _p],
    "pool_wide_inverse": [_p] * 13 + [_i] * 14 + [_p],
    "pool_spectral_forward": [_p] * 8 + [_i] * 9 + [_ll, _p],
    "pool_spectral_reg_fft": [_p] * 4 + [_i] * 3 + [_p],
    "pool_spectral_roots": [_p],
    "pool_spectral_mask": [_p] * 6 + [_i] * 10 + [_p],
    "pool_spectral_edge_gather": [_p] * 5 + [_i, _p, _p] + [_i] * 5 + [_p],
    "pool_spectral_edge": [_p] * 5 + [_i, _p, _p] + [_i] * 5 + [_p],
    "pool_spectral_inverse": [_p] * 6 + [_i] * 11 + [_p],
    "pool_spectral_wide_inverse": [_p] * 11 + [_i] * 15 + [_p],
    "pool_floor": [_p, _p] + [_i] * 4 + [_p, _p],
    "dot_chain": [_p] * 5 + [_i] * 4 + [_p],
    "dot_chain_clusters": [_i] * 3,
    "dot_chain_resident": [_i] * 2,
    "overhead_probe": [_p, _ll, _p, _p] + [_i] * 4 + [_p, _p, _i, _p],
    "empty_launch": [_i, _i, _p],
}

_lib = None
_once = set()  # (library path, CUDA device index, entry) of `kernels.once`
# Filled by load(): seconds the last build spent in nvcc (0.0 when the
# library was already built) and the compiler's report (registers, spills
# per kernel), whole and by source file name.
build_seconds = None
build_log = ""
build_logs = {}


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


class on_device:
    """Make `device` (a torch.device or a name; a CUDA device) the current
    device for the block, and the caller's current device again after it;
    `with on_device(device) as dev` gives the torch.device.

    Every call into the library runs inside this guard (`kernels`) on the
    device of the tensors it is handed.  A launch goes to the stream
    handle of `torch.cuda.current_stream(device)`; PyTorch's default
    stream is handle 0, the legacy stream of whichever device is
    *current*, and `cudaFuncSetAttribute` acts on the current device too,
    so without the guard a launch for tensors on cuda:1 would run on
    cuda:0.  A CPU device (a plan built for the plain versions) makes no
    change."""

    __slots__ = ("device", "_guard")

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"the kernels run on cuda devices, not {self.device}")
        self._guard = torch.cuda.device(self.device) if self.device.type == "cuda" else None

    def __enter__(self):
        if self._guard is not None:
            self._guard.__enter__()
        return self.device

    def __exit__(self, *exc):
        if self._guard is not None:
            self._guard.__exit__(*exc)
        return False


class kernels(on_device):
    """The block's calls into the library on the CUDA `device`: under
    `on_device` for the whole block, on the device's current stream.
    `lib` is another build's (`library`), by default this tree's
    (`load()`).  `with kernels(device) as k` gives the object whose
    methods make the calls."""

    __slots__ = ("lib", "stream")

    def __init__(self, device, lib=None):
        super().__init__(device)
        self.lib, self.stream = lib, None

    def __enter__(self):
        import torch

        # what can raise comes before the guard, which has no __exit__ then;
        # the stream is the device's, whichever device is current
        if self.lib is None:
            self.lib = load()
        self.stream = torch.cuda.current_stream(self.device).cuda_stream
        super().__enter__()
        return self

    def launch(self, kernel: str, entry: str, *args) -> None:
        """Launch `entry` with `args` on the card's current stream and count
        it under `kernel` ("K1" .. "K6"; a part of one as "K3s.edge");
        raise on a CUDA error."""
        rc = getattr(self.lib, entry)(*args, self.stream)
        try:
            LAUNCHES[kernel] += 1
        except KeyError:  # the kernel's first launch in this process
            LAUNCHES[kernel] = 1
        if rc:
            raise RuntimeError(f"{entry} launch failed: cudaError {rc}")

    def run(self, entry: str, *args) -> None:
        """Call `entry`, not a launch of a kernel (`args` as it takes them);
        raise on a CUDA error."""
        rc = getattr(self.lib, entry)(*args)
        if rc:
            raise RuntimeError(f"{entry} failed: cudaError {rc}")

    def once(self, entry: str, *args) -> None:
        """`run` once for each library and card: a copy into the card's
        constant memory."""
        import torch

        key = (self.lib._name, torch.cuda.current_device() if self.device.index is None else self.device.index, entry)
        if key not in _once:
            self.run(entry, *args)
            _once.add(key)

    def query(self, entry: str, *args) -> int:
        """The answer of an occupancy query."""
        return getattr(self.lib, entry)(*args)


def _bind(lib: ctypes.CDLL, entries) -> ctypes.CDLL:
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = ENTRIES[name], ctypes.c_int
    return lib


def library(path: str, *entries: str) -> ctypes.CDLL:
    """Another build of the library (an earlier tree's
    `upmix_tpu_torch/_build/kernels_*.so`), `entries` bound as `load`
    binds them, for `kernels(device, lib)`."""
    return _bind(ctypes.CDLL(path), entries)


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first call."""
    global _lib, build_seconds, build_log, build_logs, BUILD_DIR
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
        build_log, build_logs = "".join(logs), {src.name: log for src, log in zip(SOURCES, logs)}
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
    _lib = _bind(ctypes.CDLL(str(so)), ENTRIES)
    return _lib
