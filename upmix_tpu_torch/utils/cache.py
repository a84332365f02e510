"""Where the CUDA kernels are built.

The port's counterpart of `upmix_tpu/utils/cache.py`: the JAX package
caches compiled XLA programs on disk, the port its nvcc-built kernel
library (`ops/_build.py`, one library per `library_key()`), so a warm
start builds nothing."""

from __future__ import annotations

import os
from pathlib import Path

ENV = "UPMIX_TORCH_BUILD_DIR"
_PACKAGE_BUILD = Path(__file__).resolve().parent.parent / "_build"


def kernel_build_dir(cache_dir: str | None = None) -> str:
    """The directory the kernel library is built into and loaded from.

    Precedence: the argument > $UPMIX_TORCH_BUILD_DIR > the package's own
    `_build/` when it can be written (a checkout) >
    ~/.cache/upmix_tpu_torch/build (a read-only install).  Returns the
    directory, created, or "" when none can be created."""
    if cache_dir is not None or os.environ.get(ENV):
        candidates = [cache_dir if cache_dir is not None else os.environ[ENV]]
    else:
        candidates = [str(_PACKAGE_BUILD), os.path.join(os.path.expanduser("~"), ".cache", "upmix_tpu_torch", "build")]
    for path in candidates:
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            continue
        if os.access(path, os.W_OK):
            return path
    return ""
