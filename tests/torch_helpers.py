"""Helpers of the port's tests: the native engine, built on demand."""

import fcntl
import os
import subprocess

import pytest

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "native")


def native_engine():
    """The port's `native` package once native/libupmix_host.so loads,
    building it with `make -C native` under a file lock when it does not
    (test files in other workers may build it too); skips when it cannot
    be built, as tests/test_native.py does."""
    from upmix_tpu_torch import native

    if native.is_available():
        return native
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        mk = subprocess.run(["make", "-C", NATIVE_DIR], capture_output=True)
    if not native.is_available():
        pytest.skip(f"native lib unavailable: {mk.stderr.decode()[-200:]}")
    return native
