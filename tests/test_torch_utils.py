"""The port's utils (`upmix_tpu_torch.utils`): the counterparts of
tests/test_profiling.py, and the kernels' build directory
(`utils/cache.py::kernel_build_dir`, `ops/_build.py`)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from upmix_tpu.utils.profiling import RealtimeMeter as JaxRealtimeMeter
from upmix_tpu_torch import utils
from upmix_tpu_torch.ops import _build
from upmix_tpu_torch.utils import cache
from upmix_tpu_torch.utils.profiling import RealtimeMeter, time_fn, trace


def test_realtime_meter():
    m = RealtimeMeter(sr=1000.0)
    with m.measure(500):
        time.sleep(0.01)
    assert m.audio_s == 0.5
    assert 0 < m.realtime_factor < 100
    assert RealtimeMeter(sr=1.0).realtime_factor == float("inf")
    # The JAX package's meter, field for field.
    j = JaxRealtimeMeter(sr=1000.0, audio_samples=500, wall_s=m.wall_s)
    assert (j.audio_s, j.realtime_factor) == (m.audio_s, m.realtime_factor)


def test_time_fn():
    dt = time_fn(lambda x: x * 2, torch.ones(16), warmup=1, iters=3)
    assert dt > 0
    # Nested results (tuples and dicts of tensors) are walked; a non-tensor is fine.
    assert time_fn(lambda: ({"a": torch.zeros(2)}, [torch.ones(1), 3]), iters=2) > 0


def test_trace_writes_profile(tmp_path):
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.streaming import CudaStreamPool

    pool = CudaStreamPool(UpmixConfig.streaming([0.0, 400.0], sr=8000.0, hw_block_size=256), 256, 2, device="cpu")
    x = np.zeros((2, 256), np.float32)
    with trace(str(tmp_path)):
        (torch.ones(128) * 2).sum()
        pool.push_blocks(x, x)
    found = [f for _root, _dirs, files in os.walk(tmp_path) for f in files]
    assert found, "trace produced no files"
    with open(os.path.join(tmp_path, found[0])) as f:
        events = json.load(f)["traceEvents"]
    # the program's spans of the push (utils/tracing.py), on a track of their own
    spans = [e for e in events if e.get("cat") == "upmix_tpu_torch"]
    assert sorted(e["name"] for e in spans) == ["pool.kernels", "pool.push", "pool.shift", "pool.stage", "pool.step"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in spans)


def test_package_exports():
    import upmix_tpu.utils as jax_utils

    assert utils.__all__ == jax_utils.__all__ == ["get_logger", "RealtimeMeter", "time_fn"]
    assert utils.get_logger("upmix_tpu_torch.test").name == "upmix_tpu_torch.test"
    assert utils.RealtimeMeter is RealtimeMeter and utils.time_fn is time_fn


def test_kernel_build_dir_precedence(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv(cache.ENV, raising=False)
    # 1. the argument, over the environment
    monkeypatch.setenv(cache.ENV, str(tmp_path / "env"))
    assert cache.kernel_build_dir(str(tmp_path / "arg")) == str(tmp_path / "arg")
    assert (tmp_path / "arg").is_dir()
    # 2. the environment
    assert cache.kernel_build_dir() == str(tmp_path / "env")
    monkeypatch.delenv(cache.ENV)
    # 3. the package's _build/ when it can be written
    monkeypatch.setattr(cache, "_PACKAGE_BUILD", tmp_path / "pkg" / "_build")
    assert cache.kernel_build_dir() == str(tmp_path / "pkg" / "_build")
    # 4. ~/.cache/upmix_tpu_torch/build when it cannot (a read-only install)
    blocked = tmp_path / "ro"
    blocked.write_text("a file, so no directory can be made under it")
    monkeypatch.setattr(cache, "_PACKAGE_BUILD", blocked / "_build")
    assert cache.kernel_build_dir() == str(tmp_path / "home" / ".cache" / "upmix_tpu_torch" / "build")


def test_kernel_build_dir_that_cannot_be_created(tmp_path, monkeypatch):
    blocked = tmp_path / "file"
    blocked.write_text("")
    assert cache.kernel_build_dir(str(blocked / "sub")) == ""
    monkeypatch.setenv(cache.ENV, str(blocked / "sub"))
    assert cache.kernel_build_dir() == ""
    monkeypatch.delenv(cache.ENV)
    monkeypatch.setenv("HOME", str(blocked))
    monkeypatch.setattr(cache, "_PACKAGE_BUILD", blocked / "_build")
    assert cache.kernel_build_dir() == ""


def test_build_dir_follows_the_cache_and_a_fresh_one(tmp_path, monkeypatch):
    # load() takes BUILD_DIR from kernel_build_dir() on its first call and
    # names the library by library_key(); with no directory it says so.
    monkeypatch.setattr(_build, "BUILD_DIR", None)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv(cache.ENV, str(tmp_path / "env"))
    built = []
    monkeypatch.setattr(_build, "_nvcc", lambda: built.append(_build.BUILD_DIR) or "/bin/false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load()
    assert built == [tmp_path / "env"]
    # A fresh directory holds for its block only: the earlier directory and
    # library come back, and the temporary one is removed.
    cached = object()
    monkeypatch.setattr(_build, "_lib", cached)
    with _build.fresh_build_dir() as fresh:
        assert fresh.is_dir() and fresh != tmp_path / "env" and _build.BUILD_DIR == fresh and _build._lib is None
    assert _build.BUILD_DIR == tmp_path / "env" and _build._lib is cached and not fresh.exists()
    monkeypatch.setattr(_build, "BUILD_DIR", None)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv(cache.ENV, str(tmp_path / "file" / "sub"))
    (tmp_path / "file").write_text("")
    with pytest.raises(RuntimeError, match=cache.ENV):
        _build.load()
    assert len(_build.library_key()) == 16 and np.all([c in "0123456789abcdef" for c in _build.library_key()])
