"""Profiling helpers: realtime-factor metering, timing and profiler traces.

The port's copy of `upmix_tpu/utils/profiling.py`: `RealtimeMeter` is
the same class; `time_fn` waits for the card (torch.cuda.synchronize on
the device of the tensors it is given or returns) where the JAX version
blocks on its arrays; `trace` writes a torch.profiler trace in place of
a jax.profiler one.  torch loads on first use.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _sync(*trees):
    """Wait for the CUDA devices the tensors among `trees` lie on; none for
    the CPU."""
    import torch

    devices = {x.device for tree in trees for x in _leaves(tree) if torch.is_tensor(x) and x.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, warmup: int = 1, iters: int = 5):
    """Median wall time in seconds of fn(*args), each call ended by a
    synchronise of the CUDA devices of its arguments and its result."""
    for _ in range(warmup):
        _sync(args, fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(args, fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@dataclass
class RealtimeMeter:
    """Accumulates audio-seconds vs wall-seconds -> realtime factor."""

    sr: float
    audio_samples: int = 0
    wall_s: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    @contextlib.contextmanager
    def measure(self, n_samples: int):
        t0 = time.perf_counter()
        yield
        self.wall_s += time.perf_counter() - t0
        self.audio_samples += n_samples

    @property
    def audio_s(self) -> float:
        return self.audio_samples / self.sr

    @property
    def realtime_factor(self) -> float:
        return self.audio_s / self.wall_s if self.wall_s > 0 else float("inf")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where a card is
    present); the trace is written under `log_dir` as a Chrome trace
    (view in chrome://tracing or Perfetto)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
