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


def kernel_rows_by_device(fn, iters: int = 1, match=None, warm: bool = True):
    """({device index: kernel launches}, rows) of `iters` calls of fn
    under torch.profiler, after one call outside it (none when not
    `warm`); rows are (device
    index, kernel name, start us, end us) of every kernel on a card, in
    start order (copies and fills left out), or of those whose name
    holds one of the strings `match`.  The index is the card the kernel
    ran on, whatever tensors it was handed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    if warm:
        fn()
        sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    rows = sorted(
        ((e.device_index, e.name, e.time_range.start, e.time_range.end)
         for e in prof.events()
         if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset"))
         and (match is None or any(m in e.name for m in match))),
        key=lambda r: r[2],
    )
    counts = {}
    for dev, *_ in rows:
        counts[dev] = counts.get(dev, 0) + 1
    return dict(sorted(counts.items())), rows


def overlap_share(rows) -> float:
    """Share of the span from the first kernel's start to the last one's
    end (rows of `kernel_rows_by_device`) during which kernels of two or
    more devices run at once."""
    if not rows:
        return 0.0
    marks = sorted([(s, 1, d) for d, _, s, _ in rows] + [(e, -1, d) for d, _, _, e in rows])
    active, both, prev = {}, 0.0, marks[0][0]
    for at, step, dev in marks:
        if sum(1 for n in active.values() if n > 0) >= 2:
            both += at - prev
        active[dev] = active.get(dev, 0) + step
        prev = at
    span = max(e for *_, e in rows) - min(s for _, _, s, _ in rows)
    return both / span if span > 0 else 0.0


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
