"""Profiling helpers: realtime-factor metering, timing and profiler traces.

The port's copy of `upmix_tpu/utils/profiling.py`: `RealtimeMeter` is
the same class; `time_fn` waits for the card (torch.cuda.synchronize on
the device of the tensors it is given or returns) where the JAX version
blocks on its arrays; `trace` writes a torch.profiler trace, with the
program's own spans, in place of a jax.profiler one.  torch loads on
first use.
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


SPAN_TRACK = 1 << 30  # the trace's thread id of the program's spans (`utils/tracing.py`)


def _realtime_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the closest of a few
    paired readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def _write_spans(path: str, records) -> None:
    """Add the program's spans to the Chrome trace at `path`: a host track
    of their own on the trace's timeline.  The profiler stamps its events
    on the wall clock (CLOCK_REALTIME, in microseconds after the trace's
    `baseTimeNanoseconds` where it gives one) and the spans on
    perf_counter, so each span moves by the clocks' difference."""
    import json
    import os

    with open(path) as f:
        data = json.load(f)
    shift = _realtime_offset_ns() - int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TRACK,
               "args": {"name": "upmix_tpu_torch spans"}}]
    for s in records:
        events.append({"ph": "X", "cat": "upmix_tpu_torch", "name": s.name, "pid": pid, "tid": SPAN_TRACK,
                       "ts": (s.start_ns + shift) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "call": s.call, "card": s.card, **s.attrs}})
    data["traceEvents"] = data.get("traceEvents", []) + events
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where a card is
    present); the trace is written under `log_dir` as a Chrome trace
    (view in chrome://tracing or Perfetto), with the program's spans
    recorded in the block (`utils/tracing.py`) on a track of their own."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from upmix_tpu_torch.utils import tracing

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    start = time.perf_counter_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _write_spans(path, [s for s in tracing.spans() if s.start_ns >= start])
