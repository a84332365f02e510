"""End-to-end metrics come from every call of the window."""

import importlib.util

import pytest

from tiny import ROOT
from benchmark.window import Call, Window, quantile, spread


def read(kind, name, window):
    path = ROOT / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Ctx:
        pass

    ctx = Ctx()
    ctx.window = window
    return mod.read(ctx)


def window(times, units):
    calls, at = [], 0.0
    for t, u in zip(times, units):
        calls.append(Call(at, at + t, u))
        at += t
    return Window(0.0, at, calls)


def test_tail_is_of_every_call_not_of_chunk_medians():
    # 100 calls, the first 6 slow: 6% of calls at 100 ms.  Over every call
    # the 95th percentile is 100 ms; the median of the five 20-call chunks'
    # percentiles would be 10 ms.
    times = [0.100] * 6 + [0.010] * 94
    p95 = read("end_to_end", "clip_p95_ms", window(times, [1.0] * 100))
    assert p95 == pytest.approx(quantile([t * 1e3 for t in times], 0.95)) == pytest.approx(100.0)
    chunks = [quantile(times[i : i + 20], 0.95) * 1e3 for i in range(0, 100, 20)]
    assert quantile(chunks, 0.5) == pytest.approx(10.0)
    assert read("end_to_end", "clip_p95_ms", window(times[::-1], [1.0] * 100)) == pytest.approx(p95)


def test_rates_are_all_work_over_all_time():
    times = [0.010] * 50 + [0.090] * 50  # 5 s
    audio = [2.0] * 50 + [18.0] * 50  # 1000 s of audio
    w = window(times, audio)
    assert read("end_to_end", "offline_rtf", w) == pytest.approx(1000.0 / 5.0)
    blocks = window(times, [1.0] * 100)
    assert read("end_to_end", "pool_block_ms", blocks) == pytest.approx(5000.0 / 100)


def test_quantile_and_spread():
    assert quantile([1, 2, 3, 4], 0.5) == 2.5
    assert quantile([5], 0.95) == 5
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx((5.25 - 1.75) / 3.5)
