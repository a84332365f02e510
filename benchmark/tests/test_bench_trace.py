"""The trace's reduction on rows made by hand: busy time as a union,
idle gaps, the host's span at each gap, the cards' overlap, the breakdown."""

import pytest

import tiny  # noqa: F401  (puts the repo root on sys.path)
from benchmark.trace import Row, Trace, breakdown, host_copy_seconds, idle_percent, overlap_share, peer_copy_seconds


def trace():
    rows = [
        Row(0, "k1", 10, 30, "kernel"),
        Row(0, "k2", 20, 40, "kernel"),  # overlaps k1: busy 10-40
        Row(0, "Memcpy HtoD (Pinned -> Device)", 60, 70, "memcpy"),
        Row(1, "k1", 25, 35, "kernel"),
        Row(1, "Memcpy PtoP (Device -> Device)", 80, 90, "memcpy"),
    ]
    spans = [("bench.window", 0, 100), ("bench.block", 5, 95), ("bench.push", 5, 45), ("bench.fetch", 55, 95)]
    return Trace(sorted(rows, key=lambda r: r.start), spans, (0, 100), [0, 1])


def test_busy_idle_and_labels():
    t = trace()
    assert t.busy_s(0) == pytest.approx(40e-6) and t.busy_s(1) == pytest.approx(20e-6)
    assert t.busy_mean_s() == pytest.approx(30e-6)
    assert idle_percent(t) == pytest.approx(70.0)
    assert t.idle_gaps(0) == [(0, 10), (40, 60), (70, 100)]
    assert t.host_labels([2, 20, 50, 60, 97]) == ["bench.loop", "bench.push", "bench.block", "bench.fetch",
                                                 "bench.loop"]
    assert [r.name for r in t.rows_within(5, 45)] == ["k1", "k2", "k1"]


def test_copies_overlap_and_breakdown():
    t = trace()
    assert host_copy_seconds(t) == pytest.approx(10e-6) and peer_copy_seconds(t) == pytest.approx(10e-6)
    kernels = [r for r in t.rows if r.kind == "kernel"]
    assert overlap_share(kernels) == pytest.approx(10 / 30)  # cards 0 and 1 both busy 25-35 of 10-40
    b = breakdown(t)
    assert b["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    # card 0 idle 0-10 (push), 40-60 (block), 70-100 (fetch); card 1 0-25 (push), 35-80 (fetch),
    # 90-100 (loop: every span closed at 95); halved, the mean over two cards
    idle = {k: v * 1e6 for k, v in b["idle_gaps"]}
    assert idle == pytest.approx({"bench.fetch": 37.5, "bench.push": 17.5, "bench.block": 10.0, "bench.loop": 5.0})


def test_no_rows_reads_nothing():
    t = Trace([], [("bench.window", 0, 10)], (0, 10), [0])
    assert host_copy_seconds(t) is None and idle_percent(t) is None and overlap_share([]) is None
