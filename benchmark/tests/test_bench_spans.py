"""The program's spans on the trace's clock (`benchmark/spans.py`), on
spans and rows made by hand: the clock mapping, a gap split across two
spans, a gap no span covers, the mean over the cards, and no number
after a dropped span or from a program without the recorder."""

import sys
from types import SimpleNamespace

import pytest

import tiny  # noqa: F401  (puts the repo root on sys.path)
from benchmark import run, spans
from benchmark.trace import Row, Trace
from benchmark.window import Call, Window
from upmix_tpu_torch.utils import tracing

HOST_START = 5.0  # s, perf_counter, when the profiler's clock reads 1000 us
# The calls' starts (perf_counter s) and their outermost spans: the first
# opens as the call starts, the second 2 us after.
CALLS = [(5.000010, 5.000390), (5.000390, 5.000990)]
BLOCKS = [("bench.block", 1010, 1390), ("bench.block", 1392, 1990)]


def span(name, start_us, end_us, ident, parent=None, card=None, **attrs):
    """A record as the program keeps it: perf_counter ns, mapped to
    `start_us`..`end_us` on the trace's clock."""
    def ns(us):
        return int(round((us - 1000 + HOST_START * 1e6) * 1e3))

    return tracing.Span(name, ns(start_us), ns(end_us), ident, parent, ident if parent is None else parent, card,
                        attrs)


RECORDS = [
    span("pool.stage", 1050, 1150, 2, parent=1),
    span("pool.step", 1150, 1250, 3, parent=1, card=0),
    span("pool.push", 1050, 1250, 1, launches=4),
    span("pool.scatter", 1400, 1500, 5, parent=4, card=1),
    span("pool.gather", 1600, 1700, 6, parent=4, card=1),
    span("pool.push", 1400, 1700, 4, launches=4),
    span("pool.push", 2100, 2200, 7, launches=4),  # after the window
]


def trace():
    rows = [Row(0, "k", 1000, 1100, "kernel"), Row(0, "k", 1300, 1400, "kernel"), Row(0, "k", 1900, 2000, "kernel"),
            Row(1, "k", 1000, 1500, "kernel")]
    spans_ = [("bench.window", 1000, 2000), BLOCKS[0], ("bench.push", 1050, 1300), BLOCKS[1]]
    return Trace(sorted(rows, key=lambda r: r.start), spans_, (1000, 2000), [0, 1])


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(RECORDS))
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    # the window's own start is read long before its span opens: no anchor
    window = Window(HOST_START - 0.1, HOST_START + 1e-3, [Call(s, e, 1.0) for s, e in CALLS])
    return SimpleNamespace(window=window, trace=trace(), session=None)


def test_clock_mapping_keeps_the_window(ctx):
    assert spans.offset_us(ctx.window, ctx.trace) == pytest.approx(1000 - HOST_START * 1e6)
    got = spans.program_spans(ctx)
    assert [(s.name, pytest.approx(s.start), pytest.approx(s.end)) for s in got] == [
        ("pool.push", 1050, 1250), ("pool.stage", 1050, 1150), ("pool.step", 1150, 1250),
        ("pool.push", 1400, 1700), ("pool.scatter", 1400, 1500), ("pool.gather", 1600, 1700)]
    assert got[0].attrs == {"launches": 4} and got[2].attrs == {}


def test_no_mapping_when_the_calls_do_not_pair_off(ctx):
    ctx.window.calls = ctx.window.calls[:1]
    assert spans.offset_us(ctx.window, ctx.trace) is None and spans.program_spans(ctx) is None


def test_idle_split_by_the_innermost_span(ctx):
    # card 0 idle 1100-1300: stage 50, step 100, none 50; 1400-1900:
    # scatter 100, push 100, gather 100, none 200.  Card 1 idle
    # 1500-2000: push 100, gather 100, none 300.  Halved: the mean.
    mapped = spans.program_spans(ctx)
    split = spans.idle_split(ctx.trace, [(s.name, s.start, s.end) for s in mapped])
    assert split == pytest.approx({"pool.stage": 25, "pool.step": 50, "pool.scatter": 50, "pool.push": 100,
                                   "pool.gather": 100})
    assert spans.idle_split(ctx.trace, []) == {}


def test_innermost_pieces():
    pieces = spans.innermost([("a", 0, 10), ("b", 2, 4), ("c", 4, 6), ("d", 12, 14)])
    assert pieces == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a"), (12, 14, "d")]


def test_readers(ctx):
    def read(name):
        return run.reader("layers", name)(ctx)

    # pool.push: card 0 150 + 300, card 1 200; mean 325 us over 2 blocks
    assert read("program_idle_ms.pool") == pytest.approx(0.1625)
    assert read("launch_ms.pool") == pytest.approx(0.05)
    assert read("scatter_ms.mesh4") == pytest.approx(0.05) and read("gather_ms.mesh4") == pytest.approx(0.05)
    assert read("launches.pool") == pytest.approx(4.0)
    assert read("program_idle_ms.song") is None and read("stage_in_ms.song") is None  # no such spans


def test_offline_readers(ctx, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: [span("offline.stage_in", 1020, 1040, 2, parent=1),
                                                   span("offline.process", 1010, 1450, 1, launches=6)])
    # card 0 idle 1100-1300 and 1400-1450, card 1 none inside 1010-1450; mean 125 us over 2 files
    assert run.reader("layers", "program_idle_ms.song")(ctx) == pytest.approx(0.0625)
    assert run.reader("layers", "stage_in_ms.song")(ctx) == pytest.approx(0.01)


def test_no_number_after_a_drop(ctx, monkeypatch):
    monkeypatch.setattr(tracing, "dropped", lambda: 1)
    assert spans.program_spans(ctx) is None
    for name in ("launch_ms.pool", "launches.pool", "program_idle_ms.pool", "scatter_ms.mesh4"):
        assert run.reader("layers", name)(ctx) is None


def test_no_number_without_the_recorder(ctx, monkeypatch):
    # A tree whose program records no spans: the import fails, no reader raises.
    import upmix_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "upmix_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(upmix_tpu_torch.utils, "tracing")
    assert spans.program_spans(ctx) is None
    for name in ("launch_ms.pool", "launches.pool", "program_idle_ms.pool", "stage_in_ms.song"):
        assert run.reader("layers", name)(ctx) is None


def test_no_device_rows_no_idle(ctx):
    ctx.trace = Trace([], [("bench.window", 1000, 2000)], (1000, 2000), [0])
    assert run.reader("layers", "program_idle_ms.pool")(ctx) is None
