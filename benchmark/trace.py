"""The traced run: torch.profiler over the measured window, reduced to
device rows by card and the benchmark's own host spans.

Spans are `record_function` ranges that the benchmark's drivers open
around their calls into the program, each named "bench.<what>"; the
profiler puts them on the same clock as the device rows.  Nothing here
reads the program's own counters or spans.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
from dataclasses import dataclass

SPAN = "bench."
WINDOW = "bench.window"


def no_span(name: str):
    return contextlib.nullcontext()


def record_span(name: str):
    import torch

    return torch.profiler.record_function(name)


@dataclass
class Row:
    card: int
    name: str
    start: float  # us, profiler clock
    end: float
    kind: str  # "kernel", "memcpy" or "memset"

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6


@dataclass
class Trace:
    rows: list  # Row, every device row inside the window
    spans: list  # (name, start us, end us) of the benchmark's spans, start order
    window: tuple  # (start us, end us) of the window span
    cards: list  # indices of the cards the cell uses

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name]

    @functools.cached_property
    def _starts(self) -> list:
        return [r.start for r in self.rows]

    def rows_within(self, start: float, end: float) -> list:
        """Rows that start in [start, end) and end by `end` (rows are in start order)."""
        lo, hi = bisect.bisect_left(self._starts, start), bisect.bisect_left(self._starts, end)
        return [r for r in self.rows[lo:hi] if r.end <= end]

    def busy_s(self, card: int) -> float:
        return union_seconds([(r.start, r.end) for r in self.rows if r.card == card])

    def busy_mean_s(self) -> float:
        return sum(self.busy_s(c) for c in self.cards) / len(self.cards)

    def idle_gaps(self, card: int) -> list:
        """(start us, end us) of every stretch of the window with no row on the card."""
        merged = merge([(r.start, r.end) for r in self.rows if r.card == card])
        gaps, at = [], self.window[0]
        for s, e in merged:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.window[1] > at:
            gaps.append((at, self.window[1]))
        return gaps

    def host_labels(self, points) -> list:
        """The innermost benchmark span open on the host at each time in
        `points` (sorted), or "bench.loop" between spans.  The spans nest,
        as ranges of one thread do: one sweep with a stack."""
        marks = sorted([(s, 1, name) for name, s, e in self.spans if name != WINDOW]
                       + [(e, 0, name) for name, s, e in self.spans if name != WINDOW])
        labels, stack, i = [], [], 0
        for at in points:
            while i < len(marks) and marks[i][0] <= at:
                _, opens, name = marks[i]
                if opens:
                    stack.append(name)
                elif name in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(name)]
                i += 1
            labels.append(stack[-1] if stack else "bench.loop")
        return labels


def merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_seconds(intervals) -> float:
    return sum(e - s for s, e in merge(intervals)) * 1e-6


def overlap_share(rows) -> float | None:
    """Share of the span from the first kernel row's start to the last
    one's end during which rows of two or more cards run at once."""
    if not rows:
        return None
    marks = sorted([(r.start, 1, r.card) for r in rows] + [(r.end, -1, r.card) for r in rows])
    active, both, prev = {}, 0.0, marks[0][0]
    for at, step, card in marks:
        if sum(1 for n in active.values() if n > 0) >= 2:
            both += at - prev
        active[card] = active.get(card, 0) + step
        prev = at
    span = max(r.end for r in rows) - min(r.start for r in rows)
    return both / span if span > 0 else None


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def reduce(prof, cards: list) -> Trace:
    """Trace of a finished torch.profiler.profile whose window was opened
    by a `bench.window` span."""
    from torch.autograd import DeviceType

    rows, spans = [], []
    for e in prof.events():
        if e.name.startswith(SPAN):
            if e.device_type == DeviceType.CPU:
                spans.append((e.name, e.time_range.start, e.time_range.end))
            continue  # the span's own row on the device timeline
        if e.device_type == DeviceType.CUDA:
            rows.append(Row(e.device_index, e.name, e.time_range.start, e.time_range.end, _kind(e.name)))
    spans.sort(key=lambda s: s[1])
    windows = [s for s in spans if s[0] == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, not one")
    window = windows[0][1:]
    rows = sorted((r for r in rows if r.start >= window[0] and r.end <= window[1]), key=lambda r: r.start)
    return Trace(rows, spans, window, list(cards))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (seconds summed over the
    cards), and the device's idle time by what the host was doing (the
    innermost benchmark span at each gap's middle; seconds averaged over
    the cards)."""
    ops: dict = {}
    for r in trace.rows:
        ops[r.name] = ops.get(r.name, 0.0) + r.seconds
    idle: dict = {}
    for card in trace.cards:
        gaps = trace.idle_gaps(card)
        for (s, e), label in zip(gaps, trace.host_labels([(s + e) / 2 for s, e in gaps])):
            idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6 / len(trace.cards)

    def ranked(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


def host_copy_seconds(trace: Trace) -> float | None:
    """Device seconds of the copies between the host and the cards."""
    if not trace.rows:
        return None
    return sum(r.seconds for r in trace.rows if r.kind == "memcpy" and ("HtoD" in r.name or "DtoH" in r.name))


def peer_copy_seconds(trace: Trace) -> float | None:
    """Device seconds of the copies from one card to another."""
    if not trace.rows:
        return None
    return sum(r.seconds for r in trace.rows if r.kind == "memcpy" and "PtoP" in r.name)


def idle_percent(trace: Trace) -> float | None:
    """Share of the window with no row on a card, averaged over the cards."""
    if not trace.rows:
        return None
    return 100.0 * (1.0 - trace.busy_mean_s() / trace.window_s)
