"""The program's own spans on the traced run's clock, and the cards' idle
time split by them.

The program records spans while a torch.profiler records
(`upmix_tpu_torch/utils/tracing.py`): name, start and end on
`time.perf_counter_ns()`, its root's id and its attributes.  Each call of
the window gives the two clocks a shared instant: the call's start
(`Call.start`, perf_counter) is read just before the call's outermost
benchmark span opens on the profiler's clock (microseconds), so that
span opens later by what opening it costs; the least of these delays over the
window's calls is the offset.  (The window's own start is no such
instant: its span is the first a process opens, and the first
`record_function` costs hundreds of microseconds.)  Each idle stretch of
a card (`Trace.idle_gaps`) is split by the time it overlaps each span,
the innermost one where spans nest.

A reader returns None where the program records no spans (a tree without
the recorder, or none of the spans it asks for in the window) or the
recorder dropped any.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Mapped:
    name: str
    start: float  # us, the profiler's clock
    end: float
    attrs: dict


def offset_us(window, trace) -> float | None:
    """What to add to perf_counter microseconds to read the profiler's
    clock: the least over the window's calls of how far the call's
    outermost benchmark span opens after the call's start.  None when
    those spans do not pair off with the calls."""
    tops, end = [], None
    for name, s, e in trace.spans:  # start order
        if name != "bench.window" and trace.window[0] <= s and (end is None or s >= end):
            tops.append(s)
            end = e
    if not tops or len(tops) != len(window.calls):
        return None
    return min(s - c.start * 1e6 for s, c in zip(tops, window.calls))


def mapped(records, offset: float, trace) -> list:
    """The records (`tracing.Span`) inside the trace's window, on its
    clock (perf_counter us + `offset`), in start order (the outer of two
    that start together first)."""
    out = [Mapped(r.name, r.start_ns / 1e3 + offset, r.end_ns / 1e3 + offset, r.attrs) for r in records]
    return sorted((m for m in out if m.start >= trace.window[0] and m.end <= trace.window[1]),
                  key=lambda m: (m.start, -m.end))


def program_spans(ctx) -> list | None:
    """The program's spans of the traced window (`mapped`), or None."""
    try:
        from upmix_tpu_torch.utils import tracing
    except ImportError:
        return None
    offset = offset_us(ctx.window, ctx.trace)
    if tracing.dropped() or offset is None:
        return None
    return mapped(tracing.spans(), offset, ctx.trace)


def named(ctx, name: str) -> list | None:
    """The window's program spans called `name`, or None for none."""
    spans = program_spans(ctx)
    found = [s for s in spans or [] if s.name == name]
    return found or None


def host_ms(ctx, name: str) -> float | None:
    """Host ms in the spans called `name`, over the window's calls."""
    found = named(ctx, name)
    if found is None:
        return None
    return sum(s.end - s.start for s in found) * 1e-3 / len(ctx.window.calls)


def innermost(intervals) -> list:
    """(start, end, label) pieces of the time the (label, start, end)
    intervals cover, each labelled by the innermost interval open: the
    one opened last of those still open (of two opened together, the
    shorter)."""
    intervals = sorted(intervals, key=lambda iv: (iv[1], -iv[2]))
    marks = sorted([(s, 1, i) for i, (_, s, e) in enumerate(intervals)]
                   + [(e, 0, i) for i, (_, s, e) in enumerate(intervals)])
    pieces, open_, at = [], [], None
    for t, opens, i in marks:
        if open_ and t > at:
            pieces.append((at, t, intervals[open_[-1]][0]))
        at = t
        if opens:
            open_.append(i)
        else:
            open_.remove(i)
    return pieces


def idle_split(trace, intervals) -> dict:
    """{label: us} of the cards' idle time that the (label, start, end)
    intervals cover (`innermost` labels), mean over the cards."""
    pieces = innermost(intervals)
    out: dict = {}
    for card in trace.cards:
        gaps, j = trace.idle_gaps(card), 0
        for s, e, label in pieces:
            while j < len(gaps) and gaps[j][1] <= s:
                j += 1
            k = j
            while k < len(gaps) and gaps[k][0] < e:
                over = min(e, gaps[k][1]) - max(s, gaps[k][0])
                out[label] = out.get(label, 0.0) + over / len(trace.cards)
                k += 1
    return out


def idle_ms(ctx, name: str) -> float | None:
    """The cards' idle ms inside the spans called `name` (mean over the
    cards), over the window's calls."""
    found = named(ctx, name)
    if found is None or not ctx.trace.rows:
        return None
    us = idle_split(ctx.trace, [(name, s.start, s.end) for s in found]).get(name, 0.0)
    return us * 1e-3 / len(ctx.window.calls)
