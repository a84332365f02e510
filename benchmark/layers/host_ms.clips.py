"""Median over the window's calls of the call's wall time (host clock)
less the device time of the rows inside its span: host plan, dispatch
and waiting, in milliseconds."""

from benchmark.trace import union_seconds
from benchmark.window import median


def read(ctx):
    spans = ctx.trace.spans_named("bench.call")
    if not ctx.trace.rows or len(spans) != len(ctx.window.calls):
        return None
    host = [call.seconds - union_seconds([(r.start, r.end) for r in ctx.trace.rows_within(s, e)])
            for (_, s, e), call in zip(spans, ctx.window.calls)]
    return median(host) * 1e3
