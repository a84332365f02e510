"""Kernel launches per hardware block: the `launches` the program's
`pool.push` spans counted (the ops modules' launch counters), over the
window's blocks."""

from benchmark.spans import named


def read(ctx):
    found = named(ctx, "pool.push")
    if found is None:
        return None
    return sum(s.attrs["launches"] for s in found) / len(ctx.window.calls)
