"""Device time of the copy rows between cards, per hardware block, in milliseconds."""

from benchmark.trace import peer_copy_seconds


def read(ctx):
    s = peer_copy_seconds(ctx.trace)
    return None if s is None else s * 1e3 / len(ctx.window.calls)
