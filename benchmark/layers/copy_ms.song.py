"""Device time of the host-to-card and card-to-host copy rows, per file, in milliseconds."""

from benchmark.trace import host_copy_seconds


def read(ctx):
    s = host_copy_seconds(ctx.trace)
    return None if s is None else s * 1e3 / len(ctx.window.calls)
