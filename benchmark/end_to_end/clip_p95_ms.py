"""95th percentile of the wall time of every clip of the window, host
numpy in to three host stems out, in milliseconds."""

from benchmark.window import quantile


def read(ctx):
    return quantile([c.seconds for c in ctx.window.calls], 0.95) * 1e3
