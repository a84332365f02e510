"""Share of the kernel span during which kernels of two or more cards run, in percent."""

from benchmark.trace import overlap_share


def read(ctx):
    share = overlap_share([r for r in ctx.trace.rows if r.kind == "kernel"])
    return None if share is None else 100.0 * share
