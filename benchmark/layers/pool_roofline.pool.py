"""The blocks' least time for every stream (benchmark/roofline.py) over
the device time of every kernel row on every card, in percent."""


def read(ctx):
    kernel = sum(r.seconds for r in ctx.trace.rows if r.kind == "kernel")
    if kernel <= 0:
        return None
    return 100.0 * sum(ctx.session.least_seconds(c) for c in ctx.window.calls) / kernel
