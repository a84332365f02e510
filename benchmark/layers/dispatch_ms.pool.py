"""Mean host time of `push_blocks` until it returns, with no synchronize:
the program's enqueue of a block, in milliseconds."""


def read(ctx):
    return sum(c.dispatch for c in ctx.window.calls) * 1e3 / len(ctx.window.calls)
