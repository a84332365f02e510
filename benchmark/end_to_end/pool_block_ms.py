"""The window's milliseconds over the hardware blocks it finished for every stream."""


def read(ctx):
    return ctx.window.seconds * 1e3 / ctx.window.units
