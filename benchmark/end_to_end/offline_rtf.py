"""Audio seconds of every file finished in the window over the window's seconds."""


def read(ctx):
    return ctx.window.units / ctx.window.seconds
