"""The card's idle time inside the program's `offline.process` spans, per
file, in milliseconds."""

from benchmark.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "offline.process")
