"""The cards' idle time inside the program's `pool.push` spans, mean
over the cards, per hardware block, in milliseconds."""

from benchmark.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "pool.push")
