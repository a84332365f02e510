"""Host time in the program's `pool.gather` spans (each card's copy to
the first card and index-put), per hardware block, in milliseconds."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "pool.gather")
