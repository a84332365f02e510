"""Host time in the program's `pool.scatter` spans (each card's
index-select and copy from the first card), per hardware block, in
milliseconds."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "pool.scatter")
