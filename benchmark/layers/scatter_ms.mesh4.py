"""Host time in the program's `pool.scatter` spans (each part's rows of
the call's input sent from the first card to its own: one copy of a
slice where the rows are one range, `path` "slice", else an index-select
and its copy, "index"), per hardware block, in milliseconds."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "pool.scatter")
