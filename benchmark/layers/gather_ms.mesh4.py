"""Host time in the program's `pool.gather` spans (each part's stems
brought to the first card: one copy into a slice of the whole where the
rows are one range, `path` "slice", else a copy and an index-put,
"index"), per hardware block, in milliseconds."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "pool.gather")
