"""Host time in the program's `pool.step` spans (each card's history
shift and kernel launches), summed over the cards, per hardware block, in
milliseconds."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "pool.step")
