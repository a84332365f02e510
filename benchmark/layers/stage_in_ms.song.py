"""Host time in the program's `offline.stage_in` spans (the two channels'
copies to the card and the pad), per file, in milliseconds."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "offline.stage_in")
