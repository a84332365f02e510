"""Share of the traced window with no kernel or copy row, averaged over the cell's cards, in percent."""

from benchmark.trace import idle_percent


def read(ctx):
    return idle_percent(ctx.trace)
