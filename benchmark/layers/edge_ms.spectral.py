"""Device time of K3s's edge product, the rows of its two kernels
(`spectral_edge_gather_kernel`, `spectral_edge_kernel`), summed over the
cards, per hardware block, in milliseconds.  None where no such row ran."""

import re

EDGE = re.compile(r"\bspectral_edge(_gather)?_kernel\b")


def read(ctx):
    s = sum(r.seconds for r in ctx.trace.rows if r.kind == "kernel" and EDGE.search(r.name))
    return s * 1e3 / len(ctx.window.calls) if s > 0 else None
