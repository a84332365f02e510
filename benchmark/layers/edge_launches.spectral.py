"""K3s's edge-product launches per hardware block: the `edge_launches`
the program's `pool.push` spans counted (its gather and its product), over
the window's blocks.  0 says the product was bypassed; None where the
spans carry no such count."""

from benchmark.spans import named


def read(ctx):
    found = named(ctx, "pool.push")
    if found is None or any("edge_launches" not in s.attrs for s in found):
        return None
    return sum(s.attrs["edge_launches"] for s in found) / len(ctx.window.calls)
