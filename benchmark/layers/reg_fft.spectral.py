"""The share of K3s's FFT frames that its register core took: 100 times
the `reg_frames` over the `fft_frames` of the window's `pool.forward` and
`pool.inverse` spans (the program counts both on the host from its
routes).  Under 100 says that a block size fell back to another core;
None where the spans carry no such count."""

from benchmark.spans import named


def read(ctx):
    found = [s for name in ("pool.forward", "pool.inverse") for s in named(ctx, name) or []]
    if not found or any("fft_frames" not in s.attrs or "reg_frames" not in s.attrs for s in found):
        return None
    frames = sum(s.attrs["fft_frames"] for s in found)
    return 100.0 * sum(s.attrs["reg_frames"] for s in found) / frames if frames else None
