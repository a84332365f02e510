"""The share of K3's FFT frames that the register core took: 100 times
the `reg_frames` over the `fft_frames` of the window's `pool.frames`
spans (the program counts both on the host from its plan).  Under 100
says that a bucket took the two-stage split over FFT_MAX points; None
where no such span exists or a span carries no such count.  K3s's steps
(`pool.forward`, `pool.inverse`) are `reg_fft.spectral`'s."""

from benchmark.spans import named


def read(ctx):
    found = named(ctx, "pool.frames")
    if found is None or any("fft_frames" not in s.attrs or "reg_frames" not in s.attrs for s in found):
        return None
    frames = sum(s.attrs["fft_frames"] for s in found)
    return 100.0 * sum(s.attrs["reg_frames"] for s in found) / frames if frames else None
