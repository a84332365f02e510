"""Band-limit gain curves: a numpy copy of `upmix_tpu/ops/gains.py`.

The curve depends only on static band parameters, so it is built on the
host once per bucket; on the device, band limiting is one multiply.
"""

from __future__ import annotations

import numpy as np

from upmix_tpu.config import BandSpec, freq_to_bin


def band_gain_curve(band: BandSpec, dtype=np.float32) -> np.ndarray:
    """Per-bin gain vector: unit passband [bin_low, bin_high] with
    half-cosine fades below and above ("raised_cosine"), or zero outside
    the passband ("hard_zero" and any other mode)."""
    fft_size = band.block_size
    r = band.bin_rounding
    bin_low = freq_to_bin(band.f_low, band.sr, fft_size, rounding=r)
    bin_high = freq_to_bin(band.f_high, band.sr, fft_size, rounding=r)
    if bin_low > bin_high:
        bin_low, bin_high = bin_high, bin_low
    g = np.ones(band.n_bins, dtype=np.float64)
    if band.xover_mode == "raised_cosine":
        _apply_raised_cosine(g, band, bin_low, bin_high, fft_size)
    else:
        g[:bin_low] = 0.0
        g[bin_high + 1 :] = 0.0
    return g.astype(dtype)


def _apply_raised_cosine(g, band: BandSpec, bin_low: int, bin_high: int, fft_size: int):
    n_bins = len(g)
    bin_low = max(bin_low, 0)
    bin_high = min(bin_high, n_bins - 1)
    if bin_low > bin_high:
        g[:] = 0.0  # band entirely above Nyquist
        return
    r = band.bin_rounding
    fade_bins_low = freq_to_bin(band.xover_width_low_hz, band.sr, fft_size, rounding=r)
    fade_bins_high = freq_to_bin(band.xover_width_high_hz, band.sr, fft_size, rounding=r)
    if band.f_low > 0:
        fade_in_start = max(0, bin_low - fade_bins_low)
        g[:fade_in_start] = 0.0
        fade_in_len = bin_low - fade_in_start
        if fade_in_len > 0:
            x = (np.arange(fade_in_len) + 0.5) / fade_in_len
            g[fade_in_start:bin_low] = 0.5 * (1.0 - np.cos(np.pi * x))
    if band.f_high < band.sr * 0.5:
        fade_out_start = bin_high + 1
        fade_out_end = min(fade_out_start + fade_bins_high, n_bins)
        if fade_out_start < n_bins:
            fade_out_len = fade_out_end - fade_out_start
            x = (np.arange(fade_out_len) + 0.5) / fade_out_len
            g[fade_out_start:fade_out_end] = 0.5 * (1.0 + np.cos(np.pi * x))
            g[fade_out_end:] = 0.0
