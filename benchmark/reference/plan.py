"""The band plan, worked out anew from a configuration file's numbers.

A frozen statement of the reference algorithm's planning rules
(willleskowitz/upmix python-prototype/center_extraction.py:142-266 and
518-580, bela/upmix.cpp:45-54 and 444-514): block size per band from its
low edge, crossover fade widths, the per-bin band gains with raised-cosine
fades, the analysis window and the WOLA synthesis window.  Everything is
float64 NumPy.  It imports nothing of the program under test, so the
yardstick stays put whatever later changes do to the program's planner.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

EPS = 1e-12
MAX_BANDS_STREAM = 8  # the C++ aggregator keeps the first eight bands


@dataclass(frozen=True)
class Band:
    f_low: float
    f_high: float
    sr: float
    block: int
    hop: int
    fade_low_hz: float
    fade_high_hz: float


@dataclass(frozen=True)
class Bucket:
    """Bands of one block size: they share a frame and its transform."""

    block: int
    hop: int
    gains: np.ndarray  # [bands, block // 2 + 1] float64
    analysis: np.ndarray  # [block] float64
    synthesis: np.ndarray  # [block] float64


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def _block_for(f_low: float, sr: float, max_block: int, threshold: float) -> int:
    if f_low <= 0.0:
        return max_block
    return min(_next_pow2(int(math.ceil(sr * threshold / f_low))), max_block)


def freq_to_bin(f: float, sr: float, fft: int, rounding: str) -> int:
    if rounding == "python":  # int(round(...)): ties to even, no clamp
        return int(round(f / (sr / float(fft))))
    if rounding == "cpp":  # lround of the clamped bin
        b = min(max(f * fft / sr, 0.0), float(fft // 2))
        return int(math.floor(b + 0.5))
    raise ValueError(f"unknown bin rounding {rounding!r}")


def geometry(cfg: dict) -> tuple[float, int, list]:
    """(overlap, max block, band edges with Nyquist appended) of a
    configuration file: `constructor` "make" is the offline one,
    "streaming" the Bela one (overlap 0.75, blocks capped at 4 hardware
    blocks)."""
    sr = float(cfg["sr"])
    if cfg["constructor"] == "streaming":
        overlap, max_block = 0.75, 4 * int(cfg["hw_block_size"])
    elif cfg["constructor"] == "make":
        overlap, max_block = float(cfg["overlap"]), int(cfg["max_block_size"])
    else:
        raise ValueError(f"unknown constructor {cfg['constructor']!r}")
    edges = [float(e) for e in cfg["band_edges"]]
    if edges[-1] < sr / 2:
        edges.append(sr / 2)
    return overlap, max_block, edges


def bands(cfg: dict) -> list:
    sr = float(cfg["sr"])
    overlap, max_block, edges = geometry(cfg)
    out, prev_fade = [], 0.0
    for lo, hi in zip(edges, edges[1:]):
        block = _block_for(lo, sr, max_block, float(cfg["threshold_factor"]))
        fade_high = hi * float(cfg["xo_fraction"])
        out.append(Band(lo, hi, sr, block, int(block * (1 - overlap)), prev_fade, fade_high))
        prev_fade = fade_high
    if cfg["constructor"] == "streaming":
        out = out[:MAX_BANDS_STREAM]
    return out


def band_gain(band: Band, xover: str, rounding: str) -> np.ndarray:
    """Unit passband [bin_low, bin_high], half-cosine fades outside it."""
    n_bins = band.block // 2 + 1
    lo = freq_to_bin(band.f_low, band.sr, band.block, rounding)
    hi = freq_to_bin(band.f_high, band.sr, band.block, rounding)
    lo, hi = min(lo, hi), max(lo, hi)
    g = np.ones(n_bins)
    if xover != "raised_cosine":
        g[:lo] = 0.0
        g[hi + 1 :] = 0.0
        return g
    lo, hi = max(lo, 0), min(hi, n_bins - 1)
    if lo > hi:
        return np.zeros(n_bins)
    fade_lo = freq_to_bin(band.fade_low_hz, band.sr, band.block, rounding)
    fade_hi = freq_to_bin(band.fade_high_hz, band.sr, band.block, rounding)
    if band.f_low > 0:
        start = max(0, lo - fade_lo)
        g[:start] = 0.0
        if lo > start:
            x = (np.arange(lo - start) + 0.5) / (lo - start)
            g[start:lo] = 0.5 * (1.0 - np.cos(np.pi * x))
    if band.f_high < band.sr * 0.5 and hi + 1 < n_bins:
        start, end = hi + 1, min(hi + 1 + fade_hi, n_bins)
        x = (np.arange(end - start) + 0.5) / (end - start)
        g[start:end] = 0.5 * (1.0 + np.cos(np.pi * x))
        g[end:] = 0.0
    return g


def window(name: str, n: int) -> np.ndarray:
    k = np.arange(n)
    if name == "blackman_harris":
        a = (0.35875, 0.48829, 0.14128, 0.01168)
        t = 2 * np.pi * k / (n - 1)
        return a[0] - a[1] * np.cos(t) + a[2] * np.cos(2 * t) - a[3] * np.cos(3 * t)
    simple = {"hann": np.hanning, "blackman": np.blackman, "hamming": np.hamming}
    if name in simple:
        return simple[name](n)
    if name == "sqrt_hann":
        return np.sqrt(np.hanning(n))
    if name == "rect":
        return np.ones(n)
    raise ValueError(f"unknown window {name!r}")


def wola_synthesis(aw: np.ndarray, overlap: float) -> np.ndarray:
    """w_S(n) = w_A(n) / (sum_k w_A^2((n + k H) mod L) + EPS)."""
    size = len(aw)
    hop = int(size * (1.0 - overlap))
    k = int(round(1.0 / (1.0 - overlap)))
    idx = (np.arange(size)[:, None] + np.arange(k)[None, :] * hop) % size
    return aw / ((aw[idx] ** 2).sum(axis=1) + EPS)


def buckets(cfg: dict) -> list:
    """The configuration's buckets in band order."""
    overlap, _, _ = geometry(cfg)
    grouped: dict = {}
    for b in bands(cfg):
        grouped.setdefault(b.block, []).append(b)
    out = []
    for block, members in grouped.items():
        aw = window(cfg["window"], block)
        if cfg["synthesis"] == "wola":
            sw = wola_synthesis(aw, overlap)
        elif cfg["synthesis"] == "analysis":
            sw = aw
        else:
            raise ValueError(f"unknown synthesis {cfg['synthesis']!r}")
        gains = np.stack([band_gain(b, cfg["xover_mode"], cfg["bin_rounding"]) for b in members])
        out.append(Bucket(block, members[0].hop, gains, aw, sw))
    return out
