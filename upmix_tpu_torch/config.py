"""Band configuration and sizing logic: the port's own copy of
`upmix_tpu/config.py`.

Standard library only, so importing the package stays free of torch.
The two packages build equal configs from the same arguments
(`tests/test_torch_config.py` pins `dataclasses.asdict` of both).  A
window name that is not built in is looked up in the port's own runtime
registry of custom windows (`ops/windows.py`), as the JAX package looks
it up in its own.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Iterable, Sequence

EPS = 1e-12

# Streaming (C++-parity) defaults — reference: bela/upmix.cpp:24-29.
MAX_STFT_SIZE_STREAM = 8192
THRESHOLD_MULTI = 32.0
XO_FRACTION = 0.25
MAX_BANDS_STREAM = 8


def _check_window(name: str) -> None:
    # ops.windows imports EPS from this module: import it here, lazily.
    from upmix_tpu_torch.ops.windows import is_known_window, window_names

    if not is_known_window(name):
        raise ValueError(f"unknown window {name!r}; one of {tuple(window_names())}")


def next_power_of_2(x: int) -> int:
    """Smallest power of two >= x; 1 for x < 1 (center_extraction.py:156-171)."""
    if x < 1:
        return 1
    power = 1
    while power < x:
        power <<= 1
    return power


def freq_to_bin(freq_hz: float, sr: float, fft_size: int, rounding: str = "python") -> int:
    """Map a frequency in Hz to an rFFT bin index.

    rounding="python": int(round(f / (sr / fft_size))), banker's rounding,
    no clamping (center_extraction.py:142-154).  rounding="cpp":
    lround(f * fft / sr) clamped to [0, fft/2] (bela/upmix.cpp:45-54).
    """
    if rounding == "python":
        return int(round(freq_hz / (sr / float(fft_size))))
    if rounding == "cpp":
        binf = freq_hz * fft_size / sr
        binf = min(max(binf, 0.0), float(fft_size // 2))
        return int(math.floor(binf + 0.5))
    raise ValueError(f"unknown bin rounding mode: {rounding!r}")


def compute_block_size_for_low_freq(
    f_low: float,
    sr: float,
    max_block_size: int = 2**16,
    threshold_factor: float = 32.0,
) -> int:
    """sr * threshold_factor / f_low rounded up to a power of two, clamped
    to max_block_size; f_low <= 0 gives max_block_size
    (center_extraction.py:173-197)."""
    if f_low <= 0.0:
        return max_block_size
    threshold = (sr * threshold_factor) / f_low
    candidate = next_power_of_2(int(math.ceil(threshold)))
    return min(candidate, max_block_size)


def hp_freq_to_crossover_width(hp_freq: float, fraction: float = XO_FRACTION) -> float:
    """Crossover fade width in Hz: `fraction` of the edge frequency."""
    return hp_freq * fraction


@dataclass(frozen=True)
class BandSpec:
    """One frequency band's static parameters (center_extraction.py:240-266)."""

    f_low: float
    f_high: float
    sr: float
    block_size: int
    overlap: float = 0.75
    window: str = "blackman_harris"
    xover_mode: str = "raised_cosine"
    xover_width_low_hz: float = 50.0
    xover_width_high_hz: float = 50.0
    bin_rounding: str = "python"

    def __post_init__(self):
        _check_window(self.window)
        if self.hop_size < 1:
            raise ValueError("Overlap too large; hop size < 1 is not allowed.")

    @property
    def hop_size(self) -> int:
        return int(self.block_size * (1 - self.overlap))

    @property
    def n_bins(self) -> int:
        return self.block_size // 2 + 1


@dataclass(frozen=True)
class UpmixConfig:
    """Full multiband configuration.  `make` gives the offline defaults
    (main.py:62-73), `streaming` the bela/upmix.cpp:521-528 construction."""

    sr: float
    bands: tuple  # tuple[BandSpec, ...]
    overlap: float = 0.75
    window: str = "blackman_harris"
    xover_mode: str = "raised_cosine"
    synthesis: str = "wola"  # "wola" (Python parity) | "analysis" (C++ parity)
    bin_rounding: str = "python"

    def __post_init__(self):
        _check_window(self.window)

    @property
    def band_edges(self) -> tuple:
        edges = [b.f_low for b in self.bands]
        edges.append(self.bands[-1].f_high)
        return tuple(edges)

    @staticmethod
    def make(
        band_edges: Sequence[float],
        sr: float,
        overlap: float = 0.75,
        window: str = "blackman_harris",
        xover_mode: str = "raised_cosine",
        max_block_size: int = 2**16,
        threshold_factor: float = THRESHOLD_MULTI,
        xo_fraction: float = XO_FRACTION,
        synthesis: str = "wola",
        bin_rounding: str = "python",
        verbose: bool = False,
    ) -> "UpmixConfig":
        bands = chain_bands(
            band_edges,
            overlap=overlap,
            window=window,
            sr=sr,
            xover_mode=xover_mode,
            max_block_size=max_block_size,
            threshold_factor=threshold_factor,
            xo_fraction=xo_fraction,
            bin_rounding=bin_rounding,
            verbose=verbose,
        )
        return UpmixConfig(
            sr=sr,
            bands=tuple(bands),
            overlap=overlap,
            window=window,
            xover_mode=xover_mode,
            synthesis=synthesis,
            bin_rounding=bin_rounding,
        )

    @staticmethod
    def streaming(
        band_edges: Sequence[float],
        sr: float,
        hw_block_size: int,
        threshold_factor: float = THRESHOLD_MULTI,
        xo_fraction: float = XO_FRACTION,
        window: str = "blackman_harris",
        xover_mode: str = "raised_cosine",
        synthesis: str = "analysis",
        bin_rounding: str = "cpp",
        verbose: bool = False,
    ) -> "UpmixConfig":
        """C++-parity streaming config: fixed 75% overlap, blocks capped at
        hw_block_size * 4, at most 8 bands (bela/upmix.cpp:444-445, 498-506)."""
        if verbose:
            print(streaming_stft_table(sr, hw_block_size, threshold_factor))
        bands = chain_bands(
            band_edges,
            overlap=0.75,
            window=window,
            sr=sr,
            xover_mode=xover_mode,
            max_block_size=hw_block_size * 4,
            threshold_factor=threshold_factor,
            xo_fraction=xo_fraction,
            bin_rounding=bin_rounding,
            verbose=verbose,
        )
        # The C++ aggregator drops bands past the eighth (bela/upmix.cpp:508).
        bands = bands[:MAX_BANDS_STREAM]
        return UpmixConfig(
            sr=sr,
            bands=tuple(bands),
            overlap=0.75,
            window=window,
            xover_mode=xover_mode,
            synthesis=synthesis,
            bin_rounding=bin_rounding,
        )


def chain_bands(
    band_edges: Sequence[float],
    overlap: float,
    window: str,
    sr: float,
    xover_mode: str = "raised_cosine",
    max_block_size: int = 2**16,
    threshold_factor: float = THRESHOLD_MULTI,
    xo_fraction: float = XO_FRACTION,
    bin_rounding: str = "python",
    verbose: bool = False,
) -> list:
    """Consecutive bands from the edges (center_extraction.py:518-580):
    sr/2 is appended if the last edge is below Nyquist; each band's low
    fade width is the previous band's high one, and the high fade width
    is `xo_fraction` of its upper edge.  Edges must be non-negative and
    strictly ascending."""
    band_edges = list(band_edges)
    if not band_edges:
        raise ValueError("band_edges is empty")
    if band_edges[0] < 0.0:
        raise ValueError(f"band_edges must be non-negative, got {band_edges[0]}")
    if any(b <= a for a, b in zip(band_edges, band_edges[1:])):
        raise ValueError(f"band_edges must be ascending, got {band_edges}")
    if band_edges[-1] < (sr / 2.0):
        band_edges = band_edges + [sr / 2.0]

    bands = []
    prev_xover_high = 0.0
    for i in range(len(band_edges) - 1):
        f_low = band_edges[i]
        f_high = band_edges[i + 1]
        block_size = compute_block_size_for_low_freq(
            f_low, sr, max_block_size=max_block_size, threshold_factor=threshold_factor
        )
        xover_low = prev_xover_high
        xover_high = hp_freq_to_crossover_width(f_high, fraction=xo_fraction)
        if verbose:
            print(
                f"[Band {i + 1}] f_low={f_low:.1f} Hz, "
                f"f_high={f_high:.1f} Hz, block_size={block_size}, "
                f"xover_low={xover_low:.1f} Hz, xover_high={xover_high:.1f} Hz"
            )
        bands.append(
            BandSpec(
                f_low=float(f_low),
                f_high=float(f_high),
                sr=float(sr),
                block_size=block_size,
                overlap=overlap,
                window=window,
                xover_mode=xover_mode,
                xover_width_low_hz=float(xover_low),
                xover_width_high_hz=float(xover_high),
                bin_rounding=bin_rounding,
            )
        )
        prev_xover_high = xover_high
    if not bands:
        raise ValueError(
            f"band_edges {band_edges} yield no bands: at least one edge "
            f"must lie below Nyquist ({sr / 2.0:.1f} Hz)"
        )
    return bands


def streaming_stft_table(
    sr: float,
    hw_block_size: int,
    threshold_factor: float = THRESHOLD_MULTI,
    freqs: Sequence[float] = (20, 40, 80, 160, 320, 640, 1280, 2560, 5120),
) -> str:
    """Block size per band low frequency under the hw_block*4 cap, as the
    C++ engine prints it at setup (bela/upmix.cpp:448-459)."""
    lines = [
        f"STFT size by band low frequency (sr={sr:.0f} Hz, "
        f"hw_block={hw_block_size}, cap={hw_block_size * 4}):"
    ]
    for f in freqs:
        size = compute_block_size_for_low_freq(
            float(f), sr, max_block_size=hw_block_size * 4, threshold_factor=threshold_factor
        )
        lines.append(f"  f_low >= {f:7.1f} Hz -> stft {size}")
    return "\n".join(lines)


def config_to_dict(config: UpmixConfig) -> dict:
    """JSON-safe dict of the full band-resolved config (the port's copy of
    `upmix_tpu/aot.py::config_to_dict`).  Custom windows are process-local
    registrations: their coefficients ride along under "custom_windows"
    (`ops.windows.window_payload`), so a server checkpoint taken with one
    window does not match a server whose window of that name differs."""
    from upmix_tpu_torch.ops import windows

    d = dataclasses.asdict(config)
    payloads = {}
    for b in config.bands:
        if not windows.is_builtin_window(b.window) and b.window not in payloads:
            payloads[b.window] = windows.window_payload(
                b.window, [bb.block_size for bb in config.bands if bb.window == b.window]
            )
    if payloads:
        d["custom_windows"] = payloads
    return d


def bucket_bands(bands: Iterable[BandSpec]) -> dict:
    """Bands grouped by block size, in order: {block_size: [BandSpec, ...]}.
    Bands of one bucket share their forward transform."""
    buckets: dict = {}
    for band in bands:
        buckets.setdefault(band.block_size, []).append(band)
    return buckets
