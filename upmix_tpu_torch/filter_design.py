"""Host-side LR4-approximating FIR crossover design.

The port's numpy-only copy of `upmix_tpu/filter_design.py` (the
reference's python-prototype/filter_design.py:25-60): Hamming-windowed
FIR high and low pass, 1025 taps at 180 Hz by default, pass-through
[1.0] for a cutoff <= 0, applied as a causal FIR.  The taps are the JAX
package's dependency-free windowed sinc, which matches
scipy.signal.firwin's construction to about 1e-9; the filter is a
truncated np.convolve.  It runs on the host: no tensor op is involved.
"""

from __future__ import annotations

import numpy as np


def _firwin(numtaps: int, cutoff: float, pass_zero: bool) -> np.ndarray:
    """Hamming-windowed sinc FIR, scipy.signal.firwin's construction
    (type I, scaled so the passband's reference gain is 1)."""
    m = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * m)
    if not pass_zero:
        # Spectral inversion of the complementary low-pass: delta - lp
        h = -h
        h[(numtaps - 1) // 2] += 1.0
    h *= np.hamming(numtaps)
    # Normalised at the reference frequency (DC for a low pass, Nyquist for a high pass)
    if pass_zero:
        h /= h.sum()
    else:
        h /= (h * np.cos(np.pi * m)).sum()
    return h


def design_lr4_hp_fir(sr: float, cutoff_hz: float = 180.0, numtaps: int = 1025) -> np.ndarray:
    """Approximate 4th-order Linkwitz-Riley high-pass FIR; cutoff <= 0 gives
    the pass-through [1.0]."""
    if cutoff_hz <= 0:
        return np.array([1.0], dtype=np.float32)
    return _firwin(numtaps, cutoff_hz / (0.5 * sr), pass_zero=False).astype(np.float32)


def design_lr4_lp_fir(sr: float, cutoff_hz: float = 180.0, numtaps: int = 1025) -> np.ndarray:
    """Approximate 4th-order Linkwitz-Riley low-pass FIR; cutoff <= 0 gives
    the pass-through [1.0]."""
    if cutoff_hz <= 0:
        return np.array([1.0], dtype=np.float32)
    return _firwin(numtaps, cutoff_hz / (0.5 * sr), pass_zero=True).astype(np.float32)


def apply_fir_filter(wave: np.ndarray, fir_taps: np.ndarray) -> np.ndarray:
    """Causal FIR filtering: y = taps * x, as long as the input."""
    return np.convolve(wave, fir_taps)[: len(wave)]
