"""Window/overlap-add visualization and A/B comparison plots.

The port's copy of `upmix_tpu/visualize.py` (numpy; matplotlib imported
on first plot, so headless use never loads it): the reference's 3-panel
window/OA plot (center_extraction.py:585-640) and the demo's
time/spectrum comparison of `Ls+C+Rs` vs `L+R`
(center_extraction.py:699-736).  tests/test_torch_leaf.py holds the
arrays behind the plots to the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def overlapped_window_sums(analysis_window, synthesis_window, overlap: float):
    """The arrays behind the window/OA plot (pure math, golden-testable).

    Returns (asum, wsum): the sum of K overlapped analysis windows and of
    K overlapped analysis*synthesis products over the K-frame span.  The
    latter is the WOLA correctness diagnostic — ≈1.0 on the fully
    overlapped interior when the synthesis design is right
    (center_extraction.py:592-637).
    """
    L = len(analysis_window)
    hop = int(L * (1 - overlap))
    K = int(round(1.0 / (1.0 - overlap)))
    total = L + (K - 1) * hop
    asum = np.zeros(total, dtype=np.float64)
    wsum = np.zeros(total, dtype=np.float64)
    prod = np.asarray(analysis_window, dtype=np.float64) * np.asarray(
        synthesis_window, dtype=np.float64
    )
    for k in range(K):
        asum[k * hop : k * hop + L] += analysis_window
        wsum[k * hop : k * hop + L] += prod
    return asum, wsum


def comparison_arrays(C, Ls, Rs, L, R, sr: float):
    """The arrays behind the A/B comparison plot (pure math).

    Returns (t, upmix, orig, freqs, upmix_spec, orig_spec): peak-normalized
    time signals of Ls+C+Rs vs L+R and their rfft magnitudes
    (center_extraction.py:699-736)."""
    upmix = np.asarray(Ls) + np.asarray(C) + np.asarray(Rs)
    orig = np.asarray(L) + np.asarray(R)
    n = min(len(upmix), len(orig))
    upmix, orig = upmix[:n], orig[:n]
    upmix = upmix / (np.max(np.abs(upmix)) + 1e-12)
    orig = orig / (np.max(np.abs(orig)) + 1e-12)
    t = np.arange(n) / sr
    freqs = np.linspace(0, sr / 2, n // 2 + 1)
    return t, upmix, orig, freqs, np.abs(np.fft.rfft(upmix)), np.abs(np.fft.rfft(orig))


def visualize_windows(analysis_window, synthesis_window, overlap: float, save_path=None):
    """3 panels: single-frame windows; sum of K overlapped analysis windows;
    sum of K overlapped analysis*synthesis products (≈1.0 when the WOLA
    design is correct)."""
    plt = _plt()
    K = int(round(1.0 / (1.0 - overlap)))

    fig, axes = plt.subplots(3, 1, figsize=(10, 10))
    axes[0].set_title("Analysis vs. Synthesis Window (Single Frame)")
    axes[0].plot(analysis_window, label="Analysis")
    axes[0].plot(synthesis_window, label="Synthesis (WOLA)")
    axes[0].legend(loc="best")

    asum, wsum = overlapped_window_sums(analysis_window, synthesis_window, overlap)
    axes[1].set_title(f"Sum of {K} Overlapped Analysis Windows at {overlap * 100:.0f}% Overlap")
    axes[1].plot(asum)
    axes[2].set_title(f"Sum of {K} Overlapped Weighted Windows (Analysis*Synthesis)")
    axes[2].plot(wsum)

    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)
        return save_path
    plt.show()
    return None


def compare_upmix_vs_original(C, Ls, Rs, L, R, sr: float, save_path=None):
    """Time-domain + log-magnitude-spectrum comparison of the upmix sum
    (Ls+C+Rs) against the original stereo sum (L+R), both peak-normalized."""
    plt = _plt()
    t, upmix, orig, freqs, up_spec, orig_spec = comparison_arrays(C, Ls, Rs, L, R, sr)

    fig, axes = plt.subplots(2, 1, figsize=(12, 8))
    axes[0].plot(t, upmix, label="Upmix (Ls + C + Rs)")
    axes[0].plot(t, orig, label="Original (L + R)", alpha=0.75)
    axes[0].set_title("Time Domain Comparison")
    axes[0].legend(loc="upper right")

    axes[1].semilogy(freqs, up_spec, label="Upmix Spectrum")
    axes[1].semilogy(freqs, orig_spec, label="Original Spectrum", alpha=0.75)
    axes[1].set_title("Frequency Domain Comparison")
    axes[1].legend(loc="upper right")

    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)
        return save_path
    plt.show()
    return None
