"""Built-in analysis windows and the WOLA synthesis-window design.

Numpy copies of `upmix_tpu/ops/windows.py` (the built-in windows and
`design_wola_synthesis_window`): the port imports nothing of the JAX
package.  tests/test_torch_ops.py pins every window to the JAX
package's output bit for bit.  `BUILTIN_WINDOWS` is the set of names
the port's configs accept.
"""

from __future__ import annotations

import numpy as np

from upmix_tpu_torch.config import EPS


def make_blackman_harris(N: int) -> np.ndarray:
    """4-term Blackman-Harris, a0..a3 = 0.35875/0.48829/0.14128/0.01168."""
    n = np.arange(N)
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    w = (
        a0
        - a1 * np.cos(2 * np.pi * n / (N - 1))
        + a2 * np.cos(4 * np.pi * n / (N - 1))
        - a3 * np.cos(6 * np.pi * n / (N - 1))
    )
    return w.astype(np.float32)


_WINDOWS = {
    "blackman_harris": make_blackman_harris,
    "sqrt_hann": lambda N: np.sqrt(np.hanning(N)).astype(np.float32),
    "hann": lambda N: np.hanning(N).astype(np.float32),
    "blackman": lambda N: np.blackman(N).astype(np.float32),
    "hamming": lambda N: np.hamming(N).astype(np.float32),
    "rect": lambda N: np.ones(N, dtype=np.float32),
}
BUILTIN_WINDOWS = tuple(_WINDOWS)


def make_window(name: str, N: int) -> np.ndarray:
    fn = _WINDOWS.get(name)
    if fn is None:
        raise NotImplementedError(
            f"window {name!r} is not built in; the torch port supports "
            f"{BUILTIN_WINDOWS} (ROADMAP.md, Queue 1: custom windows)"
        )
    return fn(int(N))


def design_wola_synthesis_window(analysis_window: np.ndarray, overlap: float) -> np.ndarray:
    """w_S(n) = w_A(n) / (sum_k w_A^2((n + k*H) mod L) + EPS), with each
    term squared in float32 and summed in float64 as the reference does."""
    L = len(analysis_window)
    hop = int(L * (1.0 - overlap))
    if hop < 1:
        raise ValueError("Overlap too large; resulting hop size < 1.")
    K = int(round(1.0 / (1.0 - overlap)))
    aw = np.asarray(analysis_window)
    idx = (np.arange(L)[:, None] + np.arange(K)[None, :] * hop) % L
    terms = (aw[idx] * aw[idx]).astype(np.float64)
    denom = terms.sum(axis=1) + EPS
    return (aw / denom).astype(analysis_window.dtype)
