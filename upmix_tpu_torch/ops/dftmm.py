"""Direct banded DFT weights (port of `upmix_tpu/ops/dftmm.py`).

A bucket keeps only K bins [lo, hi] (band passbands plus fades), so its
transform is one real product per direction against a precomputed slice:

    S_re | S_im = frames @ w_fwd,   w_fwd = aw ⊙ [cos | -sin]    [B, 2K]
    frames_out  = [S_re | S_im] @ w_inv                           [2K, B]

with the synthesis window, 2/N, and the 1/N weight of the DC and Nyquist
bins folded into w_inv.  Angles are computed in float64 and the weights
stored in float32, exactly as the JAX package does (tests pin them bit
for bit).  No kernel of the port multiplies by these slices any more
(its kernels run FFTs, `csrc/fft.cuh`); the copy stays, pinned by
tests/test_torch_ops.py, with `rdft_direct` / `irdft_direct` the plain
tensor products.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DirectPlan:
    n: int
    lo_bin: int
    hi_bin: int  # inclusive; K = hi - lo + 1 kept bins
    w_fwd: np.ndarray  # [N, 2K]  (re columns then im columns)
    w_inv: np.ndarray  # [2K, N]

    @property
    def n_bins(self) -> int:
        return self.hi_bin - self.lo_bin + 1


def make_direct_plan(
    n: int, lo_bin: int, hi_bin: int, analysis_window: np.ndarray, synthesis_window: np.ndarray
) -> DirectPlan:
    """Weights for bins [lo_bin, hi_bin] of an n-point block.  Not cached:
    callers keep the device copy (models.offline.Upmixer)."""
    n = int(n)
    lo_bin = max(0, int(lo_bin))
    hi_bin = min(n // 2, int(hi_bin))
    aw = np.asarray(analysis_window, dtype=np.float32)
    sw = np.asarray(synthesis_window, dtype=np.float32)
    k = np.arange(lo_bin, hi_bin + 1)[None, :]  # [1, K]
    t = np.arange(n)[:, None]  # [N, 1]
    ang = 2.0 * np.pi * (t * k) / n
    cos = np.cos(ang)
    sin = np.sin(ang)
    w_fwd = np.concatenate(
        [aw[:, None] * cos, aw[:, None] * (-sin)], axis=1
    ).astype(np.float32)
    wk = np.full(k.shape[1], 2.0 / n)
    wk[k[0] == 0] = 1.0 / n
    wk[k[0] == n // 2] = 1.0 / n
    inv_re = (wk[:, None] * cos.T) * sw[None, :]
    inv_im = (wk[:, None] * (-sin.T)) * sw[None, :]
    w_inv = np.concatenate([inv_re, inv_im], axis=0).astype(np.float32)
    return DirectPlan(n=n, lo_bin=lo_bin, hi_bin=hi_bin, w_fwd=w_fwd, w_inv=w_inv)


def rdft_direct(x: torch.Tensor, w_fwd: torch.Tensor):
    """Windowed forward DFT on the kept bins: x [..., N] (un-windowed
    frames) -> (re, im) [..., K]."""
    s = x @ w_fwd
    k = w_fwd.shape[1] // 2
    return s[..., :k], s[..., k:]


def irdft_direct(sre: torch.Tensor, sim: torch.Tensor, w_inv: torch.Tensor) -> torch.Tensor:
    """Kept bins (re, im) [..., K] -> synthesis-windowed frames [..., N]."""
    return torch.cat([sre, sim], dim=-1) @ w_inv
