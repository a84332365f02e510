"""The omnibus engine: every bucket of a config in one call per chunk.

Port of `upmix_tpu/ops/pallas_omnibus.py` (omnibus_lcr_batch, the TPU
kernel of the offline main path), with the same contract:

    x [S, 2, chunk + halo] float32 -> (main [S, 3, chunk], spill [S, 3, halo])

For each bucket (block B, hop H, kept bins lo..lo+K-1) and each segment
s, frame f = 0 .. chunk/H - 1 reads x[s, :, f*H : f*H + B]; its windowed
kept-bin spectrum goes through gain x center mask, summed over the
bucket's bands; the three inverse frames (C, Ls, Rs), synthesis-windowed,
overlap-add into [0, chunk + B - H).  Every bucket adds into one output;
`spill` is the part past `chunk`, which the caller adds into the next
segment's head.

On a CUDA tensor `omnibus_lcr_batch` launches the kernels of
`csrc/omnibus.cu` (direct banded DFT products in FP32); on a CPU tensor
it runs `omnibus_lcr_batch_plain` (torch.fft).  There is no fallback
between the two.

What the TPU plan needed only for Mosaic has no counterpart here: no
tile LCM or minimum tile, no lookahead views, no two-stage transform, no
bf16 hi/lo weight pairs.  The plan is the list of live buckets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from upmix_tpu_torch.ops.dftmm import make_direct_plan
from upmix_tpu_torch.ops.framing import frame_signal, overlap_add
from upmix_tpu_torch.ops.mask import mask_sum

# CUDA kernel launches made by omnibus_lcr_batch (three per bucket).
LAUNCHES = 0

_TILE = 64  # output tile of the forward kernel (csrc/omnibus.cu: BM = BN)


@dataclass(frozen=True, eq=False)
class OmnibusBucket:
    """One live bucket on its device: geometry, windows, kept-bin gains,
    and on a CUDA device the direct-DFT weight slices the kernel uses."""

    block: int
    hop: int
    lo: int  # first kept bin
    analysis_window: torch.Tensor  # [B]
    synthesis_window: torch.Tensor  # [B]
    gains: torch.Tensor  # [n_bands, K], bins lo .. lo + K - 1
    w_fwd: torch.Tensor | None  # [B, 2K]
    w_inv: torch.Tensor | None  # [2K, B]

    @property
    def kept(self) -> int:
        return self.gains.shape[1]

    @property
    def spill(self) -> int:
        return self.block - self.hop


def check_geometry(block: int, hop: int) -> None:
    """The chunked path needs power-of-two blocks and hop | block."""
    if block & (block - 1) or block % hop:
        raise NotImplementedError(
            f"block {block} / hop {hop}: the torch port runs power-of-two "
            "blocks whose hop divides the block; the gather path (hop not "
            "dividing the block) and the non-power-of-two fallback are "
            "later items of ROADMAP.md, Queue 1"
        )


def make_bucket(p, device) -> OmnibusBucket | None:
    """Device record of one offline bucket plan, or None for a bucket whose
    gains are all zero (it contributes nothing).  `p` is a `_BucketPlan` of
    either package: block_size, hop_size, analysis_window,
    synthesis_window, gains [n_bands, n_bins] as numpy arrays."""
    B, H = p.block_size, p.hop_size
    check_geometry(B, H)
    nz = np.nonzero(p.gains.max(axis=0))[0]
    if not len(nz):
        return None
    lo, hi = int(nz[0]), int(nz[-1])
    device = torch.device(device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    w_fwd = w_inv = None
    if device.type == "cuda":
        dp = make_direct_plan(B, lo, hi, p.analysis_window, p.synthesis_window)
        w_fwd, w_inv = dev(dp.w_fwd), dev(dp.w_inv)
    return OmnibusBucket(
        block=B,
        hop=H,
        lo=lo,
        analysis_window=dev(p.analysis_window),
        synthesis_window=dev(p.synthesis_window),
        gains=dev(p.gains[:, lo : hi + 1]),
        w_fwd=w_fwd,
        w_inv=w_inv,
    )


@dataclass(frozen=True, eq=False)
class OmnibusPlan:
    chunk: int
    halo: int  # max(B - H) over the buckets
    buckets: tuple  # OmnibusBucket, widest spill first


def make_omnibus_plan(buckets, chunk: int) -> OmnibusPlan | None:
    """Plan for `chunk` fresh samples per segment over the live buckets
    (None entries are dead buckets and are dropped).  None if no bucket is
    live.  The widest spill goes first: its launch covers the whole
    [chunk + halo] output and stores, the others add."""
    live = sorted((b for b in buckets if b is not None), key=lambda b: -b.spill)
    if not live:
        return None
    for b in live:
        if chunk % b.hop:
            raise ValueError(f"chunk {chunk} is not a multiple of hop {b.hop}")
    return OmnibusPlan(chunk=chunk, halo=live[0].spill, buckets=tuple(live))


def _check_input(x: torch.Tensor, plan: OmnibusPlan) -> None:
    width = plan.chunk + plan.halo
    if x.dim() != 3 or x.shape[1] != 2 or x.shape[2] != width:
        raise ValueError(f"expected x [S, 2, {width}], got {tuple(x.shape)}")


def omnibus_lcr_batch(x: torch.Tensor, plan: OmnibusPlan):
    """x [S, 2, chunk + halo] float32 -> (main [S, 3, chunk], spill
    [S, 3, halo]), views of one [S, 3, chunk + halo] tensor.  A CPU tensor
    runs the plain version; a CUDA tensor runs the kernel."""
    if x.device.type == "cpu":
        return omnibus_lcr_batch_plain(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"omnibus_lcr_batch runs on cpu or cuda, not {x.device}")
    y = _omnibus_cuda(x, plan)
    return y[:, :, : plan.chunk], y[:, :, plan.chunk :]


def omnibus_lcr(x: torch.Tensor, plan: OmnibusPlan):
    """Single segment: x [2, chunk + halo] -> (main [3, chunk], spill [3, halo])."""
    main, spill = omnibus_lcr_batch(x[None], plan)
    return main[0], spill[0]


def _splits(M: int, N: int, B: int, n_sm: int) -> int:
    """Depth splits of the forward product: double until the grid holds
    two waves of blocks, keeping at least 1024 samples per split."""
    tiles = -(-M // _TILE) * -(-N // _TILE)
    P = 1
    while tiles * P < 2 * n_sm and B // (2 * P) >= 1024:
        P *= 2
    return P


def _launched(rc: int, what: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _omnibus_cuda(x: torch.Tensor, plan: OmnibusPlan) -> torch.Tensor:
    from upmix_tpu_torch.ops import _build

    _check_input(x, plan)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the omnibus kernel takes a contiguous float32 tensor")
    lib = _build.load()
    S, _, width = x.shape
    dev = x.device
    y = torch.empty((S, 3, width), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, b in enumerate(plan.buckets):
        if b.w_fwd is None or b.w_fwd.device != dev:
            raise ValueError(f"plan buckets live on {b.gains.device}, input on {dev}")
        B, H, K = b.block, b.hop, b.kept
        F = plan.chunk // H
        M = S * 2 * F
        P = _splits(M, 2 * K, B, n_sm)
        part = torch.empty((P, M, 2 * K), dtype=torch.float32, device=dev)
        spec = torch.empty((S, 3, F, 2 * K), dtype=torch.float32, device=dev)
        _launched(
            lib.omni_forward(
                x.data_ptr(), b.w_fwd.data_ptr(), part.data_ptr(),
                M, 2 * K, F, H, B, width, P, stream,
            ),
            "omni_forward",
        )
        _launched(
            lib.omni_mask(
                part.data_ptr(), b.gains.data_ptr(), spec.data_ptr(),
                S, F, K, b.gains.shape[0], P, stream,
            ),
            "omni_mask",
        )
        _launched(
            lib.omni_inverse(
                spec.data_ptr(), b.w_inv.data_ptr(), y.data_ptr(),
                S, F, H, B, 2 * K, width, int(i > 0), stream,
            ),
            "omni_inverse",
        )
    return y


def omnibus_lcr_batch_plain(x: torch.Tensor, plan: OmnibusPlan):
    """The plain PyTorch version, same contract: per bucket frame, window,
    torch.fft.rfft, gain x mask x band sum on the kept bins, irfft,
    synthesis window, overlap-add.  Computes in x's dtype (float64 gives
    a reference for the float32 kernel)."""
    _check_input(x, plan)
    S = x.shape[0]
    chunk = plan.chunk
    y = x.new_zeros((S, 3, chunk + plan.halo))
    for b in plan.buckets:
        B, H, K, lo = b.block, b.hop, b.kept, b.lo
        F = chunk // H
        span = chunk + B - H
        frames = frame_signal(x[..., :span], B, H, F)  # [S, 2, F, B]
        spec = torch.fft.rfft(frames * b.analysis_window.to(x.dtype))[..., lo : lo + K]
        sl, sr = spec[:, 0], spec[:, 1]
        c_re, c_im, l_re, l_im, r_re, r_im = mask_sum(
            sl.real, sl.imag, sr.real, sr.imag, b.gains.to(x.dtype)
        )
        full = spec.new_zeros((S, 3, F, B // 2 + 1))
        full[..., lo : lo + K] = torch.complex(
            torch.stack([c_re, l_re, r_re], dim=1), torch.stack([c_im, l_im, r_im], dim=1)
        )
        rec = torch.fft.irfft(full, n=B) * b.synthesis_window.to(x.dtype)
        y[..., :span] += overlap_add(rec, H)
    return y[:, :, :chunk], y[:, :, chunk:]
