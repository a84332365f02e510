"""The serving-pool step: one hardware block, or `hops` blocks, for every
stream at once.

Port of `upmix_tpu/ops/pallas_pool.py` (pool_step_lcr, the TPU kernel of
the serving pool), time-OLA dataflow.  Per stream s, bucket (block B,
hop H, P = hw/H frames per block, kept bins lo..lo+K-1) and hop i:

  - frame p of hop i reads hist[s, ch, i*hw + p*H : i*hw + p*H + B];
  - windowed kept-bin spectrum -> per band gain x center mask, summed
    over the bucket's bands -> inverse with the synthesis window;
  - the P inverse frames overlap-add at p*H onto the bucket's carry
    (added at [0, B)); the first hw samples are emitted, summed over
    buckets; the new carry is the tail [hw, hw + B - H) and H zeros;
  - a hop with t[s] + i < warmup (warmup = block/hop) emits exact zeros
    and leaves that stream's carries as they were;
  - carries chain across the hops of one call.

On a CUDA tensor `pool_step_lcr` launches `csrc/pool.cu`'s kernels: the
frames through FFTs in shared memory (`csrc/fft.cuh`), the mask, the
gated overlap-add and the carries, one launch per bucket, two for a
bucket over `fftplan.FFT_MAX` points (the two-stage split; from a
hardware block of 8192 samples at the streaming configs' 4 x hw cap;
`launches_per_bucket`).  On a CPU tensor it runs `pool_step_lcr_plain`
(torch.fft).  There is no fallback between the two.

What the TPU plan needed only for Mosaic has no counterpart: no group of
streams per grid step (so no n_streams % group rule), no 8 MB bound on the
baked weights, no bf16 hi/lo pairs, no quarter refs.  The plan declines
only what the function cannot do: a hop that does not divide hw or its
block, or mixed block/hop ratios.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as tnf

from upmix_tpu_torch.config import UpmixConfig, bucket_bands
from upmix_tpu_torch.ops.fftplan import FFT_MAX, launches_per_bucket, pass_twiddles
from upmix_tpu_torch.ops.framing import frame_signal, overlap_add
from upmix_tpu_torch.ops.mask import mask_sum
from upmix_tpu_torch.ops.omnibus import WideTables, check_kernel_tables, launch_geometry, make_wide_tables

# CUDA kernel launches made by pool_step_lcr (launches_per_bucket each).
LAUNCHES = 0


@dataclass(frozen=True, eq=False)
class PoolBucket:
    """One live bucket on its device: geometry, windows, kept-bin gains
    and the FFT kernels' tables.  A plan built for the CPU's plain
    version leaves out the tables of a block over FFT_MAX (`twiddles` and
    `wide` None), as `omnibus.make_bucket` does: the plain version runs
    any block."""

    block: int
    hop: int
    passes: int  # P = hw / hop frames per hardware block
    lo: int  # first kept bin
    analysis_window: torch.Tensor  # [B]
    synthesis_window: torch.Tensor  # [B]
    gains: torch.Tensor  # [n_bands, K], bins lo .. lo + K - 1
    twiddles: torch.Tensor | None  # fftplan.pass_twiddles of the kernel's FFT (B, or N1 when split)
    wide: WideTables | None  # the two-stage split, for B > FFT_MAX

    @property
    def kept(self) -> int:
        return self.gains.shape[1]


@dataclass(frozen=True, eq=False)
class PoolPlan:
    hw: int
    warmup: int  # K = block / hop, the same for every bucket
    n_streams: int
    buckets: tuple  # PoolBucket, live buckets in config order

    @property
    def window(self) -> int:
        """Shared history length: warmup * hw."""
        return self.warmup * self.hw


def plan_from_stream_buckets(records, hw: int, warmup: int, n_streams: int, device) -> PoolPlan | None:
    """Device plan from `_StreamBucketPlan` records (numpy arrays) of
    either package; None when every bucket's gains are zero.  The
    two-stage split's tables of a block over FFT_MAX are built for a CUDA
    device only."""
    device = torch.device(device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    buckets = []
    for p in records:
        nz = np.nonzero(p.gains.max(axis=0))[0]
        if not len(nz):
            continue  # a dead bucket contributes nothing
        lo, hi = int(nz[0]), int(nz[-1])
        wide = make_wide_tables(p.block_size, p.hop_size, lo, hi - lo + 1, device) if device.type == "cuda" else None
        n_fft = p.block_size if p.block_size <= FFT_MAX else (wide.n1 if wide is not None else 0)
        buckets.append(
            PoolBucket(
                block=p.block_size,
                hop=p.hop_size,
                passes=hw // p.hop_size,
                lo=lo,
                analysis_window=dev(p.analysis_window),
                synthesis_window=dev(p.synthesis_window),
                gains=dev(p.gains[:, lo : hi + 1]),
                twiddles=dev(pass_twiddles(n_fft)) if n_fft else None,
                wide=wide,
            )
        )
    if not buckets:
        return None
    return PoolPlan(hw=int(hw), warmup=int(warmup), n_streams=int(n_streams), buckets=tuple(buckets))


def make_pool_plan(config: UpmixConfig, hw: int, n_streams: int, device="cuda") -> PoolPlan | None:
    """The pool plan, or None for a config the step cannot run: a hop
    that does not divide hw or its block, mixed block/hop ratios, or no
    live bucket.  (With hop | hw every block fits the K * hw history:
    hw + (K - 1) * hop <= K * hw.)"""
    from upmix_tpu_torch.models.streaming import _plan_stream_buckets

    hw = int(hw)
    ratios = set()
    for block, bands in bucket_bands(config.bands).items():
        hop = bands[0].hop_size
        if hw % hop or block % hop:
            return None
        ratios.add(block // hop)
    if len(ratios) != 1:
        return None
    return plan_from_stream_buckets(_plan_stream_buckets(config, hw), hw, ratios.pop(), n_streams, device)


def _check_inputs(hist, t, carries, plan: PoolPlan, hops: int) -> None:
    if hops < 1:
        raise ValueError(f"hops must be >= 1, got {hops}")
    width = (plan.warmup - 1 + hops) * plan.hw
    if hist.dim() != 3 or hist.shape[1] != 2 or hist.shape[2] != width:
        raise ValueError(f"expected hist [S, 2, {width}] at hops={hops}, got {tuple(hist.shape)}")
    S = hist.shape[0]
    if tuple(t.shape) != (S,):
        raise ValueError(f"expected t [{S}], got {tuple(t.shape)}")
    if len(carries) != len(plan.buckets):
        raise ValueError(f"expected {len(plan.buckets)} bucket carries, got {len(carries)}")
    for b, c in zip(plan.buckets, carries):
        if tuple(c.shape) != (S, 3, b.block):
            raise ValueError(f"expected carry [{S}, 3, {b.block}], got {tuple(c.shape)}")


def pool_step_lcr(hist: torch.Tensor, t: torch.Tensor, carries, plan: PoolPlan, hops: int = 1):
    """hist [S, 2, (warmup - 1 + hops) * hw] float32, oldest -> newest
    (the last `hops` blocks are this call's input); t int32 [S], blocks
    seen including the first hop; carries: per bucket [S, 3, B].
    Returns (out [S, 3, hops * hw] = (C, Ls, Rs), new carries).  A CPU
    tensor runs the plain version; a CUDA tensor runs the kernels."""
    if hist.device.type == "cpu":
        return pool_step_lcr_plain(hist, t, carries, plan, hops)
    if hist.device.type != "cuda":
        raise ValueError(f"pool_step_lcr runs on cpu or cuda, not {hist.device}")
    return _pool_cuda(hist, t, carries, plan, int(hops))


def _launched(rc: int, what: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _pool_cuda(hist, t, carries, plan: PoolPlan, hops: int):
    from upmix_tpu_torch.ops import _build

    _check_inputs(hist, t, carries, plan, hops)
    dev = hist.device
    if hist.dtype != torch.float32 or not hist.is_contiguous():
        raise ValueError("the pool kernel takes a contiguous float32 history")
    if any(c.dtype != torch.float32 or not c.is_contiguous() or c.device != dev for c in carries):
        raise ValueError("the pool kernel takes contiguous float32 carries on the history's device")
    for b in plan.buckets:
        check_kernel_tables(b, dev)
    lib = _build.load()
    S, _, width = hist.shape
    hw, nq = plan.hw, plan.warmup
    t32 = t.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((S, 3, hops * hw), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    new = []
    for i, (b, carry) in enumerate(zip(plan.buckets, carries)):
        B, H, K, nb, w = b.block, b.hop, b.kept, b.gains.shape[0], b.wide
        carry_out = torch.empty((S, 3, B), dtype=torch.float32, device=dev)
        io = (carry.data_ptr(), t32.data_ptr(), out.data_ptr(), carry_out.data_ptr())
        if w is None:
            geo = launch_geometry(b, hops * b.passes, S, None, hops * b.passes + B // H)
            _launched(
                lib.pool_bucket(
                    hist.data_ptr(), *io, b.analysis_window.data_ptr(), b.synthesis_window.data_ptr(),
                    b.gains.data_ptr(), b.twiddles.data_ptr(), S, B, H, K, b.lo, nb, hw, hops, nq,
                    geo.frames, int(geo.pair), width, int(i > 0), stream,
                ),
                "pool_bucket",
            )
        else:
            part = torch.empty((S, hops * b.passes, w.groups, 2 * K, 2), dtype=torch.float32, device=dev)
            _launched(
                lib.pool_wide_forward(
                    hist.data_ptr(), t32.data_ptr(), part.data_ptr(), b.analysis_window.data_ptr(),
                    b.twiddles.data_ptr(), w.stage2.data_ptr(), S, B, H, K, b.lo, w.n1, w.cols, hw, hops, nq,
                    width, stream,
                ),
                "pool_wide_forward",
            )
            _launched(
                lib.pool_wide_inverse(
                    part.data_ptr(), *io, b.synthesis_window.data_ptr(), b.gains.data_ptr(), b.twiddles.data_ptr(),
                    w.stage2.data_ptr(), w.rows.data_ptr(), w.row_ptr.data_ptr(), w.entries.data_ptr(),
                    w.tile_ptr.data_ptr(), w.tiles, w.kt, S, B, H, K, b.lo, nb, w.n1, w.cols, hw, hops, nq,
                    int(i > 0), stream,
                ),
                "pool_wide_inverse",
            )
        new.append(carry_out)
    return out, tuple(new)


def pool_step_lcr_plain(hist: torch.Tensor, t: torch.Tensor, carries, plan: PoolPlan, hops: int = 1):
    """The plain PyTorch version, same contract: per bucket frame, window,
    torch.fft.rfft, gain x mask x band sum on the kept bins, irfft,
    synthesis window, then hop by hop the overlap-add onto the carry with
    the warmup gate.  Computes in hist's dtype (float64 gives a reference
    for the float32 kernel) on hist's device."""
    hops = int(hops)
    _check_inputs(hist, t, carries, plan, hops)
    S = hist.shape[0]
    hw, dt = plan.hw, hist.dtype
    out = hist.new_zeros((S, 3, hops * hw))
    steps = torch.arange(hops, device=hist.device)
    ready = (t.to(hist.device)[:, None] + steps[None, :] >= plan.warmup)[:, :, None, None]
    new = []
    for b, carry in zip(plan.buckets, carries):
        B, H, P, K, lo = b.block, b.hop, b.passes, b.kept, b.lo
        F = hops * P
        frames = frame_signal(hist[..., : (F - 1) * H + B], B, H, F)  # [S, 2, F, B]
        spec = torch.fft.rfft(frames * b.analysis_window.to(dt))[..., lo : lo + K]
        sl, sr = spec[:, 0], spec[:, 1]
        c_re, c_im, l_re, l_im, r_re, r_im = mask_sum(
            sl.real, sl.imag, sr.real, sr.imag, b.gains.to(dt)
        )
        full = spec.new_zeros((S, 3, F, B // 2 + 1))
        full[..., lo : lo + K] = torch.complex(
            torch.stack([c_re, l_re, r_re], dim=1), torch.stack([c_im, l_im, r_im], dim=1)
        )
        rec = torch.fft.irfft(full, n=B) * b.synthesis_window.to(dt)  # [S, 3, F, B]
        carry = carry.to(dt)
        for i in range(hops):
            acc = overlap_add(rec[:, :, i * P : (i + 1) * P], H)  # [S, 3, (P - 1) * H + B]
            acc[..., :B] += carry
            out[..., i * hw : (i + 1) * hw] += torch.where(ready[:, i], acc[..., :hw], 0.0)
            carry = torch.where(ready[:, i], tnf.pad(acc[..., hw:], (0, H)), carry)
        new.append(carry)
    return out, tuple(new)
