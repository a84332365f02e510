"""Offline (whole-file) multiband upmix on PyTorch — the main path.

Port of `upmix_tpu/models/offline.py`.  A long input is cut into chunks
of CHUNK_SAMPLES fresh samples; each segment reads its chunk plus a
right halo of max(B - H) samples, every bucket of the config runs in one
omnibus call (ops/omnibus.py), and each segment's overlap-add spill is
added into the next segment's head.  The chunk rules are the JAX
package's (chunk clamped to the input and rounded up to the LCM of the
block sizes), so both packages cut an input at the same places.

Two things differ from the JAX chunked path:
  - Segments are independent, so one kernel call takes all of them as
    batch rows, and the spill carry is one vectorised add afterwards
    (the JAX path scans the segments in order).
  - Every length goes through the kernel path.  The JAX package sends
    inputs under 2^18 samples to a whole-file program because that was
    faster on its TPU; that threshold does not carry over.

`build_offline_fn(..., chunk=0)` runs the whole-file program instead:
`_bucket_lcr` on torch.fft, in the inputs' dtype, so float64 inputs give
the reference the kernel path is checked against.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as tnf

from upmix_tpu_torch.config import UpmixConfig, bucket_bands, require_builtin_windows
from upmix_tpu_torch.ops.framing import frame_signal, offline_frame_plan, overlap_add
from upmix_tpu_torch.ops.gains import band_gain_curve
from upmix_tpu_torch.ops.mask import center_mask
from upmix_tpu_torch.ops.omnibus import (
    check_geometry,
    make_bucket,
    make_omnibus_plan,
    omnibus_lcr_batch,
)
from upmix_tpu_torch.ops.windows import design_wola_synthesis_window, make_window

CHUNK_SAMPLES = 2**21


@dataclass(frozen=True)
class _BucketPlan:
    block_size: int
    hop_size: int
    num_frames: int
    total_padded: int
    analysis_window: np.ndarray  # [block]
    synthesis_window: np.ndarray  # [block]
    gains: np.ndarray  # [n_bands_in_bucket, n_bins]


def _plan_buckets(config: UpmixConfig, n_samples: int):
    require_builtin_windows(config)
    plans = []
    for block_size, bands in bucket_bands(config.bands).items():
        hop = bands[0].hop_size
        num_frames, total_padded = offline_frame_plan(n_samples, block_size, hop)
        aw = make_window(config.window, block_size)
        if config.synthesis == "wola":
            sw = design_wola_synthesis_window(aw, config.overlap)
        elif config.synthesis == "analysis":
            sw = aw
        else:
            raise ValueError(f"unknown synthesis mode {config.synthesis!r}")
        gains = np.stack([band_gain_curve(b, dtype=np.float32) for b in bands])
        plans.append(
            _BucketPlan(
                block_size=block_size,
                hop_size=hop,
                num_frames=num_frames,
                total_padded=total_padded,
                analysis_window=aw,
                synthesis_window=sw,
                gains=gains,
            )
        )
    return plans


def _bucket_lcr(plan, L: torch.Tensor, R: torch.Tensor, n_samples: int):
    """One bucket's (C, Ls, Rs) over the whole signal via torch.fft, in the
    dtype of L and R.  Returns [3, n_samples]."""
    dev, dt = L.device, L.dtype
    x = tnf.pad(torch.stack([L, R]), (0, plan.total_padded - n_samples))
    frames = frame_signal(x, plan.block_size, plan.hop_size, plan.num_frames)
    aw = torch.as_tensor(plan.analysis_window, device=dev).to(dt)
    spec = torch.fft.rfft(frames * aw)  # [2, F, n_bins]
    gains = torch.as_tensor(plan.gains, device=dev).to(dt)[:, None, :]
    spec_c, spec_ls, spec_rs = center_mask(spec[0][None] * gains, spec[1][None] * gains)
    summed = torch.stack([spec_c.sum(0), spec_ls.sum(0), spec_rs.sum(0)])
    sw = torch.as_tensor(plan.synthesis_window, device=dev).to(dt)
    rec = torch.fft.irfft(summed, n=plan.block_size) * sw  # [3, F, block]
    return overlap_add(rec, plan.hop_size)[:, :n_samples]


def _chain_block_lcm(plans) -> int:
    # Per-chunk frame counts must divide evenly for every bucket: the chunk
    # is a multiple of every block size.
    unit = 1
    for p in plans:
        unit = unit * p.block_size // math.gcd(unit, p.block_size)
    return unit


def plans_from_numpy(bucket_plans, device) -> tuple:
    """The device plan of the kernel path: one OmnibusBucket per live
    bucket, from `_BucketPlan` records of either package (numpy arrays).
    Build it once per config and reuse it: at 44.1 kHz the weights of the
    default config take about 300 MB on a CUDA device."""
    live = (make_bucket(p, device) for p in bucket_plans)
    return tuple(b for b in live if b is not None)


def build_offline_chunked_fn(
    config: UpmixConfig,
    n_samples: int,
    chunk: int = CHUNK_SAMPLES,
    device="cuda",
    buckets: tuple | None = None,
):
    """fn(L, R) -> (C, Ls, Rs), each [n_samples] float32 on `device`, for
    tensors L, R of n_samples on `device`.  `buckets` is the device plan
    (`plans_from_numpy`); built here when not given."""
    for b in config.bands:
        check_geometry(b.block_size, b.hop_size)
    plans = _plan_buckets(config, chunk)  # geometry is per chunk
    unit = _chain_block_lcm(plans)
    # Clamp to the input length (unit-rounded) so short inputs do not pad
    # up to the full default chunk, then round up to the unit.
    chunk = min(chunk, max(-(-n_samples // unit) * unit, unit))
    if chunk % unit:
        chunk = -(-chunk // unit) * unit
    halo = max(p.block_size - p.hop_size for p in plans)
    if chunk < halo:
        raise ValueError(f"chunk {chunk} smaller than halo {halo}")
    n_seg = -(-n_samples // chunk)
    n_pad = n_seg * chunk
    device = torch.device(device)
    if buckets is None:
        buckets = plans_from_numpy(plans, device)
    oplan = make_omnibus_plan(buckets, chunk)

    def fn(L: torch.Tensor, R: torch.Tensor):
        if oplan is None:  # every bucket's gains are zero
            z = torch.zeros(n_samples, dtype=torch.float32, device=device)
            return z, z.clone(), z.clone()
        width = chunk + oplan.halo
        x = torch.zeros((2, n_pad + oplan.halo), dtype=torch.float32, device=device)
        x[0, :n_samples] = L
        x[1, :n_samples] = R
        segs = x.unfold(1, width, chunk).transpose(0, 1).contiguous()  # [n_seg, 2, width]
        main, spill = omnibus_lcr_batch(segs, oplan)
        # Spill carry: segment i's tail lands on segment i + 1's head
        # (chunk >= halo, so it reaches no further).
        main[1:, :, : oplan.halo] += spill[:-1]
        full = main.transpose(0, 1).reshape(3, n_pad)
        return full[0, :n_samples], full[1, :n_samples], full[2, :n_samples]

    return fn


def build_offline_fn(
    config: UpmixConfig,
    n_samples: int,
    chunk: int | None = None,
    device="cuda",
    buckets: tuple | None = None,
):
    """fn(L, R) -> (C, Ls, Rs) for a fixed input length.  The kernel path
    (chunked, CHUNK_SAMPLES unless `chunk` says otherwise) by default;
    chunk=0 runs the whole-file torch.fft program, in the inputs' dtype."""
    if chunk == 0:
        plans = _plan_buckets(config, n_samples)

        def fn(L: torch.Tensor, R: torch.Tensor):
            acc = None
            for plan in plans:
                contrib = _bucket_lcr(plan, L, R, n_samples)
                acc = contrib if acc is None else acc + contrib
            return acc[0], acc[1], acc[2]

        return fn
    return build_offline_chunked_fn(
        config, n_samples, chunk=chunk or CHUNK_SAMPLES, device=device, buckets=buckets
    )


class Upmixer:
    """Config-specialized offline upmixer on one device.

    The device plan (window, gain and weight tensors) is built at first use
    and shared by every input length; the per-length programs sit in an
    LRU capped at `max_programs`.  `pad_granularity` rounds lengths up to
    bound the number of programs.
    """

    def __init__(
        self,
        config: UpmixConfig,
        device="cuda",
        pad_granularity: int = 1,
        max_programs: int = 16,
        chunk: int | None = None,
    ):
        require_builtin_windows(config)
        self.config = config
        self.device = torch.device(device)
        self.pad_granularity = max(1, int(pad_granularity))
        self.max_programs = max(1, int(max_programs))
        self.chunk = chunk  # None = CHUNK_SAMPLES, 0 = whole-file torch.fft program
        self._buckets = None
        self._cache = OrderedDict()
        if self.device.type == "cuda":
            # FP32 products stay FP32: TF32 keeps about three decimal digits.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def _program(self, n_padded: int):
        fn = self._cache.get(n_padded)
        if fn is not None:
            self._cache.move_to_end(n_padded)
            return fn
        if self.chunk != 0 and self._buckets is None:
            self._buckets = plans_from_numpy(_plan_buckets(self.config, 1), self.device)
        fn = build_offline_fn(
            self.config, n_padded, chunk=self.chunk, device=self.device, buckets=self._buckets
        )
        self._cache[n_padded] = fn
        while len(self._cache) > self.max_programs:
            self._cache.popitem(last=False)
        return fn

    def process(self, L, R):
        """Stereo in (numpy arrays or tensors) -> (C, Ls, Rs), each a
        float32 tensor of len(L) on the upmixer's device."""
        n = len(L)
        if n < 1:
            raise ValueError("input must contain at least one sample")
        if len(R) != n:
            raise ValueError(f"channel length mismatch: {n} vs {len(R)}")
        g = self.pad_granularity
        n_padded = -(-n // g) * g
        L = torch.as_tensor(L, dtype=torch.float32, device=self.device)
        R = torch.as_tensor(R, dtype=torch.float32, device=self.device)
        if n_padded != n:
            L = tnf.pad(L, (0, n_padded - n))
            R = tnf.pad(R, (0, n_padded - n))
        c, ls, rs = self._program(n_padded)(L, R)
        return c[:n], ls[:n], rs[:n]

    def process_np(self, L, R):
        return tuple(t.cpu().numpy() for t in self.process(L, R))


def upmix_offline(L, R, config: UpmixConfig, device="cuda"):
    """One-shot convenience wrapper (numpy in and out)."""
    return Upmixer(config, device=device).process_np(np.asarray(L), np.asarray(R))
