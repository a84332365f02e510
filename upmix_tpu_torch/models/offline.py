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
    (the JAX path scans the segments in order).  The same holds across
    signals: `build_offline_rows_fn` takes [batch, 2, n] and puts every
    row's segments into that one call (models/batch.py, the data-only
    sharded path).
  - Every length of a config on the kernel path goes through it.  The
    JAX package sends inputs under 2^18 samples to a whole-file program
    because that was faster on its TPU; that threshold does not carry
    over.

`build_offline_fn(..., chunk=0)` runs the whole-file program instead:
`_bucket_lcr` on torch.fft, in the inputs' dtype, so float64 inputs give
the reference the kernel path is checked against.

Geometry decides the route, as in the JAX package's `build_offline_fn`
(`upmix_tpu/models/offline.py:487-493`): a config with any band whose
hop does not divide its block (overlap 0.65, say) or whose block is not
a power of two runs the whole-file program whatever `chunk` says, on any
device (`kernel_config`).  No kernel computes these buckets in either
package: the JAX package runs them on XLA (gather framing and a
matmul DFT), the port on torch.fft.  The route is fixed when a program
is built, never by a caught error.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as tnf

from upmix_tpu_torch.config import UpmixConfig, bucket_bands
from upmix_tpu_torch.ops.framing import frame_signal, offline_frame_plan, overlap_add
from upmix_tpu_torch.ops.gains import band_gain_curve
from upmix_tpu_torch.ops.mask import center_mask
from upmix_tpu_torch.ops.omnibus import (
    kernel_geometry,
    make_bucket,
    make_omnibus_plan,
    omnibus_lcr_batch,
)
from upmix_tpu_torch.ops.windows import design_wola_synthesis_window, make_window
from upmix_tpu_torch.utils.tracing import root, span

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


def kernel_config(config: UpmixConfig) -> bool:
    """Whether the config runs on the kernel path: every band's geometry
    is one the kernels take (`ops/omnibus.py::kernel_geometry`)."""
    return all(kernel_geometry(b.block_size, b.hop_size) for b in config.bands)


def _spectral_lcr(plan, frames: torch.Tensor) -> torch.Tensor:
    """frames [..., 2, F, B] (L, R) -> [..., 3, F, B] (C, Ls, Rs): analysis
    window, rfft, gain x center mask summed over the bucket's bands,
    irfft, synthesis window; torch.fft in the frames' dtype.  `plan` is a
    bucket plan of numpy arrays (`_BucketPlan`, `sharded._SeqBucketPlan`)."""
    dev, dt = frames.device, frames.dtype
    aw = torch.as_tensor(plan.analysis_window, device=dev).to(dt)
    spec = torch.fft.rfft(frames * aw)  # [..., 2, F, n_bins]
    gains = torch.as_tensor(plan.gains, device=dev).to(dt)[:, None, :]  # [bands, 1, n_bins]
    spec_c, spec_ls, spec_rs = center_mask(spec[..., 0, None, :, :] * gains, spec[..., 1, None, :, :] * gains)
    summed = torch.stack([spec_c.sum(-3), spec_ls.sum(-3), spec_rs.sum(-3)], dim=-3)
    sw = torch.as_tensor(plan.synthesis_window, device=dev).to(dt)
    return torch.fft.irfft(summed, n=plan.block_size) * sw


def _bucket_lcr(plan, x: torch.Tensor, n_samples: int) -> torch.Tensor:
    """One bucket's (C, Ls, Rs) over whole signals via torch.fft, in x's
    dtype: x [..., 2, n_samples] -> [..., 3, n_samples].  Any hop: framing
    is a strided view, the overlap-add shifted adds of whole hops
    (ops/framing.py)."""
    x = tnf.pad(x, (0, plan.total_padded - n_samples))
    frames = frame_signal(x, plan.block_size, plan.hop_size, plan.num_frames)
    return overlap_add(_spectral_lcr(plan, frames), plan.hop_size)[..., :n_samples]


def _whole_file_rows(plans, x: torch.Tensor, n_samples: int) -> torch.Tensor:
    """The whole-file program: x [..., 2, n_samples] -> [..., 3, n_samples],
    every bucket's `_bucket_lcr` summed in plan order."""
    acc = None
    for plan in plans:
        contrib = _bucket_lcr(plan, x, n_samples)
        acc = contrib if acc is None else acc + contrib
    return acc


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
    Build it once per config and reuse it: windows, gains and FFT twiddles,
    about 1.4 MB for the default config at 44.1 kHz.  The two-stage
    split's tables are built for a CUDA device only (`make_bucket`),
    with `device` current (`ops/_build.py::on_device`)."""
    from upmix_tpu_torch.ops._build import on_device

    with on_device(device):
        live = [make_bucket(p, device) for p in bucket_plans]
    return tuple(b for b in live if b is not None)


def build_offline_rows_fn(
    config: UpmixConfig,
    n_samples: int,
    chunk: int = CHUNK_SAMPLES,
    device="cuda",
    buckets: tuple | None = None,
):
    """fn(x) -> y: x [batch, 2, n_samples] on `device` -> y [batch, 3,
    n_samples] float32, each row an independent signal.  Every row's
    segments are rows of one omnibus call, and the spill carry is one
    vectorised add.  `buckets` is the device plan (`plans_from_numpy`);
    built here when not given.  A config off the kernel path
    (`kernel_config`) runs the whole-file program on every row at once."""
    if not kernel_config(config):
        whole = _plan_buckets(config, n_samples)
        return lambda x: _whole_file_rows(whole, x.float(), n_samples)
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

    def fn(x: torch.Tensor) -> torch.Tensor:
        batch = x.shape[0]
        if oplan is None:  # every bucket's gains are zero
            return torch.zeros((batch, 3, n_samples), dtype=torch.float32, device=device)
        width = chunk + oplan.halo
        with span("offline.segment"):
            xp = torch.zeros((batch, 2, n_pad + oplan.halo), dtype=torch.float32, device=device)
            xp[..., :n_samples] = x
            segs = xp.unfold(-1, width, chunk).transpose(1, 2).reshape(batch * n_seg, 2, width).contiguous()
        with span("offline.kernels"):
            main, spill = omnibus_lcr_batch(segs, oplan)
        with span("offline.spill"):
            main = main.unflatten(0, (batch, n_seg))
            # Spill carry: segment i's tail lands on segment i + 1's head
            # (chunk >= halo, so it reaches no further).
            main[:, 1:, :, : oplan.halo] += spill.unflatten(0, (batch, n_seg))[:, :-1]
            return main.transpose(1, 2).reshape(batch, 3, n_pad)[..., :n_samples]

    return fn


def build_offline_chunked_fn(
    config: UpmixConfig,
    n_samples: int,
    chunk: int = CHUNK_SAMPLES,
    device="cuda",
    buckets: tuple | None = None,
):
    """fn(L, R) -> (C, Ls, Rs), each [n_samples] float32 on `device`, for
    tensors L, R of n_samples on `device`: `build_offline_rows_fn` on one
    row."""
    rows = build_offline_rows_fn(config, n_samples, chunk=chunk, device=device, buckets=buckets)

    def fn(L: torch.Tensor, R: torch.Tensor):
        y = rows(torch.stack([L.float(), R.float()])[None])[0]
        return y[0], y[1], y[2]

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
    chunk=0, or a config off the kernel path (`kernel_config`), runs the
    whole-file torch.fft program, in the inputs' dtype."""
    if chunk == 0 or not kernel_config(config):
        plans = _plan_buckets(config, n_samples)

        def fn(L: torch.Tensor, R: torch.Tensor):
            with span("offline.kernels"):
                y = _whole_file_rows(plans, torch.stack([L, R]), n_samples)
            return y[0], y[1], y[2]

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
        self.config = config
        self.device = torch.device(device)
        self.pad_granularity = max(1, int(pad_granularity))
        self.max_programs = max(1, int(max_programs))
        self.chunk = chunk  # None = CHUNK_SAMPLES, 0 = whole-file torch.fft program
        self.kernel_path = chunk != 0 and kernel_config(config)  # else the whole-file program
        self._buckets = None
        self._cache = OrderedDict()
        if self.device.type == "cuda":
            # FP32 products stay FP32: TF32 keeps about three decimal digits.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def _program(self, n_padded: int):
        with span("offline.program") as s:
            fn = self._cache.get(n_padded)
            if fn is not None:
                self._cache.move_to_end(n_padded)
                s.set(built=False, evicted=0)
                return fn
            if self.kernel_path and self._buckets is None:
                self._buckets = plans_from_numpy(_plan_buckets(self.config, 1), self.device)
            fn = build_offline_fn(
                self.config, n_padded, chunk=self.chunk, device=self.device, buckets=self._buckets
            )
            self._cache[n_padded] = fn
            evicted = 0
            while len(self._cache) > self.max_programs:
                self._cache.popitem(last=False)
                evicted += 1
            s.set(built=True, evicted=evicted)
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
        with root("offline.process", samples=n):
            with span("offline.stage_in"):
                L = torch.as_tensor(L, dtype=torch.float32, device=self.device)
                R = torch.as_tensor(R, dtype=torch.float32, device=self.device)
                if n_padded != n:
                    L = tnf.pad(L, (0, n_padded - n))
                    R = tnf.pad(R, (0, n_padded - n))
            c, ls, rs = self._program(n_padded)(L, R)
            return c[:n], ls[:n], rs[:n]

    def process_np(self, L, R):
        stems = self.process(L, R)
        with root("offline.to_host", samples=len(L)):
            return tuple(t.cpu().numpy() for t in stems)


def upmix_offline(L, R, config: UpmixConfig, device="cuda"):
    """One-shot convenience wrapper (numpy in and out)."""
    return Upmixer(config, device=device).process_np(np.asarray(L), np.asarray(R))
