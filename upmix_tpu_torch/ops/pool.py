"""The serving-pool step: one hardware block, or `hops` blocks, for every
stream at once.

Port of `upmix_tpu/ops/pallas_pool.py` (pool_step_lcr, the TPU kernel of
the serving pool), in both of its OLA dataflows (`PoolPlan.ola`).  The
time OLA ("time", the kernel body at pallas_pool.py:432-558): per
stream s, bucket (block B, hop H, P = hw/H frames per block, kept bins
lo..lo+K-1) and hop i:

  - frame p of hop i reads hist[s, ch, i*hw + p*H : i*hw + p*H + B];
  - windowed kept-bin spectrum -> per band gain x center mask, summed
    over the bucket's bands -> inverse with the synthesis window;
  - the P inverse frames overlap-add at p*H onto the bucket's carry
    (added at [0, B)); the first hw samples are emitted, summed over
    buckets; the new carry is the tail [hw, hw + B - H) and H zeros;
  - a hop with t[s] + i < warmup (warmup = block/hop) emits exact zeros
    and leaves that stream's carries as they were;
  - carries chain across the hops of one call.

The spectral OLA ("spectral", `_spectral_bucket`, pallas_pool.py:249-325)
computes the same function by another dataflow.  A bucket's state is the
masked spectra (C, Ls, Rs at the kept bins, unnormalised rfft values) of
its last Kr - 1 frames, Kr = B/H, oldest first: [S, 3, Kr - 1, K, 2]
float32 (re, im) here.  Per hop the Kr - 1 carried spectra go ahead of
the P new ones; output hop p is the sum over the Kr frames that overlap
it of each frame's inverse (irfft of its kept bins, times the synthesis
window) at its offset into the hop; the new carry is the last Kr - 1
spectra of that window.  The warmup gate and the chaining across hops
are the time OLA's.  `pack_spectral_carry` and `unpack_spectral_carry`
convert the state to and from the JAX package's packed layout ([S, 3 *
(Kr - 1) * kp], output-major, then slot-major, re | im | zeros to kp =
2K rounded up to 128 lanes), so snapshots move between the packages.
Kr = 1 (hop = block) gives an empty carry.

On a CUDA tensor `pool_step_lcr` launches `csrc/pool.cu`'s kernels: the
frames through FFTs in shared memory (`csrc/fft.cuh`), the mask, the
gated overlap-add and the carries, one launch per bucket, two for a
bucket over `fftplan.FFT_MAX` points (the two-stage split; from a
hardware block of 8192 samples at the streaming configs' 4 x hw cap;
`launches_per_bucket`).  On a CPU tensor it runs `pool_step_lcr_plain`
(torch.fft).  A spectral plan on a CUDA tensor launches
`csrc/pool_spectral.cu`'s kernels (K3s): the new frames' forward FFTs and
mask into [S, 3, F, K] spectra and the new carry, then per stream the
inverse FFTs of every frame that reaches the output, carried or new, in
frame order (`spectral_launches_per_bucket`: 2, or 3 for a bucket over
FFT_MAX points, whose forward is the split's).  On a CPU tensor it runs
`pool_step_spectral_plain`.  There is no fallback between the kernels and
the plain versions, nor between the two dataflows.

What the TPU plan needed only for Mosaic has no counterpart: no group of
streams per grid step (so no n_streams % group rule), no 8 MB bound on
the baked weights, no bf16 hi/lo pairs, no quarter refs; for the
spectral OLA no lane padding of the spectra, no Q hops a product and no
rearranged inverse weight.  The plan declines only what the function
cannot do: a hop that does not divide hw or its block, or mixed
block/hop ratios.
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
from upmix_tpu_torch.ops.omnibus import (
    FRAME_TILE,
    WideTables,
    check_kernel_tables,
    launch_geometry,
    make_wide_tables,
)

# CUDA kernel launches made by pool_step_lcr: LAUNCHES by a time plan
# (K3, launches_per_bucket each), SPECTRAL_LAUNCHES by a spectral plan
# (K3s, spectral_launches_per_bucket each).
LAUNCHES = 0
SPECTRAL_LAUNCHES = 0

OLA_MODES = ("time", "spectral")
SPECTRAL_LANES = 128  # the JAX package's packed spectra: 2K rounded up to this


def spectral_launches_per_bucket(block: int) -> int:
    """Launches of one spectral bucket: the forward and mask, then the
    inverse; a block over FFT_MAX points takes the split's forward, a mask
    pass and the split's inverse."""
    return 2 if block <= FFT_MAX else 3


def spectral_pass(block: int) -> int:
    """Frames one thread block of the spectral kernels transforms at a
    time (FRAME_TILE complex values, at least one frame)."""
    return max(1, FRAME_TILE // block)


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

    @property
    def overlap(self) -> int:
        """Kr = B / H: the frames that overlap one hop."""
        return self.block // self.hop

    def spectral_carry_shape(self, rows: int) -> tuple:
        """A spectral carry: the masked spectra of the last Kr - 1 frames."""
        return (rows, 3, self.overlap - 1, self.kept, 2)


@dataclass(frozen=True, eq=False)
class PoolPlan:
    hw: int
    warmup: int  # K = block / hop, the same for every bucket
    n_streams: int
    buckets: tuple  # PoolBucket, live buckets in config order
    ola: str = "time"  # the OLA dataflow: "time" or "spectral"

    @property
    def window(self) -> int:
        """Shared history length: warmup * hw."""
        return self.warmup * self.hw


def check_ola(ola: str) -> None:
    """Raise ValueError unless `ola` is one of the pool's OLA dataflows."""
    if ola not in OLA_MODES:
        raise ValueError(f"unknown ola mode {ola!r}; one of {OLA_MODES}")


def plan_from_stream_buckets(records, hw: int, warmup: int, n_streams: int, device,
                             ola: str = "time") -> PoolPlan | None:
    """Device plan from `_StreamBucketPlan` records (numpy arrays) of
    either package; None when every bucket's gains are zero.  The
    two-stage split's tables of a block over FFT_MAX are built for a CUDA
    device only."""
    check_ola(ola)
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
    return PoolPlan(hw=int(hw), warmup=int(warmup), n_streams=int(n_streams), buckets=tuple(buckets), ola=ola)


def make_pool_plan(config: UpmixConfig, hw: int, n_streams: int, device="cuda", ola: str = "time") -> PoolPlan | None:
    """The pool plan, or None for a config the step cannot run: a hop
    that does not divide hw or its block, mixed block/hop ratios, or no
    live bucket.  (With hop | hw every block fits the K * hw history:
    hw + (K - 1) * hop <= K * hw.)  Both OLA dataflows take the same
    configs."""
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
    return plan_from_stream_buckets(_plan_stream_buckets(config, hw), hw, ratios.pop(), n_streams, device, ola)


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
        want = b.spectral_carry_shape(S) if plan.ola == "spectral" else (S, 3, b.block)
        if tuple(c.shape) != want:
            raise ValueError(f"expected {plan.ola} carry {list(want)}, got {tuple(c.shape)}")


def pool_step_lcr(hist: torch.Tensor, t: torch.Tensor, carries, plan: PoolPlan, hops: int = 1):
    """hist [S, 2, (warmup - 1 + hops) * hw] float32, oldest -> newest
    (the last `hops` blocks are this call's input); t int32 [S], blocks
    seen including the first hop; carries: per bucket [S, 3, B] for a
    time plan, [S, 3, Kr - 1, K, 2] for a spectral one.  Returns (out [S,
    3, hops * hw] = (C, Ls, Rs), new carries).  A CPU tensor runs the
    plain version of the plan's dataflow; a CUDA tensor runs its kernels."""
    spectral = plan.ola == "spectral"
    if hist.device.type == "cpu":
        return (pool_step_spectral_plain if spectral else pool_step_lcr_plain)(hist, t, carries, plan, hops)
    if hist.device.type != "cuda":
        raise ValueError(f"pool_step_lcr runs on cpu or cuda, not {hist.device}")
    return (_spectral_cuda if spectral else _pool_cuda)(hist, t, carries, plan, int(hops))


def _launched(rc: int, what: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _launched_spectral(rc: int, what: str) -> None:
    global SPECTRAL_LAUNCHES
    SPECTRAL_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _check_cuda_inputs(hist, carries, plan: PoolPlan) -> None:
    dev = hist.device
    if hist.dtype != torch.float32 or not hist.is_contiguous():
        raise ValueError("the pool kernel takes a contiguous float32 history")
    if any(c.dtype != torch.float32 or not c.is_contiguous() or c.device != dev for c in carries):
        raise ValueError("the pool kernel takes contiguous float32 carries on the history's device")
    for b in plan.buckets:
        check_kernel_tables(b, dev)


def _pool_cuda(hist, t, carries, plan: PoolPlan, hops: int):
    from upmix_tpu_torch.ops import _build

    _check_inputs(hist, t, carries, plan, hops)
    _check_cuda_inputs(hist, carries, plan)
    dev = hist.device
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


def _spectral_cuda(hist, t, carries, plan: PoolPlan, hops: int):
    from upmix_tpu_torch.ops import _build

    _check_inputs(hist, t, carries, plan, hops)
    _check_cuda_inputs(hist, carries, plan)
    dev = hist.device
    lib = _build.load()
    S, _, width = hist.shape
    hw, nq = plan.hw, plan.warmup
    t32 = t.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((S, 3, hops * hw), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    new = []
    for i, (b, carry) in enumerate(zip(plan.buckets, carries)):
        B, H, K, nb, w = b.block, b.hop, b.kept, b.gains.shape[0], b.wide
        F = hops * b.passes
        spec = torch.empty((S, 3, F, K, 2), dtype=torch.float32, device=dev)
        carry_out = torch.empty_like(carry)
        state = (carry.data_ptr(), spec.data_ptr(), carry_out.data_ptr())
        if w is None:
            G = spectral_pass(B)
            _launched_spectral(
                lib.pool_spectral_forward(
                    hist.data_ptr(), t32.data_ptr(), *state, b.analysis_window.data_ptr(), b.gains.data_ptr(),
                    b.twiddles.data_ptr(), S, B, H, K, b.lo, nb, hw, hops, nq, G, width, stream,
                ),
                "pool_spectral_forward",
            )
            _launched_spectral(
                lib.pool_spectral_inverse(
                    carry.data_ptr(), spec.data_ptr(), t32.data_ptr(), out.data_ptr(), b.synthesis_window.data_ptr(),
                    b.twiddles.data_ptr(), S, B, H, K, b.lo, hw, hops, nq, G, int(i > 0), stream,
                ),
                "pool_spectral_inverse",
            )
        else:
            part = torch.empty((S, F, w.groups, 2 * K, 2), dtype=torch.float32, device=dev)
            _launched_spectral(
                lib.pool_wide_forward(
                    hist.data_ptr(), t32.data_ptr(), part.data_ptr(), b.analysis_window.data_ptr(),
                    b.twiddles.data_ptr(), w.stage2.data_ptr(), S, B, H, K, b.lo, w.n1, w.cols, hw, hops, nq,
                    width, stream,
                ),
                "pool_wide_forward",
            )
            _launched_spectral(
                lib.pool_spectral_mask(
                    part.data_ptr(), t32.data_ptr(), *state, b.gains.data_ptr(), S, B, H, K, b.lo, nb, w.groups,
                    hw, hops, nq, stream,
                ),
                "pool_spectral_mask",
            )
            _launched_spectral(
                lib.pool_spectral_wide_inverse(
                    carry.data_ptr(), spec.data_ptr(), t32.data_ptr(), out.data_ptr(),
                    b.synthesis_window.data_ptr(), b.twiddles.data_ptr(), w.stage2.data_ptr(), w.rows.data_ptr(),
                    w.row_ptr.data_ptr(), w.entries.data_ptr(), w.tile_ptr.data_ptr(), w.tiles, w.kt, S, B, H, K,
                    b.lo, w.n1, w.cols, hw, hops, nq, int(i > 0), stream,
                ),
                "pool_spectral_wide_inverse",
            )
        new.append(carry_out)
    return out, tuple(new)


def pool_step_spectral_plain(hist: torch.Tensor, t: torch.Tensor, carries, plan: PoolPlan, hops: int = 1):
    """The plain PyTorch version of the spectral dataflow, same contract
    as `pool_step_lcr` with spectral carries: per bucket frame, window,
    torch.fft.rfft, gain x mask x band sum on the kept bins; then hop by
    hop the window of Kr - 1 carried and P new spectra, irfft of each
    (zero outside the kept bins), synthesis window, overlap-add, the hop's
    hw samples, and the new carry, with the warmup gate.  Computes in
    hist's dtype (float64 gives a reference for the float32 kernels) on
    hist's device."""
    hops = int(hops)
    _check_inputs(hist, t, carries, plan, hops)
    S = hist.shape[0]
    hw, dt = plan.hw, hist.dtype
    out = hist.new_zeros((S, 3, hops * hw))
    steps = torch.arange(hops, device=hist.device)
    ready = (t.to(hist.device)[:, None] + steps[None, :] >= plan.warmup)[:, :, None, None, None]
    new = []
    for b, carry in zip(plan.buckets, carries):
        B, H, P, K, lo, Kr = b.block, b.hop, b.passes, b.kept, b.lo, b.overlap
        F = hops * P
        frames = frame_signal(hist[..., : (F - 1) * H + B], B, H, F)  # [S, 2, F, B]
        spec = torch.fft.rfft(frames * b.analysis_window.to(dt))[..., lo : lo + K]
        sl, sr = spec[:, 0], spec[:, 1]
        c_re, c_im, l_re, l_im, r_re, r_im = mask_sum(
            sl.real, sl.imag, sr.real, sr.imag, b.gains.to(dt)
        )
        masked = torch.complex(
            torch.stack([c_re, l_re, r_re], dim=1), torch.stack([c_im, l_im, r_im], dim=1)
        )  # [S, 3, F, K]
        cur = torch.view_as_complex(carry.to(dt).contiguous())  # [S, 3, Kr - 1, K]
        for i in range(hops):
            win = torch.cat([cur, masked[:, :, i * P : (i + 1) * P]], dim=2)  # [S, 3, Kr - 1 + P, K]
            full = win.new_zeros((S, 3, Kr - 1 + P, B // 2 + 1))
            full[..., lo : lo + K] = win
            rec = torch.fft.irfft(full, n=B) * b.synthesis_window.to(dt)
            acc = overlap_add(rec, H)  # from frame i * P - (Kr - 1)
            emit = acc[..., (Kr - 1) * H : (Kr - 1) * H + hw]
            out[..., i * hw : (i + 1) * hw] += torch.where(ready[:, i, :, 0], emit, 0.0)
            cur = torch.where(ready[:, i], win[:, :, P:], cur)
        new.append(torch.view_as_real(cur).contiguous())
    return out, tuple(new)


def spectral_lanes(kept: int) -> int:
    """kp: one packed spectrum's lanes in the JAX package's layout."""
    return -(-2 * kept // SPECTRAL_LANES) * SPECTRAL_LANES


def pack_spectral_carry(carry) -> np.ndarray:
    """A spectral carry [S, 3, Kr - 1, K, 2] -> the JAX package's packed
    [S, 3 * (Kr - 1) * kp] float32 (pallas_pool.py:307-318)."""
    c = np.asarray(carry, np.float32)
    S, _, slots, K, _ = c.shape
    packed = np.zeros((S, 3, slots, spectral_lanes(K)), np.float32)
    packed[..., :K] = c[..., 0]
    packed[..., K : 2 * K] = c[..., 1]
    return packed.reshape(S, 3 * slots * spectral_lanes(K))


def unpack_spectral_carry(packed, slots: int, kept: int) -> np.ndarray:
    """The JAX package's packed [S, 3 * slots * kp] -> [S, 3, slots, K, 2]
    float32 (its lane padding dropped)."""
    a = np.asarray(packed, np.float32)
    kp = spectral_lanes(kept)
    if a.ndim != 2 or a.shape[1] != 3 * slots * kp:
        raise ValueError(f"packed spectral carry has shape {a.shape}, expected [S, {3 * slots * kp}]")
    a = a.reshape(a.shape[0], 3, slots, kp)
    return np.ascontiguousarray(np.stack([a[..., :kept], a[..., kept : 2 * kept]], axis=-1))
