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
`csrc/omnibus.cu` (FP32 FFTs in shared memory, `csrc/fft.cuh`): one
launch per bucket up to `fftplan.FFT_MAX` points, two for a wider one
(the two-stage split; `launches_per_bucket`), at the geometry
`launch_geometry` gives.  On a CPU tensor it runs
`omnibus_lcr_batch_plain` (torch.fft).  There is no fallback between
the two.

What the TPU plan needed only for Mosaic has no counterpart here: no
tile LCM or minimum tile, no lookahead views, no bf16 hi/lo weight
pairs.  The plan is the list of live buckets with their windows, gains
and FFT tables (`ops/fftplan.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from upmix_tpu_torch.ops import _build
from upmix_tpu_torch.ops.fftplan import FFT_MAX, launches_per_bucket, pass_twiddles, twiddles, wide_split
from upmix_tpu_torch.ops.framing import frame_signal, overlap_add
from upmix_tpu_torch.ops.mask import mask_sum

FRAME_TILE = 8192  # complex values of the frames one thread block transforms at a time
SMEM_TARGET = 75 * 1024  # shared memory per block for G > 1: three blocks share an SM (228 KB, 1 KB a block reserved)
_THREADS = 512  # csrc/fft.cuh: FFT_THREADS
_SMEM = 227 * 1024  # shared memory one block can use on sm_90
_SM_THREADS = 2048


@dataclass(frozen=True, eq=False)
class WideTables:
    """The two-stage split of a bucket over FFT_MAX points on its device
    (`fftplan.WideSplit`)."""

    n1: int
    n2: int
    cols: int
    kt: int  # kept bins per tile of the inverse
    stage2: torch.Tensor  # [B, 2]: exp(-2 pi i m / B), the stage-2 twiddles
    rows: torch.Tensor  # int32 [R]
    row_ptr: torch.Tensor  # int32 [R + 1]
    entries: torch.Tensor  # int32
    tile_ptr: torch.Tensor  # int32 [tiles + 1]

    @property
    def groups(self) -> int:
        return self.n2 // self.cols

    @property
    def tiles(self) -> int:
        return self.tile_ptr.numel() - 1


def make_wide_tables(block: int, hop: int, lo: int, kept: int, device) -> WideTables | None:
    """The split's tables on `device` for a block over FFT_MAX, else None.
    Raises for a block the kernels cannot split: its hop must be a
    multiple of N2 (a thread block owns whole rows of N2 positions)."""
    if block <= FFT_MAX:
        return None
    w = wide_split(block, lo, kept)
    if hop % w.n2:
        raise NotImplementedError(
            f"block {block} / hop {hop}: the two-stage split of this block needs a hop divisible by N2 = {w.n2}"
        )

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return WideTables(
        n1=w.n1, n2=w.n2, cols=w.cols, kt=w.kt, stage2=dev(twiddles(block), np.float32), rows=dev(w.rows, np.int32),
        row_ptr=dev(w.row_ptr, np.int32), entries=dev(w.entries, np.int32), tile_ptr=dev(w.tile_ptr, np.int32),
    )


@dataclass(frozen=True, eq=False)
class OmnibusBucket:
    """One live bucket on its device: geometry, windows, kept-bin gains
    and the FFT kernels' tables.  A plan built for the CPU's plain
    version leaves out the tables of a block over FFT_MAX (`twiddles` and
    `wide` None): the plain version runs any block."""

    block: int
    hop: int
    lo: int  # first kept bin
    analysis_window: torch.Tensor  # [B]
    synthesis_window: torch.Tensor  # [B]
    gains: torch.Tensor  # [n_bands, K], bins lo .. lo + K - 1
    twiddles: torch.Tensor | None  # fftplan.pass_twiddles of the kernel's FFT (B, or N1 when wide)
    wide: WideTables | None  # the two-stage split, for B > FFT_MAX

    @property
    def kept(self) -> int:
        return self.gains.shape[1]

    @property
    def spill(self) -> int:
        return self.block - self.hop


def kernel_geometry(block: int, hop: int) -> bool:
    """Whether the kernels take a bucket: a power-of-two block whose hop
    divides it.  The offline entry points route every other geometry to
    torch.fft programs (`models/offline.py::build_offline_fn`,
    `parallel/sharded.py`), as the JAX package routes them past its
    Pallas kernels."""
    return not block & (block - 1) and block % hop == 0


def check_geometry(block: int, hop: int) -> None:
    """The kernel path's guard: raise unless `kernel_geometry`."""
    if not kernel_geometry(block, hop):
        raise NotImplementedError(
            f"block {block} / hop {hop}: the kernels take power-of-two "
            "blocks whose hop divides the block; the offline entry points "
            "route other geometries to torch.fft (a kernel for them is a "
            "later performance item of ROADMAP.md)"
        )


def make_bucket(p, device) -> OmnibusBucket | None:
    """Device record of one offline bucket plan, or None for a bucket whose
    gains are all zero (it contributes nothing).  `p` is a `_BucketPlan` of
    either package: block_size, hop_size, analysis_window,
    synthesis_window, gains [n_bands, n_bins] as numpy arrays.  The
    two-stage split's tables of a block over FFT_MAX are built for a CUDA
    device only."""
    B, H = p.block_size, p.hop_size
    check_geometry(B, H)
    nz = np.nonzero(p.gains.max(axis=0))[0]
    if not len(nz):
        return None
    lo, hi = int(nz[0]), int(nz[-1])
    device = torch.device(device)

    def dev(a, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    wide = make_wide_tables(B, H, lo, hi - lo + 1, device) if device.type == "cuda" else None
    n_fft = B if B <= FFT_MAX else (wide.n1 if wide is not None else 0)
    return OmnibusBucket(
        block=B,
        hop=H,
        lo=lo,
        analysis_window=dev(p.analysis_window),
        synthesis_window=dev(p.synthesis_window),
        gains=dev(p.gains[:, lo : hi + 1]),
        twiddles=dev(pass_twiddles(n_fft)) if n_fft else None,
        wide=wide,
    )


def frame_pass(block: int, kept: int) -> tuple:
    """(G, pair) of csrc/fft.cuh's frames_kernel: G frames one thread
    block transforms at a time, the largest power of two with G * B <=
    FRAME_TILE complex values whose frames and Rs spectra fit SMEM_TARGET
    (so that three blocks share an SM), else one; with one, `pair` when
    the Rs spectra of two frames fit beside it in a block's shared memory,
    so that they share one inverse transform."""
    G = max(1, FRAME_TILE // block)
    while G > 1 and _frames_smem(block, kept, G, False) > SMEM_TARGET:
        G //= 2
    return G, G == 1 and _frames_smem(block, kept, 1, True) <= _SMEM


def _frames_smem(block: int, kept: int, G: int, pair: bool) -> int:
    return 8 * (G * block + (2 if pair else G) * kept)


@dataclass(frozen=True)
class Launch:
    """How a bucket's frames are launched (csrc/fft.cuh): frames_kernel, or
    for a split bucket wide_inverse_kernel (its wide_forward_kernel runs
    one block per column group and frame)."""

    frames: int  # G: frames a pass (1 for the split)
    pair: bool  # Rs of two frames share one inverse transform
    hops: int  # T: output hops per thread block
    blocks: int  # thread blocks


def launch_geometry(b, F: int, rows: int, n_sm: int) -> Launch:
    """The launch of OmnibusBucket b over F frames of `rows` rows with F +
    B/H - 1 output hops each: T from hops_per_block on n_sm SMs."""
    B, H, K, w = b.block, b.hop, b.kept, b.wide
    Kf = B // H
    n_hops = F + Kf - 1
    if w is None:
        G, pair = frame_pass(B, K)
        smem, groups = _frames_smem(B, K, G, pair), 1
    else:
        G, pair = 1, True
        smem, groups = 8 * (w.cols * w.n1 + 6 * w.kt), w.groups
    T = hops_per_block(n_hops, Kf, G, rows * groups, n_sm, smem)
    return Launch(frames=G, pair=pair, hops=T, blocks=rows * groups * -(-n_hops // T))


def hops_per_block(n_hops: int, overlap: int, G: int, rows: int, n_sm: int, smem: int) -> int:
    """T: output hops per thread block of a bucket with `overlap` = B/H
    frames per hop, G frames per pass and `rows` independent rows
    (segments, or segments x column groups).  A block computes T +
    overlap - 1 frames, rounded up to G; T minimises the passes per SM
    over the waves of blocks the card holds."""
    per_sm = max(1, min(_SM_THREADS // _THREADS, _SMEM // smem))
    best = None
    for m in range(1, 257):
        T = m * G - (overlap - 1)
        if T < 1:
            continue
        blocks = rows * -(-n_hops // T)
        cost = -(-blocks // (n_sm * per_sm)) * m
        if best is None or cost < best[0]:
            best = (cost, T)
        if T >= n_hops:
            break
    return best[1]


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


def check_kernel_tables(b, dev) -> None:
    """Raise unless bucket b carries the FFT kernels' tables, every one of
    them on `dev`."""
    if b.twiddles is None or (b.block > FFT_MAX and b.wide is None):
        raise ValueError(f"bucket B={b.block} was planned without the kernels' tables (a CPU plan); plan it for {dev}")
    w = b.wide
    tables = (b.analysis_window, b.synthesis_window, b.gains, b.twiddles)
    if w is not None:
        tables += (w.stage2, w.rows, w.row_ptr, w.entries, w.tile_ptr)
    if any(t.device != dev for t in tables):
        raise ValueError(f"plan buckets live on {b.gains.device}, input on {dev}")


def launch_bucket(k, kernel: str, x, y, b, F: int, accumulate: bool, n_sm: int) -> None:
    """Launch bucket b's kernels (csrc/omnibus.cu on csrc/fft.cuh) through
    `k` (`_build.kernels`), counted under `kernel`, over F frames of each
    row of x [S, 2, width] into y [S, 3, width], at `launch_geometry`:
    omni_bucket for a block up to FFT_MAX points, the split's
    omni_wide_forward and omni_wide_inverse for a wider one; the bucket
    writes its span, or adds into it with `accumulate`."""
    S, _, width = x.shape
    B, H, K, w = b.block, b.hop, b.kept, b.wide
    geo = launch_geometry(b, F, S, n_sm)
    common = (b.synthesis_window.data_ptr(), b.gains.data_ptr(), b.twiddles.data_ptr())
    if w is None:
        k.launch(
            kernel, "omni_bucket", x.data_ptr(), y.data_ptr(), b.analysis_window.data_ptr(), *common,
            S, B, H, K, b.lo, b.gains.shape[0], F, geo.hops, geo.frames, int(geo.pair), width, int(accumulate),
        )
        return
    part = torch.empty((S, F, w.groups, 2 * K, 2), dtype=torch.float32, device=x.device)
    k.launch(
        kernel, "omni_wide_forward", x.data_ptr(), part.data_ptr(), b.analysis_window.data_ptr(),
        b.twiddles.data_ptr(), w.stage2.data_ptr(), S, B, H, K, b.lo, w.n1, w.cols, F, width,
    )
    k.launch(
        kernel, "omni_wide_inverse", part.data_ptr(), y.data_ptr(), *common, w.stage2.data_ptr(), w.rows.data_ptr(),
        w.row_ptr.data_ptr(), w.entries.data_ptr(), w.tile_ptr.data_ptr(), w.tiles, w.kt, S, B, H, K, b.lo,
        b.gains.shape[0], w.n1, w.cols, F, geo.hops, width, int(accumulate),
    )


def _omnibus_cuda(x: torch.Tensor, plan: OmnibusPlan) -> torch.Tensor:
    _check_input(x, plan)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the omnibus kernel takes a contiguous float32 tensor")
    dev = x.device
    for b in plan.buckets:
        check_kernel_tables(b, dev)
    S, _, width = x.shape
    with _build.kernels(dev) as k:
        y = torch.empty((S, 3, width), dtype=torch.float32, device=dev)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        for i, b in enumerate(plan.buckets):  # the first writes its span, the others add
            launch_bucket(k, "K1", x, y, b, plan.chunk // b.hop, i > 0, n_sm)
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
