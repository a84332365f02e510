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

On a CUDA tensor `pool_step_lcr` launches `csrc/pool.cu`'s kernels (K3):
the frames, the mask, the gated overlap-add and the carries, one launch
per bucket up to `fftplan.FFT_MAX` points, `pool_reg_kernel`, each frame
held on chip from its forward FFT through the mask and the inverses on
`csrc/fft_reg.cuh`'s register core (its twiddles `reg_twiddles`, its
block `fftplan.reg_pool_launch`), two for a bucket over FFT_MAX (the
two-stage split on `csrc/fft.cuh`; from a hardware block of 8192 samples
at the streaming configs' 4 x hw cap; `launches_per_bucket`), in a
`pool.frames` span with the FFT frames of a stream's call
(`PoolPlan.fft_frames`).  On a CPU tensor it runs `pool_step_lcr_plain`
(torch.fft).  A spectral plan on a CUDA tensor launches
`csrc/pool_spectral.cu`'s kernels (K3s), in three steps:

  1. `spectral_forward`: per bucket the new frames' forward FFTs and
     mask into [S, 3, F, K] spectra and the new carry (the split's
     forward and a mask pass for a bucket over FFT_MAX points).  Up to
     FFT_MAX points the FFTs of steps 1 and 3 run `csrc/fft_reg.cuh`'s
     core, each frame held in registers (its twiddles `reg_twiddles`);
  2. `spectral_edge`: the frames whose span [vH, vH + B) the call's
     output [0, hops * hw) cuts ("edge frames", `PoolBucket.
     spectral_frames`) reach only a sliver of it, so they go through a
     product on the tensor cores: out[(s, o), n] = sum over edge frames v
     and the 2K (re, im) values k of spec_v[(s, o), k] w[n - vH, k], w the
     inverse weight with the synthesis window and the 1/B, 2/B scales
     folded in (`make_edge_weight`, from `dftmm.make_direct_plan`: the
     weight the JAX body rearranges into its `wq`), in split precision
     (bf16x3, `split_edge_weight`); a gather launch splits the frames'
     spectra, then one product launch takes every such bucket;
  3. `spectral_whole`: the rest ("whole frames", inside the window) by
     the inverse FFTs, per stream in frame order, added after the product.

Which buckets' edge frames the product takes is decided when the plan
is built (`takes_edge_product`): those whose every frame of a one-block
call is an edge frame, so the product spares them their inverse-FFT
launch; a bucket it does not take sends every frame to the FFTs.  A
plan works out its routes and the product's launch arguments once per
`hops` (`PoolPlan.spectral_routes`); `spectral_launches` counts the
launches of a call.  On a CPU tensor a spectral plan runs
`pool_step_spectral_plain`, and each step its plain version
(`spectral_forward_plain`, `spectral_edge_plain`,
`spectral_whole_plain`), which compose to it; a step picks its path from
where its data lies and refuses inputs spread over devices.  There is no
fallback between the kernels and the plain versions, nor between the two
dataflows.

What the TPU plan needed only for Mosaic has no counterpart: no group of
streams per grid step (so no n_streams % group rule), no 8 MB bound on
the baked weights, no quarter refs; for the spectral OLA no lane padding
of the spectra, no Q hops a product and no rearranged inverse weight:
the edge product reads its weight's rows at each frame's offset.  Its
bf16 hi/lo split is the H100's choice of precision for the tensor cores,
as the TPU's was for its matrix unit.  The plan declines only what the
function cannot do: a hop that does not divide hw or its block, or mixed
block/hop ratios.

The stream host plan, the numpy bucket records a config gives at a
hardware block size (`_plan_stream_buckets`, `stream_warmup_blocks`),
lives here too: the plans, the streaming engines and the AOT artifacts
all start from it.  The kernels are launched through
`_build.kernels` (K3 and K3s, the edge product as "K3s.edge").
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as tnf

from upmix_tpu_torch.config import UpmixConfig, bucket_bands
from upmix_tpu_torch.ops import _build
from upmix_tpu_torch.ops.dftmm import make_direct_plan
from upmix_tpu_torch.ops.fftplan import FFT_MAX, launches_per_bucket, pass_twiddles, reg_pool_launch, reg_twiddles
from upmix_tpu_torch.ops.framing import frame_signal, overlap_add
from upmix_tpu_torch.ops.gains import band_gain_curve
from upmix_tpu_torch.ops.mask import mask_sum
from upmix_tpu_torch.ops.omnibus import WideTables, check_kernel_tables, make_wide_tables
from upmix_tpu_torch.ops.windows import design_wola_synthesis_window, make_window
from upmix_tpu_torch.utils.tracing import span

OLA_MODES = ("time", "spectral")
SPECTRAL_LANES = 128  # the JAX package's packed spectra: 2K rounded up to this

# The edge product (csrc/pool_spectral.cu, spectral_edge_kernel): the
# buckets one launch takes, and the depth its weight is padded to (one
# stage of the kernel: 16 kept bins, re and im).
EDGE_MAX_BUCKETS = 8
EDGE_DEPTH = 32
# The product's tensor-core rate over the inverse FFTs' rate that
# `takes_edge_product` assumes: about the least the H100 showed, timing
# the product step against the FFTs' inverse of the same frames, at 512
# and 2048 streams (43.9 to 150.2 over the serving buckets, hw 8192's
# 32768 and one band keeping every bin of 16384; chip_smoke.py's routes
# lines, PERF.md).
EDGE_RATE_RATIO = 44

# The register core's butterfly twiddles w_16^0..3 (the head of every
# `reg_twiddles` table), copied into each device's constant memory once
# per kernel library and source (`load_reg_roots`).
_REG_ROOTS = np.ascontiguousarray(reg_twiddles(1)[:4])


def edge_frames(block: int, hop: int, frames: int) -> tuple:
    """The virtual frames v of a call of `frames` new frames (frame v spans
    [v hop, v hop + block) of the output, which is [0, frames * hop)) whose
    span the output window cuts: the Kr - 1 carried frames that reach in
    from the left, v < 0, and the last Kr - 1, v > frames - Kr."""
    Kr = block // hop
    return tuple(v for v in range(1 - Kr, frames) if v < 0 or v > frames - Kr)


def takes_edge_product(block: int, hop: int, kept: int, hw: int) -> bool:
    """Whether a spectral plan sends this bucket's edge frames to the
    tensor-core product, decided from its geometry: frames overlap (Kr >
    1); every frame of a call of one hardware block is an edge frame (P <=
    Kr - 1), so that the product spares the bucket its inverse-FFT launch
    (where whole frames remain, that launch runs anyway and the card
    measured the product slower: PERF.md); and the product's work (3
    outputs x 3 split products x 2 FLOP x 2K values for each sample an
    edge frame reaches) at EDGE_RATE_RATIO times the FFTs' rate costs no
    more than those frames' inverse FFTs (1.5 complex transforms of B
    points a frame, 5 B log2 B FLOP each), which keeps a bucket that
    keeps most of its bins (a wide K) on the FFTs.  The stream count
    does not enter: a one-card mesh plans each shard's streams but
    launches all of them as rows of one step, so a rule on the count
    would route it apart from the unsharded pool and break their bit-for-
    bit equality; and at 16 and 128 streams the plan as built still beat
    every bucket on the FFTs on the card (PERF.md)."""
    Kr, P = block // hop, hw // hop
    if Kr < 2 or P > Kr - 1:
        return False
    edge = edge_frames(block, hop, P)
    reach = sum(min(hw, v * hop + block) - max(0, v * hop) for v in edge)
    product = 36.0 * kept * reach
    return bool(product <= EDGE_RATE_RATIO * len(edge) * 7.5 * block * np.log2(block))


def edge_depth(kept: int) -> int:
    """Kp: the edge weight's depth, 2K rounded up to EDGE_DEPTH."""
    return -(-2 * kept // EDGE_DEPTH) * EDGE_DEPTH


def make_edge_weight(block: int, lo: int, kept: int, analysis_window, synthesis_window) -> np.ndarray:
    """The edge product's weight [B, Kp] float32: w[n, 2j + c] = w_inv[c K
    + j, n] of `dftmm.make_direct_plan` (c = 0 the real, 1 the imaginary
    part of kept bin lo + j; the synthesis window and the 1/B, 2/B scales
    folded in), so a frame's (re, im) pairs as the spectra store them meet
    their rows, each sample's column contiguous; rows 2K .. Kp - 1 are
    zeros (`edge_depth`)."""
    w_inv = make_direct_plan(block, lo, lo + kept - 1, analysis_window, synthesis_window).w_inv
    out = np.zeros((block, edge_depth(kept)), np.float32)
    out[:, 0 : 2 * kept : 2] = w_inv[:kept].T
    out[:, 1 : 2 * kept : 2] = w_inv[kept:].T
    return out


def split_edge_weight(w: np.ndarray) -> torch.Tensor:
    """The edge weight split for the product: [2, B, Kp] bf16, hi then lo
    (hi + lo = w to within the lo's rounding); the product splits its
    other operand the same way on the card."""
    wt = torch.from_numpy(np.ascontiguousarray(w, np.float32))
    hi = wt.to(torch.bfloat16)
    return torch.stack([hi, (wt - hi.float()).to(torch.bfloat16)])


@dataclass(frozen=True, eq=False)
class PoolBucket:
    """One live bucket on its device: geometry, windows, kept-bin gains
    and the FFT kernels' tables.  A plan built for the CPU's plain
    version leaves out the tables of a block over FFT_MAX (`twiddles` and
    `wide` None), as `omnibus.make_bucket` does: the plain version runs
    any block.  `twiddles` are those of the FFT core that runs the
    bucket: `fftplan.reg_twiddles` up to FFT_MAX points (fft_reg.cuh's,
    K3's and K3s's), else `fftplan.pass_twiddles` of the two-stage
    split's N1 (fft.cuh's).  A spectral plan's bucket whose edge frames
    the product takes (`edge_product`) carries the product's weight on a
    CUDA device (`edge_weight`, `make_edge_weight`); the plain versions
    need none."""

    block: int
    hop: int
    passes: int  # P = hw / hop frames per hardware block
    lo: int  # first kept bin
    analysis_window: torch.Tensor  # [B]
    synthesis_window: torch.Tensor  # [B]
    gains: torch.Tensor  # [n_bands, K], bins lo .. lo + K - 1
    twiddles: torch.Tensor | None  # the kernel's FFT's: reg_twiddles (B), or pass_twiddles (N1) when split
    wide: WideTables | None  # the two-stage split, for B > FFT_MAX
    edge_product: bool = False  # spectral: the edge frames go to the product, else every frame to the FFTs
    edge_weight: torch.Tensor | None = None  # [2, B, Kp] split (split_edge_weight), a CUDA plan's

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

    def spectral_frames(self, hops: int) -> tuple:
        """(edge, whole): the virtual frames of a spectral call of `hops`
        hardware blocks that the edge product takes, and those the inverse
        FFTs take (frames -(Kr - 1) .. hops * P - 1; `edge_frames`)."""
        frames = tuple(range(1 - self.overlap, hops * self.passes))
        if not self.edge_product:
            return (), frames
        edge = edge_frames(self.block, self.hop, hops * self.passes)
        return edge, tuple(v for v in frames if v not in edge)


@dataclass(frozen=True, eq=False)
class _EdgeGroup:
    """One launch pair of the edge product: up to EDGE_MAX_BUCKETS buckets
    (indices into the plan), their edge frames and weight depths, and the
    kernel's arguments that do not change between calls: the split
    weights' pointers (None where the plan carries no valid weight) and
    the geometry (B, H, K, Kp, edge frames of each bucket)."""

    buckets: tuple
    n_edge: tuple
    depth: tuple
    weights: object  # ctypes c_void_p array, or None
    geo: object  # ctypes c_int array
    device: torch.device | None  # the weights'


@dataclass(frozen=True, eq=False)
class SpectralRoutes:
    """A spectral plan's routes at one `hops`: per bucket its (edge, whole)
    frames (`PoolBucket.spectral_frames`), the edge product's launch
    groups, the kernel launches of a call, and why the product cannot run
    where a bucket it takes has no split weight on a CUDA device; for the
    steps' spans, the buckets the product takes, their edge frames in a
    stream's call, the buckets with whole frames, and the FFT frames of a
    stream's call in the forward and inverse steps with those the
    register core takes (every bucket up to FFT_MAX points; the split
    takes the rest)."""

    frames: tuple
    groups: tuple  # _EdgeGroup
    launches: int
    weight_error: str | None
    edge_buckets: int
    edge_frames: int
    whole_buckets: int
    forward_frames: int
    forward_reg: int
    inverse_frames: int
    inverse_reg: int


@dataclass(frozen=True, eq=False)
class PoolPlan:
    hw: int
    warmup: int  # K = block / hop, the same for every bucket
    n_streams: int
    buckets: tuple  # PoolBucket, live buckets in config order
    ola: str = "time"  # the OLA dataflow: "time" or "spectral"
    _routes: dict = field(default_factory=dict, init=False, repr=False)  # hops -> SpectralRoutes

    @property
    def window(self) -> int:
        """Shared history length: warmup * hw."""
        return self.warmup * self.hw

    def fft_frames(self, hops: int) -> tuple:
        """(all, reg): the frames a stream's call of `hops` blocks puts
        through forward FFTs, summed over the buckets, and those of them on
        the register core (every bucket up to FFT_MAX points; the
        two-stage split takes the rest)."""
        frames = [(hops * b.passes, b.block <= FFT_MAX) for b in self.buckets]
        return sum(n for n, _ in frames), sum(n for n, reg in frames if reg)

    def spectral_routes(self, hops: int) -> SpectralRoutes:
        """The spectral routes of a call of `hops` blocks, worked out on the
        first such call and kept."""
        routes = self._routes.get(hops)
        if routes is None:
            routes = self._routes[hops] = _spectral_routes(self, hops)
        return routes


def _spectral_routes(plan: PoolPlan, hops: int) -> SpectralRoutes:
    frames = tuple(b.spectral_frames(hops) for b in plan.buckets)
    takes = [i for i, (edge, _) in enumerate(frames) if edge]
    error = None
    for i in takes:
        b = plan.buckets[i]
        w = b.edge_weight
        if (w is None or w.device.type != "cuda" or w.dtype != torch.bfloat16 or not w.is_contiguous()
                or tuple(w.shape) != (2, b.block, edge_depth(b.kept))):
            error = ("the edge product takes its split weight [2, B, Kp] bf16 on the card (make_pool_plan builds it "
                     "for a CUDA device)")
    if error is None and len({plan.buckets[i].edge_weight.device for i in takes}) > 1:
        error = "the plan's split weights lie on several devices"
    groups = []
    for g in range(0, len(takes), EDGE_MAX_BUCKETS):
        idx = tuple(takes[g : g + EDGE_MAX_BUCKETS])
        bs = [plan.buckets[i] for i in idx]
        n_edge = tuple(len(frames[i][0]) for i in idx)
        depth = tuple(edge_depth(b.kept) for b in bs)
        geo = (ctypes.c_int * (5 * len(idx)))(*[v for b, e, kp in zip(bs, n_edge, depth)
                                                for v in (b.block, b.hop, b.kept, kp, e)])
        weights = None if error else (ctypes.c_void_p * len(idx))(*[b.edge_weight.data_ptr() for b in bs])
        groups.append(_EdgeGroup(idx, n_edge, depth, weights, geo, None if error else bs[0].edge_weight.device))
    whole = sum(1 for _, w in frames if w)
    launches = sum(launches_per_bucket(b.block) for b in plan.buckets) + 2 * len(groups) + whole
    inv = [(len(w), b.block <= FFT_MAX) for b, (_, w) in zip(plan.buckets, frames)]
    return SpectralRoutes(frames, tuple(groups), launches, error, len(takes), sum(len(frames[i][0]) for i in takes),
                          whole, *plan.fft_frames(hops), sum(n for n, _ in inv), sum(n for n, reg in inv if reg))


def check_ola(ola: str) -> None:
    """Raise ValueError unless `ola` is one of the pool's OLA dataflows."""
    if ola not in OLA_MODES:
        raise ValueError(f"unknown ola mode {ola!r}; one of {OLA_MODES}")


@dataclass(frozen=True)
class _StreamBucketPlan:
    block_size: int
    hop_size: int
    passes: int  # hw_block // hop
    analysis_window: np.ndarray  # [block]
    synthesis_window: np.ndarray  # [block]
    gains: np.ndarray  # [n_bands_in_bucket, n_bins]


def stream_warmup_blocks(config: UpmixConfig) -> int:
    """Uniform readiness latency in hardware blocks: K = block/hop, which
    must be the same for every band (the shared history needs it)."""
    ks = set()
    for b in config.bands:
        if b.block_size % b.hop_size:
            raise ValueError(
                f"streaming requires hop | block (band block {b.block_size}, hop {b.hop_size})"
            )
        ks.add(b.block_size // b.hop_size)
    if len(ks) != 1:
        raise ValueError(
            f"streaming requires a uniform block/hop ratio across bands, got {sorted(ks)}"
        )
    return ks.pop()


def _plan_stream_buckets(config: UpmixConfig, hw_block_size: int):
    """Numpy bucket records (a copy of the JAX package's, without its
    TPU-only direct-DFT field); raises ValueError for a config that cannot
    stream at this hw block size."""
    warmup = stream_warmup_blocks(config)
    plans = []
    for block_size, bands in bucket_bands(config.bands).items():
        hop = bands[0].hop_size
        if hw_block_size % hop != 0:
            raise ValueError(
                f"hw block size {hw_block_size} must be a multiple of every "
                f"band hop (violated by block {block_size}, hop {hop})"
            )
        # The last pass reads [hw - hop, hw - hop + block) of the K*hw
        # history (the C++ cap is block <= hw*4 at 75%, bela/upmix.cpp:498-506).
        if hw_block_size - hop + block_size > warmup * hw_block_size:
            raise ValueError(
                f"band block size {block_size} exceeds the shared-history "
                f"window ({warmup}x hw_block = {warmup * hw_block_size}); "
                f"build the config with UpmixConfig.streaming "
                f"(max_block_size = hw_block*4)"
            )
        aw = make_window(config.window, block_size)
        if config.synthesis == "wola":
            sw = design_wola_synthesis_window(aw, config.overlap)
        elif config.synthesis == "analysis":
            sw = aw  # C++ parity (bela/upmix.cpp:200-201)
        else:
            raise ValueError(f"unknown synthesis mode {config.synthesis!r}")
        gains = np.stack([band_gain_curve(b, dtype=np.float32) for b in bands])
        plans.append(
            _StreamBucketPlan(
                block_size=block_size,
                hop_size=hop,
                passes=hw_block_size // hop,
                analysis_window=aw,
                synthesis_window=sw,
                gains=gains,
            )
        )
    return plans


def plan_from_stream_buckets(records, hw: int, warmup: int, n_streams: int, device,
                             ola: str = "time") -> PoolPlan | None:
    """Device plan from `_StreamBucketPlan` records (numpy arrays) of
    either package; None when every bucket's gains are zero.  The
    two-stage split's tables of a block over FFT_MAX and the edge weights
    are built for a CUDA device only, with it current
    (`_build.on_device`)."""
    check_ola(ola)
    with _build.on_device(device):
        return _plan_on(records, hw, warmup, n_streams, torch.device(device), ola)


def _plan_on(records, hw: int, warmup: int, n_streams: int, device: torch.device, ola: str) -> PoolPlan | None:
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    buckets = []
    for p in records:
        nz = np.nonzero(p.gains.max(axis=0))[0]
        if not len(nz):
            continue  # a dead bucket contributes nothing
        lo, hi = int(nz[0]), int(nz[-1])
        edge = ola == "spectral" and takes_edge_product(p.block_size, p.hop_size, hi - lo + 1, hw)
        weight = None
        if edge and device.type == "cuda":
            weight = split_edge_weight(make_edge_weight(p.block_size, lo, hi - lo + 1, p.analysis_window,
                                                        p.synthesis_window)).to(device)
        wide = make_wide_tables(p.block_size, p.hop_size, lo, hi - lo + 1, device) if device.type == "cuda" else None
        n_fft = p.block_size if p.block_size <= FFT_MAX else (wide.n1 if wide is not None else 0)
        tw = reg_twiddles if p.block_size <= FFT_MAX else pass_twiddles
        buckets.append(
            PoolBucket(
                block=p.block_size,
                hop=p.hop_size,
                passes=hw // p.hop_size,
                lo=lo,
                analysis_window=dev(p.analysis_window),
                synthesis_window=dev(p.synthesis_window),
                gains=dev(p.gains[:, lo : hi + 1]),
                twiddles=dev(tw(n_fft)) if n_fft else None,
                wide=wide,
                edge_product=edge,
                edge_weight=weight,
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


def _check_cuda_inputs(hist, carries, plan: PoolPlan) -> None:
    dev = hist.device
    if hist.dtype != torch.float32 or not hist.is_contiguous():
        raise ValueError("the pool kernel takes a contiguous float32 history")
    if any(c.dtype != torch.float32 or not c.is_contiguous() or c.device != dev for c in carries):
        raise ValueError("the pool kernel takes contiguous float32 carries on the history's device")
    for b in plan.buckets:
        check_kernel_tables(b, dev)


def _pool_cuda(hist, t, carries, plan: PoolPlan, hops: int):
    """K3's launches, one a bucket up to FFT_MAX points (two over it), in a
    `pool.frames` span of the card with the buckets and the frames of a
    stream's call through FFTs (`fft_frames`) and on the register core
    (`reg_frames`), from the plan on the host."""
    _check_inputs(hist, t, carries, plan, hops)
    _check_cuda_inputs(hist, carries, plan)
    dev = hist.device
    S, _, width = hist.shape
    hw, nq = plan.hw, plan.warmup
    fft_frames, reg_frames = plan.fft_frames(hops)
    with span("pool.frames", card=dev, buckets=len(plan.buckets), fft_frames=fft_frames, reg_frames=reg_frames), \
            _build.kernels(dev) as k:
        load_reg_roots(k, "pool_reg_roots")
        t32 = t.to(device=dev, dtype=torch.int32).contiguous()
        out = torch.empty((S, 3, hops * hw), dtype=torch.float32, device=dev)
        new = []
        for i, (b, carry) in enumerate(zip(plan.buckets, carries)):
            B, H, K, nb, w = b.block, b.hop, b.kept, b.gains.shape[0], b.wide
            carry_out = torch.empty((S, 3, B), dtype=torch.float32, device=dev)
            io = (carry.data_ptr(), t32.data_ptr(), out.data_ptr(), carry_out.data_ptr())
            if w is None:
                geo = reg_pool_launch(B, K)
                k.launch(
                    "K3", "pool_reg_bucket", hist.data_ptr(), *io, b.analysis_window.data_ptr(),
                    b.synthesis_window.data_ptr(), b.gains.data_ptr(), b.twiddles.data_ptr(), S, B, H, K, b.lo, nb, hw,
                    hops, nq, geo.threads, geo.round, int(geo.pair), width, int(i > 0),
                )
            else:
                part = torch.empty((S, hops * b.passes, w.groups, 2 * K, 2), dtype=torch.float32, device=dev)
                k.launch(
                    "K3", "pool_wide_forward", hist.data_ptr(), t32.data_ptr(), part.data_ptr(),
                    b.analysis_window.data_ptr(), b.twiddles.data_ptr(), w.stage2.data_ptr(), S, B, H, K, b.lo, w.n1,
                    w.cols, hw, hops, nq, width,
                )
                k.launch(
                    "K3", "pool_wide_inverse", part.data_ptr(), *io, b.synthesis_window.data_ptr(), b.gains.data_ptr(),
                    b.twiddles.data_ptr(), w.stage2.data_ptr(), w.rows.data_ptr(), w.row_ptr.data_ptr(),
                    w.entries.data_ptr(), w.tile_ptr.data_ptr(), w.tiles, w.kt, S, B, H, K, b.lo, nb, w.n1, w.cols, hw,
                    hops, nq, int(i > 0),
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


def load_reg_roots(k, entry: str = "pool_spectral_roots") -> None:
    """Copy the register core's butterfly twiddles into the constant memory
    of `k`'s card (`_build.kernels`) that `entry` sets: K3s's
    (csrc/pool_spectral.cu::pool_spectral_roots) or K3's
    (csrc/pool.cu::pool_reg_roots), each source its own; once for each
    library and card."""
    k.once(entry, _REG_ROOTS.ctypes.data)


def spectral_launches(plan: PoolPlan, hops: int) -> int:
    """Kernel launches of one spectral call (K3s): per bucket its forward
    (two over FFT_MAX points: the split's forward and a mask pass), the
    edge product's gather and product for every EDGE_MAX_BUCKETS buckets
    it takes, and per bucket with whole frames their inverse FFTs."""
    return plan.spectral_routes(int(hops)).launches


def _spectral_cuda(hist, t, carries, plan: PoolPlan, hops: int):
    """K3s's three steps, each in a span of its card with the buckets it
    takes: `pool.forward`, `pool.edge` (where the product takes a bucket;
    `frames`, the edge frames of a stream's call) and `pool.inverse`;
    the forward's and the inverse's with `fft_frames`, the FFT frames of
    a stream's call, and `reg_frames`, those the register core takes."""
    _check_inputs(hist, t, carries, plan, hops)
    _check_cuda_inputs(hist, carries, plan)
    t32 = t.to(device=hist.device, dtype=torch.int32).contiguous()
    routes = plan.spectral_routes(hops)
    card = hist.device
    with span("pool.forward", card=card, buckets=len(plan.buckets), fft_frames=routes.forward_frames,
              reg_frames=routes.forward_reg):
        specs, new = _forward_cuda(hist, t32, carries, plan, hops)
    out = None
    if routes.groups:
        with span("pool.edge", card=card, buckets=routes.edge_buckets, frames=routes.edge_frames):
            out = _edge_cuda(carries, specs, t32, plan, hops, routes)
    with span("pool.inverse", card=card, buckets=routes.whole_buckets, fft_frames=routes.inverse_frames,
              reg_frames=routes.inverse_reg):
        out = _whole_cuda(carries, specs, t32, plan, hops, routes, out)
    return out, new


def _spectral_device(carries, specs, t, plan: PoolPlan, hops: int, out=None) -> torch.device:
    """The device a step on the spectra runs on: the spectra's.  Raises
    unless t, the carries and out lie there too and the shapes fit; on the
    card, unless they are what the kernels take."""
    if len(carries) != len(plan.buckets) or len(specs) != len(plan.buckets):
        raise ValueError(f"expected {len(plan.buckets)} bucket carries and spectra")
    dev = specs[0].device
    for x in (t, *carries, *specs, *(() if out is None else (out,))):
        if x.device != dev:
            raise ValueError(f"the spectral steps take t, the carries, the spectra and out on one device: got {x.device} "
                             f"beside the spectra's {dev}")
    S = t.shape[0]
    for b, c, x in zip(plan.buckets, carries, specs):
        want = (S, 3, hops * b.passes, b.kept, 2)
        if tuple(c.shape) != b.spectral_carry_shape(S) or tuple(x.shape) != want:
            raise ValueError(f"expected carry {list(b.spectral_carry_shape(S))} and spectra {list(want)}, "
                             f"got {tuple(c.shape)} and {tuple(x.shape)}")
    if out is not None and tuple(out.shape) != (S, 3, hops * plan.hw):
        raise ValueError(f"expected out [S, 3, {hops * plan.hw}], got {tuple(out.shape)}")
    if dev.type == "cuda":
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("the spectral kernels take t as contiguous int32")
        if any(x.dtype != torch.float32 or not x.is_contiguous() for x in (*carries, *specs)):
            raise ValueError("the spectral kernels take contiguous float32 carries and spectra")
        if out is not None and (out.dtype != torch.float32 or not out.is_contiguous()):
            raise ValueError("the spectral kernels take out as contiguous float32")
    elif dev.type != "cpu":
        raise ValueError(f"the spectral steps run on cpu or cuda, not {dev}")
    return dev


def spectral_forward(hist, t, carries, plan: PoolPlan, hops: int = 1):
    """Step 1 of K3s: (spectra, new carries), per bucket the masked spectra
    [S, 3, F, K, 2] of this call's frames (those of not-ready hops left
    unwritten on the card) and the new carry.  t int32 on hist's device.
    A CPU tensor runs `spectral_forward_plain`."""
    if hist.device.type == "cpu":
        return spectral_forward_plain(hist, t, carries, plan, hops)
    _check_inputs(hist, t, carries, plan, hops)
    _check_cuda_inputs(hist, carries, plan)
    if t.dtype != torch.int32 or not t.is_contiguous() or t.device != hist.device:
        raise ValueError("the spectral kernels take t as contiguous int32 on the history's device")
    return _forward_cuda(hist, t, carries, plan, int(hops))


def _forward_cuda(hist, t, carries, plan: PoolPlan, hops: int):
    S, _, width = hist.shape
    dev, hw, nq = hist.device, plan.hw, plan.warmup
    with _build.kernels(dev) as k:
        load_reg_roots(k)
        specs, new = [], []
        for b, carry in zip(plan.buckets, carries):
            B, H, K, nb, w = b.block, b.hop, b.kept, b.gains.shape[0], b.wide
            F = hops * b.passes
            spec = torch.empty((S, 3, F, K, 2), dtype=torch.float32, device=dev)
            carry_out = torch.empty_like(carry)
            state = (carry.data_ptr(), spec.data_ptr(), carry_out.data_ptr())
            if w is None:
                k.launch(
                    "K3s", "pool_spectral_forward", hist.data_ptr(), t.data_ptr(), *state,
                    b.analysis_window.data_ptr(), b.gains.data_ptr(), b.twiddles.data_ptr(), S, B, H, K, b.lo, nb, hw,
                    hops, nq, width,
                )
            else:
                part = torch.empty((S, F, w.groups, 2 * K, 2), dtype=torch.float32, device=dev)
                k.launch(
                    "K3s", "pool_wide_forward", hist.data_ptr(), t.data_ptr(), part.data_ptr(),
                    b.analysis_window.data_ptr(), b.twiddles.data_ptr(), w.stage2.data_ptr(), S, B, H, K, b.lo, w.n1,
                    w.cols, hw, hops, nq, width,
                )
                k.launch(
                    "K3s", "pool_spectral_mask", part.data_ptr(), t.data_ptr(), *state, b.gains.data_ptr(), S, B, H,
                    K, b.lo, nb, w.groups, hw, hops, nq,
                )
            specs.append(spec)
            new.append(carry_out)
    return tuple(specs), tuple(new)


def spectral_edge(carries, specs, t, plan: PoolPlan, hops: int = 1):
    """Step 2 of K3s: out [S, 3, hops * hw], the edge frames of every
    bucket the product takes, summed (zeros below each stream's first
    ready hop, by selection).  Runs where the spectra lie: on the card,
    for every EDGE_MAX_BUCKETS such buckets, two launches, a gather of
    their edge frames' spectra split into bf16 hi + lo, then
    `spectral_edge_kernel`; on the CPU `spectral_edge_plain`."""
    hops = int(hops)
    if _spectral_device(carries, specs, t, plan, hops).type == "cpu":
        return spectral_edge_plain(carries, specs, t, plan, hops)
    routes = plan.spectral_routes(hops)
    if not routes.groups:
        raise ValueError("no bucket of this plan sends frames to the edge product")
    return _edge_cuda(carries, specs, t, plan, hops, routes)


def _edge_cuda(carries, specs, t, plan: PoolPlan, hops: int, routes: SpectralRoutes):
    if routes.weight_error:
        raise ValueError(routes.weight_error)
    dev, S = t.device, t.shape[0]
    if any(g.device != dev for g in routes.groups):
        raise ValueError(f"the plan's split weights lie on {routes.groups[0].device}, the spectra on {dev}")
    with _build.kernels(dev) as k:
        out = torch.empty((S, 3, hops * plan.hw), dtype=torch.float32, device=dev)
        for g, group in enumerate(routes.groups):
            n = len(group.buckets)
            # The gathered operands [2, 3 S, n_edge, Kp] of the group's buckets
            # in one allocation; each a multiple of 64 bf16 values long, so
            # every one starts on 16 bytes.
            sizes = [2 * 3 * S * e * kp for e, kp in zip(group.n_edge, group.depth)]
            gathered = torch.empty(sum(sizes), dtype=torch.bfloat16, device=dev)
            at = np.cumsum([0, *sizes[:-1]]) * gathered.element_size() + gathered.data_ptr()
            args = (group.weights, (ctypes.c_void_p * n)(*at.tolist()),
                    (ctypes.c_void_p * n)(*[carries[i].data_ptr() for i in group.buckets]),
                    (ctypes.c_void_p * n)(*[specs[i].data_ptr() for i in group.buckets]),
                    group.geo, n, t.data_ptr(), out.data_ptr(), S, plan.hw, hops, plan.warmup, int(g > 0))
            k.launch("K3s.edge", "pool_spectral_edge_gather", *args)
            k.launch("K3s.edge", "pool_spectral_edge", *args)
    return out


def spectral_whole(carries, specs, t, plan: PoolPlan, hops: int = 1, out=None):
    """Step 3 of K3s: the whole frames of every bucket (every frame of a
    bucket the product does not take) by inverse FFTs, added into `out`
    (the edge product's), or into zeros when it is None; returns out.
    Runs where the spectra lie: on the card one launch per bucket with
    whole frames, one block per stream adding its frames in frame order;
    on the CPU `spectral_whole_plain`."""
    hops = int(hops)
    if _spectral_device(carries, specs, t, plan, hops, out).type == "cpu":
        whole = spectral_whole_plain(carries, specs, t, plan, hops)
        return whole if out is None else out + whole
    for b in plan.buckets:
        check_kernel_tables(b, t.device)
    return _whole_cuda(carries, specs, t, plan, hops, plan.spectral_routes(hops), out)


def _whole_cuda(carries, specs, t, plan: PoolPlan, hops: int, routes: SpectralRoutes, out):
    S, hw, nq = t.shape[0], plan.hw, plan.warmup
    with _build.kernels(t.device) as k:
        load_reg_roots(k)
        accumulate = out is not None
        if out is None:
            # The first launch writes every position; with no launch (every
            # bucket's frames on the edge product) the result is zeros.
            alloc = torch.empty if any(whole for _, whole in routes.frames) else torch.zeros
            out = alloc((S, 3, hops * hw), dtype=torch.float32, device=t.device)
        for b, carry, spec, (_, whole) in zip(plan.buckets, carries, specs, routes.frames):
            if not whole:
                continue
            B, H, K, w = b.block, b.hop, b.kept, b.wide
            state = (carry.data_ptr(), spec.data_ptr(), t.data_ptr(), out.data_ptr())
            span = (whole[0], whole[-1] + 1)
            if w is None:
                k.launch(
                    "K3s", "pool_spectral_inverse", *state, b.synthesis_window.data_ptr(), b.twiddles.data_ptr(), S,
                    B, H, K, b.lo, hw, hops, nq, *span, int(accumulate),
                )
            else:
                k.launch(
                    "K3s", "pool_spectral_wide_inverse", *state, b.synthesis_window.data_ptr(),
                    b.twiddles.data_ptr(), w.stage2.data_ptr(), w.rows.data_ptr(), w.row_ptr.data_ptr(),
                    w.entries.data_ptr(), w.tile_ptr.data_ptr(), w.tiles, w.kt, S, B, H, K, b.lo, w.n1, w.cols, hw,
                    hops, nq, *span, int(accumulate),
                )
            accumulate = True
    return out


def _masked_spectra(hist, b: PoolBucket, hops: int) -> torch.Tensor:
    """[S, 3, F, K] complex: the masked spectra (C, Ls, Rs at the kept
    bins, unnormalised) of bucket b's frames of hist, in hist's dtype."""
    dt = hist.dtype
    F = hops * b.passes
    frames = frame_signal(hist[..., : (F - 1) * b.hop + b.block], b.block, b.hop, F)  # [S, 2, F, B]
    spec = torch.fft.rfft(frames * b.analysis_window.to(dt))[..., b.lo : b.lo + b.kept]
    sl, sr = spec[:, 0], spec[:, 1]
    c_re, c_im, l_re, l_im, r_re, r_im = mask_sum(sl.real, sl.imag, sr.real, sr.imag, b.gains.to(dt))
    return torch.complex(torch.stack([c_re, l_re, r_re], dim=1), torch.stack([c_im, l_im, r_im], dim=1))


def _virtual_frames(carry, spec, t, b: PoolBucket, warmup: int, hops: int) -> torch.Tensor:
    """[S, 3, Kr - 1 + F, K] complex: each stream's virtual frames v = -(Kr
    - 1) .. F - 1 (csrc/pool_spectral.cu::SpectralState): new frame v from
    the stream's first ready frame f0 on, the carried slots just below f0,
    zeros (by selection) below those."""
    n, F = b.overlap - 1, hops * b.passes
    src = torch.cat([torch.view_as_complex(carry.contiguous()), torch.view_as_complex(spec.contiguous())], dim=2)
    f0 = ((warmup - t.to(spec.device).long()).clamp(0, hops) * b.passes)[:, None]  # [S, 1]
    v = torch.arange(-n, F, device=spec.device)[None, :]
    idx = torch.where(v >= f0, n + v, v - f0 + n)
    valid = v >= f0 - n
    S, K = spec.shape[0], b.kept
    got = torch.gather(src, 2, idx.clamp(0, n + F - 1)[:, None, :, None].expand(S, 3, n + F, K))
    return torch.where(valid[:, None, :, None], got, torch.zeros((), dtype=got.dtype, device=got.device))


def _below_first_ready(out, t, plan: PoolPlan, hops: int) -> torch.Tensor:
    """out with every position below its stream's first ready hop set to
    zero by selection (a NaN there does not reach the output)."""
    first = (plan.warmup - t.to(out.device).long()).clamp(0, hops) * plan.hw
    keep = torch.arange(out.shape[-1], device=out.device)[None, :] >= first[:, None]
    return torch.where(keep[:, None, :], out, torch.zeros((), dtype=out.dtype, device=out.device))


def spectral_forward_plain(hist, t, carries, plan: PoolPlan, hops: int = 1):
    """The plain version of `spectral_forward`, in hist's dtype: every
    frame's masked spectra [S, 3, F, K, 2] and the new carries, the last
    Kr - 1 virtual frames."""
    hops = int(hops)
    _check_inputs(hist, t, carries, plan, hops)
    specs, new = [], []
    for b, carry in zip(plan.buckets, carries):
        spec = torch.view_as_real(_masked_spectra(hist, b, hops)).contiguous()
        frames = _virtual_frames(carry.to(hist.dtype), spec, t, b, plan.warmup, hops)
        specs.append(spec)
        new.append(torch.view_as_real(frames[:, :, hops * b.passes :]).contiguous())
    return tuple(specs), tuple(new)


def _spectral_frames_plain(carries, specs, t, plan: PoolPlan, hops: int, which: int):
    """The output [S, 3, hops * hw] of every bucket's edge frames (which =
    0) or whole frames (1), each irfft of its kept bins times the synthesis
    window added at vH where it reaches the output, in the spectra's dtype;
    zeros below each stream's first ready hop."""
    hops = int(hops)
    S, N = t.shape[0], hops * plan.hw
    dt = specs[0].dtype
    out = torch.zeros((S, 3, N), dtype=dt, device=specs[0].device)
    for b, carry, spec in zip(plan.buckets, carries, specs):
        frames = b.spectral_frames(hops)[which]
        if not frames:
            continue
        n, H, B = b.overlap - 1, b.hop, b.block
        picked = _virtual_frames(carry.to(dt), spec, t, b, plan.warmup, hops)[:, :, [v + n for v in frames]]
        full = picked.new_zeros((S, 3, len(frames), B // 2 + 1))
        full[..., b.lo : b.lo + b.kept] = picked
        rec = torch.fft.irfft(full, n=B) * b.synthesis_window.to(dt)
        for i, v in enumerate(frames):
            lo, hi = max(0, v * H), min(N, v * H + B)
            out[..., lo:hi] += rec[:, :, i, lo - v * H : hi - v * H]
    return _below_first_ready(out, t, plan, hops)


def spectral_edge_plain(carries, specs, t, plan: PoolPlan, hops: int = 1):
    """The plain version of `spectral_edge`: the edge frames of every
    bucket the product takes, each by irfft (the function the product
    computes with the weight's rows at n - vH), added where it reaches the
    output; zeros below each stream's first ready hop."""
    return _spectral_frames_plain(carries, specs, t, plan, hops, 0)


def spectral_whole_plain(carries, specs, t, plan: PoolPlan, hops: int = 1):
    """The plain version of `spectral_whole` (into zeros): every bucket's
    whole frames by irfft, added at vH; zeros below each stream's first
    ready hop."""
    return _spectral_frames_plain(carries, specs, t, plan, hops, 1)


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
