"""Smoke run of the PyTorch/CUDA port (upmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths: the offline upmix of bench.py's config
(6 bands at 0/30/120/480/1920/7680 Hz, 44.1 kHz, blocks up to 65536) on
2^21 samples of seeded noise, through `Upmixer(cfg, device="cuda")`; the
same config sharded, two files of 2^21 samples on a data 2 x seq 4 mesh
of the one card, through `ShardedUpmixer`, and in batches through
`BatchUpmixer`; the geometries no kernel takes (overlap 0.65, blocks
of 49152) through `Upmixer` and `ShardedUpmixer`, and a custom window
through `Upmixer` and `make_stream_pool`; the serving pool of the stream server's default
config (the Bela setup: edges 0/500/2000/8000 Hz, 48 kHz, hardware block
2048) at 2048 streams, through `make_stream_pool(cfg, 2048, 2048)`; the
two probes through their entry points (`ops.int8_dot` check and bench,
`ops.overhead_probe.run_configs`); and the CLI in process on WAV files
(offline, --streaming, --pipe, --serve); and the stream server on
loopback through `run_stream_server`; the pool's spectral OLA through
`make_stream_pool(..., ola="spectral")`, the pool on a mesh and the
tuner (`python -m upmix_tpu_torch.tune`'s two sweeps); and the AOT
artifacts (`upmix_tpu_torch.aot`) of the offline program, the pool and
the streaming step, loaded onto the card; and processes that share one
global mesh (`upmix_tpu_torch.parallel.distributed`,
`build_sharded_offline_fn` across processes, `pod_check`).  Phases, one
line each or more, any failure exits nonzero (phases 10-13 and 19-21 run
between 5 and 6, 22-24, 27 and 25 after 8, then 14-18 and 26):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every csrc/*.cu into upmix_tpu_torch/_build/;
  3. kernel parity: the omnibus kernel against its plain version run in
     float64 on the card, per bucket and for the whole plan (>= 80 dB),
     and two calls bit-identical; each plan's device bytes and build
     seconds (offline, sharded, pool: windows, gains and FFT tables);
  4. end to end: Upmixer must launch the kernel (launches_per_bucket per
     bucket), and its output must
     match the float64 whole-file torch.fft path at bench.py's three
     probe slices (>= 60 dB); silence gives exact zeros, mono gives
     Ls, Rs <= 1e-5;
  5. timing: realtime factor of the kernel path and of the plain
     whole-file torch.fft path, the kernel path on a 4-segment input,
     and the kernel alone against its plain version on one chunk, whole
     and per bucket, beside a cuFFT yardstick for the same transforms
     (torch.fft.rfft of the framed, windowed rows and torch.fft.irfft of
     the three masked spectra; timed only, the port never calls it);
     CUDA events, min over loops; the design line (the kernel's own FFT
     operations and bytes at its launch geometry); then device time by
     kernel and the idle share under torch.profiler;
  6. pool kernel parity: the pool step kernel (K3) against its plain
     version in float64 on the card, at 2048 streams with mixed block
     counts and nonzero carries, hops 1 and 4, per bucket and whole
     (>= 80 dB, exact zeros where the plain version has them); the floor
     probe (K6) bit for bit, both modes, at 1, 5 and 2048 streams and the
     windows of hw 2048 and 4096;
  7. pool end to end: the default make_stream_pool must be the CUDA pool
     and launch K3; 12 blocks of seeded noise, the first K-1 exact zeros,
     the rest >= 60 dB against a float64 run of the plain step with its
     own state; reset_streams re-warms one slot and leaves the others
     bit-identical; silence gives zeros, mono gives Ls, Rs <= 1e-5; then
     the floor probe's own run (history shift + K6, 12 blocks) in each
     mode, and
     StreamingUpmixer on the card (it must launch K3, >= 60 dB);
  8. pool timing: ms per block at 16, 2048, 7168 and 7680 streams and at hops
     4, on device-resident blocks, with the throughput S x 42.67 ms / (ms
     per block) each extrapolates to and whether it meets the deadline;
     then S doubled past 7680 until a block takes more than 42.67 ms or
     the pool would pass 40 GB of device memory, which brackets the
     capacity by measurement; K3 against its plain version and the cuFFT
     yardstick, per bucket; the design line; the history shift; K6 copy
     and frame, each with its plain version, its share of the bound and
     one PyTorch call that reads the whole history (a sum over its
     hw-long pieces, its bytes named; K6's `library_ms`); device time by
     kernel and the idle share under torch.profiler;
  9. a JSON line of per-kernel results (launches from the main paths'
     runs; bounds from this run's shapes and the least work of each
     function: its FFTs or its bytes, whichever takes longer; a kernel
     whose bound is more than 105% of its time fails the run; K1's,
     K3's and K3s's library_ms is the cuFFT yardstick of their
     transforms; K6 one entry per mode), then the last line {"ok": true,
     "device": {...}};
 10. fused kernel parity: K2 (K1's FFT kernels with an epilogue that
     writes its span) against its plain version in float64 on the card, on
     the three buckets the sharded path routes to it, at the sharded
     geometry (8 rows of one 2^19 chunk; >= 80 dB), two calls bit-identical;
 11. sharded end to end: ShardedUpmixer on the 2 x 4 mesh must launch K2
     once per narrow bucket and K1 launches_per_bucket per wide bucket
     (3 and 3) per call, match the float64 whole-file path
     (>= 60 dB) and Upmixer within 64 samples of each shard edge (< 1e-3),
     the data-only mesh likewise, and give exact zeros for silence;
 12. BatchUpmixer.process_files, sequential and pipelined, bit-identical
     to each other and within 1e-3 of Upmixer;
 13. timing: the sharded path's realtime factor; K2 alone per bucket
     against K1 alone on the same bucket (K2/K1), the plain version and a
     cuFFT yardstick; K2's bound and design lines (its own FFTs at its
     launch geometry); the profiler's idle share;
 14. dot-chain parity (K4): each of the seven variants' kernel against its
     plain version at K = 512 and both M the probe runs, 512 and 4224
     (clusters of 2-8 CTAs and single CTAs, as the card's choice of
     cluster size gives them), after one apply and over a chain of 64:
     the int8 rungs bit for bit, the float rungs within
     int8_dot.APPLY_TOLERANCE after one apply and the coarse
     int8_dot.CHAIN_TOLERANCE over the chain; then the probe's own
     run, `check` (each
     variant's SNR after 640 applies against float64, the script's check
     line, with the plain version's beside it) and `bench` (the script's
     min-of-visits at M = 512 and 4224), which must launch every variant;
 15. dot-chain timing: one call of 64 applies per variant at M = 512 and
     at M = 4224, with the cluster size, the CTAs launched and the
     clusters the card holds at once, each beside the one PyTorch call for
     the same function where there is one (chained torch.matmul in FP32
     with TF32 off for fp32, chained bf16 torch.matmul for bf16x1,
     torch._int_mm for int8x1); at M = 512 the plain version and the
     bound (the products at the unit's dense peak);
 16. overhead probe (K5): bit for bit in its six configurations, the
     probe's own run (`run_configs`), then each configuration's kernel
     alone (64 calls queued back to back behind a sleeping kernel, CUDA
     events: with L2 cold, the calls rotating over 340 MB of inputs and
     outputs, and with L2 warm, the same call repeated), its
     plain version, one PyTorch call that moves the same bytes (torch.add
     of x's row 0 into three channels, under the same cold protocol; timed
     only), its bound (bytes from HBM) and the share of it, the bytes
     staged, and an empty launch; a JSON line of the per-variant and
     per-configuration rows;
 17. the app on the card: `cli.main` offline (split stems of two 2^21-
     sample WAVs) must launch K1 (launches_per_bucket per bucket and
     file) and write stems equal to
     `Upmixer.process_np` + `scale_lcr` bit for bit, with --meter's
     realtime factor beside phase 5's; --streaming and --pipe on a short
     WAV must launch K3 (the pipe's output as long as its input); --serve
     answers a ping and two jobs; with --no-compile-cache the kernels
     build afresh (nvcc runs) into a temporary directory for that call
     alone, K1 still launches, and the cached directory and library
     come back after it;
 18. the stream server on the card: `run_stream_server` on loopback at
     the server's default config (16 slots, the CLI's default), 8
     clients of 48 seeded blocks each in lockstep, at hops 1 (with a
     checkpoint after 24 blocks, restored into a fresh server that the
     clients resume on), hops 4 and pipeline 2: K3 must launch in each
     run, and every client's frames must equal, bit for bit, a
     CudaStreamPool on the card fed the same blocks at the same slots in
     the server's cycles; the metrics as JSON and as Prometheus text
     (parsed) over the stream port; then a 2048-slot server in real-time
     mode with 16 live clients in a child process for a few seconds, at
     pipeline 1 and 2: its cycle and dispatch times after a warm-up round
     (p50, p99 and mean from ServerMetrics) beside the card's name and
     power limit;
 19. offline geometries: `Upmixer` on phase 4's input at overlap 0.65
     and with max_block_size 49152 (the whole-file torch.fft program: no
     K1 or K2 launch) and with a custom window (a registered vector: K1
     launched as in phase 4), each >= 60 dB against the float64
     whole-file path at bench.py's probe slices, with its realtime factor
     beside phase 5's;
 20. `ShardedUpmixer` at overlap 0.65 on the 2 x 4 mesh, two files of
     2^21 samples (bench.py's edges with blocks capped at 2048: sequence
     sharding refuses bench.py's own blocks at that overlap, as the JAX
     package does, which is checked too): no kernel launch, >= 60 dB
     against float64, < 1e-3 from `Upmixer` around each shard edge, its
     realtime factor beside phase 13's;
 21. `make_stream_pool` with the custom window at 2048 streams: the CUDA
     pool, K3 launched, >= 60 dB against the float64 plain step, warmup
     blocks exact zeros;
 22. K3s parity (the pool kernel's spectral-OLA body, csrc/pool_spectral.cu)
     against its float64 plain version at 1, 5 and 2048 streams, hops 1
     and 4, hw 2048 and 8192 (its 32768 bucket through the split), mixed
     block counts and nonzero carried spectra, per bucket at 2048 streams
     and whole (>= 80 dB, exact zeros where the plain version has them),
     two calls bit-identical, and its output against K3's from a fresh
     state (>= 80 dB: the two dataflows compute one function); its edge
     product (the gather and the tensor-core product of the frames a
     call's output cuts) alone against its plain version at the same
     shapes, every bucket's edge frames forced onto it (`edge_everywhere`):
     >= 80 dB per bucket, exact zeros, two calls bit for bit; and
     spectral_whole(out=None) on a plan whose every bucket takes the edge
     product (the serving config's 8192 and 4096 buckets at hops 1)
     launches nothing and returns exact zeros;
 23. the spectral pool end to end: make_stream_pool(cfg, 2048, 2048,
     ola="spectral") must be the CUDA pool and launch K3s (and not K3),
     its edge product once a block; the plan's edge and whole frames per
     bucket; 12 blocks, warmup exact zeros, the rest >= 60 dB against
     float64; a snapshot (the JAX package's packed layout) restored into
     a fresh pool continues bit for bit; reset_streams; then ms per block
     of the K3s and K3 pools at 16 and 2048 streams, hops 1 and 4, in one
     run; K3s alone beside K3 at the same four shapes, with each call's
     host time; its three steps' times and shares (forward FFTs, edge
     product with its TFLOP/s, whole-frame inverse FFTs) at hops 1 and
     4; per bucket the product route against the FFT route, the two
     inverse steps alone with the product's and the FFTs' rate ratio
     (`pool.takes_edge_product`), and the plan as built against every
     bucket on either, at hw 2048 (2048, 128 and 16 streams), at 8192
     and for one band keeping every bin of 16384; its plain version, its
     bound and design line (its own FFTs, products and bytes), per bucket
     its edge/whole split, product and FFT times beside a cuFFT yardstick
     of its transforms; the profiler's idle share;
 24. the pool on a data = 2 mesh of the one card ([cuda:0] * 2) at 2048
     streams in both OLA modes: K3 or K3s launched, outputs and
     snapshots bit for bit the unsharded pool's; a stream-server session
     on run_stream_server(mesh=...) (spectral), checkpointed, then resumed
     on an unsharded server: the clients' frames equal the pool fed
     directly bit for bit;
 25. the tuner: `tune.main` (python -m upmix_tpu_torch.tune) over 1024
     and 2048 streams, both OLA modes, hops 1 and 4, protocol "scan", then
     the offline chunks 2^19-2^22 on bench.py's config at 2^23 samples:
     every candidate timed, best printed;
 26. AOT artifacts on the card: `aot.save_offline` of bench.py's config
     at 2^21 samples, then `aot.load`: each call launches K1 as Upmixer
     does and equals `Upmixer(cfg, device="cuda").process` bit for bit; a
     shorter input is padded and trimmed as Upmixer(pad_granularity=2^21)
     does, a longer one refused; the same artifact loaded and called in
     a fresh process, with the kernel library cached and with none (the
     load builds it); `save_stream_pool` of the serving config
     at 2048 streams in both OLA modes at hops 1 and 4: 12 blocks launch K3
     (or K3s and its edge product) and equal the live make_stream_pool bit
     for bit, a snapshot restored into a fresh load continues bit for bit
     (and through JSON at 16 streams); `save_stream_step` at hw 2048:
     push_block launches K3 and equals StreamingUpmixer bit for bit; the
     CLI's --save-aot for the three kinds, each loaded; a JAX artifact
     refused with one line; each artifact's bytes, save and load seconds
     and first call beside the live class's construction (and first call);
 27. processes on one global mesh: two child processes, each holding four
     entries of the one card, bring up torch.distributed under gloo
     (`init_distributed`, the kernels already built by phase 2) and run
     `build_sharded_offline_fn` on phase 11's two files over a global
     {"seq": 4, "data": 2} mesh, whose seq axis crosses the process
     boundary (the input head and the spill go by send and receive through
     pinned host memory); each process's shards >= 60 dB against the
     float64 whole-file path and within float32 rounding of phase 13's
     ShardedUpmixer output (K1 and K2 sum a pass's frames before adding
     them to the output, and the passes follow the launch geometry, which
     follows the row count), K1 and K2 launched 3 times each a call, the
     shards covering the output once; the exchange's ms a call beside the
     call's and the group's realtime factor beside phase 13's; then
     `run_pod_check` at its defaults in both processes (all_reduce, an
     8-entry seq mesh, > 60 dB); the same at world size 1 under NCCL on 8
     entries of one process; NCCL across two cards where there are two
     (else one line says it was not run).

Exits nonzero without a result when no CUDA device is present.  Needs no
jax: the GPU machine does not have it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SR = 44100.0
BAND_EDGES = [0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0]
MAX_BLOCK = 65536
N_SAMPLES = 2**21  # bench.py's N_SAMPLES, ~47.6 s of audio
PROBE_W = min(16384, N_SAMPLES // 4)
PROBE_STARTS = sorted({0, N_SAMPLES // 2, N_SAMPLES - PROBE_W})  # bench.py:51-54
KERNEL_BAR_DB = 80.0
E2E_BAR_DB = 60.0
OUTPUTS = ("C", "Ls", "Rs")

# The stream server's default (serve_stream.py:1307, the Bela setup).
POOL_EDGES = [0.0, 500.0, 2000.0, 8000.0]
POOL_SR = 48000.0
POOL_HW = 2048
POOL_STREAMS = 2048
POOL_BLOCKS = 12
FLOOR_STREAMS = (1, 5, POOL_STREAMS)  # K6's parity at these stream counts
# Pools near the size that S = 2048's rate extrapolates to at the 42.67 ms
# deadline (about 7,900 streams), in steps of 512: timed too, to see which
# pool sizes meet the deadline.
POOL_CAPACITY_STREAMS = (7168, 7680)
POOL_MEMORY_CAP = 40e9  # the capacity sweep stops before a run of this many bytes
SWEEP_BLOCKS = 4  # blocks a call in the capacity sweep (its inputs and outputs held on the card)
SWEEP_SPLITS = 3  # halvings of the bracket once a size misses the deadline

# The sharded path: two files of 2^21 samples on a data 2 x seq 4 mesh
# whose eight shards share the one card (one chunk of 2^19 samples each);
# BatchUpmixer on three files in batches of two.
SHARD_MESH = {"data": 2, "seq": 4}
SHARD_FILES = 2
SHARD_SAMPLES = 2**21
# Phases 19-21: geometries no kernel takes and a custom window.  bench.py's
# config with max_block_size 49152 gives its 0 and 30 Hz bands blocks of
# 49152; at overlap 0.65 the sharded run caps blocks at 2048 (threshold 64:
# the 7680 Hz band gets 512), since sequence sharding refuses bench.py's
# own blocks at that overlap (a frame-grid unit of 1.5e9 samples).
ODD_BLOCK = 49152
SHARD_065 = {"max_block_size": 2048, "threshold_factor": 64.0}
CUSTOM_WINDOW = "kaiser_8"  # np.kaiser(4096, 8.0), registered as a vector
# Phases 22-25: K3s at the pool's hw and at 8192 (its 32768 bucket split);
# the tuner's pool sweep and its offline sweep (bench.py's config on
# 2^23 samples, so that no chunk clamps to the input).
SPECTRAL_HWS = (POOL_HW, 4 * POOL_HW)
TUNE_BATCHES = (1024, 2048)
TUNE_CHUNKS = (2**19, 2**20, 2**21, 2**22)
TUNE_OFFLINE_SAMPLES = 2**23
BATCH_FILES, BATCH_SIZE, BATCH_SAMPLES = 3, 2, 2**20

# NVIDIA H100 SXM at its 700 W limit (the data sheet): FP32 outside the
# tensor cores and HBM3.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# The H100's dense bf16 tensor-core peak (the data sheet), for the edge
# product's share of K3s's design line.
BF16_FLOPS = 989e12
# A kernel's bound may be at most 105% of its time (timing noise).
BOUND_SLACK = 1.05


def bound(flop: float, nbytes: float):
    """(ms, "operations" | "bytes"): the least time for the work on the card."""
    t_op, t_b = flop / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def fft_flop(frames: int, block: int) -> float:
    """Least operations of one bucket's transforms: per frame two forward
    and three inverse real FFTs of length B, 2.5 B log2 B FLOP each (half
    the usual 5 N log2 N of a complex FFT)."""
    return 5 * frames * 2.5 * block * np.log2(block)


def plan_bytes(buckets) -> int:
    """Device bytes of a plan's tensors (windows, gains, tables, weights)."""
    total = 0
    for b in buckets:
        for v in vars(b).values():
            if isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
            elif v is not None and hasattr(v, "__dataclass_fields__"):
                total += sum(t.numel() * t.element_size() for t in vars(v).values() if isinstance(t, torch.Tensor))
    return total


def cufft_inputs(x, b, frames: int):
    """The cuFFT yardstick's inputs for one bucket: the framed, windowed
    rows of x [S, 2, ...] and three masked-spectrum stand-ins."""
    from upmix_tpu_torch.ops.framing import frame_signal

    rows = (frame_signal(x[..., : (frames - 1) * b.hop + b.block], b.block, b.hop, frames)
            * b.analysis_window).contiguous()
    spec = torch.fft.rfft(rows)
    return rows, torch.cat([spec, spec[:, :1]], dim=1).contiguous()


def cufft_ms(rows, spec, block: int) -> float:
    """Time of torch.fft.rfft of the rows plus torch.fft.irfft of the three spectra."""
    return time_ms(lambda: (torch.fft.rfft(rows), torch.fft.irfft(spec, n=block)))


def design_work(plan_buckets, S: int, chunk: int, n_sm: int):
    """(FLOP, bytes) of K1's or K2's own work at their launch geometry
    (`omnibus.launch_geometry`): every frame it computes (the B/H - 1
    recomputed at each block's left edge included), 5 N log2 N FLOP per
    complex FFT of N points (1 forward, 1.5 inverse per frame, 2 when a
    frame's Rs goes alone), the two-stage split's stage-2 sums (8 FLOP per
    complex product), x read per frame, y read and written per pass that
    touches it, the split bucket's partials."""
    from upmix_tpu_torch.ops.omnibus import launch_geometry

    flop = nbytes = 0.0
    for b in plan_buckets:
        B, H, K = b.block, b.hop, b.kept
        Kf, F = B // H, chunk // H
        width = (F + Kf - 1) * H
        geo = launch_geometry(b, F, S, n_sm)
        G = geo.frames
        per_block = -(-(geo.hops + Kf - 1) // G) * G  # frames a block computes
        if b.wide is None:
            frames = geo.blocks * per_block
            flop += frames * 5 * B * np.log2(B) * (1 + (1.5 if G > 1 or geo.pair else 2))
            nbytes += 4 * (frames * 2 * B + 2 * 3 * S * width * (G + Kf - 1) / G)
        else:
            w = b.wide
            flop += S * F * (5 * B * np.log2(w.n1) + 8 * 2 * K * w.n2)
            flop += geo.blocks * per_block * (1.5 * 5 * w.cols * w.n1 * np.log2(w.n1)
                                              + 1.5 * 8 * w.entries.numel() * w.cols)
            nbytes += 4 * S * F * 2 * B + 8 * S * F * w.groups * 2 * K * (1 + geo.blocks * per_block / (S * F))
            nbytes += 4 * 2 * 3 * S * width * Kf
    return flop, nbytes


def exact_zeros(got: torch.Tensor, ref: torch.Tensor):
    """(got is exactly 0 wherever ref is, zeros of got where ref is not,
    ref's largest magnitude there): a pool kernel's exact zeros where its
    plain version has them (not-ready hops).  A ready float32 sample can
    round to exactly 0 by chance (a few in 5e7): counted, not failed."""
    stray = (got == 0) & (ref != 0)
    return (bool((got[ref == 0] == 0).all()), int(stray.sum()),
            float(ref[stray].abs().max()) if bool(stray.any()) else 0.0)


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.double()
    err = float(((ref - got) ** 2).sum())
    return float("inf") if err == 0 else 10.0 * np.log10(float((ref**2).sum()) / err)


def time_ms(fn, loops: int = 7, iters: int = 3) -> float:
    """Min over `loops` of the mean ms per call, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def kernel_rows(fn, iters: int):
    """([(device us, kernel name)], wall us) over `iters` calls of fn, from
    torch.profiler.  Only the kernels' own rows count: an operator's row
    repeats the device time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [
        (e.self_device_time_total, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    return rows, wall_us


def device_share(fn, iters: int = 5) -> str:
    """Device time by kernel and the device's busy share over `iters`
    calls of fn."""
    rows, wall_us = kernel_rows(fn, iters)
    busy = sum(t for t, _ in rows)
    if busy == 0:
        return "no device time recorded (not measured)"
    top = ", ".join(f"{k[:40]} {t / iters / 1e3:.3f} ms" for t, k in sorted(rows, reverse=True)[:8])
    return (f"device busy {busy / iters / 1e3:.3f} ms of {wall_us / iters / 1e3:.3f} ms wall per call "
            f"(idle share {max(0.0, 1 - busy / wall_us):.3f}); {top}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.offline import (
        CHUNK_SAMPLES,
        Upmixer,
        _plan_buckets,
        build_offline_fn,
        plans_from_numpy,
    )
    from upmix_tpu_torch.ops import _build, omnibus
    from upmix_tpu_torch.ops.omnibus import (
        launches_per_bucket,
        make_omnibus_plan,
        omnibus_lcr_batch,
        omnibus_lcr_batch_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln or "spill" in ln]
    print(
        f"build: nvcc {_build.build_seconds:.2f} s, build+load {time.perf_counter() - t0:.2f} s; "
        + " | ".join(ptxas),
        flush=True,
    )

    # 3. kernel parity at the main path's shapes: one 2^21 chunk
    cfg = UpmixConfig.make(BAND_EDGES, sr=SR, max_block_size=MAX_BLOCK)
    t0 = time.perf_counter()
    buckets = plans_from_numpy(_plan_buckets(cfg, CHUNK_SAMPLES), dev)
    plan = make_omnibus_plan(buckets, CHUNK_SAMPLES)
    torch.cuda.synchronize()
    print(f"plan: offline, {len(plan.buckets)} buckets, halo {plan.halo}, {plan_bytes(plan.buckets) / 1e6:.3f} MB "
          f"on the device, built in {time.perf_counter() - t0:.3f} s", flush=True)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        rng.standard_normal((1, 2, CHUNK_SAMPLES + plan.halo)), dtype=torch.float32, device=dev
    )
    worst = float("inf")
    for b in plan.buckets:
        sub = make_omnibus_plan([b], CHUNK_SAMPLES)
        xb = x[..., : CHUNK_SAMPLES + sub.halo].contiguous()
        got = torch.cat(omnibus_lcr_batch(xb, sub), dim=-1)
        ref = torch.cat(omnibus_lcr_batch_plain(xb.double(), sub), dim=-1)
        snrs = [snr_db(ref[:, o], got[:, o]) for o in range(3)]
        worst = min(worst, *snrs)
        print(f"parity bucket B={b.block} H={b.hop} K={b.kept}: "
              + ", ".join(f"{n} {s:.1f} dB" for n, s in zip(OUTPUTS, snrs)), flush=True)
    got = torch.cat(omnibus_lcr_batch(x, plan), dim=-1)
    again = torch.cat(omnibus_lcr_batch(x, plan), dim=-1)
    ref = torch.cat(omnibus_lcr_batch_plain(x.double(), plan), dim=-1)
    torch.cuda.synchronize()
    snrs = [snr_db(ref[:, o], got[:, o]) for o in range(3)]
    max_abs_err = float((got.double() - ref).abs().max())
    repeat = bool(torch.equal(got, again))
    worst = min(worst, *snrs)
    print("parity all buckets: " + ", ".join(f"{n} {s:.1f} dB" for n, s in zip(OUTPUTS, snrs))
          + f", max abs err {max_abs_err:.3e} (bar >= {KERNEL_BAR_DB} dB); two calls bit-identical {repeat}",
          flush=True)
    if not (worst >= KERNEL_BAR_DB):
        fail(f"kernel parity {worst:.1f} dB < {KERNEL_BAR_DB} dB")
    if not repeat:
        fail("two calls of the omnibus kernel on the same input differ")
    del got, again, ref

    # 4. end to end through the user's entry point
    audio = np.random.default_rng(0)  # as bench.py:99-101 builds its input
    L = audio.standard_normal(N_SAMPLES).astype(np.float32)
    R = audio.standard_normal(N_SAMPLES).astype(np.float32)
    up = Upmixer(cfg, device="cuda")
    want = sum(launches_per_bucket(b.block) for b in plan.buckets)
    omnibus.LAUNCHES = 0
    outs = up.process_np(L, R)
    launches = omnibus.LAUNCHES
    print(f"e2e: Upmixer.process_np on {N_SAMPLES} samples, kernel launches {launches} (want {want})", flush=True)
    if launches != want:
        fail(f"the main path launched the omnibus kernels {launches} times, not {want}")
    for o in outs:
        if o.shape != (N_SAMPLES,) or not np.all(np.isfinite(o)):
            fail(f"output shape {o.shape} or non-finite values")
    Ld = torch.as_tensor(L, dtype=torch.float64, device=dev)
    Rd = torch.as_tensor(R, dtype=torch.float64, device=dev)
    ref = build_offline_fn(cfg, N_SAMPLES, chunk=0, device=dev)(Ld, Rd)
    e2e = float("inf")
    for name, r, g in zip(OUTPUTS, ref, outs):
        for s in PROBE_STARTS:
            e2e = min(e2e, snr_db(r[s : s + PROBE_W].cpu(), torch.as_tensor(g[s : s + PROBE_W])))
    del ref, Ld, Rd
    print(f"e2e: worst probe SNR vs float64 whole-file path {e2e:.1f} dB (bar >= {E2E_BAR_DB} dB)",
          flush=True)
    if not (e2e >= E2E_BAR_DB):
        fail(f"end-to-end SNR {e2e:.1f} dB < {E2E_BAR_DB} dB")
    zeros = np.zeros(N_SAMPLES, np.float32)
    silent = max(float(np.abs(o).max()) for o in up.process_np(zeros, zeros))
    _, ls, rs = up.process_np(L, L)
    mono = max(float(np.abs(ls).max()), float(np.abs(rs).max()))
    Lt = torch.as_tensor(L, device=dev)
    Rt = torch.as_tensor(R, device=dev)
    same = all(bool(torch.equal(a, b)) for a, b in zip(up.process(Lt, Rt), up.process(Lt, Rt)))
    print(f"e2e: silence max |out| {silent}, mono max |Ls|,|Rs| {mono:.3e}; two Upmixer.process calls "
          f"bit-identical {same}", flush=True)
    if not same:
        fail("two Upmixer.process calls on the same input differ")
    if silent != 0.0:
        fail("silence in did not give exact zeros out")
    if mono > 1e-5:
        fail(f"mono in gave side energy {mono:.3e} > 1e-5")

    # 5. timing
    audio_s = N_SAMPLES / SR
    whole = build_offline_fn(cfg, N_SAMPLES, chunk=0, device=dev)
    path_ms = time_ms(lambda: up.process(Lt, Rt))
    plain_path_ms = time_ms(lambda: whole(Lt, Rt))
    kernel_ms = time_ms(lambda: omnibus_lcr_batch(x, plan))
    plain_ms = time_ms(lambda: omnibus_lcr_batch_plain(x, plan))
    print(f"timing [{smi}]: kernel path {path_ms:.3f} ms = {audio_s / path_ms * 1e3:.1f}x realtime; "
          f"plain whole-file torch.fft path {plain_path_ms:.3f} ms = "
          f"{audio_s / plain_path_ms * 1e3:.1f}x realtime", flush=True)
    long_n = 4 * N_SAMPLES  # a 3-minute file: 4 segments in one launch per kernel
    Ll = torch.randn(long_n, device=dev, generator=torch.Generator(dev).manual_seed(1))
    Rl = Ll.flip(0)
    long_ms = time_ms(lambda: up.process(Ll, Rl), loops=5, iters=1)
    print(f"timing [{smi}]: kernel path on {long_n} samples (4 segments) {long_ms:.3f} ms = "
          f"{long_n / SR / long_ms * 1e3:.1f}x realtime", flush=True)
    print(f"timing [{smi}]: omnibus kernel {kernel_ms:.3f} ms per 2^21 chunk, "
          f"plain version {plain_ms:.3f} ms", flush=True)
    parts = []
    k1_lib_ms = 0.0
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in plan.buckets:
        sub = make_omnibus_plan([b], CHUNK_SAMPLES)
        xb = x[..., : CHUNK_SAMPLES + sub.halo].contiguous()
        k_ms = time_ms(lambda: omnibus_lcr_batch(xb, sub))
        p_ms = time_ms(lambda: omnibus_lcr_batch_plain(xb, sub))
        rows, spec = cufft_inputs(xb, b, CHUNK_SAMPLES // b.hop)
        c_ms = cufft_ms(rows, spec, b.block)
        del rows, spec
        k1_lib_ms += c_ms
        d_flop, _ = design_work([b], 1, CHUNK_SAMPLES, n_sm)
        parts.append(f"B={b.block} {k_ms:.3f} ms ({d_flop / k_ms / 1e9:.2f} TFLOP/s of its own FFTs, "
                     f"{launches_per_bucket(b.block)} launch(es)) vs plain {p_ms:.3f} ms, cuFFT yardstick {c_ms:.3f} ms")
    print(f"timing [{smi}]: per bucket: " + "; ".join(parts) + f"; cuFFT yardstick over the buckets "
          f"{k1_lib_ms:.3f} ms", flush=True)
    print(f"profile: {device_share(lambda: up.process(Lt, Rt))}", flush=True)

    # K1's bound on one chunk, from the least work of the function: the FFTs
    # of every frame, x read and y written once, gains and windows read.
    k1_flop = sum(fft_flop(CHUNK_SAMPLES // b.hop, b.block) for b in plan.buckets)
    k1_bytes = 4 * (5 * (CHUNK_SAMPLES + plan.halo)
                    + sum(2 * b.block + b.gains.numel() for b in plan.buckets))
    k1_bound, k1_by = bound(k1_flop, k1_bytes)
    print(f"bound [{smi}]: omnibus {k1_flop:.3e} FLOP by FFT, {k1_bytes / 1e9:.3f} GB per chunk -> "
          f"{k1_bound:.3f} ms ({k1_by}); kernel at {k1_bound / kernel_ms:.1%} of it", flush=True)
    # The kernel's own design: its FFTs (recomputed frames included) and bytes at its launch geometry.
    d_flop, d_bytes = design_work(plan.buckets, 1, CHUNK_SAMPLES, n_sm)
    d_bound, d_by = bound(d_flop, d_bytes)
    print(f"design [{smi}]: omnibus FFTs in shared memory {d_flop:.3e} FLOP, {d_bytes / 1e9:.3f} GB -> "
          f"{d_bound:.3f} ms ({d_by}); kernel at {d_bound / kernel_ms:.1%} of it "
          f"({d_flop / kernel_ms / 1e9:.2f} TFLOP/s)", flush=True)
    del x, Lt, Rt, Ll, Rl, up, whole, buckets, plan
    torch.cuda.empty_cache()
    kernels = [{
        "name": "omnibus_lcr",
        "route": "cuda",
        "source": "upmix_tpu_torch/csrc/omnibus.cu",
        "replaces": "upmix_tpu/ops/pallas_omnibus.py:958",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": k1_lib_ms,
    }]
    k2, shard_rtf = sharded_phases(smi, dev)
    kernels.append(k2)
    geometry_phases(smi, dev, audio_s / path_ms * 1e3, shard_rtf)
    kernels += pool_phases(smi, dev)
    kernels.append(spectral_phases(smi, dev))
    mesh_phases(smi, dev)
    distributed_phases(smi, dev, shard_rtf)
    tune_phases(smi, dev)
    kernels += probe_phases(smi, dev)
    app_phases(smi, dev, audio_s / path_ms * 1e3)
    server_phases(smi, dev)
    aot_phases(smi, dev)

    # 9. results.  A kernel faster than its bound means the bound does not
    # bound what was timed (bytes served by L2, say): a fault of this script.
    for k in kernels:
        if k["bound_ms"] > BOUND_SLACK * k["ms"]:
            fail(f"{k['name']} took {k['ms']:.4f} ms, under its bound {k['bound_ms']:.4f} ms")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def sharded_phases(smi: str, dev) -> dict:
    """Phases 10-13 on the sharded and batch offline paths; returns the K2
    result entry."""
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models import BatchUpmixer, Upmixer
    from upmix_tpu_torch.models.offline import build_offline_fn, plans_from_numpy
    from upmix_tpu_torch.ops import fused, omnibus, pool, pool_floor
    from upmix_tpu_torch.ops.fused import fused_bucket_lcr_batch, fused_bucket_lcr_batch_plain
    from upmix_tpu_torch.ops.omnibus import (
        launch_geometry,
        launches_per_bucket,
        make_omnibus_plan,
        omnibus_lcr_batch,
        omnibus_lcr_batch_plain,
    )
    from upmix_tpu_torch.parallel import ShardedUpmixer, make_mesh, sequence_plan
    from upmix_tpu_torch.parallel.sharded import _plan_seq_buckets, route_buckets

    cfg = UpmixConfig.make(BAND_EDGES, sr=SR, max_block_size=MAX_BLOCK)
    splan = sequence_plan(cfg, SHARD_SAMPLES, SHARD_MESH["seq"])
    chunk, S = splan.chunk, SHARD_FILES * SHARD_MESH["seq"]
    t0 = time.perf_counter()
    omni_plan, narrow = route_buckets(plans_from_numpy(_plan_seq_buckets(cfg), dev), chunk)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"sharded plan: mesh {SHARD_MESH} on one card, chunk {chunk} per shard, halo {splan.halo}; "
          f"K2 buckets {[b.block for b in narrow]}, K1 buckets {[b.block for b in omni_plan.buckets]}; "
          f"{plan_bytes(omni_plan.buckets + narrow) / 1e6:.3f} MB on the device (the K2 buckets' "
          f"{plan_bytes(narrow) / 1e6:.3f} MB: windows, gains, FFT twiddles), built in {build_s:.3f} s", flush=True)
    if [b.block for b in narrow] != [4096, 1024, 256] or [b.block for b in omni_plan.buckets] != [65536, 16384]:
        fail("bucket routing differs from 4096/1024/256 -> K2, 65536/16384 -> K1")

    # 10. K2 parity at the sharded geometry: S rows of one chunk each
    rng = np.random.default_rng(4)
    xs = {b.block: torch.as_tensor(rng.standard_normal((S, 2, chunk + b.spill)), dtype=torch.float32,
                                   device=dev) for b in narrow}
    worst, max_abs_err = float("inf"), 0.0
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in narrow:
        x = xs[b.block]
        got = torch.cat(fused_bucket_lcr_batch(x, b), dim=-1)
        again = torch.cat(fused_bucket_lcr_batch(x, b), dim=-1)
        ref = torch.cat(fused_bucket_lcr_batch_plain(x.double(), b), dim=-1)
        torch.cuda.synchronize()
        snrs = [snr_db(ref[:, o], got[:, o]) for o in range(3)]
        err = float((got.double() - ref).abs().max())
        repeat = bool(torch.equal(got, again))
        max_abs_err = max(max_abs_err, err)
        worst = min(worst, *snrs)
        geo = launch_geometry(b, chunk // b.hop, S, n_sm)
        print(f"K2 parity B={b.block} H={b.hop} K={b.kept} (S={S}, chunk {chunk}; G {geo.frames}, pair {geo.pair}, "
              f"T {geo.hops}, {geo.blocks} blocks): " + ", ".join(f"{n} {v:.1f} dB" for n, v in zip(OUTPUTS, snrs))
              + f", max abs err {err:.3e} (bar >= {KERNEL_BAR_DB} dB); two calls bit-identical {repeat}", flush=True)
        if not repeat:
            fail(f"two calls of the fused kernel on bucket {b.block} differ")
    if not (worst >= KERNEL_BAR_DB):
        fail(f"fused kernel parity {worst:.1f} dB < {KERNEL_BAR_DB} dB")
    del again
    del got, ref

    # 11. sharded end to end through the user's entry point
    mesh = make_mesh(SHARD_MESH, devices=[dev] * S)
    su = ShardedUpmixer(cfg, mesh)
    audio = torch.as_tensor(np.random.default_rng(5).standard_normal((SHARD_FILES, 2, SHARD_SAMPLES)),
                            dtype=torch.float32, device=dev)
    su.process_batch(audio)  # device plans built once, outside the count
    torch.cuda.synchronize()
    omnibus.LAUNCHES = fused.LAUNCHES = pool.LAUNCHES = pool_floor.LAUNCHES = 0
    y = su.process_batch(audio)
    torch.cuda.synchronize()
    k2_launches, k1_launches = fused.LAUNCHES, omnibus.LAUNCHES
    print(f"sharded e2e: ShardedUpmixer.process_batch on {SHARD_FILES} x {SHARD_SAMPLES} samples: "
          f"fused kernel launches {k2_launches}, omnibus launches {k1_launches}", flush=True)
    want_k1 = sum(launches_per_bucket(b.block) for b in omni_plan.buckets)
    if k2_launches != len(narrow) or k1_launches != want_k1:
        fail(f"sharded call launched K2 {k2_launches} times (want {len(narrow)}) and K1 {k1_launches} "
             f"(want {want_k1})")
    if y.shape != (SHARD_FILES, 3, SHARD_SAMPLES) or not bool(torch.isfinite(y).all()):
        fail(f"sharded output shape {tuple(y.shape)} or non-finite values")
    up = Upmixer(cfg, device=dev)
    e2e, edge_err = float("inf"), 0.0
    for i in range(SHARD_FILES):
        ref = build_offline_fn(cfg, SHARD_SAMPLES, chunk=0, device=dev)(audio[i, 0].double(), audio[i, 1].double())
        e2e = min(e2e, *(snr_db(r, y[i, o]) for o, r in enumerate(ref)))
        single = torch.stack(up.process(audio[i, 0], audio[i, 1]))
        for q in range(1, SHARD_MESH["seq"]):
            e = q * chunk
            edge_err = max(edge_err, float((single[:, e - 64 : e + 64] - y[i, :, e - 64 : e + 64]).abs().max()))
    del ref, single
    only_data = ShardedUpmixer(cfg, make_mesh({"data": SHARD_MESH["data"]}, devices=[dev] * SHARD_MESH["data"]))
    dp_err = float((only_data.process_batch(audio) - y).abs().max())
    silent = float(su.process_batch(torch.zeros_like(audio)).abs().max())
    print(f"sharded e2e: worst SNR vs float64 whole-file path {e2e:.1f} dB (bar >= {E2E_BAR_DB} dB); "
          f"max |sharded - Upmixer| within 64 samples of the shard edges {edge_err:.3e} (bar < 1e-3); "
          f"data-only mesh max abs diff {dp_err:.3e} (bar < 1e-3); silence max |out| {silent}", flush=True)
    if not (e2e >= E2E_BAR_DB):
        fail(f"sharded end-to-end SNR {e2e:.1f} dB < {E2E_BAR_DB} dB")
    if not (edge_err < 1e-3 and dp_err < 1e-3):
        fail("sharded result differs from Upmixer at a shard edge or from the data-only mesh")
    if silent != 0.0:
        fail("sharded: silence in did not give exact zeros out")
    del only_data

    # 12. BatchUpmixer.process_files, sequential and pipelined
    files = [np.random.default_rng(10 + i).standard_normal((2, BATCH_SAMPLES)).astype(np.float32)
             for i in range(BATCH_FILES)]
    bu = BatchUpmixer(cfg, BATCH_SAMPLES, BATCH_SIZE, device=dev)
    seq = list(bu.process_files(files))
    piped = list(bu.process_files(files, pipeline=True))
    same = len(seq) == len(piped) == BATCH_FILES and all(np.array_equal(a, b) for a, b in zip(seq, piped))
    vs_up = max(float(np.abs(np.stack(up.process_np(f[0], f[1])) - o).max()) for f, o in zip(files, seq))
    print(f"batch e2e: BatchUpmixer.process_files, {BATCH_FILES} files x {BATCH_SAMPLES} samples in batches of "
          f"{BATCH_SIZE}: pipelined == sequential {same}; max |batch - Upmixer| {vs_up:.3e} (bar < 1e-3)",
          flush=True)
    if not same or not (vs_up < 1e-3):
        fail("BatchUpmixer: pipelined and sequential results differ, or they differ from Upmixer")
    del bu, seq, piped, up

    # 13. timing
    audio_s = SHARD_FILES * SHARD_SAMPLES / SR
    path_ms = time_ms(lambda: su.process_batch(audio), loops=5, iters=1)
    print(f"timing [{smi}]: sharded path ({SHARD_MESH} on one card) {path_ms:.3f} ms for {SHARD_FILES} x "
          f"{SHARD_SAMPLES} samples = {audio_s / path_ms * 1e3:.1f}x realtime", flush=True)
    k2_ms = k2_plain_ms = k2_lib_ms = 0.0
    parts = []
    for b in narrow:
        x = xs[b.block]
        sub = make_omnibus_plan([b], chunk)
        t_k2 = time_ms(lambda: fused_bucket_lcr_batch(x, b))
        t_k1 = time_ms(lambda: omnibus_lcr_batch(x, sub))
        t_plain = time_ms(lambda: fused_bucket_lcr_batch_plain(x, b))
        rows, spec = cufft_inputs(x, b, chunk // b.hop)
        t_lib = cufft_ms(rows, spec, b.block)
        del rows, spec
        k2_ms, k2_plain_ms, k2_lib_ms = k2_ms + t_k2, k2_plain_ms + t_plain, k2_lib_ms + t_lib
        d_flop, _ = design_work([b], S, chunk, n_sm)
        parts.append(f"B={b.block} K2 {t_k2:.3f} ms ({d_flop / t_k2 / 1e9:.2f} TFLOP/s of its own FFTs), K1 "
                     f"{t_k1:.3f} ms (K2/K1 {t_k2 / t_k1:.2f}), plain {t_plain:.3f} ms, cuFFT yardstick {t_lib:.3f} ms")
    print(f"timing [{smi}]: per bucket (S={S}, chunk {chunk}): " + "; ".join(parts)
          + f"; cuFFT yardstick over the buckets {k2_lib_ms:.3f} ms", flush=True)
    # K2's bound over its three buckets, from the least work of the function:
    # the FFTs of every frame; x read once per bucket, y written once.
    k2_flop = sum(fft_flop(S * chunk // b.hop, b.block) for b in narrow)
    k2_bytes = 4 * sum(5 * S * (chunk + b.spill) + 2 * b.block + b.gains.numel() for b in narrow)
    k2_bound, k2_by = bound(k2_flop, k2_bytes)
    print(f"bound [{smi}]: fused {k2_flop:.3e} FLOP by FFT, {k2_bytes / 1e9:.3f} GB over its three buckets -> "
          f"{k2_bound:.3f} ms ({k2_by}); kernel {k2_ms:.3f} ms, at {k2_bound / k2_ms:.1%} of it", flush=True)
    # K2's own design: its FFTs (recomputed frames included) and bytes at its launch geometry.
    d_flop, d_bytes = design_work(narrow, S, chunk, n_sm)
    d_bound, d_by = bound(d_flop, d_bytes)
    print(f"design [{smi}]: fused FFTs in shared memory {d_flop:.3e} FLOP, {d_bytes / 1e9:.3f} GB -> "
          f"{d_bound:.3f} ms ({d_by}); kernel at {d_bound / k2_ms:.1%} of it "
          f"({d_flop / k2_ms / 1e9:.2f} TFLOP/s)", flush=True)
    print(f"sharded profile: {device_share(lambda: su.process_batch(audio), iters=3)}", flush=True)
    del su, audio, y, xs
    torch.cuda.empty_cache()
    return {
        "name": "fused_bucket_lcr",
        "route": "cuda",
        "source": "upmix_tpu_torch/csrc/omnibus.cu",
        "replaces": "upmix_tpu/ops/pallas_upmix.py:252",
        "launches": k2_launches,
        "max_abs_err": max_abs_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": k2_lib_ms,
    }, audio_s / path_ms * 1e3


def geometry_phases(smi: str, dev, path_rtf: float, shard_rtf: float):
    """Phases 19-21: the offline geometries no kernel takes and custom
    windows, through the entry points a user calls."""
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models import Upmixer
    from upmix_tpu_torch.models.offline import build_offline_fn
    from upmix_tpu_torch.models.streaming import CudaStreamPool, make_stream_pool
    from upmix_tpu_torch.ops import fused, omnibus, pool
    from upmix_tpu_torch.ops.pool import pool_step_lcr_plain
    from upmix_tpu_torch.ops.windows import register_window_vector
    from upmix_tpu_torch.parallel import ShardedUpmixer, make_mesh, sequence_plan

    audio = np.random.default_rng(0)  # phase 4's input
    L = torch.as_tensor(audio.standard_normal(N_SAMPLES).astype(np.float32), device=dev)
    R = torch.as_tensor(audio.standard_normal(N_SAMPLES).astype(np.float32), device=dev)
    audio_s = N_SAMPLES / SR
    window = register_window_vector(CUSTOM_WINDOW, np.kaiser(4096, 8.0), overwrite=True)

    def offline(label, cfg, want_k1):
        """Upmixer on phase 4's input: K1 launched want_k1 times (K2 never),
        >= 60 dB against the float64 whole-file path at bench.py's probe
        slices; its realtime factor."""
        up = Upmixer(cfg, device=dev)
        omnibus.LAUNCHES = fused.LAUNCHES = 0
        outs = up.process(L, R)
        torch.cuda.synchronize()
        k1, k2 = omnibus.LAUNCHES, fused.LAUNCHES
        if outs[0].shape != (N_SAMPLES,) or not all(bool(torch.isfinite(o).all()) for o in outs):
            fail(f"{label}: output shape {tuple(outs[0].shape)} or non-finite values")
        ref = build_offline_fn(cfg, N_SAMPLES, chunk=0, device=dev)(L.double(), R.double())
        e2e = min(snr_db(r[s : s + PROBE_W], o[s : s + PROBE_W]) for r, o in zip(ref, outs) for s in PROBE_STARTS)
        del ref
        ms = time_ms(lambda: up.process(L, R), loops=5, iters=1)
        blocks = sorted({(b.block_size, b.hop_size) for b in cfg.bands}, reverse=True)
        print(f"{label} [{smi}]: buckets B/H {blocks}; Upmixer K1 launches {k1} (want {want_k1}), K2 {k2}; "
              f"worst probe SNR vs float64 whole-file path {e2e:.1f} dB (bar >= {E2E_BAR_DB} dB); {ms:.3f} ms = "
              f"{audio_s / ms * 1e3:.1f}x realtime (phase 5's kernel path {path_rtf:.1f}x)", flush=True)
        if (k1, k2) != (want_k1, 0):
            fail(f"{label}: K1 launched {k1} times (want {want_k1}), K2 {k2} (want 0)")
        if not (e2e >= E2E_BAR_DB):
            fail(f"{label}: SNR {e2e:.1f} dB < {E2E_BAR_DB} dB")
        torch.cuda.empty_cache()

    # 19. offline: hop not dividing the block, blocks that are not powers
    # of two (the whole-file torch.fft program), and a custom window (K1).
    offline("offline overlap 0.65", UpmixConfig.make(BAND_EDGES, sr=SR, max_block_size=MAX_BLOCK, overlap=0.65), 0)
    offline(f"offline max_block_size {ODD_BLOCK}", UpmixConfig.make(BAND_EDGES, sr=SR, max_block_size=ODD_BLOCK), 0)
    bench_k1 = 6  # phase 4's launches: one a bucket, two for 65536
    offline(f"offline custom window {window}", UpmixConfig.make(BAND_EDGES, sr=SR, max_block_size=MAX_BLOCK,
                                                                window=window), bench_k1)

    # 20. sharded at overlap 0.65.  bench.py's config is refused there by
    # both packages (its frame-grid unit is lcm(65536, 22937) = 1.5e9
    # samples); blocks capped at 2048 keep the unit at 366,592.
    try:
        sequence_plan(UpmixConfig.make(BAND_EDGES, sr=SR, max_block_size=MAX_BLOCK, overlap=0.65), SHARD_SAMPLES, 4)
        fail("sequence_plan accepted bench.py's config at overlap 0.65")
    except ValueError as e:
        print(f"sharded overlap 0.65: bench.py's config refused as the JAX package refuses it: {str(e)[:90]}",
              flush=True)
    cfg = UpmixConfig.make(BAND_EDGES, sr=SR, overlap=0.65, **SHARD_065)
    mesh = make_mesh(SHARD_MESH, devices=[dev] * (SHARD_FILES * SHARD_MESH["seq"]))
    su = ShardedUpmixer(cfg, mesh)
    chunk = sequence_plan(cfg, SHARD_SAMPLES, SHARD_MESH["seq"]).chunk
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((SHARD_FILES, 2, SHARD_SAMPLES)),
                        dtype=torch.float32, device=dev)
    omnibus.LAUNCHES = fused.LAUNCHES = 0
    y = su.process_batch(x)
    torch.cuda.synchronize()
    k1, k2 = omnibus.LAUNCHES, fused.LAUNCHES
    up = Upmixer(cfg, device=dev)
    e2e, edge_err = float("inf"), 0.0
    for i in range(SHARD_FILES):
        ref = build_offline_fn(cfg, SHARD_SAMPLES, chunk=0, device=dev)(x[i, 0].double(), x[i, 1].double())
        e2e = min(e2e, *(snr_db(r, y[i, o]) for o, r in enumerate(ref)))
        single = torch.stack(up.process(x[i, 0], x[i, 1]))
        for e in range(chunk, SHARD_SAMPLES, chunk):
            edge_err = max(edge_err, float((single[:, e - 64 : e + 64] - y[i, :, e - 64 : e + 64]).abs().max()))
    del ref, single
    ms = time_ms(lambda: su.process_batch(x), loops=3, iters=1)
    blocks = sorted({(b.block_size, b.hop_size) for b in cfg.bands}, reverse=True)
    print(f"sharded overlap 0.65 [{smi}]: bench.py's edges, {SHARD_065}, buckets B/H {blocks}, chunk {chunk} per "
          f"shard; K1 launches {k1}, K2 {k2} (want 0, 0); worst SNR vs float64 whole-file path {e2e:.1f} dB "
          f"(bar >= {E2E_BAR_DB} dB); max |sharded - Upmixer| within 64 samples of the shard edges {edge_err:.3e} "
          f"(bar < 1e-3); {ms:.3f} ms = {SHARD_FILES * SHARD_SAMPLES / SR / ms * 1e3:.1f}x realtime "
          f"(phase 13's kernel path {shard_rtf:.1f}x)", flush=True)
    if (k1, k2) != (0, 0) or not (e2e >= E2E_BAR_DB) or not (edge_err < 1e-3):
        fail("sharded overlap 0.65: a kernel launched, or SNR or shard edges off")
    del su, up, x, y
    torch.cuda.empty_cache()

    # 21. the serving pool with a custom window: make_stream_pool must be
    # the CUDA pool and launch K3; >= 60 dB against a float64 run of the
    # plain step.
    cfg = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=POOL_HW, window=window)
    S, hw = POOL_STREAMS, POOL_HW
    sp = make_stream_pool(cfg, hw, S)
    if type(sp) is not CudaStreamPool:
        fail(f"make_stream_pool with a custom window gave {type(sp).__name__}, not CudaStreamPool")
    plan = sp.plan
    blocks = torch.randn((POOL_BLOCKS, 2, S, hw), device=dev, generator=torch.Generator(dev).manual_seed(3))
    pool.LAUNCHES = 0
    outs = torch.stack([torch.stack(sp.push_blocks(b[0], b[1])) for b in blocks])  # [T, 3, S, hw]
    torch.cuda.synchronize()
    k3 = pool.LAUNCHES
    got = outs.permute(2, 1, 0, 3).reshape(S, 3, -1)
    K, warm = plan.warmup, (plan.warmup - 1) * hw
    silent = not bool((got[..., :warm] != 0).any())
    # The float64 reference on every 32nd stream (streams are independent):
    # all blocks in one call of the plain step, the history from zeros.
    rows = torch.arange(0, S, 32, device=dev)
    n = len(rows)
    h = torch.cat([blocks.new_zeros((n, 2, warm)), blocks[:, :, rows].permute(2, 1, 0, 3).reshape(n, 2, -1)], -1)
    ref, _ = pool_step_lcr_plain(h.double(), torch.ones(n, dtype=torch.int32, device=dev),
                                 [h.new_zeros((n, 3, b.block), dtype=torch.float64) for b in plan.buckets],
                                 plan, POOL_BLOCKS)
    e2e = snr_db(ref[..., warm:], got[rows][..., warm:])
    print(f"pool custom window {window}: CudaStreamPool, {POOL_BLOCKS} blocks x {S} streams, K3 launches {k3}; "
          f"SNR vs float64 plain step (every 32nd stream) {e2e:.1f} dB (bar >= {E2E_BAR_DB} dB); warmup blocks "
          f"exact zeros {silent}", flush=True)
    if k3 == 0 or not (e2e >= E2E_BAR_DB) or not silent:
        fail("pool with a custom window: K3 not launched, SNR below the bar or warmup not silent")
    del sp, blocks, outs, h, ref, got
    torch.cuda.empty_cache()


def pool_phases(smi: str, dev) -> list:
    """Phases 6-8 on the serving pool; returns the K3 and K6 result entries."""
    import dataclasses

    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.streaming import CudaStreamPool, StreamingUpmixer, make_stream_pool
    from upmix_tpu_torch.ops import omnibus, pool, pool_floor
    from upmix_tpu_torch.ops.omnibus import launch_geometry
    from upmix_tpu_torch.ops.pool import launches_per_bucket, make_pool_plan, pool_step_lcr, pool_step_lcr_plain
    from upmix_tpu_torch.ops.pool_floor import floor_bytes, pool_floor_plain

    cfg = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=POOL_HW)
    S, hw = POOL_STREAMS, POOL_HW
    t0 = time.perf_counter()
    plan = make_pool_plan(cfg, hw, S, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    K = plan.warmup
    per_block = sum(launches_per_bucket(b.block) for b in plan.buckets)
    print("pool plan: " + ", ".join(f"B={b.block} H={b.hop} P={b.passes} K={b.kept}" for b in plan.buckets)
          + f"; warmup {K} blocks, window {plan.window}; {plan_bytes(plan.buckets) / 1e6:.3f} MB on the device, "
          f"built in {build_s:.3f} s", flush=True)
    rng = np.random.default_rng(1)

    def inputs(hops, ready_only=False):
        hist = torch.as_tensor(rng.standard_normal((S, 2, (K - 1 + hops) * hw)), dtype=torch.float32,
                               device=dev)
        low = K if ready_only else 1
        t = torch.as_tensor(rng.integers(low, K + 4, S), dtype=torch.int32, device=dev)
        carries = [torch.as_tensor(rng.standard_normal((S, 3, b.block)) * 0.1, dtype=torch.float32,
                                   device=dev) for b in plan.buckets]
        return hist, t, carries

    # 6. kernel parity: K3 against its plain version in float64, then K6
    worst, max_abs_err = float("inf"), 0.0
    for hops in (1, 4):
        hist, t, carries = inputs(hops)
        for b, c in zip(plan.buckets, carries):
            sub = dataclasses.replace(plan, buckets=(b,))
            got, got_c = pool_step_lcr(hist, t, [c], sub, hops)
            ref, ref_c = pool_step_lcr_plain(hist.double(), t, [c.double()], sub, hops)
            snrs = [snr_db(ref[:, o], got[:, o]) for o in range(3)] + [snr_db(ref_c[0], got_c[0])]
            worst = min(worst, *snrs)
            print(f"pool parity hops={hops} bucket B={b.block} H={b.hop}: "
                  + ", ".join(f"{n} {v:.1f} dB" for n, v in zip((*OUTPUTS, "carry"), snrs)), flush=True)
        got, got_c = pool_step_lcr(hist, t, carries, plan, hops)
        ref, ref_c = pool_step_lcr_plain(hist.double(), t, [c.double() for c in carries], plan, hops)
        torch.cuda.synchronize()
        snrs = [snr_db(ref[:, o], got[:, o]) for o in range(3)]
        snrs += [snr_db(r, g) for r, g in zip(ref_c, got_c)]
        zeros_agree, n_stray, stray_ref = exact_zeros(got, ref)
        err = float((got.double() - ref).abs().max())
        max_abs_err = max(max_abs_err, err)
        worst = min(worst, *snrs)
        print(f"pool parity hops={hops} all buckets: "
              + ", ".join(f"{n} {v:.1f} dB" for n, v in zip(OUTPUTS, snrs[:3]))
              + ", carries " + ", ".join(f"{v:.1f}" for v in snrs[3:])
              + f" dB, max abs err {err:.3e}, exact zeros where the plain version has them {zeros_agree} "
              f"(zeros elsewhere {n_stray}, the reference there at most {stray_ref:.1e}) "
              f"(bar >= {KERNEL_BAR_DB} dB)",
              flush=True)
        if not zeros_agree:
            fail("pool kernel's exact zeros differ from its plain version's")
    if not (worst >= KERNEL_BAR_DB):
        fail(f"pool kernel parity {worst:.1f} dB < {KERNEL_BAR_DB} dB")
    del hist, t, carries, got, got_c, ref, ref_c
    window = torch.randn((S, 2, plan.window), device=dev, generator=torch.Generator(dev).manual_seed(2))
    floor_err = {"copy": 0.0, "frame": 0.0}
    # K6 at the pool's stream counts and at the window of hw 2048 and 4096.
    for f_hw in (hw, 2 * hw):
        f_cfg = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=f_hw)
        for f_S in FLOOR_STREAMS:
            f_plan = make_pool_plan(f_cfg, f_hw, f_S, device=dev)
            f_hist = torch.randn((f_S, 2, f_plan.window), device=dev,
                                 generator=torch.Generator(dev).manual_seed(f_S + f_hw))
            for mode in ("copy", "frame"):
                got_f = pool_floor.pool_floor(f_hist, f_hw, mode, f_plan)
                ref_f = pool_floor_plain(f_hist, f_hw, mode, f_plan)
                same = torch.equal(got_f, ref_f)
                floor_err[mode] = max(floor_err[mode], float((got_f - ref_f).abs().max()))
                print(f"floor parity {mode} S={f_S} hw={f_hw} window={f_plan.window}: bit-exact {same}", flush=True)
                if not same:
                    fail(f"floor kernel ({mode}, S={f_S}, hw={f_hw}) differs from its plain version")
    del f_hist, got_f, ref_f

    # 7. end to end through the user's entry point
    blocks = torch.randn((POOL_BLOCKS, 2, S, hw), device=dev, generator=torch.Generator(dev).manual_seed(3))
    sp = make_stream_pool(cfg, hw, S)
    if type(sp) is not CudaStreamPool:
        fail(f"make_stream_pool gave {type(sp).__name__}, not CudaStreamPool")
    omnibus.LAUNCHES = pool.LAUNCHES = pool_floor.LAUNCHES = 0
    outs = [torch.stack(sp.push_blocks(b[0], b[1])) for b in blocks]
    torch.cuda.synchronize()
    k3_launches = pool.LAUNCHES
    print(f"pool e2e: CudaStreamPool, {POOL_BLOCKS} blocks x {S} streams, pool kernel launches "
          f"{k3_launches} (want {POOL_BLOCKS * per_block}), omnibus launches {omnibus.LAUNCHES}", flush=True)
    if k3_launches != POOL_BLOCKS * per_block or omnibus.LAUNCHES:
        fail(f"the serving pool launched K3 {k3_launches} times (want {POOL_BLOCKS * per_block}) "
             f"and K1 {omnibus.LAUNCHES} times (want 0)")
    hist64 = torch.zeros((S, 2, (K - 1) * hw), dtype=torch.float64, device=dev)
    carries64 = [torch.zeros((S, 3, b.block), dtype=torch.float64, device=dev) for b in plan.buckets]
    e2e = float("inf")
    for i, (b, out) in enumerate(zip(blocks, outs)):
        h = torch.cat([hist64, b.transpose(0, 1).double()], dim=-1)
        t = torch.full((S,), i + 1, dtype=torch.int32, device=dev)
        ref, carries64 = pool_step_lcr_plain(h, t, carries64, plan)
        hist64 = h[..., hw:]
        if not torch.isfinite(out).all() or out.shape != (3, S, hw):
            fail(f"pool block {i}: shape {tuple(out.shape)} or non-finite values")
        if i < K - 1:
            if bool((out != 0).any()):
                fail(f"pool block {i} is not silent during warmup")
        else:
            e2e = min(e2e, snr_db(ref.transpose(0, 1), out))
    print(f"pool e2e: warmup blocks 0..{K - 2} exact zeros; worst block SNR vs float64 plain step "
          f"{e2e:.1f} dB (bar >= {E2E_BAR_DB} dB)", flush=True)
    if not (e2e >= E2E_BAR_DB):
        fail(f"pool end-to-end SNR {e2e:.1f} dB < {E2E_BAR_DB} dB")
    snap = sp.snapshot()
    a = torch.stack(sp.push_blocks(blocks[0, 0], blocks[0, 1]))
    sp.restore(snap)
    slot = S // 2
    sp.reset_streams([slot])
    b = torch.stack(sp.push_blocks(blocks[0, 0], blocks[0, 1]))
    others = [s for s in range(S) if s != slot]
    churn_ok = bool(torch.equal(a[:, others], b[:, others])) and not bool((b[:, slot] != 0).any())
    sp.reset()
    zero = torch.zeros((S, hw), device=dev)
    silent = max(float(torch.stack(sp.push_blocks(zero, zero)).abs().max()) for _ in range(K + 1))
    sp.reset()
    mono = 0.0
    for blk in blocks[: K + 2]:
        _, ls, rs = sp.push_blocks(blk[0], blk[0])
        mono = max(mono, float(ls.abs().max()), float(rs.abs().max()))
    print(f"pool e2e: reset_streams re-warms slot {slot}, others bit-identical {churn_ok}; silence max |out| "
          f"{silent}, mono max |Ls|,|Rs| {mono:.3e}", flush=True)
    if not churn_ok:
        fail("reset_streams touched other streams or did not re-warm the slot")
    if silent != 0.0:
        fail("pool: silence in did not give exact zeros out")
    if mono > 1e-5:
        fail(f"pool: mono in gave side energy {mono:.3e} > 1e-5")
    # The floor probe's own run, in both modes as bench_pool_floor.py:129-133
    # runs them: the probe scan, history shift then K6, over the same blocks.
    k6_launches = {}
    for mode in ("copy", "frame"):
        pool_floor.LAUNCHES = 0
        h = torch.zeros((S, 2, (K - 1) * hw), device=dev)
        for blk in blocks:
            full = torch.cat([h, blk.transpose(0, 1)], dim=-1)
            pool_floor.pool_floor(full, hw, mode, plan)
            h = full[..., hw:]
        torch.cuda.synchronize()
        k6_launches[mode] = pool_floor.LAUNCHES
        print(f"floor probe run ({mode}): {POOL_BLOCKS} blocks, floor kernel launches {k6_launches[mode]}", flush=True)
        if k6_launches[mode] == 0:
            fail(f"the floor probe ({mode}) launched no floor kernel")
    # The single-stream engine on the card goes through the pool kernel too.
    pool.LAUNCHES = 0
    sig = blocks[:, :, 0].permute(1, 0, 2).reshape(2, POOL_BLOCKS * hw)  # stream 0's blocks
    one = torch.stack(StreamingUpmixer(cfg, hw).process_signal(sig[0], sig[1]))
    torch.cuda.synchronize()
    one_launches = pool.LAUNCHES
    h = torch.cat([sig.new_zeros((2, (K - 1) * hw)), sig], dim=-1)[None].double()
    ref, _ = pool_step_lcr_plain(h, torch.ones(1, dtype=torch.int32, device=dev),
                                 [h.new_zeros((1, 3, b.block)) for b in plan.buckets], plan, POOL_BLOCKS)
    one_snr = snr_db(ref[0], one)
    print(f"stream e2e: StreamingUpmixer.process_signal, {POOL_BLOCKS} blocks: pool kernel launches "
          f"{one_launches}; SNR vs float64 plain step {one_snr:.1f} dB (bar >= {E2E_BAR_DB} dB)", flush=True)
    if one_launches == 0:
        fail("StreamingUpmixer on the card launched no pool kernel")
    if bool((one[:, : (K - 1) * hw] != 0).any()) or not (one_snr >= E2E_BAR_DB):
        fail(f"StreamingUpmixer: warmup not silent or SNR {one_snr:.1f} dB < {E2E_BAR_DB} dB")
    del sp, outs, hist64, carries64, snap, one, ref, h

    # 8. timing
    deadline_ms = hw / POOL_SR * 1e3

    def sustained(n_streams, hops=1, n_blocks=POOL_BLOCKS):
        """(ms per block, device bytes per stream) of the sustained runner
        over n_blocks blocks, every stream past its warmup (the bytes
        include the runner's inputs and outputs)."""
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tp = CudaStreamPool(cfg, hw, n_streams, device=dev)
        run, fresh = tp.make_sustained_runner(n_blocks, hops=hops)
        rows = torch.arange(n_streams, device=dev) % S  # streams beyond S repeat the seeded noise
        slabs = (blocks[:n_blocks, :, rows].reshape(n_blocks // hops, hops, 2, n_streams, hw)
                 .permute(0, 2, 3, 1, 4).reshape(n_blocks // hops, 2, n_streams, hops * hw).contiguous())
        state, _ = run(fresh(), slabs)  # every stream past its warmup blocks
        ms = time_ms(lambda: run(state, slabs), loops=5, iters=1) / n_blocks
        per_stream = (torch.cuda.max_memory_allocated() - base) / n_streams
        del tp, run, state, slabs
        ms_line = (f"pool timing [{smi}]: S={n_streams} hops={hops} ({n_blocks} blocks a call): {ms:.3f} ms per block, "
                   f"meets the {deadline_ms:.2f} ms deadline {ms <= deadline_ms}; throughput "
                   f"S x deadline / (ms per block) = {n_streams * deadline_ms / ms:.0f} streams, "
                   f"extrapolated from S={n_streams}; peak device memory {per_stream * n_streams / 1e9:.2f} GB")
        print(ms_line, flush=True)
        return ms, per_stream

    for n_streams, hops in ((16, 1), (S, 1), (S, 4), *((n, 1) for n in POOL_CAPACITY_STREAMS)):
        ms, per_stream = sustained(n_streams, hops)
    # Capacity by measurement: double S past the last size until a block
    # misses the deadline (runs of SWEEP_BLOCKS blocks; a size that would
    # pass 40 GB is cut to the largest that does not), then halve the
    # bracket SWEEP_SPLITS times.
    met, n_streams = (POOL_CAPACITY_STREAMS[-1] if ms <= deadline_ms else 0), POOL_CAPACITY_STREAMS[-1]
    missed = None if ms <= deadline_ms else n_streams
    per_stream *= 1.5  # SWEEP_BLOCKS blocks take less than POOL_BLOCKS; a margin for the estimate all the same
    while missed is None:
        # Twice the size, or the largest that stays inside the memory cap.
        n_streams = min(2 * n_streams, int(POOL_MEMORY_CAP / per_stream) // 512 * 512)
        if n_streams <= met:
            print(f"pool capacity: a pool past S={met} would take more than {POOL_MEMORY_CAP / 1e9:.0f} GB: "
                  "stop", flush=True)
            break
        ms, per_stream = sustained(n_streams, n_blocks=SWEEP_BLOCKS)
        if ms <= deadline_ms:
            met = n_streams
        else:
            missed = n_streams
    for _ in range(SWEEP_SPLITS if missed else 0):
        mid = (met + missed) // 2 // 512 * 512
        if mid <= met:
            break
        ms, _ = sustained(mid, n_blocks=SWEEP_BLOCKS)
        met, missed = (mid, missed) if ms <= deadline_ms else (met, mid)
    print(f"pool capacity [{smi}]: largest S measured to meet the {deadline_ms:.2f} ms deadline {met}; "
          f"smallest S measured to miss it {missed}", flush=True)
    hist, t, carries = inputs(1, ready_only=True)
    k3_ms = time_ms(lambda: pool_step_lcr(hist, t, carries, plan))
    k3_plain_ms = time_ms(lambda: pool_step_lcr_plain(hist, t, carries, plan))
    k3_lib_ms = 0.0
    # K3's bound per block, from the least work of the function: the FFTs of
    # every frame; the history read, the carries read and written, the
    # outputs written and t, gains and windows read once.
    k3_flop = sum(fft_flop(S * b.passes, b.block) for b in plan.buckets)
    k3_bytes = 4 * (S * 2 * K * hw + 2 * S * 3 * sum(b.block for b in plan.buckets) + S * 3 * hw + S
                    + sum(2 * b.block + b.gains.numel() for b in plan.buckets))
    k3_bound, k3_by = bound(k3_flop, k3_bytes)
    print(f"timing [{smi}]: pool kernel (S={S}, hops=1, all ready) {k3_ms:.3f} ms, plain version "
          f"{k3_plain_ms:.3f} ms; bound {k3_bound:.3f} ms ({k3_by}: {k3_flop:.3e} FLOP by FFT, "
          f"{k3_bytes / 1e9:.3f} GB), kernel at {k3_bound / k3_ms:.1%} of it", flush=True)

    def design_flop(b):
        # Its own FFTs: 1 forward and 1.5 inverse per frame (2 when a frame's
        # Rs goes alone), G frames a pass, at the pool's launch geometry.
        geo = launch_geometry(b, b.passes, S, None, b.passes + b.block // b.hop)
        G = geo.frames
        return S * -(-b.passes // G) * G * 5 * b.block * np.log2(b.block) * (1 + (1.5 if G > 1 or geo.pair else 2))

    d_flop = sum(design_flop(b) for b in plan.buckets)
    d_bytes = k3_bytes + 4 * S * 2 * sum(b.passes * (b.block - b.hop) for b in plan.buckets)  # frames re-read
    d_bound, d_by = bound(d_flop, d_bytes)
    print(f"design [{smi}]: pool FFTs in shared memory {d_flop:.3e} FLOP, {d_bytes / 1e9:.3f} GB -> "
          f"{d_bound:.3f} ms ({d_by}); kernel at {d_bound / k3_ms:.1%} of it "
          f"({d_flop / k3_ms / 1e9:.2f} TFLOP/s)", flush=True)
    parts = []
    for b, c in zip(plan.buckets, carries):
        sub = dataclasses.replace(plan, buckets=(b,))
        b_ms = time_ms(lambda: pool_step_lcr(hist, t, [c], sub))
        b_plain = time_ms(lambda: pool_step_lcr_plain(hist, t, [c], sub))
        rows, spec = cufft_inputs(hist, b, b.passes)
        c_ms = cufft_ms(rows, spec, b.block)
        del rows, spec
        k3_lib_ms += c_ms
        parts.append(f"B={b.block} {b_ms:.3f} ms ({design_flop(b) / b_ms / 1e9:.2f} TFLOP/s of its own FFTs) "
                     f"vs plain {b_plain:.3f} ms, cuFFT yardstick {c_ms:.3f} ms")
    print(f"timing [{smi}]: pool kernel per bucket: " + "; ".join(parts)
          + f"; cuFFT yardstick over the buckets {k3_lib_ms:.3f} ms", flush=True)
    x = blocks[0].transpose(0, 1).contiguous()
    h = hist[..., hw:].contiguous()
    shift_ms = time_ms(lambda: torch.cat([h, x], dim=-1))
    print(f"timing [{smi}]: history shift (cat of [{S}, 2, {(K - 1) * hw}] and the block) "
          f"{shift_ms:.3f} ms", flush=True)
    # K6 in both modes, beside one PyTorch call that reads the whole history
    # and writes [S, 2, hw] (`pool_floor.library_call`, timed only; its
    # bytes are not quite K6's, so its own share is shown).
    floor = {}
    nbytes = floor_bytes(S, plan.window, hw)
    lib_bytes = 4 * S * 2 * (plan.window + hw)
    lib_ms = time_ms(lambda: pool_floor.library_call(window, hw), loops=20, iters=10)
    for mode in ("copy", "frame"):
        f_ms = time_ms(lambda: pool_floor.pool_floor(window, hw, mode, plan), loops=20, iters=10)
        f_plain = time_ms(lambda: pool_floor_plain(window, hw, mode, plan), loops=20, iters=10)
        # Operations: the three outputs' adds (copy: one a sample; frame: a
        # sum over the buckets and two more), against bytes at HBM rate.
        n_adds = 1 if mode == "copy" else len(plan.buckets) + 1
        f_bound, f_by = bound(S * hw * n_adds, nbytes)
        floor[mode] = (f_ms, f_plain, f_bound, f_by)
        print(f"timing [{smi}]: floor {mode} (S={S}, window {plan.window}, hw {hw}) {f_ms * 1e3:.2f} us, plain version "
              f"{f_plain * 1e3:.2f} us; bound {f_bound * 1e3:.2f} us ({f_by}: {nbytes / 1e6:.1f} MB), kernel at "
              f"{f_bound / f_ms:.1%} of it; same-bytes call (sum over the history's hw-long pieces, "
              f"{lib_bytes / 1e6:.1f} MB) {lib_ms * 1e3:.2f} us, at {lib_bytes / HBM_BYTES_PER_S / lib_ms * 1e3:.1%} "
              f"of its own bytes' bound", flush=True)
    for n_streams in (16, S):
        tp = CudaStreamPool(cfg, hw, n_streams, device=dev)
        run, fresh = tp.make_sustained_runner(POOL_BLOCKS)
        state = fresh()
        slabs = blocks[:, :, :n_streams].contiguous()
        print(f"pool profile (S={n_streams}, {POOL_BLOCKS} blocks per call): "
              f"{device_share(lambda: run(state, slabs), iters=2)}", flush=True)

    return [
        {
            "name": "pool_step_lcr",
            "route": "cuda",
            "source": "upmix_tpu_torch/csrc/pool.cu",
            "replaces": "upmix_tpu/ops/pallas_pool.py:579",
            "launches": k3_launches,
            "max_abs_err": max_abs_err,
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound,
            "bound_by": k3_by,
            "library_ms": k3_lib_ms,
        },
    ] + [
        {
            "name": f"pool_floor_{mode}",
            "route": "cuda",
            "source": "upmix_tpu_torch/csrc/pool.cu",
            "replaces": "scripts/bench_pool_floor.py:53",
            "launches": k6_launches[mode],
            "max_abs_err": floor_err[mode],
            "ms": floor[mode][0],
            "plain_ms": floor[mode][1],
            "bound_ms": floor[mode][2],
            "bound_by": floor[mode][3],
            "library_ms": lib_ms,
        }
        for mode in ("copy", "frame")
    ]


def edge_everywhere(plan):
    """The spectral plan with every bucket whose frames overlap (Kr > 1)
    sending its edge frames to the product, its split weight built: the
    product on any geometry, for holding it against its plain version and
    timing it against the FFT route."""
    import dataclasses

    from upmix_tpu_torch.ops.pool import make_edge_weight, split_edge_weight

    buckets = []
    for b in plan.buckets:
        if b.overlap > 1 and not b.edge_product:
            w = make_edge_weight(b.block, b.lo, b.kept, b.analysis_window.cpu().numpy(),
                                 b.synthesis_window.cpu().numpy())
            b = dataclasses.replace(b, edge_product=True,
                                    edge_weight=split_edge_weight(w).to(b.analysis_window.device))
        buckets.append(b)
    return dataclasses.replace(plan, buckets=tuple(buckets))


def host_ms(fn, calls: int = 20, loops: int = 5) -> float:
    """Min over `loops` of the host's ms per call of fn, issued `calls`
    times in a row with no synchronisation (the card drains the queue
    between loops): what a call costs the host where the card keeps up."""
    fn()
    best = float("inf")
    for _ in range(loops):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return best


def spectral_phases(smi: str, dev) -> dict:
    """Phases 22-23 on the pool's spectral OLA (K3s); returns its result entry."""
    import dataclasses

    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.streaming import CudaStreamPool, make_stream_pool
    from upmix_tpu_torch.ops import pool
    from upmix_tpu_torch.ops.pool import (
        make_pool_plan,
        pool_step_lcr,
        pool_step_spectral_plain,
        spectral_edge,
        spectral_edge_plain,
        spectral_forward,
        spectral_launches,
        spectral_pass,
        spectral_whole,
    )

    # 22. K3s parity against its float64 plain version, and against K3;
    # its edge product alone, each bucket's edge frames forced onto it.
    worst, max_abs_err = float("inf"), 0.0
    edge_worst = float("inf")
    for hw in SPECTRAL_HWS:
        cfg_h = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=hw)
        for S in FLOOR_STREAMS:
            plan = make_pool_plan(cfg_h, hw, S, device=dev, ola="spectral")
            tplan = make_pool_plan(cfg_h, hw, S, device=dev)
            K = plan.warmup
            rng = np.random.default_rng(S + hw)
            for hops in (1, 4):
                hist = torch.as_tensor(rng.standard_normal((S, 2, (K - 1 + hops) * hw)), dtype=torch.float32,
                                       device=dev)
                t = torch.as_tensor(rng.integers(1, K + 4, S), dtype=torch.int32, device=dev)
                carries = [torch.as_tensor(rng.standard_normal(b.spectral_carry_shape(S)) * 0.1, dtype=torch.float32,
                                           device=dev) for b in plan.buckets]
                specs, _ = spectral_forward(hist, t, carries, plan, hops)
                forced = edge_everywhere(plan)
                line = []
                for i, b in enumerate(forced.buckets):
                    sub = dataclasses.replace(forced, buckets=(b,))
                    got = spectral_edge([carries[i]], [specs[i]], t, sub, hops)
                    again = spectral_edge([carries[i]], [specs[i]], t, sub, hops)
                    ref = spectral_edge_plain([carries[i].double()], [specs[i].double()], t, sub, hops)
                    torch.cuda.synchronize()
                    zeros_agree = bool((got[ref == 0] == 0).all())
                    v = snr_db(ref, got) if bool((ref != 0).any()) else float("inf")
                    edge_worst = min(edge_worst, v)
                    line.append(f"B={b.block} {v:.1f} dB")
                    if not zeros_agree or not torch.equal(got, again):
                        fail(f"the edge product (B={b.block}) is not exact zeros where its plain version is, or two "
                             f"calls differ")
                    del got, again, ref
                print(f"K3s edge product hw={hw} S={S} hops={hops} (every bucket's edge frames on it): "
                      + ", ".join(line) + "; zeros and two calls bit for bit", flush=True)
                del specs, forced
                if S == POOL_STREAMS:
                    for b, c in zip(plan.buckets, carries):
                        sub = dataclasses.replace(plan, buckets=(b,))
                        got, got_c = pool_step_lcr(hist, t, [c], sub, hops)
                        ref, ref_c = pool_step_spectral_plain(hist.double(), t, [c.double()], sub, hops)
                        snrs = [snr_db(ref[:, o], got[:, o]) for o in range(3)]
                        snrs += [snr_db(ref_c[0], got_c[0])] if b.overlap > 1 else []
                        worst = min(worst, *snrs)
                        print(f"K3s parity hw={hw} S={S} hops={hops} bucket B={b.block} H={b.hop} K={b.kept}"
                              f"{' (split)' if b.wide is not None else ''}: "
                              + ", ".join(f"{n} {v:.1f} dB" for n, v in zip((*OUTPUTS, "carry"), snrs)), flush=True)
                got, got_c = pool_step_lcr(hist, t, carries, plan, hops)
                again, again_c = pool_step_lcr(hist, t, carries, plan, hops)
                ref, ref_c = pool_step_spectral_plain(hist.double(), t, [c.double() for c in carries], plan, hops)
                torch.cuda.synchronize()
                snrs = [snr_db(ref[:, o], got[:, o]) for o in range(3)]
                snrs += [snr_db(r, g) for b, r, g in zip(plan.buckets, ref_c, got_c) if b.overlap > 1]
                repeat = bool(torch.equal(got, again)) and all(torch.equal(a, b) for a, b in zip(got_c, again_c))
                zeros_agree, n_stray, stray_ref = exact_zeros(got, ref)
                err = float((got.double() - ref).abs().max())
                max_abs_err = max(max_abs_err, err)
                worst = min(worst, *snrs)
                del ref, ref_c, again, again_c
                # The two dataflows compute one function: from a fresh state,
                # every stream ready, K3s's output against K3's.
                ready = torch.full((S,), K + 1, dtype=torch.int32, device=dev)
                spec0 = [torch.zeros(b.spectral_carry_shape(S), device=dev) for b in plan.buckets]
                time0 = [torch.zeros((S, 3, b.block), device=dev) for b in tplan.buckets]
                vs_time = snr_db(pool_step_lcr(hist, ready, time0, tplan, hops)[0],
                                 pool_step_lcr(hist, ready, spec0, plan, hops)[0])
                worst = min(worst, vs_time)
                print(f"K3s parity hw={hw} S={S} hops={hops} all buckets: "
                      + ", ".join(f"{n} {v:.1f} dB" for n, v in zip(OUTPUTS, snrs[:3]))
                      + ", carries " + ", ".join(f"{v:.1f}" for v in snrs[3:])
                      + f" dB, max abs err {err:.3e}; exact zeros where the plain version has them {zeros_agree} "
                      f"(zeros elsewhere {n_stray}, the reference there at most {stray_ref:.1e}); two calls "
                      f"bit-identical {repeat}; against K3 from a fresh state {vs_time:.1f} dB (bar >= "
                      f"{KERNEL_BAR_DB} dB)", flush=True)
                if not zeros_agree:
                    fail("K3s's exact zeros differ from its plain version's")
                if not repeat:
                    fail("two calls of K3s on the same input differ")
                del hist, carries, got, got_c, spec0, time0
                torch.cuda.empty_cache()
    if not (worst >= KERNEL_BAR_DB):
        fail(f"K3s parity {worst:.1f} dB < {KERNEL_BAR_DB} dB")
    print(f"K3s edge product (bf16x3), worst over buckets, S, hops and hw: {edge_worst:.1f} dB (bar >= "
          f"{KERNEL_BAR_DB} dB)", flush=True)
    if not (edge_worst >= KERNEL_BAR_DB):
        fail(f"the edge product at {edge_worst:.1f} dB < {KERNEL_BAR_DB} dB")
    # A plan whose every bucket takes the edge product (the serving
    # config's 8192 and 4096 records alone, hops 1): spectral_whole
    # launches nothing, and its out=None result must be exact zeros, not
    # memory the caching allocator hands back unwritten (NaN-filled first).
    from upmix_tpu_torch.models.streaming import _plan_stream_buckets
    from upmix_tpu_torch.ops.pool import plan_from_stream_buckets

    cfg_p = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=POOL_HW)
    records = [r for r in _plan_stream_buckets(cfg_p, POOL_HW) if r.block_size in (8192, 4096)]
    edge_plan = plan_from_stream_buckets(records, POOL_HW, 4, POOL_STREAMS, dev, ola="spectral")
    all_edge = all(not whole for _, whole in edge_plan.spectral_routes(1).frames)
    gen = torch.Generator(dev).manual_seed(22)
    carries = [torch.randn(b.spectral_carry_shape(POOL_STREAMS), device=dev, generator=gen) for b in edge_plan.buckets]
    specs = [torch.randn((POOL_STREAMS, 3, b.passes, b.kept, 2), device=dev, generator=gen) for b in edge_plan.buckets]
    t = torch.full((POOL_STREAMS,), 9, dtype=torch.int32, device=dev)
    torch.full((POOL_STREAMS, 3, POOL_HW), float("nan"), device=dev)  # freed at once, its block reused below
    before = pool.SPECTRAL_LAUNCHES
    out = spectral_whole(carries, specs, t, edge_plan)
    torch.cuda.synchronize()
    launched, nonzero = pool.SPECTRAL_LAUNCHES - before, int(torch.count_nonzero(out))
    print(f"K3s spectral_whole(out=None) on an all-edge plan (buckets {[b.block for b in edge_plan.buckets]}, "
          f"S={POOL_STREAMS}, every frame on the edge product {all_edge}): {launched} launches, {nonzero} nonzero "
          "values (want exact zeros)", flush=True)
    if not all_edge or launched or nonzero:
        fail("spectral_whole(out=None) on an all-edge plan did not return exact zeros")
    del carries, specs, out

    # 23. the spectral pool end to end through the user's entry point
    cfg = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=POOL_HW)
    S, hw = POOL_STREAMS, POOL_HW
    blocks = torch.randn((POOL_BLOCKS, 2, S, hw), device=dev, generator=torch.Generator(dev).manual_seed(23))
    sp = make_stream_pool(cfg, hw, S, ola="spectral")
    if type(sp) is not CudaStreamPool or sp.ola != "spectral":
        fail(f"make_stream_pool(ola='spectral') gave {type(sp).__name__} (ola {getattr(sp, 'ola', None)})")
    plan = sp.plan
    K = plan.warmup
    per_block = spectral_launches(plan, 1)
    routes = ", ".join(f"B={b.block}: {len(b.spectral_frames(1)[0])} edge frames on the product, "
                       f"{len(b.spectral_frames(1)[1])} whole on the FFTs" for b in plan.buckets)
    print(f"spectral pool plan (hops 1): {routes}; {per_block} launches a block", flush=True)
    pool.LAUNCHES = pool.SPECTRAL_LAUNCHES = pool.EDGE_LAUNCHES = 0
    outs = [torch.stack(sp.push_blocks(b[0], b[1])) for b in blocks]
    torch.cuda.synchronize()
    k3s_launches, edge_launches = pool.SPECTRAL_LAUNCHES, pool.EDGE_LAUNCHES
    print(f"spectral pool e2e: CudaStreamPool(ola='spectral'), {POOL_BLOCKS} blocks x {S} streams, K3s launches "
          f"{k3s_launches} (want {POOL_BLOCKS * per_block}), of them the edge product {edge_launches} (want "
          f"{POOL_BLOCKS}), K3 launches {pool.LAUNCHES} (want 0)", flush=True)
    if k3s_launches != POOL_BLOCKS * per_block or edge_launches != POOL_BLOCKS or pool.LAUNCHES:
        fail(f"the spectral pool launched K3s {k3s_launches} times (the edge product {edge_launches}) and K3 "
             f"{pool.LAUNCHES} times")
    hist64 = torch.zeros((S, 2, (K - 1) * hw), dtype=torch.float64, device=dev)
    carries64 = [torch.zeros(b.spectral_carry_shape(S), dtype=torch.float64, device=dev) for b in plan.buckets]
    e2e = float("inf")
    for i, (b, out) in enumerate(zip(blocks, outs)):
        h = torch.cat([hist64, b.transpose(0, 1).double()], dim=-1)
        ref, carries64 = pool_step_spectral_plain(h, torch.full((S,), i + 1, dtype=torch.int32, device=dev),
                                                  carries64, plan)
        hist64 = h[..., hw:]
        if not torch.isfinite(out).all() or out.shape != (3, S, hw):
            fail(f"spectral pool block {i}: shape {tuple(out.shape)} or non-finite values")
        if i < K - 1:
            if bool((out != 0).any()):
                fail(f"spectral pool block {i} is not silent during warmup")
        else:
            e2e = min(e2e, snr_db(ref.transpose(0, 1), out))
    del hist64, carries64, ref, h
    print(f"spectral pool e2e: warmup blocks 0..{K - 2} exact zeros; worst block SNR vs float64 plain step "
          f"{e2e:.1f} dB (bar >= {E2E_BAR_DB} dB)", flush=True)
    if not (e2e >= E2E_BAR_DB):
        fail(f"spectral pool end-to-end SNR {e2e:.1f} dB < {E2E_BAR_DB} dB")
    snap = sp.snapshot()  # the JAX package's packed layout
    a = torch.stack(sp.push_blocks(blocks[0, 0], blocks[0, 1]))
    a2 = torch.stack(sp.push_blocks(blocks[1, 0], blocks[1, 1]))
    fresh = CudaStreamPool(cfg, hw, S, device=dev, ola="spectral")
    fresh.restore(snap)
    resumed = (torch.equal(torch.stack(fresh.push_blocks(blocks[0, 0], blocks[0, 1])), a)
               and torch.equal(torch.stack(fresh.push_blocks(blocks[1, 0], blocks[1, 1])), a2))
    layout = {k: tuple(v.shape) for k, v in snap["ola"].items()}
    sp.restore(snap)
    slot = S // 2
    sp.reset_streams([slot])
    b0 = torch.stack(sp.push_blocks(blocks[0, 0], blocks[0, 1]))
    others = [s for s in range(S) if s != slot]
    churn_ok = bool(torch.equal(a[:, others], b0[:, others])) and not bool((b0[:, slot] != 0).any())
    print(f"spectral pool e2e: snapshot carries in the JAX layout {layout}, restored into a fresh pool: the next two "
          f"blocks bit for bit {resumed}; reset_streams re-warms slot {slot}, others bit-identical {churn_ok}",
          flush=True)
    if not resumed or not churn_ok:
        fail("the spectral pool's snapshot did not resume bit for bit, or reset_streams touched other streams")
    del sp, fresh, outs, snap, a, a2, b0

    # Timing: K3s and K3 in the same run.
    deadline_ms = hw / POOL_SR * 1e3

    def sustained(n_streams, hops, ola):
        tp = CudaStreamPool(cfg, hw, n_streams, device=dev, ola=ola)
        run, fresh_state = tp.make_sustained_runner(POOL_BLOCKS, hops=hops)
        slabs = (blocks[:, :, :n_streams].reshape(POOL_BLOCKS // hops, hops, 2, n_streams, hw)
                 .permute(0, 2, 3, 1, 4).reshape(POOL_BLOCKS // hops, 2, n_streams, hops * hw).contiguous())
        state, _ = run(fresh_state(), slabs)
        return time_ms(lambda: run(state, slabs), loops=5, iters=1) / POOL_BLOCKS, (run, state, slabs)

    for n_streams, hops in ((16, 1), (16, 4), (S, 1), (S, 4)):
        ms_s, _ = sustained(n_streams, hops, "spectral")
        ms_t, _ = sustained(n_streams, hops, "time")
        torch.cuda.empty_cache()
        print(f"spectral pool timing [{smi}]: S={n_streams} hops={hops} ({POOL_BLOCKS} blocks a call): K3s pool "
              f"{ms_s:.3f} ms per block, K3 pool {ms_t:.3f} ms (K3s/K3 {ms_s / ms_t:.2f}); the {deadline_ms:.2f} ms "
              f"deadline met {ms_s <= deadline_ms}", flush=True)
    # K3s alone, every stream ready, beside K3 in the same run: ms a block.
    rng = np.random.default_rng(24)
    tplan = make_pool_plan(cfg, hw, S, device=dev)

    def step_inputs(n_streams, hops, p):
        h = torch.as_tensor(rng.standard_normal((n_streams, 2, (K - 1 + hops) * hw)), dtype=torch.float32, device=dev)
        c = [torch.as_tensor(rng.standard_normal(b.spectral_carry_shape(n_streams)) * 0.1, dtype=torch.float32,
                             device=dev) for b in p.buckets]
        return h, torch.full((n_streams,), K + 1, dtype=torch.int32, device=dev), c

    for n_streams, hops in ((S, 1), (S, 4), (16, 1), (16, 4)):
        p_s = plan if n_streams == S else make_pool_plan(cfg, hw, n_streams, device=dev, ola="spectral")
        p_t = tplan if n_streams == S else make_pool_plan(cfg, hw, n_streams, device=dev)
        h, tt, c = step_inputs(n_streams, hops, p_s)
        tc = [torch.zeros((n_streams, 3, b.block), device=dev) for b in p_t.buckets]
        ms_s = time_ms(lambda: pool_step_lcr(h, tt, c, p_s, hops)) / hops
        ms_t = time_ms(lambda: pool_step_lcr(h, tt, tc, p_t, hops)) / hops
        host_s = host_ms(lambda: pool_step_lcr(h, tt, c, p_s, hops))
        host_t = host_ms(lambda: pool_step_lcr(h, tt, tc, p_t, hops))
        print(f"timing [{smi}]: K3s alone S={n_streams} hops={hops} (all ready) {ms_s:.3f} ms a block, K3 {ms_t:.3f} "
              f"(K3s/K3 {ms_s / ms_t:.2f}); {spectral_launches(p_s, hops)} launches a call; host time a call: K3s "
              f"{host_s:.3f} ms, K3 {host_t:.3f} ms", flush=True)
        if (n_streams, hops) == (S, 1):
            k3s_ms, k3_ms = ms_s, ms_t
        del h, c, tc
    hist, t, carries = step_inputs(S, 1, plan)
    tcarries = [torch.zeros((S, 3, b.block), device=dev) for b in tplan.buckets]
    k3s_plain_ms = time_ms(lambda: pool_step_spectral_plain(hist, t, carries, plan))
    # The function's least work is K3's: the FFTs of every frame; its bytes
    # the history read, the spectral carries read and written, the outputs
    # written and t, gains and windows read once.
    k3s_flop = sum(fft_flop(S * b.passes, b.block) for b in plan.buckets)
    carry_floats = sum(3 * (b.overlap - 1) * b.kept * 2 for b in plan.buckets)
    k3s_bytes = 4 * (S * 2 * K * hw + 2 * S * carry_floats + S * 3 * hw + S
                     + sum(2 * b.block + b.gains.numel() for b in plan.buckets))
    k3s_bound, k3s_by = bound(k3s_flop, k3s_bytes)
    print(f"timing [{smi}]: K3s (S={S}, hops=1, all ready) {k3s_ms:.3f} ms, K3 {k3_ms:.3f} ms (K3s/K3 "
          f"{k3s_ms / k3_ms:.2f}), plain version {k3s_plain_ms:.3f} ms; bound {k3s_bound:.3f} ms ({k3s_by}: "
          f"{k3s_flop:.3e} FLOP by FFT, {k3s_bytes / 1e9:.3f} GB with {carry_floats} carried floats a stream), "
          f"K3s at {k3s_bound / k3s_ms:.1%} of it", flush=True)

    def edge_flop(p, n_streams, hops):
        """The edge product's logical FLOP: 2 x 2K for each row (s, o) and
        sample an edge frame reaches (three times that on the tensor cores
        in split precision)."""
        N = hops * hw
        return sum(3 * n_streams * 2 * 2 * b.kept * sum(min(N, v * b.hop + b.block) - max(0, v * b.hop)
                                                        for v in b.spectral_frames(hops)[0]) for b in p.buckets)

    # The three steps' shares, at hops 1 and 4.
    for hops in (1, 4):
        h, tt, c = step_inputs(S, hops, plan)
        specs, _ = spectral_forward(h, tt, c, plan, hops)
        f_ms = time_ms(lambda: spectral_forward(h, tt, c, plan, hops))
        w_ms = time_ms(lambda: spectral_whole(c, specs, tt, plan, hops))
        e_ms = time_ms(lambda: spectral_edge(c, specs, tt, plan, hops))
        flop = edge_flop(plan, S, hops)
        total = f_ms + e_ms + w_ms
        print(f"timing [{smi}]: K3s steps S={S} hops={hops}: forward FFTs {f_ms:.3f} ms, edge product (gather + "
              f"product, {flop:.3e} FLOP, bf16x3) {e_ms:.3f} ms ({flop / e_ms / 1e9:.1f} TFLOP/s logical, "
              f"{3 * flop / e_ms / 1e9:.1f} on the tensor cores), whole-frame inverse FFTs {w_ms:.3f} ms; shares of "
              f"their sum: forward {f_ms / total:.0%}, product {e_ms / total:.0%}, whole {w_ms / total:.0%}",
              flush=True)
        del h, c, specs

    # The routes: per bucket the product route (its edge frames forced onto
    # it) against the FFT route, and the two inverse steps alone: the
    # product against the FFTs' inverse of every frame, with the rate
    # ratio they show, (the product's tensor-core FLOP / its ms) / (the
    # FFTs' FLOP / their ms), counted as `pool.takes_edge_product` counts
    # them, where every frame is an edge frame; the plan as built against
    # every bucket on the product and every bucket on the FFTs.  At hw
    # 2048 with 2048, 128 and 16 streams, at 8192, and for one band
    # keeping every bin of its 16384-point frames.
    every_bin = UpmixConfig.streaming([0.0], sr=8000.0, hw_block_size=4096)
    for r_cfg, r_hw, r_s in ((cfg, hw, S), (cfg, hw, 128), (cfg, hw, 16),
                             (UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=4 * hw), 4 * hw, S // 4),
                             (every_bin, 4096, S // 4)):
        r_plan = make_pool_plan(r_cfg, r_hw, r_s, device=dev, ola="spectral")
        r_all = edge_everywhere(r_plan)
        r_none = dataclasses.replace(r_plan, buckets=tuple(dataclasses.replace(b, edge_product=False)
                                                           for b in r_plan.buckets))
        rK = r_plan.warmup
        h = torch.as_tensor(rng.standard_normal((r_s, 2, rK * r_hw)), dtype=torch.float32, device=dev)
        tt = torch.full((r_s,), rK + 1, dtype=torch.int32, device=dev)
        c = [torch.as_tensor(rng.standard_normal(b.spectral_carry_shape(r_s)) * 0.1, dtype=torch.float32,
                             device=dev) for b in r_plan.buckets]
        parts = []
        for i, b in enumerate(r_plan.buckets):
            on = dataclasses.replace(r_all, buckets=(r_all.buckets[i],))
            off = dataclasses.replace(r_none, buckets=(r_none.buckets[i],))
            on_ms = time_ms(lambda: pool_step_lcr(h, tt, [c[i]], on))
            off_ms = time_ms(lambda: pool_step_lcr(h, tt, [c[i]], off))
            part = (f"B={b.block} K={b.kept} ({'product' if b.edge_product else 'FFTs'} planned) product route "
                    f"{on_ms:.3f} ms, FFT route {off_ms:.3f}")
            edge, whole = on.buckets[0].spectral_frames(1)
            if not whole:
                specs, _ = spectral_forward(h, tt, [c[i]], on, 1)
                e_ms = time_ms(lambda: spectral_edge([c[i]], specs, tt, on, 1))
                w_ms = time_ms(lambda: spectral_whole([c[i]], specs, tt, off, 1))
                reach = sum(min(r_hw, v * b.hop + b.block) - max(0, v * b.hop) for v in edge)
                mma = 36.0 * b.kept * reach * r_s
                fft = len(edge) * 7.5 * b.block * np.log2(b.block) * r_s
                part += (f"; product step {e_ms:.3f} ms against the FFTs' inverse {w_ms:.3f} (FLOP ratio "
                         f"{mma / fft:.1f}, rate ratio {(mma / e_ms) / (fft / w_ms):.1f})")
                del specs
            parts.append(part)
        print(f"routes [{smi}] hw={r_hw} S={r_s} hops=1: " + "; ".join(parts) + f"; the plan as built "
              f"{time_ms(lambda: pool_step_lcr(h, tt, c, r_plan)):.3f} ms, every bucket on the product "
              f"{time_ms(lambda: pool_step_lcr(h, tt, c, r_all)):.3f}, every bucket on the FFTs "
              f"{time_ms(lambda: pool_step_lcr(h, tt, c, r_none)):.3f}", flush=True)
        del h, c, r_plan, r_all, r_none
        torch.cuda.empty_cache()

    def design(b):
        """(FFT FLOP, tensor-core FLOP, bytes) of K3s's own work on bucket
        b at hops 1 and its launch geometry: G frames a pass forward (zero
        frames included); the edge product's three split products for
        every row and sample its frames reach; per stream the whole
        frames inverted (C + i Ls one transform, the Rs of two frames
        another); 5 N log2 N a complex FFT; frames read, the new spectra
        written and read, the gathered operand written and read, the
        carries, the output read and written."""
        G, F, Kr = spectral_pass(b.block), b.passes, b.overlap
        edge, whole = b.spectral_frames(1)
        fwd = -(-F // G) * G
        nw = len(whole)
        inv = sum(nf + -(-nf // 2) for nf in [min(G, nw - i) for i in range(0, nw, G)])
        fft = S * (fwd + inv) * 5 * b.block * np.log2(b.block)
        mma = 3 * edge_flop(dataclasses.replace(plan, buckets=(b,)), S, 1)
        kp = -(-2 * b.kept // 32) * 32
        nbytes = 4 * S * (fwd * 2 * b.block + 2 * 3 * F * b.kept * 2 + 2 * 3 * (Kr - 1) * b.kept * 2 + 2 * 3 * hw)
        nbytes += 2 * 2 * 2 * 3 * S * len(edge) * kp  # the gathered bf16 hi and lo, written and read
        return fft, mma, nbytes

    d = [design(b) for b in plan.buckets]
    d_fft, d_mma, d_bytes = (sum(x[i] for x in d) for i in range(3))
    d_ms = max(d_fft / FP32_FLOPS + d_mma / BF16_FLOPS, d_bytes / HBM_BYTES_PER_S) * 1e3
    print(f"design [{smi}]: K3s FFTs in shared memory {d_fft:.3e} FLOP, edge product {d_mma:.3e} FLOP on the tensor "
          f"cores ({(d_fft + d_mma / 3) / k3s_flop:.2f}x the function's FLOP counting the product's logical ones), "
          f"{d_bytes / 1e9:.3f} GB -> {d_ms:.3f} ms; K3s at {d_ms / k3s_ms:.1%} of it", flush=True)
    parts, k3s_lib_ms = [], 0.0
    for b, c in zip(plan.buckets, carries):
        sub = dataclasses.replace(plan, buckets=(b,))
        tsub = dataclasses.replace(tplan, buckets=(tplan.buckets[plan.buckets.index(b)],))
        b_ms = time_ms(lambda: pool_step_lcr(hist, t, [c], sub))
        b_k3 = time_ms(lambda: pool_step_lcr(hist, t, [tcarries[plan.buckets.index(b)]], tsub))
        b_plain = time_ms(lambda: pool_step_spectral_plain(hist, t, [c], sub))
        specs, _ = spectral_forward(hist, t, [c], sub, 1)
        f_ms = time_ms(lambda: spectral_forward(hist, t, [c], sub, 1))
        edge, whole = b.spectral_frames(1)
        if edge:
            e_ms = time_ms(lambda: spectral_edge([c], specs, t, sub, 1))
            e_flop = edge_flop(sub, S, 1)
            product = f"product {e_ms:.3f} ms ({e_flop / e_ms / 1e9:.1f} TFLOP/s logical)"
        else:
            product = "no product"
        w_ms = time_ms(lambda: spectral_whole([c], specs, t, sub, 1)) if whole else 0.0
        del specs
        # The cuFFT yardstick of its transforms: rfft of the new frames,
        # irfft of the three outputs of every frame that reaches the output.
        rows, _ = cufft_inputs(hist, b, b.passes)
        gen = torch.Generator(dev).manual_seed(b.block)
        shape = (S, 3, b.passes + b.overlap - 1, b.block // 2 + 1)
        spec = torch.complex(torch.randn(shape, device=dev, generator=gen),
                             torch.randn(shape, device=dev, generator=gen))
        c_ms = cufft_ms(rows, spec, b.block)
        del rows, spec
        k3s_lib_ms += c_ms
        parts.append(f"B={b.block} {len(edge)} edge / {len(whole)} whole frames: {b_ms:.3f} ms (K3 {b_k3:.3f}); "
                     f"{product}, FFTs {f_ms + w_ms:.3f} ms (forward {f_ms:.3f}, whole {w_ms:.3f}); plain "
                     f"{b_plain:.3f} ms, cuFFT yardstick {c_ms:.3f} ms")
    print(f"timing [{smi}]: K3s per bucket (hops 1): " + "; ".join(parts)
          + f"; cuFFT yardstick over the buckets {k3s_lib_ms:.3f} ms", flush=True)
    for n_streams in (16, S):
        _, (run, state, slabs) = sustained(n_streams, 1, "spectral")
        print(f"spectral pool profile (S={n_streams}, {POOL_BLOCKS} blocks per call): "
              f"{device_share(lambda: run(state, slabs), iters=2)}", flush=True)
        del run, state, slabs
    del hist, carries, tcarries, blocks
    torch.cuda.empty_cache()
    return {
        "name": "pool_step_spectral",
        "route": "cuda",
        "source": "upmix_tpu_torch/csrc/pool_spectral.cu",
        "replaces": "upmix_tpu/ops/pallas_pool.py:249",
        "launches": k3s_launches,
        "max_abs_err": max_abs_err,
        "ms": k3s_ms,
        "plain_ms": k3s_plain_ms,
        "bound_ms": k3s_bound,
        "bound_by": k3s_by,
        "library_ms": k3s_lib_ms,
    }


def mesh_phases(smi: str, dev):
    """Phase 24: the serving pool on a data = 2 mesh of the one card."""
    import tempfile

    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.streaming import CudaStreamPool
    from upmix_tpu_torch.ops import pool
    from upmix_tpu_torch.parallel import make_mesh
    from upmix_tpu_torch.serve_stream import StreamSession, run_stream_server

    cfg = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=POOL_HW)
    S, hw = POOL_STREAMS, POOL_HW
    mesh = make_mesh({"data": 2}, devices=[dev] * 2)
    blocks = torch.randn((6, 2, S, hw), device=dev, generator=torch.Generator(dev).manual_seed(24))
    for ola in ("time", "spectral"):
        shard = CudaStreamPool(cfg, hw, S, device=dev, mesh=mesh, ola=ola)
        plain = CudaStreamPool(cfg, hw, S, device=dev, ola=ola)
        launches, same = 0, True
        for b in blocks:
            before = pool.SPECTRAL_LAUNCHES if ola == "spectral" else pool.LAUNCHES
            got = torch.stack(shard.push_blocks(b[0], b[1]))
            launches += (pool.SPECTRAL_LAUNCHES if ola == "spectral" else pool.LAUNCHES) - before
            same &= bool(torch.equal(got, torch.stack(plain.push_blocks(b[0], b[1]))))
        snaps_same = all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in
                         zip(shard.snapshot()["histL"], plain.snapshot()["histL"]))
        print(f"mesh pool [{smi}] ola={ola}: data=2 over one card, S={S} (plan {shard.plan.n_streams} streams a "
              f"shard), {len(blocks)} blocks, {'K3s' if ola == 'spectral' else 'K3'} launches {launches}; outputs "
              f"bit for bit the unsharded pool's {same}, snapshots equal {snaps_same}", flush=True)
        if launches == 0 or not same or not snaps_same:
            fail(f"the mesh pool ({ola}) launched {launches} kernels or differs from the unsharded pool")
        del shard, plain
    # A stream-server session on the mesh pool, checkpointed, then restored
    # into an unsharded server: the clients' frames equal the pool fed
    # directly in the server's cycles, bit for bit.
    kw = dict(sr=POOL_SR, hw_block_size=POOL_HW, band_edges=POOL_EDGES, verbose=False, device=dev, engine="cuda",
              ola="spectral", n_streams=SERVER_SLOTS, lockstep=True)
    rng = np.random.default_rng(241)
    n = SERVER_BLOCKS * hw
    x = (rng.standard_normal((SERVER_CLIENTS, n, 2)) * 0.3).astype(np.float32)
    ref = _direct_frames(CudaStreamPool(cfg, hw, SERVER_SLOTS, device=dev, ola="spectral"), x, 1)
    skip = (CudaStreamPool(cfg, hw, 1, device=dev).warmup_blocks - 1) * hw
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/sessions.npz"
        pool.SPECTRAL_LAUNCHES = 0
        srv = run_stream_server(0, mesh=mesh, **kw)
        try:
            if srv.pool.mesh is None or srv.pool.ola != "spectral":
                fail("run_stream_server(mesh=...) did not build the spectral CUDA pool on the mesh")
            sessions = [StreamSession(*srv.address, mix="lcr") for _ in range(SERVER_CLIENTS)]
            part1 = _serve_clients(sessions, x, 0, SERVER_CUT, SERVER_CUT * hw - skip, False)
            saved = srv.save_checkpoint(ckpt)
            for s in sessions:
                s.close()
        finally:
            srv.close()
        srv = run_stream_server(0, snapshot_path=ckpt, **kw)
        try:
            sessions = [StreamSession(*srv.address, mix="lcr", token=s.token) for s in sessions]
            part2 = _serve_clients(sessions, x, SERVER_CUT, SERVER_BLOCKS, n - part1.shape[1], True)
            for s in sessions:
                s.close()
            unsharded = srv.pool.mesh is None
        finally:
            srv.close()
    got = np.concatenate([part1, part2], axis=1)
    same = bool(np.array_equal(got, ref))
    print(f"mesh server [{smi}]: {SERVER_CLIENTS} clients x {SERVER_BLOCKS} blocks on a data=2 mesh pool "
          f"(spectral), checkpointed at block {SERVER_CUT} ({saved} sessions) and resumed on an unsharded server "
          f"({unsharded}); K3s launches {pool.SPECTRAL_LAUNCHES}; frames equal the pool fed directly bit for bit: "
          f"{same} (max abs err {float(np.abs(got - ref).max()):.3g})", flush=True)
    if saved != SERVER_CLIENTS or not unsharded or not same or pool.SPECTRAL_LAUNCHES == 0:
        fail("the mesh pool's server session did not resume bit for bit on an unsharded server")


DIST_MESH = {"seq": 4, "data": 2}  # over two processes of 4 entries: process 0 holds seq 0-1 of both files
DIST_LOOPS = 5
DIST_TIMEOUT = 300  # seconds a group of child processes may take
# Shards against phase 13's output: K1 and K2 sum a pass's G frames before
# adding them to the output, and which frames share a pass follows the
# launch's hops per block, which follows the row count (4 rows a process
# here, 8 in phase 13): float32 rounding apart, never more.
DIST_DIFF_BAR = 1e-5

# Phase 27's child: one process of a group.  argv[1] is a JSON object: the
# group (port, rank, world, backend, device, local entries), bench.py's
# config, the global mesh, the files and samples of phase 13's input, the
# path of phase 13's output and the timing loops.  Prints one JSON line.
_DIST_CHILD = r"""
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.offline import build_offline_fn
from upmix_tpu_torch.ops import fused, omnibus
from upmix_tpu_torch.parallel import Shard, build_sharded_offline_fn, init_distributed, make_mesh, run_pod_check
from upmix_tpu_torch.parallel import sharded

a = json.loads(sys.argv[1])
dev = torch.device(a["device"])
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
info = init_distributed(f"127.0.0.1:{a['port']}", a["world"], a["rank"], [a["device"]] * a["local"], a["backend"])
cfg = UpmixConfig.make(a["edges"], sr=a["sr"], max_block_size=a["max_block"])
n, files = a["samples"], a["files"]
audio = torch.as_tensor(np.random.default_rng(5).standard_normal((files, 2, n)), dtype=torch.float32, device=dev)
fn, plan = build_sharded_offline_fn(cfg, n, make_mesh(a["mesh"]))
assert plan.n_padded == n, plan
fn(audio)  # the device plans are built on the first call
sync()
omnibus.LAUNCHES = fused.LAUNCHES = 0
out = fn(audio)
sync()
k1, k2 = omnibus.LAUNCHES, fused.LAUNCHES
if isinstance(out, torch.Tensor):  # this process holds every entry
    out = [Shard((slice(0, files), slice(None), slice(0, n)), out)]
phase13 = np.load(a["ref"], mmap_mode="r")
shards = []
for i in range(files):
    ref = torch.stack(build_offline_fn(cfg, n, chunk=0, device=dev)(audio[i, 0].double(), audio[i, 1].double()))
    for s in out:
        rows, _, sl = s.index
        if rows.start <= i < rows.stop:
            got = s.data[i - rows.start].double()
            err, sig = ((ref[:, sl] - got) ** 2).sum(-1).tolist(), (ref[:, sl] ** 2).sum(-1).tolist()
            snr = min(10 * np.log10(g / e) if e > 0 else float("inf") for g, e in zip(sig, err))
            diff = float(np.abs(got.float().cpu().numpy() - phase13[i, :, sl]).max())
            shards.append({"file": i, "start": sl.start, "stop": sl.stop, "snr_db": snr, "max_diff": diff})
del ref


def best_ms(after=lambda: None):
    best = []
    for _ in range(a["loops"]):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        fn(audio)
        sync()
        best.append((time.perf_counter() - t0, after()))
    return min(best)


call_s, _ = best_ms()
# The exchange's own time: each halo step between a synchronize before and
# after it (staging, send and receive, waits), summed over the call's two.
spent, moved, real = [], [], sharded._exchange


def timed(sends, recvs):
    sync()
    t0 = time.perf_counter()
    got = real(sends, recvs)
    sync()
    spent.append(time.perf_counter() - t0)
    moved.append(sum(t.numel() for _, _, t in sends) * 4 + sum(int(np.prod(r[2])) * 4 for r in recvs))
    return got


def drain():
    took = (sum(spent), sum(moved))
    spent.clear()
    moved.clear()
    return took


sharded._exchange = timed
timed_call_s, (exchange_s, exchange_bytes) = best_ms(drain)
sharded._exchange = real
pod = run_pod_check(device=a["device"], local_devices=a["local"], backend=a["backend"])
print(json.dumps({"rank": a["rank"], "topology": info, "backend": dist.get_backend(), "k1": k1, "k2": k2,
                  "shards": shards, "call_ms": call_s * 1e3, "timed_call_ms": timed_call_s * 1e3,
                  "exchange_ms": exchange_s * 1e3, "exchange_bytes": exchange_bytes,
                  "pod": {k: pod[k] for k in ("collective", "seq_sharded", "ok")}}))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_group(world: int, backend: str, local: int, devices: list, ref_path: str) -> list:
    """Start `world` processes of _DIST_CHILD at once; returns their JSON
    lines, or fails on a non-zero exit or a timeout."""
    from pathlib import Path

    base = dict(port=_free_port(), world=world, backend=backend, local=local, edges=BAND_EDGES, sr=SR,
                max_block=MAX_BLOCK, mesh=DIST_MESH, files=SHARD_FILES, samples=SHARD_SAMPLES, ref=ref_path,
                loops=DIST_LOOPS)
    argvs = [[sys.executable, "-c", _DIST_CHILD, json.dumps({**base, "rank": r, "device": devices[r]})]
             for r in range(world)]
    procs = [subprocess.Popen(argv, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT))
    except subprocess.TimeoutExpired:
        fail(f"a process of the {backend} group did not finish within {DIST_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reps = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"process {r} of the {backend} group exited {p.returncode}: {out[-1500:]} {err[-3000:]}")
        reps.append(json.loads(out.strip().splitlines()[-1]))
    return reps


def distributed_phases(smi: str, dev, shard_rtf: float):
    """Phase 27: processes that share one global mesh, on the one card
    under gloo and with NCCL at world size 1 (and across cards with NCCL
    where there are two)."""
    import tempfile

    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.offline import plans_from_numpy
    from upmix_tpu_torch.ops.omnibus import launches_per_bucket
    from upmix_tpu_torch.parallel import ShardedUpmixer, make_mesh, sequence_plan
    from upmix_tpu_torch.parallel.sharded import _plan_seq_buckets, route_buckets

    cfg = UpmixConfig.make(BAND_EDGES, sr=SR, max_block_size=MAX_BLOCK)
    splan = sequence_plan(cfg, SHARD_SAMPLES, DIST_MESH["seq"])
    omni_plan, narrow = route_buckets(plans_from_numpy(_plan_seq_buckets(cfg), dev), splan.chunk)
    want_k1, want_k2 = sum(launches_per_bucket(b.block) for b in omni_plan.buckets), len(narrow)
    audio_s = SHARD_FILES * SHARD_SAMPLES / SR
    audio = torch.as_tensor(np.random.default_rng(5).standard_normal((SHARD_FILES, 2, SHARD_SAMPLES)),
                            dtype=torch.float32, device=dev)  # phase 11's input
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = f"{tmp}/phase13.npy"
        phase13 = ShardedUpmixer(cfg, make_mesh(SHARD_MESH, devices=[dev] * SHARD_FILES * SHARD_MESH["seq"]))
        np.save(ref_path, phase13.process_batch(audio).cpu().numpy())
        del audio, omni_plan, narrow, phase13
        torch.cuda.empty_cache()

        def report(reps, label: str):
            for rep in reps:
                t = rep["topology"]
                worst = min(s["snr_db"] for s in rep["shards"])
                diff = max(s["max_diff"] for s in rep["shards"])
                spans = sorted({(s["start"], s["stop"]) for s in rep["shards"]})
                pod = rep["pod"]
                pod_snr = min(s["snr_db"] for s in pod["seq_sharded"]["shards"])
                print(f"distributed [{smi}] {label}: process {t['process_index']}/{t['process_count']} "
                      f"({rep['backend']}, {t['local_devices']} of {t['global_devices']} entries of {DIST_MESH}), "
                      f"shards {len(rep['shards'])} at samples {spans}: worst SNR vs float64 whole-file path "
                      f"{worst:.1f} dB (bar >= {E2E_BAR_DB} dB), max |shard - phase 13's ShardedUpmixer| {diff:.3e} "
                      f"(bar < {DIST_DIFF_BAR}); "
                      f"K1 launches {rep['k1']} (want {want_k1}), K2 {rep['k2']} (want {want_k2}); call "
                      f"{rep['call_ms']:.3f} ms, exchange {rep['exchange_ms']:.3f} ms a call over "
                      f"{rep['exchange_bytes'] / 1e6:.3f} MB (call {rep['timed_call_ms']:.3f} ms with it timed); "
                      f"pod_check: sum {pod['collective']['got']} (want {pod['collective']['want']}), "
                      f"{len(pod['seq_sharded']['shards'])} shards >= {pod_snr:.1f} dB", flush=True)
                if not (worst >= E2E_BAR_DB and pod_snr > E2E_BAR_DB and pod["ok"]):
                    fail(f"{label}: a shard of process {t['process_index']} is under {E2E_BAR_DB} dB")
                if not diff < DIST_DIFF_BAR:
                    fail(f"{label}: process {t['process_index']}'s shards differ from phase 13's by {diff:.3e}")
                if rep["k1"] != want_k1 or rep["k2"] != want_k2:
                    fail(f"{label}: process {t['process_index']} launched K1 {rep['k1']} and K2 {rep['k2']} times")
                if pod["collective"]["got"] != pod["collective"]["want"]:
                    fail(f"{label}: the all_reduce gave {pod['collective']['got']}")
            covered = sorted((s["file"], s["start"]) for rep in reps for s in rep["shards"])
            whole = [(i, q * splan.chunk) for i in range(SHARD_FILES) for q in range(DIST_MESH["seq"])]
            if len(reps) > 1 and covered != whole:
                fail(f"{label}: the processes' shards {covered} do not cover the output once")
            slowest = max(rep["call_ms"] for rep in reps)
            print(f"distributed [{smi}] {label}: {audio_s / slowest * 1e3:.1f}x realtime for the group (slowest "
                  f"process {slowest:.3f} ms for {SHARD_FILES} x {SHARD_SAMPLES} samples; phase 13's one-process "
                  f"ShardedUpmixer {shard_rtf:.1f}x)", flush=True)

        # (a) Two processes on the one card under gloo, the halos staged
        # through host memory: the seq axis crosses the process boundary.
        report(_dist_group(2, "gloo", 4, ["cuda:0", "cuda:0"], ref_path), "gloo, 2 processes on one card")
        # (b) NCCL at world size 1: bring-up, the all_reduce and the pipeline
        # on a one-process global mesh of 8 entries.
        report(_dist_group(1, "nccl", 8, ["cuda:0"], ref_path), "nccl, world size 1")
        # (c) NCCL between distinct cards.
        if torch.cuda.device_count() >= 2:
            report(_dist_group(2, "nccl", 4, ["cuda:0", "cuda:1"], ref_path), "nccl, 2 processes on 2 cards")
        else:
            print(f"distributed: nccl between 2 cards not run: {torch.cuda.device_count()} card here, and NCCL "
                  "refuses two ranks on one device", flush=True)


def tune_phases(smi: str, dev):
    """Phase 25: `python -m upmix_tpu_torch.tune`'s two sweeps on the card."""
    import contextlib
    import io

    from upmix_tpu_torch import tune

    def run(argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tune.main(argv + ["--json"])
        return rc, json.loads(out.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0

    rc, rep, took = run(["--batches", ",".join(map(str, TUNE_BATCHES)), "--ola", "time,spectral", "--hops", "1,4",
                         "--protocol", "scan", "--blocks", "16", "--visits", "3"])
    for r in rep["results"]:
        print(f"tune pool [{smi}]: {r['label']}: " + (
            f"{r['seconds_per_block'] * 1e3:.3f} ms per block, {r['streams_per_chip']:.0f} streams in real time"
            if r["ok"] else f"FAILED {r['error']}"), flush=True)
    best = rep["best"]
    print(f"tune pool: best {best and best['label']}; transport floor "
          f"{rep['protocol']['transport_floor_seconds'] * 1e3:.3f} ms; {took:.1f} s", flush=True)
    if rc != 0 or len(rep["results"]) != 2 * 2 * len(TUNE_BATCHES) or not all(r["ok"] for r in rep["results"]):
        fail(f"the pool sweep ran {len(rep['results'])} candidates, not all with a time (rc {rc})")
    rc, rep, took = run(["--offline", "--samples", str(TUNE_OFFLINE_SAMPLES), "--chunks",
                         ",".join(map(str, TUNE_CHUNKS)), "--inner", "2", "--visits", "3"])
    for r in rep["results"]:
        print(f"tune offline [{smi}]: {r['label']} on {TUNE_OFFLINE_SAMPLES} samples: " + (
            f"{r['realtime_factor']:.1f}x realtime" if r["ok"] else f"FAILED {r.get('error')}"), flush=True)
    print(f"tune offline: best {rep['best'] and rep['best']['label']}; {took:.1f} s", flush=True)
    if rc != 0 or len(rep["results"]) != len(TUNE_CHUNKS) or not all(r["ok"] for r in rep["results"]):
        fail(f"the offline sweep gave {len(rep['results'])} candidates, not all with a time (rc {rc})")


def probe_phases(smi: str, dev) -> list:
    """Phases 14-16 on the two probes; returns the K4 and K5 result entries
    and prints the per-variant and per-configuration rows as a JSON line."""
    from upmix_tpu_torch.ops import int8_dot
    from upmix_tpu_torch.ops import overhead_probe as op
    from upmix_tpu_torch.ops.int8_dot import (
        APPLY_TOLERANCE, CHAIN, CHAIN_TOLERANCE, EXACT, PEAK, UNIT, VARIANTS, flop_per_apply, int8_dot_chain,
        int8_dot_chain_plain, make_consts, start_x,
    )

    # 14. K4 parity: each variant's kernel, at the cluster size the card's
    # choice gives it, against its plain version at K = 512 and both M the
    # probe's run gives it (512: clusters; 4224: a strip per SM, single
    # CTAs), after one apply and over a chain of 64: the int8 rungs bit for
    # bit, the float rungs within int8_dot.APPLY_TOLERANCE after one apply
    # and int8_dot.CHAIN_TOLERANCE (coarse) over the chain.
    consts = {v: make_consts(v, dev) for v in VARIANTS}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {v: {"variant": v, "max_abs_err": 0.0} for v in VARIANTS}
    for M in (512, int8_dot.SMS * int8_dot.ROWS):
        xm = torch.from_numpy(start_x(M)).to(dev)
        for v in VARIANTS:
            cs = int8_dot.cluster_size(M, *int8_dot.card_clusters(v), n_sm)
            for chain, limit in ((1, APPLY_TOLERANCE), (CHAIN, CHAIN_TOLERANCE.get(v))):
                got = int8_dot_chain(xm, v, chain, consts[v])
                ref = int8_dot_chain_plain(xm, v, chain, consts[v])
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                rel = err / float(ref.abs().max())
                exact = bool(torch.equal(got, ref))
                rows[v][f"max_rel_err_chain_{chain}{'' if M == 512 else '_all_sms'}"] = rel
                rows[v]["max_abs_err"] = max(rows[v]["max_abs_err"], err)
                print(f"K4 parity {v} (M={M}, cluster of {cs}, chain {chain}): max abs err {err:.3e}, relative "
                      f"{rel:.3e}, exact {exact} (bar: {'bit for bit' if v in EXACT else f'relative <= {limit:g}'})",
                      flush=True)
                if not (exact if v in EXACT else rel <= limit) or not bool(torch.isfinite(got).all()):
                    fail(f"dot-chain kernel {v} differs from its plain version at M = {M}, chain {chain}: "
                         f"relative {rel:.3e}")
    del got, ref, xm
    x = torch.from_numpy(start_x(512)).to(dev)

    # The probe's own run through its entry points: check (every variant's
    # SNR against float64 after 64 x 10 applies, the script's check line)
    # and bench (the script's interleaved min-of-visits at M = 512 and 4224).
    int8_dot.LAUNCHES = 0
    int8_dot.LAUNCHES_BY_VARIANT = {}
    snrs = int8_dot.check(VARIANTS, device=dev)
    int8_dot.bench(VARIANTS)
    torch.cuda.synchronize()
    k4_launches = int8_dot.LAUNCHES
    by_variant = dict(int8_dot.LAUNCHES_BY_VARIANT)
    print(f"K4 run: check + bench, dot-chain kernel launches {k4_launches} ({by_variant})", flush=True)
    if k4_launches == 0 or any(by_variant.get(v, 0) == 0 for v in VARIANTS):
        fail("the dot-chain probe's run launched no kernel for some variant")
    # The plain version's SNR over the same chain, beside the kernel's.
    w64 = torch.from_numpy(int8_dot.make_weights().astype(np.float64)).to(dev)
    ref = x.double()
    for _ in range(CHAIN * int8_dot.INNER):
        ref = ref @ w64
    ref = ref.cpu().numpy()
    for v in VARIANTS:
        y = x
        for _ in range(int8_dot.INNER):
            y = int8_dot_chain_plain(y, v, CHAIN, consts[v])
        rows[v]["snr_db"] = snrs[v]
        rows[v]["plain_snr_db"] = int8_dot.snr_db(ref, y.double().cpu().numpy())
        print(f"K4 check {v}: kernel SNR {snrs[v]:.1f} dB, plain version {rows[v]['plain_snr_db']:.1f} dB "
              f"over {CHAIN * int8_dot.INNER} applies (bar 60 dB: {'meets' if snrs[v] >= 60 else 'misses'})",
              flush=True)

    # 15. K4 timing: one call (chain 64) per rung at M = 512 and M = 4224
    # (a strip per SM), beside the one PyTorch call for the same function
    # where there is one; at M = 512 the plain version and the bound (the
    # products at the unit's dense peak).

    def chained(fn, a):
        for _ in range(CHAIN):
            a = fn(a)
        return a

    w32 = consts["fp32"].weights[0]
    wbf = consts["bf16x1"].weights[0].to(dev)
    wi8 = consts["int8x1"].weights[0]
    for M in (512, int8_dot.SMS * int8_dot.ROWS):
        xm = torch.from_numpy(start_x(M)).to(dev)
        xi8 = torch.clamp(torch.round(xm * (127.0 / 8.0)), -127, 127).to(torch.int8)
        library = {
            "fp32": lambda: chained(lambda a: torch.matmul(a, w32), xm),
            "bf16x1": lambda: chained(lambda a: torch.matmul(a, wbf), xm.to(torch.bfloat16)),
            "int8x1": lambda: [torch._int_mm(xi8, wi8) for _ in range(CHAIN)],
        }
        for v in VARIANTS:
            resident, at_once = int8_dot.card_clusters(v)
            cs = int8_dot.cluster_size(M, resident, at_once, n_sm)
            k_ms = time_ms(lambda: int8_dot_chain(xm, v, CHAIN, consts[v]))
            lib_ms = time_ms(library[v]) if v in library else None
            b_ms = CHAIN * flop_per_apply(v, M) / PEAK[UNIT[v]] * 1e3
            us = k_ms * 1e3 / CHAIN
            key = "" if M == 512 else "_all_sms"
            rows[v].update({f"ms{key}": k_ms, f"library_ms{key}": lib_ms, f"us_apply{key}": us,
                            f"bound_ms{key}": b_ms, f"peak_share{key}": b_ms / k_ms, f"cluster{key}": cs,
                            f"ctas{key}": M // int8_dot.ROWS * cs, f"clusters_at_once{key}": at_once(cs)})
            plain = ""
            if M == 512:
                p_ms = time_ms(lambda: int8_dot_chain_plain(xm, v, CHAIN, consts[v]), loops=3, iters=1)
                rows[v].update({"M": 512, "launches": by_variant[v], "plain_ms": p_ms,
                                "M_all_sms": int8_dot.SMS * int8_dot.ROWS})
                plain = f", plain {p_ms:.3f} ms"
            lib = f"{lib_ms:.3f} ms (kernel/library {k_ms / lib_ms:.2f})" if lib_ms is not None else "none"
            print(f"K4 timing [{smi}] {v} M={M}: kernel {k_ms:.3f} ms per call of {CHAIN} applies = {us:.2f} us per "
                  f"apply ({b_ms / k_ms:.1%} of the {UNIT[v]} peak; bound {b_ms:.4f} ms, operations){plain}; "
                  f"library {lib}; cluster of {cs}, {M // int8_dot.ROWS * cs} CTAs, {at_once(cs)} clusters at once, "
                  f"W {'resident' if resident(cs) else 'from L2'}",
                  flush=True)
    del xm, xi8
    # What the cluster buys: each rung at M = 512 at every cluster size, and
    # its us per apply from the slope between 1 and CHAIN applies (the rest
    # of a call, launch and loads, is fixed).
    x512 = torch.from_numpy(start_x(512)).to(dev)
    for v in VARIANTS:
        parts = []
        resident, at_once = int8_dot.card_clusters(v)
        for cs in int8_dot.CLUSTER_SIZES:
            t_one = time_ms(lambda: int8_dot.dot_cuda(x512, v, 1, consts[v], cs))
            t_all = time_ms(lambda: int8_dot.dot_cuda(x512, v, CHAIN, consts[v], cs))
            slope = (t_all - t_one) * 1e3 / (CHAIN - 1)
            parts.append(f"{cs}: {t_all:.3f} ms ({slope:.2f} us per apply, {t_one * 1e3 - slope:.1f} us fixed; "
                         f"{at_once(cs)} clusters at once, W {'resident' if resident(cs) else 'from L2'})")
        print(f"K4 clusters [{smi}] {v} M=512: " + "; ".join(parts), flush=True)
    del x512
    del consts, x, w64

    # 16. K5: parity bit for bit in all six configurations, the probe's own
    # run (its entry point), then each configuration's kernel alone.
    x5, rng = op.make_inputs(device=dev)
    weights = {c: op.make_weights(c[1], rng, dev) for c in op.CONFIGS}
    seed = torch.tensor(0.25, device=dev)
    k5_err = 0.0
    for c in op.CONFIGS:
        out, spill = op.overhead_probe(x5, seed, weights[c], c[0], c[2])
        ref_out, ref_spill = op.overhead_probe_plain(x5, seed, weights[c], c[0], c[2])
        same = bool(torch.equal(out, ref_out) and torch.equal(spill, ref_spill))
        k5_err = max(k5_err, float((out - ref_out).abs().max()), float((spill - ref_spill).abs().max()))
        print(f"K5 parity views={c[0]} weights={c[1]} halo={c[2]}: bit-exact {same}", flush=True)
        if not same:
            fail(f"overhead probe kernel differs from its plain version at {c}")
    del out, spill, ref_out, ref_spill
    op.LAUNCHES = 0
    script_rows = op.run_configs()
    torch.cuda.synchronize()
    k5_launches = op.LAUNCHES
    print(f"K5 run: the probe's six configurations, kernel launches {k5_launches}", flush=True)
    if k5_launches == 0:
        fail("the overhead probe's run launched no kernel")
    # The bound takes every byte from HBM, but x (17 MB) and out (25 MB) of
    # a call repeated on the same tensors stay in the 50 MB L2, and even
    # with cold inputs L2 can absorb one call's writes and drain them in
    # the host's gap before the next.  So the kernel's time is that of
    # op.CALLS calls queued back to back, rotating over op.SETS copies of
    # x that each keep their output (340 MB; op.cold_ms): all but the last
    # 50 MB of their writes must reach HBM inside the timed span.  The one
    # PyTorch call that moves the same bytes (op.library_call) is timed
    # the same way.
    n_tiles = op.N // op.TILE
    xs = [x5] + [x5.clone() for _ in range(op.SETS - 1)]
    k5_rows = []
    for c, (_, _, _, script_ms) in zip(op.CONFIGS, script_rows):
        shift = seed + sum(w[0, 0] for w in weights[c])
        cold_ms = op.cold_ms(lambda x_: op.overhead_probe(x_, seed, weights[c], c[0], c[2]), xs)  # noqa: B023
        warm_ms = op.queued_ms(lambda: op.overhead_probe(x5, seed, weights[c], c[0], c[2]), op.CALLS)  # noqa: B023
        lib_ms = op.cold_ms(lambda x_: op.library_call(x_, shift, op.N), xs)  # noqa: B023
        p_ms = time_ms(lambda: op.overhead_probe_plain(x5, seed, weights[c], c[0], c[2]))  # noqa: B023
        b_ms = op.bound_bytes(op.N, c[2]) / HBM_BYTES_PER_S * 1e3
        staged = op.staged_bytes(c[0])
        k5_rows.append({"views": c[0], "weights": c[1], "halo": c[2], "script_ms": script_ms,
                        "device_ms": cold_ms, "device_ms_l2_warm": warm_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                        "bound_ms": b_ms, "bound_share": b_ms / cold_ms, "staged_mb": staged / 1e6})
        print(f"K5 timing [{smi}] views={c[0]} weights={c[1]} halo={c[2]}: script protocol {script_ms:.4f} ms; "
              f"device {cold_ms:.4f} ms = {cold_ms * 1e3 / n_tiles:.3f} us per block back to back with L2 cold, at "
              f"{b_ms / cold_ms:.1%} of the bound {b_ms:.4f} ms (bytes from HBM); "
              f"{warm_ms:.4f} ms with L2 warm; one PyTorch call {lib_ms:.4f} ms; plain {p_ms:.4f} ms; "
              f"staged {staged / 1e6:.1f} MB", flush=True)
    del xs
    empty_ms = time_ms(lambda: op.empty_launch(n_tiles, 100), iters=1) / 100
    print(f"K5 floor [{smi}]: an empty launch of {n_tiles} blocks {empty_ms * 1e3:.2f} us (100 from one host "
          f"call); through the wrapper {script_rows[-2][3] * 1e3:.2f} us a call", flush=True)
    print(json.dumps({"k4_variants": list(rows.values()), "k5_configs": k5_rows,
                      "k5_empty_launch_ms": empty_ms}), flush=True)
    del x5, weights
    torch.cuda.empty_cache()
    k4, k5 = rows["bf16x3"], k5_rows[-1]
    return [
        {
            "name": "int8_dot_chain",
            "route": "cuda",
            "source": "upmix_tpu_torch/csrc/int8_dot.cu",
            "replaces": "scripts/bench_int8_dot.py:68",
            "launches": k4_launches,
            "max_abs_err": k4["max_abs_err"],
            "ms": k4["ms"],
            "plain_ms": k4["plain_ms"],
            "bound_ms": k4["bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
        },
        {
            "name": "overhead_probe",
            "route": "cuda",
            "source": "upmix_tpu_torch/csrc/overhead_probe.cu",
            "replaces": "scripts/bench_overhead_probe.py:34",
            "launches": k5_launches,
            "max_abs_err": k5_err,
            "ms": k5["device_ms"],
            "plain_ms": k5["plain_ms"],
            "bound_ms": k5["bound_ms"],
            "bound_by": "bytes",
            "library_ms": k5["library_ms"],
        },
    ]


class _Pipe:
    """A text stream with a byte buffer, standing in for stdin or stdout."""

    def __init__(self, data: bytes = b""):
        import io

        self.buffer = io.BytesIO(data)

    def write(self, text):
        self.buffer.write(text.encode())

    def flush(self):
        pass


def app_phases(smi: str, dev, path_rtf: float):
    """Phase 17: the app and CLI on the card, in process."""
    import contextlib
    import io
    import shutil
    from pathlib import Path

    from upmix_tpu_torch import cli
    from upmix_tpu_torch.app import load_stereo, scale_lcr
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.io import read_wav, write_wav
    from upmix_tpu_torch.models.offline import Upmixer
    from upmix_tpu_torch.models.offline import _plan_buckets, plans_from_numpy
    from upmix_tpu_torch.ops import omnibus, pool
    from upmix_tpu_torch.ops.omnibus import launches_per_bucket

    cfg = UpmixConfig.make(BAND_EDGES, sr=SR, max_block_size=MAX_BLOCK)
    per_file = sum(launches_per_bucket(b.block) for b in plans_from_numpy(_plan_buckets(cfg, 1), "cpu"))
    pool_cfg = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=POOL_HW)
    per_step = sum(pool.launches_per_bucket(b.block)
                   for b in pool.make_pool_plan(pool_cfg, POOL_HW, 1, device="cpu").buckets)
    work = Path(__file__).resolve().parent / "upmix_tpu_torch" / "_build" / "app_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        rng = np.random.default_rng(0)
        L = rng.standard_normal(N_SAMPLES).astype(np.float32)
        R = rng.standard_normal(N_SAMPLES).astype(np.float32)
        for name in ("song.wav", "again.wav"):
            write_wav(work / name, np.stack([L, R], 1), int(SR))
        edges = ",".join(str(int(e)) for e in BAND_EDGES)

        # Offline: split stems, two files (the second runs on warm plans).
        omnibus.LAUNCHES = 0
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main([str(work / "song.wav"), str(work / "again.wav"), "--out-dir", str(work / "out"),
                           "--export-mode", "split", "--band-edges", edges, "--meter"])
        launches = omnibus.LAUNCHES
        lines = stdout.getvalue().splitlines()
        meters = [ln for ln in lines if "x realtime" in ln]
        print(f"app e2e: cli.main offline split on 2 x {N_SAMPLES} samples: rc {rc}, omnibus launches "
              f"{launches} (want {2 * per_file}); " + "; ".join(meters) + f" (phase 5's kernel path {path_rtf:.1f}x realtime, "
              "the CLI's includes WAV load and write, and the plan build on the first file)", flush=True)
        if rc != 0 or launches != 2 * per_file:
            fail(f"the CLI's offline run failed or launched the omnibus kernels {launches} times, "
                 f"not {2 * per_file}")
        # --no-compile-cache: the kernels build afresh into a temporary
        # directory for that call alone, K1 still launches, and the cached
        # directory and library come back after it.
        from upmix_tpu_torch.ops import _build

        cached_dir, cached_lib = _build.BUILD_DIR, _build.load()
        built_in = []
        real_nvcc = _build._nvcc
        _build._nvcc = lambda: built_in.append(_build.BUILD_DIR) or real_nvcc()
        omnibus.LAUNCHES = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc_fresh = cli.main([str(work / "song.wav"), "--out-dir", str(work / "fresh"), "--band-edges",
                                     edges, "--no-compile-cache"])
        finally:
            _build._nvcc = real_nvcc
        fresh_s = time.perf_counter() - t0
        restored = _build.BUILD_DIR == cached_dir and _build._lib is cached_lib
        gone = bool(built_in) and not built_in[0].exists()
        print(f"app e2e: --no-compile-cache: rc {rc_fresh}, built into {built_in} (cached {cached_dir}), "
              f"nvcc {_build.build_seconds:.2f} s, omnibus launches {omnibus.LAUNCHES} (want {per_file}), "
              f"{fresh_s:.2f} s for the run; after it the cached directory and library back: {restored}, "
              f"the temporary directory removed: {gone}", flush=True)
        if (rc_fresh or omnibus.LAUNCHES != per_file or len(built_in) != 1 or built_in[0] == cached_dir
                or not restored or not gone):
            fail("--no-compile-cache did not build afresh into a temporary directory for the call alone, "
                 "or did not launch K1")
        stems = [p for p in lines if p.endswith(".wav") and Path(p).name.startswith("song_")]
        got = {Path(p).name.split("_")[1]: read_wav(p)[0] for p in stems}
        l64, r64, _, peak_in = load_stereo(work / "song.wav")
        C, Ls, Rs, _ = scale_lcr(*Upmixer(cfg, device=dev).process_np(l64.astype(np.float32),
                                                                   r64.astype(np.float32)), peak_in)
        same = (np.array_equal(got["C"][:, 0], C.astype(np.float32).astype(np.float64))
                and np.array_equal(got["Ls"][:, 0], Ls.astype(np.float32).astype(np.float64))
                and np.array_equal(got["Rs"][:, 1], Rs.astype(np.float32).astype(np.float64)))
        print(f"app e2e: stems equal Upmixer.process_np + scale_lcr bit for bit: {same}", flush=True)
        if not same:
            fail("the CLI's stems differ from Upmixer + scale_lcr")

        # Streaming and pipe on a short WAV of the stream server's config.
        n = 16 * POOL_HW
        write_wav(work / "short.wav", np.stack([L[:n], R[:n]], 1), int(POOL_SR))
        pool.LAUNCHES = 0
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main([str(work / "short.wav"), "--streaming", "--out-dir", str(work / "stream")])
        stream_launches = pool.LAUNCHES
        raw = np.stack([L[:n], R[:n]], 1).astype("<f4").tobytes()
        src, dst = _Pipe(raw), _Pipe()
        saved = sys.stdin, sys.stdout
        pool.LAUNCHES = 0
        try:
            sys.stdin, sys.stdout = src, dst
            rc_pipe = cli.main(["-", "--pipe", "--sr", str(int(POOL_SR))])
        finally:
            sys.stdin, sys.stdout = saved
        pipe_launches = pool.LAUNCHES
        out = np.frombuffer(dst.buffer.getvalue(), dtype="<f4").reshape(-1, 2)
        print(f"app e2e: --streaming on {n} samples rc {rc}, pool kernel launches {stream_launches}; --pipe rc "
              f"{rc_pipe}, {out.shape[0]} frames out of {n} in, pool kernel launches {pipe_launches}, finite "
              f"{bool(np.isfinite(out).all())}", flush=True)
        if rc or rc_pipe or stream_launches == 0 or pipe_launches == 0 or (stream_launches % per_step
                                                                           or pipe_launches % per_step):
            fail(f"--streaming or --pipe failed or launched the pool kernel a number of times that is not a "
                 f"multiple of {per_step} (one launch per bucket and step)")
        if out.shape[0] != n or not np.isfinite(out).all():
            fail("--pipe output is not as long as its input or not finite")

        # The job server: a ping and two jobs.
        jobs = "\n".join([json.dumps({"cmd": "ping"}),
                          json.dumps({"in": str(work / "song.wav"), "out_dir": str(work / "jobs")}),
                          json.dumps({"in": str(work / "short.wav"), "out_dir": str(work / "jobs")})]) + "\n"
        saved = sys.stdin
        omnibus.LAUNCHES = 0
        stdout = io.StringIO()
        try:
            sys.stdin = io.StringIO(jobs)
            with contextlib.redirect_stdout(stdout):
                rc = cli.main(["-", "--serve", "--band-edges", edges])
        finally:
            sys.stdin = saved
        resps = [json.loads(ln) for ln in stdout.getvalue().splitlines()]
        print(f"app e2e: --serve rc {rc}, omnibus launches {omnibus.LAUNCHES}, responses "
              + json.dumps([{k: r[k] for k in r if k in ("ok", "pong", "audio_seconds", "wall_s")} for r in resps]),
              flush=True)
        if rc or len(resps) != 3 or not all(r["ok"] for r in resps) or omnibus.LAUNCHES == 0:
            fail("--serve did not answer the ping and both jobs")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _tree_lists(tree):
    if isinstance(tree, dict):
        return {k: _tree_lists(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_tree_lists(v) for v in tree]
    return np.asarray(tree).tolist()


AOT_JSON_STREAMS = 16  # the JSON round trip of a snapshot (2048 streams' would be gigabytes of text)

# Phase 26's child: a fresh process loads the offline artifact and calls it twice.
_AOT_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
from upmix_tpu_torch import aot
from upmix_tpu_torch.ops import _build, omnibus
t1 = time.perf_counter()
art = aot.load(sys.argv[1])
torch.cuda.synchronize()
t2 = time.perf_counter()
x = torch.randn((2, art.n_samples), device="cuda", generator=torch.Generator("cuda").manual_seed(0))
torch.cuda.synchronize()
times = []
for _ in range(2):
    t3 = time.perf_counter()
    art.process(x[0], x[1])
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t3)
print(json.dumps({"import_s": t1 - t0, "load_s": t2 - t1, "nvcc_s": _build.build_seconds, "first_ms": times[0] * 1e3,
                  "second_ms": times[1] * 1e3, "launches": omnibus.LAUNCHES}))
"""


def aot_phases(smi: str, dev):
    """Phase 26: AOT artifacts saved, loaded onto the card, and held bit for
    bit against the live classes, each launching its kernels."""
    import contextlib
    import io
    import shutil
    from pathlib import Path

    from upmix_tpu_torch import aot, cli
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.offline import Upmixer, _plan_buckets, plans_from_numpy
    from upmix_tpu_torch.models.streaming import CudaStreamPool, StreamingUpmixer, make_stream_pool
    from upmix_tpu_torch.ops import omnibus, pool
    from upmix_tpu_torch.ops.omnibus import launches_per_bucket

    work = Path(__file__).resolve().parent / "upmix_tpu_torch" / "_build" / "aot_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    try:
        # The offline program: bench.py's config at 2^21 samples (K1).
        cfg = UpmixConfig.make(BAND_EDGES, sr=SR, max_block_size=MAX_BLOCK)
        want = sum(launches_per_bucket(b.block) for b in plans_from_numpy(_plan_buckets(cfg, 1), "cpu"))
        path = str(work / "offline.upmixaot")
        meta, save_s = timed(lambda: aot.save_offline(path, cfg, N_SAMPLES))
        art, load_s = timed(lambda: aot.load(path))
        rng = np.random.default_rng(26)
        Lt = torch.as_tensor(rng.standard_normal(N_SAMPLES), dtype=torch.float32, device=dev)
        Rt = torch.as_tensor(rng.standard_normal(N_SAMPLES), dtype=torch.float32, device=dev)
        omnibus.LAUNCHES = 0
        got, first_s = timed(lambda: art.process(Lt, Rt))
        launches = omnibus.LAUNCHES
        live, live_init_s = timed(lambda: Upmixer(cfg, device="cuda"))
        ref, live_first_s = timed(lambda: live.process(Lt, Rt))
        same = _equal(got, ref)
        n_short = N_SAMPLES - 12345
        short = art.process(Lt[:n_short], Rt[:n_short])
        short_ref = Upmixer(cfg, device="cuda", pad_granularity=N_SAMPLES).process(Lt[:n_short], Rt[:n_short])
        short_same = _equal(short, short_ref) and all(o.shape == (n_short,) for o in short)
        try:
            art.process(torch.zeros(N_SAMPLES + 1), torch.zeros(N_SAMPLES + 1))
            refused = False
        except ValueError:
            refused = True
        print(f"aot [{smi}]: offline artifact of bench.py's config at {N_SAMPLES} samples: "
              f"{Path(path).stat().st_size} bytes, save {save_s:.3f} s, load {load_s:.3f} s (the kernel library "
              "already loaded in this process), first "
              f"call {first_s * 1e3:.1f} ms; the live Upmixer: construction {live_init_s * 1e3:.3f} ms, first call "
              f"{live_first_s * 1e3:.1f} ms (its plan built there); K1 launches per call {launches} (want {want}); "
              f"bit for bit the live Upmixer {same}; {n_short} samples padded and trimmed as Upmixer("
              f"pad_granularity={N_SAMPLES}) {short_same}; a longer input refused {refused}", flush=True)
        if launches != want or not same or not short_same or not refused:
            fail("the offline artifact did not launch K1 as Upmixer does or differs from it")
        del got, ref, short, short_ref, art, live, Lt, Rt

        # A serving host's load: a fresh process, with the kernel library
        # cached (the checkout's build directory) and with none (a new
        # $UPMIX_TORCH_BUILD_DIR: the load compiles the kernels).
        for label, env in (("library cached", {}), ("no library", {"UPMIX_TORCH_BUILD_DIR": str(work / "cold")})):
            res = subprocess.run([sys.executable, "-c", _AOT_CHILD, path], capture_output=True, text=True,
                                 env={**os.environ, **env}, timeout=600)
            if res.returncode != 0:
                fail(f"a fresh process could not load the offline artifact: {res.stderr[-2000:]}")
            child = json.loads(res.stdout.strip().splitlines()[-1])
            print(f"aot [{smi}]: offline artifact in a fresh process, {label}: import {child['import_s']:.3f} s, "
                  f"load {child['load_s']:.3f} s (nvcc {child['nvcc_s']:.2f} s of it), first call "
                  f"{child['first_ms']:.1f} ms, second {child['second_ms']:.2f} ms, K1 launches {child['launches']}",
                  flush=True)
            if child["launches"] != 2 * want:
                fail("the offline artifact in a fresh process did not launch K1")

        # The serving pool: the Bela config at S = 2048, both OLA modes, hops 1 and 4.
        pcfg = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=POOL_HW)
        for ola in ("time", "spectral"):
            for hops in (1, 4):
                path = str(work / f"pool_{ola}_{hops}.upmixaot")
                _, save_s = timed(lambda: aot.save_stream_pool(path, pcfg, POOL_HW, POOL_STREAMS, ola=ola, hops=hops))
                art, load_s = timed(lambda: aot.load(path))
                live, live_init_s = timed(lambda: make_stream_pool(pcfg, POOL_HW, POOL_STREAMS, ola=ola))
                if not isinstance(live, CudaStreamPool):
                    fail("make_stream_pool did not return the CUDA pool")
                rng = np.random.default_rng(hops)
                x = torch.as_tensor(rng.standard_normal((POOL_BLOCKS // hops, 2, POOL_STREAMS, hops * POOL_HW)) * 0.3,
                                    dtype=torch.float32, device=dev)

                def push(p, blk):
                    return p.push_blocks_multi(blk[0], blk[1]) if hops > 1 else p.push_blocks(blk[0], blk[1])

                counts = (pool.LAUNCHES, pool.SPECTRAL_LAUNCHES, pool.EDGE_LAUNCHES)
                pool.LAUNCHES = pool.SPECTRAL_LAUNCHES = pool.EDGE_LAUNCHES = 0
                first, first_s = timed(lambda: push(art, x[0]))
                outs = [first] + [push(art, blk) for blk in x[1:]]
                k3, k3s, edge = pool.LAUNCHES, pool.SPECTRAL_LAUNCHES, pool.EDGE_LAUNCHES
                same = all(_equal(o, push(live, blk)) for o, blk in zip(outs, x))
                snap = art.snapshot()
                fresh = aot.load(path)
                fresh.restore(snap)
                cont = _equal(push(fresh, x[0]), push(live, x[0]))
                pool.LAUNCHES, pool.SPECTRAL_LAUNCHES, pool.EDGE_LAUNCHES = counts
                launched = (k3 > 0 and k3s == 0) if ola == "time" else (k3s > 0 and edge > 0 and k3 == 0)
                print(f"aot [{smi}]: pool artifact ola={ola} hops={hops} S={POOL_STREAMS}: "
                      f"{Path(path).stat().st_size} bytes, save {save_s:.3f} s, load {load_s:.3f} s, first call "
                      f"{first_s * 1e3:.2f} ms; the live make_stream_pool: construction {live_init_s:.3f} s; over "
                      f"{POOL_BLOCKS} blocks K3 launches {k3}, K3s launches {k3s} (edge product {edge}); bit for bit "
                      f"the live pool {same}; a snapshot restored into a fresh load continues bit for bit {cont}",
                      flush=True)
                if not launched or not same or not cont:
                    fail(f"the pool artifact (ola={ola}, hops={hops}) did not launch its kernels or differs from the "
                         "live pool")
                del art, live, fresh, outs, first, snap, x
                torch.cuda.empty_cache()

                # The snapshot through JSON, at the server's default slot count.
                path = str(work / f"pool_{ola}_{hops}_small.upmixaot")
                aot.save_stream_pool(path, pcfg, POOL_HW, AOT_JSON_STREAMS, ola=ola, hops=hops)
                art, live = aot.load(path), CudaStreamPool(pcfg, POOL_HW, AOT_JSON_STREAMS, ola=ola)
                x = torch.as_tensor(rng.standard_normal((POOL_BLOCKS // hops + 1, 2, AOT_JSON_STREAMS,
                                                         hops * POOL_HW)) * 0.3, dtype=torch.float32, device=dev)
                for blk in x[:-1]:
                    push(art, blk)
                    push(live, blk)
                text = json.dumps(_tree_lists(art.snapshot()))
                art.restore(json.loads(text))
                cont = _equal(push(art, x[-1]), push(live, x[-1]))
                print(f"aot: pool artifact ola={ola} hops={hops} S={AOT_JSON_STREAMS}: snapshot through JSON "
                      f"({len(text)} characters) restored, continues bit for bit {cont}", flush=True)
                if not cont:
                    fail("a pool artifact's snapshot did not continue bit for bit after JSON")
                del art, live, x

        # The streaming step at hw 2048 (K3).
        path = str(work / "step.upmixaot")
        _, save_s = timed(lambda: aot.save_stream_step(path, pcfg, POOL_HW))
        art, load_s = timed(lambda: aot.load(path))
        live, live_init_s = timed(lambda: StreamingUpmixer(pcfg, POOL_HW, device="cuda"))
        rng = np.random.default_rng(7)
        x = rng.standard_normal((POOL_BLOCKS, 2, POOL_HW)).astype(np.float32) * 0.3
        pool.LAUNCHES = 0
        got = [art.push_block(b[0], b[1]) for b in x]
        k3 = pool.LAUNCHES
        same = all(_equal(g, live.push_block(b[0], b[1])) for g, b in zip(got, x))
        nonzero = bool(got[-1][0].abs().max() > 0)
        print(f"aot [{smi}]: stream-step artifact hw={POOL_HW}: {Path(path).stat().st_size} bytes, save {save_s:.3f} s, "
              f"load {load_s:.3f} s; StreamingUpmixer construction {live_init_s:.3f} s; K3 launches over "
              f"{POOL_BLOCKS} blocks {k3}; bit for bit StreamingUpmixer {same}, signal after warmup {nonzero}",
              flush=True)
        if not k3 or not same or not nonzero:
            fail("the stream-step artifact did not launch K3 or differs from StreamingUpmixer")

        # The CLI's --save-aot, all three kinds, each loaded onto the card.
        edges = ",".join(str(int(e)) for e in BAND_EDGES)
        pedges = ",".join(str(int(e)) for e in POOL_EDGES)
        kinds = {
            "cli_offline": ["--sr", str(int(SR)), "--band-edges", edges],
            "cli_step": ["--sr", str(int(POOL_SR)), "--band-edges", pedges, "--aot-stream"],
            "cli_pool": ["--sr", str(int(POOL_SR)), "--band-edges", pedges, "--aot-pool", str(POOL_STREAMS),
                         "--aot-hops", "4", "--pool-ola", "spectral"],
        }
        loaded = []
        for name, extra in kinds.items():
            path = str(work / f"{name}.upmixaot")
            stdout = io.StringIO()
            with contextlib.redirect_stdout(stdout):
                rc = cli.main(["-", "--save-aot", path, *extra])
            line = json.loads(stdout.getvalue().strip().splitlines()[-1])
            art = aot.load(path)
            loaded.append(f"{name} rc {rc} {line['type']} {line['platforms']} -> {type(art).__name__}")
            if rc or line["platforms"] != ["cuda"]:
                fail(f"--save-aot ({name}) failed")
        print("aot: the CLI's --save-aot, then load: " + "; ".join(loaded), flush=True)

        # A JAX artifact, written by hand (the port needs no jax), is refused.
        path = work / "jax.upmixaot"
        jax_meta = {"format": 1, "type": "offline", "config": {}, "n_samples": 4096, "kernel": "mm",
                    "platforms": ["tpu"], "jax_version": "0.0"}
        path.write_bytes(b"UPMIXAOT1\n" + json.dumps(jax_meta).encode() + b"\n" + b"\0" * 64)
        try:
            aot.load(str(path))
            msg = None
        except ValueError as e:
            msg = str(e)
        print(f"aot: a JAX artifact: read_meta type {aot.read_meta(str(path))['type']}, load refused: {msg}",
              flush=True)
        if msg is None or "JAX package artifact" not in msg or "\n" in msg:
            fail("load did not refuse a JAX artifact with one line")
    finally:
        shutil.rmtree(work, ignore_errors=True)


SERVER_SLOTS = 16  # the CLI's --streams default
SERVER_CLIENTS = 8
SERVER_BLOCKS = 48
SERVER_CUT = 24  # blocks before the checkpoint
LOAD_SLOTS = 2048
LOAD_CLIENTS = 16
LOAD_BLOCKS = 64  # per client: 2.7 s of audio at 48 kHz


def _direct_frames(pool, x, hops: int) -> np.ndarray:
    """What the server's clients at slots 0..C-1 must receive (lcr,
    warmup-aligned): x [C, n_blocks * hw, 2] pushed through `pool` in the
    server's cycles of `hops` blocks, then drain cycles of zero blocks.
    -> [C, n_blocks * hw, 3]."""
    C, n, _ = x.shape
    hw, S = pool.hw_block_size, pool.n_streams
    total = -(-(n // hw + pool.warmup_blocks - 1) // hops) * hops * hw
    xs = np.zeros((S, total, 2), np.float32)
    xs[:C, :n] = x
    push = pool.push_blocks_multi if hops > 1 else pool.push_blocks
    outs = [torch.stack(push(xs[:, i : i + hops * hw, 0], xs[:, i : i + hops * hw, 1]), -1)[:C].cpu().numpy()
            for i in range(0, total, hops * hw)]
    skip = (pool.warmup_blocks - 1) * hw
    return np.concatenate(outs, axis=1)[:, skip : skip + n]


def _serve_clients(sessions, x, first: int, last: int, due: int, finish: bool) -> np.ndarray:
    """Each session (one thread each) sends blocks [first, last) of its
    signal x[c] and reads `due` frames -> [C, due, 3]."""
    import threading

    hw = sessions[0].hw
    got, errors = [None] * len(sessions), []

    def run(c):
        try:
            for b in range(first, last):
                sessions[c].send_block(x[c, b * hw : (b + 1) * hw, 0], x[c, b * hw : (b + 1) * hw, 1])
            if finish:
                sessions[c].finish()
            got[c] = sessions[c].recv_frames(due)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(c,)) for c in range(len(sessions))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors or any(t.is_alive() for t in threads):
        fail(f"stream-server clients failed: {errors or 'timed out'}")
    return np.stack(got)


def server_phases(smi: str, dev):
    """Phase 18: the stream server on the card, in process, on loopback."""
    import tempfile
    from pathlib import Path

    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.streaming import CudaStreamPool
    from upmix_tpu_torch.ops import pool
    from upmix_tpu_torch.serve_stream import StreamSession, fetch_metrics, run_stream_server

    kw = dict(sr=POOL_SR, hw_block_size=POOL_HW, band_edges=POOL_EDGES, verbose=False, device=dev)
    cfg = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=POOL_HW)
    rng = np.random.default_rng(18)
    n = SERVER_BLOCKS * POOL_HW
    x = (rng.standard_normal((SERVER_CLIENTS, n, 2)) * 0.3).astype(np.float32)
    refs = {h: _direct_frames(CudaStreamPool(cfg, POOL_HW, SERVER_SLOTS, device=dev), x, h) for h in (1, 4)}
    skip = (CudaStreamPool(cfg, POOL_HW, 1, device=dev).warmup_blocks - 1) * POOL_HW
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/sessions.npz"
        for hops, pipeline in ((1, 1), (4, 1), (1, 2)):
            pool.LAUNCHES = 0
            srv = run_stream_server(0, n_streams=SERVER_SLOTS, lockstep=True, hops=hops, pipeline=pipeline, **kw)
            try:
                if not isinstance(srv.pool, CudaStreamPool) or srv.pool.device != dev:
                    fail(f"run_stream_server built {type(srv.pool).__name__} on {srv.pool.device}, not the CUDA "
                         f"pool on {dev}")
                sessions = [StreamSession(*srv.address, mix="lcr") for _ in range(SERVER_CLIENTS)]
                if [s.slot for s in sessions] != list(range(SERVER_CLIENTS)):
                    fail(f"sessions got slots {[s.slot for s in sessions]}")
                if hops == 1 and pipeline == 1:  # cut mid-stream: checkpoint, resume on a fresh server
                    part1 = _serve_clients(sessions, x, 0, SERVER_CUT, SERVER_CUT * POOL_HW - skip, False)
                    saved = srv.save_checkpoint(ckpt)
                    for s in sessions:
                        s.close()
                    srv.close()
                    srv = run_stream_server(0, n_streams=SERVER_SLOTS, lockstep=True, snapshot_path=ckpt, **kw)
                    tokens = [s.token for s in sessions]
                    sessions = [StreamSession(*srv.address, mix="lcr", token=t) for t in tokens]
                    resumed = [s.server_in_frames for s in sessions]
                    if saved != SERVER_CLIENTS or resumed != [SERVER_CUT * POOL_HW] * SERVER_CLIENTS:
                        fail(f"checkpoint saved {saved} sessions, resumed at {resumed}")
                    part2 = _serve_clients(sessions, x, SERVER_CUT, SERVER_BLOCKS, n - part1.shape[1], True)
                    got = np.concatenate([part1, part2], axis=1)
                else:
                    got = _serve_clients(sessions, x, 0, SERVER_BLOCKS, n, True)
                for s in sessions:
                    s.close()
                snap = fetch_metrics(*srv.address)
                text = fetch_metrics(*srv.address, fmt="prometheus")
            finally:
                srv.close()
            launches = pool.LAUNCHES
            same = bool(np.array_equal(got, refs[hops]))
            err = float(np.abs(got - refs[hops]).max())
            cut = f" (checkpoint and resume at block {SERVER_CUT})" if hops == 1 and pipeline == 1 else ""
            print(f"server e2e [{smi}] hops={hops} pipeline={pipeline}{cut}: "
                  f"{SERVER_CLIENTS} clients x {SERVER_BLOCKS} blocks on {SERVER_SLOTS} slots, K3 launches {launches}, "
                  f"frames equal the pool fed directly bit for bit: {same} (max abs err {err:.3g})", flush=True)
            if launches == 0 or not same:
                fail(f"the stream server at hops {hops}, pipeline {pipeline} launched K3 {launches} times or its "
                     "frames differ from the pool fed directly")
        samples = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
        frames = SERVER_CLIENTS * n
        print(f"server metrics: JSON counters {json.dumps(snap['counters'])}; Prometheus text {len(samples)} samples "
              f"parsed, upmix_frames_total {samples.get('upmix_frames_total')}, cycle_seconds count "
              f"{samples.get('upmix_cycle_seconds_count')}", flush=True)
        if samples.get("upmix_frames_total") != frames or snap["counters"]["frames"] != frames:
            fail(f"the server's metrics count {samples.get('upmix_frames_total')} / {snap['counters']['frames']} "
                 f"frames, not {frames}")
    print(f"server e2e: {time.perf_counter() - t0:.1f} s for the three runs", flush=True)

    # A 2048-slot server in real-time mode (the deployment mode) with 16
    # live clients streaming as fast as they can, from another process (in
    # this one they would contend for the interpreter with the server's
    # threads): one cycle per 42.67 ms.  A short round first warms the
    # pool; the measured window is the second round's cycles.  At
    # pipeline 2 the dispatch histogram is the wait for the previous
    # cycle's outputs, which the card computed while the host waited for
    # the tick: it reads how much of the device's work the host still waits on.
    for pipeline in (1, 2):
        srv = run_stream_server(0, n_streams=LOAD_SLOTS, pipeline=pipeline, **kw)
        try:
            windows = []
            for blocks in (4, LOAD_BLOCKS):
                before = srv.metrics.snapshot()
                pool.LAUNCHES = 0
                t0 = time.perf_counter()
                res = subprocess.run([sys.executable, "-c", LOAD_CLIENTS_CODE, *map(str, srv.address),
                                      str(LOAD_CLIENTS), str(blocks), str(POOL_HW), str(POOL_SR)],
                                     cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True,
                                     timeout=120)
                windows.append((before, srv.metrics.snapshot(), time.perf_counter() - t0, pool.LAUNCHES))
                if res.returncode != 0 or "clients ok" not in res.stdout:
                    fail(f"the 2048-slot server's clients failed: {res.stdout[-2000:]} {res.stderr[-2000:]}")
        finally:
            srv.close()
        before, after, wall, launches = windows[-1]
        cyc = _window(before["cycle_seconds"], after["cycle_seconds"])
        dis = _window(before["dispatch_seconds"], after["dispatch_seconds"])
        counts = {k: after["counters"][k] - before["counters"][k] for k in ("blocks", "late_zero_blocks")}
        print(f"server load [{smi}] pipeline={pipeline}: {LOAD_SLOTS} slots, {LOAD_CLIENTS} live clients (another "
              f"process) x {LOAD_BLOCKS} blocks in real time ({wall:.2f} s wall with the client process's start, "
              f"{counts['blocks']} blocks, {counts['late_zero_blocks']} late zero blocks, K3 launches {launches}): "
              f"cycle p50 {cyc['p50'] * 1e3:.1f} ms p99 {cyc['p99'] * 1e3:.1f} ms (bucket upper bounds) mean "
              f"{cyc['mean'] * 1e3:.3f} ms over {cyc['count']} cycles; dispatch p50 {dis['p50'] * 1e3:.1f} ms p99 "
              f"{dis['p99'] * 1e3:.1f} ms mean {dis['mean'] * 1e3:.3f} ms; deadline {POOL_HW / POOL_SR * 1e3:.2f} ms",
              flush=True)
        if launches == 0 or cyc["count"] == 0:
            fail("the 2048-slot server ran no cycle on the card")


# The load phase's clients: argv host, port, clients, blocks, hw, sr; each
# client streams its seeded signal through stream_client on its own thread.
LOAD_CLIENTS_CODE = """
import sys, threading
import numpy as np
from upmix_tpu_torch.serve_stream import stream_client
host = sys.argv[1]
port, n, blocks, hw = (int(a) for a in sys.argv[2:6])
sr = float(sys.argv[6])
sig = (np.random.default_rng(blocks).standard_normal((n, blocks * hw, 2)) * 0.3).astype(np.float32)
outs = [None] * n
def run(c):
    outs[c] = stream_client(host, port, sig[c, :, 0], sig[c, :, 1], expect_sr=sr)
threads = [threading.Thread(target=run, args=(c,)) for c in range(n)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=100)
assert all(o is not None and len(o[0]) == blocks * hw and np.isfinite(o).all() for o in outs)
print("clients ok")
"""


def _window(a: dict, b: dict) -> dict:
    """A LatencyHistogram's records between snapshots a and b: count, mean
    and the p50 and p99 of LatencyHistogram.quantile (the first bucket
    bound whose cumulative count reaches q x count; b's max past the last)."""
    count = b["count"] - a["count"]
    cum = [(bound, cb - ca) for (bound, cb), (_, ca) in zip(b["buckets"], a["buckets"])]
    out = {"count": count, "mean": (b["sum"] - a["sum"]) / max(count, 1)}
    for q in (0.5, 0.99):
        out[f"p{int(q * 100)}"] = next((bound for bound, c in cum if count and c >= q * count), b["max"])
    return out

if __name__ == "__main__":
    main()
