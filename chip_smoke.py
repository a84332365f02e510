"""Smoke run of the PyTorch/CUDA port (upmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths: the offline upmix of bench.py's config
(6 bands at 0/30/120/480/1920/7680 Hz, 44.1 kHz, blocks up to 65536) on
2^21 samples of seeded noise, through `Upmixer(cfg, device="cuda")`; the
same config sharded, two files of 2^21 samples on a data 2 x seq 4 mesh
of the one card, through `ShardedUpmixer`, and in batches through
`BatchUpmixer`; and the serving pool of the stream server's default
config (the Bela setup: edges 0/500/2000/8000 Hz, 48 kHz, hardware block
2048) at 2048 streams, through `make_stream_pool(cfg, 2048, 2048)`.
Phases, one line each or more, any failure exits nonzero (phases 10-13
run between 5 and 6):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every csrc/*.cu into upmix_tpu_torch/_build/;
  3. kernel parity: the omnibus kernel against its plain version run in
     float64 on the card, per bucket and for the whole plan (>= 80 dB);
  4. end to end: Upmixer must launch the kernel, and its output must
     match the float64 whole-file torch.fft path at bench.py's three
     probe slices (>= 60 dB); silence gives exact zeros, mono gives
     Ls, Rs <= 1e-5;
  5. timing: realtime factor of the kernel path and of the plain
     whole-file torch.fft path, the kernel path on a 4-segment input,
     and the kernel alone against its plain version on one chunk, whole
     and per bucket (CUDA events, min over loops); then device time by
     kernel and the idle share under torch.profiler;
  6. pool kernel parity: the pool step kernel (K3) against its plain
     version in float64 on the card, at 2048 streams with mixed block
     counts and nonzero carries, hops 1 and 4, per bucket and whole
     (>= 80 dB, exact zeros where the plain version has them); the floor
     probe (K6) bit for bit, both modes;
  7. pool end to end: the default make_stream_pool must be the CUDA pool
     and launch K3; 12 blocks of seeded noise, the first K-1 exact zeros,
     the rest >= 60 dB against a float64 run of the plain step with its
     own state; reset_streams re-warms one slot and leaves the others
     bit-identical; silence gives zeros, mono gives Ls, Rs <= 1e-5; then
     the floor probe's own run (history shift + K6, 12 blocks), and
     StreamingUpmixer on the card (it must launch K3, >= 60 dB);
  8. pool timing: ms per block at 16, 2048, 7168 and 7680 streams and at hops
     4, on device-resident blocks, with the throughput S x 42.67 ms / (ms
     per block) each extrapolates to and whether it meets the deadline;
     K3 against its plain version, per bucket; the history shift; K6 copy
     and frame; device time by kernel and the idle share under
     torch.profiler;
  9. a JSON line of per-kernel results (launches from the main paths'
     runs; bounds from this run's shapes and the least work of each
     function: its FFTs or its bytes, whichever takes longer), then the
     last line {"ok": true, "device": {...}};
 10. fused kernel parity: K2 against its plain version in float64 on the
     card, on the three buckets the sharded path routes to it, at the
     sharded geometry (8 rows of one 2^19 chunk; >= 80 dB);
 11. sharded end to end: ShardedUpmixer on the 2 x 4 mesh must launch K2
     3 times and K1 6 times per call, match the float64 whole-file path
     (>= 60 dB) and Upmixer within 64 samples of each shard edge (< 1e-3),
     the data-only mesh likewise, and give exact zeros for silence;
 12. BatchUpmixer.process_files, sequential and pipelined, bit-identical
     to each other and within 1e-3 of Upmixer;
 13. timing: the sharded path's realtime factor; K2 alone per bucket
     against K1 alone on the same bucket and against the plain version;
     K2's bound and design lines; the profiler's idle share.

Exits nonzero without a result when no CUDA device is present.  Needs no
jax: the GPU machine does not have it.
"""

import json
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
# Pools near the size that S = 2048's rate extrapolates to at the 42.67 ms
# deadline (about 7,900 streams), in steps of 512: timed too, to see which
# pool sizes meet the deadline.
POOL_CAPACITY_STREAMS = (7168, 7680)

# The sharded path: two files of 2^21 samples on a data 2 x seq 4 mesh
# whose eight shards share the one card (one chunk of 2^19 samples each);
# BatchUpmixer on three files in batches of two.
SHARD_MESH = {"data": 2, "seq": 4}
SHARD_FILES = 2
SHARD_SAMPLES = 2**21
BATCH_FILES, BATCH_SIZE, BATCH_SAMPLES = 3, 2, 2**20

# NVIDIA H100 SXM at its 700 W limit (the data sheet): FP32 outside the
# tensor cores and HBM3.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound(flop: float, nbytes: float):
    """(ms, "operations" | "bytes"): the least time for the work on the card."""
    t_op, t_b = flop / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def fft_flop(frames: int, block: int) -> float:
    """Least operations of one bucket's transforms: per frame two forward
    and three inverse real FFTs of length B, 2.5 B log2 B FLOP each (half
    the usual 5 N log2 N of a complex FFT)."""
    return 5 * frames * 2.5 * block * np.log2(block)


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


def device_share(fn, iters: int = 5) -> str:
    """Device time by kernel and the device's busy share over `iters`
    calls of fn, from torch.profiler.  Only the kernels' own rows count:
    an operator's row repeats the device time of the kernels it launched."""
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
    print(f"plan: {len(plan.buckets)} buckets, halo {plan.halo}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
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
    ref = torch.cat(omnibus_lcr_batch_plain(x.double(), plan), dim=-1)
    torch.cuda.synchronize()
    snrs = [snr_db(ref[:, o], got[:, o]) for o in range(3)]
    max_abs_err = float((got.double() - ref).abs().max())
    worst = min(worst, *snrs)
    print("parity all buckets: " + ", ".join(f"{n} {s:.1f} dB" for n, s in zip(OUTPUTS, snrs))
          + f", max abs err {max_abs_err:.3e} (bar >= {KERNEL_BAR_DB} dB)", flush=True)
    if not (worst >= KERNEL_BAR_DB):
        fail(f"kernel parity {worst:.1f} dB < {KERNEL_BAR_DB} dB")
    del got, ref

    # 4. end to end through the user's entry point
    audio = np.random.default_rng(0)  # as bench.py:99-101 builds its input
    L = audio.standard_normal(N_SAMPLES).astype(np.float32)
    R = audio.standard_normal(N_SAMPLES).astype(np.float32)
    up = Upmixer(cfg, device="cuda")
    omnibus.LAUNCHES = 0
    outs = up.process_np(L, R)
    launches = omnibus.LAUNCHES
    print(f"e2e: Upmixer.process_np on {N_SAMPLES} samples, kernel launches {launches}", flush=True)
    if launches == 0:
        fail("the main path launched no omnibus kernel")
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
    print(f"e2e: silence max |out| {silent}, mono max |Ls|,|Rs| {mono:.3e}", flush=True)
    if silent != 0.0:
        fail("silence in did not give exact zeros out")
    if mono > 1e-5:
        fail(f"mono in gave side energy {mono:.3e} > 1e-5")

    # 5. timing
    audio_s = N_SAMPLES / SR
    Lt = torch.as_tensor(L, device=dev)
    Rt = torch.as_tensor(R, device=dev)
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
    for b in plan.buckets:
        sub = make_omnibus_plan([b], CHUNK_SAMPLES)
        xb = x[..., : CHUNK_SAMPLES + sub.halo].contiguous()
        k_ms = time_ms(lambda: omnibus_lcr_batch(xb, sub))
        p_ms = time_ms(lambda: omnibus_lcr_batch_plain(xb, sub))
        gflop = 20.0 * CHUNK_SAMPLES // b.hop * b.block * b.kept / 1e9  # 2 x 10 F B K
        parts.append(f"B={b.block} {k_ms:.3f} ms ({gflop / k_ms:.1f} TFLOP/s) vs plain {p_ms:.3f} ms")
    print(f"timing [{smi}]: per bucket: " + "; ".join(parts), flush=True)
    print(f"profile: {device_share(lambda: up.process(Lt, Rt))}", flush=True)

    # K1's bound on one chunk, from the least work of the function: the FFTs
    # of every frame, x read and y written once, gains and windows read.
    k1_flop = sum(fft_flop(CHUNK_SAMPLES // b.hop, b.block) for b in plan.buckets)
    k1_bytes = 4 * (5 * (CHUNK_SAMPLES + plan.halo)
                    + sum(2 * b.block + b.gains.numel() for b in plan.buckets))
    k1_bound, k1_by = bound(k1_flop, k1_bytes)
    print(f"bound [{smi}]: omnibus {k1_flop:.3e} FLOP by FFT, {k1_bytes / 1e9:.3f} GB per chunk -> "
          f"{k1_bound:.3f} ms ({k1_by}); kernel at {k1_bound / kernel_ms:.1%} of it", flush=True)
    # The kernel's own design, the direct banded DFT: 2 x 10 F B K FLOP, weights read too.
    d_flop = sum(20.0 * CHUNK_SAMPLES // b.hop * b.block * b.kept for b in plan.buckets)
    d_bound, _ = bound(d_flop, k1_bytes + 4 * sum(4 * b.block * b.kept for b in plan.buckets))
    print(f"design [{smi}]: omnibus direct DFT {d_flop:.3e} FLOP -> {d_bound:.3f} ms at FP32 peak; "
          f"kernel at {d_bound / kernel_ms:.1%} of it ({d_flop / kernel_ms / 1e9:.1f} TFLOP/s)", flush=True)
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
        "library_ms": None,
    }]
    kernels.append(sharded_phases(smi, dev))
    kernels += pool_phases(smi, dev)

    # 9. results
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
    from upmix_tpu_torch.ops.omnibus import make_omnibus_plan, omnibus_lcr_batch, omnibus_lcr_batch_plain
    from upmix_tpu_torch.parallel import ShardedUpmixer, make_mesh, sequence_plan
    from upmix_tpu_torch.parallel.sharded import _plan_seq_buckets, route_buckets

    cfg = UpmixConfig.make(BAND_EDGES, sr=SR, max_block_size=MAX_BLOCK)
    splan = sequence_plan(cfg, SHARD_SAMPLES, SHARD_MESH["seq"])
    chunk, S = splan.chunk, SHARD_FILES * SHARD_MESH["seq"]
    omni_plan, narrow = route_buckets(plans_from_numpy(_plan_seq_buckets(cfg), dev), chunk)
    print(f"sharded plan: mesh {SHARD_MESH} on one card, chunk {chunk} per shard, halo {splan.halo}; "
          f"K2 buckets {[b.block for b in narrow]}, K1 buckets {[b.block for b in omni_plan.buckets]}",
          flush=True)
    if [b.block for b in narrow] != [4096, 1024, 256] or [b.block for b in omni_plan.buckets] != [65536, 16384]:
        fail("bucket routing differs from 4096/1024/256 -> K2, 65536/16384 -> K1")

    # 10. K2 parity at the sharded geometry: S rows of one chunk each
    rng = np.random.default_rng(4)
    xs = {b.block: torch.as_tensor(rng.standard_normal((S, 2, chunk + b.spill)), dtype=torch.float32,
                                   device=dev) for b in narrow}
    worst, max_abs_err = float("inf"), 0.0
    for b in narrow:
        x = xs[b.block]
        got = torch.cat(fused_bucket_lcr_batch(x, b), dim=-1)
        ref = torch.cat(fused_bucket_lcr_batch_plain(x.double(), b), dim=-1)
        torch.cuda.synchronize()
        snrs = [snr_db(ref[:, o], got[:, o]) for o in range(3)]
        err = float((got.double() - ref).abs().max())
        max_abs_err = max(max_abs_err, err)
        worst = min(worst, *snrs)
        print(f"K2 parity B={b.block} H={b.hop} K={b.kept} (S={S}, chunk {chunk}): "
              + ", ".join(f"{n} {v:.1f} dB" for n, v in zip(OUTPUTS, snrs))
              + f", max abs err {err:.3e} (bar >= {KERNEL_BAR_DB} dB)", flush=True)
    if not (worst >= KERNEL_BAR_DB):
        fail(f"fused kernel parity {worst:.1f} dB < {KERNEL_BAR_DB} dB")
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
    if k2_launches != 3 or k1_launches != 6:
        fail(f"sharded call launched K2 {k2_launches} times (want 3) and K1 {k1_launches} (want 6)")
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
    k2_ms = k2_plain_ms = 0.0
    parts = []
    for b in narrow:
        x = xs[b.block]
        sub = make_omnibus_plan([b], chunk)
        t_k2 = time_ms(lambda: fused_bucket_lcr_batch(x, b))
        t_k1 = time_ms(lambda: omnibus_lcr_batch(x, sub))
        t_plain = time_ms(lambda: fused_bucket_lcr_batch_plain(x, b))
        k2_ms, k2_plain_ms = k2_ms + t_k2, k2_plain_ms + t_plain
        gflop = 20.0 * S * chunk // b.hop * b.block * b.kept / 1e9
        parts.append(f"B={b.block} K2 {t_k2:.3f} ms ({gflop / t_k2:.1f} TFLOP/s), K1 {t_k1:.3f} ms "
                     f"(K2/K1 {t_k2 / t_k1:.2f}), plain {t_plain:.3f} ms")
    print(f"timing [{smi}]: per bucket (S={S}, chunk {chunk}): " + "; ".join(parts), flush=True)
    # K2's bound over its three buckets, from the least work of the function:
    # the FFTs of every frame; x read once per bucket, y written once.
    k2_flop = sum(fft_flop(S * chunk // b.hop, b.block) for b in narrow)
    k2_bytes = 4 * sum(5 * S * (chunk + b.spill) + 2 * b.block + b.gains.numel() for b in narrow)
    k2_bound, k2_by = bound(k2_flop, k2_bytes)
    print(f"bound [{smi}]: fused {k2_flop:.3e} FLOP by FFT, {k2_bytes / 1e9:.3f} GB over its three buckets -> "
          f"{k2_bound:.3f} ms ({k2_by}); kernel {k2_ms:.3f} ms, at {k2_bound / k2_ms:.1%} of it", flush=True)
    d_flop = sum(20.0 * S * chunk // b.hop * b.block * b.kept for b in narrow)
    d_bound, _ = bound(d_flop, k2_bytes + 4 * sum(4 * b.block * b.kept for b in narrow))
    print(f"design [{smi}]: fused direct DFT {d_flop:.3e} FLOP -> {d_bound:.3f} ms at FP32 peak; "
          f"kernel at {d_bound / k2_ms:.1%} of it ({d_flop / k2_ms / 1e9:.1f} TFLOP/s)", flush=True)
    print(f"sharded profile: {device_share(lambda: su.process_batch(audio), iters=3)}", flush=True)
    del su, audio, y, xs
    torch.cuda.empty_cache()
    return {
        "name": "fused_bucket_lcr",
        "route": "cuda",
        "source": "upmix_tpu_torch/csrc/fused.cu",
        "replaces": "upmix_tpu/ops/pallas_upmix.py:252",
        "launches": k2_launches,
        "max_abs_err": max_abs_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }


def pool_phases(smi: str, dev) -> list:
    """Phases 6-8 on the serving pool; returns the K3 and K6 result entries."""
    import dataclasses

    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.streaming import CudaStreamPool, StreamingUpmixer, make_stream_pool
    from upmix_tpu_torch.ops import omnibus, pool, pool_floor
    from upmix_tpu_torch.ops.pool import make_pool_plan, pool_step_lcr, pool_step_lcr_plain
    from upmix_tpu_torch.ops.pool_floor import floor_bytes, pool_floor_plain

    cfg = UpmixConfig.streaming(POOL_EDGES, sr=POOL_SR, hw_block_size=POOL_HW)
    S, hw = POOL_STREAMS, POOL_HW
    plan = make_pool_plan(cfg, hw, S, device=dev)
    K = plan.warmup
    print("pool plan: " + ", ".join(f"B={b.block} H={b.hop} P={b.passes} K={b.kept}" for b in plan.buckets)
          + f"; warmup {K} blocks, window {plan.window}", flush=True)
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
        zeros_agree = bool(torch.equal(got == 0, ref == 0))
        err = float((got.double() - ref).abs().max())
        max_abs_err = max(max_abs_err, err)
        worst = min(worst, *snrs)
        print(f"pool parity hops={hops} all buckets: "
              + ", ".join(f"{n} {v:.1f} dB" for n, v in zip(OUTPUTS, snrs[:3]))
              + ", carries " + ", ".join(f"{v:.1f}" for v in snrs[3:])
              + f" dB, max abs err {err:.3e}, not-ready zeros agree {zeros_agree} (bar >= {KERNEL_BAR_DB} dB)",
              flush=True)
        if not zeros_agree:
            fail("pool kernel's exact zeros differ from its plain version's")
    if not (worst >= KERNEL_BAR_DB):
        fail(f"pool kernel parity {worst:.1f} dB < {KERNEL_BAR_DB} dB")
    del hist, t, carries, got, got_c, ref, ref_c
    window = torch.randn((S, 2, plan.window), device=dev, generator=torch.Generator(dev).manual_seed(2))
    for mode in ("copy", "frame"):
        same = torch.equal(pool_floor.pool_floor(window, hw, mode, plan),
                           pool_floor_plain(window, hw, mode, plan))
        print(f"floor parity {mode}: bit-exact {same}", flush=True)
        if not same:
            fail(f"floor kernel ({mode}) differs from its plain version")

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
          f"{k3_launches}, omnibus launches {omnibus.LAUNCHES}", flush=True)
    if k3_launches == 0:
        fail("the serving pool launched no pool kernel")
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
    # The floor probe's own run: the probe scan of bench_pool_floor.py,
    # history shift then K6, over the same blocks.
    pool_floor.LAUNCHES = 0
    h = torch.zeros((S, 2, (K - 1) * hw), device=dev)
    for blk in blocks:
        full = torch.cat([h, blk.transpose(0, 1)], dim=-1)
        pool_floor.pool_floor(full, hw, "copy")
        h = full[..., hw:]
    torch.cuda.synchronize()
    k6_launches = pool_floor.LAUNCHES
    print(f"floor probe run: {POOL_BLOCKS} blocks, floor kernel launches {k6_launches}", flush=True)
    if k6_launches == 0:
        fail("the floor probe launched no floor kernel")
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
    for n_streams, hops in ((16, 1), (S, 1), (S, 4), *((n, 1) for n in POOL_CAPACITY_STREAMS)):
        tp = CudaStreamPool(cfg, hw, n_streams, device=dev)
        run, fresh = tp.make_sustained_runner(POOL_BLOCKS, hops=hops)
        rows = torch.arange(n_streams, device=dev) % S  # streams beyond S repeat the seeded noise
        slabs = (blocks[:, :, rows].reshape(POOL_BLOCKS // hops, hops, 2, n_streams, hw)
                 .permute(0, 2, 3, 1, 4).reshape(POOL_BLOCKS // hops, 2, n_streams, hops * hw).contiguous())
        state = fresh()
        per_block = time_ms(lambda: run(state, slabs), loops=5, iters=1) / POOL_BLOCKS
        print(f"pool timing [{smi}]: S={n_streams} hops={hops}: {per_block:.3f} ms per block, "
              f"meets the {deadline_ms:.2f} ms deadline {per_block <= deadline_ms}; throughput "
              f"S x deadline / (ms per block) = {n_streams * deadline_ms / per_block:.0f} streams, "
              f"extrapolated from S={n_streams}", flush=True)
        del tp, run, state, slabs
    hist, t, carries = inputs(1, ready_only=True)
    k3_ms = time_ms(lambda: pool_step_lcr(hist, t, carries, plan))
    k3_plain_ms = time_ms(lambda: pool_step_lcr_plain(hist, t, carries, plan))
    # K3's bound per block, from the least work of the function: the FFTs of
    # every frame; the history read, the carries read and written, the
    # outputs written and t, gains and windows read once.
    k3_flop = sum(fft_flop(S * b.passes, b.block) for b in plan.buckets)
    k3_bytes = 4 * (S * 2 * K * hw + 2 * S * 3 * sum(b.block for b in plan.buckets) + S * 3 * hw + S
                    + sum(2 * b.block + b.gains.numel() for b in plan.buckets))
    k3_bound, k3_by = bound(k3_flop, k3_bytes)
    d_flop = sum(20.0 * S * b.passes * b.block * b.kept for b in plan.buckets)
    d_bound, _ = bound(d_flop, k3_bytes + 4 * sum(4 * b.block * b.kept for b in plan.buckets))
    print(f"timing [{smi}]: pool kernel (S={S}, hops=1, all ready) {k3_ms:.3f} ms, plain version "
          f"{k3_plain_ms:.3f} ms; bound {k3_bound:.3f} ms ({k3_by}: {k3_flop:.3e} FLOP by FFT, "
          f"{k3_bytes / 1e9:.3f} GB), kernel at {k3_bound / k3_ms:.1%} of it", flush=True)
    print(f"design [{smi}]: pool direct DFT {d_flop:.3e} FLOP -> {d_bound:.3f} ms at FP32 peak; "
          f"kernel at {d_bound / k3_ms:.1%} of it ({d_flop / k3_ms / 1e9:.1f} TFLOP/s)", flush=True)
    parts = []
    for b, c in zip(plan.buckets, carries):
        sub = dataclasses.replace(plan, buckets=(b,))
        b_ms = time_ms(lambda: pool_step_lcr(hist, t, [c], sub))
        b_plain = time_ms(lambda: pool_step_lcr_plain(hist, t, [c], sub))
        gflop = 20.0 * S * b.passes * b.block * b.kept / 1e9
        parts.append(f"B={b.block} {b_ms:.3f} ms ({gflop / b_ms:.1f} TFLOP/s) vs plain {b_plain:.3f} ms")
    print(f"timing [{smi}]: pool kernel per bucket: " + "; ".join(parts), flush=True)
    x = blocks[0].transpose(0, 1).contiguous()
    h = hist[..., hw:].contiguous()
    shift_ms = time_ms(lambda: torch.cat([h, x], dim=-1))
    print(f"timing [{smi}]: history shift (cat of [{S}, 2, {(K - 1) * hw}] and the block) "
          f"{shift_ms:.3f} ms", flush=True)
    floor = {}
    for mode in ("copy", "frame"):
        f_ms = time_ms(lambda: pool_floor.pool_floor(window, hw, mode, plan))
        f_plain = time_ms(lambda: pool_floor_plain(window, hw, mode, plan))
        nbytes = floor_bytes(S, plan.window, hw)
        f_bound, f_by = bound(S * hw * 3.0, nbytes)
        floor[mode] = (f_ms, f_plain, f_bound, f_by)
        print(f"timing [{smi}]: floor {mode} (S={S}) {f_ms * 1e3:.1f} us, plain version "
              f"{f_plain * 1e3:.1f} us; bound {f_bound * 1e3:.1f} us ({f_by}: {nbytes / 1e6:.1f} MB), "
              f"kernel at {f_bound / f_ms:.1%} of it", flush=True)
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
            "library_ms": None,
        },
        {
            "name": "pool_floor",
            "route": "cuda",
            "source": "upmix_tpu_torch/csrc/pool.cu",
            "replaces": "scripts/bench_pool_floor.py:53",
            "launches": k6_launches,
            "max_abs_err": 0.0,
            "ms": floor["copy"][0],
            "plain_ms": floor["copy"][1],
            "bound_ms": floor["copy"][2],
            "bound_by": floor["copy"][3],
            "library_ms": None,
        },
    ]


if __name__ == "__main__":
    main()
