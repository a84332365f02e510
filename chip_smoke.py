"""Smoke run of the PyTorch/CUDA port (upmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the offline upmix of bench.py's config
(6 bands at 0/30/120/480/1920/7680 Hz, 44.1 kHz, blocks up to 65536) on
2^21 samples of seeded noise, through `Upmixer(cfg, device="cuda")`.
Phases, one line each, any failure exits nonzero:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds csrc/omnibus.cu into upmix_tpu_torch/_build/;
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
  6. a JSON line of per-kernel results, then the last line
     {"ok": true, "device": {...}}.

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
    calls of fn, from torch.profiler."""
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
        if e.self_device_time_total > 0
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

    # 6. results
    print(json.dumps({"kernels": [{
        "name": "omnibus_lcr",
        "route": "cuda",
        "source": "upmix_tpu_torch/csrc/omnibus.cu",
        "replaces": "upmix_tpu/ops/pallas_omnibus.py:958",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
