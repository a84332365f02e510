"""Which card runs the kernels of the one-process multi-card paths.

    python -m upmix_tpu_torch.parallel.cards [offline] [sharded] [pool] [dispatch]

Needs two or more CUDA devices.  Each path runs in a child process of
its own (a kernel fault on a card poisons the CUDA context of the process
that launched it), on bench.py's config or the serving config:

  offline: `Upmixer(cfg, device="cuda:1").process` on 2^21 samples of
           seeded noise from host memory, against `Upmixer` on cuda:0;
  sharded: `ShardedUpmixer(cfg, make_mesh(axes))` on two files of 2^21
           samples, axes {"data": 2, "seq": 2} over four cards (or
           {"seq": 2} over two), against the same mesh on cuda:0 repeated;
  pool:    `CudaStreamPool` of the serving config at 2048 streams a card
           on make_mesh({"data": N}) over the cards, 12 blocks at hop 1,
           against the unsharded pool on cuda:0.

  dispatch: where the host's time goes in the sharded call (`_dispatch`).

Each prints one JSON line: whether the call ran, the torch.profiler
kernel rows of one call by device index, the port's kernels and all
kernels (`utils/profiling.py::kernel_rows_by_device`), the max abs
difference from the reference, and
ms a call (host clock around calls that end by synchronising every card,
min of 5).  A run on the wrong card shows as rows on device 0 only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BENCH_EDGES = [0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0]
POOL_EDGES = [0.0, 500.0, 2000.0, 8000.0]
N_SAMPLES = 2**21
POOL_STREAMS = 2048  # a card
POOL_BLOCKS = 12
PATHS = ("offline", "sharded", "pool")
CHILD_TIMEOUT = 300
# Names of the port's kernels as the profiler lists them: K1 and K2
# (frames and split kernels on OmniSink), K3 (on PoolSink), K3s.
PORT_KERNELS = ("OmniSink", "PoolSink", "SpectralSink", "spectral_")


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def best_ms(fn, loops: int = 5) -> float:
    fn()
    sync_all()
    best = float("inf")
    for _ in range(loops):
        t0 = time.perf_counter()
        fn()
        sync_all()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _offline() -> dict:
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.offline import Upmixer

    cfg = UpmixConfig.make(BENCH_EDGES, sr=44100, max_block_size=65536)
    rng = np.random.default_rng(0)
    L = rng.standard_normal(N_SAMPLES).astype(np.float32)
    R = rng.standard_normal(N_SAMPLES).astype(np.float32)
    want = np.stack(Upmixer(cfg, device="cuda:0").process_np(L, R))
    up = Upmixer(cfg, device="cuda:1")
    return {"call": lambda: up.process(L, R), "check": lambda: np.stack(up.process_np(L, R)), "want": want}


def _sharded() -> dict:
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.parallel.sharded import ShardedUpmixer, make_mesh

    cfg = UpmixConfig.make(BENCH_EDGES, sr=44100, max_block_size=65536)
    axes = {"data": 2, "seq": 2} if torch.cuda.device_count() >= 4 else {"seq": 2}
    n = int(np.prod(list(axes.values())))
    audio = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 2, N_SAMPLES)), dtype=torch.float32,
                            device="cuda:0")
    want = ShardedUpmixer(cfg, make_mesh(axes, devices=[torch.device("cuda", 0)] * n)).process_batch(audio)
    su = ShardedUpmixer(cfg, make_mesh(axes))
    return {"call": lambda: su.process_batch(audio), "check": lambda: su.process_batch(audio).cpu().numpy(),
            "want": want.cpu().numpy(), "axes": axes}


def _pool() -> dict:
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.streaming import CudaStreamPool
    from upmix_tpu_torch.parallel.sharded import make_mesh

    cfg = UpmixConfig.streaming(POOL_EDGES, sr=48000, hw_block_size=2048)
    n = torch.cuda.device_count()
    S = POOL_STREAMS * n
    blocks = np.random.default_rng(7).standard_normal((POOL_BLOCKS, 2, S, 2048)).astype(np.float32)

    def run(pool):
        outs = [torch.stack(pool.push_blocks(b[0], b[1])) for b in blocks]
        return torch.stack(outs)

    want = run(CudaStreamPool(cfg, 2048, S, device="cuda:0")).cpu().numpy()
    pool = CudaStreamPool(cfg, 2048, S, mesh=make_mesh({"data": n}))

    def check():
        pool.reset()
        return run(pool).cpu().numpy()

    return {"call": lambda: pool.push_blocks(blocks[0, 0], blocks[0, 1]), "check": check, "want": want}


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _dispatch() -> dict:
    """Where the host's time goes in the sharded call over the cards.
    First whether a launch or a copy makes the host wait for a busy card:
    the host's ms for a K1 call and for a copy onto a card that has 50 ms
    of `torch.cuda._sleep` queued, beside the same on an idle card.  Then
    the sharded call's dispatch: host ms in total and inside the kernel
    wrappers, and the caching allocator's device allocations, frees and
    retries over 5 calls (any of them can wait for a card)."""
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.offline import _plan_buckets, plans_from_numpy
    from upmix_tpu_torch.ops.omnibus import make_omnibus_plan, omnibus_lcr_batch
    from upmix_tpu_torch.parallel import sharded
    from upmix_tpu_torch.parallel.sharded import ShardedUpmixer, make_mesh

    cfg = UpmixConfig.make(BENCH_EDGES, sr=44100, max_block_size=65536)
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    chunk = 2**19
    plan = make_omnibus_plan(plans_from_numpy(_plan_buckets(cfg, chunk), last), chunk)
    x = torch.randn((1, 2, chunk + plan.halo), device=last)
    y = torch.randn((4, 2, chunk), device="cuda:0")
    cycles = 100_000_000  # about 50 ms at the H100's 1.98 GHz boost clock
    report = {}
    for name, fn in (("k1_call", lambda: omnibus_lcr_batch(x, plan)), ("copy_onto", lambda: y.to(last))):
        fn()
        sync_all()
        report[f"{name}_idle_ms"] = _host_ms(fn)
        sync_all()
        with torch.cuda.device(last):
            torch.cuda._sleep(cycles)
        report[f"{name}_busy_ms"] = _host_ms(fn)
        sync_all()
    axes = {"data": 2, "seq": 2} if torch.cuda.device_count() >= 4 else {"seq": torch.cuda.device_count()}
    audio = torch.randn((2, 2, N_SAMPLES), device="cuda:0")
    su = ShardedUpmixer(cfg, make_mesh(axes))
    inside = []

    def timed(kernel):
        def call(*args):
            t0 = time.perf_counter()
            out = kernel(*args)
            inside.append(time.perf_counter() - t0)
            return out
        return call

    real = sharded.omnibus_lcr_batch, sharded.fused_bucket_lcr_batch
    sharded.omnibus_lcr_batch, sharded.fused_bucket_lcr_batch = map(timed, real)
    try:
        su.process_batch(audio)
        sync_all()
        keys = ("num_device_alloc", "num_device_free", "num_alloc_retries", "num_sync_all_streams")
        stats = lambda: [sum(torch.cuda.memory_stats(i).get(k, 0) for i in range(torch.cuda.device_count()))  # noqa: E731
                         for k in keys]
        before = stats()
        totals = []
        for _ in range(5):
            sync_all()
            inside.clear()
            totals.append((_host_ms(lambda: su.process_batch(audio)), sum(inside) * 1e3))
        sync_all()
        report["allocator_over_5_calls"] = dict(zip(keys, (b - a for a, b in zip(before, stats()))))
    finally:
        sharded.omnibus_lcr_batch, sharded.fused_bucket_lcr_batch = real
    total, wrappers = min(totals)
    report.update({"axes": axes, "sharded_dispatch_ms": total, "in_kernel_wrappers_ms": wrappers})
    return report


def child(path: str) -> dict:
    from upmix_tpu_torch.utils.profiling import kernel_rows_by_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"path": path, "cards": torch.cuda.device_count()}
    if path == "dispatch":
        report.update(_dispatch())
        report["ran"] = True
        return report
    try:
        case = {"offline": _offline, "sharded": _sharded, "pool": _pool}[path]()
        report.update({k: v for k, v in case.items() if k == "axes"})
        got = case["check"]()
        sync_all()
        report["max_abs_diff"] = float(np.abs(got - case["want"]).max())
        report["port_kernels_by_device"] = kernel_rows_by_device(case["call"], match=PORT_KERNELS)[0]
        report["all_kernels_by_device"] = kernel_rows_by_device(case["call"])[0]
        report["ms"] = best_ms(case["call"])
        report["ran"] = True
    except Exception as e:  # the finding is the error itself
        report["ran"] = False
        report["error"] = f"{type(e).__name__}: {e}"[:400]
    report["current_device"] = torch.cuda.current_device()
    return report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    if torch.cuda.device_count() < 2:
        print("cards: needs two or more CUDA devices", file=sys.stderr)
        return 2
    from upmix_tpu_torch.ops import _build

    _build.load()  # the children find the library built
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(f"cards: {torch.cuda.device_count()} x {smi[0] if smi else 'unknown'}", flush=True)
    ok = True
    for path in argv or PATHS:
        res = subprocess.run([sys.executable, "-m", "upmix_tpu_torch.parallel.cards", "--child", path],
                             capture_output=True, text=True, timeout=CHILD_TIMEOUT)
        line = res.stdout.strip().splitlines()[-1:] or [json.dumps({"path": path, "ran": False,
                                                                   "error": res.stderr[-400:]})]
        print(line[0], flush=True)
        ok = ok and res.returncode == 0 and json.loads(line[0]).get("ran", False)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
