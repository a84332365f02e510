"""Bring-up check of processes that share one global mesh (port of
`upmix_tpu/parallel/pod_check.py`).

``parallel/distributed.py`` wraps `torch.distributed`; this module is the
proof that the wrapper and the two multi-process conventions work on a
live group.  Run ONE copy per process:

    python -m upmix_tpu_torch.parallel.pod_check \\
        --coordinator HOST:PORT --num-processes N --process-id I \\
        [--device cuda] [--local-devices K] [--backend nccl|gloo] \\
        [--files a.wav b.wav ...] [--report out.json]

or under torchrun without --coordinator (its environment names the
group).  Each process holds K mesh entries of `--device`: with a bare
`cuda`, K distinct cards (`local_entries`); a named device is repeated,
and its entries run as rows of one launch.  Each process performs, in
order:

1. ``init_distributed()``: brings up the group; after it, `make_mesh()`
   builds over every process's entries.
2. A cross-process COLLECTIVE check: each entry of a global 1-D mesh
   sums its row of a shared array, and an ``all_reduce`` of the
   processes' sums must give the global sum.
3. The GLOBAL-MESH sharded offline pipeline (`build_sharded_offline_fn`
   over every entry on the ``seq`` axis): the halos cross the process
   boundary by send and receive, and every process gates ITS OWN output
   shards against the float64 whole-file torch.fft path (>60 dB); no
   process assembles the global output.
4. The MULTI-PROCESS OFFLINE convention: ``local_file_shard`` splits a
   shared file list; this process runs `upmix_offline` over its share and
   gates each result against the float64 path (>60 dB).

The JAX package gates against its NumPy oracle; the port imports nothing
of the JAX package, and its float64 path is the reference its own card
checks use (`models/offline.py::build_offline_fn` with chunk=0).

Exits 0 and prints ``POD_CHECK_OK`` only if every step passes; the
optional ``--report`` JSON carries the measured numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def _test_stereo(n: int, sr: float, seed: int = 0):
    """Deterministic band-rich stereo pair, identical on every process
    (a shared center component plus decorrelated sides)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    center = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n)
    L = center + 0.3 * np.sin(2 * np.pi * 555.0 * t + 0.3) + 0.1 * rng.standard_normal(n)
    R = center + 0.3 * np.sin(2 * np.pi * 812.0 * t + 1.1) + 0.1 * rng.standard_normal(n)
    return L.astype(np.float32), R.astype(np.float32)


def _snr_db(ref, test) -> float:
    import numpy as np

    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(test, np.float64)) ** 2)
    sig = np.sum(ref**2)
    if err == 0.0:
        return math.inf
    return 10.0 * math.log10(sig / max(err, 1e-300))


def _float64_lcr(L, R, cfg, device):
    """[3, n] float64 numpy: the whole-file torch.fft path in float64."""
    import numpy as np
    import torch

    from upmix_tpu_torch.models.offline import build_offline_fn

    Ld = torch.as_tensor(np.asarray(L), dtype=torch.float64, device=device)
    Rd = torch.as_tensor(np.asarray(R), dtype=torch.float64, device=device)
    return torch.stack(build_offline_fn(cfg, len(L), chunk=0, device=device)(Ld, Rd)).cpu().numpy()


def local_entries(device: str, count: int) -> list:
    """This process's `count` mesh entries of `device`.  A bare "cuda"
    spans `count` distinct cards, the block of LOCAL_RANK (cuda:LOCAL_RANK
    * count onwards), as a JAX process holds its local chips: one process
    over four cards is `--local-devices 4`, and under torchrun each rank
    takes its own card.  A named device (cuda:k, cpu) is repeated; its
    entries run as rows of one launch."""
    import os

    import torch

    if device != "cuda":
        return [device] * count
    first = int(os.environ.get("LOCAL_RANK", 0)) * count
    if first + count > torch.cuda.device_count():
        raise ValueError(f"--local-devices {count} of bare cuda needs cards {first} .. {first + count - 1}, "
                         f"{torch.cuda.device_count()} visible; name a device (cuda:0) to repeat one card")
    return [f"cuda:{first + i}" for i in range(count)]


def run_pod_check(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    files: list[str] | None = None,
    edges: tuple[float, ...] = (0.0, 400.0, 1600.0),
    sr: float = 8000.0,
    max_block_size: int = 512,
    seq_samples: int = 6000,
    snr_floor_db: float = 60.0,
    device: str = "cuda",
    local_devices: int = 1,
    backend: str | None = None,
) -> dict:
    """Run the four-step check (see module docstring).

    `device`, `local_devices` and `backend` go to `init_distributed` (K
    entries of `device`, `local_entries`); once the group is up they
    change nothing.
    Returns the report dict; raises AssertionError on any failed gate so
    launchers see a non-zero exit.
    """
    import numpy as np
    import torch
    import torch.distributed as dist

    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.parallel.distributed import init_distributed, local_file_shard
    from upmix_tpu_torch.parallel.sharded import Shard, build_sharded_offline_fn, make_mesh, sequence_plan

    info = init_distributed(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_entries(device, local_devices),
        backend=backend,
    )
    report: dict = {"topology": info, "backend": dist.get_backend()}
    if num_processes is not None:
        assert info["process_count"] == num_processes, info
    assert info["global_devices"] >= info["local_devices"] >= 1, info

    n_glob = info["global_devices"]
    mesh = make_mesh({"seq": n_glob})
    me = info["process_index"]
    mine = [k for k in range(n_glob) if mesh.processes.flat[k] == me]
    first = mesh.devices.flat[mine[0]]

    # -- 2. cross-process collective -------------------------------------
    base = np.arange(n_glob * 8, dtype=np.float32).reshape(n_glob, 8)
    on = first if report["backend"] == "nccl" else torch.device("cpu")
    part = torch.stack([torch.as_tensor(base[k], device=mesh.devices.flat[k]).sum().to(on) for k in mine]).sum()
    dist.all_reduce(part)
    want_sum = float(base.sum())
    report["collective"] = {"got": float(part), "want": want_sum}
    assert abs(float(part) - want_sum) <= 1e-3 * abs(want_sum), report["collective"]

    # -- 3. global-mesh sequence-sharded pipeline --------------------------
    cfg = UpmixConfig.make(list(edges), sr=sr, max_block_size=max_block_size)
    plan = sequence_plan(cfg, seq_samples, n_glob)
    n = plan.n_padded  # full-length signal: every shard carries signal
    L, R = _test_stereo(n, sr, seed=11)
    ref = _float64_lcr(L, R, cfg, first)
    fn, _ = build_sharded_offline_fn(cfg, n, mesh, data_axis=None)
    shards = fn(torch.as_tensor(np.stack([L, R])[None]))
    if isinstance(shards, torch.Tensor):  # this process holds every entry
        cut = [slice(k * plan.chunk, (k + 1) * plan.chunk) for k in range(n_glob)]
        shards = [Shard((slice(0, 1), slice(None), sl), shards[..., sl]) for sl in cut]
    shard_snrs = []
    for s in shards:
        sl = s.index[-1]
        shard_snrs.append({"start": sl.start, "stop": sl.stop, "snr_db": _snr_db(ref[:, sl], s.data[0].cpu())})
    report["seq_sharded"] = {
        "chunk": plan.chunk,
        "halo": plan.halo,
        "n_padded": plan.n_padded,
        "shards": shard_snrs,
    }
    assert shard_snrs, "no output shards on this process"
    for s in shard_snrs:
        assert s["snr_db"] > snr_floor_db, report["seq_sharded"]

    # -- 4. multi-process offline convention: per-process file shards ------
    jobs = []
    if files:
        from upmix_tpu_torch.io.wav import read_wav
        from upmix_tpu_torch.models.offline import upmix_offline

        for path in local_file_shard(files):
            data, fsr = read_wav(path, always_2d=True)
            Lf = np.asarray(data[:, 0], np.float32)
            Rf = np.asarray(data[:, min(1, data.shape[1] - 1)], np.float32)
            fcfg = UpmixConfig.make(list(edges), sr=float(fsr), max_block_size=max_block_size)
            fref = _float64_lcr(Lf, Rf, fcfg, first)
            got3 = upmix_offline(Lf, Rf, fcfg, device=first)
            snrs = [_snr_db(r, g) for r, g in zip(fref, got3)]
            jobs.append({"path": path, "snr_db": snrs})
            for s in snrs:
                assert s > snr_floor_db, jobs[-1]
    report["file_jobs"] = jobs
    report["ok"] = True
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m upmix_tpu_torch.parallel.pod_check",
        description="Verify processes on one global mesh: distributed init, cross-process collectives, the "
        "global-mesh sharded pipeline, and per-process file sharding, all gated against the float64 path.",
    )
    ap.add_argument("--coordinator", default=None, help="HOST:PORT of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--files", nargs="*", default=None,
                    help="shared WAV list; THIS process takes paths[i::n]")
    ap.add_argument("--report", default=None, help="write the JSON report here")
    ap.add_argument("--sr", type=float, default=8000.0)
    ap.add_argument("--edges", type=float, nargs="+", default=[0.0, 400.0, 1600.0])
    ap.add_argument("--max-block", type=int, default=512)
    ap.add_argument("--seq-samples", type=int, default=6000)
    ap.add_argument("--device", default="cuda",
                    help="this process's device (cpu for the plain versions; bare cuda is cuda:LOCAL_RANK)")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="mesh entries of --device this process holds (bare cuda: that many distinct cards)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl for CUDA devices, gloo for the CPU")
    args = ap.parse_args(argv)

    try:
        report = run_pod_check(
            coordinator=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            files=args.files,
            edges=tuple(args.edges),
            sr=args.sr,
            max_block_size=args.max_block,
            seq_samples=args.seq_samples,
            device=args.device,
            local_devices=args.local_devices,
            backend=args.backend,
        )
    except Exception as e:  # report the failure, exit non-zero
        report = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=2)
        print(f"POD_CHECK_FAIL {report['error']}", file=sys.stderr)
        return 1

    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    t = report["topology"]
    print(
        f"POD_CHECK_OK process {t['process_index']}/{t['process_count']} "
        f"devices local={t['local_devices']} global={t['global_devices']} "
        f"shards={len(report['seq_sharded']['shards'])} "
        f"files={len(report['file_jobs'])}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
