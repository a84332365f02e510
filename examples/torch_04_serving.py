"""Serving surfaces of the PyTorch/CUDA port: the job server, the
multi-stream pool, the stream server with checkpoint/resume, and a
deployment artifact.

The port's counterpart of 04_serving.py, on the card (the pool kernel
K3) or with --cpu on the plain versions:

1. `run_jobs`: the persistent job server behind `python -m
   upmix_tpu_torch.cli - --serve`, JSON jobs in, JSON results out, plans
   reused across jobs.
2. `make_stream_pool`: many live streams through one step per hardware
   block, with per-slot session churn (`CudaStreamPool` on the card).
3. `StreamServer`: the network front end of that pool (behind
   `--serve-stream PORT`), with its metrics.
4. Live sessions survive a server restart through a checkpoint.
5. `aot`: the serving pool saved to an artifact and loaded as a serving
   host would, equal to the live pool block for block.

    python examples/torch_04_serving.py [workdir] [--cpu]
"""

import io
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from upmix_tpu_torch import aot
from upmix_tpu_torch.app import run_jobs
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.io import write_wav
from upmix_tpu_torch.models import CudaStreamPool, make_stream_pool
from upmix_tpu_torch.models.streaming import BatchStreamingUpmixer
from upmix_tpu_torch.serve_stream import StreamServer, StreamSession, fetch_metrics, stream_client

args = [a for a in sys.argv[1:] if a != "--cpu"]
DEVICE = "cpu" if "--cpu" in sys.argv[1:] else "cuda"
workdir = args[0] if args else "."
os.makedirs(workdir, exist_ok=True)

# --- 1. job server ------------------------------------------------------
sr = 8000
rng = np.random.default_rng(0)
paths = []
for i in range(3):
    x = (rng.standard_normal((sr, 2)) * 0.3).astype(np.float32)
    p = os.path.join(workdir, f"job_{i}.wav")
    write_wav(p, x, sr)
    paths.append(p)

jobs = "\n".join(
    [json.dumps({"cmd": "ping"})] + [json.dumps({"in": p, "out_dir": os.path.join(workdir, "served")}) for p in paths]
)
dst = io.StringIO()
n_ok, n_fail = run_jobs(io.StringIO(jobs), dst, band_edges=[0.0, 400.0, 1600.0], max_block_size=512, device=DEVICE)
assert (n_ok, n_fail) == (3, 0)
for line in dst.getvalue().splitlines():
    r = json.loads(line)
    print("job:", {k: r[k] for k in r if k != "outputs"})
print(f"[{DEVICE}] job server: 3/3 ok (the plan built once, reused by the other jobs)\n")

# --- 2. multi-stream pool ----------------------------------------------
HW, B = 256, 4
cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=float(sr), hw_block_size=HW)
pool = make_stream_pool(cfg, HW, n_streams=B, device=DEVICE)  # engine "auto"
common = rng.standard_normal((8, B, HW)).astype(np.float32) * 0.3
side = rng.standard_normal((8, B, HW)).astype(np.float32) * 0.1
for t in range(8):
    C, Ls, Rs = pool.push_blocks(common[t] + side[t], common[t] - side[t])
    if t == 5:
        pool.reset_streams([2])  # the session on slot 2 ended; the slot re-warms
print(f"pool ({type(pool).__name__}): {B} streams, last block C peak per stream:",
      [round(float(C[b].abs().max()), 4) for b in range(B)])
assert float(C[2].abs().max()) == 0.0  # slot 2 still in warmup
assert float(C[0].abs().max()) > 0.0
print("multi-stream pool: slot churn verified (slot 2 re-warming)\n")

# --- 3. live-stream server ---------------------------------------------
with StreamServer(BatchStreamingUpmixer(cfg, HW, n_streams=B, device=DEVICE), lockstep=True) as srv:
    n = 5 * HW
    L = (rng.standard_normal(n) * 0.3).astype(np.float32)
    R = (rng.standard_normal(n) * 0.3).astype(np.float32)
    out_l, out_r = stream_client(*srv.address, L, R)
    assert len(out_l) == n and np.isfinite(out_l).all()
    print(f"stream server on {srv.address[0]}:{srv.address[1]}: {n} frames round-tripped, "
          f"peak {np.abs(out_l).max():.3f}")
    m = fetch_metrics(*srv.address)
    print(f"metrics: {m['counters']['accepted']} sessions, {m['counters']['blocks']} pool blocks, dispatch p95 "
          f"{m['dispatch_seconds']['p95'] * 1e3:.2f} ms")

# --- 4. session checkpoint/resume across a server restart ----------------
ck = os.path.join(workdir, "sessions.npz")
srv_a = StreamServer(BatchStreamingUpmixer(cfg, HW, n_streams=B, device=DEVICE), lockstep=True).start()
n_blocks = 8
L = (rng.standard_normal(n_blocks * HW) * 0.3).astype(np.float32)
R = (rng.standard_normal(n_blocks * HW) * 0.3).astype(np.float32)
sess = StreamSession(*srv_a.address)
for b in range(4):
    sess.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
part1 = sess.recv_frames(4 * HW - (pool.warmup_blocks - 1) * HW)
srv_a.save_checkpoint(ck)
sess.close()
srv_a.close()  # "crash"

srv_b = StreamServer(BatchStreamingUpmixer(cfg, HW, n_streams=B, device=DEVICE), lockstep=True,
                     checkpoint=ck).start()
try:
    sess2 = StreamSession(*srv_b.address, token=sess.token)  # the same session
    resume_blk = sess2.server_in_frames // HW  # resend from the acknowledged position
    for b in range(resume_blk, n_blocks):
        sess2.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
    sess2.finish()
    part2 = sess2.recv_frames(n_blocks * HW - len(part1))
    full = np.concatenate([part1, part2])
    assert len(full) == n_blocks * HW and np.isfinite(full).all()
    print(f"checkpoint/resume: session resumed at block {resume_blk}, {len(full)} frames total across the restart\n")
finally:
    sess2.close()
    srv_b.close()

# --- 5. deployment artifact ---------------------------------------------
art_path = os.path.join(workdir, "pool.upmixaot")
meta = aot.save_stream_pool(art_path, cfg, HW, B, hops=2, device=DEVICE)
served = aot.load(art_path, device=DEVICE)  # a serving host's load: tables checked, kernels built
live = CudaStreamPool(cfg, HW, B, device=DEVICE)
for t in range(4):
    xl, xr = (rng.standard_normal((B, 2 * HW)).astype(np.float32) * 0.3 for _ in range(2))
    for got, want in zip(served.push_blocks_multi(xl, xr), live.push_blocks_multi(xl, xr)):
        assert torch.equal(got, want)
print(f"artifact: {meta['type']} for {meta['platforms']}, {os.path.getsize(art_path)} bytes, hops {meta['hops']}; "
      "the loaded pool equals the live one bit for bit")
