"""The torch port must run where jax is not installed: importing every
module of upmix_tpu_torch and running an Upmixer, a BatchUpmixer, a
ShardedUpmixer on a CPU mesh, the stream pools (a spectral one and one
on a mesh of two CPU devices among them), the tuner's two sweeps, a
stream-server session,
both probes' plain versions and the CLI on a WAV file, the custom-window
registry, the routes of geometries no kernel takes (overlap 0.65
offline, batched and sharded, `--window-file` and `--overlap` in the
CLI), AOT artifacts of all three kinds saved and loaded (and the CLI's
--save-aot), the native engine (where `make -C native` builds it), the
utils, the FIR design, the plots, the demo, and a world-size-1 gloo
`init_distributed` with a one-process pod check leaves jax, and every
module of the JAX package, unimported.

Runs in a fresh interpreter, since this test process has jax loaded.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from helpers import cpu_child_env
from torch_helpers import native_engine

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
import numpy as np
import torch
import upmix_tpu_torch
from upmix_tpu_torch import BatchUpmixer, ShardedUpmixer, UpmixConfig, Upmixer, make_mesh, make_stream_pool

names = [m.name for m in pkgutil.walk_packages(upmix_tpu_torch.__path__, "upmix_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for mod in ("ops.omnibus", "ops._build", "ops.pool", "ops.pool_floor", "models.streaming",
            "ops.fused", "parallel.sharded", "models.batch", "ops.int8_dot", "ops.overhead_probe", "app",
            "cli", "io.wav", "metrics", "serve_stream", "tune", "aot", "native", "native.host", "utils.profiling",
            "utils.cache", "filter_design", "visualize", "demo", "parallel.distributed", "parallel.pod_check"):
    assert "upmix_tpu_torch." + mod in names, names

cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
L = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
c, ls, rs = Upmixer(cfg, device="cpu").process_np(L, 0.5 * L)
assert c.shape == (3000,) and np.isfinite(c).all()
y = ShardedUpmixer(cfg, make_mesh({"data": 2, "seq": 4}, devices=["cpu"] * 8)).process_batch(
    np.stack([np.stack([L, 0.5 * L])] * 2))
assert y.shape == (2, 3, 3000) and float((y[0, 0] - c).abs().max()) < 1e-3
b, = BatchUpmixer(cfg, 3000, 1, device="cpu").process_files([np.stack([L, 0.5 * L])])
assert b.shape == (3, 3000) and float(np.abs(b[0] - c).max()) < 1e-3
scfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=256)
for engine in ("cuda", "torch"):
    pool = make_stream_pool(scfg, 256, 3, engine=engine, device="cpu")
    for _ in range(5):
        out = pool.push_blocks(np.random.default_rng(1).standard_normal((3, 256)), np.ones((3, 256)))
    assert np.isfinite(out[0].numpy()).all() and out[0].abs().max() > 0
from upmix_tpu_torch.models.streaming import CudaStreamPool
spectral = CudaStreamPool(scfg, 256, 2, device="cpu", ola="spectral")
on_mesh = CudaStreamPool(scfg, 256, 4, device="cpu", mesh=make_mesh({"data": 2}, devices=["cpu", "cpu:0"]))
for i in range(5):
    x = np.random.default_rng(i).standard_normal((2, 4, 256))
    a = spectral.push_blocks(x[0, :2], x[1, :2])
    m = on_mesh.push_blocks(x[0], x[1])
assert a[0].abs().max() > 0 and float((m[0][:2] - a[0]).abs().max()) < 1e-5
assert spectral.snapshot()["ola"]["1024"].shape == (2, 3 * 3 * 640)
from upmix_tpu_torch.tune import tune_offline, tune_pool
assert tune_pool(scfg, 256, batch_sizes=(2,), ola=("time", "spectral"), blocks=1, visits=1, device="cpu",
                 verbose=False)["best"] is not None
assert tune_offline(cfg, n_samples=3000, chunks=(0, 4096), inner=1, visits=1, device="cpu",
                    verbose=False)["best"] is not None
from upmix_tpu_torch.serve_stream import StreamServer, fetch_metrics, stream_client
with StreamServer(make_stream_pool(scfg, 256, 2, engine="cuda", device="cpu"), lockstep=True) as srv:
    got = stream_client(*srv.address, L[:1000], 0.5 * L[:1000], mix="lcr")
    assert len(got) == 3 and got[0].shape == (1000,) and np.isfinite(got[0]).all()  # 4 blocks served
    assert "upmix_frames_total 1024.0" in fetch_metrics(*srv.address, fmt="prometheus")
from upmix_tpu_torch import cli
from upmix_tpu_torch.io import read_wav, write_wav
from upmix_tpu_torch.ops import int8_dot, overhead_probe
y = int8_dot.int8_dot_chain(torch.ones((32, 64)), "int8x3", 2, int8_dot.make_consts("int8x3", "cpu", 64))
assert torch.isfinite(y).all()
x, rng = overhead_probe.make_inputs(4 * 256, 256, "cpu")
out, spill = overhead_probe.overhead_probe(x, torch.zeros(()), overhead_probe.make_weights(2, rng, "cpu"), 4, 8, 256)
assert out.shape == (1, 3, 1024) and not spill.any()
with tempfile.TemporaryDirectory() as tmp:
    wav = os.path.join(tmp, "in.wav")
    write_wav(wav, np.stack([L, 0.5 * L], 1), 8000)
    assert cli.main([wav, "--out-dir", tmp, "--band-edges", "0,400,1600", "--max-block-size", "512",
                     "--device", "cpu"]) == 0
    outs = [f for f in os.listdir(tmp) if f.startswith("in_Sum_")]
    assert len(outs) == 1 and read_wav(os.path.join(tmp, outs[0]))[0].shape == (3000, 2)
from upmix_tpu_torch.ops.windows import register_window_vector, window_names
name = register_window_vector("nojax_window", np.kaiser(300, 6.0))
assert name in window_names()
odd = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=512, overlap=0.65, window=name)
c, _, _ = Upmixer(odd, device="cpu").process_np(L, 0.5 * L)
b, = BatchUpmixer(odd, 3000, 1, device="cpu").process_files([np.stack([L, 0.5 * L])])
assert np.isfinite(c).all() and float(np.abs(b[0] - c).max()) < 1e-5
y = ShardedUpmixer(odd, make_mesh({"seq": 2}, devices=["cpu"] * 2)).process_batch(np.stack([L, 0.5 * L])[None])
assert float((y[0, 0] - torch.as_tensor(c)).abs().max()) < 1e-3
with tempfile.TemporaryDirectory() as tmp:
    wav, win = os.path.join(tmp, "in.wav"), os.path.join(tmp, "w.txt")
    write_wav(wav, np.stack([L, 0.5 * L], 1), 8000)
    np.savetxt(win, np.hanning(64))
    assert cli.main([wav, "--out-dir", tmp, "--band-edges", "0,400,1600", "--max-block-size", "512",
                     "--overlap", "0.65", "--window-file", win, "--device", "cpu"]) == 0
from upmix_tpu_torch import aot, filter_design, native, utils, visualize
from upmix_tpu_torch.demo import run_demo
with tempfile.TemporaryDirectory() as tmp:
    p = os.path.join(tmp, "a.upmixaot")
    aot.save_offline(p, cfg, 3000, device="cpu")
    c2, _, _ = aot.load(p, device="cpu").process_np(L, 0.5 * L)
    np.testing.assert_array_equal(c2, Upmixer(cfg, device="cpu").process_np(L, 0.5 * L)[0])
    aot.save_stream_step(p, scfg, 256, device="cpu")
    assert aot.load(p, device="cpu").push_block(L[:256], L[:256])[0].shape == (256,)
    assert cli.main(["-", "--save-aot", p, "--sr", "8000", "--band-edges", "0,400,1600", "--hw-block", "256",
                     "--aot-pool", "2", "--aot-hops", "2", "--pool-ola", "spectral", "--device", "cpu"]) == 0
    assert aot.load(p, device="cpu").push_blocks_multi(np.ones((2, 512)), np.ones((2, 512)))[0].shape == (2, 512)
    wav = os.path.join(tmp, "in.wav")
    write_wav(wav, np.stack([L, 0.5 * L], 1), 8000)
    run_demo(wav, out_dir=tmp, band_edges=[0.0, 400.0, 1600.0], device="cpu")
    assert cli.main([wav, "--out-dir", tmp, "--band-edges", "0,400,1600", "--max-block-size", "512", "--device",
                     "cpu", "--no-compile-cache"]) == 0
if native.is_available():
    eng = native.NativeStreamingUpmixer([0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=256)
    assert eng.process_signal(L, L)[0].shape == (2816,)
assert len(filter_design.apply_fir_filter(L, filter_design.design_lr4_lp_fir(8000.0))) == len(L)
assert visualize.overlapped_window_sums(np.hanning(64), np.hanning(64), 0.75)[0].shape == (112,)
assert utils.time_fn(lambda: torch.ones(4) * 2, iters=2) > 0 and utils.RealtimeMeter(8000.0).audio_s == 0.0
import socket
from upmix_tpu_torch.parallel import init_distributed, local_file_shard, run_pod_check
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
rep = run_pod_check(f"127.0.0.1:{port}", 1, 0, seq_samples=2000, device="cpu", local_devices=2, backend="gloo")
assert rep["ok"] and rep["topology"]["global_devices"] == 2 and len(rep["seq_sharded"]["shards"]) == 2
assert init_distributed() == rep["topology"] and local_file_shard(["a", "b"]) == ["a", "b"]
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not loaded, loaded
jax_package = sorted(m for m in sys.modules if m == "upmix_tpu" or m.startswith("upmix_tpu."))
assert not jax_package, jax_package
print("NOJAX_OK", len(names))
"""


def test_port_never_imports_jax():
    try:  # the native engine runs in the script where it can be built
        native_engine()
    except pytest.skip.Exception:
        pass
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        cwd=ROOT, env=cpu_child_env(), capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NOJAX_OK" in res.stdout
