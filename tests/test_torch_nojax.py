"""The torch port must run where jax is not installed: importing every
module of upmix_tpu_torch and running an Upmixer, a BatchUpmixer, a
ShardedUpmixer on a CPU mesh and a stream pool leaves jax, and every
module of the JAX package, unimported.

Runs in a fresh interpreter, since this test process has jax loaded.
"""

import subprocess
import sys
from pathlib import Path

from helpers import cpu_child_env

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np
import upmix_tpu_torch
from upmix_tpu_torch import BatchUpmixer, ShardedUpmixer, UpmixConfig, Upmixer, make_mesh, make_stream_pool

names = [m.name for m in pkgutil.walk_packages(upmix_tpu_torch.__path__, "upmix_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for mod in ("ops.omnibus", "ops._build", "ops.pool", "ops.pool_floor", "models.streaming",
            "ops.fused", "parallel.sharded", "models.batch"):
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
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not loaded, loaded
jax_package = sorted(m for m in sys.modules if m == "upmix_tpu" or m.startswith("upmix_tpu."))
assert not jax_package, jax_package
print("NOJAX_OK", len(names))
"""


def test_port_never_imports_jax():
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        cwd=ROOT, env=cpu_child_env(), capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NOJAX_OK" in res.stdout
