"""The torch port must run where jax is not installed: importing every
module of upmix_tpu_torch and running an Upmixer leaves jax unimported.

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
from upmix_tpu_torch import UpmixConfig, Upmixer

names = [m.name for m in pkgutil.walk_packages(upmix_tpu_torch.__path__, "upmix_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "upmix_tpu_torch.ops.omnibus" in names and "upmix_tpu_torch.ops._build" in names, names

cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
L = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
c, ls, rs = Upmixer(cfg, device="cpu").process_np(L, 0.5 * L)
assert c.shape == (3000,) and np.isfinite(c).all()
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not loaded, loaded
print("NOJAX_OK", len(names))
"""


def test_port_never_imports_jax():
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        cwd=ROOT, env=cpu_child_env(), capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NOJAX_OK" in res.stdout
