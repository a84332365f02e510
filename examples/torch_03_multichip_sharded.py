"""Scale-out on the PyTorch/CUDA port: data-parallel batches and
sequence-parallel long inputs over a mesh.

The port's counterpart of 03_multichip_sharded.py: `ShardedUpmixer` on a
data 2 x seq 4 mesh.  The mesh here repeats one device eight times (the
card, or with --cpu the CPU): shards on one device run as rows of one
launch, so the example runs on a single card; on a host with eight cards
build the mesh with `make_mesh({"data": 2, "seq": 4})` instead.  The
sharded output is held against the single-device offline path.

The same path is one flag at the CLI: `python -m upmix_tpu_torch.cli
in.wav --mesh data=2,seq=4` (and `--pool-mesh data=D` for the stream
server).

    python examples/torch_03_multichip_sharded.py [workdir] [--cpu]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models import upmix_offline
from upmix_tpu_torch.parallel import ShardedUpmixer, make_mesh

DEVICE = "cpu" if "--cpu" in sys.argv[1:] else "cuda"

cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)

# 2 x 4 mesh: files across 'data', each file's sample axis across 'seq'
# (halo exchange keeps the overlapped frames exact).
mesh = make_mesh({"data": 2, "seq": 4}, devices=[DEVICE] * 8)
up = ShardedUpmixer(cfg, mesh=mesh)

rng = np.random.default_rng(0)
x = rng.standard_normal((2, 2, 40960)).astype(np.float32) * 0.3
y = up.process_batch(x).cpu().numpy()  # [batch, 3, n]
print(f"[{DEVICE}] sharded output: {y.shape}")

# Parity vs the single-device offline path.
ref = np.stack(upmix_offline(x[0, 0], x[0, 1], cfg, device=DEVICE))
err = np.abs(y[0] - ref).max()
snr = 10 * np.log10((ref**2).sum() / max(((y[0] - ref) ** 2).sum(), 1e-30))
print(f"vs single-device offline: max|diff|={err:.2e}, SNR={snr:.1f} dB")
assert snr > 60.0
