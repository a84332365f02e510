"""Real-time-style streaming with a mid-stream checkpoint and resume, on
the PyTorch/CUDA port.

The port's counterpart of 02_streaming_checkpoint.py: `StreamingUpmixer`
(the pool kernel K3 on the card, its plain version with --cpu) streams
block by block, snapshots its state halfway (a host copy in the JAX
engine's structure), a second engine restores the snapshot, and the
continuation is bit-identical.

    python examples/torch_02_streaming_checkpoint.py [workdir] [--cpu]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models import StreamingUpmixer

DEVICE = "cpu" if "--cpu" in sys.argv[1:] else "cuda"

# The reference's shipped real-time config: edges 0/500/2000/8000 Hz at
# 48 kHz, 2048-sample hardware blocks (bela/upmix.cpp:525-528).
SR, HW = 48000.0, 2048
cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=SR, hw_block_size=HW)

rng = np.random.default_rng(0)
n_blocks = 12
blocks = rng.standard_normal((n_blocks, 2, HW)).astype(np.float32) * 0.3

eng = StreamingUpmixer(cfg, HW, device=DEVICE)
print(f"[{DEVICE}] bands: {[b.block_size for b in cfg.bands]}, warmup {eng.warmup_blocks} blocks")

outs = []
snap = None
for i, (bl, br) in enumerate(blocks):
    if i == n_blocks // 2:
        snap = eng.snapshot()  # host-side copy, safe to persist
        print(f"checkpointed at block {i}")
    c, ls, rs = eng.push_block(bl, br)
    outs.append(c.cpu().numpy())

# Resume a new engine from the snapshot and replay the second half.
eng2 = StreamingUpmixer(cfg, HW, device=DEVICE)
eng2.restore(snap)
resumed = [eng2.push_block(bl, br)[0].cpu().numpy() for bl, br in blocks[n_blocks // 2 :]]

assert np.abs(np.concatenate(outs)).max() > 0
np.testing.assert_array_equal(np.concatenate(outs[n_blocks // 2 :]), np.concatenate(resumed))
print("resumed continuation is bit-identical to the uninterrupted stream")
