"""The omnibus CUDA kernel against its plain version, on an NVIDIA GPU.

Marked `gpu`: skipped where no CUDA device is present.  On a GPU machine
(which need not have jax; this file does not import it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Small configs cover the kernel's edges that the bench config does not:
hops below the 64-wide output tile, kept-bin counts that are not
multiples of the tile, depth splits, and several segments per launch.
"""

import numpy as np
import pytest
import torch

from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.offline import Upmixer, _plan_buckets, build_offline_fn, plans_from_numpy
from upmix_tpu_torch.ops import omnibus
from upmix_tpu_torch.ops.omnibus import make_omnibus_plan, omnibus_lcr_batch, omnibus_lcr_batch_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _snr(ref, got):
    ref, got = ref.double().cpu(), got.double().cpu()
    return 10 * np.log10(float((ref**2).sum()) / max(float(((ref - got) ** 2).sum()), 1e-300))


CASES = [
    (([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512)), 2048),
    (([0.0, 2000.0], dict(sr=8000.0, max_block_size=512, overlap=0.5)), 1024),
    (([0, 100, 200, 400, 800, 1200, 1600, 2400, 3200], dict(sr=8000.0, max_block_size=1024)), 2048),
    (([0.0, 400.0], dict(sr=8000.0, max_block_size=4096)), 8192),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain_float64(cuda, case):
    # FP32 products against float64 FFTs: ~120 dB in practice; 90 dB bar.
    (edges, kw), chunk = CASES[case]
    cfg = UpmixConfig.make(edges, **kw)
    plan = make_omnibus_plan(plans_from_numpy(_plan_buckets(cfg, chunk), cuda), chunk)
    rng = np.random.default_rng(case)
    x = torch.as_tensor(
        rng.standard_normal((3, 2, chunk + plan.halo)), dtype=torch.float32, device=cuda
    )
    before = omnibus.LAUNCHES
    got = torch.cat(omnibus_lcr_batch(x, plan), dim=-1)
    torch.cuda.synchronize()
    assert omnibus.LAUNCHES - before == 3 * len(plan.buckets)
    ref = torch.cat(omnibus_lcr_batch_plain(x.double(), plan), dim=-1)
    for o in range(3):
        assert _snr(ref[:, o], got[:, o]) > 90.0


def test_kernel_rejects_float64(cuda):
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    plan = make_omnibus_plan(plans_from_numpy(_plan_buckets(cfg, 512), cuda), 512)
    x = torch.zeros((1, 2, 512 + plan.halo), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        omnibus_lcr_batch(x, plan)


def test_upmixer_matches_whole_file_float64(cuda):
    # Several segments with a ragged tail through the kernel path, against
    # the float64 whole-file torch.fft program on the card.
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    n = 4 * 1024 + 300
    rng = np.random.default_rng(7)
    L = rng.standard_normal(n).astype(np.float32)
    R = rng.standard_normal(n).astype(np.float32)
    got = Upmixer(cfg, device=cuda, chunk=1024).process(L, R)
    ref = build_offline_fn(cfg, n, chunk=0, device=cuda)(
        torch.as_tensor(L, dtype=torch.float64, device=cuda),
        torch.as_tensor(R, dtype=torch.float64, device=cuda),
    )
    for r, g in zip(ref, got):
        assert _snr(r, g) > 90.0
