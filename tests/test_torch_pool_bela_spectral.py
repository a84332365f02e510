"""The stream server's Bela configuration on the spectral pool (K3s's
plain path) at a small size on the CPU: 8 streams, 12 blocks from a seed.
It agrees with the benchmark's float64 reference (`benchmark/reference/`,
plain PyTorch that imports nothing of the port) within the benchmark's
limit, with the time pool within float32 rounding, and its plan sends
edge frames to the edge product.  The card's kernels at the benchmark's
size are held by the `pool_8192_spectral` cell."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference.core import Reference
from benchmark.reference.plan import bands
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.streaming import CudaStreamPool

CFG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs" /
                  "stream_48k_4band_bela_spectral.json").read_text())
S, HW, BLOCKS = 8, CFG["hw_block_size"], 12
LIMIT = 1e-4  # the benchmark's limit of every pool cell (PERF.md §2)


def _config():
    return UpmixConfig.streaming(CFG["band_edges"], CFG["sr"], HW)


@pytest.fixture(scope="module")
def runs():
    """The input [2, S, BLOCKS * hw] and each pool's outputs [BLOCKS, 3, S, hw]."""
    x = (np.random.default_rng(2200000037).standard_normal((2, S, BLOCKS * HW)) * 0.25).astype(np.float32)
    outs = {}
    for ola in (CFG["ola"], "time"):
        pool = CudaStreamPool(_config(), HW, S, device="cpu", ola=ola)
        outs[ola] = torch.stack([torch.stack(pool.push_blocks(x[0][:, i * HW : (i + 1) * HW],
                                                              x[1][:, i * HW : (i + 1) * HW]))
                                 for i in range(BLOCKS)])
    return x, outs


def test_spectral_pool_agrees_with_the_reference(runs):
    x, outs = runs
    signal = torch.as_tensor(x, dtype=torch.float64)
    warmup = bands(CFG)[0].block // bands(CFG)[0].hop
    ref = Reference(CFG).stream_blocks(lambda a, z: signal[..., a:z], HW, warmup, list(range(BLOCKS)))
    assert bool(ref[warmup:].abs().amax(dim=(0, 2, 3)).gt(0).all())  # every stem sounds after the warm-up
    rms = ref.pow(2).mean(dim=(0, 2, 3)).sqrt()
    err = (outs["spectral"].double() - ref).abs().amax(dim=(0, 2, 3)) / rms
    assert bool((err <= LIMIT).all()), err


def test_spectral_pool_agrees_with_the_time_pool(runs):
    # The two OLA dataflows add the same frames in another order: 8 units
    # in the last place of the largest sample.
    _, outs = runs
    spectral, time = outs["spectral"], outs["time"]
    assert float((spectral - time).abs().max()) <= 8 * torch.finfo(torch.float32).eps * float(time.abs().max())


def test_spectral_plan_takes_the_edge_product():
    plan = CudaStreamPool(_config(), HW, S, device="cpu", ola="spectral").plan
    routes = plan.spectral_routes(1)
    assert routes.groups and [b.edge_product for b in plan.buckets] == [True, True, False, False]
    assert [g.buckets for g in routes.groups] == [(0, 1)]
    # the gather and the product, four forwards, the inverses of the two buckets with whole frames
    assert routes.launches == 8
