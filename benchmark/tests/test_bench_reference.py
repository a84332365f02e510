"""The reference agrees with the program's plain CPU path at a tiny size,
and its band plan, worked out anew, with the program's planner."""

import json

import numpy as np
import pytest
import torch

from tiny import ROOT
from benchmark import run
from benchmark.reference import plan
from benchmark.reference.core import Reference, tf32


def cfg(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["offline_44k_6band", "stream_48k_4band_bela", "offline_44k_6band_ov065"])
def test_plan_matches_the_program_config(name):
    from upmix_tpu_torch.ops.gains import band_gain_curve
    from upmix_tpu_torch.ops.windows import design_wola_synthesis_window, make_window

    c = cfg(name)
    port = run.port_config(c)
    mine = plan.bands(c)
    assert [(b.f_low, b.f_high, b.block, b.hop) for b in mine] == \
        [(b.f_low, b.f_high, b.block_size, b.hop_size) for b in port.bands]
    for b, p in zip(mine, port.bands):
        assert b.fade_low_hz == pytest.approx(p.xover_width_low_hz)
        np.testing.assert_allclose(plan.band_gain(b, c["xover_mode"], c["bin_rounding"]),
                                   band_gain_curve(p, dtype=np.float64), atol=1e-7)
    for bucket in plan.buckets(c):
        aw = make_window(c["window"], bucket.block)
        np.testing.assert_allclose(bucket.analysis, aw, atol=1e-7)
        if c["synthesis"] == "wola":
            np.testing.assert_allclose(bucket.synthesis, design_wola_synthesis_window(aw, c["overlap"]), rtol=1e-6)


@pytest.mark.parametrize("name", ["offline_44k_6band", "offline_44k_6band_ov065"])
def test_offline_matches_the_program_cpu_path(name):
    from upmix_tpu_torch.models.offline import Upmixer

    c = cfg(name)
    x = np.random.default_rng(3).standard_normal((2, 200003)).astype(np.float32) * 0.25
    x[1] += x[0]  # a shared component
    got = Upmixer(run.port_config(c), device="cpu", chunk=65536).process_np(x[0], x[1])
    ref = Reference(c).offline(x[0], x[1]).numpy()
    for k in range(3):
        assert np.abs(got[k] - ref[k]).max() / np.sqrt((ref[k] ** 2).mean()) < 1e-5


def test_stream_blocks_match_the_program_cpu_pool():
    from upmix_tpu_torch.models.streaming import CudaStreamPool

    c = cfg("stream_48k_4band_bela")
    hw, S, T = 2048, 5, 12
    sig = np.random.default_rng(4).standard_normal((2, S, T * hw)).astype(np.float32) * 0.25
    pool = CudaStreamPool(run.port_config(c), hw, S, device="cpu")
    outs = [torch.stack(pool.push_blocks(sig[0, :, t * hw : (t + 1) * hw], sig[1, :, t * hw : (t + 1) * hw]))
            for t in range(T)]
    blocks = [0, 2, 3, 4, 7, 11]  # silence through the warm-up, then history and carries
    ref = Reference(c).stream_blocks(lambda a, z: torch.as_tensor(sig[..., a:z]), hw, 4, blocks)
    for j, t in enumerate(blocks):
        err = (outs[t].double() - ref[j]).abs().max()
        assert err < 1e-5, (t, float(err))
    assert ref[0].abs().max() == 0 and ref[2].abs().max() > 0.05


def parent_ola(rec, hop):
    """The overlap-add as it stood when every hop divided its block."""
    *lead, F, B = rec.shape
    k = B // hop
    acc = rec.new_zeros((*lead, F + k - 1, hop))
    parts = rec.unflatten(-1, (k, hop))
    for q in range(k):
        acc[..., q : q + F, :] += parts[..., q, :]
    return acc.flatten(-2)


@pytest.mark.parametrize("name", ["offline_44k_6band", "stream_48k_4band_bela", "stream_48k_4band_bela_spectral"])
def test_ola_at_dividing_hops_is_bit_for_bit_the_parents(name):
    gen = torch.Generator().manual_seed(5)
    for b in plan.buckets(cfg(name)):
        assert b.block % b.hop == 0
        for dtype in (torch.float64, torch.float32):  # the reference's and the control's
            rec = torch.randn((2, 3, 7, b.block), generator=gen, dtype=dtype)
            assert torch.equal(Reference._ola(rec, b.hop), parent_ola(rec, b.hop)), (b.block, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ola_at_hops_that_divide_no_block_adds_each_frame_at_its_hop(dtype):
    gen = torch.Generator().manual_seed(6)
    blocks = [(b.block, b.hop) for b in plan.buckets(cfg("offline_44k_6band_ov065"))] + [(10, 3), (5, 4)]
    frames = 5
    for block, hop in blocks:
        assert block % hop
        rec = torch.randn((3, frames, block), generator=gen, dtype=dtype)
        want = torch.zeros((3, (frames - 1) * hop + block), dtype=dtype)
        for i in range(frames):
            want[:, i * hop : i * hop + block] += rec[:, i]
        got = Reference._ola(rec, hop)
        assert got.shape == want.shape, (block, hop)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 if dtype == torch.float64 else 1e-5)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-10), 3.0e-3], dtype=torch.float32)
    y = tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2 * 2**-10 and y[2] == x[2]  # ties to even; exact stays
    assert abs(y[3] - x[3]) <= x[3] * 2**-11
    z = tf32(torch.complex(x, -x))
    assert torch.equal(z.real, y) and torch.equal(z.imag, -y)
