"""The torch port's host plans and tensor ops against the JAX package.

Host plans (windows, gains, direct-DFT weights, bucket plans) are numpy
copies and must equal upmix_tpu's bit for bit.  Tensor ops are compared
on the same numpy inputs: exact where the arithmetic is the same
(framing, overlap-add), <= 1e-6 of the output's scale where float32
rounding differs (the masks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upmix_tpu.ops.dftmm as jdft
import upmix_tpu.ops.framing as jfr
import upmix_tpu.ops.gains as jgains
import upmix_tpu.ops.mask as jmask
import upmix_tpu.ops.windows as jwin
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.offline import _plan_buckets as jax_plan_buckets
from upmix_tpu.ops.pallas_upmix import _mask_sum as jax_mask_sum
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.offline import _plan_buckets
from upmix_tpu_torch.ops import dftmm, framing, gains, mask, windows
from upmix_tpu_torch.ops.windows import BUILTIN_WINDOWS

BENCH = ([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], dict(sr=44100.0, max_block_size=65536))
CONFIGS = [
    BENCH,
    ([0.0], dict(sr=8000.0, max_block_size=512)),
    ([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512)),
    ([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512, xover_mode="hard_zero")),
    ([0.0, 5.0, 400.0], dict(sr=8000.0, max_block_size=512)),
    ([0, 100, 200, 400, 800, 1200, 1600, 2400, 3200], dict(sr=8000.0, max_block_size=1024)),
    ([0.0, 400.0], dict(sr=8000.0, max_block_size=512, synthesis="analysis", bin_rounding="cpp")),
    ([0.0, 2000.0], dict(sr=8000.0, max_block_size=512, overlap=0.5)),
    ([0.0, 1000.0], dict(sr=8000.0, max_block_size=1000, window="hann", overlap=0.65)),
]


def _rel_close(got, ref, rel):
    dt = np.complex128 if np.iscomplexobj(ref) else np.float64
    got, ref = np.asarray(got, dt), np.asarray(ref, dt)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= rel * scale, (np.abs(got - ref).max(), scale)


@pytest.mark.parametrize("name", BUILTIN_WINDOWS)
def test_windows_equal(name):
    for n in (16, 255, 256, 4096, 65536):
        np.testing.assert_array_equal(windows.make_window(name, n), jwin.make_window(name, n))
        for overlap in (0.75, 0.5, 0.65):
            aw = windows.make_window(name, n)
            np.testing.assert_array_equal(
                windows.design_wola_synthesis_window(aw, overlap),
                jwin.design_wola_synthesis_window(aw, overlap),
            )


def test_custom_window_name_refused():
    # A name no registry knows is refused by both packages, with the same
    # error; a registered one is built (tests/test_torch_windows.py).
    with pytest.raises(ValueError, match="unknown window 'my_window'"):
        windows.make_window("my_window", 64)
    with pytest.raises(ValueError, match="unknown window 'my_window'"):
        jwin.make_window("my_window", 64)


@pytest.mark.parametrize("case", range(len(CONFIGS)))
def test_gains_and_bucket_plans_equal(case):
    edges, kw = CONFIGS[case]
    cfg = UpmixConfig.make(edges, **kw)
    jcfg = JaxUpmixConfig.make(edges, **kw)
    for band, jband in zip(cfg.bands, jcfg.bands, strict=True):
        for dt in (np.float32, np.float64):
            np.testing.assert_array_equal(
                gains.band_gain_curve(band, dtype=dt), jgains.band_gain_curve(jband, dtype=dt)
            )
    for n in (1, 997, 5000):
        for p, q in zip(_plan_buckets(cfg, n), jax_plan_buckets(jcfg, n), strict=True):
            assert (p.block_size, p.hop_size, p.num_frames, p.total_padded) == (
                q.block_size, q.hop_size, q.num_frames, q.total_padded
            )
            for field in ("analysis_window", "synthesis_window", "gains"):
                a, b = getattr(p, field), getattr(q, field)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [0, 2, 5, 7])
def test_direct_plan_weights_equal(case):
    # Every kept-bin slice of the config, DC (lo = 0) and Nyquist
    # (hi = B/2) half-weights included.  The bench config's 65536 bucket
    # (2 x 117 MB of weights per package) is left out to keep memory low.
    edges, kw = CONFIGS[case]
    cfg = UpmixConfig.make(edges, **kw)
    for p in _plan_buckets(cfg, 4096):
        if p.block_size > 16384:
            continue
        nz = np.nonzero(p.gains.max(axis=0))[0]
        lo, hi = int(nz[0]), int(nz[-1])
        a = dftmm.make_direct_plan(p.block_size, lo, hi, p.analysis_window, p.synthesis_window)
        b = jdft.make_direct_plan(p.block_size, lo, hi, p.analysis_window, p.synthesis_window)
        assert (a.n, a.lo_bin, a.hi_bin, a.n_bins) == (b.n, b.lo_bin, b.hi_bin, b.n_bins)
        np.testing.assert_array_equal(a.w_fwd, b.w_fwd)
        np.testing.assert_array_equal(a.w_inv, b.w_inv)


def test_rdft_irdft_direct_match_jax():
    # Plain float32 products on both sides; summation order differs.
    aw = windows.make_window("blackman_harris", 512)
    sw = windows.design_wola_synthesis_window(aw, 0.75)
    plan = dftmm.make_direct_plan(512, 0, 128, aw, sw)
    jplan = jdft.make_direct_plan(512, 0, 128, aw, sw)
    x = np.random.default_rng(0).standard_normal((3, 7, 512)).astype(np.float32)
    re, im = dftmm.rdft_direct(torch.as_tensor(x), torch.as_tensor(plan.w_fwd))
    jre, jim = jdft.rdft_direct(jnp.asarray(x), jplan)
    _rel_close(re, jre, 1e-6)
    _rel_close(im, jim, 1e-6)
    y = dftmm.irdft_direct(re, im, torch.as_tensor(plan.w_inv))
    jy = jdft.irdft_direct(jre, jim, jplan)
    _rel_close(y, jy, 1e-6)


def _spectra(shape, seed):
    rng = np.random.default_rng(seed)
    parts = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    parts[1][..., :3] = 0.0  # exact zeros: the EPS guards
    parts[0][..., :2] = 0.0
    parts[2][..., 5] = parts[0][..., 5]  # L == R bins: full coherence
    parts[3][..., 5] = parts[1][..., 5]
    return parts


def test_center_mask_matches_jax():
    lre, lim, rre, rim = _spectra((4, 33), 1)
    sl = torch.complex(torch.as_tensor(lre), torch.as_tensor(lim))
    sr = torch.complex(torch.as_tensor(rre), torch.as_tensor(rim))
    got = mask.center_mask(sl, sr)
    ref = jmask.center_mask(jnp.asarray(lre + 1j * lim), jnp.asarray(rre + 1j * rim))
    for g, r in zip(got, ref):
        assert g.dtype == torch.complex64
        _rel_close(g.numpy(), np.asarray(r), 1e-6)


def test_mask_sum_matches_jax_and_center_mask():
    lre, lim, rre, rim = _spectra((6, 41), 2)
    g = np.random.default_rng(3).uniform(0.0, 1.0, (3, 41)).astype(np.float32)
    g[:, :4] = 0.0
    got = mask.mask_sum(*(torch.as_tensor(a) for a in (lre, lim, rre, rim)), torch.as_tensor(g))
    ref = jax_mask_sum(*(jnp.asarray(a) for a in (lre, lim, rre, rim)), [jnp.asarray(b) for b in g])
    for a, b in zip(got, ref):
        _rel_close(a.numpy(), np.asarray(b), 1e-6)
    # The SoA formula (coherence = cross / (cross + EPS)) and the complex
    # one (|L conj R| / (|L||R| + EPS)) agree to float32 rounding.
    sl = torch.complex(torch.as_tensor(lre), torch.as_tensor(lim))
    sr = torch.complex(torch.as_tensor(rre), torch.as_tensor(rim))
    acc = [0.0, 0.0, 0.0]
    for gb in torch.as_tensor(g):
        for k, part in enumerate(mask.center_mask(sl * gb, sr * gb)):
            acc[k] = acc[k] + part
    for k in range(3):
        _rel_close(got[2 * k].numpy(), acc[k].real.numpy(), 1e-6)
        _rel_close(got[2 * k + 1].numpy(), acc[k].imag.numpy(), 1e-6)


@pytest.mark.parametrize("block,hop", [(256, 64), (512, 256), (64, 64), (100, 35)])
def test_frame_and_overlap_add_equal(block, hop):
    rng = np.random.default_rng(block + hop)
    F = 9
    x = rng.standard_normal((2, (F - 1) * hop + block)).astype(np.float32)
    fr = framing.frame_signal(torch.as_tensor(x), block, hop, F)
    np.testing.assert_array_equal(fr.numpy(), np.asarray(jfr.frame_signal(jnp.asarray(x), block, hop, F)))
    frames = rng.standard_normal((3, F, block)).astype(np.float32)
    got = framing.overlap_add(torch.as_tensor(frames), hop).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfr.overlap_add(jnp.asarray(frames), hop)))


def test_frame_signal_rejects_wrong_length():
    with pytest.raises(ValueError):
        framing.frame_signal(torch.zeros(2, 100), 64, 16, 4)


def test_offline_frame_plan_equal():
    for n in (1, 63, 64, 100, 997, 4096, 65537):
        for block, hop in ((256, 64), (65536, 16384), (1000, 350)):
            assert framing.offline_frame_plan(n, block, hop) == jfr.offline_frame_plan(n, block, hop)
