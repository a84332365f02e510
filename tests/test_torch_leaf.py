"""The port's leaf modules against the JAX package's: `filter_design`
(the counterparts of tests/test_filter_design.py), `visualize` (of
tests/test_visualize.py) and `demo` (of tests/test_streaming_app.py's
demo entry), on seeded inputs.  Bit for bit where the code is a copy;
the port's numpy-only FIR against scipy's within the JAX fallback's
1e-9."""

import os

import numpy as np
import pytest

import upmix_tpu.filter_design as jfd
import upmix_tpu.visualize as jvis
from upmix_tpu_torch import filter_design as fd
from upmix_tpu_torch import visualize as vis
from upmix_tpu_torch.io import write_wav
from upmix_tpu_torch.ops.windows import design_wola_synthesis_window, make_blackman_harris

from helpers import make_stereo


def test_passthrough_for_nonpositive_cutoff():
    np.testing.assert_array_equal(fd.design_lr4_hp_fir(44100, 0.0), [1.0])
    np.testing.assert_array_equal(fd.design_lr4_lp_fir(44100, -5.0), [1.0])
    x = np.random.default_rng(0).standard_normal(100)
    np.testing.assert_allclose(fd.apply_fir_filter(x, np.array([1.0])), x)


def test_lp_hp_frequency_response():
    sr, fc = 44100.0, 180.0
    lp = fd.design_lr4_lp_fir(sr, fc)
    hp = fd.design_lr4_hp_fir(sr, fc)
    assert len(lp) == len(hp) == 1025 and lp.dtype == hp.dtype == np.float32
    w = np.fft.rfftfreq(8192, 1 / sr)
    LP = np.abs(np.fft.rfft(lp, 8192))
    HP = np.abs(np.fft.rfft(hp, 8192))
    assert LP[0] == pytest.approx(1.0, abs=1e-3)
    assert HP[0] < 5e-3
    assert LP[-1] < 5e-3
    assert HP[-1] == pytest.approx(1.0, abs=1e-3)
    k = np.argmin(np.abs(w - fc))
    assert 0.3 < LP[k] < 0.7 and 0.3 < HP[k] < 0.7


@pytest.mark.parametrize("pass_zero", [True, False])
def test_taps_match_jax(pass_zero):
    # The windowed sinc is the JAX package's fallback, bit for bit, and
    # scipy's firwin (which the JAX package calls when present) to 1e-9.
    for numtaps, cutoff in ((257, 0.2), (1025, 180.0 / 22050.0)):
        ours = fd._firwin(numtaps, cutoff, pass_zero)
        np.testing.assert_array_equal(ours, jfd._firwin_fallback(numtaps, cutoff, pass_zero))
    design, jdesign = (fd.design_lr4_lp_fir, jfd.design_lr4_lp_fir) if pass_zero else (
        fd.design_lr4_hp_fir, jfd.design_lr4_hp_fir)
    for sr, fc, taps in ((44100.0, 180.0, 1025), (8000.0, 500.0, 101)):
        np.testing.assert_allclose(design(sr, fc, taps), jdesign(sr, fc, taps), rtol=0, atol=1e-7)


def test_apply_fir_filter_length_linearity_and_jax():
    x = np.random.default_rng(1).standard_normal(500)
    taps = fd.design_lr4_lp_fir(8000.0, 500.0, numtaps=101)
    y = fd.apply_fir_filter(x, taps)
    assert len(y) == len(x)
    np.testing.assert_allclose(fd.apply_fir_filter(2 * x, taps), 2 * y, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(y, jfd.apply_fir_filter(x, taps), rtol=0, atol=1e-12)


def test_wola_plot_math_golden_and_jax():
    aw = make_blackman_harris(256)
    sw = design_wola_synthesis_window(aw, 0.75)
    asum, wsum = vis.overlapped_window_sums(aw, sw, 0.75)
    L, hop = 256, 64
    np.testing.assert_allclose(wsum[L - hop : -(L - hop)], 1.0, atol=1e-3)
    a_int = asum[L - hop : -(L - hop)]
    assert abs(a_int.mean() - 4 * 0.35875) < 0.02 and a_int.std() < 0.02
    for ours, theirs in zip((asum, wsum), jvis.overlapped_window_sums(aw, sw, 0.75)):
        np.testing.assert_array_equal(ours, theirs)
    # The analysis window as synthesis does not meet the invariant.
    _, wrong = vis.overlapped_window_sums(aw, aw, 0.75)
    assert np.abs(wrong[192:-192] - 1.0).max() > 0.05


def test_comparison_arrays_golden_and_jax():
    sr, n = 8000.0, 4096
    tone = np.sin(2 * np.pi * 500 * np.arange(n) / sr).astype(np.float32)
    zeros = np.zeros(n, np.float32)
    tt, upmix, orig, freqs, up_spec, orig_spec = vis.comparison_arrays(tone, zeros, zeros, tone, tone, sr)
    assert tt.shape == (n,) and freqs.shape == (n // 2 + 1,)
    np.testing.assert_allclose(upmix, orig, atol=1e-6)
    assert abs(freqs[int(np.argmax(up_spec))] - 500.0) < sr / n + 1e-9
    rng = np.random.default_rng(2)
    args = [rng.standard_normal(n).astype(np.float32) for _ in range(5)]
    for ours, theirs in zip(vis.comparison_arrays(*args, sr), jvis.comparison_arrays(*args, sr)):
        np.testing.assert_array_equal(ours, theirs)


def test_plots_render_nonblank(tmp_path):
    plt = pytest.importorskip("matplotlib.pyplot")
    aw = make_blackman_harris(256)
    assert vis.visualize_windows(aw, design_wola_synthesis_window(aw, 0.75), 0.75, save_path=tmp_path / "w.png")
    rng = np.random.default_rng(0)
    vis.compare_upmix_vs_original(*(rng.standard_normal(2048).astype(np.float32) for _ in range(5)), 8000.0,
                                  save_path=tmp_path / "ab.png")
    for name in ("w.png", "ab.png"):
        assert plt.imread(str(tmp_path / name)).std() > 0.01


def test_demo_entry(tmp_path):
    pytest.importorskip("matplotlib")
    from upmix_tpu_torch.demo import main

    L, R = make_stereo(8 * 256, 8000.0, seed=0)
    wav = tmp_path / "in.wav"
    write_wav(wav, np.column_stack([L, R]).astype(np.float32), 8000, subtype="FLOAT")
    out = tmp_path / "demo"
    assert main([str(wav), "--out-dir", str(out), "--band-edges", "0,400,1600", "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["upmix_vs_original.png", "windows_band0.png"]
