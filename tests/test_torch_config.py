"""The port's config module is its own copy of `upmix_tpu/config.py`: the
same arguments give equal configs field for field (`dataclasses.asdict`),
the same errors, and the same bin and block-size arithmetic.
"""

import dataclasses
import itertools

import numpy as np
import pytest

import upmix_tpu.config as jcfg
import upmix_tpu_torch.config as pcfg
from upmix_tpu_torch.ops.windows import register_window
from test_torch_offline import PARITY

BENCH_EDGES = [0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0]
STREAMING = {
    "8k_hw256": (([0.0, 400.0, 1600.0],), dict(sr=8000.0, hw_block_size=256)),
    "bela_48k_hw2048": (([0.0, 500.0, 2000.0, 8000.0],), dict(sr=48000.0, hw_block_size=2048)),
    "bench_44k_hw2048": ((BENCH_EDGES,), dict(sr=44100.0, hw_block_size=2048)),
}
VARIANTS = {
    "default": {},
    "hard_zero": dict(xover_mode="hard_zero"),
    "python_rounding_wola": dict(bin_rounding="python", synthesis="wola"),
    "hard_zero_cpp_analysis": dict(xover_mode="hard_zero", bin_rounding="cpp", synthesis="analysis"),
}


def _same(build, *args, **kw):
    a = build(pcfg, *args, **kw)
    b = build(jcfg, *args, **kw)
    assert type(a) is not type(b)  # two classes, one per package
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    return a


@pytest.mark.parametrize("name", list(PARITY))
def test_make_equals_jax(name):
    (edges, kw), *_ = PARITY[name]
    cfg = _same(lambda m, *a, **k: m.UpmixConfig.make(*a, **k), edges, **kw)
    assert cfg.band_edges == jcfg.UpmixConfig.make(edges, **kw).band_edges


@pytest.mark.parametrize("name,variant", list(itertools.product(STREAMING, VARIANTS)))
def test_streaming_equals_jax(name, variant):
    args, kw = STREAMING[name]
    _same(lambda m, *a, **k: m.UpmixConfig.streaming(*a, **k), *args, **kw, **VARIANTS[variant])


@pytest.mark.parametrize(
    "edges,sr",
    [([], 8000.0), ([0.0, 400.0, 200.0], 8000.0), ([0.0, 400.0, 400.0], 8000.0), ([-1.0], 8000.0),
     ([5000.0], 8000.0), ([4000.0], 8000.0)],
)
def test_same_errors(edges, sr):
    msgs = []
    for m in (pcfg, jcfg):
        for build in (lambda: m.UpmixConfig.make(edges, sr=sr),
                      lambda: m.UpmixConfig.streaming(edges, sr=sr, hw_block_size=256)):
            with pytest.raises(ValueError) as err:
                build()
            msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:]


@pytest.mark.parametrize("rounding", ["python", "cpp"])
def test_freq_to_bin_and_block_size_equal(rounding):
    for sr, fft in itertools.product((8000.0, 44100.0, 48000.0), (64, 256, 1000, 4096, 65536)):
        for f in (0.0, 1.0, 5.0, 30.0, 62.5, 100.0, 400.0, 1234.5, sr / 4, sr / 2, sr):
            assert pcfg.freq_to_bin(f, sr, fft, rounding) == jcfg.freq_to_bin(f, sr, fft, rounding)
    for sr, f, cap, thr in itertools.product(
        (8000.0, 44100.0, 48000.0), (-1.0, 0.0, 5.0, 30.0, 400.0, 7680.0), (256, 8192, 65536), (16.0, 32.0)
    ):
        assert pcfg.compute_block_size_for_low_freq(f, sr, cap, thr) == jcfg.compute_block_size_for_low_freq(
            f, sr, cap, thr
        )
    with pytest.raises(ValueError):
        pcfg.freq_to_bin(1.0, 8000.0, 256, "banker")


def test_helpers_equal():
    for x in (-3, 0, 1, 2, 3, 1000, 4096, 4097):
        assert pcfg.next_power_of_2(x) == jcfg.next_power_of_2(x)
    assert pcfg.hp_freq_to_crossover_width(400.0) == jcfg.hp_freq_to_crossover_width(400.0)
    assert pcfg.streaming_stft_table(48000.0, 2048) == jcfg.streaming_stft_table(48000.0, 2048)
    assert (pcfg.EPS, pcfg.MAX_STFT_SIZE_STREAM, pcfg.THRESHOLD_MULTI, pcfg.XO_FRACTION, pcfg.MAX_BANDS_STREAM) == (
        jcfg.EPS, jcfg.MAX_STFT_SIZE_STREAM, jcfg.THRESHOLD_MULTI, jcfg.XO_FRACTION, jcfg.MAX_BANDS_STREAM
    )
    cfg = pcfg.UpmixConfig.make(BENCH_EDGES, sr=44100.0)
    buckets = pcfg.bucket_bands(cfg.bands)
    assert list(buckets) == list(jcfg.bucket_bands(jcfg.UpmixConfig.make(BENCH_EDGES, sr=44100.0).bands))
    assert [len(v) for v in buckets.values()] == [2, 1, 1, 1, 1]


def test_custom_window_raises_at_construction():
    # A window name neither registry knows raises ValueError when the config
    # is built, in both packages; once registered in the port's registry
    # the port builds the config (tests/test_torch_windows.py).
    for mod in (pcfg, jcfg):
        with pytest.raises(ValueError, match="unknown window 'never_registered'"):
            mod.UpmixConfig.make([0.0, 400.0], sr=8000.0, window="never_registered")
        with pytest.raises(ValueError, match="unknown window"):
            mod.BandSpec(0.0, 400.0, 8000.0, 256, window="never_registered")
    register_window("config_test_window", np.hanning, overwrite=True)
    band = pcfg.BandSpec(0.0, 400.0, 8000.0, 256, window="config_test_window")
    assert band.window == "config_test_window"
    with pytest.raises(ValueError, match="hop size"):
        pcfg.BandSpec(0.0, 400.0, 8000.0, 256, overlap=1.0)
