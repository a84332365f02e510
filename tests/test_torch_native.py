"""The port's native engine loader (`upmix_tpu_torch.native`, the C++
host shell of native/ on the CPU): the counterparts of tests/test_native.py
and of the native cases of tests/test_streaming_app.py, against the NumPy
oracle, the port's streaming engine and the JAX package's loader of the
same library (bit for bit: one library, the same arguments).

The library is built with `make -C native` on demand; the tests skip, as
tests/test_native.py does, when it cannot be built."""

import os
import threading

import numpy as np
import pytest

from helpers import make_stereo, snr_db
from torch_helpers import native_engine
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.oracle.reference import oracle_stream_multiband
from upmix_tpu_torch.config import UpmixConfig

HW = 256
EDGES = [0.0, 400.0, 1600.0]
SR = 8000.0


@pytest.fixture(scope="module")
def native():
    return native_engine()


def _signal(n_blocks, seed):
    L, R = make_stereo(n_blocks * HW, SR, seed=seed)
    return L.astype(np.float32), R.astype(np.float32)


@pytest.mark.parametrize("synthesis,rounding,precision", [
    ("analysis", "cpp", "double"), ("wola", "python", "double"), ("analysis", "cpp", "float"),
    ("wola", "python", "float"),
])
def test_native_parity_vs_oracle(native, synthesis, rounding, precision):
    cfg = JaxUpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW, synthesis=synthesis, bin_rounding=rounding)
    eng = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW, synthesis=synthesis, bin_rounding=rounding,
                                        precision=precision)
    L, R = _signal(16, 0)
    ref_l, ref_r = oracle_stream_multiband(L, R, cfg, HW)
    got_l, got_r = eng.process_signal(L, R, mix="stereo_sum")
    assert snr_db(ref_l, got_l) > 60.0 and snr_db(ref_r, got_r) > 60.0


def test_native_float_mode_close_to_double_mode(native):
    kw = dict(sr=SR, hw_block_size=HW, synthesis="analysis", bin_rounding="cpp")
    L, R = _signal(16, 2)
    d = native.NativeStreamingUpmixer(EDGES, **kw).process_signal(L, R, mix="stereo_sum")
    f = native.NativeStreamingUpmixer(EDGES, precision="float", **kw).process_signal(L, R, mix="stereo_sum")
    assert snr_db(d[0], f[0]) > 80.0 and snr_db(d[1], f[1]) > 80.0


def test_native_rejects_bad_arguments(native):
    with pytest.raises(ValueError):
        native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW, precision="half")
    with pytest.raises(ValueError):
        native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=3)
    with pytest.raises(ValueError):
        native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW, window="nope")
    eng = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW)
    with pytest.raises(ValueError, match="shape"):
        eng.push_block(np.zeros(HW - 1), np.zeros(HW - 1))
    with pytest.raises(ValueError, match="unknown mix"):
        eng.process_signal(np.zeros(HW), np.zeros(HW), mix="quad")


def test_native_vs_the_ports_streaming_engine(native):
    from upmix_tpu_torch.models import StreamingUpmixer

    cfg = UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)
    eng = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW, synthesis="analysis", bin_rounding="cpp")
    L, R = _signal(12, 2)
    ref = StreamingUpmixer(cfg, HW, device="cpu").process_signal(L, R, mix="lcr")
    for r, g in zip(ref, eng.process_signal(L, R, mix="lcr")):
        assert snr_db(r.numpy(), g) > 60.0


@pytest.mark.parametrize("window", ["blackman_harris", "hann", "hamming", "sqrt_hann", "vector", "callable"])
def test_native_windows_match_the_jax_loader(native, window):
    # Both loaders hand the one library the same arguments: built-in
    # windows by their code, registered ones as the per-band vectors of
    # make_window (the port's bit for bit the JAX package's).
    from upmix_tpu import native as jax_native
    from upmix_tpu.ops import windows as jax_windows
    from upmix_tpu_torch.ops import windows

    vec = np.kaiser(700, 6.0).astype(np.float32)

    def tukey(N):
        return (np.sin(np.pi * np.linspace(0, 1, N)) ** 1.5).astype(np.float32)

    name = window
    if window in ("vector", "callable"):
        name = f"test:native-{window}"
        for reg in (windows, jax_windows):
            if window == "vector":
                reg.register_window_vector(name, vec, overwrite=True)
            else:
                reg.register_window(name, tukey, overwrite=True)
    try:
        kw = dict(sr=SR, hw_block_size=HW, synthesis="analysis", bin_rounding="cpp", window=name)
        L, R = _signal(12, 11)
        got = native.NativeStreamingUpmixer(EDGES, **kw).process_signal(L, R, mix="lcr")
        want = jax_native.NativeStreamingUpmixer(EDGES, **kw).process_signal(L, R, mix="lcr")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        cfg = JaxUpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW, window=name)
        ref_l, _ = oracle_stream_multiband(L, R, cfg, HW)
        assert snr_db(ref_l, got[1] + 0.5 * got[0]) > 60.0
    finally:
        windows._CUSTOM.pop(name, None)
        jax_windows._CUSTOM.pop(name, None)


def test_native_hard_zero_mode(native):
    cfg = JaxUpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW, xover_mode="hard_zero")
    eng = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW, xover_mode="hard_zero",
                                        synthesis="analysis", bin_rounding="cpp")
    L, R = _signal(12, 3)
    ref_l, ref_r = oracle_stream_multiband(L, R, cfg, HW)
    got_l, got_r = eng.process_signal(L, R, mix="stereo_sum")
    assert snr_db(ref_l, got_l) > 60.0 and snr_db(ref_r, got_r) > 60.0


def test_native_warmup_reset_and_sizing(native):
    eng = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW)
    assert eng.latency_blocks == 4
    assert eng.block_sizes == [b.block_size for b in UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW).bands]
    x = np.random.default_rng(4).standard_normal(HW).astype(np.float32)
    for _ in range(3):
        assert np.all(eng.push_block(x, x)[0] == 0.0)
    assert np.abs(eng.push_block(x, x)[0]).max() > 0.0
    eng.reset()
    assert np.all(eng.push_block(x, x)[0] == 0.0)
    edges = [0, 50, 100, 200, 400, 800, 1200, 1600, 2000, 2400, 2800]
    assert native.NativeStreamingUpmixer(edges, sr=8000.0, hw_block_size=256).num_bands == 8


@pytest.mark.parametrize("n_threads", [0, 3])
def test_native_band_pool_bit_identical(native, n_threads):
    L, R = _signal(16, 21)
    ref = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW).process_signal(L, R, mix="lcr")
    pooled = native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW, n_threads=n_threads)
    for _ in range(2):  # and across a reset
        for r, g in zip(ref, pooled.process_signal(L, R, mix="lcr")):
            np.testing.assert_array_equal(r, g)
        pooled.reset()


def test_concurrent_engines_are_independent(native):
    L, R = _signal(12, 9)

    def run():
        return native.NativeStreamingUpmixer(EDGES, sr=SR, hw_block_size=HW).process_signal(L, R, mix="stereo_sum")

    seq = run()
    results = [None, None]
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, run())) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for res in results:
        np.testing.assert_array_equal(res[0], seq[0])
        np.testing.assert_array_equal(res[1], seq[1])


def test_app_and_cli_run_the_native_engine(native, tmp_path, capsys):
    # app.run_streaming and run_pipe with engine="native" against the JAX
    # app's native engine (the same library), and --engine native.
    import io

    import upmix_tpu.app as japp
    import upmix_tpu_torch.app as tapp
    from upmix_tpu_torch.cli import main
    from upmix_tpu_torch.io import read_wav, write_wav

    L, R = _signal(8, 0)
    wav = tmp_path / "in.wav"
    write_wav(wav, np.column_stack([L, R]), int(SR), subtype="FLOAT")
    kw = dict(hw_block_size=HW, band_edges=EDGES, engine="native")
    got = tapp.run_streaming(wav, out_dir=tmp_path / "t", **kw)
    want = japp.run_streaming(wav, out_dir=tmp_path / "j", **kw)
    assert [os.path.basename(p) for p in got.paths] == [os.path.basename(p) for p in want.paths]
    np.testing.assert_array_equal(read_wav(got.paths[0])[0], read_wav(want.paths[0])[0])
    raw = np.column_stack([L, R]).astype("<f4").tobytes()
    outs = []
    for run in (tapp.run_pipe, japp.run_pipe):
        sink = io.BytesIO()
        assert run(io.BytesIO(raw), sink, sr=SR, **kw) == len(L)
        outs.append(sink.getvalue())
    assert outs[0] == outs[1]
    assert main([str(wav), "--streaming", "--engine", "native", "--hw-block", str(HW), "--band-edges", "0,400,1600",
                 "--out-dir", str(tmp_path / "cli")]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    np.testing.assert_array_equal(read_wav(printed[-1])[0], read_wav(got.paths[0])[0])
