"""Custom windows in the port's own registry (`upmix_tpu_torch/ops/windows.py`)
against the JAX package's (`upmix_tpu/ops/windows.py`).

The same window registered in both packages gives the same coefficients
(bit for bit, vectors resampled per band alike), the same config dicts,
and the same stems: offline and sharded against the NumPy oracle (> 60 dB,
the repo's bar) and against the JAX paths (> 80 dB: float32 FFTs here,
XLA's on the JAX side), the CPU pool against the JAX XLA pool (> 80 dB).
The registry refuses what the JAX one refuses, with the same messages;
the CLI's --window-file registers under the JAX CLI's content-derived
name, and an unknown --window is a one-line exit.

Registrations are process-wide: each test uses names of its own.
"""

import numpy as np
import pytest
import torch

from helpers import make_stereo, snr_db
from upmix_tpu import aot as jaot
from upmix_tpu.cli import load_window_file as jax_load_window_file
from upmix_tpu.cli import main as jax_main
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.offline import upmix_offline as jax_upmix_offline
from upmix_tpu.models.streaming import BatchStreamingUpmixer as JaxBatch
from upmix_tpu.ops import windows as jwin
from upmix_tpu.oracle import oracle_multiband
from upmix_tpu.parallel import ShardedUpmixer as JaxShardedUpmixer
from upmix_tpu.parallel import make_mesh as jax_make_mesh
from upmix_tpu_torch import cli
from upmix_tpu_torch.config import UpmixConfig, config_to_dict
from upmix_tpu_torch.io import read_wav, write_wav
from upmix_tpu_torch.models import Upmixer
from upmix_tpu_torch.models.streaming import make_stream_pool
from upmix_tpu_torch.ops import omnibus
from upmix_tpu_torch.ops import windows as pwin
from upmix_tpu_torch.parallel import ShardedUpmixer, make_mesh

EDGES = [0.0, 400.0, 1600.0]
VEC = np.kaiser(300, 6.0)  # 300 samples: resampled to every block size


def _both(register, name, *args, **kw):
    """Register one window in both packages (overwrite: tests may rerun)."""
    register(pwin, name, *args, overwrite=True, **kw)
    register(jwin, name, *args, overwrite=True, **kw)
    return name


def _vector(mod, name, vec, **kw):
    return mod.register_window_vector(name, vec, **kw)


def _callable(mod, name, fn, **kw):
    return mod.register_window(name, fn, **kw)


def _stereo32(n, sr, seed):
    return tuple(a.astype(np.float32) for a in make_stereo(n, sr, seed=seed))


@pytest.mark.parametrize("n", [16, 100, 256, 299, 300, 301, 4096])
def test_vector_resampled_per_band_as_jax(n):
    name = _both(_vector, "win_resample", VEC)
    np.testing.assert_array_equal(pwin.make_window(name, n), jwin.make_window(name, n))
    if n == VEC.size:  # a band of the vector's own length gets it verbatim
        np.testing.assert_array_equal(pwin.make_window(name, n), VEC.astype(np.float32))
    np.testing.assert_array_equal(
        pwin.design_wola_synthesis_window(pwin.make_window(name, n), 0.65),
        jwin.design_wola_synthesis_window(jwin.make_window(name, n), 0.65),
    )


def test_registry_names_and_lookup():
    name = _both(_callable, "win_names", np.hanning)
    assert pwin.is_known_window(name) and jwin.is_known_window(name)
    assert not pwin.is_builtin_window(name) and pwin.is_builtin_window("hann")
    assert pwin.window_names()[: len(pwin.BUILTIN_WINDOWS)] == pwin.BUILTIN_WINDOWS
    assert set(pwin.BUILTIN_WINDOWS) == set(jwin.window_names()[: len(pwin.BUILTIN_WINDOWS)])
    assert name in pwin.window_names()
    assert not pwin.is_known_window("win_never_registered")


def _message(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize(
    "case",
    ["builtin_name", "duplicate", "wrong_length", "non_finite", "short_vector", "non_finite_vector", "unknown"],
)
def test_registry_errors_as_jax(case):
    for mod in (pwin, jwin):
        mod.register_window("win_taken", np.hanning, overwrite=True)
    calls = {
        "builtin_name": lambda m: m.register_window("hann", np.hanning),
        "duplicate": lambda m: m.register_window("win_taken", np.hamming),
        "wrong_length": lambda m: m.register_window("win_bad", lambda N: np.ones(N + 1)),
        "non_finite": lambda m: m.register_window("win_bad", lambda N: np.full(N, np.nan)),
        "short_vector": lambda m: m.register_window_vector("win_bad", [1.0]),
        "non_finite_vector": lambda m: m.register_window_vector("win_bad", [1.0, np.inf, 1.0]),
        "unknown": lambda m: m.window_payload("win_never_registered", [256]),
    }
    assert _message(lambda: calls[case](pwin)) == _message(lambda: calls[case](jwin))
    assert not pwin.is_known_window("win_bad")


def test_config_dict_carries_the_window_as_jax():
    for name, register, arg in (("win_dict_vec", _vector, VEC), ("win_dict_fn", _callable, np.blackman)):
        _both(register, name, arg)
        kw = dict(sr=8000.0, max_block_size=512, window=name)
        assert config_to_dict(UpmixConfig.make(EDGES, **kw)) == jaot.config_to_dict(JaxUpmixConfig.make(EDGES, **kw))
    assert "custom_windows" not in config_to_dict(UpmixConfig.make(EDGES, sr=8000.0))


@pytest.mark.parametrize("overlap", [0.75, 0.65])
def test_offline_stems_as_jax(overlap):
    # overlap 0.75: the kernel path (its plain version here) takes the
    # window as an array of its plan; 0.65: the whole-file program.
    name = _both(_vector, "win_offline", VEC)
    kw = dict(sr=8000.0, max_block_size=512, window=name, overlap=overlap)
    cfg, jcfg = UpmixConfig.make(EDGES, **kw), JaxUpmixConfig.make(EDGES, **kw)
    L, R = _stereo32(5000, 8000.0, seed=31)
    up = Upmixer(cfg, device="cpu")
    got = up.process_np(L, R)
    assert up.kernel_path == (overlap == 0.75)
    want = jax_upmix_offline(L, R, jcfg)
    for r, w, g in zip(oracle_multiband(L, R, jcfg), want, got):
        assert snr_db(r, g) > 60.0
        assert snr_db(np.asarray(w), g) > 80.0


def test_sharded_stems_as_jax():
    name = _both(_callable, "win_sharded", np.hamming)
    kw = dict(sr=8000.0, max_block_size=512, window=name)
    cfg, jcfg = UpmixConfig.make(EDGES, **kw), JaxUpmixConfig.make(EDGES, **kw)
    L, R = _stereo32(6000, 8000.0, seed=32)
    got = ShardedUpmixer(cfg, make_mesh({"data": 2, "seq": 2}, devices=["cpu"] * 4)).process_np(L, R)
    want = JaxShardedUpmixer(jcfg, jax_make_mesh({"data": 2, "seq": 2})).process(L, R)
    for r, w, g in zip(oracle_multiband(L, R, jcfg), want, got):
        assert snr_db(r, g) > 60.0
        assert snr_db(np.asarray(w), g) > 80.0


def test_cpu_pool_as_jax():
    name = _both(_vector, "win_pool", VEC)
    hw, S = 256, 5
    cfg = UpmixConfig.streaming(EDGES, sr=8000.0, hw_block_size=hw, window=name)
    jcfg = JaxUpmixConfig.streaming(EDGES, sr=8000.0, hw_block_size=hw, window=name)
    pool, ref = make_stream_pool(cfg, hw, S, device="cpu"), JaxBatch(jcfg, hw, n_streams=S)
    rng = np.random.default_rng(33)
    for i in range(8):
        xl, xr = (rng.standard_normal((S, hw)).astype(np.float32) * 0.3 for _ in range(2))
        for o, (w, g) in enumerate(zip(ref.push_blocks(xl, xr), pool.push_blocks(xl, xr))):
            w, g = np.asarray(w), np.asarray(g.numpy() if isinstance(g, torch.Tensor) else g)
            if np.abs(w).max() == 0:
                assert np.abs(g).max() == 0.0, (i, o)
            else:
                assert snr_db(w, g) > 80.0, (i, o)


def _wav(tmp_path, n=3000, sr=8000, seed=34):
    L, R = make_stereo(n, sr, seed=seed)
    path = tmp_path / "clip.wav"
    write_wav(path, np.column_stack([L, R]) * 0.4, sr)
    return path


@pytest.mark.parametrize("suffix", [".npy", ".txt"])
def test_window_file_as_jax_cli(tmp_path, capsys, suffix):
    vec = np.kaiser(200, 5.0) + 0.01 * np.arange(200) / 200 + (suffix == ".txt")
    path = tmp_path / f"w{suffix}"
    np.save(path, vec) if suffix == ".npy" else np.savetxt(path, vec)
    name = cli.load_window_file(str(path))
    assert name == jax_load_window_file(str(path)) and name.startswith("file:")
    assert cli.load_window_file(str(path)) == name  # the same file reuses its registration
    np.testing.assert_array_equal(pwin.make_window(name, 512), jwin.make_window(name, 512))
    wav = _wav(tmp_path)
    args = [str(wav), "--band-edges", "0,400,1600", "--max-block-size", "512", "--export-mode", "split",
            "--window-file", str(path)]
    assert cli.main([*args, "--out-dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert jax_main([*args, "--out-dir", str(tmp_path / "j"), "--no-compile-cache"]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(got) == len(want) == 3
    for p, q in zip(got, want):
        y, r = read_wav(p)[0], read_wav(q)[0]
        for ch in range(2):
            assert snr_db(r[:, ch], y[:, ch]) >= 60.0


def test_unknown_window_is_a_clean_exit(tmp_path):
    wav = _wav(tmp_path)
    with pytest.raises(SystemExit) as exc:
        cli.main([str(wav), "--window", "win_typo", "--device", "cpu", "--out-dir", str(tmp_path)])
    msg = str(exc.value)
    assert msg.startswith("error: unknown --window 'win_typo'") and "\n" not in msg and "hann" in msg
    with pytest.raises(SystemExit, match="--window-file"):
        cli.main([str(wav), "--window-file", str(tmp_path / "missing.npy"), "--device", "cpu"])


def test_custom_window_reaches_the_kernel_plan():
    # The kernels take windows as arrays of their plans: the plan of a
    # custom-window config carries that window (the card's kernels read
    # these tensors, chip_smoke.py checks them on the card).
    name = _both(_vector, "win_plan", VEC)
    cfg = UpmixConfig.make(EDGES, sr=8000.0, max_block_size=512, window=name)
    up = Upmixer(cfg, device="cpu")
    up.process_np(np.zeros(1024, np.float32), np.zeros(1024, np.float32))
    assert up._buckets and all(
        np.array_equal(b.analysis_window.numpy(), pwin.make_window(name, b.block)) for b in up._buckets
    )
    assert omnibus.kernel_geometry(512, 128) and not omnibus.kernel_geometry(512, 179)
