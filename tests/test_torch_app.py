"""The port's app layer (`upmix_tpu_torch.app`, its WAV codec and
LatencyHistogram) against the JAX package's, on the CPU.

The same seeded WAV goes through `upmix_tpu.app` and through the port
with device="cpu" (the kernels' plain versions): the same file names in
every export mode, AB's right channel (the unprocessed L + R) identical,
the stems at 60 dB or better against the JAX output, the mono and
silent-file guards, `run_jobs` responses, `run_pipe`'s aligned length, and
the batch over a CPU mesh against the plain run.
"""

import io
import json
import os

import numpy as np
import pytest

import upmix_tpu.app as japp
import upmix_tpu.io as jio
import upmix_tpu_torch.app as tapp
import upmix_tpu_torch.io as tio
from upmix_tpu.config import UpmixConfig as JaxConfig
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.metrics import LatencyHistogram

from helpers import make_stereo, snr_db
from torch_helpers import native_engine

SR = 8000
EDGES = [0.0, 400.0, 1600.0]
OFFLINE = dict(band_edges=EDGES, max_block_size=512)
STREAM = dict(hw_block_size=256, band_edges=EDGES)


def _wav(tmp_path, name="song.wav", n=5000, seed=0, kind="mix", stereo=True, sr=SR):
    L, R = make_stereo(n, float(sr), seed=seed, kind=kind)
    data = np.column_stack([L, R]) * 0.5 if stereo else L * 0.5
    path = tmp_path / name
    jio.write_wav(path, data, sr)
    return path


def _read(path):
    return tio.read_wav(path)[0]


@pytest.mark.parametrize("subtype", ["FLOAT", "DOUBLE", "PCM_16", "PCM_24", "PCM_32"])
def test_wav_codec_is_the_jax_packages(tmp_path, subtype):
    x = np.random.default_rng(1).uniform(-0.9, 0.9, (300, 3))
    tio.write_wav(tmp_path / "t.wav", x, 22050, subtype=subtype)
    jio.write_wav(tmp_path / "j.wav", x, 22050, subtype=subtype)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = tio.read_wav(tmp_path / "j.wav")
    ref, sr_j = jio.read_wav(tmp_path / "j.wav")
    assert sr == sr_j == 22050
    np.testing.assert_array_equal(got, ref)


def test_load_guards(tmp_path):
    mono = _wav(tmp_path, "mono.wav", stereo=False)
    for a, b in zip(tapp.load_stereo(mono), japp.load_stereo(mono)):
        np.testing.assert_array_equal(a, b)
    l, r, _, _ = tapp.load_stereo(mono)
    np.testing.assert_array_equal(l, r)
    silent = tmp_path / "silent.wav"
    tio.write_wav(silent, np.zeros((1000, 2)), SR)
    assert tapp.load_stereo(silent)[3] == japp.load_stereo(silent)[3] == 1e-9


def test_scale_and_names():
    rng = np.random.default_rng(0)
    C, Ls, Rs = (rng.standard_normal(500).astype(np.float32) * s for s in (3.0, 2.0, 1.0))
    for a, b in zip(tapp.scale_lcr(C, Ls, Rs, 0.7), japp.scale_lcr(C, Ls, Rs, 0.7)):
        np.testing.assert_array_equal(a, b)
    cfg, jcfg = UpmixConfig.make(EDGES, sr=float(SR), max_block_size=512), JaxConfig.make(EDGES, sr=float(SR),
                                                                                           max_block_size=512)
    assert tapp.band_info_str(cfg) == japp.band_info_str(jcfg)
    assert tapp.EXPORT_MODES == japp.EXPORT_MODES


@pytest.mark.parametrize("mode", ["AB", "split", "stereo_sum"])
def test_run_offline_matches_jax(tmp_path, mode):
    path = _wav(tmp_path)
    got = tapp.run_offline(path, out_dir=tmp_path / "t", export_mode=mode, device="cpu", **OFFLINE)
    ref = japp.run_offline(path, out_dir=tmp_path / "j", export_mode=mode, **OFFLINE)
    assert [os.path.basename(p) for p in got.paths] == [os.path.basename(p) for p in ref.paths]
    assert (got.n_samples, got.sr) == (ref.n_samples, ref.sr) == (5000, SR)
    assert got.scale_factor == pytest.approx(ref.scale_factor, rel=1e-3)  # 60 dB on the peak
    for p, q in zip(got.paths, ref.paths):
        y, r = _read(p), _read(q)
        assert y.shape == r.shape
        for ch in range(2):
            if mode == "AB" and ch == 1:
                np.testing.assert_array_equal(y[:, 1], r[:, 1])  # L + R, unprocessed
            elif np.abs(r[:, ch]).max() > 0:
                assert snr_db(r[:, ch], y[:, ch]) >= 60.0
            else:
                assert not y[:, ch].any()  # split's silent channels


def test_run_offline_silence_and_mono(tmp_path):
    silent = _wav(tmp_path, "silent.wav", kind="silence")
    res = tapp.run_offline(silent, out_dir=tmp_path / "s", device="cpu", **OFFLINE)
    assert not _read(res.paths[0]).any()
    mono = _wav(tmp_path, "mono.wav", kind="mono")
    res = tapp.run_offline(mono, out_dir=tmp_path / "m", export_mode="split", device="cpu", **OFFLINE)
    ls, rs = _read(res.paths[0])[:, 0], _read(res.paths[2])[:, 1]
    assert max(np.abs(ls).max(), np.abs(rs).max()) <= 1e-5


def test_upmixer_cache_is_keyed(tmp_path):
    a = _wav(tmp_path, "a.wav")
    b = _wav(tmp_path, "b.wav", sr=16000)
    cache = {}
    tapp.run_offline(a, out_dir=tmp_path / "o", upmixer_cache=cache, device="cpu", **OFFLINE)
    tapp.run_offline(a, out_dir=tmp_path / "o", upmixer_cache=cache, device="cpu", **OFFLINE)
    assert len(cache) == 1
    tapp.run_offline(b, out_dir=tmp_path / "o", upmixer_cache=cache, device="cpu", **OFFLINE)
    tapp.run_offline(a, out_dir=tmp_path / "o", upmixer_cache=cache, device="cpu", chunk=0, **OFFLINE)
    assert len(cache) == 3
    keys = list(cache)
    assert {k[0].sr for k in keys} == {8000.0, 16000.0} and {k[-1] for k in keys} == {"cpu"}


def test_run_offline_batch_on_a_cpu_mesh(tmp_path):
    from upmix_tpu_torch.parallel import make_mesh

    paths = [_wav(tmp_path, f"{i}.wav", n=n, seed=i) for i, n in enumerate((4000, 2900, 3500))]
    mesh = make_mesh({"data": 2, "seq": 2}, devices=["cpu"] * 4)
    results = tapp.run_offline_batch(paths, mesh, out_dir=tmp_path / "b", **OFFLINE)
    for p, res in zip(paths, results):
        solo = tapp.run_offline(p, out_dir=tmp_path / "solo", device="cpu", **OFFLINE)
        assert os.path.basename(res.paths[0]) == os.path.basename(solo.paths[0])
        y, r = _read(res.paths[0]), _read(solo.paths[0])
        assert y.shape == r.shape
        for ch in range(2):
            assert snr_db(r[:, ch], y[:, ch]) > 60.0


@pytest.mark.parametrize("mode", ["stereo_sum", "split"])
def test_run_streaming_matches_jax(tmp_path, mode):
    path = _wav(tmp_path, n=8 * 256)
    got = tapp.run_streaming(path, out_dir=tmp_path / "t", export_mode=mode, device="cpu", **STREAM)
    ref = japp.run_streaming(path, out_dir=tmp_path / "j", export_mode=mode, **STREAM)
    assert [os.path.basename(p) for p in got.paths] == [os.path.basename(p) for p in ref.paths]
    assert got.n_samples == ref.n_samples == 8 * 256
    for p, q in zip(got.paths, ref.paths):
        y, r = _read(p), _read(q)
        for ch in range(2):
            if np.abs(r[:, ch]).max() > 0:
                assert snr_db(r[:, ch], y[:, ch]) >= 60.0
            else:
                assert not y[:, ch].any()
    assert np.abs(_read(got.paths[0])[4 * 256 :]).max() > 0
    with pytest.raises(ValueError, match="stereo_sum"):
        tapp.run_streaming(path, out_dir=tmp_path / "x", export_mode="AB", device="cpu", **STREAM)


def test_native_engine_is_not_ported(tmp_path):
    # The native engine runs (the C++ host shell, on the CPU), within the
    # JAX package's native-vs-XLA bar of the torch engine.  The unknown
    # engine comes first: the native half skips where the library cannot
    # be built.
    path = _wav(tmp_path, n=8 * 256)
    with pytest.raises(ValueError, match="unknown engine"):
        tapp.run_streaming(path, out_dir=tmp_path, engine="jax", device="cpu", **STREAM)
    native_engine()
    got = tapp.run_streaming(path, out_dir=tmp_path / "n", engine="native", device="cpu", **STREAM)
    ref = tapp.run_streaming(path, out_dir=tmp_path / "t", device="cpu", **STREAM)
    y, r = _read(got.paths[0]), _read(ref.paths[0])
    assert y.shape == r.shape and np.abs(r[4 * 256 :]).max() > 0
    assert np.abs(y - r).max() < 1e-3


@pytest.mark.parametrize("mix", ["stereo_sum", "lcr"])
def test_run_pipe_aligned_matches_jax(mix):
    n = 6 * 256 + 100  # a partial final block
    L, R = make_stereo(n, float(SR), seed=13)
    raw = np.column_stack([L, R]).astype("<f4").tobytes()
    outs = []
    for run, kw in ((tapp.run_pipe, {"device": "cpu"}), (japp.run_pipe, {})):
        sink = io.BytesIO()
        emitted = run(io.BytesIO(raw), sink, sr=SR, mix=mix, **STREAM, **kw)
        assert emitted == n
        outs.append(np.frombuffer(sink.getvalue(), dtype="<f4").reshape(n, -1))
    got, ref = outs
    assert got.shape == ref.shape == (n, 2 if mix == "stereo_sum" else 3)
    for ch in range(got.shape[1]):
        assert snr_db(ref[:, ch], got[:, ch]) >= 60.0


def test_run_pipe_raw_is_the_real_time_stream():
    from upmix_tpu_torch.models.streaming import StreamingUpmixer

    n = 5 * 256
    L, R = (a.astype(np.float32) for a in make_stereo(n, float(SR), seed=14))
    sink = io.BytesIO()
    assert tapp.run_pipe(io.BytesIO(np.column_stack([L, R]).astype("<f4").tobytes()), sink, sr=SR,
                         align=False, device="cpu", **STREAM) == n
    out = np.frombuffer(sink.getvalue(), dtype="<f4").reshape(-1, 2)
    cfg = UpmixConfig.streaming(EDGES, sr=float(SR), hw_block_size=256)
    ref = StreamingUpmixer(cfg, 256, device="cpu").process_signal(L, R, mix="stereo_sum")
    np.testing.assert_allclose(out[:, 0], ref[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(out[:, 1], ref[1].numpy(), atol=1e-6)


def test_run_jobs_matches_jax(tmp_path):
    a = _wav(tmp_path, "a.wav", n=4096, seed=1)
    b = _wav(tmp_path, "b.wav", n=4096, seed=2)
    jobs = "\n".join([
        json.dumps({"cmd": "ping"}),
        json.dumps({"cmd": "stats"}),
        json.dumps({"in": str(a), "out_dir": "o1"}),
        json.dumps({"in": str(tmp_path / "missing.wav")}),  # fails; the server goes on
        json.dumps({"in": str(b), "out_dir": "o2", "export_mode": "split"}),
        json.dumps({"in": str(a), "bogus_field": 1}),
        "",
        "not json",
        json.dumps({"cmd": "stats"}),
    ])
    resps = {}
    for name, run, kw in (("t", tapp.run_jobs, {"device": "cpu"}), ("j", japp.run_jobs, {})):
        jobs_here = jobs.replace('"o1"', json.dumps(str(tmp_path / name / "o1"))).replace(
            '"o2"', json.dumps(str(tmp_path / name / "o2")))
        dst = io.StringIO()
        assert run(io.StringIO(jobs_here), dst, out_dir=str(tmp_path / name), **OFFLINE, **kw) == (2, 3)
        resps[name] = [json.loads(line) for line in dst.getvalue().splitlines()]
    got, ref = resps["t"], resps["j"]
    assert len(got) == len(ref) == 8
    assert got[0] == ref[0] == {"ok": True, "pong": True}
    for g, r in zip(got, ref):
        assert g["ok"] == r["ok"] and set(g) == set(r)
        if "outputs" in g:
            assert [os.path.basename(p) for p in g["outputs"]] == [os.path.basename(p) for p in r["outputs"]]
            assert g["audio_seconds"] == r["audio_seconds"]
        if not g["ok"]:
            assert g["error"].split(":")[0] == r["error"].split(":")[0]
    assert got[-1]["n_ok"] == 2 and got[-1]["n_failed"] == 3 and got[-1]["job_seconds"]["count"] == 2
    assert got[-1]["configs_cached"] == 1 and got[-1]["programs_cached"] == 1


def test_latency_histogram_is_the_jax_packages():
    from upmix_tpu.metrics import LatencyHistogram as JaxHistogram

    got, ref = LatencyHistogram(), JaxHistogram()
    for s in (0.0001, 0.003, 0.02, 0.02, 1.5, 200.0):
        got.record(s)
        ref.record(s)
    assert got.snapshot() == ref.snapshot()
    assert got.quantile(0.5) == ref.quantile(0.5)
