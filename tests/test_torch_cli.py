"""The port's CLI (`upmix_tpu_torch.cli`, in process, --device cpu)
against the JAX package's CLI on the same seeded WAV: the same file names
and layouts in every export mode, AB's right channel identical, the stems
at 60 dB or better; --mesh on a CPU mesh against the plain run (the
pattern of tests/test_cli.py); --streaming (and --engine native), --pipe
and --serve; and the one-line errors of the --save-aot flags.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from upmix_tpu.cli import main as jax_main
from upmix_tpu.cli import parse_edges as jax_parse_edges
from upmix_tpu.cli import parse_mesh_spec as jax_parse_mesh_spec
from upmix_tpu_torch.cli import main, parse_edges, parse_mesh_spec
from upmix_tpu_torch.io import read_wav, write_wav

from helpers import cpu_child_env, make_stereo, snr_db
from torch_helpers import native_engine

ROOT = Path(__file__).resolve().parent.parent
COMMON = ["--band-edges", "0,400,1600", "--max-block-size", "512"]
CPU = ["--device", "cpu"]


def _input(tmp_path, name="clip.wav", n=3000, sr=8000, seed=0):
    L, R = make_stereo(n, sr, seed=seed)
    path = tmp_path / name
    write_wav(path, np.column_stack([L, R]) * 0.4, sr)
    return path


def _printed(capsys):
    return [ln for ln in capsys.readouterr().out.strip().splitlines() if ln]


def _same_audio(got_paths, ref_paths, ab=False):
    assert [os.path.basename(p) for p in got_paths] == [os.path.basename(p) for p in ref_paths]
    for p, q in zip(got_paths, ref_paths):
        y, sr = read_wav(p)
        r, sr_r = read_wav(q)
        assert sr == sr_r and y.shape == r.shape
        for ch in range(y.shape[1]):
            if ab and ch == 1:
                np.testing.assert_array_equal(y[:, 1], r[:, 1])
            elif np.abs(r[:, ch]).max() > 0:
                assert snr_db(r[:, ch], y[:, ch]) >= 60.0
            else:
                assert not y[:, ch].any()


def test_parsers_match_jax():
    for text in ("0,30,120", "0, 400,1600,", "5"):
        assert parse_edges(text) == jax_parse_edges(text)
    for text in ("seq=4", "data=2,seq=2", "data=3"):
        assert parse_mesh_spec(text) == jax_parse_mesh_spec(text)
    for bad in ("0,abc", "120,30", "", "-1,3"):
        with pytest.raises(SystemExit):
            parse_edges(bad)
    for bad in ("seq=abc", "seq=0", "seq", "", "seq=2,seq=2"):
        with pytest.raises(SystemExit):
            parse_mesh_spec(bad)


@pytest.mark.parametrize("mode", ["stereo_sum", "AB", "split"])
def test_offline_matches_jax_cli(tmp_path, capsys, mode):
    a = _input(tmp_path, "a.wav", seed=1)
    b = _input(tmp_path, "b.wav", n=2500, seed=2)
    args = [str(a), str(b), "--export-mode", mode, *COMMON]
    assert main([*args, "--out-dir", str(tmp_path / "t"), "--no-compile-cache", *CPU]) == 0
    got = _printed(capsys)
    assert jax_main([*args, "--out-dir", str(tmp_path / "j"), "--no-compile-cache"]) == 0
    ref = _printed(capsys)
    assert len(got) == len(ref) == (6 if mode == "split" else 2)
    _same_audio(got, ref, ab=mode == "AB")


def test_mesh_offline_parity(tmp_path, capsys):
    path = _input(tmp_path, n=5000)
    assert main([str(path), "--out-dir", str(tmp_path / "a"), *COMMON, *CPU]) == 0
    ref_path = _printed(capsys)[-1]
    assert main([str(path), "--out-dir", str(tmp_path / "b"), "--mesh", "seq=4", *COMMON, *CPU]) == 0
    got_path = _printed(capsys)[-1]
    ref, _ = read_wav(ref_path)
    got, _ = read_wav(got_path)
    assert ref.shape == got.shape
    for ch in range(2):
        assert snr_db(ref[:, ch], got[:, ch]) > 60.0


def test_mesh_dp_sp_batch(tmp_path, capsys):
    # Many files on a data 2 x seq 2 mesh of the CPU: one sharded call per
    # sample rate, ragged lengths padded and trimmed; each file as its solo run.
    files = [_input(tmp_path, f"{c}.wav", n=n) for c, n in zip("abc", (4000, 2900, 3500))]
    solo = {}
    for p in files:
        assert main([str(p), "--out-dir", str(tmp_path / "solo"), *COMMON, *CPU]) == 0
        solo[p] = read_wav(_printed(capsys)[-1])[0]
    assert main([*map(str, files), "--out-dir", str(tmp_path / "out"), "--mesh", "data=2,seq=2", "--meter",
                 *COMMON, *CPU]) == 0
    printed = _printed(capsys)
    assert printed[0].startswith("[batch x3]") and len(printed) == 4
    for p, line in zip(files, printed[1:]):
        y, sr = read_wav(line)
        assert sr == 8000 and y.shape == solo[p].shape
        for ch in range(2):
            assert snr_db(solo[p][:, ch], y[:, ch]) > 60.0


def test_mesh_validation(tmp_path):
    path = _input(tmp_path)
    for spec in ("seq=abc", "seq=0", "model=2"):
        with pytest.raises(SystemExit):
            main([str(path), "--mesh", spec, *CPU])
    with pytest.raises(SystemExit, match="offline"):
        main([str(path), "--mesh", "seq=2", "--streaming", *CPU])
    with pytest.raises(SystemExit, match="chunk"):
        main([str(path), "--chunk", "2048", "--mesh", "seq=2", *CPU])
    with pytest.raises(SystemExit, match="chunk"):
        main([str(path), "--chunk", "-1", *CPU])
    with pytest.raises(SystemExit, match="pad-granularity"):
        main([str(path), "--pad-granularity", "0", *CPU])


def test_chunk_and_meter(tmp_path, capsys):
    path = _input(tmp_path, n=5000)
    outs = {}
    for name, extra in (("default", []), ("chunk2048", ["--chunk", "2048"]), ("whole", ["--chunk", "0"])):
        assert main([str(path), "--out-dir", str(tmp_path / name), "--meter", *COMMON, *CPU, *extra]) == 0
        printed = _printed(capsys)
        assert "x realtime" in printed[0]
        outs[name] = read_wav(printed[-1])[0]
    for name in ("chunk2048", "whole"):
        for ch in range(2):
            assert snr_db(outs["default"][:, ch], outs[name][:, ch]) > 60.0


@pytest.mark.parametrize("mode", ["stereo_sum", "split"])
def test_streaming_matches_jax_cli(tmp_path, capsys, mode):
    path = _input(tmp_path, n=8 * 256)
    args = [str(path), "--streaming", "--hw-block", "256", "--band-edges", "0,400,1600", "--export-mode", mode]
    assert main([*args, "--out-dir", str(tmp_path / "t"), *CPU]) == 0
    got = _printed(capsys)
    assert jax_main([*args, "--out-dir", str(tmp_path / "j"), "--no-compile-cache"]) == 0
    _same_audio(got, _printed(capsys))
    with pytest.raises(SystemExit, match="AB"):
        main([str(path), "--streaming", "--export-mode", "AB", *CPU])


def test_pipe_subprocess_keeps_the_length(tmp_path):
    sr, hw = 8000, 256
    n = 6 * hw + 100
    L, R = make_stereo(n, float(sr), seed=13)
    raw = np.column_stack([L, R]).astype("<f4").tobytes()
    cmd = ["--pipe", "--sr", str(sr), "--hw-block", str(hw), "--band-edges", "0,400,1600"]
    got = subprocess.run([sys.executable, "-m", "upmix_tpu_torch.cli", "-", *cmd, *CPU], input=raw,
                         capture_output=True, env=cpu_child_env(), cwd=ROOT, timeout=300)
    assert got.returncode == 0, got.stderr.decode()[-500:]
    out = np.frombuffer(got.stdout, dtype="<f4").reshape(-1, 2)
    assert out.shape[0] == n
    from upmix_tpu.app import run_pipe

    sink = io.BytesIO()
    run_pipe(io.BytesIO(raw), sink, sr=sr, hw_block_size=hw, band_edges=[0, 400, 1600])
    ref = np.frombuffer(sink.getvalue(), dtype="<f4").reshape(-1, 2)
    for ch in range(2):
        assert snr_db(ref[:, ch], out[:, ch]) >= 60.0
    for bad, match in ((["-", "--pipe", *CPU], "--sr"), (["x.wav", "--pipe", "--sr", "8000", *CPU], "stdin")):
        with pytest.raises(SystemExit, match=match):
            main(bad)


def test_serve(tmp_path, capsys, monkeypatch):
    a = _input(tmp_path, "a.wav", n=4096)
    jobs = "\n".join([json.dumps({"cmd": "ping"}), json.dumps({"in": str(a)}),
                      json.dumps({"in": str(tmp_path / "missing.wav")}), json.dumps({"cmd": "stats"})])
    monkeypatch.setattr(sys, "stdin", io.StringIO(jobs + "\n"))
    assert main(["-", "--serve", "--out-dir", str(tmp_path / "o"), *COMMON, *CPU]) == 0
    resps = [json.loads(line) for line in _printed(capsys)]
    assert resps[0] == {"ok": True, "pong": True}
    assert resps[1]["ok"] and len(resps[1]["outputs"]) == 1 and os.path.exists(resps[1]["outputs"][0])
    assert not resps[2]["ok"] and "missing" in resps[2]["error"]
    assert resps[3]["n_ok"] == 1 and resps[3]["n_failed"] == 1
    monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps({"in": "nope.wav"}) + "\n"))
    assert main(["-", "--serve", *CPU]) == 1  # every job failed
    with pytest.raises(SystemExit, match="stdin"):
        main([str(a), "--serve", *CPU])


# The --save-aot flags' errors, with the JAX CLI's checks and messages.
AOT_ERRORS = {
    "stream_and_pool": (["--aot-stream", "--aot-pool", "8"], "--aot-stream and --aot-pool are exclusive"),
    "hops_without_pool": (["--aot-hops", "4"], "--aot-hops requires --aot-pool"),
    "tpu_platform": (["--aot-platforms", "tpu"], "platform 'tpu'"),
    "no_sr": (["--sr", "0"], "--save-aot requires a positive --sr"),
}


@pytest.mark.parametrize("case", sorted(AOT_ERRORS))
def test_unported_flags_exit_cleanly(case, tmp_path, capsys):
    extra, want = AOT_ERRORS[case]
    with pytest.raises(SystemExit) as exc:
        main(["-", "--save-aot", str(tmp_path / "x.upmixaot"), "--sr", "8000", *extra])
    msg = str(exc.value)
    assert msg.startswith("error: ") and want in msg and "\n" not in msg
    assert not (tmp_path / "x.upmixaot").exists()


def test_other_clean_errors(tmp_path):
    path = _input(tmp_path)
    with pytest.raises(SystemExit, match="unknown --window"):
        main([str(path), "--window", "blackman_haris", *CPU])
    with pytest.raises(SystemExit):
        main([str(path), "--export-mode", "quad", *CPU])
    with pytest.raises(FileNotFoundError):
        main([str(tmp_path / "nope.wav"), "--out-dir", str(tmp_path), *CPU])
    # Last, since it skips where the native library cannot be built.
    native_engine()
    assert main([str(path), "--streaming", "--engine", "native", "--out-dir", str(tmp_path / "n"), *CPU]) == 0
    assert len(os.listdir(tmp_path / "n")) == 1
