"""The port's tuner (upmix_tpu_torch/tune.py) on the CPU, with tiny sweeps:
the counterparts of tests/test_tune.py's cases.  Every feasible candidate
is measured with the interleaved min-of-visits protocol, infeasible ones
are recorded with their error, and `best` is the capacity-best feasible
one.  The JAX tuner's group and layout knobs have no counterpart (the
card's pool has neither); the OLA dataflow is swept instead.  The
protocol is the same on the card, where the clock is CUDA events."""

import json

import pytest

from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.tune import tune_pool as jax_tune_pool
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.tune import main, tune_offline, tune_pool

HW = 256
SR = 8000.0
EDGES = [0.0, 400.0, 1600.0]
CPU = dict(device="cpu", verbose=False)
OFFLINE = dict(sr=8000.0, band_edges=(0.0, 400.0, 1600.0), max_block_size=512, n_samples=4096, **CPU)


def _cfg():
    return UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)


def _ok(report):
    return [r for r in report["results"] if r["ok"]]


def test_tune_torch_sweep_picks_best():
    report = tune_pool(_cfg(), HW, batch_sizes=(2, 4), engine="torch", blocks=2, visits=2, **CPU)
    ok = _ok(report)
    assert len(ok) == 2  # one batch-pool candidate per batch size
    best = report["best"]
    assert best is not None and best in report["results"]
    for r in ok:
        assert r["seconds_per_block"] > 0
        assert r["streams_per_chip"] == pytest.approx(r["batch"] * (HW / SR) / r["seconds_per_block"])
        assert r["us_per_block_stream"] == pytest.approx(r["seconds_per_block"] / r["batch"] * 1e6)
    assert best["streams_per_chip"] == max(r["streams_per_chip"] for r in ok)
    assert report["protocol"]["estimator"].startswith("min-of-visits")
    assert report["protocol"]["transport_floor_seconds"] > 0


def test_report_keys_are_the_jax_tuners():
    jax_report = jax_tune_pool(JaxUpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW), HW, batch_sizes=(2,),
                               groups=(2,), engine="xla", blocks=1, visits=1, verbose=False)
    report = tune_pool(_cfg(), HW, batch_sizes=(2,), engine="torch", blocks=1, visits=1, **CPU)
    assert set(report) == set(jax_report)
    assert set(jax_report["results"][0]) - {"group"} <= set(report["results"][0])
    assert set(jax_report["protocol"]) - {"unroll", "layout"} <= set(report["protocol"])


def test_tune_records_failures_without_raising():
    report = tune_pool(_cfg(), HW, batch_sizes=(2,), engine="bogus", blocks=1, visits=1, **CPU)
    assert report["best"] is None
    (rec,) = report["results"]
    assert rec["ok"] is False and "ValueError" in rec["error"]
    # A config the pool plan refuses (hop 100 does not divide its block).
    report = tune_pool(_cfg(), 100, batch_sizes=(2,), engine="cuda", blocks=1, visits=1, **CPU)
    assert report["best"] is None and "ValueError" in report["results"][0]["error"]


def test_tune_cuda_candidate_on_cpu():
    # The CUDA pool on the CPU runs its plain version: one tiny candidate
    # proves the cuda arm of the sweep end to end.
    report = tune_pool(_cfg(), HW, batch_sizes=(3,), engine="cuda", blocks=1, visits=1, **CPU)
    best = report["best"]
    assert best is not None and best["engine"] == "cuda" and best["batch"] == 3 and best["ola"] == "time"


def test_tune_ola_sweep():
    report = tune_pool(_cfg(), HW, batch_sizes=(2,), engine="cuda", ola=("time", "spectral"), blocks=2, visits=1,
                       **CPU)
    ok = _ok(report)
    assert {r["ola"] for r in ok} == {"time", "spectral"}
    assert [r["label"] for r in ok] == ["cuda/B2/time", "cuda/B2/spectral"]
    assert report["protocol"]["ola"] == ["time", "spectral"]


def test_tune_cli_json(capsys):
    rc = main(["--sr", str(SR), "--hw-block", str(HW), "--edges", "0,400,1600", "--batches", "2", "--engine", "torch",
               "--blocks", "1", "--visits", "1", "--device", "cpu", "--json"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["best"]["batch"] == 2


def test_tune_torch_one_candidate_per_batch():
    # The batch pool has no OLA mode: engine "torch" with two modes must
    # not time the same pool twice under two labels.
    report = tune_pool(_cfg(), HW, batch_sizes=(2,), engine="torch", ola=("time", "spectral"), blocks=1, visits=1,
                       **CPU)
    (rec,) = report["results"]
    assert rec["ok"] and rec["ola"] is None and rec["label"] == "torch/B2"


def test_tune_auto_dedupes_oleless_resolution():
    # engine "auto" on the CPU resolves to the batch pool, which ignores
    # ola: the first mode per batch is timed, the other recorded as a
    # duplicate.
    report = tune_pool(_cfg(), HW, batch_sizes=(2,), engine="auto", ola=("time", "spectral"), blocks=1, visits=1,
                       **CPU)
    ok = _ok(report)
    dup = [r for r in report["results"] if r["error"] and "duplicate" in r["error"]]
    assert len(ok) == 1 and len(dup) == 1 and ok[0]["ola"] is None


def test_tune_cli_json_exit_code_on_total_failure(capsys):
    # hw 100: no candidate builds; the scripted (--json) run exits 1 too.
    rc = main(["--sr", str(SR), "--hw-block", "100", "--edges", "0,400,1600", "--batches", "4", "--engine", "cuda",
               "--blocks", "1", "--visits", "1", "--device", "cpu", "--json"])
    assert rc == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["best"] is None


def test_tune_scan_protocol_torch():
    report = tune_pool(_cfg(), HW, batch_sizes=(2, 4), engine="torch", blocks=4, visits=2, protocol="scan", **CPU)
    ok = _ok(report)
    assert len(ok) == 2 and report["best"] is not None
    assert report["protocol"]["name"] == "scan"
    assert all(r["seconds_per_block"] > 0 for r in ok)


def test_tune_scan_protocol_cuda():
    report = tune_pool(_cfg(), HW, batch_sizes=(4,), engine="cuda", blocks=2, visits=1, protocol="scan", **CPU)
    best = report["best"]
    assert best is not None and best["engine"] == "cuda"


def test_tune_rejects_unknown_protocol():
    with pytest.raises(ValueError):
        tune_pool(_cfg(), HW, protocol="bogus", **CPU)


def test_tune_hops_sweep_scan_cuda():
    report = tune_pool(_cfg(), HW, batch_sizes=(4,), engine="cuda", blocks=2, visits=1, protocol="scan", hops=(1, 2),
                       **CPU)
    ok = _ok(report)
    assert {r["hops"] for r in ok} == {1, 2}
    (t2,) = [r for r in ok if r["hops"] == 2]
    assert t2["label"].endswith("/T2")
    assert report["protocol"]["hops"] == [1, 2] and report["best"] is not None


def test_tune_hops_dispatch_uses_push_blocks_multi():
    report = tune_pool(_cfg(), HW, batch_sizes=(4,), engine="cuda", ola="spectral", blocks=2, visits=1,
                       protocol="dispatch", hops=(2,), **CPU)
    (rec,) = report["results"]
    assert rec["ok"] and rec["hops"] == 2 and rec["label"] == "cuda/B4/spectral/T2"
    assert rec["seconds_per_block"] > 0


def test_tune_hops_infeasible_on_torch_resolution():
    # "auto" resolves to the batch pool on the CPU, which has no multi-hop
    # step: recorded as infeasible, neither raised nor dropped.
    report = tune_pool(_cfg(), HW, batch_sizes=(2,), engine="auto", blocks=2, visits=1, hops=(2,), **CPU)
    assert report["best"] is None
    (rec,) = report["results"]
    assert rec["ok"] is False and "multi-hop" in rec["error"]


def test_tune_hops_must_divide_blocks():
    report = tune_pool(_cfg(), HW, batch_sizes=(4,), engine="cuda", blocks=3, visits=1, hops=(2,), **CPU)
    assert report["results"] == [] and report["best"] is None


def test_tune_lockstep_protocol_torch():
    report = tune_pool(_cfg(), HW, batch_sizes=(2, 4), engine="torch", blocks=2, visits=2, protocol="lockstep", **CPU)
    ok = _ok(report)
    assert len(ok) == 2 and report["protocol"]["name"] == "lockstep" and report["best"] is not None
    assert all(r["seconds_per_block"] > 0 for r in ok)


def test_tune_lockstep_hops_cuda():
    report = tune_pool(_cfg(), HW, batch_sizes=(4,), engine="cuda", blocks=2, visits=1, protocol="lockstep",
                       hops=(1, 2), **CPU)
    ok = _ok(report)
    assert {r["hops"] for r in ok} == {1, 2}
    (t2,) = [r for r in ok if r["hops"] == 2]
    assert t2["label"].endswith("/T2")


def test_tune_lockstep_pipeline_sweep_shares_pool():
    report = tune_pool(_cfg(), HW, batch_sizes=(4,), engine="torch", blocks=4, visits=2, protocol="lockstep",
                       pipelines=(1, 2), **CPU)
    ok = _ok(report)
    assert {r["pipeline"] for r in ok} == {1, 2}
    (p2,) = [r for r in ok if r["pipeline"] == 2]
    assert p2["label"].endswith("/P2") and report["protocol"]["pipelines"] == [1, 2]
    assert all(r["seconds_per_block"] > 0 for r in ok)


def test_tune_pipeline_rejected_off_lockstep():
    with pytest.raises(ValueError, match="lockstep"):
        tune_pool(_cfg(), HW, batch_sizes=(4,), engine="torch", protocol="dispatch", pipelines=(1, 2), **CPU)
    with pytest.raises(ValueError, match="1 or 2"):
        tune_pool(_cfg(), HW, batch_sizes=(4,), engine="torch", protocol="lockstep", pipelines=(3,), **CPU)


def test_tune_rejects_bad_hops_values():
    for bad in ((0,), (-2,), ()):
        with pytest.raises(ValueError, match="hops"):
            tune_pool(_cfg(), HW, batch_sizes=(8,), engine="cuda", blocks=4, visits=1, hops=bad, **CPU)


def test_tune_offline_sweep():
    report = tune_offline(chunks=(2048, 4096, 0), inner=2, visits=2, **OFFLINE)
    ok = _ok(report)
    assert len(ok) == 3  # all feasible at this tiny geometry
    best = report["best"]
    assert best is not None and best in report["results"]
    for r in ok:
        assert r["seconds_per_application"] > 0
        assert r["realtime_factor"] == pytest.approx((4096 / 8000.0) / r["seconds_per_application"])
    assert best["realtime_factor"] == max(r["realtime_factor"] for r in ok)
    assert report["protocol"]["name"] == "offline" and report["protocol"]["chunk_active"]


def test_tune_offline_chunk_rounds_to_frame_grid():
    # A chunk below the frame-grid unit is rounded up by build_offline_rows_fn, not rejected.
    report = tune_offline(chunks=(7, 4096), inner=1, visits=1, **OFFLINE)
    assert all(r["ok"] for r in report["results"])


def test_tune_offline_records_infeasible():
    report = tune_offline(chunks=(-1,), inner=1, visits=1, **OFFLINE)
    (bad,) = report["results"]
    assert not bad["ok"] and "ValueError" in bad["error"] and report["best"] is None


def test_tune_offline_cli_json(capsys):
    rc = main(["--offline", "--sr", "8000", "--edges", "0,400,1600", "--max-block-size", "512", "--samples", "4096",
               "--chunks", "4096", "--inner", "1", "--visits", "1", "--device", "cpu", "--json"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["best"]["ok"]


def test_tune_offline_inactive_chunking_dedupes():
    # Overlap 0.65: the geometry routes the config to the whole-file
    # program, so every chunk is that program; one builds, the rest are
    # recorded as duplicates.
    cfg = UpmixConfig.make(EDGES, sr=8000.0, max_block_size=512, overlap=0.65)
    report = tune_offline(cfg, chunks=(2048, 4096), inner=1, visits=1, n_samples=4096, **CPU)
    ok = _ok(report)
    dup = [r for r in report["results"] if r.get("error") and "identical program" in r["error"]]
    assert len(ok) == 1 and len(dup) == 1 and report["protocol"]["chunk_active"] is False


def test_tune_offline_clamped_chunks_deduped():
    report = tune_offline(chunks=(2048, 4096, 8192), inner=1, visits=1, **OFFLINE)
    ok = _ok(report)
    dup = [r for r in report["results"] if r.get("error") and "duplicate" in r["error"]]
    assert len(ok) == 2 and len(dup) == 1 and dup[0]["chunk"] == 8192


def test_tune_offline_clamped_label_set_after_the_build(monkeypatch):
    # The JAX tuner names a clamped candidate the representative before it
    # builds (upmix_tpu/tune.py:564), so a failed build hides the next
    # clamped chunk.  Here the first clamped chunk that builds is the one.
    from upmix_tpu_torch.models import offline

    real = offline.Upmixer

    def failing(config, device="cuda", chunk=None, **kw):
        if chunk == 4096:
            raise RuntimeError("no room")
        return real(config, device=device, chunk=chunk, **kw)

    monkeypatch.setattr(offline, "Upmixer", failing)
    report = tune_offline(chunks=(4096, 8192, 16384), inner=1, visits=1, **OFFLINE)
    first, second, third = report["results"]
    assert not first["ok"] and "no room" in first["error"]
    assert second["ok"]
    assert "duplicate of chunk=8192" in third["error"]
