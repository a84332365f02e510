"""The `pool_8192_spectral` cell on the CPU: its configuration holds the
Bela setup's numbers and names the OLA its traffic runs, its tiny dry run is correct
at both trace settings, its control fails the limit, the pool's faults
(streams left out, state unchanged, one sample altered) fail it, and its
two readers, `edge_ms.spectral` and `edge_launches.spectral`, read a
trace and spans made by hand."""

import json
from types import SimpleNamespace

import pytest

import tiny
import upmix_tpu_torch.models.streaming as streaming
from benchmark import run
from benchmark.trace import Row, Trace
from benchmark.window import Call, Window
from test_bench_dry import check_dry
from test_bench_faults import broken_step
from test_bench_spans import BLOCKS, CALLS, HOST_START, span
from upmix_tpu_torch.utils import tracing

CELL = "pool_8192_spectral"


def test_configuration_is_the_bela_setup_on_the_spectral_ola():
    # Nothing cut: every number of the Bela setup under the same key; the
    # OLA the configuration names is the one its cells' traffic runs.
    configs = {c["name"]: c for c in tiny.spec()["configs"]}
    bela, spectral = (json.loads((tiny.ROOT / configs[n]["file"]).read_text())
                      for n in ("stream_48k_4band_bela", tiny.cell(CELL)["config"]))
    assert configs[tiny.cell(CELL)["config"]]["reduced"] == []
    for key in ("constructor", "band_edges", "sr", "hw_block_size", "window", "xover_mode", "threshold_factor",
                "xo_fraction", "synthesis", "bin_rounding"):
        assert spectral[key] == bela[key], key
    runs = [w["name"] for w in tiny.spec()["workloads"] if w["config"] == tiny.cell(CELL)["config"]]
    assert CELL in runs and {tiny.traffic(w)["ola"] for w in runs} == {spectral["ola"]} == {"spectral"}
    assert configs[tiny.cell(CELL)["config"]]["source"] != configs["stream_48k_4band_bela"]["source"]


def test_tiny_size_is_the_drivers_default():
    assert (tiny.patch(CELL), tiny.devices(CELL)) == ({"streams": 8, "check": {"reservoir": 3, "streams": 4}},
                                                      ["cpu"])
    assert tiny.traffic(CELL)["ola"] == "spectral"


@pytest.mark.parametrize("trace", [0, 1])
def test_runs_dry_on_the_spectral_pool(monkeypatch, trace):
    from benchmark.drivers import pool

    olas, release = [], pool.Session.release

    def spy(self):
        olas.append(self.pool.ola)
        release(self)

    monkeypatch.setattr(pool.Session, "release", spy)
    r = tiny.result(CELL, trace=trace)
    check_dry(r, trace)
    assert olas == ["spectral"]
    if trace:  # the CPU's plain versions launch nothing
        assert r["metrics"]["launches.pool"]["value"] == 0 and r["metrics"]["edge_launches.spectral"]["value"] == 0
        assert "edge_ms.spectral" not in r["metrics"]  # no device rows


def test_control_fails_the_limit():
    line = tiny.control(CELL)
    assert line["program"]["max_err"] <= tiny.traffic(CELL)["check"]["limits"]["max_err"] < line["control"]["max_err"]


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged", "token_altered"])
def test_pool_faults_fail(monkeypatch, fault):
    monkeypatch.setattr(streaming, "_batch_step", broken_step(fault))
    r = tiny.result(CELL)
    assert r["correct"] is False, r["checks"]


def _ctx(rows=(), records=()):
    window = Window(HOST_START - 0.1, HOST_START + 1e-3, [Call(s, e, 1.0) for s, e in CALLS])
    trace = Trace(sorted(rows, key=lambda r: r.start), [("bench.window", 1000, 2000), *BLOCKS], (1000, 2000), [0])
    return SimpleNamespace(window=window, trace=trace, session=None)


EDGE_ROWS = [Row(0, "(anonymous namespace)::spectral_edge_gather_kernel((anonymous namespace)::EdgeArgs)", 1100,
                 1130, "kernel"),
             Row(0, "(anonymous namespace)::spectral_edge_kernel((anonymous namespace)::EdgeArgs)", 1130, 1250,
                 "kernel"),
             Row(0, "(anonymous namespace)::spectral_edge_gather_kernel((anonymous namespace)::EdgeArgs)", 1500,
                 1540, "kernel")]
OTHER_ROWS = [Row(0, "(anonymous namespace)::spectral_forward_kernel(...)", 1010, 1100, "kernel"),
              Row(0, "void frames_kernel<PoolSink>(...)", 1400, 1500, "kernel"),
              Row(0, "Memcpy HtoD (Pinned -> Device)", 1250, 1300, "memcpy")]


def test_edge_ms_reads_the_edge_products_rows():
    read = run.reader("layers", "edge_ms.spectral")
    # 30 + 120 + 40 us over the window's 2 blocks
    assert read(_ctx(EDGE_ROWS + OTHER_ROWS)) == pytest.approx(0.095)
    assert read(_ctx(OTHER_ROWS)) is None and read(_ctx()) is None  # a time pool, the CPU


def test_edge_launches_reads_the_pushes(monkeypatch):
    read = run.reader("layers", "edge_launches.spectral")
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    pushes = [span("pool.push", 1050, 1250, 1, launches=8, edge_launches=2),
              span("pool.push", 1400, 1700, 2, launches=8, edge_launches=2)]
    monkeypatch.setattr(tracing, "spans", lambda: pushes)
    assert read(_ctx()) == pytest.approx(2.0)
    monkeypatch.setattr(tracing, "spans", lambda: [pushes[0], span("pool.push", 1400, 1700, 2, launches=4,
                                                                   edge_launches=0)])
    assert read(_ctx()) == pytest.approx(1.0)  # one block's product bypassed
    # a program whose pushes carry no such count (before the attribute), or none at all
    monkeypatch.setattr(tracing, "spans", lambda: [span("pool.push", 1050, 1250, 1, launches=8)])
    assert read(_ctx()) is None
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert read(_ctx()) is None
    monkeypatch.setattr(tracing, "spans", lambda: pushes)
    monkeypatch.setattr(tracing, "dropped", lambda: 1)
    assert read(_ctx()) is None
