"""The check fails a broken timed path.  Each test drives a tiny run on
the CPU (no chip: the plain versions) with the program broken underneath
and sees `correct` come out false: once for each fault the cell can have.
And the control, the reference in TF32 put in the program's place, fails
the cell's limit at this size too."""

import pytest
import torch

import tiny
import upmix_tpu_torch.models.offline as offline
import upmix_tpu_torch.models.streaming as streaming

SPEC = tiny.spec()


def broken_omnibus(fault):
    real = offline.omnibus_lcr_batch

    def call(segs, oplan):
        main, spill = real(segs, oplan)
        if fault == "half_batch":  # the second half of the segments left out
            main[main.shape[0] - main.shape[0] // 2 :] = 0
        elif fault == "state_unchanged":  # the spill carry between segments dropped
            spill = torch.zeros_like(spill)
        elif fault == "token_altered":
            main[0, 0, 1000] += 0.05
        return main, spill

    return call


@pytest.mark.parametrize("workload,fault", [
    ("offline_song", "half_batch"),
    ("offline_song", "state_unchanged"),
    ("offline_song", "token_altered"),
    ("offline_clips", "token_altered"),
])
def test_offline_faults_fail(monkeypatch, workload, fault):
    assert tiny.result(workload)["correct"] is True
    monkeypatch.setattr(offline, "omnibus_lcr_batch", broken_omnibus(fault))
    r = tiny.result(workload)
    assert r["correct"] is False, r["checks"]


def broken_step(fault):
    real = streaming._batch_step

    def step(plan, hw, state, x):
        new, out = real(plan, hw, state, x)
        if fault == "state_unchanged":
            return state, out
        if fault == "half_batch":  # half of the streams left out
            out = out.clone()
            out[out.shape[0] // 2 :] = 0
        elif fault == "token_altered":
            out = out.clone()
            out[0, 0, 100] += 0.05
        return new, out

    return step


def broken_exchange():
    real = streaming._StreamPool._step

    def step(self, state, x):
        new, full = real(self, state, x)
        for index in self._index[1:]:  # the other devices' rows never gathered
            full[index] = 0
        return new, full

    return step


@pytest.mark.parametrize("workload,fault", [
    ("pool_2048", "state_unchanged"),
    ("pool_2048", "half_batch"),
    ("pool_2048", "token_altered"),
    ("pool_mesh4_8192", "state_unchanged"),
    ("pool_mesh4_8192", "half_batch"),
    ("pool_mesh4_8192", "token_altered"),
    ("pool_mesh4_8192", "exchange_left_out"),
])
def test_pool_faults_fail(monkeypatch, workload, fault):
    if fault == "exchange_left_out":
        monkeypatch.setattr(streaming._StreamPool, "_step", broken_exchange())
    else:
        monkeypatch.setattr(streaming, "_batch_step", broken_step(fault))
    r = tiny.result(workload)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_the_limit(workload):
    line = tiny.control(workload, bench=SPEC)
    limit = tiny.traffic(workload, SPEC)["check"]["limits"]["max_err"]
    assert line["program"]["max_err"] <= limit < line["control"]["max_err"]


def test_new_cell_control_fails_the_limit():
    """The same for a cell entered in the spec alone (pool_2048's traffic
    on the spectral OLA, patched in memory)."""
    from benchmark import run

    bench = tiny.joined(SPEC, tiny.NEW, tiny.LIKE)
    line = tiny.control(tiny.NEW, bench=bench, traffic_patch=run.merged(tiny.patch(tiny.NEW, bench), tiny.NEW_PATCH))
    limit = tiny.traffic(tiny.NEW, bench)["check"]["limits"]["max_err"]
    assert line["program"]["max_err"] <= limit < line["control"]["max_err"]
