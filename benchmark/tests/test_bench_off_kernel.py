"""The `offline_song_ov065` cell on the CPU: its configuration holds the
reference's offline defaults but for the overlap, no hop of it divides
its block, its tiny run goes through the whole-file torch.fft program
and never the frames kernel (K1), and the faults that program can have
(half of a bucket's frames left out, the overlap-add's carry from one
hop to the next dropped, one sample altered) make `correct` false."""

import json

import pytest
import torch

import tiny
import upmix_tpu_torch.models.offline as offline
from benchmark.reference import plan

CELL = "offline_song_ov065"


def config(name):
    return json.loads((tiny.ROOT / {c["name"]: c for c in tiny.spec()["configs"]}[name]["file"]).read_text())


def test_configuration_is_the_offline_defaults_at_overlap_065():
    mine, base = config(tiny.cell(CELL)["config"]), config("offline_44k_6band")
    assert {c["name"]: c for c in tiny.spec()["configs"]}[tiny.cell(CELL)["config"]]["reduced"] == []
    assert set(mine) == set(base)
    assert {k for k in base if mine[k] != base[k]} == {"name", "source", "deployment", "overlap", "buckets", "assumed"}
    assert mine["overlap"] == 0.65 and tiny.cell(CELL)["traffic"] == "song"
    assert [(b.block, b.hop) for b in plan.buckets(mine)] == \
        [(65536, 22937), (16384, 5734), (4096, 1433), (1024, 358), (256, 89)]


def test_runs_on_the_whole_file_program(monkeypatch):
    whole, kernel = [], []
    real = offline._whole_file_rows
    monkeypatch.setattr(offline, "_whole_file_rows", lambda *a: whole.append(a[2]) or real(*a))
    monkeypatch.setattr(offline, "omnibus_lcr_batch", lambda *a: kernel.append(1))
    r = tiny.result(CELL)
    assert r["correct"] is True, r["checks"]
    assert whole and not kernel


def broken(fault):
    if fault == "half_batch":  # the second half of each bucket's frames left out
        real = offline._spectral_lcr

        def spectral(p, frames):
            out = real(p, frames)
            out[..., out.shape[-2] - out.shape[-2] // 2 :, :] = 0
            return out

        return "_spectral_lcr", spectral
    if fault == "state_unchanged":  # each frame's tail never carried onto the next hops
        def ola(frames, hop):
            *batch, num, block = frames.shape
            acc = frames.new_zeros((*batch, (num - 1) * hop + block))
            acc[..., : num * hop] = frames[..., :hop].reshape(*batch, num * hop)
            return acc

        return "overlap_add", ola
    real = offline._whole_file_rows

    def rows(*a):  # token_altered: one sample of the stems
        out = real(*a)
        out[..., 0, 1000] += 0.05
        return out

    return "_whole_file_rows", rows


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged", "token_altered"])
def test_faults_fail(monkeypatch, fault):
    monkeypatch.setattr(offline, *broken(fault))
    r = tiny.result(CELL)
    assert r["correct"] is False, r["checks"]
