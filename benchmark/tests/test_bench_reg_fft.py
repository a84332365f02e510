"""`reg_fft.spectral`'s reader on synthetic traces: the share of K3s's
FFT frames (the `fft_frames` of the window's `pool.forward` and
`pool.inverse` spans) that the register core took (their `reg_frames`)."""

import pytest

from benchmark import run
from test_bench_spans import span
from test_bench_spectral import _ctx
from upmix_tpu_torch.utils import tracing


def test_reg_fft_reads_the_steps_spans(monkeypatch):
    read = run.reader("layers", "reg_fft.spectral")
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    steps = [span("pool.forward", 1060, 1100, 3, parent=1, card=0, buckets=4, fft_frames=43, reg_frames=43),
             span("pool.inverse", 1150, 1240, 4, parent=1, card=0, buckets=2, fft_frames=46, reg_frames=46),
             span("pool.forward", 1410, 1450, 5, parent=2, card=0, buckets=4, fft_frames=43, reg_frames=43),
             span("pool.inverse", 1500, 1690, 6, parent=2, card=0, buckets=2, fft_frames=46, reg_frames=46)]
    edge = span("pool.edge", 1100, 1150, 7, parent=1, card=0, buckets=2, frames=9)
    monkeypatch.setattr(tracing, "spans", lambda: [*steps, edge])
    assert read(_ctx()) == pytest.approx(100.0)
    # a size off the core (the split's 32768 frames at hw 8192): 168 + 177 of 169 + 177
    part = [span("pool.forward", 1060, 1100, 3, parent=1, buckets=4, fft_frames=169, reg_frames=168),
            span("pool.inverse", 1150, 1240, 4, parent=1, buckets=3, fft_frames=177, reg_frames=177)]
    monkeypatch.setattr(tracing, "spans", lambda: part)
    assert read(_ctx()) == pytest.approx(100.0 * 345 / 346)
    # a program whose steps carry no such count (before the attributes), or no step at all
    monkeypatch.setattr(tracing, "spans", lambda: [span("pool.forward", 1060, 1100, 3, parent=1, buckets=4),
                                                   span("pool.inverse", 1150, 1240, 4, parent=1, buckets=2)])
    assert read(_ctx()) is None
    monkeypatch.setattr(tracing, "spans", lambda: [span("pool.push", 1050, 1250, 1, launches=4, edge_launches=0)])
    assert read(_ctx()) is None
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert read(_ctx()) is None
