"""`reg_fft.pool`'s reader on synthetic traces: the share of K3's FFT
frames (the `fft_frames` of the window's `pool.frames` spans) that the
register core took (their `reg_frames`); K3s's steps are
`reg_fft.spectral`'s (test_bench_reg_fft.py)."""

import pytest

from benchmark import run
from test_bench_spans import span
from test_bench_spectral import _ctx
from upmix_tpu_torch.utils import tracing

# K3's spans, as the time pool's `_pool_cuda` opens them: a stream's call of
# the Bela buckets at hw 2048 (1 + 2 + 8 + 32 frames, each up to FFT_MAX),
# and at hw 8192 (the 32768 bucket's 1 frame a block on the split).
K3_CALLS = [span("pool.frames", 1060, 1240, 3, parent=1, card=0, buckets=4, fft_frames=43, reg_frames=43),
            span("pool.frames", 1410, 1690, 5, parent=2, card=0, buckets=4, fft_frames=43, reg_frames=43)]
K3S_STEPS = [span("pool.forward", 1060, 1100, 3, parent=1, card=0, buckets=4, fft_frames=169, reg_frames=168),
             span("pool.inverse", 1150, 1240, 4, parent=1, card=0, buckets=3, fft_frames=177, reg_frames=177)]
PUSH = span("pool.push", 1050, 1250, 1, launches=4, edge_launches=0)


@pytest.mark.parametrize("records,want", [
    (K3_CALLS, 100.0),  # every frame on the core
    ([span("pool.frames", 1060, 1240, 3, parent=1, card=0, buckets=4, fft_frames=169, reg_frames=168)],
     100.0 * 168 / 169),  # a split bucket's frame off it
    (K3_CALLS + K3S_STEPS, 100.0),  # K3s's steps are not K3's
    (K3S_STEPS + [PUSH], None),  # a spectral pool: no pool.frames span
    ([span("pool.frames", 1060, 1240, 3, parent=1, card=0, buckets=4), *K3_CALLS[1:]], None),  # a span without counts
    ([PUSH], None),  # the parent's program: no such span
], ids=["all_on_the_core", "split_bucket", "k3s_steps_apart", "spectral_only", "no_counts", "no_span"])
def test_reg_fft_pool_reads_the_frames_spans(monkeypatch, records, want):
    read = run.reader("layers", "reg_fft.pool")
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    monkeypatch.setattr(tracing, "spans", lambda: records)
    got = read(_ctx())
    assert got is None if want is None else got == pytest.approx(want)
