"""The traffic generator gives the same inputs for a seed, other inputs
for another seed, and the same amount of work to every seed."""

import numpy as np
import torch

import tiny  # noqa: F401  (puts the repo root on sys.path)
from benchmark import generate

GRID = {"kind": "grid", "count": 8, "min_s": 120, "max_s": 360, "spacing": "linear", "jitter_s": 1.0}
SEQ = {"kind": "sequence", "min_s": 1, "max_s": 10, "spacing": "log", "buffer_s": 60}
AUDIO = {"level_dbfs": -12, "center_share": 0.5}


def test_grid_lengths_repeat_for_a_seed_and_keep_the_work():
    a, b = generate.grid_lengths(GRID, 44100, 5), generate.grid_lengths(GRID, 44100, 5)
    c = generate.grid_lengths(GRID, 44100, 2**33 + 7)
    assert a == b and a != c
    assert sorted(a) != a or sorted(c) != c  # some order is drawn
    for lengths in (a, c):
        base = np.round(np.linspace(120, 360, 8) * 44100)
        jitter = np.sort(lengths) - base
        assert ((jitter >= 0) & (jitter < 44100)).all()


def test_sequence_lengths_are_distinct_in_range_and_repeat():
    a = generate.sequence_lengths(SEQ, 44100, 9, 3000)
    assert a == generate.sequence_lengths(SEQ, 44100, 9, 3000)
    assert a != generate.sequence_lengths(SEQ, 44100, 10, 3000)
    assert len(set(a)) == len(a)
    assert min(a) >= 44100 and max(a) <= 441000 + 3000
    # log-uniform: about half the clips under sqrt(10) s, in any prefix
    for prefix in (100, 1000, 3000):
        share = np.mean(np.array(a[:prefix]) < np.sqrt(10) * 44100)
        assert abs(share - 0.5) < 0.03
    offsets = generate.sequence_offsets(a, 60 * 44100, 9)
    assert offsets == generate.sequence_offsets(a, 60 * 44100, 9)
    assert all(0 <= o <= 60 * 44100 - n for o, n in zip(offsets, a))


def test_audio_repeats_for_a_seed_with_a_real_center():
    x = generate.audio(AUDIO, (4, 50000), generate.torch_generator(2**31 + 11, "cpu"), "cpu")
    y = generate.audio(AUDIO, (4, 50000), generate.torch_generator(2**31 + 11, "cpu"), "cpu")
    z = generate.audio(AUDIO, (4, 50000), generate.torch_generator(2**31 + 12, "cpu"), "cpu")
    assert torch.equal(x, y) and not torch.equal(x, z)
    assert x.shape == (2, 4, 50000) and x.dtype == torch.float32
    rms = x.pow(2).mean().sqrt().item()
    assert abs(20 * np.log10(rms) + 12) < 0.1
    corr = (x[0] * x[1]).mean() / x.pow(2).mean()
    assert abs(corr.item() - 0.5) < 0.02  # the center's share of each channel's power
