"""The one traffic generator: input lengths and audio from a traffic
file's parameters and the run's seed.

Lengths (`files` in a traffic file):
  - "grid": `count` lengths evenly spaced over [min_s, max_s] (linear, or
    "log" `spacing`), each plus a jitter drawn uniformly from [0,
    jitter_s) seconds, in an order drawn from the seed.  Every seed gets
    the same amount of work in another order and at other exact lengths.
  - "sequence": an endless run of lengths over [min_s, max_s], the j-th at
    quantile frac(u0 + j * 0.618...) (a golden-ratio sequence: any prefix
    covers the range evenly), u0 drawn from the seed, every length in
    samples distinct; each is a slice of one seeded buffer of `buffer_s`
    seconds, at an offset drawn from the seed.

Audio (`audio`): a center component common to both channels plus an
independent side component in each, white Gaussian, the channels' RMS at
`level_dbfs`, `center_share` of each channel's power in the center.  It
is made on the device by one torch.Generator seeded with the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def _seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """NumPy generator of one independent stream of a seed."""
    return np.random.default_rng([_seed(seed), stream])


def torch_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(_seed(seed))
    return g


def grid_lengths(spec: dict, sr: float, seed: int) -> list:
    lo, hi, count = float(spec["min_s"]), float(spec["max_s"]), int(spec["count"])
    if spec.get("spacing", "linear") == "log":
        points = np.exp(np.linspace(math.log(lo), math.log(hi), count))
    else:
        points = np.linspace(lo, hi, count)
    r = rng(seed, 1)
    jitter = r.integers(0, max(1, int(float(spec.get("jitter_s", 0)) * sr)), size=count)
    lengths = np.round(points * sr).astype(np.int64) + jitter
    return [int(n) for n in lengths[r.permutation(count)]]


def sequence_lengths(spec: dict, sr: float, seed: int, count: int) -> list:
    lo, hi = float(spec["min_s"]) * sr, float(spec["max_s"]) * sr
    u0 = rng(seed, 2).random()
    q = (u0 + GOLDEN * np.arange(count)) % 1.0
    if spec.get("spacing", "linear") == "log":
        raw = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    else:
        raw = lo + q * (hi - lo)
    seen, out = set(), []
    for n in np.round(raw).astype(np.int64):
        n = int(n)
        while n in seen:
            n += 1
        seen.add(n)
        out.append(n)
    return out


def sequence_offsets(lengths: list, buffer_n: int, seed: int) -> list:
    high = buffer_n - np.asarray(lengths, dtype=np.int64) + 1
    return [int(o) for o in rng(seed, 3).integers(0, high)]


def audio(spec: dict, shape: tuple, gen: torch.Generator, device) -> torch.Tensor:
    """Stereo float32 [2, *shape] on `device`: center plus independent sides."""
    rms = 10.0 ** (float(spec["level_dbfs"]) / 20.0)
    share = float(spec["center_share"])
    z = torch.randn((3, *shape), generator=gen, device=torch.device(device))
    center = z[0] * (rms * math.sqrt(share))
    sides = z[1:] * (rms * math.sqrt(1.0 - share))
    return center + sides
