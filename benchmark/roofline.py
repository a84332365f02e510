"""Least time of the algorithm's work on one NVIDIA H100, counted from a
configuration's own numbers (band edges, sample rate, block sizes,
overlap, streams), never from the program's planner.

  - Operations: five real FFTs of B points for every frame of every
    bucket (two forward, three inverse), 2.5 B log2 B FLOP each, at the
    card's FP32 peak outside the tensor cores.
  - Bytes: every input byte read once and every output byte written once,
    float32 samples; the stream pool's carried state (the shared history
    of K hardware blocks per channel, an overlap-add carry of 3 x B
    samples per bucket, the block counter) counts as input and as output.
  - The least time is the larger of the two, and `bound` says which.

Peaks: NVIDIA's data sheet for the H100 SXM at its full 700 W; a card
set below that limit runs slower under load, so results carry the card's
power limit beside the share.
"""

from __future__ import annotations

import math

from benchmark.reference.plan import bands

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SAMPLE_BYTES = 4
FFTS_PER_FRAME = 5


def fft_flops(block: int) -> float:
    return 2.5 * block * math.log2(block)


def _buckets(cfg: dict) -> list:
    """(block, hop) of each bucket: bands of one block size share a frame."""
    return list({b.block: b.hop for b in bands(cfg)}.items())


def _least(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return {
        "flops": flops,
        "bytes": nbytes,
        "seconds": max(t_ops, t_bytes),
        "bound": "operations" if t_ops >= t_bytes else "bytes",
    }


def offline_file(cfg: dict, n_samples: int) -> dict:
    """One file of n samples: ceil(n / hop) frames a bucket; two channels
    in, three stems out."""
    flops = sum(-(-n_samples // hop) * FFTS_PER_FRAME * fft_flops(block) for block, hop in _buckets(cfg))
    return _least(flops, (2 + 3) * n_samples * SAMPLE_BYTES)


def pool_block(cfg: dict, streams: int) -> dict:
    """One hardware block for every stream: hw / hop frames a bucket."""
    hw, bs = int(cfg["hw_block_size"]), _buckets(cfg)
    k = {block // hop for block, hop in bs}
    if len(k) != 1:
        raise ValueError(f"a stream pool needs one block/hop ratio, got {sorted(k)}")
    (k,) = k
    flops = streams * sum((hw // hop) * FFTS_PER_FRAME * fft_flops(block) for block, hop in bs)
    state = 2 * k * hw + 3 * sum(block for block, _ in bs)  # samples
    nbytes = streams * ((2 + 3) * hw * SAMPLE_BYTES + 2 * (state * SAMPLE_BYTES + 4))
    return _least(flops, nbytes)
