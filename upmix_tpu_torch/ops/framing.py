"""Framing and overlap-add on tensors (port of `upmix_tpu/ops/framing.py`).

Framing is a view (`unfold`) at any hop, and overlap-add is
ceil(block/hop) shifted adds in a fixed order, so the sums are
deterministic and match the JAX fold element for element (its grouped
fold when hop | block, its scatter-add otherwise).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tnf


def frame_signal(x: torch.Tensor, block_size: int, hop_size: int, num_frames: int) -> torch.Tensor:
    """out[..., f, n] = x[..., f*hop + n]; x has trailing length
    (num_frames - 1) * hop_size + block_size.  Returns a view."""
    total = (num_frames - 1) * hop_size + block_size
    if x.shape[-1] != total:
        raise ValueError(f"expected trailing length {total}, got {x.shape[-1]}")
    return x.unfold(-1, block_size, hop_size)


def overlap_add(frames: torch.Tensor, hop_size: int) -> torch.Tensor:
    """[..., num_frames, block] -> [..., (num_frames - 1) * hop + block]:
    ceil(block / hop) shifted adds of the frames' hop-long parts.  When hop
    does not divide the block each frame is zero-padded to whole hops and
    the parts add last first, so every position sums its frames in
    increasing frame order, as the JAX package's scatter-add does.  No
    scatter: deterministic on the card too."""
    *batch, num_frames, block_size = frames.shape
    total = (num_frames - 1) * hop_size + block_size
    k_frames = -(-block_size // hop_size)
    order = range(k_frames)
    if block_size % hop_size:
        frames = tnf.pad(frames, (0, k_frames * hop_size - block_size))
        order = reversed(order)
    z = frames.reshape(*batch, num_frames, k_frames, hop_size)
    acc = None
    for k in order:
        # Frame part k lands k hops later: pad the frame axis.
        part = tnf.pad(z[..., :, k, :], (0, 0, k, k_frames - 1 - k))
        acc = part if acc is None else acc + part
    return acc.reshape(*batch, (num_frames + k_frames - 1) * hop_size)[..., :total]


def offline_frame_plan(n_samples: int, block_size: int, hop_size: int) -> tuple:
    """(num_frames, total_padded) of the reference's padding math: every
    window full, num_hops = ceil((N - (block - hop)) / hop)."""
    leftover = block_size - hop_size
    num_hops = math.ceil((n_samples - leftover) / hop_size)
    padded_len = max(num_hops * hop_size + leftover, n_samples)
    num_frames = math.ceil(padded_len / hop_size)
    total_padded = (num_frames - 1) * hop_size + block_size
    return num_frames, total_padded
