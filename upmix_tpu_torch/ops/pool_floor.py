"""The serving pool's floor probe: the least a pool step must move.

Port of the probe kernel of `scripts/bench_pool_floor.py` (main.make_call,
the TPU kernel that measured the pool kernel's floor), with the whole
pool as one group of streams.  From a history [S, 2, window] it writes
out [S, 3, hw]:

  - mode "copy":  (L[:hw] + R[:hw], L[window - hw:], R[window - hw:]);
  - mode "frame": per bucket the first rows of its framed channel-L
    matrix (rows (stream, m), m < M frames of one group, M = P / (B/H)
    when that divides, else 1), the first min(hw, B) columns of each,
    summed over buckets in plan order into acc; out = (acc, acc + L[:hw],
    acc + R[:hw]).

The probe DMAs each group's whole [G, window] history of both channels
into on-chip memory before it writes the outputs, so it moves what a
pool step must move of the history and the outputs.  The kernel does the
same: one thread block per stream stages the stream's whole [2, window]
history in shared memory, so both modes read 2 * S * window floats and
write 3 * S * hw (`floor_bytes`).  The pool step moves its carries
besides, which the probe leaves out.

On a CUDA tensor `pool_floor` launches `csrc/pool.cu::floor_kernel`,
whose output equals `pool_floor_plain` bit for bit; on a CPU tensor it
runs `pool_floor_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from upmix_tpu_torch.ops.pool import PoolPlan

# CUDA kernel launches made by pool_floor.
LAUNCHES = 0

MAX_BUCKETS = 8  # csrc/pool.cu: FloorGeom; streaming configs have at most 8 bands
MAX_SHARED_BYTES = 227 * 1024  # one thread block's shared memory on sm_90


def frame_geometry(plan: PoolPlan) -> tuple:
    """(B, M) per bucket of the frame mode: M frames of one group per row
    block (bench_pool_floor.py:58-60)."""
    geo = []
    for b in plan.buckets:
        kr = b.block // b.hop
        geo.append((b.block, b.passes // kr if b.passes % kr == 0 else 1))
    return tuple(geo)


def _check(hist: torch.Tensor, hw: int, mode: str, plan):
    if mode not in ("copy", "frame"):
        raise ValueError(f"unknown mode {mode!r}; one of ('copy', 'frame')")
    if hist.dim() != 3 or hist.shape[1] != 2 or hist.shape[2] < hw:
        raise ValueError(f"expected hist [S, 2, window >= {hw}], got {tuple(hist.shape)}")
    if mode == "frame":
        if plan is None or plan.hw != hw:
            raise ValueError("mode 'frame' needs the pool plan of this hw")
        for B, M in frame_geometry(plan):
            if M * B > hist.shape[2]:
                raise ValueError(f"bucket {B} x {M} frames is longer than the history")


def pool_floor(hist: torch.Tensor, hw: int, mode: str = "copy", plan: PoolPlan | None = None):
    """hist [S, 2, window] -> out [S, 3, hw] (see the module docstring).
    `plan` gives the buckets of mode "frame"."""
    if hist.device.type == "cpu":
        return pool_floor_plain(hist, hw, mode, plan)
    if hist.device.type != "cuda":
        raise ValueError(f"pool_floor runs on cpu or cuda, not {hist.device}")
    return _floor_cuda(hist, hw, mode, plan)


def _floor_cuda(hist, hw: int, mode: str, plan):
    global LAUNCHES
    from upmix_tpu_torch.ops import _build

    _check(hist, hw, mode, plan)
    if hist.dtype != torch.float32 or not hist.is_contiguous():
        raise ValueError("the floor kernel takes a contiguous float32 history")
    geo = frame_geometry(plan) if mode == "frame" else ()
    if len(geo) > MAX_BUCKETS:
        raise ValueError(f"at most {MAX_BUCKETS} buckets, got {len(geo)}")
    packed = (ctypes.c_int * (2 * MAX_BUCKETS))(*[v for bm in geo for v in bm])
    S, _, W = hist.shape
    if 2 * W * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"a window of {W} samples does not fit one thread block's shared memory")
    out = torch.empty((S, 3, hw), dtype=torch.float32, device=hist.device)
    stream = torch.cuda.current_stream(hist.device).cuda_stream
    rc = _build.load().pool_floor(hist.data_ptr(), out.data_ptr(), S, W, hw, len(geo), packed, stream)
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"pool_floor launch failed: cudaError {rc}")
    return out


def pool_floor_plain(hist: torch.Tensor, hw: int, mode: str = "copy", plan: PoolPlan | None = None):
    """The plain PyTorch version, same contract and the same float32
    sums in the same order."""
    _check(hist, hw, mode, plan)
    L, R = hist[:, 0], hist[:, 1]
    W = hist.shape[2]
    if mode == "copy":
        return torch.stack([L[:, :hw] + R[:, :hw], L[:, W - hw :], R[:, W - hw :]], dim=1)
    S = hist.shape[0]
    acc = None
    for B, M in frame_geometry(plan):
        w = min(hw, B)
        rows = L[:, : M * B].reshape(S * M, B)[:S, :w]
        part = torch.nn.functional.pad(rows, (0, hw - w))
        acc = part if acc is None else acc + part
    return torch.stack([acc, acc + L[:, :hw], acc + R[:, :hw]], dim=1)


def floor_bytes(S: int, window: int, hw: int) -> int:
    """Bytes the probe moves in either mode: each stream's [2, window]
    history read once, three [hw] outputs written (float32)."""
    return 4 * S * (2 * window + 3 * hw)
