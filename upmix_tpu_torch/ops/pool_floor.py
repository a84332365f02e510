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
same: a streaming pass loads every 16-byte column of the history into
registers once, whether or not it feeds an output, so both modes read
2 * S * window floats and write 3 * S * hw (`floor_bytes`).  The pool
step moves its carries besides, which the probe leaves out.

On a CUDA tensor `pool_floor` launches `csrc/pool.cu::floor_kernel`,
whose output equals `pool_floor_plain` bit for bit; on a CPU tensor it
runs `pool_floor_plain`.

On the card, at the serving pool's cell (the stream server's default
config, 2048 streams, hw 2048, window 8192):

    python -m upmix_tpu_torch.ops.pool_floor [--against LIB.so]

times both modes beside the plain version and one PyTorch call that
reads the whole history (`library_call`), with CUDA events; with
--against, also the floor kernel of another build of the library (an
earlier tree's `upmix_tpu_torch/_build/kernels_*.so`), in turns: this,
that, that, this.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from upmix_tpu_torch.ops import _build
from upmix_tpu_torch.ops.pool import PoolPlan

MAX_BUCKETS = 8  # csrc/pool.cu: FloorGeom; streaming configs have at most 8 bands


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


def _floor_cuda(hist, hw: int, mode: str, plan, lib=None):
    """The kernel of `lib` (default: this tree's library)."""
    _check(hist, hw, mode, plan)
    if hist.dtype != torch.float32 or not hist.is_contiguous():
        raise ValueError("the floor kernel takes a contiguous float32 history")
    geo = frame_geometry(plan) if mode == "frame" else ()
    if len(geo) > MAX_BUCKETS:
        raise ValueError(f"at most {MAX_BUCKETS} buckets, got {len(geo)}")
    packed = (ctypes.c_int * (2 * MAX_BUCKETS))(*[v for bm in geo for v in bm])
    S, _, W = hist.shape
    with _build.kernels(hist.device, lib) as k:
        out = torch.empty((S, 3, hw), dtype=torch.float32, device=hist.device)
        k.launch("K6", "pool_floor", hist.data_ptr(), out.data_ptr(), S, W, hw, len(geo), packed)
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


def library_call(hist: torch.Tensor, hw: int) -> torch.Tensor:
    """One PyTorch call that reads the whole history and writes [S, 2, hw]:
    the sum of its hw-long pieces (window a multiple of hw).  Not the
    probe's function: a yardstick of what the card gives one call that
    streams these bytes, 4 * S * 2 * (window + hw)."""
    S, _, W = hist.shape
    return hist.view(S, 2, W // hw, hw).sum(2)


def _time_ms(fn, loops: int = 20, iters: int = 10) -> float:
    """Min over loops of the mean ms a call, CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(loops):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def main(argv=None) -> int:
    import argparse

    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.ops.pool import make_pool_plan

    p = argparse.ArgumentParser(prog="python -m upmix_tpu_torch.ops.pool_floor")
    p.add_argument("--against", default=None, metavar="LIB.so",
                   help="also time the pool_floor of this build of the library (an earlier tree's)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("error: the floor probe times the CUDA kernel: no CUDA device")
    dev, S, hw = torch.device("cuda"), 2048, 2048
    plan = make_pool_plan(UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=hw), hw, S,
                          device=dev)
    hist = torch.randn((S, 2, plan.window), device=dev, generator=torch.Generator(dev).manual_seed(2))
    other = _build.library(args.against, "pool_floor") if args.against else None
    bound_ms = floor_bytes(S, plan.window, hw) / 3.35e12 * 1e3
    lib_ms = _time_ms(lambda: library_call(hist, hw))
    lib_bytes = 4 * S * 2 * (plan.window + hw)
    for mode in ("copy", "frame"):

        def mine():
            return pool_floor(hist, hw, mode, plan)

        line = (f"floor {mode} S={S} window {plan.window} hw {hw}: {{k}} ({bound_ms * 1e3:.2f} us bound, "
                f"{floor_bytes(S, plan.window, hw) / 1e6:.1f} MB at 3.35 TB/s); plain "
                f"{_time_ms(lambda: pool_floor_plain(hist, hw, mode, plan)) * 1e3:.2f} us; same-bytes call "
                f"{lib_ms * 1e3:.2f} us ({lib_bytes / 1e6:.1f} MB)")
        if other is None:
            k = _time_ms(mine)
            print(line.format(k=f"{k * 1e3:.2f} us, {bound_ms / k:.1%} of the bound"), flush=True)
            continue

        def theirs():
            return _floor_cuda(hist, hw, mode, plan, lib=other)

        if not torch.equal(mine(), theirs()):
            raise SystemExit(f"error: {args.against} and this kernel disagree in mode {mode}")
        a1, b1, b2, a2 = _time_ms(mine), _time_ms(theirs), _time_ms(theirs), _time_ms(mine)
        k, t = (a1 + a2) / 2, (b1 + b2) / 2
        print(line.format(k=f"{k * 1e3:.2f} us, {bound_ms / k:.1%} of the bound (visits {a1 * 1e3:.2f}, {a2 * 1e3:.2f})")
              + f"; {args.against}: {t * 1e3:.2f} us ({bound_ms / t:.1%}; visits {b1 * 1e3:.2f}, {b2 * 1e3:.2f})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
