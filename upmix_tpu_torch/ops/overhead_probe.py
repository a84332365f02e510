"""Fixed-cost probe: the omnibus grid's structure with a trivial body.

Port of `scripts/bench_overhead_probe.py` (main.build, the TPU kernel that
measured the fixed cost of a grid step).  For x [1, 2, N + 4 TILE],
a scalar seed and n_weights [128, 128] weights, `overhead_probe` computes
what the probe's kernel computes (bench_overhead_probe.py:40-57):

  - out [1, 3, N]: out[0, c, j] = (x[0, 0, j] + seed) + sum_k w_k[0, 0]
    for every channel c, the sum taken in order in float32;
  - spill [1, 3, halo]: the accumulator, which starts at 0 and is halved
    at every step, so exactly 0.

n_views views of x at tiles i + v reach the kernel; only row 0 of view 0
enters the result, but the kernel stages every view's tile into the shared
memory of the thread block that owns the output tile, as the TPU kernel's
BlockSpecs copied them into VMEM.  So its time is the fixed cost of a
launch and of N / TILE thread blocks that each receive n_views [2, TILE]
tiles.  On a CUDA tensor `overhead_probe` launches
`csrc/overhead_probe.cu`, whose output equals `overhead_probe_plain` bit
for bit; on a CPU tensor it runs `overhead_probe_plain`.

    python -m upmix_tpu_torch.ops.overhead_probe
    python -m upmix_tpu_torch.ops.overhead_probe cold [--against LIB.so]

The first prints the script's line for each of its six configurations (ms
per call and us per tile over ITERS calls chained through the seed,
median of three), the staged bytes and the bound, and the time of an
empty launch of the same grid, through the wrapper and in a loop in C:
the floor.  `cold` times each configuration's kernel with L2 cold
(`cold_ms`), beside one PyTorch call that moves the function's bytes
(`library_call`); with --against, also the kernel of another build of
this library (an earlier tree's `upmix_tpu_torch/_build/kernels_*.so`),
in turns: this, that, that, this.  Both run on the card.
"""

from __future__ import annotations

import ctypes
import itertools
import sys

import numpy as np
import torch

from upmix_tpu_torch.ops import _build

N = 2**21
TILE = 16384
ITERS = 20
# (n_views, n_weights, halo) of bench_overhead_probe.py:88-92.
CONFIGS = ((1, 0, 128), (2, 0, 128), (4, 0, 128), (4, 16, 128), (4, 56, 128), (4, 56, 49152))
MAX_WEIGHTS = 64  # csrc/overhead_probe.cu: MAX_WEIGHTS
HBM_BYTES_PER_S = 3.35e12  # an H100 SXM's HBM3
# The cold-L2 protocol (`cold_ms`): CALLS calls queued back to back,
# rotating over SETS copies of x that each keep their output (at N = 2^21,
# 8 x 42 MB: a repeated call would find its 42 MB in the 50 MB L2).
SETS = 8
CALLS = 64


def make_inputs(n: int = N, tile: int = TILE, device="cuda", seed: int = 0):
    """(x [1, 2, n + 4 tile], rng) as the script draws them: x first, then
    each configuration's weights from the same generator (`make_weights`)."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((1, 2, n + 4 * tile)), dtype=torch.float32, device=device)
    return x, rng


def make_weights(n_weights: int, rng, device="cuda") -> list:
    return [torch.as_tensor(rng.standard_normal((128, 128)), dtype=torch.float32, device=device)
            for _ in range(n_weights)]


def _check(x: torch.Tensor, seed: torch.Tensor, weights, n_views: int, halo: int, tile: int, n: int):
    if x.dim() != 3 or x.shape[:2] != (1, 2):
        raise ValueError(f"expected x [1, 2, samples], got {tuple(x.shape)}")
    if n < tile or n % tile:
        raise ValueError(f"n = {n} must be a positive multiple of the tile {tile}")
    if n_views < 1 or x.shape[2] < n + (n_views - 1) * tile:
        raise ValueError(f"{n_views} views of {n // tile} tiles need {n + (n_views - 1) * tile} samples, "
                         f"x has {x.shape[2]}")
    if halo < 1:
        raise ValueError(f"halo must be >= 1, got {halo}")
    if seed.numel() != 1:
        raise ValueError("seed must be a scalar tensor")
    if len(weights) > MAX_WEIGHTS or any(w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1 for w in weights):
        raise ValueError(f"at most {MAX_WEIGHTS} two-dimensional weights")


def overhead_probe(x: torch.Tensor, seed: torch.Tensor, weights, n_views: int, halo: int, tile: int = TILE,
                   n: int | None = None):
    """-> (out [1, 3, n], spill [1, 3, halo]); n defaults to x's length
    less four tiles, as the script lays x out."""
    n = x.shape[-1] - 4 * tile if n is None else n
    if x.device.type == "cpu":
        return overhead_probe_plain(x, seed, weights, n_views, halo, tile, n)
    if x.device.type != "cuda":
        raise ValueError(f"overhead_probe runs on cpu or cuda, not {x.device}")
    return _probe_cuda(x, seed, weights, n_views, halo, tile, n)


def _probe_cuda(x, seed, weights, n_views: int, halo: int, tile: int, n: int, lib=None):
    """The kernel of `lib` (default: this tree's library)."""
    _check(x, seed, weights, n_views, halo, tile, n)
    tensors = (x, seed, *weights)
    if any(t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device for t in tensors):
        raise ValueError("the probe kernel takes contiguous float32 tensors on one device")
    if x.shape[2] % 4 or tile % 4:
        raise ValueError("the probe kernel stages 16-byte pieces: x's length and the tile must be multiples of 4")
    ptrs = (ctypes.c_void_p * MAX_WEIGHTS)(*[w.data_ptr() for w in weights])
    with _build.kernels(x.device, lib) as k:
        out = torch.empty((1, 3, n), dtype=torch.float32, device=x.device)
        spill = torch.empty((1, 3, halo), dtype=torch.float32, device=x.device)
        k.launch("K5", "overhead_probe", x.data_ptr(), x.shape[2], seed.data_ptr(), ptrs, len(weights), n_views,
                 n // tile, tile, out.data_ptr(), spill.data_ptr(), halo)
    return out, spill


def overhead_probe_plain(x: torch.Tensor, seed: torch.Tensor, weights, n_views: int, halo: int,
                         tile: int = TILE, n: int | None = None):
    """The plain PyTorch version: the same float32 sums in the same order."""
    n = x.shape[-1] - 4 * tile if n is None else n
    _check(x, seed, weights, n_views, halo, tile, n)
    s = torch.zeros((), dtype=torch.float32, device=x.device)
    for w in weights:
        s = s + w[0, 0]
    y = (x[0, 0, :n] + seed.reshape(())) + s
    out = y.expand(3, n)[None].contiguous()
    return out, torch.zeros((1, 3, halo), dtype=torch.float32, device=x.device)


def empty_launch(blocks: int, count: int = 1, device="cuda"):
    """`count` launches of an empty kernel on `blocks` blocks of the
    probe's width, from one host call (the floor of a launch; not counted
    as K5's)."""
    with _build.kernels(device) as k:
        k.run("empty_launch", blocks, count, k.stream)


def queued_ms(fn, calls: int) -> float:
    """ms per call of `calls` calls of fn run back to back on the device:
    they are queued behind a sleeping kernel, so no host gap falls between
    them (the start event must still be pending when the last is queued)."""
    fn()
    torch.cuda.synchronize()
    cycles = 2 * 10**7
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / calls
        cycles *= 4
    raise RuntimeError(f"could not queue {calls} calls ahead of the device")


def cold_ms(call, xs) -> float:
    """ms per call of call(x) with L2 cold: CALLS calls queued back to back
    (`queued_ms`), rotating over the tensors xs, each call's output kept
    until its tensor's turn comes again, so all but the last 50 MB of the
    writes reach HBM inside the timed span."""
    ring, turn = [None] * len(xs), itertools.count()

    def step():
        i = next(turn) % len(xs)
        ring[i] = None
        ring[i] = call(xs[i])

    for _ in xs:
        step()
    return queued_ms(step, CALLS)


def library_call(x: torch.Tensor, shift: torch.Tensor, n: int) -> torch.Tensor:
    """One PyTorch call that moves the function's bytes: x's row 0 plus
    `shift` (seed + the weights' sum), three channels, into a new [1, 3, n].
    The yardstick (`library_ms`) of `cold`; the probe never calls it."""
    out = torch.empty((1, 3, n), dtype=x.dtype, device=x.device)
    torch.add(x[0, 0, :n].expand(3, n), shift, out=out[0])
    return out


def _event_ms(fn, count: int) -> float:
    """ms per call of fn over `count` calls, CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def staged_bytes(n_views: int, n: int = N) -> int:
    """Bytes the kernel moves between L2 and the SMs: every view's [2, TILE]
    tile of every tile staged, out written (the spill aside)."""
    return n_views * 8 * n + 12 * n


def bound_bytes(n: int, halo: int) -> int:
    """The function's least bytes: x's row 0 read, out and spill written."""
    return 4 * (n + 3 * n + 3 * halo)


def run_configs() -> list:
    """The script's protocol on the card: per configuration, ITERS calls
    chained through the seed (seed = out[0, 0, 0] * 1e-6), timed with CUDA
    events, median of three.  Returns [(n_views, n_weights, halo, ms per
    call)] and prints the script's line, the staged bytes and the bound
    (bytes from HBM; these calls, host time included, find x in L2);
    then the empty launch through the wrapper ("empty") and from C
    ("empty_c")."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe times the CUDA kernel: no CUDA device")
    device = torch.device("cuda")
    x, rng = make_inputs(device=device)
    n_tiles = N // TILE
    rows = []
    for n_views, n_weights, halo in CONFIGS:
        weights = make_weights(n_weights, rng, device)

        def run(k):
            seed = torch.zeros((), dtype=torch.float32, device=device)
            res = None
            for _ in range(k):
                res = overhead_probe(x, seed, weights, n_views, halo)
                seed = res[0][0, 0, 0] * 1e-6
            return res

        run(1)
        torch.cuda.synchronize()
        ms = sorted(_event_ms(lambda: run(ITERS), 1) / ITERS for _ in range(3))[1]
        rows.append((n_views, n_weights, halo, ms))
        print(f"views={n_views} weights={n_weights} halo={halo}: {ms:6.3f} ms = {ms * 1e3 / n_tiles:6.3f} us/tile; "
              f"staged {staged_bytes(n_views) / 1e6:.1f} MB; bound {bound_bytes(N, halo) / HBM_BYTES_PER_S * 1e6:.1f} "
              f"us ({bound_bytes(N, halo) / 1e6:.1f} MB)", flush=True)
    empty_launch(n_tiles)
    torch.cuda.synchronize()
    py_ms = _event_ms(lambda: empty_launch(n_tiles), ITERS)
    c_ms = _event_ms(lambda: empty_launch(n_tiles, ITERS), 1) / ITERS
    print(f"empty launch of {n_tiles} blocks: {py_ms * 1e3:.2f} us a call through the Python wrapper, "
          f"{c_ms * 1e3:.2f} us a launch in a loop in C (the floor)", flush=True)
    rows.append(("empty", 0, 0, py_ms))
    rows.append(("empty_c", 0, 0, c_ms))
    return rows


def cold(against: str | None = None) -> list:
    """Each configuration's kernel with L2 cold (`cold_ms` over SETS copies
    of x), beside `library_call` and the bound; with `against`, the kernel
    of another build of this library too (`_build.library`), in turns (this,
    that, that, this) after holding its output against this kernel's.
    Returns one dict per configuration and prints a line for each."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe times the CUDA kernel: no CUDA device")
    device = torch.device("cuda")
    x, rng = make_inputs(device=device)
    xs = [x] + [x.clone() for _ in range(SETS - 1)]
    seed = torch.tensor(0.25, device=device)
    earlier = _build.library(against, "overhead_probe") if against else None
    rows = []
    for n_views, n_weights, halo in CONFIGS:
        weights = make_weights(n_weights, rng, device)
        shift = seed + sum(w[0, 0] for w in weights)
        mine = lambda x_: overhead_probe(x_, seed, weights, n_views, halo)  # noqa: E731
        row = {"views": n_views, "weights": n_weights, "halo": halo,
               "bound_ms": bound_bytes(N, halo) / HBM_BYTES_PER_S * 1e3,
               "staged_mb": staged_bytes(n_views) / 1e6,
               "library_ms": cold_ms(lambda x_: library_call(x_, shift, N), xs)}
        if earlier is None:
            row["ms"] = cold_ms(mine, xs)
        else:
            theirs = lambda x_: _probe_cuda(x_, seed, weights, n_views, halo, TILE, N, earlier)  # noqa: E731
            if not all(torch.equal(a, b) for a, b in zip(mine(x), theirs(x))):
                raise RuntimeError(f"{against} and this kernel disagree at {(n_views, n_weights, halo)}")
            a1, b1, b2, a2 = cold_ms(mine, xs), cold_ms(theirs, xs), cold_ms(theirs, xs), cold_ms(mine, xs)
            row.update(ms=(a1 + a2) / 2, visits=[a1, a2], against_ms=(b1 + b2) / 2, against_visits=[b1, b2])
        rows.append(row)
        print(f"views={n_views} weights={n_weights} halo={halo}: {row['ms'] * 1e3:.2f} us with L2 cold, "
              f"{row['bound_ms'] / row['ms']:.1%} of the bound {row['bound_ms'] * 1e3:.2f} us; "
              f"staged {row['staged_mb']:.1f} MB; one PyTorch call {row['library_ms'] * 1e3:.2f} us"
              + (f"; {against}: {row['against_ms'] * 1e3:.2f} us (visits {b1 * 1e3:.2f}, {b2 * 1e3:.2f}; "
                 f"this kernel's {a1 * 1e3:.2f}, {a2 * 1e3:.2f})" if earlier else ""), flush=True)
    return rows


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m upmix_tpu_torch.ops.overhead_probe")
    p.add_argument("mode", nargs="?", default="script", choices=("script", "cold"),
                   help="script: the TPU script's protocol (run_configs); cold: each kernel with L2 cold")
    p.add_argument("--against", default=None, metavar="LIB.so",
                   help="with cold: also time the overhead_probe of this build of the library (an earlier tree's)")
    args = p.parse_args(argv)
    if args.mode == "cold":
        cold(args.against)
    else:
        run_configs()
    return 0


if __name__ == "__main__":
    sys.exit(main())
