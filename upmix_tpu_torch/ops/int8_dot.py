"""Precision-rung probe: chained split-precision products at [M, K] @ [K, K].

Port of `scripts/bench_int8_dot.py` (build, the TPU kernel that timed the
bf16x3 and int8 split dots).  `int8_dot_chain(x, variant, chain, consts)`
applies `chain` times x <- apply(x), with W the orthonormal DCT-II
[K, K] split on the host (`make_consts`).  The variants are the script's
(bench_int8_dot.py:79-126), with its rounding details:

  bf16x3   xh = bf16(x), xl = bf16(x - xh); xh.wh + xh.wl + xl.wh
  bf16x1   bf16(x).wh
  int8x3   sa = max(max|x| * (1/127), 1e-30) per row, q = x * (1/sa)
           (a reciprocal, then a multiply), xh = clip(rint(q), +-127),
           xl = clip(rint((q - xh) * 254), +-127), int32 products,
           y = (phh + pcross * (1/254)) * sa * sw
  int8x3f  int8x3 at the fixed scale sa = 8/127, which clips |x| > 8
  int8x1   clip(rint(x * (1/sa))).wh * sa * sw at sa = 8/127
and two rows that are the card's own:
  fp32     x.W, FP32 on the SIMT cores: what K1-K3 do today (on the TPU
           an f32 dot was bf16x3, so this is the card's lowering of it)
  tf32x3   xh = tf32(x), xl = tf32(x - xh) (round to nearest, ties away,
           as cvt.rna); xh.wh + xh.wl + xl.wh on the tensor cores.

On a CUDA tensor `int8_dot_chain` launches `csrc/int8_dot.cu` (K = 512,
M a multiple of 32: a thread-block cluster of `cluster_size` CTAs per
32-row strip, each CTA owning 512 / size columns); on a CPU tensor it
runs `int8_dot_chain_plain`.  The
plain version is also what the kernel is held to on the card: its float32
products must run in full FP32 there
(`torch.backends.cuda.matmul.allow_tf32 = False`).

    python -m upmix_tpu_torch.ops.int8_dot check        # SNR per variant vs float64
    python -m upmix_tpu_torch.ops.int8_dot bench [variants]

`check` prints each variant's SNR after CHAIN x INNER applies against a
float64 chain, as the script's check does; `bench` times dispatches of
INNER chained calls with the script's interleaved min-of-visits protocol
and prints the best ms per dispatch, the us per apply and the share of
the unit's dense peak (the H100's: bf16 989, int8 1979, TF32 495, FP32 67
TFLOP/s), at M = 512 and at M = 4224 (a 32-row strip for each of the 132
SMs).  Both run on the card unless `--cpu` is given (check only).  The
BENCH_M / BENCH_CHAIN / BENCH_INNER / BENCH_VISITS / BENCH_REPS variables
override the sizes as in the script.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from upmix_tpu_torch.ops import _build

K_KERNEL = 512  # csrc/int8_dot.cu: K
ROWS = 32  # csrc/int8_dot.cu: R, rows per strip
SMS = 132  # an H100 SXM
CLUSTER_SIZES = (8, 4, 2, 1)  # CTAs per strip the kernel takes (8: the portable maximum)
M_DEFAULT, CHAIN, INNER, VISITS, REPS = 512, 64, 10, 12, 3

TPU_VARIANTS = ("bf16x3", "bf16x1", "int8x3", "int8x3f", "int8x1")
CARD_VARIANTS = ("fp32", "tf32x3")
VARIANTS = TPU_VARIANTS + CARD_VARIANTS
# The kernel's variant codes (csrc/int8_dot.cu: enum Variant).
_CODES = {"fp32": 0, "bf16x1": 1, "bf16x3": 2, "tf32x3": 3, "int8x1": 4, "int8x3": 5, "int8x3f": 6}
_COUNTED = {v: f"K4.{v}" for v in _CODES}  # the launch counter's key of each variant (utils/tracing.py)
PASSES = {"bf16x3": 3, "bf16x1": 1, "int8x3": 3, "int8x3f": 3, "int8x1": 1, "fp32": 1, "tf32x3": 3}
UNIT = {"bf16x3": "bf16", "bf16x1": "bf16", "int8x3": "int8", "int8x3f": "int8", "int8x1": "int8",
        "fp32": "fp32", "tf32x3": "tf32"}
# Dense peaks of an H100 SXM at 700 W (NVIDIA's data sheet), FLOP/s.
PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}

_FIXED_SCALE = 8.0 / 127.0

# How closely the kernel and its plain version agree, as max |a - b| /
# max |b|, and why.  The int8 rungs take the plain version's float ops in
# its order on exact integer products: bit for bit at any chain (EXACT).
# The float rungs differ in each product's own sum order (and the tensor
# cores' accumulation): after one apply at M = 512 on an H100 by 6.4e-7
# (bf16x3, bf16x1), 1.1e-6 (fp32) and 1.7e-6 (tf32x3), held at
# APPLY_TOLERANCE.  Over a chain a one-ulp difference can flip one rounding
# of the next step's split and the chain carries it on: after 64 applies
# 5.5e-6 (fp32), 6.6e-5 (bf16x3), 8.7e-5 (tf32x3) and 2.3e-2 (bf16x1,
# whose split moves an element by a bf16 ulp), held at about three times
# that by CHAIN_TOLERANCE, a coarse check.
EXACT = ("int8x3", "int8x3f", "int8x1")
APPLY_TOLERANCE = 5e-6
CHAIN_TOLERANCE = {"fp32": 2e-5, "bf16x3": 2e-4, "tf32x3": 3e-4, "bf16x1": 0.07}


def make_weights(K: int = K_KERNEL) -> np.ndarray:
    """Orthonormal DCT-II [K, K] float32: chained applications stay O(1)."""
    n = np.arange(K)
    w = np.cos(np.pi * (n[:, None] + 0.5) * n[None, :] / K) * np.sqrt(2.0 / K)
    w[:, 0] *= 1.0 / np.sqrt(2.0)
    return w.astype(np.float32)


def split_bf16_np(w: np.ndarray):
    """(hi, lo) bfloat16 CPU tensors of a float32 array (numpy has no
    bfloat16): hi = bf16(w), lo = bf16(w - hi), both rounded to nearest even."""
    w = torch.from_numpy(np.asarray(w, np.float32))
    h = w.to(torch.bfloat16)
    return h, (w - h.float()).to(torch.bfloat16)


def split_int8_np(w: np.ndarray, axis: int = 0):
    """(hi, lo, scale): int8 hi and lo parts with per-column (axis 0) scales."""
    s = np.max(np.abs(w), axis=axis, keepdims=True).astype(np.float64) / 127.0
    s = np.where(s == 0.0, 1.0, s)
    h = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    r = w - s * h
    l = np.clip(np.rint(r / (s / 254.0)), -127, 127).astype(np.int8)
    return h, l, s.astype(np.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def split_tf32_np(w: np.ndarray):
    """(hi, lo) float32 CPU tensors holding TF32 values: hi = tf32(w), lo =
    tf32(w - hi), rounded as `tf32_round`."""
    w = torch.from_numpy(np.asarray(w, np.float32))
    h = tf32_round(w)
    return h, tf32_round(w - h)


def pack_fragments(w: torch.Tensor, per_reg: int) -> torch.Tensor:
    """W [K, N] in mma.sync B-fragment order, as csrc/int8_dot.cu reads it,
    n-tile major (a CTA's columns are one contiguous range at any cluster
    size): for n-tile nt and k-step ks, lane g*4 + t holds its two 32-bit
    registers of `per_reg` elements each (bf16 2, int8 4, tf32 1), element
    (half, v) being W[ks*8*per_reg + half*4*per_reg + t*per_reg + v, nt*8 + g]."""
    K, N = w.shape
    kt = 8 * per_reg
    return w.reshape(K // kt, 2, 4, per_reg, N // 8, 8).permute(4, 0, 5, 2, 1, 3).contiguous()


def cluster_size(M: int, resident, at_once, n_sm: int = SMS) -> int:
    """CTAs per 32-row strip of the kernel, from M and what the card says
    of each size (`card_clusters`): among CLUSTER_SIZES with strips x size
    <= n_sm, the smallest whose CTAs keep their W columns resident in
    shared memory (`resident(cs)`) and whose clusters all run at once
    (`at_once(cs)` >= strips); else the largest resident one; else the
    largest whose clusters all run at once; else 1.  A smaller cluster
    exchanges x with fewer peers and waits at a cheaper barrier; W read
    from L2 each k-step, or a second wave of clusters, costs more than
    either (PERF.md, section 6: each rung timed at every size)."""
    strips = M // ROWS
    sizes = [cs for cs in CLUSTER_SIZES if strips * cs <= n_sm]  # largest first
    held = [cs for cs in sizes if resident(cs)]
    for pick in ([cs for cs in held if at_once(cs) >= strips][-1:], held[:1],
                 [cs for cs in sizes if at_once(cs) >= strips][:1]):
        if pick:
            return pick[0]
    return 1


_CARD = {}


def card_clusters(variant: str, device="cuda"):
    """(resident, at_once) of `variant`'s kernel on the card `device`, for
    `cluster_size`: whether a cluster size keeps W resident, and how many
    of its clusters the card runs at once (cudaOccupancyMaxActiveClusters);
    each asked once."""
    _check_variant(variant)

    def ask(fn, cs):
        key = (fn, variant, cs)
        if key not in _CARD:
            args = (_CODES[variant], cs) if fn == "dot_chain_resident" else (ROWS, _CODES[variant], cs)
            with _build.kernels(device) as k:
                n = k.query(fn, *args)
            if n < 0:
                raise RuntimeError(f"{fn} failed for {variant} at cluster size {cs}")
            _CARD[key] = n
        return _CARD[key]

    return (lambda cs: ask("dot_chain_resident", cs) == 1), (lambda cs: ask("dot_chain_clusters", cs))


class DotConsts(NamedTuple):
    """The split weights of one variant: `weights` as the script's consts
    (natural layout, for the plain version), `frags` the kernel's operands
    (hi, lo or None, int8 column scales or None)."""

    variant: str
    weights: tuple
    frags: tuple


def make_consts(variant: str, device="cuda", K: int = K_KERNEL) -> DotConsts:
    """Split the DCT weights for `variant` on the host and move them to `device`."""
    _check_variant(variant)
    device = torch.device(device)
    w = make_weights(K)
    if variant == "fp32":
        weights = (torch.from_numpy(w),)
        frags = (weights[0], None, None)  # row-major, as the fp32 kernel reads it
    elif variant in ("bf16x3", "bf16x1"):
        h, l = split_bf16_np(w)
        weights = (h, l) if variant == "bf16x3" else (h,)
        frags = (pack_fragments(h, 2), pack_fragments(l, 2) if variant == "bf16x3" else None, None)
    elif variant == "tf32x3":
        h, l = split_tf32_np(w)
        weights = (h, l)
        frags = (pack_fragments(h, 1), pack_fragments(l, 1), None)
    else:
        h, l, s = (torch.from_numpy(a) for a in split_int8_np(w, axis=0))
        weights = (h, l, s) if variant != "int8x1" else (h, s)
        frags = (pack_fragments(h, 4), pack_fragments(l, 4) if variant != "int8x1" else None, s.reshape(-1))
    move = lambda t: None if t is None else t.to(device).contiguous()  # noqa: E731
    return DotConsts(variant, tuple(move(t) for t in weights), tuple(move(t) for t in frags))


def _check_variant(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")


def _check(x: torch.Tensor, variant: str, chain: int, consts: DotConsts):
    _check_variant(variant)
    if consts.variant != variant:
        raise ValueError(f"consts were made for {consts.variant!r}, not {variant!r}")
    K = consts.weights[0].shape[0]
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"expected x [M, {K}], got {tuple(x.shape)}")
    if chain < 0:
        raise ValueError(f"chain must be >= 0, got {chain}")


def int8_dot_chain(x: torch.Tensor, variant: str, chain: int, consts: DotConsts) -> torch.Tensor:
    """x [M, K] float32 -> `chain` applies of `variant` (see the module
    docstring).  The kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return int8_dot_chain_plain(x, variant, chain, consts)
    if x.device.type != "cuda":
        raise ValueError(f"int8_dot_chain runs on cpu or cuda, not {x.device}")
    return dot_cuda(x, variant, chain, consts)


def dot_cuda(x: torch.Tensor, variant: str, chain: int, consts: DotConsts, cluster: int | None = None) -> torch.Tensor:
    """The kernel's launch: `cluster` CTAs per strip, one of CLUSTER_SIZES,
    by default `cluster_size` for M on this card (the result does not
    depend on it; the tests and chip_smoke.py's sweep set it).  Counted
    under "K4.<variant>"."""
    _check(x, variant, chain, consts)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the dot-chain kernel takes a contiguous float32 x")
    M, K = x.shape
    if K != K_KERNEL or M % ROWS:
        raise ValueError(f"the dot-chain kernel takes K = {K_KERNEL} and M a multiple of {ROWS}, got [{M}, {K}]")
    if any(t is not None and t.device != x.device for t in consts.frags):
        raise ValueError("consts must lie on x's device")
    hi, lo, sw = consts.frags
    if cluster is None:
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        cluster = cluster_size(M, *card_clusters(variant, x.device), n_sm)
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got {cluster}")
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with _build.kernels(x.device) as k:
        out = torch.empty_like(x)
        k.launch(_COUNTED[variant], "dot_chain", x.data_ptr(), out.data_ptr(), ptr(hi), ptr(lo), ptr(sw), M,
                 _CODES[variant], chain, cluster)
    return out


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8-valued operands, as float64 (its sums
    stay far below 2^53)."""
    return a.double() @ b.double()


def _apply_plain(x: torch.Tensor, variant: str, w: tuple) -> torch.Tensor:
    mm = torch.matmul
    if variant == "fp32":
        return mm(x, w[0])
    if variant in ("bf16x3", "bf16x1"):
        wh = w[0].float()
        xh = x.to(torch.bfloat16).float()
        if variant == "bf16x1":
            return mm(xh, wh)
        xl = (x - xh).to(torch.bfloat16).float()
        return mm(xh, wh) + mm(xh, w[1].float()) + mm(xl, wh)
    if variant == "tf32x3":
        xh = tf32_round(x)
        xl = tf32_round(x - xh)
        return mm(xh, w[0]) + mm(xh, w[1]) + mm(xl, w[0])
    wh, sw = w[0], w[-1]
    if variant == "int8x3":
        sa = torch.clamp_min(x.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0), 1e-30)
    else:
        sa = torch.full((x.shape[0], 1), _FIXED_SCALE, dtype=torch.float32, device=x.device)
    q = x * torch.reciprocal(sa)
    xh = torch.clamp(torch.round(q), -127.0, 127.0)
    if variant == "int8x1":
        return _int_product(xh, wh).float() * sa * sw
    xl = torch.clamp(torch.round((q - xh) * 254.0), -127.0, 127.0)
    phh = _int_product(xh, wh).float()
    pcross = (_int_product(xh, w[1]) + _int_product(xl, wh)).float()  # exact: |pcross| < 2^24 at K <= 512
    return (phh + pcross * (1.0 / 254.0)) * sa * sw


def int8_dot_chain_plain(x: torch.Tensor, variant: str, chain: int, consts: DotConsts) -> torch.Tensor:
    """The plain PyTorch version: the same splits, roundings and float32
    sums in the same order; the products' own sums run in torch.matmul's
    order (int8 products exactly, in float64)."""
    _check(x, variant, chain, consts)
    x = x.float()
    for _ in range(chain):
        x = _apply_plain(x, variant, consts.weights)
    return x


def flop_per_apply(variant: str, M: int, K: int = K_KERNEL) -> float:
    return 2.0 * M * K * K * PASSES[variant]


def snr_db(ref: np.ndarray, y: np.ndarray) -> float:
    """The script's SNR: -20 log10 of the relative RMS error."""
    err = np.sqrt(np.mean((y - ref) ** 2) / max(np.mean(ref**2), 1e-300))
    return float(-20 * np.log10(max(err, 1e-300)))


def start_x(M: int, K: int = K_KERNEL) -> np.ndarray:
    """The script's input: seeded normal noise of standard deviation 4."""
    return (np.random.default_rng(0).standard_normal((M, K)) * 4.0).astype(np.float32)


def check(variants=VARIANTS, M: int = M_DEFAULT, K: int = K_KERNEL, chain: int = CHAIN, inner: int = INNER,
          device="cuda") -> dict:
    """Each variant's SNR after chain x inner applies against a float64 chain."""
    device = torch.device(device)
    x = start_x(M, K)
    w = torch.from_numpy(make_weights(K).astype(np.float64)).to(device)
    ref = torch.from_numpy(x.astype(np.float64)).to(device)
    for _ in range(chain * inner):
        ref = ref @ w
    ref = ref.cpu().numpy()
    result = {}
    for variant in variants:
        consts = make_consts(variant, device, K)
        y = torch.from_numpy(x).to(device)
        for _ in range(inner):
            y = int8_dot_chain(y, variant, chain, consts)
        result[variant] = snr_db(ref, y.double().cpu().numpy())
        print(f"{variant:8s} chain of {chain * inner}: SNR {result[variant]:6.1f} dB", flush=True)
    return result


def bench(variants=VARIANTS, Ms=(M_DEFAULT, SMS * ROWS), chain: int = CHAIN, inner: int = INNER,
          visits: int = VISITS, reps: int = REPS) -> dict:
    """Best ms per dispatch of `inner` chained calls, per variant and M,
    interleaved min-of-visits on the card; {(variant, M): (ms, us/apply,
    share of the unit's peak)}."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench times the CUDA kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    consts = {v: make_consts(v, device) for v in variants}
    result = {}
    for M in Ms:
        x0 = torch.from_numpy(start_x(M)).to(device)

        def dispatch(v):
            y = x0
            for _ in range(inner):
                y = int8_dot_chain(y, v, chain, consts[v])
            return y

        for v in variants:
            dispatch(v)
        torch.cuda.synchronize()
        best = {v: float("inf") for v in variants}
        for _ in range(visits):
            for v in variants:
                for _ in range(reps):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    dispatch(v)
                    end.record()
                    end.synchronize()
                    best[v] = min(best[v], start.elapsed_time(end))
        print(f"shape [{M},{K_KERNEL}]@[{K_KERNEL},{K_KERNEL}], {chain} applies/call x {inner} calls/dispatch",
              flush=True)
        for v in variants:
            t_apply = best[v] * 1e-3 / (chain * inner)
            share = flop_per_apply(v, M) / t_apply / PEAK[UNIT[v]]
            result[(v, M)] = (best[v], t_apply * 1e6, share)
            print(f"{v:8s} min {best[v]:8.3f} ms/dispatch  {t_apply * 1e6:7.2f} us/apply"
                  f"  ({share * 100:5.1f}% of {UNIT[v]} peak)", flush=True)
    return result


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in args
    args = [a for a in args if a != "--cpu"]
    mode = args.pop(0) if args and args[0] in ("check", "bench") else "bench"
    for v in args:
        _check_variant(v)
    variants = tuple(args) or VARIANTS
    env = lambda name, default: int(os.environ.get(name, default))  # noqa: E731
    chain, inner = env("BENCH_CHAIN", CHAIN), env("BENCH_INNER", INNER)
    if mode == "check":
        device = "cpu" if cpu else "cuda"
        if device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("error: no CUDA device (pass --cpu to check the plain versions)")
        check(variants, M=env("BENCH_M", M_DEFAULT), chain=chain, inner=inner, device=device)
        return 0
    if cpu:
        raise SystemExit("error: bench times the card; --cpu applies to check only")
    Ms = (env("BENCH_M", M_DEFAULT),) if "BENCH_M" in os.environ else (M_DEFAULT, SMS * ROWS)
    bench(variants, Ms, chain, inner, env("BENCH_VISITS", VISITS), env("BENCH_REPS", REPS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
