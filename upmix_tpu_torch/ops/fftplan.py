"""Host tables of the FFT kernels (csrc/fft.cuh, omnibus.cu, pool.cu).

The kernels run FP32 FFTs of power-of-two length in shared memory:
in-place radix-4 passes (one radix-2 pass first when log2 n is odd),
decimation in frequency for the forward transform, so its bins come out
in digit-reversed order (`digit_positions`), and the exact reverse of
those passes, with conjugate twiddles, for the inverse, which takes its
bins in that order and gives samples in natural order.  Twiddles are
computed in float64 and rounded once to float32, as ops/dftmm.py rounds
its weights: `pass_twiddles(n)` lays them out pass by pass, so that the
threads of a warp read neighbouring entries, and `twiddles(n)` is the
plain table exp(-2 pi i m / n) of the two-stage split's stage 2.

Blocks up to FFT_MAX points are one transform in one thread block.
Wider blocks take the two-stage split B = N1 x N2 (`wide_split`), as
`upmix_tpu/ops/fftmm.py::make_real_banded_plan` splits them, with N2 =
WIDE_N2 columns, or B / WIDE_TILE past WIDE_TILE x WIDE_N2 points so
that one column's transform always fits a thread block: N1-point
FFTs over the N2 columns of the frame, then, per needed bin k = k1 +
N1 c, a direct sum over the columns with the combined twiddle
w_B^(k b); the inverse computes stage-2 rows only where a bin lands
(`rows`, `row_ptr`, `entries`), WIDE_KT kept bins at a time (`tile_ptr`),
and runs N1-point inverse FFTs over the columns.

The pool's kernels run another core, csrc/fft_reg.cuh, for blocks up to
FFT_MAX points (K3's csrc/pool.cu::pool_reg_kernel, the time OLA, and
K3s's forward and inverse FFT kernels in csrc/pool_spectral.cu): each
transform held in registers by a team of n / REG_RADIX threads,
REG_RADIX values a thread, through the Stockham stages of
`reg_radices`, bins and samples in natural order both ways, with its own
twiddle table (`reg_twiddles`); K3's block geometry is
`reg_pool_launch`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FFT_MAX = 16384  # widest one-block transform: 128 KB of complex float32
WIDE_N2 = 128  # least columns of the two-stage split (upmix_tpu/ops/pallas_omnibus.py: N2 = 128)
WIDE_TILE = 8192  # complex values of one block's columns in the two-stage split; the widest N1
WIDE_KT = 512  # kept bins the split's inverse masks at a time (its shared memory: 48 bytes a bin)


def launches_per_bucket(block: int) -> int:
    """Kernel launches a bucket of this block size takes per call of the
    offline or pool step: one, or two for the two-stage split."""
    return 1 if block <= FFT_MAX else 2


def radices(n: int) -> list:
    """The passes of an n-point transform, widest first: a radix-2 pass
    when log2 n is odd, then radix-4 passes."""
    log2n = int(n).bit_length() - 1
    return [2] * (log2n & 1) + [4] * (log2n >> 1)


def digit_positions(n: int) -> np.ndarray:
    """pos[k]: where the forward transform leaves bin k (and where the
    inverse takes it), i.e. csrc/fft.cuh::fft_pos."""
    k = np.arange(n)
    pos = np.zeros(n, dtype=np.int64)
    m = n
    for r in radices(n):
        m //= r
        pos += (k % r) * m
        k = k // r
    return pos


def pass_twiddles(n: int) -> np.ndarray:
    """[T, 2] float32, the twiddles of an n-point transform's passes in
    forward order (csrc/fft.cuh reads them so): for a radix-2 pass
    exp(-2 pi i u / n), u < n/2; for a radix-4 pass of span L, k = 1, 2, 3
    in turn, exp(-2 pi i k u / L), u < L/4."""
    parts = []
    L = n
    if (int(n).bit_length() - 1) & 1:
        parts.append(np.arange(n // 2) / n)
        L = n // 2
    while L >= 4:
        u = np.arange(L // 4)
        parts += [k * u / L for k in (1, 2, 3)]
        L //= 4
    ang = 2.0 * np.pi * np.concatenate(parts) if parts else np.zeros(0)
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


REG_RADIX = 16  # values a thread of csrc/fft_reg.cuh holds: the radix of every stage but the last
REG_FORWARD_THREADS = 256  # least threads a block of spectral_forward_kernel (a team of n / 16 when more)
REG_INVERSE_THREADS = 512  # least threads a block of spectral_inverse_kernel, one block a stream
POOL_REG_THREADS = 512  # threads a block of pool_reg_kernel (K3), one block a stream, two an SM
REG_SMEM = 232448  # shared memory a block may take on the H100 (227 KB)
POOL_REG_STATIC = 1024  # of it kept for pool_reg_kernel's static shared arguments (PoolArgs)


def reg_radices(n: int) -> list:
    """The stages of csrc/fft_reg.cuh's n-point transform, in order:
    radix 16 for every four bits of log2 n, then the 2, 4 or 8 points
    left; one stage of n points below 16, none for one point."""
    log2n = int(n).bit_length() - 1
    if n < REG_RADIX:
        return [n] if n > 1 else []
    return [REG_RADIX] * (log2n // 4) + ([1 << (log2n % 4)] if log2n % 4 else [])


def reg_threads(n: int) -> int:
    """Threads of one n-point transform of csrc/fft_reg.cuh (a team)."""
    return max(1, n // REG_RADIX)


def reg_round(n: int) -> int:
    """Frames spectral_inverse_kernel's block inverts at a time: nf with
    nf + ceil(nf / 2) transforms (C + i Ls of each, the Rs of each pair)
    for its teams, or one (its C + i Ls, then its Rs) with one team."""
    teams = max(REG_INVERSE_THREADS, reg_threads(n)) // reg_threads(n)
    return max(1, 2 * teams // 3)


@dataclass(frozen=True)
class RegPoolLaunch:
    """K3's launch of one bucket on the register core (csrc/pool.cu::
    pool_reg_kernel), one block a stream."""

    threads: int  # a block: whole teams of reg_threads(n), POOL_REG_THREADS or one team
    round: int  # frames a round: nf with nf + ceil(nf / 2) transforms for the teams
    pair: bool  # one team: the Rs of two frames share a transform
    smem: int  # bytes: the teams' exchange buffers, then the Rs buffer


def reg_pool_launch(n: int, kept: int) -> RegPoolLaunch:
    """K3's block for an n-point bucket (n <= FFT_MAX) keeping `kept` bins:
    POOL_REG_THREADS in teams of reg_threads(n), or 1024 threads where that
    would make two teams (4096 points: a round of two teams is one frame,
    the other team idle in its forward; four teams take two frames a
    round), or one team of n / 16 threads from 8192 points; a round of
    frames as large as its teams take, the Rs of two frames a transform.
    Each team has an exchange buffer of n + n / 16 complex values
    (csrc/fft_reg.cuh's padding), where a frame's spectrum is masked in
    place; the Rs buffer holds `kept` values for each frame of a round
    (several teams), or for two frames with one team when they fit beside
    its buffer (`pair`: their Rs share one transform), else one."""
    team = reg_threads(n)
    teams = max(1, POOL_REG_THREADS // team)
    if teams == 2:
        teams = 4
    threads = teams * team
    buffers = 8 * teams * (n + n // 16)
    if teams > 1:
        rnd = max(1, 2 * teams // 3)
        return RegPoolLaunch(threads, rnd, False, buffers + 8 * rnd * kept)
    pair = buffers + 16 * kept <= REG_SMEM - POOL_REG_STATIC
    return RegPoolLaunch(threads, 1, pair, buffers + 8 * (2 if pair else 1) * kept)


def reg_twiddles(n: int) -> np.ndarray:
    """[T, 2] float32, csrc/fft_reg.cuh's twiddles of an n-point transform
    from float64: w_16^k = exp(-2 pi i k / 16) for k < 4 (its
    butterflies'), then for each stage after the first, of radix P after
    NS points of the earlier stages, exp(-2 pi i m r / (NS P)) at [(r - 1)
    NS + m], r = 1 .. P - 1, m < NS."""
    parts, ns = [np.arange(4) / 16], 1
    for i, p in enumerate(reg_radices(n)):
        if i:
            parts += [r * np.arange(ns) / (ns * p) for r in range(1, p)]
        ns *= p
    ang = 2.0 * np.pi * np.concatenate(parts)
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def twiddles(n: int) -> np.ndarray:
    """[n, 2] float32: (cos, -sin) of 2 pi m / n, from float64."""
    ang = 2.0 * np.pi * np.arange(n) / n
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@dataclass(frozen=True)
class WideSplit:
    """The two-stage split of one wide bucket (B > FFT_MAX)."""

    n1: int
    n2: int
    cols: int  # columns per thread block (cols * n1 <= WIDE_TILE)
    kt: int  # kept bins per tile: min(K, WIDE_KT)
    rows: np.ndarray  # int32 [R]: per tile, the stage-1 rows k1 that carry one of its bins
    row_ptr: np.ndarray  # int32 [R + 1]: entries of row r at row_ptr[r] .. row_ptr[r + 1]
    entries: np.ndarray  # int32: 2 j + mirror, bin lo + j (mirror 0) or B - lo - j (mirror 1)
    tile_ptr: np.ndarray  # int32 [tiles + 1]: tile t's rows at tile_ptr[t] .. tile_ptr[t + 1]

    @property
    def groups(self) -> int:
        return self.n2 // self.cols


def inverse_bins(block: int, lo: int, kept: int):
    """(bin, j, mirror) of every nonzero bin of a Hermitian-packed inverse
    of kept bins lo .. lo + kept - 1: each kept bin, and its mirror B - k
    except at DC and Nyquist."""
    out = []
    for j in range(kept):
        k = lo + j
        out.append((k, j, 0))
        if 0 < k < block // 2:
            out.append((block - k, j, 1))
    return out


def wide_split(block: int, lo: int, kept: int) -> WideSplit:
    """The split B = N1 x N2 with N2 = max(WIDE_N2, B / WIDE_TILE), so
    that N1 <= WIDE_TILE and each block takes at least one column, and
    the inverse's stage-2 rows: only rows k1 = k mod N1 that some nonzero
    bin k lands on are computed (the row restriction of
    pallas_omnibus.py:390-396), listed per tile of kt kept bins, each
    tile's rows in order."""
    if block & (block - 1) or block <= FFT_MAX:
        raise ValueError(f"block {block}: the two-stage split takes powers of two over {FFT_MAX}")
    n2 = max(WIDE_N2, block // WIDE_TILE)
    n1 = block // n2
    kt = min(kept, WIDE_KT)
    tiles = [{} for _ in range(-(-kept // kt))]
    for k, j, mirror in inverse_bins(block, lo, kept):
        tiles[j // kt].setdefault(k % n1, []).append(2 * j + mirror)
    rows, entries, row_ptr, tile_ptr = [], [], [0], [0]
    for by_row in tiles:
        for r in sorted(by_row):
            rows.append(r)
            entries += by_row[r]
            row_ptr.append(len(entries))
        tile_ptr.append(len(rows))
    return WideSplit(
        n1=n1,
        n2=n2,
        cols=min(n2, WIDE_TILE // n1),
        kt=kt,
        rows=np.asarray(rows, np.int32),
        row_ptr=np.asarray(row_ptr, np.int32),
        entries=np.asarray(entries, np.int32),
        tile_ptr=np.asarray(tile_ptr, np.int32),
    )
