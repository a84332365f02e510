"""The FFT kernels' factorization (csrc/fft.cuh, omnibus.cu, pool.cu,
fft_reg.cuh), stated in torch float64 from the plans' own tables, against
the plain versions and the JAX package's two-stage banded transform.

The statement follows the kernels step by step: the radix-2/radix-4
passes in place with the plans' float32 twiddle tables, bins read at
their digit-reversed positions, the packed-stereo forward transform and
its unpacking at the kept bins, the Hermitian packing of C + i Ls (and
of Rs of two frames) into one inverse, the two-stage split B = N1 x N2
of the 65536 bucket with its stage-2 sums over the columns and its
stage-2 rows only where a bin lands, and the pool kernel's gate (frames
from the first ready hop, the carry added at it).  The pool kernel's
buckets up to FFT_MAX points run the register core (csrc/fft_reg.cuh:
`reg_fft` below, from `reg_twiddles`), the mask and the inverses on each
frame in turn, a round of frames at a time (`reg_pool_step`).  Only the
twiddles' rounding to float32 separates it from float64 FFTs: >= 120 dB
against the plain versions run in float64.  The JAX package's two-stage
transform runs in float32, so the bar there is 100 dB.
"""

import dataclasses

import numpy as np
import pytest
import torch

from helpers import snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.offline import _plan_buckets as jax_plan_buckets
from upmix_tpu.ops.fftmm import irfft_real_banded, make_real_banded_plan, rfft_real_banded
from upmix_tpu.ops.pallas_omnibus import make_bd_sub
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.offline import _plan_buckets, plans_from_numpy
from upmix_tpu_torch.ops.fftplan import (
    FFT_MAX,
    WIDE_N2,
    WIDE_TILE,
    digit_positions,
    inverse_bins,
    REG_RADIX,
    POOL_REG_STATIC,
    REG_SMEM,
    pass_twiddles,
    radices,
    reg_pool_launch,
    reg_radices,
    reg_round,
    reg_threads,
    reg_twiddles,
    wide_split,
)
from upmix_tpu_torch.ops.framing import frame_signal, overlap_add
from upmix_tpu_torch.ops.mask import mask_sum
from upmix_tpu_torch.ops.omnibus import make_omnibus_plan, make_wide_tables, omnibus_lcr_batch_plain
from upmix_tpu_torch.ops.pool import make_pool_plan, pool_step_lcr_plain

BENCH = ([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], dict(sr=44100.0, max_block_size=65536))
POOL = ([0.0, 500.0, 2000.0, 8000.0], dict(sr=48000.0, hw_block_size=2048))
CHUNK = 65536  # the smallest chunk of the bench config (the LCM of its blocks)


def _csnr(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    return snr_db(np.concatenate([ref.real, ref.imag]), np.concatenate([got.real, got.imag]))


def _cplx(table) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(table), dtype=torch.float64)
    return torch.complex(t[:, 0], t[:, 1])


def with_split_tables(buckets) -> tuple:
    """CPU buckets (offline or pool), each over FFT_MAX given the two-stage
    split's tables, which only a CUDA plan builds."""
    out = []
    for b in buckets:
        if b.block > FFT_MAX:
            wide = make_wide_tables(b.block, b.hop, b.lo, b.kept, "cpu")
            b = dataclasses.replace(b, twiddles=torch.as_tensor(pass_twiddles(wide.n1)), wide=wide)
        out.append(b)
    return tuple(out)


def cpu_plan(bucket_plans) -> tuple:
    """plans_from_numpy on the CPU, with the split's tables attached."""
    return with_split_tables(plans_from_numpy(bucket_plans, "cpu"))


def _passes(n: int):
    """(radix, span L, offset into pass_twiddles) of each forward pass."""
    out, L, off = [], n, 0
    for r in radices(n):
        out.append((r, L, off))
        off += (r - 1) * (L // r)
        L //= r
    return out


def fft_forward(z: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """csrc/fft.cuh::fft_forward over the last axis: in place, bins left
    digit-reversed."""
    n = z.shape[-1]
    for r, L, off in _passes(n):
        M = L // r
        x = z.reshape(*z.shape[:-1], n // L, r, M)
        if r == 2:
            a, b = x[..., 0, :], x[..., 1, :]
            y = [a + b, (a - b) * tw[off : off + M]]
        else:
            s02, d02 = x[..., 0, :] + x[..., 2, :], x[..., 0, :] - x[..., 2, :]
            s13, d13 = x[..., 1, :] + x[..., 3, :], x[..., 1, :] - x[..., 3, :]
            y = [s02 + s13, (d02 - 1j * d13) * tw[off : off + M],
                 (s02 - s13) * tw[off + M : off + 2 * M], (d02 + 1j * d13) * tw[off + 2 * M : off + 3 * M]]
        z = torch.stack(y, dim=-2).reshape(z.shape)
    return z


def fft_inverse(z: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """csrc/fft.cuh::fft_inverse: the forward passes undone in reverse
    order with conjugate twiddles, unnormalised; bins in digit-reversed
    order, samples out in natural order."""
    n = z.shape[-1]
    for r, L, off in reversed(_passes(n)):
        M = L // r
        x = z.reshape(*z.shape[:-1], n // L, r, M)
        if r == 2:
            a, b = x[..., 0, :], x[..., 1, :] * tw[off : off + M].conj()
            y = [a + b, a - b]
        else:
            y0 = x[..., 0, :]
            y1, y2, y3 = (x[..., k, :] * tw[off + (k - 1) * M : off + k * M].conj() for k in (1, 2, 3))
            s02, d02, s13, d13 = y0 + y2, y0 - y2, y1 + y3, y1 - y3
            y = [s02 + s13, d02 + 1j * d13, s02 - s13, d02 - 1j * d13]
        z = torch.stack(y, dim=-2).reshape(z.shape)
    return z


def hermitian(u: torch.Tensor, v: torch.Tensor, B: int, lo: int) -> torch.Tensor:
    """Full spectra [..., B] of two real outputs packed as u + i v, from
    their kept bins [..., K] (only the real parts at DC and Nyquist)."""
    K = u.shape[-1]
    k = torch.arange(lo, lo + K)
    edge = (k == 0) | (2 * k == B)
    w = torch.zeros((*u.shape[:-1], B), dtype=torch.complex128)
    w[..., k] = torch.where(edge, torch.complex(u.real, v.real), u + 1j * v)
    mid = ~edge
    w[..., B - k[mid]] = u[..., mid].conj() + 1j * v[..., mid].conj()
    return w


def unpack_mask(Z: torch.Tensor, Zm: torch.Tensor, gains: torch.Tensor):
    """L and R at the kept bins from the packed spectrum, through the mask:
    (C, Ls, Rs) complex [..., K]."""
    XL = (Z + Zm.conj()) / 2
    XR = (Z - Zm.conj()) / 2j
    c_re, c_im, l_re, l_im, r_re, r_im = mask_sum(XL.real, XL.imag, XR.real, XR.imag, gains)
    return torch.complex(c_re, c_im), torch.complex(l_re, l_im), torch.complex(r_re, r_im)


def pair_rs(rs: torch.Tensor) -> torch.Tensor:
    """Rs of frames 2j and 2j + 1 as (u, v) of one transform; an odd last
    frame goes alone.  rs: [S, F, K] -> ([S, ceil(F/2), K] twice)."""
    F = rs.shape[1]
    if F % 2:
        rs = torch.cat([rs, torch.zeros_like(rs[:, :1])], dim=1)
    return rs[:, 0::2], rs[:, 1::2]


def unpair(y: torch.Tensor, F: int) -> torch.Tensor:
    """The real outputs of pair_rs's transforms: [S, ceil(F/2), B] -> [S, F, B]."""
    return torch.stack([y.real, y.imag], dim=2).flatten(1, 2)[:, :F]


def single_stage_frames(frames: torch.Tensor, b) -> torch.Tensor:
    """Windowed inverse frames [S, 3, F, B] of one bucket (B <= FFT_MAX)
    from frames [S, 2, F, B], as omnibus.cu computes them (K1, K2)."""
    B, K, lo = b.block, b.kept, b.lo
    tw = _cplx(b.twiddles)
    pos = torch.as_tensor(digit_positions(B))
    k = torch.arange(lo, lo + K)
    aw, sw = b.analysis_window.double(), b.synthesis_window.double()
    Z = fft_forward(torch.complex(frames[:, 0] * aw, frames[:, 1] * aw), tw)
    c, ls, rs = unpack_mask(Z[..., pos[k]], Z[..., pos[(B - k) % B]], b.gains.double())
    F = frames.shape[2]

    def inverse(u, v):
        w = torch.zeros((*u.shape[:-1], B), dtype=torch.complex128)
        w[..., pos] = hermitian(u, v, B, lo)
        return fft_inverse(w, tw) * (sw / B)

    y01 = inverse(c, ls)
    y2 = unpair(inverse(*pair_rs(rs)), F)
    return torch.stack([y01.real, y01.imag, y2], dim=1)


def two_stage_frames(frames: torch.Tensor, b) -> torch.Tensor:
    """The same for a bucket over FFT_MAX through the two-stage split."""
    B, K, lo, w = b.block, b.kept, b.lo, b.wide
    n1, n2 = w.n1, w.n2
    tw1, twB = _cplx(b.twiddles), _cplx(w.stage2)
    pos1 = torch.as_tensor(digit_positions(n1))
    aw, sw = b.analysis_window.double(), b.synthesis_window.double()
    z = torch.complex(frames[:, 0] * aw, frames[:, 1] * aw)  # [S, F, B]
    cols = z.unflatten(-1, (n1, n2)).transpose(-1, -2)  # [S, F, b, a]: z[a * N2 + b]
    A = fft_forward(cols, tw1)  # column b's N1-point FFT, rows digit-reversed
    bvec = torch.arange(n2)

    def bin_value(kk):  # sum_b A[kk mod N1, b] w_B^(kk b): launch 1's partials, summed
        return (A[..., pos1[kk % n1]] * twB[(kk[None, :] * bvec[:, None]) % B]).sum(dim=-2)

    k = torch.arange(lo, lo + K)
    c, ls, rs = unpack_mask(bin_value(k), bin_value((B - k) % B), b.gains.double())
    rows, ptr, ent = (t.tolist() for t in (w.rows, w.row_ptr, w.entries))

    def inverse(u, v):
        U = torch.zeros((*u.shape[:-1], n2, n1), dtype=torch.complex128)
        for r, row in enumerate(rows):  # stage 2 backwards, only where a bin lands, a tile of bins at a time
            acc = 0
            for e in ent[ptr[r] : ptr[r + 1]]:
                j, mirror = e >> 1, e & 1
                kk = lo + j
                edge = kk == 0 or 2 * kk == B
                if edge:
                    val = torch.complex(u[..., j].real, v[..., j].real)
                elif mirror:
                    val, kk = u[..., j].conj() + 1j * v[..., j].conj(), B - kk
                else:
                    val = u[..., j] + 1j * v[..., j]
                acc = acc + val[..., None] * twB[(kk * bvec) % B].conj()
            U[..., :, pos1[row]] += acc
        y = fft_inverse(U, tw1).transpose(-1, -2).flatten(-2)  # sample a * N2 + b
        return y * (sw / B)

    y01 = inverse(c, ls)
    y2 = unpair(inverse(*pair_rs(rs)), frames.shape[2])
    return torch.stack([y01.real, y01.imag, y2], dim=1)


def bucket_frames(frames, b):
    return single_stage_frames(frames, b) if b.block <= FFT_MAX else two_stage_frames(frames, b)


def pool_bucket_frames(frames, b):
    """The pool kernel's (K3's) frames: on the register core up to FFT_MAX
    points (`reg_stage_frames`), through the two-stage split above."""
    return reg_stage_frames(frames, b) if b.block <= FFT_MAX else two_stage_frames(frames, b)


@pytest.fixture(scope="module")
def bench_plan():
    cfg = UpmixConfig.make(BENCH[0], **BENCH[1])
    return make_omnibus_plan(cpu_plan(_plan_buckets(cfg, CHUNK)), CHUNK)


def test_positions_and_tables():
    # fft_forward is a DFT with bins at digit_positions; fft_inverse is its
    # inverse times n, with the float32 tables.
    rng = np.random.default_rng(0)
    for n in (2, 4, 8, 32, 128, 512, 2048):
        z = torch.as_tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n))
        tw = _cplx(pass_twiddles(n))
        Z = fft_forward(z, tw)
        pos = torch.as_tensor(digit_positions(n))
        assert sorted(pos.tolist()) == list(range(n))
        assert _csnr(torch.fft.fft(z).numpy(), Z[pos].numpy()) > 135
        assert _csnr(z.numpy() * n, fft_inverse(Z, tw).numpy()) > 135
        assert pass_twiddles(n).dtype == np.float32


@pytest.mark.parametrize("block", [256, 1024, 4096, 16384, 65536])
def test_factorization_matches_plain_offline(bench_plan, block):
    # Every bucket of bench.py's config, the 65536 one through the
    # two-stage split, against omnibus_lcr_batch_plain in float64.
    (b,) = [b for b in bench_plan.buckets if b.block == block]
    _check_offline_bucket(b, CHUNK, 2, block)


def test_factorization_tiled_split():
    # A split bucket whose inverse takes its kept bins in several tiles of
    # fftplan.WIDE_KT (a first band to 400 Hz at 8 kHz and 32768 points:
    # K = 2049), against the plain version in float64.
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=32768)
    (b,) = [b for b in cpu_plan(_plan_buckets(cfg, 32768)) if b.block == 32768]
    assert b.kept == 2049 and b.wide.tiles == 5
    _check_offline_bucket(b, 32768, 1, 3)


@pytest.mark.parametrize("log2b", range(17, 23))
def test_wide_split_grows_n2(log2b):
    # N2 = max(128, B / WIDE_TILE): N1 <= WIDE_TILE and a thread block
    # takes at least one whole column at every block the config admits.
    B = 2**log2b
    w = wide_split(B, 3, 40)
    assert w.n1 * w.n2 == B and w.n2 == max(WIDE_N2, B // WIDE_TILE)
    assert 2 <= w.n1 <= WIDE_TILE and w.cols >= 1 and w.cols * w.n1 <= WIDE_TILE
    assert w.groups * w.cols == w.n2
    # Every bin of the inverse sits in one row of its tile.
    assert sorted(int(e) for e in w.entries) == sorted(2 * j + m for _, j, m in inverse_bins(B, 3, 40))
    t = make_wide_tables(B, B // 4, 3, 40, "cpu")
    assert (t.n1, t.n2, t.groups) == (w.n1, w.n2, w.groups) and t.stage2.shape == (B, 2)


def test_wide_split_limit_raises_at_plan_build():
    # A thread block of the split owns whole rows of N2 positions: a hop
    # that N2 does not divide raises when the plan is built, naming N2.
    with pytest.raises(NotImplementedError, match="N2 = 256"):
        make_wide_tables(2**21, 128 * 3, 0, 8, "cpu")
    with pytest.raises(ValueError):
        wide_split(16384, 0, 8)


def _check_offline_bucket(b, chunk: int, S: int, seed: int) -> None:
    sub = make_omnibus_plan([b], chunk)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((S, 2, chunk + b.spill)))
    F = chunk // b.hop
    rec = bucket_frames(frame_signal(x[..., : chunk + b.spill], b.block, b.hop, F), b)
    got = overlap_add(rec, b.hop)
    ref = torch.cat(omnibus_lcr_batch_plain(x, sub), dim=-1)
    for o in range(3):
        assert snr_db(ref[:, o].numpy(), got[:, o].numpy()) >= 120.0, (b.block, o)


@pytest.mark.parametrize("hw", [2048, 8192])
@pytest.mark.parametrize("hops", [1, 3])
def test_factorization_matches_plain_pool(hops, hw):
    # The pool's buckets with the pool kernel's gate: frames from the first
    # ready hop i0 on, the carry added at i0 * hw; positions past hops * hw
    # are the new carry.  Up to FFT_MAX points on the register core; at hw
    # 8192 the 32768 bucket takes the two-stage split.
    cfg = UpmixConfig.streaming(POOL[0], sr=POOL[1]["sr"], hw_block_size=hw)
    S = 4
    plan = make_pool_plan(cfg, hw, S, device="cpu")
    plan = dataclasses.replace(plan, buckets=with_split_tables(plan.buckets))
    K = plan.warmup
    rng = np.random.default_rng(hops)
    hist = torch.as_tensor(rng.standard_normal((S, 2, (K - 1 + hops) * hw)))
    t = torch.tensor([1, K - 1, K, K + 3], dtype=torch.int32)
    carries = [torch.as_tensor(rng.standard_normal((S, 3, b.block))) for b in plan.buckets]
    ref, ref_c = pool_step_lcr_plain(hist, t, carries, plan, hops)
    i0 = (K - t).clamp(0, hops)
    out = torch.zeros((S, 3, hops * hw), dtype=torch.float64)
    for b, carry, rc in zip(plan.buckets, carries, ref_c):
        F = hops * b.passes
        frames = frame_signal(hist[..., : (F - 1) * b.hop + b.block], b.block, b.hop, F)
        ready = (torch.arange(F)[None, :] >= (i0 * b.passes)[:, None])[:, None, :, None]
        rec = pool_bucket_frames(torch.where(ready, frames, 0.0), b) * ready  # not-ready frames: zeros
        acc = torch.nn.functional.pad(overlap_add(rec, b.hop), (0, b.hop))  # [S, 3, hops * hw + B]
        for s in range(S):
            c0 = int(i0[s]) * hw
            acc[s, :, c0 : c0 + b.block] += carry[s]
        out += acc[..., : hops * hw]
        assert snr_db(rc.numpy(), acc[..., hops * hw :].numpy()) >= 120.0
    assert torch.equal(out == 0, ref == 0)
    assert snr_db(ref.numpy(), out.numpy()) >= 120.0


def test_two_stage_split_matches_jax_banded():
    # The 65536 bucket: the row count of the JAX kernel's stage-1
    # restriction, and the split's forward and inverse against
    # fftmm.rfft_real_banded / irfft_real_banded (float32) on one channel.
    jcfg = JaxUpmixConfig.make(BENCH[0], **BENCH[1])
    (jp,) = [p for p in jax_plan_buckets(jcfg, CHUNK) if p.block_size == 65536]
    (b,) = cpu_plan([jp])
    w = b.wide
    assert (w.n1, b.block // w.n1) == (65536 // 128, 128)
    positive = {w.rows[r].item() for r in range(len(w.rows))
                for e in w.entries[w.row_ptr[r] : w.row_ptr[r + 1]].tolist() if not e & 1}
    R = make_bd_sub(jp, 1, (0,)).R
    assert -(-(max(positive) + 1) // 8) * 8 == R

    rng = np.random.default_rng(7)
    xl = rng.standard_normal(b.block)
    frames = torch.as_tensor(np.stack([xl, np.zeros_like(xl)]))[None, :, None, :]  # [1, 2, 1, B]
    lo, hi = b.lo, b.lo + b.kept - 1
    rp = make_real_banded_plan(b.block, lo, hi, n1=w.n1)
    jre, jim = rfft_real_banded((xl * jp.analysis_window).astype(np.float32), rp)
    bins = np.arange(rp.n1)[:, None] + rp.n1 * np.asarray(rp.cols)[None, :]
    keep = (bins >= lo) & (bins <= hi)
    jax_x = (np.asarray(jre, np.float64) + 1j * np.asarray(jim, np.float64))[keep][np.argsort(bins[keep])]

    # Forward: the split's L spectrum at the kept bins (R = 0, so X_L = Z).
    z = torch.complex(frames[:, 0] * b.analysis_window.double(), frames[:, 1])
    A = fft_forward(z.unflatten(-1, (w.n1, WIDE_N2)).transpose(-1, -2), _cplx(b.twiddles))
    k = torch.arange(lo, hi + 1)
    pos1 = torch.as_tensor(digit_positions(w.n1))
    twB = _cplx(w.stage2)
    got = (A[..., pos1[k % w.n1]] * twB[(k[None, :] * torch.arange(WIDE_N2)[:, None]) % b.block]).sum(-2)
    assert _csnr(jax_x, got[0, 0].numpy()) >= 100.0

    # Inverse: one real output from those bins through the split (unwindowed)
    # against irfft_real_banded of the same half spectrum.
    half = np.zeros((rp.n1, len(rp.cols)), np.complex128)
    half[keep] = jax_x[np.argsort(np.argsort(bins[keep]))]
    y_jax = np.asarray(irfft_real_banded(half.real.astype(np.float32), half.imag.astype(np.float32), rp))
    u = torch.as_tensor(jax_x)[None, None]
    zero = torch.zeros_like(u)
    U = torch.zeros((1, 1, WIDE_N2, w.n1), dtype=torch.complex128)
    full = hermitian(u, zero, b.block, lo)[0, 0]
    bvec = torch.arange(WIDE_N2)
    for r, row in enumerate(w.rows.tolist()):
        acc = 0
        for e in w.entries[w.row_ptr[r] : w.row_ptr[r + 1]].tolist():
            kk = lo + (e >> 1)
            kk = b.block - kk if e & 1 and 0 < kk < b.block // 2 else kk
            acc = acc + full[kk] * twB[(kk * bvec) % b.block].conj()
        U[0, 0, :, pos1[row]] += acc
    y = (fft_inverse(U, _cplx(b.twiddles)).transpose(-1, -2).flatten(-2) / b.block).real[0, 0]
    assert snr_db(y_jax, y.numpy()) >= 100.0


# csrc/fft_reg.cuh, the register core of K3s's two FFT kernels.


def reg_fft(z: torch.Tensor, tw: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """csrc/fft_reg.cuh's transform over the last axis, stage by stage from
    its twiddle table: per stage of radix P after NS points, virtual
    thread v reads x[v + r n / P], takes the twiddle at [(r - 1) NS + v mod
    NS] of its stage's part of the table, the P-point DFT by radix-2
    butterflies whose twiddles are the table's w_16^k (w_16^(4 + k) = -i
    w_16^k), and writes output k at (v / NS) NS P + v mod NS + k NS.
    Conjugate twiddles for the inverse; natural order in and out."""
    n = z.shape[-1]
    w16 = [tw[k] for k in range(4)]
    w16 += [-1j * w for w in w16]
    if inverse:
        w16, tw = [w.conj() for w in w16], tw.conj()
    ns, at = 1, 4
    for P in reg_radices(n):
        v = torch.arange(n // P)
        x = [z[..., v + r * (n // P)] for r in range(P)]
        if ns > 1:
            x = [x[0]] + [x[r] * tw[at + (r - 1) * ns + v % ns] for r in range(1, P)]
            at += (P - 1) * ns
        L = P
        while L >= 2:  # radix-2 passes in place: x[s] ends as output bin brev(s)
            for b0 in range(0, P, L):
                for i in range(L // 2):
                    a, c = x[b0 + i], x[b0 + i + L // 2]
                    x[b0 + i], x[b0 + i + L // 2] = a + c, (a - c) * w16[i * (16 // L)]
            L //= 2
        bits = P.bit_length() - 1
        out = torch.empty_like(z)
        for k in range(P):
            out[..., (v // ns) * ns * P + v % ns + k * ns] = x[int(format(k, f"0{bits}b")[::-1] or "0", 2)]
        z, ns = out, ns * P
    return z


def test_register_core_sizes():
    # Every power of two up to FFT_MAX has its stages (16s, then what is
    # left), a team of n / 16 threads holding 16 values (n below 16: one
    # thread, n values), and a table the size the kernel's offsets give.
    for log2n in range(FFT_MAX.bit_length()):
        n = 1 << log2n
        r = reg_radices(n)
        assert int(np.prod(r)) == n and all(p in (2, 4, 8, 16) for p in r)
        assert r[:-1] == [REG_RADIX] * (len(r) - 1) and len(r) == (0 if n == 1 else -(-log2n // 4))
        assert reg_threads(n) * min(n, REG_RADIX) == n
        ns = np.cumprod([1] + r)[:-1]
        assert len(reg_twiddles(n)) == 4 + sum((p - 1) * m for p, m in zip(r[1:], ns[1:]))
    assert reg_radices(8192) == [16, 16, 16, 2] and reg_threads(8192) == 512
    # the inverse kernel's rounds: 21 frames of 256 points (32 teams of 16
    # threads), 5 of 1024 (8 teams), one of 8192 (one team: C + i Ls, then Rs)
    assert (reg_round(256), reg_round(1024), reg_round(8192), reg_round(16384)) == (21, 5, 1, 1)


@pytest.mark.parametrize("log2n", range(15))
def test_register_twiddles_are_float64_rounded_once(log2n):
    # The table against numpy float64, entry by entry, within float32's
    # rounding (half an ulp of 1), in the layout the kernel reads.
    n = 1 << log2n
    tw = reg_twiddles(n)
    assert tw.dtype == np.float32
    parts, ns = [np.exp(-2j * np.pi * np.arange(4) / 16)], 1
    for i, p in enumerate(reg_radices(n)):
        if i:
            m = np.arange(ns)
            parts += [np.exp(-2j * np.pi * m * r / (ns * p)) for r in range(1, p)]
        ns *= p
    want = np.concatenate(parts)
    assert np.abs(tw[:, 0] - want.real).max() <= 2.0**-24 and np.abs(tw[:, 1] - want.imag).max() <= 2.0**-24


@pytest.mark.parametrize("log2n", range(15))
def test_register_core_statement(log2n):
    # The core's stages from its float32 table against torch.fft in
    # float64, both ways: only the table's rounding separates them.
    n = 1 << log2n
    gen = torch.Generator().manual_seed(log2n)
    z = torch.complex(torch.randn((2, n), generator=gen, dtype=torch.float64),
                      torch.randn((2, n), generator=gen, dtype=torch.float64))
    tw = _cplx(reg_twiddles(n))
    assert _csnr(torch.fft.fft(z).numpy(), reg_fft(z, tw).numpy()) >= 120.0
    assert _csnr((torch.fft.ifft(z) * n).numpy(), reg_fft(z, tw, inverse=True).numpy()) >= 120.0


# csrc/pool.cu::pool_reg_kernel, K3 on the register core.


def reg_stage_frames(frames: torch.Tensor, b) -> torch.Tensor:
    """Windowed inverse frames [S, 3, F, B] of one pool bucket (B <=
    FFT_MAX) from frames [S, 2, F, B] on the register core: `reg_fft` of
    each packed frame, the mask at each kept bin from Z[k] and Z[B - k],
    the C + i Ls inverse of each frame, and the Rs of frames 2j and 2j + 1
    in one inverse (`pair_rs`), all in natural order."""
    B, K, lo = b.block, b.kept, b.lo
    tw = _cplx(b.twiddles)
    aw, sw = b.analysis_window.double(), b.synthesis_window.double()
    Z = reg_fft(torch.complex(frames[:, 0] * aw, frames[:, 1] * aw), tw)
    k = torch.arange(lo, lo + K)
    c, ls, rs = unpack_mask(Z[..., k], Z[..., (B - k) % B], b.gains.double())

    def inverse(u, v):
        return reg_fft(hermitian(u, v, B, lo), tw, inverse=True) * (sw / B)

    y01 = inverse(c, ls)
    y2 = unpair(inverse(*pair_rs(rs)), frames.shape[2])
    return torch.stack([y01.real, y01.imag, y2], dim=1)


def reg_pool_step(hist, t, carries, plan, hops: int):
    """pool_reg_kernel's dataflow in float64 for a plan whose buckets are
    all up to FFT_MAX points, one stream at a time (a block), bucket after
    bucket: init (the previous buckets' output, the carry added at the
    first ready hop i0 * hw), then the frames from the first ready one, a
    round at a time (`reg_pool_launch`): with several teams `round` frames,
    their Rs paired inside the round, each round's frames summed in frame
    order and added onto what is there; with one team a frame's C and Ls,
    then the Rs of two frames (`pair`) or of one.  Returns (out, new
    carries) as `pool_step_lcr` does."""
    S, hw = hist.shape[0], plan.hw
    i0 = (plan.warmup - t.long()).clamp(0, hops)
    out = torch.zeros((S, 3, hops * hw), dtype=torch.float64)
    new = []
    for b, carry in zip(plan.buckets, carries):
        B, H, F = b.block, b.hop, hops * b.passes
        geo = reg_pool_launch(B, b.kept)
        one_team = geo.threads == reg_threads(B)
        frames = frame_signal(hist[..., : (F - 1) * H + B], B, H, F)  # [S, 2, F, B]
        acc = torch.cat([out, torch.zeros((S, 3, B), dtype=torch.float64)], dim=-1)  # [S, 3, F H + B]

        def add(s, rec, outputs, fb):  # a round's frames [3, nf, B], summed in frame order, onto what is there
            total = overlap_add(rec[None], H)[0]
            acc[s, outputs, fb * H : fb * H + total.shape[-1]] += total[outputs]

        for s in range(S):
            acc[s, :, int(i0[s]) * hw : int(i0[s]) * hw + B] += carry[s]
            f0 = int(i0[s]) * b.passes
            if not one_team:
                for fb in range(f0, F, geo.round):
                    nf = min(geo.round, F - fb)
                    add(s, reg_stage_frames(frames[s : s + 1, :, fb : fb + nf], b)[0], [0, 1, 2], fb)
                continue
            for f in range(f0, F):
                slot = (f - f0) % 2 if geo.pair else 0
                add(s, reg_stage_frames(frames[s : s + 1, :, f : f + 1], b)[0], [0, 1], f)
                if not geo.pair or slot == 1 or f + 1 == F:
                    add(s, reg_stage_frames(frames[s : s + 1, :, f - slot : f + 1], b)[0], [2], f - slot)
        out = acc[..., : hops * hw]
        new.append(acc[..., hops * hw :])
    return out, tuple(new)


@pytest.mark.parametrize("hw", [2048, 8192])
def test_time_plan_carries_register_twiddles(hw):
    # K3 runs every bucket up to FFT_MAX points on the register core, so a
    # time plan carries its twiddles there, as a spectral plan does; a
    # bucket over FFT_MAX (32768 at hw 8192) carries the split's N1 pass
    # twiddles, which only a CUDA plan builds (test_torch_cuda.py's
    # plan-on-the-card test): none on the CPU.
    cfg = UpmixConfig.streaming(POOL[0], sr=48000.0, hw_block_size=hw)
    for ola in ("time", "spectral"):
        plan = make_pool_plan(cfg, hw, 2, device="cpu", ola=ola)
        for b in plan.buckets:
            if b.block > FFT_MAX:
                assert b.twiddles is None and b.wide is None
            else:
                assert torch.equal(b.twiddles, torch.as_tensor(reg_twiddles(b.block)))
    split = with_split_tables(make_pool_plan(cfg, hw, 2, device="cpu").buckets)
    assert [torch.equal(b.twiddles, torch.as_tensor(pass_twiddles(b.wide.n1))) for b in split if b.block > FFT_MAX] == (
        [True] if hw == 8192 else [])


@pytest.mark.parametrize("hw,hops,counts", [(2048, 1, (43, 43)), (2048, 4, (172, 172)),
                                             (8192, 1, (169, 168)), (8192, 4, (676, 672))])
def test_pool_frames_counts_of_the_serving_config(hw, hops, counts):
    # The `pool.frames` span's `fft_frames` and `reg_frames`, from the plan
    # on the host: at hw 2048 the Bela buckets' 1 + 2 + 8 + 32 frames a
    # block, every one on the register core; at hw 8192 the 32768 bucket's
    # frame a block goes through the split, off the core.  The same counts
    # as K3s's forward step's.
    cfg = UpmixConfig.streaming(POOL[0], sr=48000.0, hw_block_size=hw)
    plan = make_pool_plan(cfg, hw, 2, device="cpu")
    assert plan.fft_frames(hops) == counts
    spectral = make_pool_plan(cfg, hw, 2, device="cpu", ola="spectral").spectral_routes(hops)
    assert (spectral.forward_frames, spectral.forward_reg) == counts


@pytest.mark.parametrize("log2n", range(15))
def test_reg_pool_launch_fits_every_kept_width(log2n):
    # K3's block on the register core: 512 threads in whole teams of n /
    # 16, four teams of 256 at 4096 points (not two, which would round one
    # frame at a time), one team from 8192 points; at most 15 teams of 64
    # threads or more (each syncs on a named barrier, 1-15); a round's nf +
    # ceil(nf / 2) transforms fit its teams; the shared memory (exchange
    # buffers, then the Rs buffer) fits one block at every kept width up to
    # all n / 2 + 1 bins, the Rs of two frames paired with one team only
    # where both fit (not at 16384 points with every bin kept: that
    # frame's Rs goes alone).
    n = 1 << log2n
    team = reg_threads(n)
    for kept in sorted({1, min(90, n // 2 + 1), n // 4 + 1, n // 2 + 1}):
        g = reg_pool_launch(n, kept)
        teams = g.threads // team
        assert g.threads % team == 0 and g.threads <= 1024 and (team < 64 or teams <= 15)
        assert g.threads == (1024 if n in (4096, 16384) else 512) and g.smem <= REG_SMEM - POOL_REG_STATIC
        if teams > 1:
            assert g.round == 2 * teams // 3 and g.round + -(-g.round // 2) <= teams and not g.pair
            assert g.smem == 8 * (teams * (n + n // 16) + g.round * kept)
        else:
            assert g.round == 1 and g.smem == 8 * (n + n // 16 + (2 if g.pair else 1) * kept)
    # the Bela buckets' rounds: 8192 one team, frame by frame; 4096 both
    # frames of a one-block call at once; 1024 and 256 in two rounds
    assert [reg_pool_launch(b, 90).round for b in (8192, 4096, 1024, 256)] == [1, 2, 5, 21]
    assert reg_pool_launch(16384, 4097).pair and not reg_pool_launch(16384, 8193).pair


@pytest.mark.parametrize("hops", [1, 4])
def test_register_dataflow_matches_plain_pool(hops):
    # The pool kernel's dataflow on the register core (`reg_pool_step`),
    # from the plan's float32 twiddles in float64, against
    # pool_step_lcr_plain on the Bela config at hw 2048: nonzero carries,
    # stream 0 below the warmup (its carry held at hops 1, its first hops
    # gated at hops 4), the rest ready.  Within 1e-5 of the outputs' scale,
    # exact zeros where the plain version has them.
    cfg = UpmixConfig.streaming(POOL[0], sr=48000.0, hw_block_size=2048)
    S = 3
    plan = make_pool_plan(cfg, 2048, S, device="cpu")
    assert all(b.block <= FFT_MAX for b in plan.buckets)
    K = plan.warmup
    rng = np.random.default_rng(26 + hops)
    hist = torch.as_tensor(rng.standard_normal((S, 2, (K - 1 + hops) * 2048)))
    t = torch.tensor([1, K, K + 5], dtype=torch.int32)
    carries = [torch.as_tensor(rng.standard_normal((S, 3, b.block))) for b in plan.buckets]
    ref, ref_c = pool_step_lcr_plain(hist, t, carries, plan, hops)
    got, got_c = reg_pool_step(hist, t, carries, plan, hops)
    assert torch.equal(got == 0, ref == 0)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    for r, g, c in zip(ref_c, got_c, carries):
        assert float((g - r).abs().max()) <= 1e-5 * max(1.0, float(r.abs().max()))
        if hops == 1:
            assert torch.equal(g[0], c[0])  # stream 0 not ready: carry held
