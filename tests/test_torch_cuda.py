"""The CUDA kernels against their plain versions, and the entry points
that must launch them, on an NVIDIA GPU.

Marked `gpu`: skipped where no CUDA device is present.  On a GPU machine
(which need not have jax; this file does not import it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Small configs cover the kernels' edges that the bench config does not:
blocks from 128 to 2^21 points (odd and even powers of two, the
two-stage split, its N2 grown past 2^20 points), overlaps 0.5 to 0.875,
K2 at every frame-pass size, several segments per launch, K3s (the pool's
spectral OLA) at every pool case and 1, 5 and 2048 streams, its edge
product on every bucket at hw 2048 and 8192 and its inputs on one
device, one band that keeps every bin (a 16384-point frame whose Rs goes alone;
a split bucket whose kept bins take 65 tiles), the pool at hw 8192 (its
32768 bucket split), and K3's register path at every size from 16 to
16384 points with every bin kept, hops 1, 3 and 4, two calls bit for
bit and NaN isolated; the bench config covers each of its block sizes,
256 to 65536.  Launch counts are read from the wrappers'
`launches_per_bucket`.  The probes: K4 at every rung and cluster size,
K5 in its six configurations and odd geometries.  The stream server on
a CudaStreamPool on the card against the pool fed directly.
"""

import numpy as np
import pytest
import torch

from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.offline import Upmixer, _plan_buckets, build_offline_fn, plans_from_numpy
from upmix_tpu_torch.ops.omnibus import (
    launches_per_bucket,
    make_omnibus_plan,
    omnibus_lcr_batch,
    omnibus_lcr_batch_plain,
)
from upmix_tpu_torch.utils.tracing import launches

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _snr(ref, got):
    ref, got = ref.double().cpu(), got.double().cpu()
    return 10 * np.log10(float((ref**2).sum()) / max(float(((ref - got) ** 2).sum()), 1e-300))


CASES = [
    (([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512)), 2048),
    (([0.0, 2000.0], dict(sr=8000.0, max_block_size=512, overlap=0.5)), 1024),
    (([0, 100, 200, 400, 800, 1200, 1600, 2400, 3200], dict(sr=8000.0, max_block_size=1024)), 2048),
    (([0.0, 400.0], dict(sr=8000.0, max_block_size=4096)), 8192),
    (([0.0, 400.0], dict(sr=8000.0, max_block_size=32768)), 32768),
    (([0.0], dict(sr=8000.0, max_block_size=16384)), 16384),
    (([0.0], dict(sr=8000.0, max_block_size=65536)), 65536),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain_float64(cuda, case):
    # FP32 FFTs against float64 FFTs: ~135 dB in practice; 90 dB bar.
    (edges, kw), chunk = CASES[case]
    cfg = UpmixConfig.make(edges, **kw)
    plan = make_omnibus_plan(plans_from_numpy(_plan_buckets(cfg, chunk), cuda), chunk)
    rng = np.random.default_rng(case)
    x = torch.as_tensor(
        rng.standard_normal((3, 2, chunk + plan.halo)), dtype=torch.float32, device=cuda
    )
    before = launches("K1")
    got = torch.cat(omnibus_lcr_batch(x, plan), dim=-1)
    torch.cuda.synchronize()
    assert launches("K1") - before == sum(launches_per_bucket(b.block) for b in plan.buckets)
    ref = torch.cat(omnibus_lcr_batch_plain(x.double(), plan), dim=-1)
    for o in range(3):
        assert _snr(ref[:, o], got[:, o]) > 90.0


def test_kernel_each_bench_block_size_and_repeatable(cuda):
    # Each block size of bench.py's config (256 to 65536, the widest
    # through the two-stage split) alone and all together, at one 65536
    # chunk of two segments: >= 80 dB against float64, and two calls give
    # the same bits (the overlap-add has no atomics).
    cfg = UpmixConfig.make([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], sr=44100.0)
    chunk = 65536
    plan = make_omnibus_plan(plans_from_numpy(_plan_buckets(cfg, chunk), cuda), chunk)
    assert sorted(b.block for b in plan.buckets) == [256, 1024, 4096, 16384, 65536]
    x = torch.randn((2, 2, chunk + plan.halo), device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    for sub in [make_omnibus_plan([b], chunk) for b in plan.buckets] + [plan]:
        xb = x[..., : chunk + sub.halo].contiguous()
        got = torch.cat(omnibus_lcr_batch(xb, sub), dim=-1)
        again = torch.cat(omnibus_lcr_batch(xb, sub), dim=-1)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        ref = torch.cat(omnibus_lcr_batch_plain(xb.double(), sub), dim=-1)
        for o in range(3):
            assert _snr(ref[:, o], got[:, o]) >= 80.0, ([b.block for b in sub.buckets], o)


def test_kernel_rejects_float64(cuda):
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    plan = make_omnibus_plan(plans_from_numpy(_plan_buckets(cfg, 512), cuda), 512)
    x = torch.zeros((1, 2, 512 + plan.halo), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        omnibus_lcr_batch(x, plan)


def test_upmixer_matches_whole_file_float64(cuda):
    # Several segments with a ragged tail through the kernel path, against
    # the float64 whole-file torch.fft program on the card.
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    n = 4 * 1024 + 300
    rng = np.random.default_rng(7)
    L = rng.standard_normal(n).astype(np.float32)
    R = rng.standard_normal(n).astype(np.float32)
    got = Upmixer(cfg, device=cuda, chunk=1024).process(L, R)
    ref = build_offline_fn(cfg, n, chunk=0, device=cuda)(
        torch.as_tensor(L, dtype=torch.float64, device=cuda),
        torch.as_tensor(R, dtype=torch.float64, device=cuda),
    )
    for r, g in zip(ref, got):
        assert _snr(r, g) > 90.0


# The pool kernel (K3) and its floor probe (K6).

POOL_CASES = {
    # (edges, sr, hw): the 256 bucket has H = 64 (one 64-wide column
    # tile), the 1024 bucket P = 1; at hw 128 every block exceeds hw.
    "h64": (([0.0, 400.0, 1600.0], 8000.0), 256),
    "block_over_hw": (([0.0, 400.0, 1600.0], 8000.0), 128),
    "bela_48k": (([0.0, 500.0, 2000.0, 8000.0], 48000.0), 2048),
    "hw8192_split": (([0.0, 500.0, 2000.0, 8000.0], 48000.0), 8192),
    "one_band_every_bin": (([0.0], 8000.0), 4096),
}
# K3's register path at every size it takes, B = 16 .. 16384 (one bucket,
# every bin kept: the widest Rs buffer; hw = B / 4): one team a block from
# 8192 points, the Rs of two frames paired but at 16384.
POOL_SIZES = {f"B{1 << n}": (([0.0], 8000.0), 1 << (n - 2)) for n in range(4, 15)}


def _pool_case(case):
    return POOL_CASES[case] if case in POOL_CASES else POOL_SIZES[case]


@pytest.mark.parametrize("case", list(POOL_CASES) + list(POOL_SIZES))
@pytest.mark.parametrize("S,hops", [(1, 1), (5, 1), (5, 3), (5, 4)])
def test_pool_kernel_matches_plain_float64(cuda, case, S, hops):
    # FP32 FFTs against float64 FFTs; mixed t with nonzero carries,
    # stream 0 below the warmup with a carry it must hold.
    from upmix_tpu_torch.ops import pool
    from upmix_tpu_torch.ops.pool import make_pool_plan, pool_step_lcr, pool_step_lcr_plain

    (edges, sr), hw = _pool_case(case)
    cfg = UpmixConfig.streaming(edges, sr=sr, hw_block_size=hw)
    plan = make_pool_plan(cfg, hw, S, device=cuda)
    K = plan.warmup
    rng = np.random.default_rng(S * 10 + hops)
    hist = torch.as_tensor(rng.standard_normal((S, 2, (K - 1 + hops) * hw)), dtype=torch.float32, device=cuda)
    t = torch.as_tensor(rng.integers(1, 8, S), dtype=torch.int32, device=cuda)
    t[0] = 1
    carries = [torch.as_tensor(rng.standard_normal((S, 3, b.block)), dtype=torch.float32, device=cuda)
               for b in plan.buckets]
    before = launches("K3")
    out, new = pool_step_lcr(hist, t, carries, plan, hops)
    torch.cuda.synchronize()
    assert launches("K3") - before == sum(pool.launches_per_bucket(b.block) for b in plan.buckets)
    ref, ref_new = pool_step_lcr_plain(hist.double(), t, [c.double() for c in carries], plan, hops)
    assert torch.equal(out == 0, ref == 0)  # not-ready hops are exact zeros
    if bool((ref != 0).any()):  # else no stream was ready: all zeros, checked above
        assert _snr(ref, out) > 90.0
    for c, r, n in zip(carries, ref_new, new):
        assert _snr(r, n) > 90.0
        if hops == 1 and K > 1:
            assert torch.equal(n[0], c[0])  # stream 0 not ready: carry held


@pytest.mark.parametrize("case", ["bela_48k", *POOL_SIZES])
@pytest.mark.parametrize("hops", [1, 4])
def test_pool_kernel_zeros_and_nan_isolation(cuda, hops, case):
    # The stream server's config, and K3's every register size, at 64
    # streams with mixed t and nonzero carries: >= 80 dB, exact zeros where
    # the plain version has them, two calls bit for bit, and a NaN in one
    # stream's history leaves every other stream's output and carries as
    # they were, and finite.
    from upmix_tpu_torch.ops.pool import make_pool_plan, pool_step_lcr, pool_step_lcr_plain

    (edges, sr), hw = _pool_case(case)
    cfg = UpmixConfig.streaming(edges, sr=sr, hw_block_size=hw)
    S = 64
    plan = make_pool_plan(cfg, hw, S, device=cuda)
    K = plan.warmup
    rng = np.random.default_rng(40 + hops)
    hist = torch.as_tensor(rng.standard_normal((S, 2, (K - 1 + hops) * hw)), dtype=torch.float32, device=cuda)
    t = torch.as_tensor(rng.integers(1, K + 4, S), dtype=torch.int32, device=cuda)
    carries = [torch.as_tensor(rng.standard_normal((S, 3, b.block)) * 0.1, dtype=torch.float32, device=cuda)
               for b in plan.buckets]
    out, new = pool_step_lcr(hist, t, carries, plan, hops)
    again, new_again = pool_step_lcr(hist, t, carries, plan, hops)
    assert torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(new, new_again))
    ref, ref_new = pool_step_lcr_plain(hist.double(), t, [c.double() for c in carries], plan, hops)
    assert bool((ref == 0).any()) and bool((out[ref == 0] == 0).all())
    assert _snr(ref, out) >= 80.0
    for r, n in zip(ref_new, new):
        assert _snr(r, n) >= 80.0
    bad = hist.clone()
    bad[7, 1, -min(100, hw)] = float("nan")
    out_nan, new_nan = pool_step_lcr(bad, t, carries, plan, hops)
    others = torch.arange(S, device=cuda) != 7
    assert bool(torch.isfinite(out_nan[others]).all()) and torch.equal(out_nan[others], out[others])
    for a, b in zip(new_nan, new):
        assert bool(torch.isfinite(a[others]).all()) and torch.equal(a[others], b[others])


@pytest.mark.parametrize("mode", ["copy", "frame"])
def test_pool_floor_bit_exact(cuda, mode):
    from upmix_tpu_torch.ops.pool import make_pool_plan
    from upmix_tpu_torch.ops.pool_floor import pool_floor, pool_floor_plain

    for (edges, sr), hw in POOL_CASES.values():  # every window: the kernel keeps none in shared memory
        cfg = UpmixConfig.streaming(edges, sr=sr, hw_block_size=hw)
        plan = make_pool_plan(cfg, hw, 7, device=cuda)
        hist = torch.randn((7, 2, plan.window), device=cuda, generator=torch.Generator(cuda).manual_seed(hw))
        assert torch.equal(pool_floor(hist, hw, mode, plan), pool_floor_plain(hist, hw, mode, plan))


@pytest.mark.parametrize("mode", ["copy", "frame"])
@pytest.mark.parametrize("hw", [2048, 4096])
@pytest.mark.parametrize("S", [1, 5, 2048])
def test_pool_floor_at_the_pool_shapes(cuda, S, hw, mode):
    # The Bela config's floor at the stream counts and windows the pool
    # runs (windows 8192 and 16384), bit for bit; then a history that
    # starts 4 bytes off 16 (the kernel's one-float columns) and one whose
    # window is not a multiple of 4.
    from upmix_tpu_torch.ops import pool_floor as pf
    from upmix_tpu_torch.ops.pool import make_pool_plan

    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=hw)
    plan = make_pool_plan(cfg, hw, S, device=cuda)
    gen = torch.Generator(cuda).manual_seed(S * hw)
    hist = torch.randn((S, 2, plan.window), device=cuda, generator=gen)
    before = launches("K6")
    assert torch.equal(pf.pool_floor(hist, hw, mode, plan), pf.pool_floor_plain(hist, hw, mode, plan))
    assert launches("K6") - before == 1
    off = torch.randn(S * 2 * plan.window + 1, device=cuda, generator=gen)[1:].view(S, 2, plan.window)
    assert torch.equal(pf.pool_floor(off, hw, mode, plan), pf.pool_floor_plain(off, hw, mode, plan))
    if mode == "copy":
        odd = torch.randn((S, 2, plan.window + 3), device=cuda, generator=gen)
        assert torch.equal(pf.pool_floor(odd, hw + 1, mode), pf.pool_floor_plain(odd, hw + 1, mode))


def test_cuda_pool_matches_torch_engine(cuda):
    # Both pools run the pool kernel on the card: the same step on the same
    # state, so the same bits; the JAX structures differ only in snapshots.
    from upmix_tpu_torch.models.streaming import BatchStreamingUpmixer, CudaStreamPool, make_stream_pool
    from upmix_tpu_torch.ops import pool

    cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=256)
    S = 6
    pool_ = make_stream_pool(cfg, 256, S, device=cuda)
    assert isinstance(pool_, CudaStreamPool)
    ref = BatchStreamingUpmixer(cfg, 256, S, device=cuda)
    blocks = torch.randn((10, S, 2, 256), device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    for t, b in enumerate(blocks):
        before = launches("K3")
        got = torch.stack(pool_.push_blocks(b[:, 0], b[:, 1]))
        want = torch.stack(ref.push_blocks(b[:, 0], b[:, 1]))
        assert launches("K3") - before == 2 * sum(pool.launches_per_bucket(b.block) for b in pool_.plan.buckets)
        if t < pool_.warmup_blocks - 1:
            assert torch.all(got == 0)
        assert torch.equal(got, want)


def test_engines_on_cuda_launch_the_pool_kernel(cuda):
    # StreamingUpmixer and BatchStreamingUpmixer on the card go through the
    # pool kernel and match one float64 run of the plain step over the
    # whole signal.
    from upmix_tpu_torch.models.streaming import BatchStreamingUpmixer, StreamingUpmixer
    from upmix_tpu_torch.ops import pool
    from upmix_tpu_torch.ops.pool import make_pool_plan, pool_step_lcr_plain

    cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=256)
    hw, S, n = 256, 3, 10
    x = torch.randn((S, 2, n * hw), device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    plan = make_pool_plan(cfg, hw, S, device=cuda)
    K = plan.warmup
    hist = torch.cat([x.new_zeros((S, 2, (K - 1) * hw)), x], dim=-1).double()
    carries = [hist.new_zeros((S, 3, b.block)) for b in plan.buckets]
    ref, _ = pool_step_lcr_plain(hist, torch.ones(S, dtype=torch.int32, device=cuda), carries, plan, n)

    before = launches("K3")
    got = torch.stack(StreamingUpmixer(cfg, hw, device=cuda).process_signal(x[0, 0], x[0, 1]))
    assert launches("K3") - before == sum(pool.launches_per_bucket(b.block) for b in plan.buckets)
    assert torch.equal(got[:, : (K - 1) * hw] == 0, ref[0, :, : (K - 1) * hw] == 0)
    assert _snr(ref[0], got) > 90.0

    single = StreamingUpmixer(cfg, hw, device=cuda)
    batch = BatchStreamingUpmixer(cfg, hw, S, device=cuda)
    before = launches("K3")
    pushed, batched = [], []
    for i in range(n):
        blk = x[..., i * hw : (i + 1) * hw]
        pushed.append(torch.stack(single.push_block(blk[0, 0], blk[0, 1])))
        batched.append(torch.stack(batch.push_blocks(blk[:, 0], blk[:, 1])))
    assert launches("K3") - before == 2 * n * sum(pool.launches_per_bucket(b.block) for b in plan.buckets)
    assert _snr(ref[0], torch.cat(pushed, dim=-1)) > 90.0
    assert _snr(ref.transpose(0, 1), torch.cat(batched, dim=-1)) > 90.0


# The pool kernel's spectral-OLA body (K3s) and the pool on a mesh.


@pytest.mark.parametrize("case", list(POOL_CASES))
@pytest.mark.parametrize("S,hops", [(1, 1), (5, 4), (2048, 1), (2048, 4)])
def test_spectral_kernel_matches_plain_float64(cuda, case, S, hops):
    # K3s against its float64 plain version from nonzero carried spectra
    # with mixed t, stream 0 below the warmup holding its carry; its
    # output against K3's on the same blocks from a fresh state.
    from upmix_tpu_torch.ops import pool
    from upmix_tpu_torch.ops.pool import make_pool_plan, pool_step_lcr, pool_step_spectral_plain

    (edges, sr), hw = POOL_CASES[case]
    if S == 2048 and hw > 2048:
        S = 256  # the same launch geometry (one block a stream), a tenth of the plain version's memory
    cfg = UpmixConfig.streaming(edges, sr=sr, hw_block_size=hw)
    plan = make_pool_plan(cfg, hw, S, device=cuda, ola="spectral")
    K = plan.warmup
    rng = np.random.default_rng(S * 10 + hops + 7)
    hist = torch.as_tensor(rng.standard_normal((S, 2, (K - 1 + hops) * hw)), dtype=torch.float32, device=cuda)
    t = torch.as_tensor(rng.integers(1, K + 4, S), dtype=torch.int32, device=cuda)
    t[0] = 1
    carries = [torch.as_tensor(rng.standard_normal(b.spectral_carry_shape(S)), dtype=torch.float32, device=cuda)
               for b in plan.buckets]
    before = (launches("K3"), launches("K3s"))
    out, new = pool_step_lcr(hist, t, carries, plan, hops)
    again, _ = pool_step_lcr(hist, t, carries, plan, hops)
    torch.cuda.synchronize()
    per_call = pool.spectral_launches(plan, hops)
    assert (launches("K3"), launches("K3s")) == (before[0], before[1] + 2 * per_call)
    assert torch.equal(out, again)
    ref, ref_new = pool_step_spectral_plain(hist.double(), t, [c.double() for c in carries], plan, hops)
    assert bool((out[ref == 0] == 0).all())  # not-ready hops are exact zeros
    if bool((ref != 0).any()):
        assert _snr(ref, out) >= 80.0
    for b, c, r, n in zip(plan.buckets, carries, ref_new, new):
        if b.overlap > 1:  # else an empty carry
            assert _snr(r, n) >= 80.0
            if hops + 1 <= K:
                assert torch.equal(n[0], c[0])  # stream 0 not ready: carry held
    # The two dataflows compute one function: from a fresh state, K3s's
    # output against K3's on the same history.
    tplan = make_pool_plan(cfg, hw, S, device=cuda)
    ready = torch.full((S,), K + 1, dtype=torch.int32, device=cuda)
    zs = [torch.zeros(b.spectral_carry_shape(S), device=cuda) for b in plan.buckets]
    zt = [torch.zeros((S, 3, b.block), device=cuda) for b in tplan.buckets]
    assert _snr(pool_step_lcr(hist, ready, zt, tplan, hops)[0], pool_step_lcr(hist, ready, zs, plan, hops)[0]) >= 80.0


def test_spectral_pool_launches_k3s_and_isolates_nan(cuda):
    # make_stream_pool(ola="spectral") on the card is the CUDA pool, which
    # launches K3s (never K3, never the plain version) and holds >= 60 dB
    # against a float64 run; a NaN in one stream leaves the others alone.
    from upmix_tpu_torch.models.streaming import CudaStreamPool, make_stream_pool
    from upmix_tpu_torch.ops import pool
    from upmix_tpu_torch.ops.pool import pool_step_spectral_plain

    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048)
    S, hw = 16, 2048
    sp = make_stream_pool(cfg, hw, S, device=cuda, ola="spectral")
    assert type(sp) is CudaStreamPool and sp.ola == "spectral"
    plan = sp.plan
    K = plan.warmup
    blocks = torch.randn((8, 2, S, hw), device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    calls = []
    real = pool.pool_step_spectral_plain
    pool.pool_step_spectral_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        before = (launches("K3"), launches("K3s"))
        outs = [torch.stack(sp.push_blocks(b[0], b[1])) for b in blocks]
        torch.cuda.synchronize()
    finally:
        pool.pool_step_spectral_plain = real
    per_call = pool.spectral_launches(plan, 1)
    assert not calls and (launches("K3"), launches("K3s")) == (before[0], before[1] + 8 * per_call)
    hist = torch.zeros((S, 2, (K - 1) * hw), dtype=torch.float64, device=cuda)
    carries = [torch.zeros(b.spectral_carry_shape(S), dtype=torch.float64, device=cuda) for b in plan.buckets]
    for i, (b, out) in enumerate(zip(blocks, outs)):
        h = torch.cat([hist, b.transpose(0, 1).double()], dim=-1)
        ref, carries = pool_step_spectral_plain(h, torch.full((S,), i + 1, dtype=torch.int32, device=cuda), carries,
                                                plan)
        hist = h[..., hw:]
        if i < K - 1:
            assert torch.all(out == 0)
        else:
            assert _snr(ref.transpose(0, 1), out) >= 60.0
    sp.reset()
    clean = make_stream_pool(cfg, hw, S, device=cuda, ola="spectral")
    for i, b in enumerate(blocks):
        bad = b.clone()
        if i >= 5:
            bad[:, 3] = float("nan")
        got, want = torch.stack(sp.push_blocks(bad[0], bad[1])), torch.stack(clean.push_blocks(b[0], b[1]))
        others = torch.arange(S, device=cuda) != 3
        assert torch.equal(got[:, others], want[:, others])


@pytest.mark.parametrize("inverse", [0, 1])
@pytest.mark.parametrize("log2n", range(6, 15))
def test_register_fft_core_matches_torch_fft_float64(cuda, log2n, inverse):
    # csrc/fft_reg.cuh through the two kernels' own transforms
    # (pool_spectral_reg_fft), B = 64 .. 16384, against torch.fft in
    # float64: the forward of complex frames (a window of ones), the
    # unnormalised inverse of two real signals' half spectra packed as u +
    # i v with every bin kept; float32 rounding alone (about 137 dB on the
    # host): >= 120 dB.  A count that leaves a block's last teams idle.
    from upmix_tpu_torch.ops import _build, pool
    from upmix_tpu_torch.ops.fftplan import reg_twiddles

    n = 1 << log2n
    count = 2 * max(1, 256 // max(1, n // 16)) + 1
    gen = torch.Generator(cuda).manual_seed(log2n)
    planes = torch.randn((count, 2, n), device=cuda, dtype=torch.float64, generator=gen)
    if inverse:
        half = torch.fft.rfft(planes, dim=-1)  # [count, 2, n / 2 + 1]: U, V
        x = torch.view_as_real(half).float().contiguous()
        half_f = torch.view_as_complex(x.double())
        # the reference from the float32 half spectra the kernel reads
        ref = torch.fft.irfft(half_f[:, 0], n=n) * n + 1j * torch.fft.irfft(half_f[:, 1], n=n) * n
    else:
        x = planes.float().contiguous()
        ref = torch.fft.fft(torch.complex(x[:, 0].double(), x[:, 1].double()), dim=-1)
    y = torch.full((count, n, 2), float("nan"), device=cuda)
    ones = torch.ones(n, device=cuda)
    tw = torch.as_tensor(reg_twiddles(n), device=cuda)
    with _build.kernels(cuda) as k:  # raises on a CUDA error
        pool.load_reg_roots(k)
        k.run("pool_spectral_reg_fft", x.data_ptr(), y.data_ptr(), ones.data_ptr(), tw.data_ptr(), n, count, inverse,
              k.stream)
    torch.cuda.synchronize()
    assert _snr(torch.view_as_real(ref), y.double()) >= 120.0


@pytest.mark.parametrize("S,hops", [(16, 1), (16, 4), (2048, 1), (2048, 4), (8192, 1), (8192, 4)])
def test_spectral_pool_on_the_register_core(cuda, S, hops):
    # CudaStreamPool(ola="spectral") of the Bela configuration on K3s's
    # register-core FFTs against its float64 plain version, every block
    # through push_blocks (hops 1) or push_blocks_multi (hops 4), with the
    # frames its spans count on the core: every one of them.  Two pools
    # fed the same blocks agree bit for bit, and a stream's output does not
    # depend on the rows beside it: the first 16 rows of the step at S
    # rows equal the step of those 16 rows alone.
    from upmix_tpu_torch.models.streaming import make_stream_pool
    from upmix_tpu_torch.ops.pool import pool_step_lcr, pool_step_spectral_plain

    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048)
    hw = 2048
    pools = [make_stream_pool(cfg, hw, S, device=cuda, ola="spectral") for _ in range(2)]
    plan = pools[0].plan
    routes = plan.spectral_routes(hops)
    assert (routes.forward_reg, routes.inverse_reg) == (routes.forward_frames, routes.inverse_frames) != (0, 0)
    K = plan.warmup
    gen = torch.Generator(cuda).manual_seed(S + hops)
    calls = K + 1
    blocks = torch.randn((calls, 2, S, hops * hw), device=cuda, generator=gen)
    hist = torch.zeros((S, 2, (K - 1) * hw), dtype=torch.float64, device=cuda)
    carries = [torch.zeros(b.spectral_carry_shape(S), dtype=torch.float64, device=cuda) for b in plan.buckets]
    for i, b in enumerate(blocks):
        push = [p.push_blocks if hops == 1 else p.push_blocks_multi for p in pools]
        out, again = (torch.stack(f(b[0], b[1])) for f in push)
        assert torch.equal(out, again)
        h = torch.cat([hist, b.transpose(0, 1).double()], dim=-1)
        t = torch.full((S,), i * hops + 1, dtype=torch.int32, device=cuda)
        ref, carries = pool_step_spectral_plain(h, t, carries, plan, hops)
        hist = h[..., hops * hw :]
        if bool((ref != 0).any()):
            assert _snr(ref.transpose(0, 1), out) >= 80.0
        del h, ref
    x = torch.randn((S, 2, (K - 1 + hops) * hw), device=cuda, generator=gen)
    t = torch.full((S,), K + 1, dtype=torch.int32, device=cuda)
    c = [torch.randn(b.spectral_carry_shape(S), device=cuda, generator=gen) for b in plan.buckets]
    whole, _ = pool_step_lcr(x, t, c, plan, hops)
    few, _ = pool_step_lcr(x[:16].contiguous(), t[:16], [ci[:16].contiguous() for ci in c], plan, hops)
    assert torch.equal(whole[:16], few)


def _edge_everywhere(plan):
    """The spectral plan with every bucket whose frames overlap sending its
    edge frames to the product, with its split weight."""
    import dataclasses

    from upmix_tpu_torch.ops.pool import make_edge_weight, split_edge_weight

    def forced(b):
        w = make_edge_weight(b.block, b.lo, b.kept, b.analysis_window.cpu().numpy(), b.synthesis_window.cpu().numpy())
        return dataclasses.replace(b, edge_product=True, edge_weight=split_edge_weight(w).to(b.analysis_window.device))

    return dataclasses.replace(plan, buckets=tuple(forced(b) if b.overlap > 1 else b for b in plan.buckets))


@pytest.mark.parametrize("hw", [2048, 8192])
@pytest.mark.parametrize("S,hops", [(1, 1), (5, 4), (2048, 1), (2048, 4)])
def test_edge_product_matches_plain_float64(cuda, S, hops, hw):
    # K3s's edge product (gather + tensor-core product, bf16x3) against its
    # plain version in float64, per bucket (each bucket's edge frames
    # forced onto the product) and for the plan as built, >= 80 dB, exact
    # zeros where the plain version has them (streams below their first
    # ready hop, stream 0 among them), two calls bit for bit; its launches
    # counted.
    import dataclasses

    from upmix_tpu_torch.ops.pool import make_pool_plan, spectral_edge, spectral_edge_plain, spectral_forward

    if hw > 2048 and S == 2048:
        S = 256  # the same launch geometry per row tile, a tenth of the plain version's memory
    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=hw)
    built = make_pool_plan(cfg, hw, S, device=cuda, ola="spectral")
    plan = _edge_everywhere(built)
    K = plan.warmup
    rng = np.random.default_rng(S + hops + hw)
    hist = torch.as_tensor(rng.standard_normal((S, 2, (K - 1 + hops) * hw)), dtype=torch.float32, device=cuda)
    t = torch.as_tensor(rng.integers(1, K + 4, S), dtype=torch.int32, device=cuda)
    t[0] = 1
    carries = [torch.as_tensor(rng.standard_normal(b.spectral_carry_shape(S)), dtype=torch.float32, device=cuda)
               for b in plan.buckets]
    specs, _ = spectral_forward(hist, t, carries, plan, hops)
    for i, b in enumerate(plan.buckets):
        sub = dataclasses.replace(plan, buckets=(b,))
        before = (launches("K3s.edge"), launches("K3s"))
        got = spectral_edge([carries[i]], [specs[i]], t, sub, hops)
        again = spectral_edge([carries[i]], [specs[i]], t, sub, hops)
        torch.cuda.synchronize()
        assert (launches("K3s.edge"), launches("K3s")) == (before[0] + 4, before[1] + 4)
        assert torch.equal(got, again)
        ref = spectral_edge_plain([carries[i].double()], [specs[i].double()], t, sub, hops)
        assert bool((got[ref == 0] == 0).all())
        assert not got[0, :, : int(min(K - 1, hops)) * hw].any()
        if bool((ref != 0).any()):
            assert _snr(ref, got) >= 80.0, b.block
    if any(b.edge_product for b in built.buckets):
        got = spectral_edge(carries, specs, t, built, hops)
        ref = spectral_edge_plain([c.double() for c in carries], [x.double() for x in specs], t, built, hops)
        assert bool((got[ref == 0] == 0).all())
        if bool((ref != 0).any()):
            assert _snr(ref, got) >= 80.0


def test_edge_product_never_hands_work_to_a_plain_version(cuda):
    # A CUDA plan whose bucket takes the product but has no weight raises;
    # the spectral step on the card never calls the plain versions.
    import dataclasses

    from upmix_tpu_torch.ops import pool
    from upmix_tpu_torch.ops.pool import make_pool_plan, pool_step_lcr

    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048)
    plan = make_pool_plan(cfg, 2048, 4, device=cuda, ola="spectral")
    assert [b.edge_product for b in plan.buckets] == [True, True, False, False]
    assert all((b.edge_weight is not None) == b.edge_product for b in plan.buckets)
    hist = torch.zeros((4, 2, 4 * 2048), device=cuda)
    t = torch.full((4,), 9, dtype=torch.int32, device=cuda)
    carries = [torch.zeros(b.spectral_carry_shape(4), device=cuda) for b in plan.buckets]
    broken = dataclasses.replace(plan, buckets=(dataclasses.replace(plan.buckets[0], edge_weight=None),
                                                *plan.buckets[1:]))
    with pytest.raises(ValueError, match="split weight"):
        pool_step_lcr(hist, t, carries, broken)
    calls = []
    names = ("spectral_edge_plain", "spectral_whole_plain", "spectral_forward_plain", "pool_step_spectral_plain")
    real = {n: getattr(pool, n) for n in names}
    for n in names:
        setattr(pool, n, lambda *a, _n=n, **k: calls.append(_n) or real[_n](*a, **k))
    try:
        before = launches("K3s.edge")
        pool_step_lcr(hist, t, carries, plan, 1)
        torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(pool, n, real[n])
    assert not calls and launches("K3s.edge") == before + 2


def test_spectral_steps_refuse_inputs_spread_over_devices(cuda):
    # The edge and whole steps run where the spectra lie; t, a carry or out
    # on the host beside spectra on the card raise (no plain version runs
    # on the card's tensors, no kernel launches).
    from upmix_tpu_torch.ops.pool import make_pool_plan, spectral_edge, spectral_forward, spectral_whole

    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048)
    S = 4
    plan = make_pool_plan(cfg, 2048, S, device=cuda, ola="spectral")
    hist = torch.zeros((S, 2, 4 * 2048), device=cuda)
    t = torch.full((S,), 9, dtype=torch.int32, device=cuda)
    carries = [torch.zeros(b.spectral_carry_shape(S), device=cuda) for b in plan.buckets]
    specs, _ = spectral_forward(hist, t, carries, plan)
    out = spectral_edge(carries, specs, t, plan)
    torch.cuda.synchronize()
    before = launches("K3s")
    with pytest.raises(ValueError, match="one device"):
        spectral_edge(carries, specs, t.cpu(), plan)
    with pytest.raises(ValueError, match="one device"):
        spectral_whole(carries, specs, t.cpu(), plan)
    with pytest.raises(ValueError, match="one device"):
        spectral_whole(carries, specs, t, plan, out=out.cpu())
    with pytest.raises(ValueError, match="one device"):
        spectral_edge([carries[0].cpu(), *carries[1:]], specs, t, plan)
    assert launches("K3s") == before


def test_spectral_whole_of_an_all_edge_plan_is_zeros_on_the_card(cuda):
    # The Bela config's 8192 and 4096 records alone: at hops 1 every frame
    # goes to the edge product, so spectral_whole launches nothing and its
    # out=None result must be exact zeros, not unwritten memory.
    from upmix_tpu_torch.ops.pool import _plan_stream_buckets, plan_from_stream_buckets, spectral_whole

    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048)
    records = [r for r in _plan_stream_buckets(cfg, 2048) if r.block_size in (8192, 4096)]
    S = 64
    plan = plan_from_stream_buckets(records, 2048, 4, S, cuda, ola="spectral")
    assert all(not whole for _, whole in plan.spectral_routes(1).frames)
    gen = torch.Generator(cuda).manual_seed(0)
    carries = [torch.randn(b.spectral_carry_shape(S), device=cuda, generator=gen) for b in plan.buckets]
    specs = [torch.randn((S, 3, b.passes, b.kept, 2), device=cuda, generator=gen) for b in plan.buckets]
    t = torch.full((S,), 9, dtype=torch.int32, device=cuda)
    for _ in range(3):  # reuse of freed blocks of the caching allocator
        torch.full((S, 3, 2048), float("nan"), device=cuda)
        before = launches("K3s")
        out = spectral_whole(carries, specs, t, plan)
        torch.cuda.synchronize()
        assert launches("K3s") == before and out.shape == (S, 3, 2048) and not out.any()


@pytest.mark.parametrize("ola", ["time", "spectral"])
def test_aot_pool_artifact_on_the_card(cuda, ola, tmp_path):
    # A pool artifact saved on the host loads onto the card, launches the
    # pool kernels and equals the live pool bit for bit, at hops 1 and 4.
    from upmix_tpu_torch import aot
    from upmix_tpu_torch.models.streaming import CudaStreamPool

    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048)
    S = 8
    rng = np.random.default_rng(0)
    for hops in (1, 4):
        path = str(tmp_path / f"pool{hops}.upmixaot")
        aot.save_stream_pool(path, cfg, 2048, S, ola=ola, hops=hops)
        art = aot.load(path)
        live = CudaStreamPool(cfg, 2048, S, ola=ola)
        before = launches("K3") + launches("K3s")
        for _ in range(3):
            x = rng.standard_normal((2, S, hops * 2048)).astype(np.float32)
            push = (lambda p: p.push_blocks_multi(x[0], x[1])) if hops > 1 else (lambda p: p.push_blocks(x[0], x[1]))
            for got, want in zip(push(art), push(live)):
                assert torch.equal(got, want)
        assert launches("K3") + launches("K3s") > before


@pytest.mark.parametrize("ola", ["time", "spectral"])
def test_mesh_pool_on_the_card(cuda, ola):
    # data = 2 over the one card, repeated: the shards run as rows of one
    # launch a bucket (the unsharded pool's launches), bit for bit the
    # unsharded pool.
    from upmix_tpu_torch.models.streaming import CudaStreamPool
    from upmix_tpu_torch.ops import pool
    from upmix_tpu_torch.parallel import make_mesh

    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048)
    S, hw = 64, 2048
    mesh = make_mesh({"data": 2}, devices=[cuda] * 2)
    shard = CudaStreamPool(cfg, hw, S, device=cuda, mesh=mesh, ola=ola)
    plain = CudaStreamPool(cfg, hw, S, device=cuda, ola=ola)
    assert shard.plan.n_streams == S // 2
    count = (lambda: launches("K3s")) if ola == "spectral" else (lambda: launches("K3"))
    if ola == "spectral":
        per_call = pool.spectral_launches(shard.plan, 1)
    else:
        per_call = sum(pool.launches_per_bucket(x.block) for x in shard.plan.buckets)
    blocks = torch.randn((6, 2, S, hw), device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    for b in blocks:
        before = count()
        got = torch.stack(shard.push_blocks(b[0], b[1]))
        assert count() - before == per_call
        assert torch.equal(got, torch.stack(plain.push_blocks(b[0], b[1])))


# The fused bucket kernel (K2) and the sharded and batch paths.

FUSED_CASES = {
    # (edges, config kwargs, chunk): several thread blocks per segment,
    # H = 32 and 64 (below the 64-wide column tile), eight frames per
    # output sample (overlap 0.875), and the bench config's 256 bucket.
    "small": (([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512)), 8192),
    "overlap_0875": (([0.0, 400.0], dict(sr=8000.0, max_block_size=256, overlap=0.875)), 4096),
    "bench_narrow": (([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], dict(sr=44100.0)), 65536),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
@pytest.mark.parametrize("S", [1, 5])
def test_fused_kernel_matches_plain_float64(cuda, case, S):
    # FP32 products against float64 FFTs: ~120 dB in practice; 90 dB bar.
    from upmix_tpu_torch.ops.fused import fused_bucket_lcr_batch, fused_bucket_lcr_batch_plain
    from upmix_tpu_torch.parallel.sharded import _plan_seq_buckets, route_buckets

    (edges, kw), chunk = FUSED_CASES[case]
    _, buckets = route_buckets(plans_from_numpy(_plan_seq_buckets(UpmixConfig.make(edges, **kw)), cuda), chunk)
    assert buckets
    rng = np.random.default_rng(S)
    for b in buckets:
        x = torch.as_tensor(rng.standard_normal((S, 2, chunk + b.spill)), dtype=torch.float32, device=cuda)
        x[0, :, 100:300] = 0.0  # a silent stretch inside the first segment
        before = launches("K2")
        got = torch.cat(fused_bucket_lcr_batch(x, b), dim=-1)
        torch.cuda.synchronize()
        assert launches("K2") - before == 1
        ref = torch.cat(fused_bucket_lcr_batch_plain(x.double(), b), dim=-1)
        for o in range(3):
            assert _snr(ref[:, o], got[:, o]) > 90.0, (b.block, o)


# K2's buckets at every frame-pass size frame_pass picks for them (G
# frames a pass: 16, 8, 4, 2, 1 with paired Rs) and a 65536-point bucket
# that the gate admits (K <= 14), which takes the two-stage split:
# (block, hop, first kept bin, kept bins, G, launches).
FUSED_BUCKETS = {
    "g16": (256, 64, 1, 95, 16, 1),
    "g8": (512, 128, 0, 129, 8, 1),
    "g4": (1024, 256, 3, 190, 4, 1),
    "g2": (4096, 1024, 2, 190, 2, 1),
    "g1_paired_8192": (8192, 2048, 0, 100, 1, 1),
    "g1_paired_16384": (16384, 4096, 5, 50, 1, 1),
    "split_65536": (65536, 16384, 1, 14, 1, 2),
}


def _bucket_plan(block, hop, lo, kept, seed):
    """A live bucket of two bands keeping bins lo .. lo + kept - 1."""
    from upmix_tpu_torch.models.offline import _BucketPlan
    from upmix_tpu_torch.ops.windows import design_wola_synthesis_window, make_window

    aw = make_window("blackman_harris", block)
    gains = np.zeros((2, block // 2 + 1), np.float32)
    gains[:, lo : lo + kept] = np.random.default_rng(seed).uniform(0.1, 1.0, (2, kept))
    return _BucketPlan(block, hop, 1, block, aw, design_wola_synthesis_window(aw, 1 - hop / block), gains)


@pytest.mark.parametrize("case", list(FUSED_BUCKETS))
@pytest.mark.parametrize("S", [1, 5])
def test_fused_kernel_every_frame_pass(cuda, case, S):
    # FP32 FFTs against float64 FFTs, >= 90 dB; two calls the same bits.
    from upmix_tpu_torch.ops.fused import fused_bucket_lcr_batch, fused_bucket_lcr_batch_plain, takes_fused
    from upmix_tpu_torch.ops.omnibus import frame_pass, make_bucket

    block, hop, lo, kept, G, want = FUSED_BUCKETS[case]
    b = make_bucket(_bucket_plan(block, hop, lo, kept, S), cuda)
    assert takes_fused(b) and b.kept == kept
    if b.wide is None:
        assert frame_pass(block, kept) == (G, G == 1)
    chunk = 4 * block
    x = torch.randn((S, 2, chunk + b.spill), device=cuda, generator=torch.Generator(cuda).manual_seed(S))
    before = launches("K2")
    got = torch.cat(fused_bucket_lcr_batch(x, b), dim=-1)
    torch.cuda.synchronize()
    assert launches("K2") - before == want
    assert torch.equal(got, torch.cat(fused_bucket_lcr_batch(x, b), dim=-1))
    ref = torch.cat(fused_bucket_lcr_batch_plain(x.double(), b), dim=-1)
    for o in range(3):
        assert _snr(ref[:, o], got[:, o]) > 90.0, (case, o)


def test_block_of_2p21_through_the_split(cuda):
    # A 2^21-point bucket (the split's N2 grown to 256): K1 against its
    # float64 plain version, >= 80 dB; the Upmixer at max_block_size 2^21
    # runs on the card and matches the float64 whole-file path.
    from upmix_tpu_torch.ops.omnibus import make_bucket

    b = make_bucket(_bucket_plan(2**21, 2**19, 0, 700, 21), cuda)
    assert (b.wide.n1, b.wide.n2, b.wide.cols) == (8192, 256, 1)
    plan = make_omnibus_plan([b], 2**21)
    x = torch.randn((1, 2, 2**21 + plan.halo), device=cuda, generator=torch.Generator(cuda).manual_seed(21))
    got = torch.cat(omnibus_lcr_batch(x, plan), dim=-1)
    ref = torch.cat(omnibus_lcr_batch_plain(x.double(), plan), dim=-1)
    for o in range(3):
        assert _snr(ref[:, o], got[:, o]) >= 80.0, o
    cfg = UpmixConfig.make([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], sr=44100.0, max_block_size=2**21)
    L, R = x[0, 0, : 2**21], x[0, 1, : 2**21]
    up = Upmixer(cfg, device=cuda)
    before = launches("K1")
    out = up.process(L, R)
    want_launches = sum(launches_per_bucket(bb.block) for bb in plans_from_numpy(_plan_buckets(cfg, 1), "cpu"))
    assert launches("K1") - before == want_launches == 8  # 2^21 and 65536 split, four buckets of one launch
    want = build_offline_fn(cfg, 2**21, chunk=0, device=cuda)(L.double(), R.double())
    for r, g in zip(want, out):
        assert _snr(r, g) >= 60.0


def test_sharded_upmixer_launches_both_kernels(cuda):
    # A 2 x 4 mesh on one card: per call one K2 launch per narrow bucket
    # and K1's launches per wide bucket; matches the float64 whole-file
    # path and the unsharded Upmixer.
    from upmix_tpu_torch.parallel import ShardedUpmixer, make_mesh
    from upmix_tpu_torch.parallel.sharded import _plan_seq_buckets, route_buckets

    cfg = UpmixConfig.make([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], sr=44100.0)
    su = ShardedUpmixer(cfg, make_mesh({"data": 2, "seq": 4}, devices=[cuda] * 8))
    x = torch.randn((2, 2, 2**18), device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    omni, narrow = route_buckets(plans_from_numpy(_plan_seq_buckets(cfg), "cpu"), 2**16)
    k1, k2 = launches("K1"), launches("K2")
    y = su.process_batch(x)
    torch.cuda.synchronize()
    want = (sum(launches_per_bucket(b.block) for b in omni.buckets), len(narrow))
    assert (launches("K1") - k1, launches("K2") - k2) == want == (3, 3)
    for i in range(2):
        ref = build_offline_fn(cfg, 2**18, chunk=0, device=cuda)(x[i, 0].double(), x[i, 1].double())
        for o in range(3):
            assert _snr(ref[o], y[i, o]) > 90.0
        single = torch.stack(Upmixer(cfg, device=cuda).process(x[i, 0], x[i, 1]))
        assert float((single - y[i]).abs().max()) < 1e-3


@pytest.mark.parametrize("kw", [dict(overlap=0.65), dict(max_block_size=3000)], ids=["overlap_065", "block_3000"])
def test_geometries_no_kernel_takes_run_on_torch_fft(cuda, kw):
    # Hop not dividing the block, or a block that is not a power of two:
    # Upmixer and BatchUpmixer run the whole config on torch.fft and launch
    # no kernel; ShardedUpmixer keeps the buckets of kernel geometry on
    # K2/K1 (the 1024 bucket of max_block_size 3000 on K2) and runs the
    # rest inside each shard.  All match the float64 whole-file program.
    from upmix_tpu_torch.models import BatchUpmixer
    from upmix_tpu_torch.parallel import ShardedUpmixer, make_mesh
    from upmix_tpu_torch.parallel.sharded import route_buckets, split_plans

    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, **{"max_block_size": 512, **kw})
    n = 3 * 2**15 + 11
    x = torch.randn((2, 2, n), device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    k1, k2 = launches("K1"), launches("K2")
    up = Upmixer(cfg, device=cuda)
    got = torch.stack(up.process(x[0, 0], x[0, 1]))
    batch = BatchUpmixer(cfg, n, 2, device=cuda)
    rows = list(batch.process_files([a.cpu().numpy() for a in x]))
    torch.cuda.synchronize()
    assert (launches("K1"), launches("K2")) == (k1, k2) and not up.kernel_path
    su = ShardedUpmixer(cfg, make_mesh({"data": 2, "seq": 2}, devices=[cuda] * 4))
    sharded = su.process_batch(x)
    torch.cuda.synchronize()
    omni, narrow = route_buckets(plans_from_numpy(split_plans(cfg)[0], "cpu"), su._compiled(n)[1].chunk)
    want = (sum(launches_per_bucket(b.block) for b in omni.buckets) if omni else 0, len(narrow))
    assert (launches("K1") - k1, launches("K2") - k2) == want == ((0, 1) if "max_block_size" in kw else (0, 0))
    for i in range(2):
        ref = build_offline_fn(cfg, n, chunk=0, device=cuda)(x[i, 0].double(), x[i, 1].double())
        for o in range(3):
            assert _snr(ref[o], sharded[i, o]) >= 60.0 and _snr(ref[o], torch.as_tensor(rows[i][o])) >= 60.0
            if i == 0:
                assert _snr(ref[o], got[o]) >= 60.0
        assert float((torch.as_tensor(rows[i], device=cuda) - sharded[i]).abs().max()) < 1e-3


def test_custom_window_launches_the_kernels(cuda):
    # A registered window reaches K1 and K3 as arrays of their plans.
    from upmix_tpu_torch.models.streaming import CudaStreamPool, make_stream_pool
    from upmix_tpu_torch.ops.pool import pool_step_lcr_plain
    from upmix_tpu_torch.ops.windows import register_window_vector

    name = register_window_vector("gpu_test_kaiser", np.kaiser(1000, 8.0), overwrite=True)
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512, window=name)
    x = torch.randn((2, 5000), device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    before = launches("K1")
    got = Upmixer(cfg, device=cuda).process(x[0], x[1])
    assert launches("K1") - before == 2  # buckets 512 and 256
    for r, g in zip(build_offline_fn(cfg, 5000, chunk=0, device=cuda)(x[0].double(), x[1].double()), got):
        assert _snr(r, g) >= 60.0
    scfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=256, window=name)
    sp = make_stream_pool(scfg, 256, 4, device=cuda)
    assert type(sp) is CudaStreamPool
    blocks = torch.randn((8, 2, 4, 256), device=cuda, generator=torch.Generator(cuda).manual_seed(7))
    before = launches("K3")
    outs = torch.stack([torch.stack(sp.push_blocks(b[0], b[1])) for b in blocks])  # [T, 3, S, hw]
    assert launches("K3") > before
    K = sp.plan.warmup
    h = torch.cat([blocks.new_zeros((4, 2, (K - 1) * 256)), blocks.permute(2, 1, 0, 3).reshape(4, 2, -1)], -1)
    ref, _ = pool_step_lcr_plain(h.double(), torch.ones(4, dtype=torch.int32, device=cuda),
                                 [h.new_zeros((4, 3, b.block), dtype=torch.float64) for b in sp.plan.buckets],
                                 sp.plan, 8)
    got = outs.permute(2, 1, 0, 3).reshape(4, 3, -1)
    assert _snr(ref[..., (K - 1) * 256 :], got[..., (K - 1) * 256 :]) >= 60.0


def test_batch_upmixer_pipelined_on_cuda(cuda):
    from upmix_tpu_torch.models import BatchUpmixer

    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    rng = np.random.default_rng(3)
    files = [rng.standard_normal((2, n)).astype(np.float32) for n in (4096, 3000, 4096)]
    bu = BatchUpmixer(cfg, 4096, 2, device=cuda)
    before = launches("K1")
    seq = list(bu.process_files(files))
    assert launches("K1") - before == 2 * 2  # two batches, one launch per bucket (512 and 256)
    piped = list(bu.process_files(files, pipeline=True))
    for f, a, b in zip(files, seq, piped):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (3, f.shape[-1])


@pytest.mark.parametrize("variant", ["bf16x3", "bf16x1", "int8x3", "int8x3f", "int8x1", "fp32", "tf32x3"])
def test_dot_chain_kernel_matches_plain(cuda, variant):
    # K4: the integer variants take the plain version's float ops in its
    # order (exact products): bit for bit.  The float ones differ in each
    # product's own sum order: within int8_dot.APPLY_TOLERANCE after one
    # apply, int8_dot.CHAIN_TOLERANCE (coarse) over a chain of 8.
    from upmix_tpu_torch.ops import int8_dot

    consts = int8_dot.make_consts(variant, cuda)
    x = torch.from_numpy(int8_dot.start_x(64)).to(cuda)
    for chain in (1, 8):
        before = launches("K4")
        got = int8_dot.int8_dot_chain(x, variant, chain, consts)
        torch.cuda.synchronize()
        assert launches("K4") - before == 1
        ref = int8_dot.int8_dot_chain_plain(x, variant, chain, consts)
        assert bool(torch.isfinite(got).all())
        if variant in int8_dot.EXACT:
            assert torch.equal(got, ref)
        else:
            limit = int8_dot.APPLY_TOLERANCE if chain == 1 else int8_dot.CHAIN_TOLERANCE[variant]
            assert float((got - ref).abs().max() / ref.abs().max()) <= limit
    assert torch.equal(int8_dot.int8_dot_chain(x, variant, 0, consts), x)


@pytest.mark.parametrize("M", [32, 96, 512, 4224])
@pytest.mark.parametrize("variant", ["bf16x3", "bf16x1", "int8x3", "int8x3f", "int8x1", "fp32", "tf32x3"])
def test_dot_chain_kernel_each_cluster_size(cuda, variant, M):
    # The card's choice of cluster size at each M (one CTA a strip at
    # 4224), and every size at M = 32, 96 and 512 (W resident or from L2,
    # one wave or two): the int8 rungs bit for bit, the float rungs within
    # APPLY_TOLERANCE after one apply and CHAIN_TOLERANCE over 64.
    from upmix_tpu_torch.ops import int8_dot

    resident, at_once = int8_dot.card_clusters(variant)
    chosen = int8_dot.cluster_size(M, resident, at_once)
    assert chosen == 1 if M == 4224 else chosen in int8_dot.CLUSTER_SIZES
    consts = int8_dot.make_consts(variant, cuda)
    x = torch.from_numpy(int8_dot.start_x(M)).to(cuda)
    for cs in (None,) if M == 4224 else (None, *int8_dot.CLUSTER_SIZES):
        for chain, limit in ((1, int8_dot.APPLY_TOLERANCE), (int8_dot.CHAIN, int8_dot.CHAIN_TOLERANCE.get(variant))):
            got = int8_dot.dot_cuda(x, variant, chain, consts, cs)
            ref = int8_dot.int8_dot_chain_plain(x, variant, chain, consts)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got).all())
            if variant in int8_dot.EXACT:
                assert torch.equal(got, ref), (cs, chain)
            else:
                assert float((got - ref).abs().max() / ref.abs().max()) <= limit, (cs, chain)


def test_dot_chain_kernel_rejects_what_it_does_not_take(cuda):
    from upmix_tpu_torch.ops import int8_dot

    consts = int8_dot.make_consts("bf16x3", cuda)
    x = torch.zeros((64, 512), device=cuda)
    for bad in (x.double(), torch.zeros((48, 512), device=cuda), torch.zeros((512, 64), device=cuda).t()):
        with pytest.raises(ValueError):
            int8_dot.int8_dot_chain(bad, "bf16x3", 1, consts)
    with pytest.raises(ValueError):  # a cluster size the kernel does not take
        int8_dot.dot_cuda(x, "bf16x3", 1, consts, 16)
    with pytest.raises(ValueError):  # K other than 512
        int8_dot.int8_dot_chain(torch.zeros((64, 256), device=cuda), "bf16x3", 1,
                                int8_dot.make_consts("bf16x3", cuda, 256))
    with pytest.raises(ValueError):  # consts on another device
        int8_dot.int8_dot_chain(x, "bf16x3", 1, int8_dot.make_consts("bf16x3", "cpu"))


@pytest.mark.parametrize("config", [(1, 0, 128), (2, 0, 128), (4, 0, 128), (4, 16, 128), (4, 56, 128),
                                    (4, 56, 49152)])
def test_overhead_probe_bit_exact(cuda, config):
    from upmix_tpu_torch.ops import overhead_probe as op

    n_views, n_weights, halo = config
    for n, tile in ((op.N, op.TILE), (8 * 4096, 4096), (4 * 8192, 8192), (6 * 1000, 1000)):
        x, rng = op.make_inputs(n, tile, cuda)
        weights = op.make_weights(n_weights, rng, cuda)
        seed = torch.tensor(0.125, device=cuda)
        before = launches("K5")
        out, spill = op.overhead_probe(x, seed, weights, n_views, halo, tile)
        torch.cuda.synchronize()
        assert launches("K5") - before == 1
        ref, ref_spill = op.overhead_probe_plain(x, seed, weights, n_views, halo, tile)
        assert torch.equal(out, ref) and torch.equal(spill, ref_spill)


@pytest.mark.parametrize("n_views", [1, 2, 3, 4])
def test_overhead_probe_awkward_geometries(cuda, n_views):
    # Odd tile counts (13, 5, 3, 1), tiles smaller than a stage's piece
    # (1000 and 2048 floats), a ragged last piece (6144 = 4096 + 2048), a
    # halo larger than the tile, more steps than the ring has slots (a
    # 16384 tile: 4 pieces x 4 views = 16 steps through 6 slots), 1-4
    # views.
    from upmix_tpu_torch.ops import overhead_probe as op

    for n_tiles, tile, halo in ((13, 1000, 4099), (5, 6144, 8192), (3, 16384, 49152), (1, 2048, 5)):
        x, rng = op.make_inputs(n_tiles * tile, tile, cuda, seed=n_tiles)
        weights = op.make_weights(3, rng, cuda)
        seed = torch.tensor(-0.5, device=cuda)
        out, spill = op.overhead_probe(x, seed, weights, n_views, halo, tile)
        torch.cuda.synchronize()
        ref, ref_spill = op.overhead_probe_plain(x, seed, weights, n_views, halo, tile)
        assert torch.equal(out, ref) and torch.equal(spill, ref_spill), (n_tiles, tile, halo)


def test_overhead_probe_cold_protocol_runs(cuda):
    # The cold-L2 protocol and the yardstick at a small size: the library
    # call computes the function too (x + (seed + s) rounds once less, so
    # within an ulp or two).
    from upmix_tpu_torch.ops import overhead_probe as op

    n, tile = 16 * 1024, 1024
    x, rng = op.make_inputs(n, tile, cuda)
    weights = op.make_weights(2, rng, cuda)
    seed = torch.tensor(0.25, device=cuda)
    ref, _ = op.overhead_probe_plain(x, seed, weights, 4, 128, tile)
    lib = op.library_call(x, seed + sum(w[0, 0] for w in weights), n)
    torch.testing.assert_close(lib, ref, rtol=1e-6, atol=1e-6)
    xs = [x, x.clone()]
    ms = op.cold_ms(lambda x_: op.overhead_probe(x_, seed, weights, 4, 128, tile), xs)
    assert 0 < ms < 100


def test_overhead_probe_rejects_what_it_does_not_take(cuda):
    from upmix_tpu_torch.ops import overhead_probe as op

    x, rng = op.make_inputs(4 * 1024, 1024, cuda)
    seed = torch.zeros((), device=cuda)
    with pytest.raises(ValueError):
        op.overhead_probe(x.double(), seed.double(), [], 1, 128, 1024)
    with pytest.raises(ValueError):  # a weight that is not contiguous
        op.overhead_probe(x, seed, [torch.zeros((128, 128), device=cuda).t()[:, :64]], 1, 128, 1024)
    with pytest.raises(ValueError):  # a length the 16-byte staging cannot take
        op.overhead_probe(x[..., :-2].contiguous(), seed, [], 1, 128, 1024, n=3 * 1024)


def test_pool_plan_on_the_card_carries_the_split_tables(cuda):
    # A CPU plan leaves the two-stage split's tables out (test_torch_pool);
    # a plan for the card builds them for its bucket over 16384 points,
    # with the split's N1 pass twiddles (fft.cuh's), and the register
    # core's twiddles for the others, in both OLA modes.
    from upmix_tpu_torch.ops.fftplan import pass_twiddles, reg_twiddles
    from upmix_tpu_torch.ops.pool import make_pool_plan

    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=8192)
    for ola in ("time", "spectral"):
        plan = make_pool_plan(cfg, 8192, 2, device=cuda, ola=ola)
        big = [b for b in plan.buckets if b.block > 16384]
        assert big and all(b.wide is not None and b.twiddles is not None for b in big)
        assert all(b.twiddles.device.type == "cuda" for b in plan.buckets)
        for b in plan.buckets:
            want = pass_twiddles(b.wide.n1) if b.block > 16384 else reg_twiddles(b.block)
            assert torch.equal(b.twiddles.cpu(), torch.as_tensor(want))


@pytest.mark.parametrize("hops,pipeline", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_stream_server_on_the_card_matches_the_pool_fed_directly(cuda, hops, pipeline):
    # Two sessions on a CudaStreamPool on the card, in lockstep: the server
    # launches K3, and each client's frames equal, bit for bit, a second
    # pool on the card fed the same blocks at the same slots (the same
    # kernels on the same inputs), warmup-aligned.
    from upmix_tpu_torch.models.streaming import CudaStreamPool
    from upmix_tpu_torch.serve_stream import StreamServer, StreamSession

    hw, S, n_blocks = 256, 6, 10
    cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=hw)
    rng = np.random.default_rng(hops * 10 + pipeline)
    x = rng.standard_normal((2, n_blocks, hw, 2)).astype(np.float32) * 0.3  # [client, block, frame, ch]
    direct = CudaStreamPool(cfg, hw, S, device=cuda)
    skip = (direct.warmup_blocks - 1) * hw
    # The server's cycles: hops blocks each, then drain cycles of zero
    # blocks until the output catches up with the input.
    total = -(-(n_blocks + direct.warmup_blocks - 1) // hops) * hops
    xs = np.zeros((S, total * hw, 2), np.float32)
    xs[:2, : n_blocks * hw] = x.reshape(2, n_blocks * hw, 2)
    push = direct.push_blocks_multi if hops > 1 else direct.push_blocks
    want = [np.stack([o.cpu().numpy()[:2] for o in push(xs[:, i : i + hops * hw, 0], xs[:, i : i + hops * hw, 1])],
                     -1) for i in range(0, total * hw, hops * hw)]  # [2, hops * hw, 3] each
    want = np.concatenate(want, axis=1)[:, skip : skip + n_blocks * hw]
    before = launches("K3")
    with StreamServer(CudaStreamPool(cfg, hw, S, device=cuda), lockstep=True, hops=hops,
                      pipeline=pipeline) as srv:
        sessions = [StreamSession(*srv.address, mix="lcr") for _ in range(2)]
        assert [s.slot for s in sessions] == [0, 1]
        for b in range(n_blocks):
            for c, s in enumerate(sessions):
                s.send_block(x[c, b, :, 0], x[c, b, :, 1])
        for s in sessions:
            s.finish()
        got = np.stack([s.recv_frames(n_blocks * hw) for s in sessions])
        for s in sessions:
            s.close()
    assert launches("K3") > before
    np.testing.assert_array_equal(got, want)


# One process over several cards (`-k devices`; two or more cards, else
# skipped): every launch on its tensors' card, the current device left as
# the caller had it.  Kernel rows by device come from torch.profiler
# (`utils/profiling.py::kernel_rows_by_device`), so a launch on the wrong
# card fails.

BENCH_EDGES = [0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0]
POOL_EDGES = [0.0, 500.0, 2000.0, 8000.0]
OMNI_ROWS = ("OmniSink",)  # K1 and K2 (K1's kernels on one bucket)
POOL_ROWS = ("PoolSink", "SpectralSink", "spectral_")  # K3 and K3s


@pytest.fixture
def cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices, {n} here")
    return [torch.device("cuda", i) for i in range(min(n, 4))]


def _rows(fn, match):
    from upmix_tpu_torch.utils.profiling import kernel_rows_by_device

    return kernel_rows_by_device(fn, match=match)[0]


def test_devices_upmixer_on_card_1_is_card_0_bit_for_bit(cards):
    cfg = UpmixConfig.make(BENCH_EDGES, sr=44100.0)
    rng = np.random.default_rng(0)
    L, R = rng.standard_normal((2, 2**19)).astype(np.float32)
    want = Upmixer(cfg, device="cuda:0").process_np(L, R)
    up = Upmixer(cfg, device="cuda:1")
    assert torch.cuda.current_device() == 0
    got = up.process_np(L, R)
    assert torch.cuda.current_device() == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _rows(lambda: up.process(L, R), OMNI_ROWS) == {1: 6}  # one a bucket, two for 65536


def test_devices_launch_under_another_current_device_and_stream(cards):
    # The caller's current device is cuda:1 with a stream of its own; a
    # launch on cuda:0 goes to cuda:0's current stream and the caller's
    # device and stream are as they were after it.
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    x = np.random.default_rng(1).standard_normal((2, 8192)).astype(np.float32)
    want = Upmixer(cfg, device="cuda:0").process_np(x[0], x[1])
    up = Upmixer(cfg, device="cuda:0")
    side = torch.cuda.Stream(device="cuda:1")
    with torch.cuda.device(1), torch.cuda.stream(side):
        got = up.process_np(x[0], x[1])
        assert torch.cuda.current_device() == 1 and torch.cuda.current_stream() == side
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_devices_sharded_over_distinct_cards(cards):
    from upmix_tpu_torch.parallel import ShardedUpmixer, make_mesh

    cfg = UpmixConfig.make(BENCH_EDGES, sr=44100.0)
    axes = {"data": 2, "seq": 2} if len(cards) >= 4 else {"seq": 2}
    n = int(np.prod(list(axes.values())))
    x = torch.randn((2, 2, 2**19), device="cuda:0", generator=torch.Generator("cuda:0").manual_seed(3))
    want = ShardedUpmixer(cfg, make_mesh(axes, devices=[cards[0]] * n)).process_batch(x)
    su = ShardedUpmixer(cfg, make_mesh(axes))
    k1, k2 = launches("K1"), launches("K2")
    got = su.process_batch(x)
    assert torch.cuda.current_device() == 0 and got.device == torch.device("cuda", 0)
    assert (launches("K1") - k1, launches("K2") - k2) == (3 * n, 3 * n)  # 3 and 3 on every card
    # Row counts change K1/K2's OLA grouping: float32 rounding apart.
    assert float((got - want).abs().max()) < 1e-5
    assert _rows(lambda: su.process_batch(x), OMNI_ROWS) == {i: 6 for i in range(n)}


@pytest.mark.parametrize("pipeline", [False, True])
def test_devices_batch_over_distinct_cards(cards, pipeline):
    from upmix_tpu_torch.models import BatchUpmixer
    from upmix_tpu_torch.parallel import make_mesh

    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    rng = np.random.default_rng(4)
    files = [rng.standard_normal((2, n)).astype(np.float32) for n in (4096, 3000, 4096, 2048) * len(cards)]
    one = list(BatchUpmixer(cfg, 4096, len(cards), device="cuda:0").process_files(files))
    bu = BatchUpmixer(cfg, 4096, len(cards), mesh=make_mesh({"data": len(cards)}))
    got = list(bu.process_files(files, pipeline=pipeline))
    assert torch.cuda.current_device() == 0
    for a, b in zip(got, one):
        assert a.shape == b.shape and float(np.abs(a - b).max()) < 1e-5
    x = torch.as_tensor(np.stack([np.pad(f, ((0, 0), (0, 4096 - f.shape[1]))) for f in files[: len(cards)]]))
    assert _rows(lambda: bu._fn(x.to("cuda:0")), OMNI_ROWS) == {i: 2 for i in range(len(cards))}


@pytest.mark.parametrize("ola", ["time", "spectral"])
def test_devices_pool_over_distinct_cards(cards, ola):
    # Each card steps its shard's streams; the same kernels on fewer rows
    # a launch: within 1e-5 of the unsharded pool (K3/K3s's launch
    # geometry follows the row count), snapshots across the two.
    from upmix_tpu_torch.models.streaming import CudaStreamPool
    from upmix_tpu_torch.parallel import make_mesh

    cfg = UpmixConfig.streaming(POOL_EDGES, sr=48000.0, hw_block_size=2048)
    S, hw = 16 * len(cards), 2048
    mesh_pool = CudaStreamPool(cfg, hw, S, mesh=make_mesh({"data": len(cards)}), ola=ola)
    plain = CudaStreamPool(cfg, hw, S, device="cuda:0", ola=ola)
    rng = np.random.default_rng(5)
    for _ in range(6):
        b = rng.standard_normal((2, S, hw)).astype(np.float32)
        got = torch.stack(mesh_pool.push_blocks(b[0], b[1]))
        want = torch.stack(plain.push_blocks(b[0], b[1]))
        assert got.device == torch.device("cuda", 0) and torch.cuda.current_device() == 0
        assert float((got - want).abs().max()) < 1e-5
    again = CudaStreamPool(cfg, hw, S, device="cuda:0", ola=ola)
    again.restore(mesh_pool.snapshot())
    b = rng.standard_normal((2, S, hw)).astype(np.float32)
    assert float((torch.stack(again.push_blocks(b[0], b[1])) - torch.stack(mesh_pool.push_blocks(b[0], b[1])))
                 .abs().max()) < 1e-5
    rows = _rows(lambda: mesh_pool.push_blocks(b[0], b[1]), POOL_ROWS)
    assert sorted(rows) == list(range(len(cards))) and len(set(rows.values())) == 1


def test_devices_pool_cards_step_together(cards):
    # Every card's input leaves card 0 before card 0 steps, so the other
    # cards' K3 runs beside card 0's, not after it: at 2048 streams a
    # card, each other card's first K3 row of a traced block begins before
    # card 0's last one ends.  Each card's rows are a one-card pool of its
    # 2048 streams on cuda:0 bit for bit (the same rows a launch).
    from upmix_tpu_torch.models.streaming import CudaStreamPool
    from upmix_tpu_torch.parallel import make_mesh
    from upmix_tpu_torch.utils.profiling import kernel_rows_by_device

    cfg = UpmixConfig.streaming(POOL_EDGES, sr=48000.0, hw_block_size=2048)
    local, hw, n = 2048, 2048, len(cards)
    mesh_pool = CudaStreamPool(cfg, hw, local * n, mesh=make_mesh({"data": n}))
    ones = [CudaStreamPool(cfg, hw, local, device="cuda:0") for _ in range(n)]
    x = torch.randn((3, 2, local * n, hw), device="cuda:0", generator=torch.Generator("cuda:0").manual_seed(20))
    got = [torch.stack(mesh_pool.push_blocks(b[0], b[1])) for b in x[:2]]
    _, rows = kernel_rows_by_device(lambda: got.append(torch.stack(mesh_pool.push_blocks(x[2, 0], x[2, 1]))),
                                    match=POOL_ROWS, warm=False)
    for b, g in zip(x, got):
        want = [torch.stack(o.push_blocks(b[0, k * local : (k + 1) * local], b[1, k * local : (k + 1) * local]))
                for k, o in enumerate(ones)]
        assert g.device == torch.device("cuda", 0) and torch.equal(g, torch.cat(want, dim=1))
    last_end = max(end for dev, _, _, end in rows if dev == 0)
    for k in range(1, n):
        first = min(start for dev, _, start, _ in rows if dev == k)
        assert first < last_end, (k, first, last_end, rows)


def test_devices_stream_pool_on_card_1(cards):
    from upmix_tpu_torch.models.streaming import make_stream_pool

    cfg = UpmixConfig.streaming(POOL_EDGES, sr=48000.0, hw_block_size=2048)
    one = make_stream_pool(cfg, 2048, 8, device="cuda:1")
    zero = make_stream_pool(cfg, 2048, 8, device="cuda:0")
    rng = np.random.default_rng(6)
    for _ in range(4):
        b = rng.standard_normal((2, 8, 2048)).astype(np.float32)
        got = torch.stack(one.push_blocks(b[0], b[1]))
        assert got.device == torch.device("cuda", 1) and torch.cuda.current_device() == 0
        assert torch.equal(got.cpu(), torch.stack(zero.push_blocks(b[0], b[1])).cpu())
    assert set(_rows(lambda: one.push_blocks(b[0], b[1]), POOL_ROWS)) == {1}


def test_devices_a_launch_over_two_cards_raises(cards):
    from upmix_tpu_torch.ops.fused import fused_bucket_lcr_batch
    from upmix_tpu_torch.ops.pool import make_pool_plan, pool_step_lcr

    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    plan = make_omnibus_plan(plans_from_numpy(_plan_buckets(cfg, 2048), "cuda:0"), 2048)
    x = torch.zeros((1, 2, 2048 + plan.halo), device="cuda:1")
    with pytest.raises(ValueError, match="plan buckets live on cuda:0, input on cuda:1"):
        omnibus_lcr_batch(x, plan)
    b = plan.buckets[-1]
    with pytest.raises(ValueError, match="plan buckets live on cuda:0, input on cuda:1"):
        fused_bucket_lcr_batch(torch.zeros((1, 2, 2048 + b.spill), device="cuda:1"), b)
    pcfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=256)
    pplan = make_pool_plan(pcfg, 256, 2, device="cuda:0")
    hist = torch.zeros((2, 2, pplan.warmup * 256), device="cuda:1")
    carries = [torch.zeros((2, 3, pb.block), device="cuda:1") for pb in pplan.buckets]
    with pytest.raises(ValueError, match="plan buckets live on cuda:0, input on cuda:1"):
        pool_step_lcr(hist, torch.ones(2, dtype=torch.int32, device="cuda:1"), carries, pplan)
    carries[0] = carries[0].to("cuda:0")
    with pytest.raises(ValueError, match="on the history's device"):
        pool_step_lcr(hist, torch.ones(2, dtype=torch.int32, device="cuda:1"), carries, pplan)
    assert torch.cuda.current_device() == 0


def test_devices_aot_offline_loaded_onto_card_1(cards, tmp_path):
    from upmix_tpu_torch import aot

    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    path = str(tmp_path / "offline.upmixaot")
    aot.save_offline(path, cfg, 8192)
    art = aot.load(path, device="cuda:1")
    x = np.random.default_rng(7).standard_normal((2, 8192)).astype(np.float32)
    got = art.process(x[0], x[1])
    assert got[0].device == torch.device("cuda", 1) and torch.cuda.current_device() == 0
    for a, b in zip(got, aot.load(path, device="cuda:0").process(x[0], x[1])):
        assert torch.equal(a.cpu(), b.cpu())
    assert set(_rows(lambda: art.process(x[0], x[1]), OMNI_ROWS)) == {1}


def _profiled_spans(fn):
    """The program's spans (utils/tracing.py) of fn under torch.profiler,
    after one call outside it."""
    from torch.profiler import ProfilerActivity, profile

    from upmix_tpu_torch.utils import tracing

    fn()
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    out = tracing.spans()
    tracing.clear()
    return out


@pytest.mark.parametrize("ola", ["time", "spectral"])
def test_spans_count_the_launches(cuda, ola):
    from upmix_tpu_torch.models.streaming import CudaStreamPool

    p = CudaStreamPool(UpmixConfig.streaming(POOL_EDGES, sr=48000.0, hw_block_size=2048), 2048, 16, device=cuda,
                       ola=ola)
    up = Upmixer(UpmixConfig.make(BENCH_EDGES, sr=44100.0), device=cuda)
    rng = np.random.default_rng(8)
    b = rng.standard_normal((2, 16, 2048)).astype(np.float32)
    x = rng.standard_normal((2, 2**19)).astype(np.float32)
    counters = (lambda: (launches("K1"), launches("K3") + launches("K3s")))

    def calls():
        before = counters()
        p.push_blocks(b[0], b[1])
        up.process(x[0], x[1])
        moved.append([a - z for a, z in zip(counters(), before)])

    moved = []
    spans = _profiled_spans(calls)
    roots = {s.name: s.attrs["launches"] for s in spans if s.parent is None}
    assert roots == {"offline.process": moved[-1][0], "pool.push": moved[-1][1]}
    assert roots["offline.process"] == 6  # one a bucket, two for 65536
    assert roots["pool.push"] > 0 and (ola == "spectral" or roots["pool.push"] == 4)  # K3: one a bucket
    (push,) = [s for s in spans if s.name == "pool.push"]
    # K3s's edge product: a gather and a product for its one launch group
    assert push.attrs["edge_launches"] == (2 if ola == "spectral" else 0)


@pytest.mark.parametrize("ola", ["time", "spectral"])
def test_spectral_spans_split_k3s(cuda, ola, tmp_path):
    # Inside each `pool.kernels` span K3s's three steps have spans of their
    # own, on the pool's card, in the exported trace too; the time pool's
    # kernels span holds K3's one, `pool.frames`, with the frames of a
    # stream's call, every one on the register core.
    import json
    import os

    from upmix_tpu_torch.models.streaming import CudaStreamPool
    from upmix_tpu_torch.utils.profiling import trace

    p = CudaStreamPool(UpmixConfig.streaming(POOL_EDGES, sr=48000.0, hw_block_size=2048), 2048, 64, device=cuda,
                       ola=ola)
    b = np.random.default_rng(11).standard_normal((2, 64, 2048)).astype(np.float32)
    spans = _profiled_spans(lambda: p.push_blocks(b[0], b[1]))
    (kernels,) = [s for s in spans if s.name == "pool.kernels"]
    inner = sorted((s for s in spans if s.parent == kernels.id), key=lambda s: s.start_ns)
    if ola == "time":
        assert [(s.name, s.card, s.attrs) for s in inner] == [
            ("pool.frames", 0, {"buckets": 4, "fft_frames": 43, "reg_frames": 43})]
    else:
        routes = p.plan.spectral_routes(1)
        assert [(s.name, s.card) for s in inner] == [("pool.forward", 0), ("pool.edge", 0), ("pool.inverse", 0)]
        # the FFT frames of a stream's call, all of them on the register core
        assert [s.attrs for s in inner] == [
            {"buckets": 4, "fft_frames": 43, "reg_frames": 43},
            {"buckets": 2, "frames": sum(sum(g.n_edge) for g in routes.groups)},
            {"buckets": sum(1 for _, whole in routes.frames if whole), "fft_frames": 46, "reg_frames": 46}]
    with trace(str(tmp_path)):
        p.push_blocks(b[0], b[1])
        torch.cuda.synchronize()
    (path,) = [os.path.join(r, f) for r, _, files in os.walk(tmp_path) for f in files]
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "upmix_tpu_torch"}
    stages = {"pool.forward", "pool.edge", "pool.inverse"}
    assert names & stages == (stages if ola == "spectral" else set())


def test_exported_spans_open_before_their_kernels(cuda, tmp_path):
    # The exported trace maps the spans onto the profiler's clock: each
    # `pool.kernels` span opens before the first K3 row of its push, and
    # every K3 launch (the runtime call the profiler links to the row)
    # starts inside one.
    import json
    import os

    from upmix_tpu_torch.models.streaming import CudaStreamPool
    from upmix_tpu_torch.utils.profiling import trace

    p = CudaStreamPool(UpmixConfig.streaming(POOL_EDGES, sr=48000.0, hw_block_size=2048), 2048, 64, device=cuda)
    blocks = np.random.default_rng(9).standard_normal((4, 2, 64, 2048)).astype(np.float32)
    p.push_blocks(blocks[0, 0], blocks[0, 1])
    torch.cuda.synchronize()
    with trace(str(tmp_path)):
        for b in blocks:
            p.push_blocks(b[0], b[1])
        torch.cuda.synchronize()
    (path,) = [os.path.join(r, f) for r, _, files in os.walk(tmp_path) for f in files]
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e for e in events if e.get("cat") == "upmix_tpu_torch" and e["name"] == "pool.kernels"),
                   key=lambda e: e["ts"])
    rows = sorted((e for e in events if e.get("cat") == "kernel" and "PoolSink" in e["name"]), key=lambda e: e["ts"])
    assert len(spans) == 4 and len(rows) == 4 * 4
    for i, s in enumerate(spans):
        assert s["ts"] < rows[4 * i]["ts"], (s, rows[4 * i])
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    for r in rows:
        launch = launches[r["args"]["correlation"]]
        assert any(s["ts"] <= launch["ts"] <= s["ts"] + s["dur"] for s in spans), (launch, spans)


def test_devices_pool_spans_carry_each_card(cards):
    from upmix_tpu_torch.models.streaming import CudaStreamPool
    from upmix_tpu_torch.ops import pool
    from upmix_tpu_torch.parallel import make_mesh

    S, hw = 16 * len(cards), 2048
    p = CudaStreamPool(UpmixConfig.streaming(POOL_EDGES, sr=48000.0, hw_block_size=hw), hw, S,
                       mesh=make_mesh({"data": len(cards)}))
    b = np.random.default_rng(10).standard_normal((2, S, hw)).astype(np.float32)
    spans = _profiled_spans(lambda: p.push_blocks(b[0], b[1]))
    for name in ("pool.scatter", "pool.step", "pool.gather"):
        assert sorted(s.card for s in spans if s.name == name) == list(range(len(cards))), name
    assert {s.attrs["path"] for s in spans if s.name in ("pool.scatter", "pool.gather")} == {"slice"}
    (root,) = [s for s in spans if s.parent is None]
    assert root.attrs["launches"] == len(cards) * sum(pool.launches_per_bucket(pb.block) for pb in p.plan.buckets)
