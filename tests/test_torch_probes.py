"""The two measurement probes of the port against the TPU scripts.

K4 (`upmix_tpu_torch.ops.int8_dot`): each variant's plain version against
the JAX kernel of `scripts/bench_int8_dot.py` (`build(variant,
interpret=True)`, loaded with importlib at M = K = 64, CHAIN 4, INNER 2),
after one apply within an ulp or two, over the chain within a coarse
limit (the float sums run in another order, which can flip one rounding
of a later step's split); the split weights bit for
bit.  K5 (`upmix_tpu_torch.ops.overhead_probe`): the plain version against
a numpy statement of the probe body (bench_overhead_probe.py:40-57), bit
for bit, the spill exactly 0.  The CUDA kernels are held to these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from upmix_tpu_torch.ops import int8_dot, overhead_probe

ROOT = Path(__file__).resolve().parent.parent
M, K, CHAIN, INNER = 64, 64, 4, 2


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("bench_int8_dot", ROOT / "scripts" / "bench_int8_dot.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.M, mod.K, mod.CHAIN, mod.INNER = M, K, CHAIN, INNER
    return mod


def _x():
    return (np.random.default_rng(0).standard_normal((M, K)) * 4.0).astype(np.float32)


def _chain(variant, x):
    consts = int8_dot.make_consts(variant, "cpu", K)
    y = torch.from_numpy(x)
    for _ in range(INNER):
        y = int8_dot.int8_dot_chain(y, variant, CHAIN, consts)
    return y.numpy()


def test_split_weights_are_the_scripts(script):
    w = int8_dot.make_weights(K)
    np.testing.assert_array_equal(w, script.make_weights())
    h, l = int8_dot.split_bf16_np(w)
    hj, lj = script.split_bf16_np(w)
    np.testing.assert_array_equal(h.view(torch.int16).numpy(), np.asarray(hj).view(np.int16))
    np.testing.assert_array_equal(l.view(torch.int16).numpy(), np.asarray(lj).view(np.int16))
    for a, b in zip(int8_dot.split_int8_np(w, axis=0), script.split_int8_np(w, axis=0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# max |a - b| / max |b| of the plain version against the JAX kernel.  After
# one apply only the float32 combine's order differs (XLA's, an ulp): read
# at most 1.1e-7 for every rung.  Over the chain of 8 a one-ulp difference
# can flip one rounding of the next step's split: read bf16x3 7.5e-6,
# bf16x1 1.1e-7, int8x3 5.4e-8, int8x3f 7.6e-5 (a flip moves an element by
# 1/254 of its scale) and int8x1 1.6e-2 (by the whole step 8/127); held at
# about three times that, a coarse check.
JAX_APPLY_TOLERANCE = 1e-6
JAX_CHAIN_TOLERANCE = {"bf16x3": 3e-5, "bf16x1": 1e-6, "int8x3": 1e-6, "int8x3f": 3e-4, "int8x1": 0.05}


def _jax_chain(script, variant, x, chain, inner):
    script.CHAIN, script.INNER = chain, inner
    try:
        fn, _ = script.build(variant, interpret=True)
        return np.asarray(fn(x))
    finally:
        script.CHAIN, script.INNER = CHAIN, INNER


@pytest.mark.parametrize("variant", int8_dot.TPU_VARIANTS)
def test_plain_matches_the_jax_kernel(script, variant):
    x = _x()
    consts = int8_dot.make_consts(variant, "cpu", K)
    one = int8_dot.int8_dot_chain(torch.from_numpy(x), variant, 1, consts).numpy()
    ref_one = _jax_chain(script, variant, x, 1, 1)
    assert np.abs(one - ref_one).max() / np.abs(ref_one).max() <= JAX_APPLY_TOLERANCE
    ref = _jax_chain(script, variant, x, CHAIN, INNER)
    got = _chain(variant, x)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= JAX_CHAIN_TOLERANCE[variant], (variant, err)


@pytest.mark.parametrize("variant", int8_dot.VARIANTS)
def test_chain_snr_against_float64(variant):
    # The script's check at this size: the float rungs keep their digits
    # over the chain, the one-pass and fixed-scale rungs do not (the fixed
    # scale clips |x| > 8 of an input of standard deviation 4).
    x = _x()
    ref = x.astype(np.float64)
    w = int8_dot.make_weights(K).astype(np.float64)
    for _ in range(CHAIN * INNER):
        ref = ref @ w
    snr = int8_dot.snr_db(ref, _chain(variant, x).astype(np.float64))
    floor = {"fp32": 110.0, "tf32x3": 110.0, "bf16x3": 90.0, "int8x3": 70.0, "bf16x1": 35.0}
    if variant in floor:
        assert snr > floor[variant], snr
    else:  # int8x3f, int8x1: the clip dominates
        assert 5.0 < snr < 30.0, snr


def test_tf32_rounding_ties_away():
    # 1 + 2^-11 lies halfway between two TF32 values: ties go away from zero.
    half = np.float32(1.0 + 2.0**-11)
    x = torch.tensor([half, -half, 1.0 + 2.0**-12, 1.5], dtype=torch.float32)
    got = int8_dot.tf32_round(x).tolist()
    assert got == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 1.5]
    w = int8_dot.make_weights(K)
    h, l = (t.numpy() for t in int8_dot.split_tf32_np(w))
    assert not (h.view(np.uint32) & 0x1FFF).any() and not (l.view(np.uint32) & 0x1FFF).any()
    assert np.abs(w - h - l).max() < 2.0**-20 * np.abs(w).max()


@pytest.mark.parametrize("per_reg", (1, 2, 4))
def test_fragment_order(per_reg):
    # The B operand of mma.sync m16n8k{8,16,32}: lane g*4 + t holds rows
    # t*V + v and t*V + KT/2 + v of column g, V elements a register;
    # n-tile major, so the n-tiles of a CTA's columns are one range.
    Kw, N = 256, 64
    w = torch.arange(Kw * N, dtype=torch.float64).reshape(Kw, N)
    frags = int8_dot.pack_fragments(w, per_reg).reshape(-1, 32, 2, per_reg)
    kt, nt = 8 * per_reg, N // 8
    ks_n = Kw // kt
    for ks in range(ks_n):
        for n_tile in range(nt):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                k0 = ks * kt + t * per_reg
                got = frags[n_tile * ks_n + ks, lane]
                assert torch.equal(got[0], w[k0 : k0 + per_reg, n_tile * 8 + g])
                assert torch.equal(got[1], w[k0 + kt // 2 : k0 + kt // 2 + per_reg, n_tile * 8 + g])


@pytest.mark.parametrize("cs", int8_dot.CLUSTER_SIZES)
def test_cta_slices_are_contiguous(cs):
    # CTA r of a cluster of cs reads its 512 / cs columns as one range of
    # the packed weights, the mma rungs' fragments from offset r * (64 /
    # cs) n-tiles: each range is the packing of those columns alone.
    K = int8_dot.K_KERNEL
    w = torch.from_numpy(int8_dot.make_weights(K))
    nc = K // cs
    for per_reg in (1, 2, 4):
        frags = int8_dot.pack_fragments(w, per_reg).reshape(K // 8, -1)
        for r in range(cs):
            own = int8_dot.pack_fragments(w[:, r * nc : (r + 1) * nc], per_reg).reshape(nc // 8, -1)
            assert torch.equal(frags[r * nc // 8 : (r + 1) * nc // 8], own)


# What an H100 (132 SMs) reports for each rung's kernel by cluster size:
# whether its CTAs keep their W columns resident (the kernel's shared
# memory: A parts + W / size <= 227 KB), and how many clusters run at once
# (cudaOccupancyMaxActiveClusters; PERF.md, section 6).
H100_RESIDENT = {"bf16x1": {4, 8}, "bf16x3": {8}, "int8x1": {2, 4, 8}, "int8x3": {4, 8}, "int8x3f": {4, 8},
                 "fp32": {8}, "tf32x3": set()}
H100_AT_ONCE = {"bf16x1": {8: 30, 4: 30, 2: 198, 1: 264}, "bf16x3": {8: 15, 4: 92, 2: 132, 1: 132},
                "int8x1": {8: 62, 4: 62, 2: 66, 1: 264}, "int8x3": {8: 30, 4: 30, 2: 132, 1: 132},
                "int8x3f": {8: 30, 4: 30, 2: 132, 1: 132}, "fp32": {8: 15, 4: 92, 2: 198, 1: 264},
                "tf32x3": {8: 15, 4: 30, 2: 66, 1: 132}}


def _h100_pick(M, v):
    return int8_dot.cluster_size(M, H100_RESIDENT[v].__contains__, H100_AT_ONCE[v].__getitem__)


def test_cluster_size_from_m_and_the_card():
    # M = 512 (16 strips): the smallest resident size that runs in one wave
    # (bf16x1, int8), else the largest resident one (bf16x3 and fp32: 15
    # clusters of 8 at once, a second wave, still faster than W from L2),
    # else the largest that runs in one wave (tf32x3).  M = 4224 (a strip
    # per SM): one CTA a strip.
    assert {v: _h100_pick(512, v) for v in int8_dot.VARIANTS} == {
        "bf16x3": 8, "bf16x1": 4, "int8x3": 4, "int8x3f": 4, "int8x1": 2, "fp32": 8, "tf32x3": 4}
    assert {v: _h100_pick(32, v) for v in int8_dot.VARIANTS} == {
        "bf16x3": 8, "bf16x1": 4, "int8x3": 4, "int8x3f": 4, "int8x1": 2, "fp32": 8, "tf32x3": 8}
    for v in int8_dot.VARIANTS:
        assert _h100_pick(4224, v) == 1 and _h100_pick(8192, v) == 1
        for M in range(32, 8192 + 1, 32):
            cs = _h100_pick(M, v)
            assert cs in int8_dot.CLUSTER_SIZES and (M // 32 * cs <= int8_dot.SMS or cs == 1)
    # Nothing resident and nothing in one wave: one CTA a strip.
    assert int8_dot.cluster_size(512, lambda cs: False, lambda cs: 1) == 1
    assert int8_dot.cluster_size(512, lambda cs: True, lambda cs: 99, n_sm=64) == 1


def test_consts_and_checks():
    c = int8_dot.make_consts("int8x3", "cpu", K)
    assert [t.dtype for t in c.weights] == [torch.int8, torch.int8, torch.float32]
    assert c.frags[0].numel() == K * K and c.frags[2].shape == (K,)
    x = torch.zeros((M, K))
    with pytest.raises(ValueError, match="unknown variant"):
        int8_dot.int8_dot_chain(x, "fp16", 1, c)
    with pytest.raises(ValueError, match="made for"):
        int8_dot.int8_dot_chain(x, "int8x1", 1, c)
    with pytest.raises(ValueError, match="expected x"):
        int8_dot.int8_dot_chain(torch.zeros((M, K + 1)), "int8x3", 1, c)
    assert torch.equal(int8_dot.int8_dot_chain(x, "int8x3", 3, c), x)  # zero rows stay zero (scale clamp)


def test_check_entry_point_on_cpu(capsys):
    snrs = int8_dot.check(("bf16x3", "fp32"), M=M, K=K, chain=CHAIN, inner=INNER, device="cpu")
    out = capsys.readouterr().out
    assert "bf16x3   chain of 8: SNR" in out and set(snrs) == {"bf16x3", "fp32"}
    with pytest.raises(SystemExit):
        int8_dot.main(["bench", "--cpu"])


def _probe_numpy(x, seed, weights, n, halo):
    """bench_overhead_probe.py:40-57 in numpy: view 0's row 0 of x + seed,
    plus the weights' [0, 0] summed in order from 0, three times; the spill
    is the accumulator, 0 halved at every step."""
    s = np.float32(0.0)
    for w in weights:
        s = np.float32(s + w[0, 0])
    row = (x[0, 0, :n] + np.float32(seed)).astype(np.float32)
    out = np.tile((row + s).astype(np.float32), (3, 1))[None]
    acc = np.zeros((3, halo), np.float32)
    for _ in range(n // 256):
        acc = acc * np.float32(0.5)
    return out, acc[None]


@pytest.mark.parametrize("config", overhead_probe.CONFIGS)
def test_overhead_probe_plain_is_the_probe_body(config):
    n_views, n_weights, halo = config
    tile, n = 256, 8 * 256
    x, rng = overhead_probe.make_inputs(n, tile, "cpu")
    weights = overhead_probe.make_weights(n_weights, rng, "cpu")
    seed = torch.tensor(0.375, dtype=torch.float32)
    out, spill = overhead_probe.overhead_probe(x, seed, weights, n_views, halo, tile=tile)
    ref_out, ref_spill = _probe_numpy(x.numpy(), 0.375, [w.numpy() for w in weights], n, halo)
    assert out.shape == (1, 3, n) and spill.shape == (1, 3, halo)
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(spill.numpy(), ref_spill)
    assert not spill.any()


def test_overhead_probe_checks_and_bytes():
    x, _ = overhead_probe.make_inputs(4 * 256, 256, "cpu")
    seed = torch.zeros(())
    with pytest.raises(ValueError, match="views"):
        overhead_probe.overhead_probe(x, seed, [], 6, 128, tile=256)
    with pytest.raises(ValueError, match="multiple of the tile"):
        overhead_probe.overhead_probe(x, seed, [], 1, 128, tile=256, n=1000)
    with pytest.raises(ValueError, match="weights"):
        overhead_probe.overhead_probe(x, seed, [torch.zeros((2, 2))] * 65, 1, 128, tile=256)
    # The bound at the probe's N = 2^21: about 33.6 MB.
    assert overhead_probe.bound_bytes(2**21, 128) == 4 * (4 * 2**21 + 384)
    assert overhead_probe.staged_bytes(4) == 4 * 8 * 2**21 + 12 * 2**21


@pytest.mark.parametrize("config", overhead_probe.CONFIGS)
def test_overhead_probe_library_call_computes_the_function(config):
    # K5's yardstick (`library_call`, timed beside the kernel on the card):
    # one torch.add of x's row 0 and seed + s into three channels.  It adds
    # seed + s first, so it may round once differently from the probe's
    # (x + seed) + s: within 1e-6 of values of order one.
    n_views, n_weights, halo = config
    tile, n = 256, 8 * 256
    x, rng = overhead_probe.make_inputs(n, tile, "cpu")
    weights = overhead_probe.make_weights(n_weights, rng, "cpu")
    seed = torch.tensor(0.375, dtype=torch.float32)
    ref, _ = overhead_probe.overhead_probe_plain(x, seed, weights, n_views, halo, tile=tile)
    got = overhead_probe.library_call(x, seed + sum(w[0, 0] for w in weights), n)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
