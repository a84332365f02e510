"""The torch port's offline path (on the CPU) against the NumPy oracle and
the JAX package's chunked pipeline.

Bars: > 60 dB against the float64 oracle (the repo's bar, as
tests/test_offline_parity.py); > 80 dB against the JAX chunked path at
the same segmentation, whose Pallas omnibus runs in interpret mode with
bf16x3 products (~1e-6 relative error).
"""

import numpy as np
import pytest
import torch

from helpers import make_stereo, snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.offline import _plan_buckets as jax_plan_buckets
from upmix_tpu.models.offline import build_offline_chunked_fn as jax_build_chunked
from upmix_tpu.oracle import oracle_multiband
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models import Upmixer, upmix_offline
from upmix_tpu_torch.models.offline import (
    CHUNK_SAMPLES,
    build_offline_chunked_fn,
    build_offline_fn,
    plans_from_numpy,
)

BENCH = ([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], dict(sr=44100.0, max_block_size=65536))

# The configs of tests/test_offline_parity.py (all inside the chunked
# path's domain: power-of-two blocks, hop | block), plus the bench config.
PARITY = {
    "bench_2p17": (BENCH, 2**17, "noise", 0, 60.0),
    "single_band_full_range": (([0.0], dict(sr=8000.0, max_block_size=512)), 4096, "mix", 0, 60.0),
    "three_band_raised_cosine": (([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512)), 5000, "mix", 0, 60.0),
    "three_band_hard_zero": (
        ([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512, xover_mode="hard_zero")),
        5000, "mix", 1, 60.0,
    ),
    "bucket_collision": (([0.0, 5.0, 400.0], dict(sr=8000.0, max_block_size=512)), 4096, "mix", 2, 60.0),
    "many_bands": (
        ([0, 100, 200, 400, 800, 1200, 1600, 2400, 3200], dict(sr=8000.0, max_block_size=1024)),
        6000, "mix", 3, 60.0,
    ),
    "awkward_length": (([0.0, 400.0], dict(sr=8000.0, max_block_size=256)), 997, "mix", 4, 60.0),
    "shorter_than_one_block": (([0.0, 400.0], dict(sr=8000.0, max_block_size=256)), 100, "mix", 5, 40.0),
    "analysis_synthesis": (
        ([0.0, 400.0], dict(sr=8000.0, max_block_size=512, synthesis="analysis", bin_rounding="cpp")),
        4096, "mix", 7, 60.0,
    ),
    "overlap_half": (([0.0, 2000.0], dict(sr=8000.0, max_block_size=512, overlap=0.5)), 3000, "mix", 8, 60.0),
    "mono": (([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512)), 4096, "mono", 6, 60.0),
    "anticorrelated": (([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512)), 4096, "anticorrelated", 6, 60.0),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_upmixer_matches_oracle(name):
    (edges, kw), n, kind, seed, bar = PARITY[name]
    cfg = UpmixConfig.make(edges, **kw)
    L, R = make_stereo(n, cfg.sr, kind=kind, seed=seed)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, JaxUpmixConfig.make(edges, **kw))
    got = Upmixer(cfg, device="cpu").process_np(L32, R32)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.dtype == np.float32
        if np.max(np.abs(r)) < 1e-6:  # numerically-zero channel (mono sides)
            assert np.max(np.abs(g)) < 1e-5
        else:
            assert snr_db(r, g) > bar


@pytest.mark.parametrize(
    "edges,kw",
    [
        ([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512)),
        # outside the kernel path: non-power-of-two block, hop not dividing it
        ([0.0, 1000.0], dict(sr=8000.0, max_block_size=1000, window="hann", overlap=0.65)),
    ],
)
def test_whole_file_path_matches_oracle(edges, kw):
    # chunk=0: the torch.fft whole-file program, the reference the kernel
    # path is held to on the card (float64 there; float32 here).
    cfg = UpmixConfig.make(edges, **kw)
    L, R = make_stereo(5000, cfg.sr, seed=9)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref = oracle_multiband(L32, R32, JaxUpmixConfig.make(edges, **kw))
    fn = build_offline_fn(cfg, 5000, chunk=0, device="cpu")
    got64 = fn(torch.as_tensor(L), torch.as_tensor(R))
    assert got64[0].dtype == torch.float64
    for r, g in zip(ref, got64):
        assert snr_db(r, g.numpy()) > 60.0
    for r, g in zip(ref, Upmixer(cfg, device="cpu", chunk=0).process_np(L32, R32)):
        assert snr_db(r, g) > 60.0


@pytest.mark.parametrize("n", [4 * 1024 + 300, 2 * 1024])
def test_chunked_matches_jax_chunked(n):
    # >= 4 segments with a ragged tail: same segmentation on both sides,
    # spill carried segment to segment.
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    chunk = 1024
    rng = np.random.default_rng(n)
    L = rng.standard_normal(n).astype(np.float32)
    R = rng.standard_normal(n).astype(np.float32)
    jcfg = JaxUpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    ref = jax_build_chunked(jcfg, n, chunk=chunk, use_pallas=True)(L, R)
    got = build_offline_chunked_fn(cfg, n, chunk=chunk, device="cpu")(
        torch.as_tensor(L), torch.as_tensor(R)
    )
    for r, g in zip(ref, got):
        assert g.shape == (n,)
        assert snr_db(np.asarray(r), g.numpy()) > 80.0


def test_block_of_2p21_on_the_chunked_path():
    # max_block_size 2^21: the first band's block is 2^21 points.  A CPU
    # plan builds no tables of the kernels' two-stage split (the plain
    # version runs any block), so the chunked path runs it; the shortest
    # input that fills the block, against the port's whole-file path and
    # the float64 oracle.
    edges, kw = BENCH[0], dict(sr=44100.0, max_block_size=2**21)
    cfg = UpmixConfig.make(edges, **kw)
    assert cfg.bands[0].block_size == 2**21
    n = 2**21
    L, R = make_stereo(n, cfg.sr, kind="mix", seed=21)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    got = Upmixer(cfg, device="cpu").process_np(L32, R32)
    whole = Upmixer(cfg, device="cpu", chunk=0).process_np(L32, R32)
    ref = oracle_multiband(L32, R32, JaxUpmixConfig.make(edges, **kw))
    for r, w, g in zip(ref, whole, got):
        assert g.shape == (n,) and np.isfinite(g).all()
        assert snr_db(w, g) >= 60.0
        assert snr_db(r, g) >= 60.0
    (wide,) = [b for b in plans_from_numpy(jax_plan_buckets(JaxUpmixConfig.make(edges, **kw), n), "cpu")
               if b.block == 2**21]
    assert wide.wide is None and wide.twiddles is None


def test_plans_from_jax_give_bitwise_same_output():
    cfg = UpmixConfig.make(*BENCH[:1], **BENCH[1])
    n = 70000
    rng = np.random.default_rng(3)
    L = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    R = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    own = build_offline_chunked_fn(cfg, n, device="cpu")(L, R)
    jcfg = JaxUpmixConfig.make(*BENCH[:1], **BENCH[1])
    jax_buckets = plans_from_numpy(jax_plan_buckets(jcfg, CHUNK_SAMPLES), "cpu")
    carried = build_offline_chunked_fn(cfg, n, device="cpu", buckets=jax_buckets)(L, R)
    for a, b in zip(own, carried):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize(
    "edges,kw",
    [
        ([0.0, 1000.0], dict(sr=8000.0, max_block_size=1000)),  # non-power-of-two block
        ([0.0, 400.0], dict(sr=8000.0, max_block_size=512, overlap=0.65)),  # hop does not divide block
    ],
)
def test_unsupported_configs_raise(edges, kw):
    # Geometries no kernel takes: the entry points no longer raise, they
    # run the whole-file torch.fft program (as the JAX package runs them on
    # XLA), > 60 dB against the oracle; the kernel path's own guard still
    # refuses such a bucket (`make_bucket` -> `check_geometry`).
    from upmix_tpu.models.offline import _plan_buckets as jplan

    from upmix_tpu_torch.ops.omnibus import make_bucket

    cfg = UpmixConfig.make(edges, **kw)
    L, R = (a.astype(np.float32) for a in make_stereo(4096, 8000.0, seed=13))
    ref = oracle_multiband(L, R, JaxUpmixConfig.make(edges, **kw))
    for got in (
        Upmixer(cfg, device="cpu").process_np(L, R),
        [t.numpy() for t in build_offline_chunked_fn(cfg, 4096, device="cpu")(torch.as_tensor(L), torch.as_tensor(R))],
    ):
        for r, g in zip(ref, got):
            assert snr_db(r, g) > 60.0
    odd = [p for p in jplan(JaxUpmixConfig.make(edges, **kw), 4096) if p.block_size & (p.block_size - 1) or p.block_size % p.hop_size]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_bucket(odd[0], "cpu")


def test_custom_window_raises():
    from upmix_tpu.ops.windows import register_window
    from upmix_tpu_torch.ops.windows import register_window as port_register_window

    # The same window registered in both packages: the port builds the
    # config (it raised before its registry) and gives the JAX package's
    # stems, > 80 dB (the file's bar against the JAX chunked path).
    register_window("torch_port_test_window", np.hanning, overwrite=True)
    port_register_window("torch_port_test_window", np.hanning, overwrite=True)
    kw = dict(sr=8000.0, max_block_size=256, window="torch_port_test_window")
    cfg = UpmixConfig.make([0.0, 400.0], **kw)
    jcfg = JaxUpmixConfig.make([0.0, 400.0], **kw)
    L, R = (a.astype(np.float32) for a in make_stereo(4096, 8000.0, seed=14))
    got = Upmixer(cfg, device="cpu").process_np(L, R)
    want = jax_build_chunked(jcfg, 4096, use_pallas=False)(L, R)
    for r, g in zip(oracle_multiband(L, R, jcfg), got):
        assert snr_db(r, g) > 60.0
    for w, g in zip(want, got):
        assert snr_db(np.asarray(w), g) > 80.0


def test_upmixer_cache_padding_and_lru():
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    up = Upmixer(cfg, device="cpu", pad_granularity=1024, max_programs=2)
    outs = {}
    for n in (3000, 3500, 5000):  # pad to 3072, 4096, 5120
        L, R = make_stereo(n, cfg.sr, seed=n)
        outs[n] = (L, R, up.process_np(L.astype(np.float32), R.astype(np.float32)))
    assert list(up._cache) == [4096, 5120]  # least recently used evicted
    L, R, first = outs[3000]
    again = up.process_np(L.astype(np.float32), R.astype(np.float32))
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    jcfg = JaxUpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=256)
    ref = oracle_multiband(L.astype(np.float32), R.astype(np.float32), jcfg)
    for r, g in zip(ref, first):
        assert g.shape == (3000,) and snr_db(r, g) > 60.0
    with pytest.raises(ValueError):
        up.process_np(np.zeros(10), np.zeros(11))
    with pytest.raises(ValueError):
        up.process_np(np.zeros(0), np.zeros(0))


def test_silence_and_mono():
    cfg = UpmixConfig.make(*BENCH[:1], **BENCH[1])
    up = Upmixer(cfg, device="cpu")
    z = np.zeros(70000, np.float32)
    for o in up.process_np(z, z):
        assert np.all(o == 0.0)
    L = np.random.default_rng(0).standard_normal(70000).astype(np.float32)
    c, ls, rs = upmix_offline(L, L, cfg, device="cpu")
    assert np.abs(ls).max() <= 1e-5 and np.abs(rs).max() <= 1e-5
    assert np.abs(c).max() > 0.1


@pytest.mark.parametrize("n,batch", [(4 * 1024 + 300, 1), (3 * 1024, 3), (1024, 2)])
def test_rows_reach_the_kernel_as_it_takes_them(monkeypatch, n, batch):
    # The omnibus kernel takes one contiguous float32 [S, 2, chunk + halo]
    # tensor (the CPU runs the plain version, which would take any view);
    # every row's segments go into that one call.
    from upmix_tpu_torch.models import offline

    seen, real = [], offline.omnibus_lcr_batch

    def spy(x, plan):
        assert x.dtype == torch.float32 and x.is_contiguous()
        seen.append(x.shape[0])
        return real(x, plan)

    monkeypatch.setattr(offline, "omnibus_lcr_batch", spy)
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.standard_normal((batch, 2, n)), dtype=torch.float32)
    y = offline.build_offline_rows_fn(cfg, n, chunk=1024, device="cpu")(x)
    assert seen == [batch * -(-n // 1024)] and y.shape == (batch, 3, n)
    for b in range(batch):
        one = build_offline_chunked_fn(cfg, n, chunk=1024, device="cpu")(x[b, 0], x[b, 1])
        for o in range(3):
            torch.testing.assert_close(y[b, o], one[o], rtol=0, atol=1e-6)
