"""The port's streaming engines (on the CPU) against the C++-semantics
streaming oracle and the JAX package's XLA engines.

Bars: > 60 dB against the oracle (the repo's bar, as
tests/test_streaming.py); > 80 dB against the JAX engines, which compute
the same float32 FFTs with another library.  Warmup blocks are exact
zeros.  Inputs are made from a seed with numpy and fed to both packages.
"""

import numpy as np
import pytest
import torch

from helpers import make_stereo, snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.streaming import BatchStreamingUpmixer as JaxBatch
from upmix_tpu.models.streaming import StreamingUpmixer as JaxStreaming
from upmix_tpu.oracle.reference import oracle_stream_multiband
from upmix_tpu_torch.config import BandSpec, UpmixConfig
from upmix_tpu_torch.models import (
    BatchStreamingUpmixer,
    CudaStreamPool,
    StreamingUpmixer,
    make_stream_pool,
    mix_stereo_sum,
)
from upmix_tpu_torch.models.streaming import WARMUP_BLOCKS, init_stream_state, stream_warmup_blocks
from upmix_tpu_torch.parallel import make_mesh

HW = 256
EDGES = [0.0, 400.0, 1600.0]

# name -> (UpmixConfig constructor, args, kwargs, hw, blocks, seed)
CONFIGS = {
    "default": ("streaming", (EDGES,), dict(sr=8000.0, hw_block_size=HW), HW, 16, 0),
    "hard_zero_cpp_analysis": (
        "streaming", (EDGES,),
        dict(sr=8000.0, hw_block_size=HW, xover_mode="hard_zero", synthesis="analysis", bin_rounding="cpp"),
        HW, 12, 1,
    ),
    "overlap_half": ("make", (EDGES,), dict(sr=8000.0, max_block_size=512, overlap=0.5), HW, 16, 11),
}


def _fuzz_configs():
    # As tests/test_streaming.py:228: random edges, overlap 0.5 or 0.75,
    # hw 128 or 256.
    rng = np.random.default_rng(4321)
    out = {}
    for trial in range(3):
        sr = float(rng.choice([8000, 16000]))
        n_edges = int(rng.integers(1, 4))
        edges = [0.0] + sorted(float(f) for f in rng.uniform(sr * 0.02, sr * 0.4, size=n_edges))
        overlap = float(rng.choice([0.5, 0.75]))
        hw = int(rng.choice([128, 256]))
        kw = dict(sr=sr, overlap=overlap, max_block_size=hw * 2, synthesis="analysis", bin_rounding="cpp")
        out[f"fuzz{trial}"] = ("make", (edges,), kw, hw, 14, 100 + trial)
    return out


CONFIGS.update(_fuzz_configs())


def _both(name):
    ctor, args, kw, hw, n_blocks, seed = CONFIGS[name]
    port = getattr(UpmixConfig, ctor)(*args, **kw)
    jax_cfg = getattr(JaxUpmixConfig, ctor)(*args, **kw)
    return port, jax_cfg, hw, n_blocks, seed


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_matches_oracle_and_jax(name):
    cfg, jcfg, hw, n_blocks, seed = _both(name)
    L, R = make_stereo(n_blocks * hw, cfg.sr, seed=seed)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L32, R32, jcfg, hw)
    eng = StreamingUpmixer(cfg, hw, device="cpu")
    got_l, got_r = eng.process_signal(L32, R32, mix="stereo_sum")
    assert snr_db(ref_l, got_l.numpy()) > 60.0
    assert snr_db(ref_r, got_r.numpy()) > 60.0
    jax_lcr = JaxStreaming(jcfg, hw).process_signal(L32, R32, mix="lcr")
    for j, g in zip(jax_lcr, eng.process_signal(L32, R32, mix="lcr")):
        assert snr_db(np.asarray(j), g.numpy()) > 80.0


def test_push_block_equals_process_signal():
    cfg, _, hw, n_blocks, _ = _both("default")
    L, R = make_stereo(n_blocks * hw + 100, cfg.sr, seed=2)  # a ragged tail is dropped
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    eng = StreamingUpmixer(cfg, hw, device="cpu")
    whole = torch.stack(eng.process_signal(L32, R32))
    assert whole.shape == (3, n_blocks * hw)
    eng.reset()
    pushed = torch.cat([torch.stack(eng.push_block(L32[i : i + hw], R32[i : i + hw]))
                        for i in range(0, n_blocks * hw, hw)], dim=1)
    torch.testing.assert_close(pushed, whole, rtol=0, atol=0)
    with pytest.raises(ValueError, match="push_block"):
        eng.push_block(L32[: hw - 1], R32[: hw - 1])
    with pytest.raises(ValueError, match="unknown mix"):
        eng.process_signal(L32, R32, mix="5.1")


def test_warmup_is_uniform_k_blocks():
    cfg, _, hw, _, _ = _both("default")
    x = np.random.default_rng(3).standard_normal(8 * hw).astype(np.float32)
    eng = StreamingUpmixer(cfg, hw, device="cpu")
    peaks = [float(eng.push_block(x[i : i + hw], x[i : i + hw])[0].abs().max()) for i in range(0, len(x), hw)]
    assert eng.warmup_blocks == WARMUP_BLOCKS == 4
    assert all(p == 0.0 for p in peaks[: WARMUP_BLOCKS - 1]) and peaks[WARMUP_BLOCKS - 1] > 0.0
    half = UpmixConfig.make(EDGES, sr=8000.0, max_block_size=512, overlap=0.5)
    assert StreamingUpmixer(half, hw, device="cpu").warmup_blocks == 2


def test_mixed_k_and_bad_hw_raise():
    b1 = BandSpec(f_low=0.0, f_high=400.0, sr=8000.0, block_size=512, overlap=0.75)
    b2 = BandSpec(f_low=400.0, f_high=4000.0, sr=8000.0, block_size=256, overlap=0.5)
    mixed = UpmixConfig(sr=8000.0, bands=(b1, b2))
    with pytest.raises(ValueError, match="uniform"):
        stream_warmup_blocks(mixed)
    with pytest.raises(ValueError):
        StreamingUpmixer(mixed, 256, device="cpu")
    cfg = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=512)
    with pytest.raises(ValueError, match="multiple of every"):
        StreamingUpmixer(cfg, 100, device="cpu")
    wide = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=4096)
    with pytest.raises(ValueError, match="multiple of every"):
        BatchStreamingUpmixer(wide, 256, 2, device="cpu")


def test_state_exchange_with_jax_streaming():
    cfg, jcfg, hw, _, _ = _both("default")
    L, R = make_stereo(12 * hw, cfg.sr, seed=4)
    L32, R32 = L.astype(np.float32), R.astype(np.float32)
    blocks = [(L32[i : i + hw], R32[i : i + hw]) for i in range(0, len(L32), hw)]
    jeng = JaxStreaming(jcfg, hw, donate=False)
    for b in blocks[:6]:
        jeng.push_block(*b)
    port = StreamingUpmixer(cfg, hw, device="cpu")
    port.restore(jeng.snapshot())
    back = JaxStreaming(jcfg, hw, donate=False)
    for i, b in enumerate(blocks[6:]):
        if i == 3:  # and back into a JAX engine midway
            back.state = port.snapshot()
        want = np.stack([np.asarray(o) for o in jeng.push_block(*b)])
        got = torch.stack(port.push_block(*b)).numpy()
        assert snr_db(want, got) > 80.0
        if i >= 3:
            assert snr_db(want, np.stack([np.asarray(o) for o in back.push_block(*b)])) > 80.0
    fresh = init_stream_state(cfg, hw, device="cpu")
    assert set(fresh["ola"]) == set(jeng.state["ola"]) and fresh["history"].shape == (2, 4 * hw)


def test_batch_matches_independent_streams_and_jax():
    cfg, jcfg, hw, _, _ = _both("default")
    S, n_blocks = 3, 9
    blocks = np.random.default_rng(31).standard_normal((n_blocks, S, 2, hw)).astype(np.float32) * 0.3
    batch = BatchStreamingUpmixer(cfg, hw, S, device="cpu")
    jbatch = JaxBatch(jcfg, hw, n_streams=S)
    singles = [StreamingUpmixer(cfg, hw, device="cpu") for _ in range(S)]
    for t in range(n_blocks):
        got = np.stack([o.numpy() for o in batch.push_blocks(blocks[t, :, 0], blocks[t, :, 1])])
        want = np.stack([np.asarray(o) for o in jbatch.push_blocks(blocks[t, :, 0], blocks[t, :, 1])])
        for s in range(S):
            one = torch.stack(singles[s].push_block(blocks[t, s, 0], blocks[t, s, 1])).numpy()
            np.testing.assert_array_equal(got[:, s], one)
            if np.abs(want[:, s]).max() == 0:
                assert np.abs(got[:, s]).max() == 0.0
            else:
                assert snr_db(want[:, s], got[:, s]) > 80.0


def test_batch_churn_and_checkpoint_round_trip():
    cfg, jcfg, hw, _, _ = _both("default")
    S, n_blocks = 4, 12
    blocks = np.random.default_rng(32).standard_normal((n_blocks, S, 2, hw)).astype(np.float32) * 0.3
    plain = BatchStreamingUpmixer(cfg, hw, S, device="cpu")
    plain_out = [np.stack([o.numpy() for o in plain.push_blocks(b[:, 0], b[:, 1])]) for b in blocks]
    pool = BatchStreamingUpmixer(cfg, hw, S, device="cpu")
    half = n_blocks // 2
    for b in blocks[:half]:
        pool.push_blocks(b[:, 0], b[:, 1])
    snap = pool.snapshot()
    rows = pool.extract_streams([1])
    pool.reset_streams([1])
    for t, b in enumerate(blocks[half:]):
        got = np.stack([o.numpy() for o in pool.push_blocks(b[:, 0], b[:, 1])])
        np.testing.assert_array_equal(got[:, [0, 2, 3]], plain_out[half + t][:, [0, 2, 3]])
        if t < pool.warmup_blocks - 1:
            assert np.abs(got[:, 1]).max() == 0.0
    # The checkpoint resumes bit for bit here, and in the JAX engine.
    again = BatchStreamingUpmixer(cfg, hw, S, device="cpu")
    again.restore(snap)
    jpool = JaxBatch(jcfg, hw, n_streams=S, donate=False)
    jpool.restore(snap)
    for t, b in enumerate(blocks[half:]):
        got = np.stack([o.numpy() for o in again.push_blocks(b[:, 0], b[:, 1])])
        np.testing.assert_array_equal(got, plain_out[half + t])
        assert snr_db(np.stack([np.asarray(o) for o in jpool.push_blocks(b[:, 0], b[:, 1])]), got) > 80.0
    # One session moves into another slot.
    pool.load_streams([2], rows)
    np.testing.assert_array_equal(pool.extract_streams([2])["history"], rows["history"])
    with pytest.raises(ValueError, match="out of range"):
        pool.reset_streams([4])
    with pytest.raises(ValueError, match="push_blocks"):
        pool.push_blocks(np.zeros((S, hw - 1)), np.zeros((S, hw - 1)))
    with pytest.raises(ValueError):
        BatchStreamingUpmixer(cfg, hw, 0, device="cpu")
    # A mesh splits the streams over its 'data' axis (test_torch_pool_mesh.py).
    on_mesh = BatchStreamingUpmixer(cfg, hw, 2, device="cpu", mesh=make_mesh({"data": 2}, devices=["cpu"] * 2))
    assert on_mesh.plan.n_streams == 1


def test_make_stream_pool_selection_on_cpu():
    cfg, _, hw, _, _ = _both("default")
    assert type(make_stream_pool(cfg, hw, 8, device="cpu")) is BatchStreamingUpmixer
    assert type(make_stream_pool(cfg, hw, 8, engine="torch", device="cpu")) is BatchStreamingUpmixer
    assert type(make_stream_pool(cfg, hw, 5, engine="cuda", device="cpu")) is CudaStreamPool
    with pytest.raises(ValueError, match="unknown engine"):
        make_stream_pool(cfg, hw, 8, engine="pallas", device="cpu")
    # With a mesh, "auto" is the batch pool and "cuda" the sharded CUDA pool,
    # as in the JAX package.
    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    assert type(make_stream_pool(cfg, hw, 8, device="cpu", mesh=mesh)) is BatchStreamingUpmixer
    assert type(make_stream_pool(cfg, hw, 8, engine="cuda", device="cpu", mesh=mesh)) is CudaStreamPool


def test_mix_stereo_sum_layout():
    lcr = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    left, right = mix_stereo_sum(lcr)
    torch.testing.assert_close(left, torch.tensor([3.5, 5.0]))
    torch.testing.assert_close(right, torch.tensor([5.5, 7.0]))
