"""The pool's spectral-OLA dataflow in the port (on the CPU: its plain
version, `ops/pool.py::pool_step_spectral_plain`) against the JAX
package's PallasStreamPool(ola="spectral") run in interpret mode, the
port's time-OLA pool and the float64 streaming oracle.

Mirrors tests/test_streaming.py's spectral cases (multi-hop, matches
time, snapshots and the cross-mode guard, NaN isolation, the seeded
random-config fuzz) and tests/test_serve_stream.py's spectral server.
Inputs are made from a seed with numpy.  The JAX kernel multiplies in
bf16x3, the port runs float32 FFTs: outputs and packed carries are held
at 80 dB, with exact zeros where the JAX pool has them, and at 60 dB
against the oracle.  Configs the JAX spectral plan refuses only for its
TPU layout (no hop a dot of whole lanes, a hop equal to its block) are
held against the port's time pool.
"""

import numpy as np
import pytest
import torch

from helpers import make_stereo, snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.streaming import BatchStreamingUpmixer as JaxBatch
from upmix_tpu.models.streaming import PallasStreamPool
from upmix_tpu.oracle.reference import oracle_stream_multiband
from upmix_tpu.ops.pallas_pool import make_pool_plan as jax_make_pool_plan
from upmix_tpu.ops.pallas_pool import pool_step_lcr as jax_pool_step_lcr
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.streaming import CudaStreamPool, StreamingUpmixer, make_stream_pool
from upmix_tpu_torch.ops import pool
from upmix_tpu_torch.ops.fftplan import FFT_MAX, reg_twiddles
from upmix_tpu_torch.ops.pool import (
    EDGE_DEPTH,
    make_edge_weight,
    make_pool_plan,
    pack_spectral_carry,
    pool_step_lcr,
    pool_step_spectral_plain,
    spectral_lanes,
    takes_edge_product,
    unpack_spectral_carry,
)
from upmix_tpu_torch.serve_stream import StreamServer, stream_client
from upmix_tpu_torch.utils.tracing import launches

HW = 256
SR = 8000.0
EDGES = [0.0, 400.0, 1600.0]


def _cfgs(edges=EDGES, sr=SR, hw=HW, **kw):
    return (
        UpmixConfig.streaming(edges, sr=sr, hw_block_size=hw, **kw),
        JaxUpmixConfig.streaming(edges, sr=sr, hw_block_size=hw, **kw),
    )


def _blocks(n_blocks, S, seed, hw=HW):
    return np.random.default_rng(seed).standard_normal((n_blocks, S, 2, hw)).astype(np.float32) * 0.3


def _stack(outs):
    return np.stack([np.asarray(o) for o in outs])


def _assert_close(want, got, bar=80.0, what=""):
    """> bar dB against a reference that is not silent, exact zeros against
    one that is.  (A single value can be zero on one side and a rounding
    error on the other: Rs at a bin where R - C cancels.)"""
    want, got = np.asarray(want), np.asarray(got)
    if np.abs(want).max() == 0:
        assert np.abs(got).max() == 0.0, f"not silent: {what}"
    else:
        assert snr_db(want, got) > bar, what


def _assert_blocks_close(want, got, hw=HW, bar=80.0, what=""):
    """_assert_close per stream and per hardware block of [3, S, n * hw]
    outputs: the warmup gate's silent blocks must be exact zeros."""
    want, got = np.asarray(want), np.asarray(got)
    for s in range(want.shape[1]):
        for i in range(want.shape[2] // hw):
            cut = (slice(None), s, slice(i * hw, (i + 1) * hw))
            _assert_close(want[cut], got[cut], bar, f"{what} stream {s} block {i}")


def _spectral(cfg, S, hw=HW):
    return CudaStreamPool(cfg, hw, S, device="cpu", ola="spectral")


@pytest.mark.parametrize("hops", [1, 3])
def test_spectral_step_matches_jax_interpret(hops):
    # One step from nonzero carried spectra with t straddling the warmup:
    # outputs and packed carries against the JAX kernel's spectral body.
    cfg, jcfg = _cfgs()
    S = 8
    plan = make_pool_plan(cfg, HW, S, device="cpu", ola="spectral")
    jplan = jax_make_pool_plan(jcfg, HW, S, group=8, ola="spectral")
    assert [(b.block, b.hop, b.passes, b.overlap) for b in plan.buckets] == [(b.B, b.H, b.P, b.Kr) for b in jplan.buckets]
    assert [3 * (b.overlap - 1) * spectral_lanes(b.kept) for b in plan.buckets] == [b.spec_width for b in jplan.buckets]
    nq = plan.warmup
    rng = np.random.default_rng(hops + 10)
    hist = rng.standard_normal((S, 2, (nq - 1 + hops) * HW)).astype(np.float32)
    t = np.array([1, 2, 3, 4, 5, 6, 1, 3], np.int32)
    carries = [rng.standard_normal(b.spectral_carry_shape(S)).astype(np.float32) for b in plan.buckets]

    (oc, ols, ors), jnew = jax_pool_step_lcr(
        [hist[:, 0, q * HW : (q + 1) * HW] for q in range(nq - 1 + hops)],
        [hist[:, 1, q * HW : (q + 1) * HW] for q in range(nq - 1 + hops)],
        t, tuple(pack_spectral_carry(c) for c in carries), jplan, interpret=True, hops=hops,
    )
    out, new = pool_step_lcr(torch.as_tensor(hist), torch.as_tensor(t), [torch.as_tensor(c) for c in carries],
                             plan, hops)
    ref = np.stack([np.asarray(oc), np.asarray(ols), np.asarray(ors)])
    _assert_blocks_close(ref, out.numpy().transpose(1, 0, 2))
    for b, j, n in zip(plan.buckets, jnew, new):
        packed = pack_spectral_carry(n.numpy())
        held = pack_spectral_carry(carries[plan.buckets.index(b)])
        for s in range(S):
            _assert_close(np.asarray(j)[s], packed[s], what=f"carry B={b.block} stream {s}")
            if t[s] + hops - 1 < plan.warmup:  # no hop ready: the carry is held, bit for bit
                np.testing.assert_array_equal(packed[s], held[s])
    # The float64 plain version is the reference the kernel is held to on the card.
    out64, _ = pool_step_spectral_plain(torch.as_tensor(hist, dtype=torch.float64), torch.as_tensor(t),
                                        [torch.as_tensor(c, dtype=torch.float64) for c in carries], plan, hops)
    assert snr_db(out64.numpy(), out.numpy()) > 120.0


def test_spectral_pool_multi_hop():
    # tests/test_streaming.py::test_pallas_pool_multi_hop_spectral: the
    # spectral carry chains across the hops of one call as across calls.
    cfg, jcfg = _cfgs()
    S, n_blocks, hops = 8, 8, 4
    blocks = _blocks(n_blocks, S, 45)
    seq = _spectral(cfg, S)
    jseq = PallasStreamPool(jcfg, HW, n_streams=S, group=8, ola="spectral")
    seq_out = [_stack(seq.push_blocks(b[:, 0], b[:, 1])) for b in blocks]
    multi = _spectral(cfg, S)
    for t0 in range(0, n_blocks, hops):
        xl = np.concatenate([blocks[t0 + i, :, 0] for i in range(hops)], axis=1)
        xr = np.concatenate([blocks[t0 + i, :, 1] for i in range(hops)], axis=1)
        out = _stack(multi.push_blocks_multi(xl, xr))
        for i in range(hops):
            t = t0 + i
            got = out[..., i * HW : (i + 1) * HW]
            _assert_blocks_close(seq_out[t], got, bar=100.0, what=f"block {t}")
            _assert_blocks_close(_stack(jseq.push_blocks(blocks[t, :, 0], blocks[t, :, 1])), got, what=f"jax block {t}")
    np.testing.assert_array_equal(multi.state["t"].numpy(), seq.state["t"].numpy())


def test_spectral_pool_matches_time():
    # tests/test_streaming.py::test_pallas_pool_spectral_matches_time: the
    # spectral pool computes the time pool's function, through warmup
    # silence and slot churn; and the JAX spectral pool's, at 80 dB.
    cfg, jcfg = _cfgs()
    S, n_blocks = 16, 12
    blocks = _blocks(n_blocks, S, 53)
    t_pool = CudaStreamPool(cfg, HW, S, device="cpu")
    s_pool = _spectral(cfg, S)
    j_pool = PallasStreamPool(jcfg, HW, n_streams=S, group=8, ola="spectral")
    assert s_pool.ola == "spectral" and s_pool.plan.ola == "spectral"
    for t in range(n_blocks):
        if t == n_blocks // 2:
            for p in (t_pool, s_pool, j_pool):
                p.reset_streams([2, 9])
        want = _stack(t_pool.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        got = _stack(s_pool.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        _assert_blocks_close(want, got, bar=100.0, what=f"block {t}")
        _assert_blocks_close(_stack(j_pool.push_blocks(blocks[t, :, 0], blocks[t, :, 1])), got, what=f"jax block {t}")
        if t < s_pool.warmup_blocks - 1:
            assert np.abs(got).max() == 0.0


def test_spectral_pool_against_the_oracle():
    # One stream of the spectral pool against the float64 streaming oracle.
    cfg, jcfg = _cfgs()
    n_blocks = 16
    L, R = make_stereo(n_blocks * HW, SR, seed=5)
    L, R = L.astype(np.float32), R.astype(np.float32)
    ref_l, ref_r = oracle_stream_multiband(L, R, jcfg, HW)
    p = _spectral(cfg, 1)
    outs = [_stack(p.push_blocks(L[None, i * HW : (i + 1) * HW], R[None, i * HW : (i + 1) * HW]))[:, 0]
            for i in range(n_blocks)]
    lcr = np.concatenate(outs, axis=1)
    got_l, got_r = lcr[1] + 0.5 * lcr[0], lcr[2] + 0.5 * lcr[0]
    assert snr_db(ref_l, got_l) >= 60.0 and snr_db(ref_r, got_r) >= 60.0


def test_spectral_snapshots_both_ways_and_cross_mode_guard():
    # tests/test_streaming.py::test_pallas_pool_spectral_snapshot_and_cross_mode_guard,
    # across the packages: a JAX spectral snapshot continues in the port and
    # a port snapshot in the JAX pool; a port snapshot resumes the port bit
    # for bit; per-stream rows move both ways; a snapshot of the other OLA
    # mode raises in either package.
    cfg, jcfg = _cfgs()
    S, n_blocks = 8, 10
    blocks = _blocks(n_blocks, S, 59)
    jpool = PallasStreamPool(jcfg, HW, n_streams=S, group=8, ola="spectral")
    port = _spectral(cfg, S)
    for b in blocks[:5]:
        jpool.push_blocks(b[:, 0], b[:, 1])
        port.push_blocks(b[::-1, 0], b[::-1, 1])
    jsnap, psnap = jpool.snapshot(), port.snapshot()
    for k, v in psnap["ola"].items():
        assert v.shape == np.asarray(jsnap["ola"][k]).shape
    into_port = _spectral(cfg, S)
    into_port.restore(jsnap)
    into_jax = PallasStreamPool(jcfg, HW, n_streams=S, group=8, ola="spectral")
    into_jax.restore(psnap)
    again = _spectral(cfg, S)
    again.restore(psnap)
    for t, b in enumerate(blocks[5:]):
        _assert_blocks_close(_stack(jpool.push_blocks(b[:, 0], b[:, 1])),
                             _stack(into_port.push_blocks(b[:, 0], b[:, 1])), what=f"jax -> port block {5 + t}")
        mine = _stack(port.push_blocks(b[::-1, 0], b[::-1, 1]))
        np.testing.assert_array_equal(_stack(again.push_blocks(b[::-1, 0], b[::-1, 1])), mine)
        _assert_blocks_close(_stack(into_jax.push_blocks(b[::-1, 0], b[::-1, 1])), mine,
                             what=f"port -> jax block {5 + t}")
    rows = jpool.extract_streams([1, 6])
    port.load_streams([3, 0], rows)
    for k, v in port.extract_streams([3, 0])["ola"].items():
        _assert_close(np.asarray(rows["ola"][k]), v, what=f"rows {k}")
    jpool.load_streams([2], port.extract_streams([5]))

    t_port = CudaStreamPool(cfg, HW, S, device="cpu")
    t_jax = PallasStreamPool(jcfg, HW, n_streams=S, group=8)
    for target, snap in ((t_port, jsnap), (t_port, psnap), (port, t_jax.snapshot()), (port, t_port.snapshot())):
        with pytest.raises(ValueError, match="OLA format"):
            target.restore(snap)
    with pytest.raises(ValueError, match="OLA format"):
        t_jax.restore(psnap)
    with pytest.raises(ValueError, match="OLA format"):
        jpool.restore(t_port.snapshot())


def test_spectral_nan_stream_isolation():
    # tests/test_streaming.py::test_pallas_pool_spectral_nan_stream_isolation:
    # a stream fed NaN from block 5 on leaves its neighbours as they were,
    # and reset_streams recovers it.
    cfg, _ = _cfgs()
    S, n_blocks = 8, 10
    blocks = _blocks(n_blocks, S, 23)
    clean, dirty = _spectral(cfg, S), _spectral(cfg, S)
    ok = [i for i in range(S) if i != 2]
    for t in range(n_blocks):
        want = _stack(clean.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        bad = blocks[t].copy()
        if t >= 5:
            bad[2] = np.nan
        got = _stack(dirty.push_blocks(bad[:, 0], bad[:, 1]))
        np.testing.assert_array_equal(got[:, ok], want[:, ok])
        if t >= 5:
            assert not np.all(np.isfinite(got[:, 2]))
    dirty.reset_streams([2])
    for t in range(dirty.warmup_blocks + 1):
        assert np.all(np.isfinite(_stack(dirty.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))))


def test_spectral_random_config_fuzz():
    # tests/test_streaming.py::test_pallas_pool_spectral_random_config_fuzz:
    # random pool configs (Kr 2 and 4, hops of 32 to 128 samples, single-
    # frame buckets).  Where the JAX spectral plan takes the config, the
    # port's spectral pool is held against it; where it refuses it only for
    # its TPU layout, against the port's time pool (and that against the
    # JAX time pool).
    rng = np.random.default_rng(991)
    against_jax = against_time = 0
    for trial in range(10):
        sr = float(rng.choice([8000, 16000]))
        edges = [0.0] + sorted(float(f) for f in rng.uniform(sr * 0.02, sr * 0.4, size=int(rng.integers(1, 4))))
        overlap = float(rng.choice([0.5, 0.75]))
        hw = int(rng.choice([64, 128, 256]))
        kw = dict(sr=sr, overlap=overlap, max_block_size=hw * 2, synthesis="analysis", bin_rounding="cpp")
        cfg, jcfg = UpmixConfig.make(edges, **kw), JaxUpmixConfig.make(edges, **kw)
        S = 8
        if make_pool_plan(cfg, hw, S, device="cpu") is None:
            assert jax_make_pool_plan(jcfg, hw, S, group=8) is None
            continue
        blocks = _blocks(6, S, 300 + trial, hw)
        s_pool = _spectral(cfg, S, hw)
        jax_takes = jax_make_pool_plan(jcfg, hw, S, group=8, ola="spectral") is not None
        if jax_takes:
            ref = PallasStreamPool(jcfg, hw, n_streams=S, group=8, ola="spectral")
            against_jax += 1
        else:
            ref = CudaStreamPool(cfg, hw, S, device="cpu")
            jref = PallasStreamPool(jcfg, hw, n_streams=S, group=8)
            against_time += 1
        for t in range(6):
            got = _stack(s_pool.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
            want = _stack(ref.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
            what = f"trial {trial} block {t} (edges={edges}, ov={overlap}, hw={hw})"
            _assert_blocks_close(want, got, hw, what=what)
            if not jax_takes:
                _assert_blocks_close(_stack(jref.push_blocks(blocks[t, :, 0], blocks[t, :, 1])), want, hw, what=what)
    assert against_jax >= 3 and against_time >= 2, (against_jax, against_time)


def test_spectral_configs_the_jax_plan_refuses():
    # Kr = 1 (hop = block: an empty carry) and hops of 32 and 48 samples
    # (no legal hops-per-dot on the TPU): the port's spectral pool runs
    # them, held against its time pool, which the JAX time pool holds.
    for edges, kw, hw in (([0.0, 1000.0], dict(overlap=0.0, max_block_size=128), 128),
                          (EDGES, dict(overlap=0.75, max_block_size=128), 64),
                          ([0.0], dict(overlap=0.75, max_block_size=192), 96)):
        kw = dict(sr=SR, synthesis="analysis", bin_rounding="cpp", **kw)
        cfg, jcfg = UpmixConfig.make(edges, **kw), JaxUpmixConfig.make(edges, **kw)
        S = 3
        assert jax_make_pool_plan(jcfg, hw, 8, group=8, ola="spectral") is None
        plan = make_pool_plan(cfg, hw, S, device="cpu", ola="spectral")
        assert plan is not None
        s_pool, t_pool = _spectral(cfg, S, hw), CudaStreamPool(cfg, hw, S, device="cpu")
        snap = None
        for t, b in enumerate(_blocks(8, S, 17, hw)):
            got = _stack(s_pool.push_blocks(b[:, 0], b[:, 1]))
            _assert_blocks_close(_stack(t_pool.push_blocks(b[:, 0], b[:, 1])), got, hw, bar=100.0,
                                 what=f"{edges} {kw} block {t}")
            if t == 4:
                snap = s_pool.snapshot()
        if any(b.overlap == 1 for b in plan.buckets):
            assert all(v.shape == (S, 0) for v in snap["ola"].values())
        back = _spectral(cfg, S, hw)
        back.restore(snap)
        assert back.snapshot()["t"].tolist() == snap["t"].tolist()


def test_spectral_split_bucket_on_cpu():
    # At hw 8192 the 32768 bucket is over FFT_MAX: a CPU plan has no split
    # tables and the plain version runs it, against the JAX XLA engine.
    hw, S = 8192, 2
    cfg, jcfg = _cfgs(edges=[0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw=hw)
    port = CudaStreamPool(cfg, hw, S, device="cpu", ola="spectral")
    assert any(b.block > 16384 and b.wide is None for b in port.plan.buckets)
    ref = JaxBatch(jcfg, hw, n_streams=S)
    for i, b in enumerate(_blocks(6, S, 8, hw)):
        _assert_blocks_close(_stack(ref.push_blocks(b[:, 0], b[:, 1])), _stack(port.push_blocks(b[:, 0], b[:, 1])),
                             hw, what=f"block {i}")


def test_pack_and_unpack_the_jax_layout():
    rng = np.random.default_rng(0)
    carry = rng.standard_normal((4, 3, 3, 91, 2)).astype(np.float32)
    packed = pack_spectral_carry(carry)
    kp = spectral_lanes(91)
    assert kp == 256 and packed.shape == (4, 3 * 3 * kp)
    lanes = packed.reshape(4, 3, 3, kp)  # output-major, then slot-major
    np.testing.assert_array_equal(lanes[..., :91], carry[..., 0])
    np.testing.assert_array_equal(lanes[..., 91:182], carry[..., 1])
    assert not lanes[..., 182:].any()
    np.testing.assert_array_equal(unpack_spectral_carry(packed, 3, 91), carry)
    with pytest.raises(ValueError, match="packed spectral carry"):
        unpack_spectral_carry(packed[:, :-1], 3, 91)


def test_spectral_dispatch_on_the_cpu_is_the_plain_version():
    cfg, _ = _cfgs()
    plan = make_pool_plan(cfg, HW, 2, device="cpu", ola="spectral")
    rng = np.random.default_rng(1)
    hist = torch.as_tensor(rng.standard_normal((2, 2, 4 * HW)), dtype=torch.float32)
    t = torch.tensor([3, 9], dtype=torch.int32)
    carries = [torch.as_tensor(rng.standard_normal(b.spectral_carry_shape(2)), dtype=torch.float32)
               for b in plan.buckets]
    before = launches("K3", "K3s")
    for a, b in zip(pool_step_lcr(hist, t, carries, plan), pool_step_spectral_plain(hist, t, carries, plan)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert launches("K3", "K3s") == before
    time_carries = [torch.zeros((2, 3, b.block)) for b in plan.buckets]
    with pytest.raises(ValueError, match="spectral carry"):
        pool_step_lcr(hist, t, time_carries, plan)
    with pytest.raises(ValueError):
        pool_step_lcr(hist.to("meta"), t, carries, plan)
    # make_stream_pool: the CUDA pool in the requested mode when forced; the
    # batch pool (no OLA mode) on the CPU's "auto" and for "torch".
    assert make_stream_pool(cfg, HW, 4, engine="cuda", device="cpu", ola="spectral").ola == "spectral"
    assert not hasattr(make_stream_pool(cfg, HW, 4, device="cpu", ola="spectral"), "ola")
    with pytest.raises(ValueError, match="unknown ola"):
        make_stream_pool(cfg, HW, 4, device="cpu", ola="freq")
    # The single-stream engine keeps the time dataflow.
    assert StreamingUpmixer(cfg, HW, device="cpu")._plan.ola == "time"


def test_spectral_pool_serves_clients():
    # tests/test_serve_stream.py::test_spectral_pool_serves_clients: a
    # client of a spectral pool gets the single-stream engine's output.
    cfg, _ = _cfgs()
    with StreamServer(_spectral(cfg, 8), lockstep=True) as srv:
        L, R = make_stereo(8 * HW, SR, seed=67)
        L, R = L.astype(np.float32), R.astype(np.float32)
        got = stream_client(*srv.address, L, R)
    eng = StreamingUpmixer(cfg, HW, device="cpu")
    skip = (eng.warmup_blocks - 1) * HW
    n = len(L)
    pad = -(-n // HW) * HW + skip
    Lp, Rp = np.zeros(pad, np.float32), np.zeros(pad, np.float32)
    Lp[:n], Rp[:n] = L, R
    ref = [o.numpy()[skip : skip + n] for o in eng.process_signal(Lp, Rp, mix="stereo_sum")]
    assert len(got) == 2
    for g, r in zip(got, ref):
        assert np.asarray(g).shape == r.shape
        assert snr_db(r, np.asarray(g)) > 80.0


# K3s's redesign: the frames a call's output cuts (edge frames) go through
# a product against the inverse weight, the rest through inverse FFTs.
# The product's weight against the JAX body's rearranged weight, the
# three steps' plain versions against the plain step, the routing table.

SERVE_EDGES, SERVE_SR = [0.0, 500.0, 2000.0, 8000.0], 48000.0


def _serve_plan(hw, S):
    cfg = UpmixConfig.streaming(SERVE_EDGES, sr=SERVE_SR, hw_block_size=hw)
    return make_pool_plan(cfg, hw, S, device="cpu", ola="spectral")


@pytest.mark.parametrize("hw", [2048, 8192])
def test_edge_weight_is_the_jax_window_weight(hw):
    # The JAX body's weight wq [(Q + Kr - 1) kp, Q H] holds w_inv[k, (r + Kr
    # - 1 - j) H + tau] at slot j, hop r (pallas_pool.py:193-229), split
    # into bf16 hi + lo; the port's [B, Kp] holds the same w_inv with each
    # sample's (re, im) pairs interleaved.  Equal within the bf16 pair's
    # rounding (2^-17 of the largest weight; 1e-5 here).
    from upmix_tpu.ops.dftmm import make_direct_plan as jax_direct_plan
    from upmix_tpu.ops.pallas_pool import _spectral_bucket_fields

    for b in _serve_plan(hw, 1).buckets:
        aw, sw = b.analysis_window.numpy(), b.synthesis_window.numpy()
        K, H, Kr = b.kept, b.hop, b.overlap
        w = make_edge_weight(b.block, b.lo, K, aw, sw)
        assert w.shape == (b.block, -(-2 * K // EDGE_DEPTH) * EDGE_DEPTH) and w.dtype == np.float32
        assert not w[:, 2 * K :].any()
        f = _spectral_bucket_fields(jax_direct_plan(b.block, b.lo, b.lo + K - 1, aw, sw), b.block, H, hw, 2**62,
                                    n_bins=K)
        wq = np.asarray(f["wq_hi"], np.float32) + np.asarray(f["wq_lo"], np.float32)
        kp, Q = f["kp"], f["Q"]
        assert wq.shape == ((Q + Kr - 1) * kp, Q * H)
        atol = 1e-5 * float(np.abs(w).max())
        for j in range(Q + Kr - 1):
            for r in range(Q):
                got = wq[j * kp : (j + 1) * kp, r * H : (r + 1) * H]
                s = r + Kr - 1 - j
                if not 0 <= s < Kr:
                    assert not got.any()
                    continue
                mine = w[s * H : (s + 1) * H]
                np.testing.assert_allclose(got[:K], mine[:, 0 : 2 * K : 2].T, rtol=0, atol=atol)
                np.testing.assert_allclose(got[K : 2 * K], mine[:, 1 : 2 * K : 2].T, rtol=0, atol=atol)
                assert not got[2 * K :].any()


def _edge_by_weight(carries, specs, t, plan, hops):
    """The edge product as the kernel computes it, in float64: each edge
    frame's (re, im) pairs against the weight's rows n - vH."""
    S, N = t.shape[0], hops * plan.hw
    out = torch.zeros((S, 3, N), dtype=torch.float64)
    for b, c, x in zip(plan.buckets, carries, specs):
        edge, _ = b.spectral_frames(hops)
        if not edge:
            continue
        w = torch.as_tensor(make_edge_weight(b.block, b.lo, b.kept, b.analysis_window.numpy(),
                                             b.synthesis_window.numpy()), dtype=torch.float64)
        frames = torch.view_as_real(pool._virtual_frames(c, x, t, b, plan.warmup, hops)).flatten(-2)
        n = b.overlap - 1
        for v in edge:
            lo, hi = max(0, v * b.hop), min(N, v * b.hop + b.block)
            out[..., lo:hi] += frames[:, :, v + n] @ w[lo - v * b.hop : hi - v * b.hop, : 2 * b.kept].T
    first = (plan.warmup - t.long()).clamp(0, hops) * plan.hw
    return torch.where((torch.arange(N)[None, :] >= first[:, None])[:, None], out, 0.0)


STEP_CASES = {
    # (edges, config kwargs, hw, hops, t): t mixes streams part-way
    # through warmup (several first-ready hops at hops 4) with ready ones;
    # the stream at index 1 carries NaN and is not ready in the whole call
    # (where Kr = 1 its carry is empty and its second hop ready).
    "serve_hops1": ((SERVE_EDGES, dict(sr=SERVE_SR), 2048), 1, [1, 2, 3, 4, 5, 9]),
    "serve_hops4": ((SERVE_EDGES, dict(sr=SERVE_SR), 2048), 4, [1, 0, 2, 3, 4, 7]),
    "small_hops3": ((EDGES, dict(sr=SR), HW), 3, [1, 0, 2, 3, 4, 7]),
    "kr1": (([0.0, 1000.0], dict(sr=SR, overlap=0.0, max_block_size=128, synthesis="analysis",
                                  bin_rounding="cpp")), 2, [1, 0, 1, 2, 3, 4]),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_edge_and_whole_plain_compose_to_the_plain_step(case):
    # spectral_forward_plain, then spectral_edge_plain + spectral_whole_plain
    # in float64, equal pool_step_spectral_plain to 1e-10 (outputs and
    # carries), NaN where it has NaN; the edge product by the weight equals
    # the edge frames by irfft within the weight's float32 rounding.
    (edges, kw, *rest), hops, t = STEP_CASES[case]
    hw = rest[0] if rest else 128
    if "overlap" in kw:
        cfg = UpmixConfig.make(edges, **kw)
    else:
        cfg = UpmixConfig.streaming(edges, hw_block_size=hw, **kw)
    S = len(t)
    plan = make_pool_plan(cfg, hw, S, device="cpu", ola="spectral")
    assert (plan.warmup == 1) == (case == "kr1")
    rng = np.random.default_rng(hops + S)
    hist = torch.as_tensor(rng.standard_normal((S, 2, (plan.warmup - 1 + hops) * hw)))
    t = torch.as_tensor(t, dtype=torch.int32)
    carries = [torch.zeros(b.spectral_carry_shape(S), dtype=torch.float64).copy_(
        torch.as_tensor(rng.standard_normal(b.spectral_carry_shape(S)))) for b in plan.buckets]
    for c in carries:
        c[1] = float("nan")  # stream 1 is not ready in this call
    ref, ref_new = pool_step_spectral_plain(hist, t, carries, plan, hops)
    specs, new = pool.spectral_forward_plain(hist, t, carries, plan, hops)
    edge = pool.spectral_edge_plain(carries, specs, t, plan, hops)
    out = edge + pool.spectral_whole_plain(carries, specs, t, plan, hops)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(ref).all())
    assert float((out - ref).abs().max()) <= 1e-10 * max(1.0, float(ref.abs().max()))
    first = (plan.warmup - t.long()).clamp(0, hops) * hw
    for s in range(S):  # the hops before a stream's first ready one are exact zeros
        assert not out[s, :, : int(first[s])].any()
    assert int(first[1]) == hops * hw or plan.warmup == 1  # stream 1 not ready, but where Kr = 1
    for r, n, c in zip(ref_new, new, carries):
        assert r.shape == n.shape and torch.equal(r.isnan(), n.isnan())
        if r.numel():
            assert float((r - n).nan_to_num().abs().max()) <= 1e-10 * max(1.0, float(r.nan_to_num().abs().max()))
            assert bool(n[1].isnan().all())  # stream 1's carry held
    if any(b.spectral_frames(hops)[0] for b in plan.buckets):
        clean = [c.nan_to_num() for c in carries]
        by_weight = _edge_by_weight(clean, specs, t, plan, hops)
        assert snr_db(pool.spectral_edge_plain(clean, specs, t, plan, hops).numpy(), by_weight.numpy()) > 120.0
    else:
        assert not edge.any()


def test_edge_routing_table_of_the_serving_config():
    # Virtual frame v spans [vH, vH + B) of a call's output [0, hops hw):
    # edge frames reach past an end of it, whole frames lie inside.  The
    # product takes a bucket whose frames at hops 1 are all edge frames (P
    # <= Kr - 1: the 8192 and 4096 buckets at hw 2048); the 1024 and 256
    # buckets keep every frame on the inverse FFTs.
    def rng(a, b):
        return tuple(range(a, b))

    want = {
        1: {8192: (rng(-3, 1), ()), 4096: (rng(-3, 2), ()), 1024: ((), rng(-3, 8)), 256: ((), rng(-3, 32))},
        4: {8192: ((-3, -2, -1, 1, 2, 3), (0,)), 4096: ((-3, -2, -1, 5, 6, 7), rng(0, 5)),
            1024: ((), rng(-3, 32)), 256: ((), rng(-3, 128))},
    }
    plan = _serve_plan(2048, 4)
    assert [b.edge_product for b in plan.buckets] == [True, True, False, False]
    assert all(b.edge_weight is None for b in plan.buckets)  # a CPU plan keeps no weight
    for hops, table in want.items():
        assert {b.block: b.spectral_frames(hops) for b in plan.buckets} == table
    # The geometry alone: edge frames of the 1024 bucket at hops 1.
    assert pool.edge_frames(1024, 256, 8) == (-3, -2, -1, 5, 6, 7)
    # 4 forwards, the gather and the product for the two buckets, the
    # whole frames' inverses
    assert pool.spectral_launches(plan, 1) == 4 + 2 + 2
    assert pool.spectral_launches(plan, 4) == 4 + 2 + 4
    # At hw 8192 the 32768 bucket (over FFT_MAX, P = 1) takes the product;
    # its forward is two launches.
    wide = _serve_plan(8192, 1)
    assert [b.block for b in wide.buckets if b.edge_product] == [32768]
    assert pool.spectral_launches(wide, 1) == 5 + 2 + 3
    # A bucket keeping every bin stays on the FFTs (its product would cost
    # hundreds of times its inverses), as does Kr = 1 (no edge frame).
    assert not takes_edge_product(16384, 4096, 8193, 4096)
    assert takes_edge_product(8192, 2048, 107, 2048) and not takes_edge_product(256, 256, 97, 256)
    one = make_pool_plan(UpmixConfig.streaming([0.0], sr=8000.0, hw_block_size=4096), 4096, 2, device="cpu",
                         ola="spectral")
    assert not one.buckets[0].edge_product
    assert one.buckets[0].spectral_frames(1) == ((), rng(-3, 1))


@pytest.mark.parametrize("hw,hops,counts", [(2048, 1, (43, 43, 46, 46)), (2048, 4, (172, 172, 172, 172)),
                                             (8192, 1, (169, 168, 177, 177)), (8192, 4, (676, 672, 682, 681))])
def test_register_core_frames_of_the_serving_config(hw, hops, counts):
    # The FFT frames of a stream's call in K3s's forward and inverse steps
    # (the `pool.forward` and `pool.inverse` spans' `fft_frames`) and those
    # the register core takes (`reg_frames`): every bucket up to FFT_MAX
    # points.  At hw 2048 the Bela buckets' 1 + 2 + 8 + 32 new frames a
    # block go forward, and the 1024 and 256 buckets' 11 + 35 frames
    # inverse (at hops 4 every bucket has whole frames: 1 + 5 + 35 + 131);
    # at hw 8192 the 32768 bucket's frames (1 a block forward, 0 or 1
    # inverse) take the split.  A spectral plan's buckets up to FFT_MAX
    # points carry the core's twiddles, and so do a time plan's (K3 runs
    # them on the same core).
    plan = _serve_plan(hw, 2)
    r = plan.spectral_routes(hops)
    assert (r.forward_frames, r.forward_reg, r.inverse_frames, r.inverse_reg) == counts
    for b in plan.buckets:
        assert b.twiddles is None if b.block > FFT_MAX else torch.equal(b.twiddles, torch.as_tensor(reg_twiddles(b.block)))
    cfg = UpmixConfig.streaming(SERVE_EDGES, sr=SERVE_SR, hw_block_size=hw)
    for b in make_pool_plan(cfg, hw, 2, device="cpu").buckets:
        assert b.twiddles is None if b.block > FFT_MAX else torch.equal(b.twiddles, torch.as_tensor(reg_twiddles(b.block)))


def test_spectral_steps_run_where_the_spectra_lie():
    # spectral_edge and spectral_whole run the plain versions for spectra on
    # the CPU (equal to them exactly), and refuse t, a carry or out on
    # another device, or spectra where no kernel runs.
    plan = _serve_plan(2048, 3)
    rng = np.random.default_rng(11)
    hist = torch.as_tensor(rng.standard_normal((3, 2, 4 * 2048)), dtype=torch.float32)
    t = torch.tensor([1, 4, 9], dtype=torch.int32)
    carries = [torch.as_tensor(rng.standard_normal(b.spectral_carry_shape(3)), dtype=torch.float32)
               for b in plan.buckets]
    specs, _ = pool.spectral_forward(hist, t, carries, plan)
    edge = pool.spectral_edge(carries, specs, t, plan)
    torch.testing.assert_close(edge, pool.spectral_edge_plain(carries, specs, t, plan), rtol=0, atol=0)
    torch.testing.assert_close(pool.spectral_whole(carries, specs, t, plan, out=edge),
                               edge + pool.spectral_whole_plain(carries, specs, t, plan), rtol=0, atol=0)
    meta = [x.to("meta") for x in (t, edge, carries[0])]
    with pytest.raises(ValueError, match="one device"):
        pool.spectral_edge(carries, specs, meta[0], plan)
    with pytest.raises(ValueError, match="one device"):
        pool.spectral_whole(carries, specs, t, plan, out=meta[1])
    with pytest.raises(ValueError, match="one device"):
        pool.spectral_whole([meta[2], *carries[1:]], specs, t, plan)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pool.spectral_edge([c.to("meta") for c in carries], [x.to("meta") for x in specs], meta[0], plan)
