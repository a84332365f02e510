"""The port's serving pool (on the CPU: the pool step's plain version)
against the JAX package's Pallas pool run in interpret mode.

Inputs are made from a seed with numpy and fed to both packages.  The
JAX kernel multiplies in bf16x3 (about 1e-6 relative error) and the
port's plain version uses float32 FFTs, so the bar is 80 dB per output;
warmup blocks and not-ready hops must be exact zeros on both sides.
"""

import numpy as np
import pytest
import torch

from helpers import snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.streaming import BatchStreamingUpmixer as JaxBatch
from upmix_tpu.models.streaming import PallasStreamPool
from upmix_tpu.ops.pallas_pool import make_pool_plan as jax_make_pool_plan
from upmix_tpu.ops.pallas_pool import pool_step_lcr as jax_pool_step_lcr
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch import aot
from upmix_tpu_torch.models.streaming import CudaStreamPool
from upmix_tpu_torch.ops import pool
from upmix_tpu_torch.ops.fftplan import reg_twiddles
from upmix_tpu_torch.ops.pool import make_pool_plan, pool_step_lcr, pool_step_lcr_plain
from upmix_tpu_torch.ops.pool_floor import floor_bytes, pool_floor, pool_floor_plain
from upmix_tpu_torch.parallel import make_mesh
from upmix_tpu_torch.utils.tracing import launches

HW = 256
EDGES = [0.0, 400.0, 1600.0]


def _cfgs(edges=EDGES, sr=8000.0, hw=HW, **kw):
    return (
        UpmixConfig.streaming(edges, sr=sr, hw_block_size=hw, **kw),
        JaxUpmixConfig.streaming(edges, sr=sr, hw_block_size=hw, **kw),
    )


def _blocks(n_blocks, S, seed):
    return np.random.default_rng(seed).standard_normal((n_blocks, S, 2, HW)).astype(np.float32) * 0.3


def _stack(outs):
    return np.stack([np.asarray(o) for o in outs])


def _assert_close(want, got, bar=80.0, what=""):
    """> bar dB where the reference is nonzero, exact zeros where it is zero."""
    want, got = np.asarray(want), np.asarray(got)
    if np.abs(want).max() == 0:
        assert np.abs(got).max() == 0.0, what
    else:
        assert snr_db(want, got) > bar, what


@pytest.mark.parametrize("hops", [1, 3])
def test_pool_step_matches_jax_interpret(hops):
    cfg, jcfg = _cfgs()
    S = 8
    plan = make_pool_plan(cfg, HW, S, device="cpu")
    jplan = jax_make_pool_plan(jcfg, HW, S, group=8)
    assert [(b.block, b.hop, b.passes) for b in plan.buckets] == [(b.B, b.H, b.P) for b in jplan.buckets]
    nq = jplan.window // HW
    rng = np.random.default_rng(hops)
    hist = rng.standard_normal((S, 2, (nq - 1 + hops) * HW)).astype(np.float32)
    t = np.array([1, 2, 3, 4, 5, 6, 1, 3], np.int32)  # straddles warmup (K = 4)
    carries = [rng.standard_normal((S, 3, b.block)).astype(np.float32) for b in plan.buckets]

    (oc, ols, ors), jnew = jax_pool_step_lcr(
        [hist[:, 0, q * HW : (q + 1) * HW] for q in range(nq - 1 + hops)],
        [hist[:, 1, q * HW : (q + 1) * HW] for q in range(nq - 1 + hops)],
        t,
        tuple(tuple(c[:, o] for o in range(3)) for c in carries),
        jplan,
        interpret=True,
        hops=hops,
    )
    out, new = pool_step_lcr(torch.as_tensor(hist), torch.as_tensor(t), [torch.as_tensor(c) for c in carries],
                             plan, hops)
    ref = np.stack([np.asarray(oc), np.asarray(ols), np.asarray(ors)], axis=1)
    assert out.shape == (S, 3, hops * HW)
    for s in range(S):
        for i in range(hops):
            blk = slice(i * HW, (i + 1) * HW)
            _assert_close(ref[s, :, blk], out[s, :, blk].numpy(), what=f"stream {s} hop {i}")
    for c, j, n in zip(carries, jnew, new):
        jn = np.stack([np.asarray(a) for a in j], axis=1)
        for s in range(S):
            if t[s] + hops - 1 < 4:  # never ready in this call: the carry is held
                np.testing.assert_array_equal(n[s].numpy(), c[s])
            assert snr_db(jn[s], n[s].numpy()) > 80.0


def test_cuda_pool_matches_jax_pallas_pool():
    cfg, jcfg = _cfgs()
    S, n_blocks = 8, 10
    blocks = _blocks(n_blocks, S, 41)
    ref = PallasStreamPool(jcfg, HW, n_streams=S, group=8)
    port = CudaStreamPool(cfg, HW, S, device="cpu")
    for t in range(n_blocks):
        want = _stack(ref.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        got = _stack(port.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        if t < port.warmup_blocks - 1:
            assert np.abs(got).max() == 0.0, f"block {t} not silent in warmup"
        _assert_close(want, got, what=f"block {t}")


def test_cuda_pool_any_stream_count_matches_jax_batch():
    # 13 streams: not a multiple of 8, which the JAX Pallas pool refuses;
    # the port has no group rule.
    cfg, jcfg = _cfgs()
    S, n_blocks = 13, 8
    blocks = _blocks(n_blocks, S, 42)
    with pytest.raises(ValueError, match="not eligible"):
        PallasStreamPool(jcfg, HW, n_streams=S, group=8)
    ref = JaxBatch(jcfg, HW, n_streams=S)
    port = CudaStreamPool(cfg, HW, S, device="cpu")
    for t in range(n_blocks):
        want = _stack(ref.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        got = _stack(port.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        _assert_close(want, got, what=f"block {t}")


def test_reset_streams_leaves_others_bit_identical():
    cfg, _ = _cfgs()
    S, n_blocks = 5, 12
    blocks = _blocks(n_blocks, S, 43)
    plain = CudaStreamPool(cfg, HW, S, device="cpu")
    plain_out = [_stack(plain.push_blocks(b[:, 0], b[:, 1])) for b in blocks]
    churn = CudaStreamPool(cfg, HW, S, device="cpu")
    half = n_blocks // 2
    for b in blocks[:half]:
        churn.push_blocks(b[:, 0], b[:, 1])
    churn.reset_streams([2])
    for t, b in enumerate(blocks[half:]):
        got = _stack(churn.push_blocks(b[:, 0], b[:, 1]))
        keep = [0, 1, 3, 4]
        np.testing.assert_array_equal(got[:, keep], plain_out[half + t][:, keep])
        if t < churn.warmup_blocks - 1:
            assert np.abs(got[:, 2]).max() == 0.0
    with pytest.raises(ValueError, match="out of range"):
        churn.reset_streams([5])


@pytest.mark.parametrize("hops", [2, 3])
def test_push_blocks_multi_equals_sequential(hops):
    cfg, _ = _cfgs()
    S, n_blocks = 3, 6
    blocks = _blocks(n_blocks, S, 44)
    seq = CudaStreamPool(cfg, HW, S, device="cpu")
    want = np.concatenate([_stack(seq.push_blocks(b[:, 0], b[:, 1])) for b in blocks], axis=-1)
    multi = CudaStreamPool(cfg, HW, S, device="cpu")
    got = []
    for t0 in range(0, n_blocks, hops):
        xs = blocks[t0 : t0 + hops]
        got.append(_stack(multi.push_blocks_multi(
            np.concatenate(list(xs[:, :, 0]), axis=1), np.concatenate(list(xs[:, :, 1]), axis=1)
        )))
    np.testing.assert_array_equal(np.concatenate(got, axis=-1), want)
    np.testing.assert_array_equal(multi.state["t"].numpy(), seq.state["t"].numpy())
    with pytest.raises(ValueError, match="push_blocks_multi expects"):
        multi.push_blocks_multi(np.zeros((S, HW + 1)), np.zeros((S, HW + 1)))


def test_sustained_runner_matches_push_blocks():
    cfg, _ = _cfgs()
    S, n_blocks = 3, 6
    blocks = _blocks(n_blocks, S, 45)
    pool_ = CudaStreamPool(cfg, HW, S, device="cpu")
    want = [_stack(pool_.push_blocks(b[:, 0], b[:, 1]))[0] for b in blocks]
    run, fresh = pool_.make_sustained_runner(n_blocks)
    _, cs = run(fresh(), torch.as_tensor(blocks.transpose(0, 2, 1, 3)))
    np.testing.assert_array_equal(cs.numpy(), np.stack(want))
    run2, fresh2 = pool_.make_sustained_runner(n_blocks, hops=2)
    slabs = blocks.reshape(3, 2, S, 2, HW).transpose(0, 3, 2, 1, 4).reshape(3, 2, S, 2 * HW)
    _, cs2 = run2(fresh2(), torch.as_tensor(slabs))
    np.testing.assert_array_equal(cs2[-1, :, -HW:].numpy(), want[-1])
    with pytest.raises(ValueError, match="multiple of hops"):
        pool_.make_sustained_runner(5, hops=2)


def test_nan_stream_isolation():
    cfg, _ = _cfgs()
    S, n_blocks = 8, 10
    blocks = _blocks(n_blocks, S, 23)
    clean = CudaStreamPool(cfg, HW, S, device="cpu")
    dirty = CudaStreamPool(cfg, HW, S, device="cpu")
    ok = [i for i in range(S) if i != 2]
    for t in range(n_blocks):
        want = _stack(clean.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        bad = blocks[t].copy()
        if t >= 5:
            bad[2] = np.nan
        got = _stack(dirty.push_blocks(bad[:, 0], bad[:, 1]))
        np.testing.assert_array_equal(got[:, ok], want[:, ok])
        if t >= 5:
            assert not np.isfinite(got[:, 2]).any()
    dirty.reset_streams([2])
    for t in range(dirty.warmup_blocks + 1):
        assert np.isfinite(_stack(dirty.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))).all()


@pytest.mark.parametrize("layout", ["quarters", "window"])
def test_snapshot_from_jax_resumes_in_port(layout):
    cfg, jcfg = _cfgs()
    S = 8
    blocks = _blocks(12, S, 47)
    ref = PallasStreamPool(jcfg, HW, n_streams=S, group=8, layout=layout)
    for b in blocks[:6]:
        ref.push_blocks(b[:, 0], b[:, 1])
    port = CudaStreamPool(cfg, HW, S, device="cpu")
    port.restore(ref.snapshot())
    for t, b in enumerate(blocks[6:]):
        want = _stack(ref.push_blocks(b[:, 0], b[:, 1]))
        _assert_close(want, _stack(port.push_blocks(b[:, 0], b[:, 1])), what=f"block {6 + t}")


def test_snapshot_from_port_resumes_in_jax():
    cfg, jcfg = _cfgs()
    S = 8
    blocks = _blocks(12, S, 48)
    port = CudaStreamPool(cfg, HW, S, device="cpu")
    for b in blocks[:6]:
        port.push_blocks(b[:, 0], b[:, 1])
    snap = port.snapshot()
    assert len(snap["histL"]) == port.warmup_blocks - 1 and snap["histL"][0].shape == (S, HW)
    ref = PallasStreamPool(jcfg, HW, n_streams=S, group=8)
    ref.restore(snap)
    again = CudaStreamPool(cfg, HW, S, device="cpu")
    again.restore(snap)
    for t, b in enumerate(blocks[6:]):
        mine = _stack(port.push_blocks(b[:, 0], b[:, 1]))
        np.testing.assert_array_equal(_stack(again.push_blocks(b[:, 0], b[:, 1])), mine)
        _assert_close(_stack(ref.push_blocks(b[:, 0], b[:, 1])), mine, what=f"block {6 + t}")


def test_loaded_carry_waits_for_warmup_as_in_jax():
    # load_streams can put a nonzero carry into a slot whose t is below the
    # warmup: the carry must be held through the silent blocks and emitted
    # at the first ready one, as the JAX kernel does.
    cfg, jcfg = _cfgs()
    S = 8
    blocks = _blocks(12, S, 49)
    donor = PallasStreamPool(jcfg, HW, n_streams=S, group=8)
    ref = PallasStreamPool(jcfg, HW, n_streams=S, group=8)
    for b in blocks[:6]:
        donor.push_blocks(b[:, 0], b[:, 1])
        ref.push_blocks(b[::-1, 0], b[::-1, 1])
    rows = donor.extract_streams([1, 6])
    rows["t"] = np.array([1, 2], np.int32)  # below the warmup of 4
    assert all(np.abs(np.asarray(c)).max() > 0 for c in rows["ola"]["1024"])
    port = CudaStreamPool(cfg, HW, S, device="cpu")
    port.restore(ref.snapshot())
    ref.load_streams([3, 5], rows)
    port.load_streams([3, 5], rows)
    np.testing.assert_array_equal(port.extract_streams([3, 5])["t"], [1, 2])
    for t, b in enumerate(blocks[6:]):
        want = _stack(ref.push_blocks(b[:, 0], b[:, 1]))
        got = _stack(port.push_blocks(b[:, 0], b[:, 1]))
        for s in range(S):
            _assert_close(want[:, s], got[:, s], what=f"block {6 + t} stream {s}")


def test_restore_rejects_mismatched_snapshots():
    # A JAX spectral snapshot restores into a spectral port pool and the
    # two continue together; across OLA modes a snapshot raises, as in the
    # JAX package, and so does one of another pool size.
    cfg, jcfg = _cfgs()
    port = CudaStreamPool(cfg, HW, 8, device="cpu")
    spectral = PallasStreamPool(jcfg, HW, n_streams=8, group=8, ola="spectral")
    blocks = _blocks(8, 8, 50)
    for b in blocks[:5]:
        spectral.push_blocks(b[:, 0], b[:, 1])
    with pytest.raises(ValueError, match="OLA format"):
        port.restore(spectral.snapshot())
    port_spectral = CudaStreamPool(cfg, HW, 8, device="cpu", ola="spectral")
    port_spectral.restore(spectral.snapshot())
    with pytest.raises(ValueError, match="OLA format"):
        port_spectral.restore(port.snapshot())
    for t, b in enumerate(blocks[5:]):
        _assert_close(_stack(spectral.push_blocks(b[:, 0], b[:, 1])),
                      _stack(port_spectral.push_blocks(b[:, 0], b[:, 1])), what=f"block {5 + t}")
    with pytest.raises(ValueError, match="histL"):
        CudaStreamPool(cfg, HW, 4, device="cpu").restore(port.snapshot())


def test_plan_declines_only_what_it_cannot_run():
    cfg, _ = _cfgs()
    for S in (1, 5, 13):  # no group rule
        plan = make_pool_plan(cfg, HW, S, device="cpu")
        assert plan.n_streams == S and plan.window == 4 * HW
        for b in plan.buckets:  # windows, gains and the register core's twiddles: no direct-DFT weights
            assert torch.equal(b.twiddles, torch.as_tensor(reg_twiddles(b.block))) and b.wide is None
            assert [k for k, v in vars(b).items() if isinstance(v, torch.Tensor)] == [
                "analysis_window", "synthesis_window", "gains", "twiddles"]
    assert make_pool_plan(cfg, 100, 8, device="cpu") is None  # hop does not divide hw
    mixed = UpmixConfig(sr=8000.0, bands=(
        UpmixConfig.make([0.0], sr=8000.0, max_block_size=512).bands[0],
        UpmixConfig.make([0.0], sr=8000.0, max_block_size=256, overlap=0.5).bands[0],
    ))
    assert make_pool_plan(mixed, HW, 8, device="cpu") is None  # mixed block/hop ratios
    wide = UpmixConfig.make([0.0, 400.0], sr=8000.0, max_block_size=4096)
    assert make_pool_plan(wide, HW, 8, device="cpu") is None  # hop 1024 does not divide hw
    with pytest.raises(ValueError, match="not eligible"):
        CudaStreamPool(wide, HW, 8, device="cpu")


def test_cpu_pool_plan_builds_no_split_tables():
    # At hw 8192 the streaming config's 32768 bucket is over FFT_MAX: a CPU
    # plan carries none of the two-stage split's tables (only a CUDA plan
    # builds them, as omnibus.make_bucket does), and the pool runs its
    # plain version, against the JAX XLA engine on the same blocks.
    hw, S = 8192, 2
    cfg, jcfg = _cfgs(hw=hw, sr=48000.0, edges=[0.0, 500.0, 2000.0, 8000.0])
    plan = make_pool_plan(cfg, hw, S, device="cpu")
    big = [b for b in plan.buckets if b.block > 16384]
    assert big and all(b.wide is None and b.twiddles is None for b in big)
    assert all(b.twiddles is not None for b in plan.buckets if b.block <= 16384)
    port = CudaStreamPool(cfg, hw, S, device="cpu")
    ref = JaxBatch(jcfg, hw, n_streams=S)
    rng = np.random.default_rng(8)
    for i in range(6):
        xl, xr = (rng.standard_normal((S, hw)).astype(np.float32) * 0.3 for _ in range(2))
        got, want = port.push_blocks(xl, xr), ref.push_blocks(xl, xr)
        for o in range(3):
            _assert_close(want[o], got[o], what=f"block {i} output {o}")


def test_cpu_dispatch_is_the_plain_version_and_options_not_ported(tmp_path):
    cfg, _ = _cfgs()
    plan = make_pool_plan(cfg, HW, 2, device="cpu")
    rng = np.random.default_rng(0)
    hist = torch.as_tensor(rng.standard_normal((2, 2, 4 * HW)), dtype=torch.float32)
    t = torch.tensor([3, 9], dtype=torch.int32)
    carries = [torch.zeros((2, 3, b.block)) for b in plan.buckets]
    before = launches("K3")
    for a, b in zip(pool_step_lcr(hist, t, carries, plan), pool_step_lcr_plain(hist, t, carries, plan)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert launches("K3") == before
    with pytest.raises(ValueError):
        pool_step_lcr(hist.to("meta"), t, carries, plan)
    with pytest.raises(ValueError):
        pool_step_lcr(hist[..., :-1], t, carries, plan)
    # A mesh and the spectral dataflow construct (tests/test_torch_pool_mesh.py
    # and test_torch_spectral.py run them); the AOT load (the JAX package's
    # shape-only build) gives the built plan, checked against the artifact.
    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    assert CudaStreamPool(cfg, HW, 8, device="cpu", mesh=mesh).plan.n_streams == 4
    assert CudaStreamPool(cfg, HW, 8, device="cpu", ola="spectral").plan.ola == "spectral"
    with pytest.raises(ValueError, match="unknown ola"):
        CudaStreamPool(cfg, HW, 8, device="cpu", ola="freq")
    built = CudaStreamPool(cfg, HW, 8, device="cpu")
    aot.save_stream_pool(str(tmp_path / "pool.upmixaot"), cfg, HW, 8, device="cpu")
    slim = aot.load(str(tmp_path / "pool.upmixaot"), device="cpu")
    assert [(b.block, b.hop, b.lo, b.kept) for b in slim.plan.buckets] == [
        (b.block, b.hop, b.lo, b.kept) for b in built.plan.buckets]
    assert all(torch.equal(s.gains, b.gains) and torch.equal(s.analysis_window, b.analysis_window)
               for s, b in zip(slim.plan.buckets, built.plan.buckets))


def _probe_body(histL, histR, geometry, hw, mode):
    """numpy copy of the kernel body of scripts/bench_pool_floor.py:54-78
    with the whole pool as one group (G = S)."""
    G, W = histL.shape
    if mode == "copy":
        return histL[:, :hw] + histR[:, :hw], histL[:, W - hw :], histR[:, W - hw :]
    acc = None
    for Bk, H, P in geometry:
        Kr = Bk // H
        NG, M = (Kr, P // Kr) if P % Kr == 0 else (P, 1)
        zs = []
        for ch in (histL, histR):
            for j in range(NG):
                zs.append(ch[:, j * H : j * H + M * Bk].reshape(G * M, Bk))
        Z = np.concatenate(zs, axis=0)
        w = min(hw, Bk)
        part = Z[:G, :w]
        if w < hw:
            part = np.pad(part, ((0, 0), (0, hw - w)))
        acc = part if acc is None else acc + part
    return acc, acc + histL[:, :hw], acc + histR[:, :hw]


def test_floor_library_call_and_timing_entry_point():
    # The same-bytes yardstick reads the whole history (the sum of its
    # hw-long pieces); the timing entry point needs the card and says so.
    from upmix_tpu_torch.ops.pool_floor import library_call, main

    hist = torch.as_tensor(np.random.default_rng(9).standard_normal((3, 2, 1024)), dtype=torch.float32)
    torch.testing.assert_close(library_call(hist, 256), sum(hist[..., k * 256 : (k + 1) * 256] for k in range(4)))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            main([])


@pytest.mark.parametrize("mode", ["copy", "frame"])
@pytest.mark.parametrize("hw", [256, 512])
def test_floor_matches_probe_body(mode, hw):
    cfg, jcfg = _cfgs(hw=hw)
    S = 6
    plan = make_pool_plan(cfg, hw, S, device="cpu")
    jplan = jax_make_pool_plan(jcfg, hw, 8, group=8)
    geometry = [(b.B, b.H, b.P) for b in jplan.buckets]
    hist = np.random.default_rng(hw).standard_normal((S, 2, plan.window)).astype(np.float32)
    want = np.stack(_probe_body(hist[:, 0], hist[:, 1], geometry, hw, mode), axis=1)
    got = pool_floor(torch.as_tensor(hist), hw, mode, plan)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pool_floor_plain(torch.as_tensor(hist), hw, mode, plan).numpy(), want)
    # bytes: the whole history of both channels in, three outputs out
    assert floor_bytes(S, plan.window, hw) == hist.nbytes + want.nbytes
