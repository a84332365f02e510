"""The port's stream server (`upmix_tpu_torch.serve_stream`) on the CPU:
the pools run the pool step's plain version.

The cases of tests/test_serve_stream.py that the port supports: each
client gets exactly the warmup-aligned output its signal would get from
the single-stream engine, concurrently, with slot churn, pool-full
rejection, checkpoint and resume, hops, pipelining and their guards, the
failure paths and the CLI.  Then parity with the JAX package: the same
seeded blocks through the JAX server (its XLA pool) and the port's
server, both against the float64 oracle; a JAX client against the port's
server; the Prometheus text of both packages on one snapshot.
"""

import json
import re
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from helpers import cpu_child_env, make_stereo, snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.metrics import prometheus_text as jax_prometheus_text
from upmix_tpu.models.streaming import BatchStreamingUpmixer as JaxBatch
from upmix_tpu.oracle.reference import oracle_stream_multiband
from upmix_tpu.serve_stream import StreamServer as JaxStreamServer
from upmix_tpu.serve_stream import StreamSession as JaxStreamSession
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.metrics import prometheus_text
from upmix_tpu_torch.models.streaming import (
    BatchStreamingUpmixer,
    CudaStreamPool,
    StreamingUpmixer,
    stream_warmup_blocks,
)
from upmix_tpu_torch.parallel import make_mesh
from upmix_tpu_torch.serve_stream import (
    MAGIC_HELLO,
    MAGIC_REPLY,
    StreamServer,
    StreamSession,
    _read_exact,
    fetch_metrics,
    run_stream_server,
    stream_client,
)

HW = 256
SR = 8000.0
EDGES = [0.0, 400.0, 1600.0]


def _cfg():
    return UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)


def _batch(n=4):
    return BatchStreamingUpmixer(_cfg(), HW, n, device="cpu")


def _cuda_pool(n=8):
    """The serving pool (its plain step on the CPU): the one with hops."""
    return CudaStreamPool(_cfg(), HW, n, device="cpu")


@pytest.fixture(scope="module")
def server():
    with StreamServer(_batch(), lockstep=True) as srv:
        yield srv


def _signal(n, seed):
    L, R = make_stereo(n, SR, seed=seed)
    return L.astype(np.float32), R.astype(np.float32)


def _warmup_skip():
    return (stream_warmup_blocks(_cfg()) - 1) * HW


def _aligned_reference(L, R, mix="stereo_sum"):
    """What a warmup-aligned client must receive: the single-stream
    engine over the padded signal plus zero drain blocks, the leading
    warmup silence dropped, trimmed to the input length."""
    eng = StreamingUpmixer(_cfg(), HW, device="cpu")
    n = len(L)
    pad = (-n) % HW
    xl = np.concatenate([L, np.zeros(pad, np.float32)])
    xr = np.concatenate([R, np.zeros(pad, np.float32)])
    skip, total, outs, emitted, bi = _warmup_skip(), len(xl), [], 0, 0
    zeros = np.zeros(HW, np.float32)
    while emitted < total:
        b = bi * HW
        bl, br = (xl[b : b + HW], xr[b : b + HW]) if b < total else (zeros, zeros)
        bi += 1
        c, ls, rs = (o.numpy() for o in eng.push_block(bl, br))
        out = np.column_stack([c, ls, rs] if mix == "lcr" else [ls + 0.5 * c, rs + 0.5 * c])
        k = min(skip, len(out))
        out, skip = out[k:], skip - k
        out = out[: total - emitted]
        if len(out):
            outs.append(out)
            emitted += len(out)
    ref = np.concatenate(outs)[:n]
    return tuple(np.ascontiguousarray(ref[:, ch]) for ch in range(ref.shape[1]))


def _check(got, ref):
    # The server and the single-stream engine run the same plain step on
    # the same blocks: 80 dB where the reference is not silent.
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape
        if np.abs(r).max() > 0:
            assert snr_db(r, g) > 80.0
        else:
            np.testing.assert_allclose(g, r, atol=1e-6)


def _one_shot(pool_factory, L, R, mix="stereo_sum", **kw):
    """An uninterrupted run of the signal on a fresh server: the exact
    reference for a checkpointed and resumed session."""
    with StreamServer(pool_factory(), lockstep=True, **kw) as srv:
        return stream_client(*srv.address, L, R, mix=mix)


def _send_and_read(sess, xl, xr, start_blk, n_blocks, already_read):
    """Send blocks [start_blk, start_blk + n_blocks) and read every output
    frame due after their dispatches (lockstep, this the only sender)."""
    for b in range(start_blk, start_blk + n_blocks):
        sess.send_block(xl[b * HW : (b + 1) * HW], xr[b * HW : (b + 1) * HW])
    due = max(0, (start_blk + n_blocks) * HW - _warmup_skip()) - already_read
    return sess.recv_frames(due) if due > 0 else np.zeros((0, sess.out_channels), "<f4")


def _in_threads(fn, n):
    results = [None] * n

    def go(i):
        results[i] = fn(i)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return results


# -- sessions -----------------------------------------------------------------


def test_single_client_round_trip(server):
    L, R = _signal(10 * HW + 100, 60)  # a short final block: padded, output trimmed
    _check(stream_client(*server.address, L, R), _aligned_reference(L, R))


def test_lcr_mix(server):
    L, R = _signal(6 * HW, 61)
    got = stream_client(*server.address, L, R, mix="lcr")
    assert len(got) == 3
    _check(got, _aligned_reference(L, R, mix="lcr"))


def test_concurrent_clients_are_isolated(server):
    sigs = [_signal(8 * HW, seed) for seed in (62, 63, 64)]
    results = _in_threads(lambda i: stream_client(*server.address, *sigs[i]), len(sigs))
    for got, (L, R) in zip(results, sigs):
        assert got is not None
        _check(got, _aligned_reference(L, R))


def test_many_clients_under_a_short_switch_interval():
    # More client threads than cores, with the interpreter switching
    # threads every 10 us: a lost update to a slot's queue or counters
    # would show as a client's frames out of place or the frame total off.
    sigs = [_signal((4 + i % 3) * HW + 7 * i, 130 + i) for i in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with StreamServer(_batch(16), lockstep=True) as srv:
            results = _in_threads(lambda i: stream_client(*srv.address, *sigs[i], timeout=60.0), len(sigs))
            frames = srv.stats["frames"]
    finally:
        sys.setswitchinterval(old)
    for got, (L, R) in zip(results, sigs):
        assert got is not None
        _check(got, _aligned_reference(L, R))
    assert frames == sum(-(-len(L) // HW) * HW for L, _ in sigs)


def test_slot_reuse_after_churn(server):
    for seed in (65, 66):  # a re-warmed slot behaves like a fresh engine
        L, R = _signal(5 * HW, seed)
        _check(stream_client(*server.address, L, R), _aligned_reference(L, R))


def test_pool_full_rejection():
    with StreamServer(_batch(1), lockstep=True) as srv:
        hold = socket.create_connection(srv.address, timeout=10)
        hold.sendall(MAGIC_HELLO + struct.pack("<II", 1, 0))
        reply = _read_exact(hold, 20)
        assert reply[:4] == MAGIC_REPLY and struct.unpack("<I", reply[4:8])[0] == 0
        with pytest.raises(ConnectionError, match="full"):
            stream_client(*srv.address, *_signal(2 * HW, 67))
        hold.close()
        last = None
        for _ in range(50):  # the abandoned slot drains out and frees
            try:
                last = stream_client(*srv.address, *_signal(2 * HW, 68))
                break
            except ConnectionError:
                time.sleep(0.1)
        assert last is not None, "slot never freed after client abort"


def test_realtime_tick_mode_completes():
    with StreamServer(_batch(2), lockstep=False, sr=SR * 8) as srv:
        got = stream_client(*srv.address, *_signal(4 * HW, 69))
        assert len(got) == 2 and all(np.isfinite(g).all() and len(g) == 4 * HW for g in got)
        assert srv.stats["blocks"] > 0


def test_rst_abort_frees_slot_and_pool_keeps_serving():
    with StreamServer(_batch(1), lockstep=True) as srv:
        rude = socket.create_connection(srv.address, timeout=10)
        rude.sendall(MAGIC_HELLO + struct.pack("<II", 1, 0))
        assert len(_read_exact(rude, 20)) == 20
        rude.sendall(np.zeros(int(1.5 * HW * 2), np.float32).tobytes())
        rude.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        rude.close()  # RST mid-block
        L, R = _signal(3 * HW, 71)
        got = None
        for _ in range(100):
            try:
                got = stream_client(*srv.address, L, R, timeout=30.0)
                break
            except ConnectionError:
                time.sleep(0.1)
        assert got is not None, "slot leaked after RST abort"
        _check(got, _aligned_reference(L, R))


# -- checkpoint / resume ------------------------------------------------------------


@pytest.mark.parametrize("pool_kind", ["torch", "cuda"])
def test_checkpoint_resume_continues_exactly(tmp_path, pool_kind):
    factory = (lambda: _batch(8)) if pool_kind == "torch" else _cuda_pool
    n_blocks, cut = 12, 5
    L, R = _signal(n_blocks * HW, 101)
    ref = _one_shot(factory, L, R)
    path = str(tmp_path / "sessions.npz")
    srv_a = StreamServer(factory(), lockstep=True).start()
    sess = StreamSession(*srv_a.address)
    assert sess.server_in_frames == 0 and len(sess.token) == 16
    part1 = _send_and_read(sess, L, R, 0, cut, 0)
    assert srv_a.save_checkpoint(path) == 1
    sess.close()
    srv_a.close()
    srv_b = StreamServer(factory(), lockstep=True, checkpoint=path).start()
    try:
        sess2 = StreamSession(*srv_b.address, token=sess.token)
        assert sess2.server_in_frames == cut * HW and sess2.server_out_frames == len(part1)
        for b in range(cut, n_blocks):
            sess2.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
        sess2.finish()
        part2 = sess2.recv_frames(n_blocks * HW - len(part1))
        sess2.close()
    finally:
        srv_b.close()
    np.testing.assert_array_equal(np.concatenate([part1, part2]), np.column_stack(ref))


def test_checkpoint_captures_queued_blocks(tmp_path):
    n_blocks = 10
    (Lx, Rx), (Ly, Ry) = _signal(n_blocks * HW, 103), _signal(n_blocks * HW, 104)
    ref_x, ref_y = _one_shot(_batch, Lx, Rx), _one_shot(_batch, Ly, Ry)
    path = str(tmp_path / "sessions.npz")
    srv_a = StreamServer(_batch(), lockstep=True).start()
    sx, sy = StreamSession(*srv_a.address), StreamSession(*srv_a.address)
    for b in range(5):
        sx.send_block(Lx[b * HW : (b + 1) * HW], Rx[b * HW : (b + 1) * HW])
        sy.send_block(Ly[b * HW : (b + 1) * HW], Ry[b * HW : (b + 1) * HW])
    due = 5 * HW - _warmup_skip()
    px, py = sx.recv_frames(due), sy.recv_frames(due)
    for b in (5, 6):  # X alone: lockstep holds these queued
        sx.send_block(Lx[b * HW : (b + 1) * HW], Rx[b * HW : (b + 1) * HW])
    deadline = time.time() + 10
    while srv_a._slots[0].in_frames < 7 * HW and time.time() < deadline:
        time.sleep(0.01)
    assert srv_a.save_checkpoint(path) == 2
    sx.close(), sy.close()
    srv_a.close()
    srv_b = StreamServer(_batch(), lockstep=True, checkpoint=path).start()
    try:
        sx2 = StreamSession(*srv_b.address, token=sx.token)
        sy2 = StreamSession(*srv_b.address, token=sy.token)
        assert sx2.server_in_frames == 7 * HW and sy2.server_in_frames == 5 * HW
        for b in range(7, n_blocks):
            sx2.send_block(Lx[b * HW : (b + 1) * HW], Rx[b * HW : (b + 1) * HW])
        for b in range(5, n_blocks):
            sy2.send_block(Ly[b * HW : (b + 1) * HW], Ry[b * HW : (b + 1) * HW])
        sx2.finish(), sy2.finish()
        gx = np.concatenate([px, sx2.recv_frames(n_blocks * HW - len(px))])
        gy = np.concatenate([py, sy2.recv_frames(n_blocks * HW - len(py))])
        sx2.close(), sy2.close()
    finally:
        srv_b.close()
    np.testing.assert_array_equal(gx, np.column_stack(ref_x))
    np.testing.assert_array_equal(gy, np.column_stack(ref_y))


def test_resume_token_rejection_and_identity_guard(tmp_path):
    path = str(tmp_path / "ck.npz")
    with StreamServer(_batch(), lockstep=True) as srv:
        with pytest.raises(ConnectionError, match="unknown or expired"):
            StreamSession(*srv.address, token=b"\x01" * 16)
        L, R = _signal(4 * HW, 105)
        _check(stream_client(*srv.address, L, R), _aligned_reference(L, R))
        srv.save_checkpoint(path)
    # A checkpoint restores only into the same pool: slots, and engine.
    with pytest.raises(ValueError, match="does not match"):
        StreamServer(_batch(8), lockstep=True, checkpoint=path)
    with pytest.raises(ValueError, match=r"mismatched: \['engine'"):
        StreamServer(CudaStreamPool(_cfg(), HW, 4, device="cpu"), lockstep=True, checkpoint=path)


def test_resume_ttl_reclaims_parked_slots(tmp_path):
    path = str(tmp_path / "ck.npz")
    srv_a = StreamServer(_batch(1), lockstep=True).start()
    sess = StreamSession(*srv_a.address)
    L, R = _signal(2 * HW, 110)
    _send_and_read(sess, L, R, 0, 2, 0)
    assert srv_a.save_checkpoint(path) == 1
    sess.close()
    srv_a.close()
    srv_b = StreamServer(_batch(1), lockstep=True, checkpoint=path).start()
    try:
        with pytest.raises(ConnectionError, match="full"):  # the parked ghost holds the slot
            StreamSession(*srv_b.address)
    finally:
        srv_b.close()
    srv_c = StreamServer(_batch(1), lockstep=True, checkpoint=path, resume_ttl=0.05).start()
    try:
        time.sleep(0.1)
        s2 = StreamSession(*srv_c.address)
        assert srv_c.stats["parked_expired"] == 1
        with pytest.raises(ConnectionError, match="unknown or expired"):
            StreamSession(*srv_c.address, token=sess.token)
        s2.close()
    finally:
        srv_c.close()


def test_run_stream_server_snapshot_path(tmp_path):
    path = str(tmp_path / "live.npz")
    kw = dict(sr=SR, n_streams=4, hw_block_size=HW, band_edges=EDGES, lockstep=True, engine="torch",
              verbose=False, snapshot_path=path, device="cpu")
    srv = run_stream_server(0, **kw)
    L, R = _signal(6 * HW, 107)
    try:
        assert srv.snapshot_path == path
        sess = StreamSession(*srv.address)
        part1 = _send_and_read(sess, L, R, 0, 4, 0)
        assert len(part1) > 0
        srv.save_checkpoint(path)
        sess.close()
    finally:
        srv.close()
    srv2 = run_stream_server(0, **kw)  # restores from the same path
    try:
        sess2 = StreamSession(*srv2.address, token=sess.token)
        resume_blk = sess2.server_in_frames // HW
        assert resume_blk == 4
        for b in range(resume_blk, 6):
            sess2.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
        sess2.finish()
        part2 = sess2.recv_frames(6 * HW - len(part1))
        sess2.close()
    finally:
        srv2.close()
    got = np.concatenate([part1, part2])
    _check(tuple(got[:, i] for i in range(got.shape[1])), _aligned_reference(L, R))


def test_periodic_checkpoint_and_output_dedupe(tmp_path):
    import os

    n_blocks = 10
    L, R = _signal(n_blocks * HW, 109)
    ref = _one_shot(_batch, L, R)
    path = str(tmp_path / "mid.npz")
    srv_a = StreamServer(_batch(), lockstep=True, snapshot_every=0.2).start()
    srv_a.snapshot_path = path
    try:
        sess = StreamSession(*srv_a.address)
        got_a = _send_and_read(sess, L, R, 0, 5, 0)
        srv_a.save_checkpoint(path)
        got_a = np.concatenate([got_a, _send_and_read(sess, L, R, 5, 2, len(got_a))])  # past the checkpoint
        m0 = os.stat(path).st_mtime_ns
        deadline = time.time() + 10
        while os.stat(path).st_mtime_ns == m0 and time.time() < deadline:
            time.sleep(0.05)
        periodic_ran = os.stat(path).st_mtime_ns != m0
        sess.close()
    finally:
        srv_a.close()
    assert periodic_ran
    srv_b = StreamServer(_batch(), lockstep=True, checkpoint=path).start()
    try:
        sess2 = StreamSession(*srv_b.address, token=sess.token)
        resume_blk = sess2.server_in_frames // HW
        assert 5 <= resume_blk <= 7
        dup = len(got_a) - sess2.server_out_frames  # frames to discard
        assert dup >= 0
        for b in range(resume_blk, n_blocks):
            sess2.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
        sess2.finish()
        regen = sess2.recv_frames(dup + n_blocks * HW - len(got_a))
        got = np.concatenate([got_a, regen[dup:]])
        sess2.close()
    finally:
        srv_b.close()
    np.testing.assert_array_equal(got, np.column_stack(ref))


# -- hops and pipeline -----------------------------------------------------------


def test_hops_server_round_trip_with_drain_padding():
    with StreamServer(_cuda_pool(), lockstep=True, hops=2) as srv:
        assert srv.metrics_snapshot()["config"]["hops"] == 2
        L, R = _signal(9 * HW + 50, 70)  # an odd block count: the drain pads the last cycle
        _check(stream_client(*srv.address, L, R), _aligned_reference(L, R))
        assert srv.stats["blocks"] % 2 == 0


def test_hops_concurrent_clients_lockstep():
    sigs = [_signal(blocks * HW, seed) for seed, blocks in ((71, 6), (72, 11))]
    with StreamServer(_cuda_pool(), lockstep=True, hops=2) as srv:
        results = _in_threads(lambda i: stream_client(*srv.address, *sigs[i]), len(sigs))
    for got, (L, R) in zip(results, sigs):
        assert got is not None
        _check(got, _aligned_reference(L, R))


def test_hops_construction_guards():
    with pytest.raises(ValueError, match="multi-hop"):
        StreamServer(_batch(), lockstep=True, hops=2)
    with pytest.raises(ValueError, match="max_buffered_blocks"):
        StreamServer(_cuda_pool(), lockstep=True, hops=64, max_buffered_blocks=32)
    with pytest.raises(ValueError, match=">= 1"):
        StreamServer(_cuda_pool(), lockstep=True, hops=0)


def test_pipeline_server_round_trip():
    L, R = _signal(9 * HW + 50, 75)
    ref = _one_shot(_batch, L, R)
    with StreamServer(_batch(), lockstep=True, pipeline=2) as srv:
        assert srv.metrics_snapshot()["config"]["pipeline"] == 2
        got = stream_client(*srv.address, L, R)
    np.testing.assert_array_equal(np.column_stack(got), np.column_stack(ref))


def test_pipeline_concurrent_clients_with_drain():
    sigs = [_signal(n, seed) for seed, n in ((76, 5 * HW), (77, 11 * HW + 30))]
    with StreamServer(_batch(), lockstep=True, pipeline=2) as srv:
        results = _in_threads(lambda i: stream_client(*srv.address, *sigs[i]), len(sigs))
    for got, (L, R) in zip(results, sigs):
        assert got is not None
        _check(got, _aligned_reference(L, R))


def test_pipeline_with_hops():
    with StreamServer(_cuda_pool(), lockstep=True, hops=2, pipeline=2) as srv:
        L, R = _signal(7 * HW + 40, 78)
        _check(stream_client(*srv.address, L, R), _aligned_reference(L, R))


def test_pipeline_construction_guard():
    for bad in (0, 3, -1):
        with pytest.raises(ValueError, match="pipeline"):
            StreamServer(_batch(), lockstep=True, pipeline=bad)


def test_pipeline_checkpoint_flushes_in_flight(tmp_path):
    n_blocks = 10
    L, R = _signal(n_blocks * HW, 79)
    ref = _one_shot(_batch, L, R)
    path = str(tmp_path / "pipe.npz")
    srv_a = StreamServer(_batch(), lockstep=True, pipeline=2).start()
    try:
        sess = StreamSession(*srv_a.address)
        for b in range(6):  # a burst: no reads between sends
            sess.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
        time.sleep(0.1)
        assert srv_a.save_checkpoint(path) == 1
        saved = np.load(path, allow_pickle=False)
        s0 = json.loads(saved["__meta__"].tobytes().decode("utf-8"))["sessions"][0]
        consumed = s0["in_frames"] - saved["s0.blocks"].shape[0] * HW
        assert s0["out_frames"] == max(0, consumed - _warmup_skip())  # every consumed block's output counted
        got_a = sess.recv_frames(max(0, 6 * HW - _warmup_skip()))
        sess.close()
    finally:
        srv_a.close()
    srv_b = StreamServer(_batch(), lockstep=True, checkpoint=path).start()
    try:
        sess2 = StreamSession(*srv_b.address, token=sess.token)
        resume_blk = sess2.server_in_frames // HW
        dup = len(got_a) - sess2.server_out_frames
        assert dup >= 0
        for b in range(resume_blk, n_blocks):
            sess2.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
        sess2.finish()
        regen = sess2.recv_frames(dup + n_blocks * HW - len(got_a))
        got = np.concatenate([got_a, regen[dup:]])
        sess2.close()
    finally:
        srv_b.close()
    np.testing.assert_array_equal(got, np.column_stack(ref))


@pytest.mark.parametrize("hops,pipeline", [(2, 1), (1, 2), (2, 2)])
def test_checkpoint_resume_under_hops_and_pipeline(tmp_path, hops, pipeline):
    # The cut falls mid-cycle at hops 2: one block queued, not dispatched.
    srv_kw = dict(lockstep=True, hops=hops, pipeline=pipeline)
    n_blocks, cut = 12, 5
    L, R = _signal(n_blocks * HW, 300 + hops * 10 + pipeline)
    ref = _one_shot(_cuda_pool, L, R, hops=hops, pipeline=pipeline)
    dispatched = (cut // hops) * hops
    skip = _warmup_skip()
    path = str(tmp_path / "hp.npz")
    srv_a = StreamServer(_cuda_pool(), **srv_kw).start()
    sess = StreamSession(*srv_a.address)
    for b in range(cut):
        sess.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
    due = max(0, dispatched * HW - skip)
    part1 = sess.recv_frames(due) if due else np.zeros((0, sess.out_channels), "<f4")
    deadline = time.time() + 10.0
    while srv_a._slots[0].in_frames < cut * HW and time.time() < deadline:
        time.sleep(0.01)
    assert srv_a.save_checkpoint(path) == 1
    sess.close()
    srv_a.close()
    saved = np.load(path, allow_pickle=False)
    s0 = json.loads(saved["__meta__"].tobytes().decode("utf-8"))["sessions"][0]
    assert saved[f"s{s0['slot']}.blocks"].shape[0] == cut - dispatched
    assert s0["in_frames"] == cut * HW
    assert s0["out_frames"] == max(0, dispatched * HW - skip) == len(part1)
    assert s0["skip"] == max(0, skip - dispatched * HW)
    srv_b = StreamServer(_cuda_pool(), checkpoint=path, **srv_kw).start()
    try:
        sess2 = StreamSession(*srv_b.address, token=sess.token)
        assert sess2.server_in_frames == cut * HW and sess2.server_out_frames == len(part1)
        for b in range(cut, n_blocks):
            sess2.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
        sess2.finish()
        part2 = sess2.recv_frames(n_blocks * HW - len(part1))
        sess2.close()
    finally:
        srv_b.close()
    np.testing.assert_array_equal(np.concatenate([part1, part2]), np.column_stack(ref))


# -- failure paths --------------------------------------------------------------


def test_close_releases_port_with_live_clients():
    srv_a = StreamServer(_batch(), lockstep=True).start()
    host, port = srv_a.address
    s1, s2 = StreamSession(host, port), StreamSession(host, port)
    z = np.zeros(HW, np.float32)
    s1.send_block(z, z)
    time.sleep(0.1)
    srv_a.close()
    for s in (s1, s2):  # a clean shutdown (EOF), not a hang
        s.sock.settimeout(10.0)
        try:
            s.sock.recv(1 << 16)
        except TimeoutError:  # pragma: no cover
            raise AssertionError("client hung on server shutdown")
        except OSError:
            pass
        s.close()
    deadline = time.monotonic() + 10.0
    while True:
        try:
            srv_b = StreamServer(_batch(), lockstep=True, host=host, port=port).start()
            break
        except OSError:  # pragma: no cover
            assert time.monotonic() < deadline, f"could not rebind {host}:{port}"
            time.sleep(0.1)
    try:
        L, R = _signal(4 * HW, 95)
        _check(stream_client(*srv_b.address, L, R), _aligned_reference(L, R))
    finally:
        srv_b.close()


def test_dispatcher_death_fails_sessions_fast():
    with StreamServer(_batch(), lockstep=True) as srv:
        def boom(*a, **k):
            raise RuntimeError("injected pool failure")

        srv._push = boom
        L, R = _signal(6 * HW, 80)
        errs = []

        def go():
            try:
                stream_client(*srv.address, L, R)
            except Exception as exc:
                errs.append(exc)

        t = threading.Thread(target=go)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive(), "client hung on a dead dispatcher"
        assert errs, "the client must see the failed session"
        deadline = time.monotonic() + 30
        while (not srv._stop.is_set() or srv._sock.fileno() != -1) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.stats["dispatcher_failures"] == 1
        assert srv._stop.is_set() and srv._sock.fileno() == -1
        with pytest.raises(Exception):  # the listener is closed: no new victims
            stream_client(*srv.address, L, R)


def test_stopping_server_refuses_admission_mid_handshake():
    srv = StreamServer(_batch(), lockstep=True).start()
    try:
        srv._stop.set()  # stopping, listener still open
        with pytest.raises(ConnectionError, match="pool is full"):
            StreamSession(*srv.address)
        deadline = time.monotonic() + 10
        while srv.stats["rejected"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.stats["rejected"] >= 1
        with srv._lock:
            assert all(s.state == 0 for s in srv._slots), "no slot leaked"
    finally:
        srv.close()


def test_run_stream_server_pool_options():
    # The engine and device the caller asks for; the spectral dataflow
    # (on the CUDA pool, and ignored by the batch pool as in the JAX
    # package) and a mesh each serve a client; the TPU grid-step group is
    # accepted and ignored; an unknown OLA mode and a misspelled keyword
    # raise at the call.
    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    for kw, kind in ((dict(engine="cuda", group=8), CudaStreamPool), (dict(ola="spectral", engine="cuda"), CudaStreamPool),
                     (dict(ola="spectral"), BatchStreamingUpmixer),
                     (dict(ola="spectral", engine="torch"), BatchStreamingUpmixer),
                     (dict(mesh=mesh), BatchStreamingUpmixer)):
        srv = run_stream_server(0, sr=SR, n_streams=8, hw_block_size=HW, band_edges=EDGES, lockstep=True,
                                verbose=False, device="cpu", **kw)
        try:
            assert type(srv.pool) is kind and srv.pool.device.type == "cpu", kw
            assert getattr(srv.pool, "ola", "time") == kw.get("ola", "time") or kind is BatchStreamingUpmixer
            L, R = _signal(6 * HW, 91)
            _check(stream_client(*srv.address, L, R), _aligned_reference(L, R))
        finally:
            srv.close()
    with pytest.raises(ValueError, match="unknown ola"):
        run_stream_server(0, sr=SR, hw_block_size=HW, band_edges=EDGES, verbose=False, device="cpu", ola="freq")
    with pytest.raises(TypeError):
        run_stream_server(0, sr=SR, lockstp=True)


# -- metrics --------------------------------------------------------------------


def test_metrics_over_the_stream_port_and_http():
    import urllib.request

    with StreamServer(_batch(), lockstep=True, metrics_http_port=0) as srv:
        stream_client(*srv.address, *_signal(5 * HW, 92))
        snap = fetch_metrics(*srv.address)
        assert snap["counters"]["accepted"] == 1 and snap["counters"]["frames"] == 5 * HW
        assert snap["config"]["engine"] == "BatchStreamingUpmixer" and snap["cycle_seconds"]["count"] > 0
        text = fetch_metrics(*srv.address, fmt="prometheus")
        samples = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
        assert samples["upmix_accepted_total"] == 1.0
        assert samples['upmix_cycle_seconds_bucket{le="+Inf"}'] == snap["cycle_seconds"]["count"]
        host, port = srv.metrics_http_address
        body = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10).read().decode()
        assert "upmix_frames_total" in body
        as_json = json.loads(urllib.request.urlopen(f"http://{host}:{port}/metrics.json", timeout=10).read())
        assert as_json["counters"]["frames"] == 5 * HW


# -- the CLI ----------------------------------------------------------------------


def test_cli_serve_stream_round_trip(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "upmix_tpu_torch.cli", "-", "--serve-stream", "0", "--sr", str(SR), "--hw-block",
         str(HW), "--band-edges", ",".join(str(e) for e in EDGES), "--streams", "2", "--lockstep", "--device",
         "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=cpu_child_env(),
    )
    try:
        addr = None
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"stream server on ([\d.]+):(\d+)", line)
            if m:
                addr = (m.group(1), int(m.group(2)))
                break
        assert addr is not None, "server never announced its address"
        L, R = _signal(6 * HW, 70)
        _check(stream_client(*addr, L, R, timeout=120.0), _aligned_reference(L, R))
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_cli_connect_client_mode(tmp_path):
    from upmix_tpu_torch.cli import main
    from upmix_tpu_torch.io import read_wav, write_wav

    with StreamServer(_batch(), lockstep=True) as srv:
        host, port = srv.address
        L, R = _signal(5 * HW + 77, 111)
        in_path = str(tmp_path / "song.wav")
        write_wav(in_path, np.column_stack([L, R]), int(SR))
        assert main([in_path, "--connect", f"{host}:{port}", "--out-dir", str(tmp_path / "out")]) == 0
        got, sr2 = read_wav(str(tmp_path / "out" / "song_net_stereo_sum.wav"))
        assert sr2 == int(SR) and got.shape == (len(L), 2)
        _check((got[:, 0], got[:, 1]), _aligned_reference(L, R))
        bad = str(tmp_path / "bad.wav")
        write_wav(bad, np.column_stack([L, R]), int(SR * 2))
        with pytest.raises(SystemExit, match="Hz"):  # a sample-rate mismatch sends nothing
            main([bad, "--connect", f"{host}:{port}", "--out-dir", str(tmp_path / "out")])
        printed = []
        for argv in (["-", "--fetch-metrics", f"{host}:{port}"], ["-", "--fetch-metrics", f"{host}:{port}",
                                                                  "--prometheus"]):
            import contextlib
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(argv) == 0
            printed.append(buf.getvalue())
        assert json.loads(printed[0])["counters"]["accepted"] >= 1
        assert "# TYPE upmix_accepted_total counter" in printed[1]
    with pytest.raises(SystemExit, match="HOST:PORT"):
        main([in_path, "--connect", "nonsense"])
    with pytest.raises(SystemExit, match="input WAV"):
        main(["-", "--connect", "127.0.0.1:1"])


def test_cli_server_guards():
    from upmix_tpu_torch.cli import main

    for argv, match in (
        (["-", "--serve-stream", "0"], "positive --sr"),
        (["x.wav", "--serve-stream", "0", "--sr", "8000"], "no input files"),
        (["-", "--serve-stream", "0", "--sr", "8000", "--pipe"], "exclusive"),
        (["-", "--serve-stream", "0", "--sr", "8000", "--streams", "0"], "--streams"),
        (["-", "--serve-stream", "0", "--sr", "8000", "--serve-hops", "0"], "--serve-hops"),
        (["-", "--serve-stream", "0", "--sr", "8000", "--snapshot-every", "1"], "--snapshot-path"),
        (["-", "--metrics-http", "0"], "requires --serve-stream"),
        (["-", "--prometheus"], "requires --fetch-metrics"),
        (["-", "--fetch-metrics", "nohost"], "HOST:PORT"),
        (["x.wav", "--connect", "127.0.0.1:1", "--serve"], "exclusive"),
        (["-", "--serve-stream", "0", "--sr", "8000", "--mesh", "seq=2"], "offline pipeline only"),
        (["-", "--pool-mesh", "data=2"], "requires --serve-stream"),
        (["-", "--serve-stream", "0", "--sr", "8000", "--pool-mesh", "seq=2", "--device", "cpu"], "data"),
        (["-", "--serve-stream", "0", "--sr", "8000", "--streams", "3", "--pool-mesh", "data=2", "--pool-engine",
          "cuda", "--device", "cpu"], "divide evenly"),
        (["-", "--serve-stream", "0", "--sr", "8000", "--serve-hops", "2", "--pool-engine", "torch", "--device",
          "cpu"], "multi-hop"),
    ):
        with pytest.raises(SystemExit, match=match):
            main(argv)


# -- parity with the JAX package ------------------------------------------------------


def _jcfg():
    return JaxUpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)


def test_servers_agree_with_the_jax_server_and_the_oracle():
    # The same seeded blocks through the JAX server (its XLA pool on the
    # CPU) and the port's server (the pool step's plain version): the
    # frames agree at the 80 dB the two pools are held to in
    # test_torch_pool.py, and both hold >= 60 dB against the float64
    # streaming oracle, warmup-aligned.
    sigs = [_signal(n, seed) for seed, n in ((120, 12 * HW + 33), (121, 9 * HW))]
    with JaxStreamServer(JaxBatch(_jcfg(), HW, n_streams=4), lockstep=True) as jsrv:
        want = _in_threads(lambda i: stream_client(*jsrv.address, *sigs[i]), len(sigs))
    with StreamServer(_batch(), lockstep=True) as srv:
        got = _in_threads(lambda i: stream_client(*srv.address, *sigs[i]), len(sigs))
    skip = _warmup_skip()
    for (L, R), w, g in zip(sigs, want, got):
        pad = (-len(L)) % HW + skip  # whole blocks, then the drain
        xl, xr = (np.concatenate([a, np.zeros(pad, np.float32)]) for a in (L, R))
        oracle = [o[skip : skip + len(L)] for o in oracle_stream_multiband(xl, xr, _jcfg(), HW)]
        for ch in range(2):
            assert snr_db(np.asarray(w[ch]), g[ch]) > 80.0
            assert snr_db(oracle[ch], g[ch]) > 60.0
            assert snr_db(oracle[ch], np.asarray(w[ch])) > 60.0


def test_jax_session_round_trip_on_the_port_server():
    # The wire protocol byte for byte: the JAX package's v2 client session
    # (hello, reply with token and sample rate, blocks, half-close, drain)
    # on the port's server.
    L, R = _signal(7 * HW, 122)
    with StreamServer(_batch(), lockstep=True) as srv:
        with JaxStreamSession(*srv.address, mix="lcr") as sess:
            assert (sess.hw, sess.out_channels, sess.server_sr) == (HW, 3, SR) and len(sess.token) == 16
            for b in range(7):
                sess.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
            sess.finish()
            got = sess.recv_frames(7 * HW)
    _check(tuple(got[:, ch] for ch in range(3)), _aligned_reference(L, R, mix="lcr"))


def test_prometheus_text_equals_the_jax_rendering():
    with StreamServer(_batch(), lockstep=True) as srv:
        stream_client(*srv.address, *_signal(4 * HW, 123))
        snap = srv.metrics_snapshot()
    snap["config"]["note"] = 'quote " backslash \\ newline \n'  # the escapes
    assert prometheus_text(snap) == jax_prometheus_text(snap)
    assert prometheus_text(snap, prefix="x") == jax_prometheus_text(snap, prefix="x")
