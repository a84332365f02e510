"""The serving pool on a mesh in the port (on the CPU: the pool step's
plain versions), against the unsharded pool and the JAX package's
sharded pools.

Mirrors tests/test_streaming.py's mesh cases (make_stream_pool's choice
with a mesh, the sharded Pallas pool equal to the unsharded one, in both
OLA dataflows) and tests/test_serve_stream.py's (a stream server on a
mesh, checkpoints across mesh topologies).  Meshes are CPU devices:
["cpu"] * d repeats one device, whose shards run as rows of one step;
"cpu" and "cpu:0" are two distinct devices to the pool, so their shards
keep their own state and step apart, the bookkeeping of a mesh of
several cards.  Streams are independent, so a sharded pool must give the
unsharded pool's outputs and snapshots bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from helpers import make_stereo, snr_db
from test_torch_serve_stream import _aligned_reference, _check, _send_and_read
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.streaming import PallasStreamPool
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.streaming import BatchStreamingUpmixer, CudaStreamPool, make_stream_pool
from upmix_tpu_torch.parallel import make_mesh
from upmix_tpu_torch.serve_stream import StreamServer, StreamSession, run_stream_server, stream_client

HW = 256
SR = 8000.0
EDGES = [0.0, 400.0, 1600.0]

MESHES = {
    "repeated": (2, ["cpu"] * 2),
    "distinct": (2, ["cpu", "cpu:0"]),
    "interleaved": (4, ["cpu", "cpu:0", "cpu", "cpu:0"]),  # each device holds two shards apart
}


def _cfg():
    return UpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW)


def _mesh(kind):
    d, devices = MESHES[kind]
    return make_mesh({"data": d}, devices=devices)


def _blocks(n_blocks, S, seed):
    return np.random.default_rng(seed).standard_normal((n_blocks, S, 2, HW)).astype(np.float32) * 0.3


def _stack(outs):
    return np.stack([np.asarray(o) for o in outs])


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_make_stream_pool_on_a_mesh():
    # tests/test_streaming.py:590-617: "auto" with a mesh is the batch
    # pool, "cuda" the sharded CUDA pool with a per-shard plan; the
    # streams must divide evenly; the CUDA pool needs a 'data' axis.
    cfg = _cfg()
    mesh = _mesh("repeated")
    assert type(make_stream_pool(cfg, HW, 16, device="cpu", mesh=mesh)) is BatchStreamingUpmixer
    sharded = make_stream_pool(cfg, HW, 16, engine="cuda", device="cpu", mesh=mesh)
    assert type(sharded) is CudaStreamPool and sharded.plan.n_streams == 8
    assert make_stream_pool(cfg, HW, 16, engine="cuda", device="cpu", mesh=mesh, ola="spectral").ola == "spectral"
    with pytest.raises(ValueError, match="divide evenly"):
        make_stream_pool(cfg, HW, 9, engine="cuda", device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        BatchStreamingUpmixer(cfg, HW, 9, device="cpu", mesh=mesh)
    seq_only = make_mesh({"seq": 2}, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="'data' mesh axis"):
        CudaStreamPool(cfg, HW, 8, device="cpu", mesh=seq_only)
    assert BatchStreamingUpmixer(cfg, HW, 8, device="cpu", mesh=seq_only).plan.n_streams == 8
    # Shards on one device are one step; on distinct devices, one a device.
    assert len(CudaStreamPool(cfg, HW, 8, device="cpu", mesh=mesh)._parts) == 1
    parts = CudaStreamPool(cfg, HW, 8, device="cpu", mesh=_mesh("interleaved"))._parts
    assert [p.rows.tolist() for p in parts] == [[0, 1, 4, 5], [2, 3, 6, 7]]


@pytest.mark.parametrize("ola", ["time", "spectral"])
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_mesh_pool_matches_unsharded(kind, ola):
    # tests/test_streaming.py::test_pallas_pool_sharded_matches_unsharded and
    # ::test_pallas_pool_spectral_sharded: bit for bit with the unsharded
    # pool, through slot churn, single-session moves, hops and snapshots;
    # and at 80 dB against the JAX sharded Pallas pool.
    cfg = _cfg()
    S, n_blocks = 16, 10
    blocks = _blocks(n_blocks, S, 11)
    plain = CudaStreamPool(cfg, HW, S, device="cpu", ola=ola)
    shard = CudaStreamPool(cfg, HW, S, device="cpu", ola=ola, mesh=_mesh(kind))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    jpool = PallasStreamPool(JaxUpmixConfig.streaming(EDGES, sr=SR, hw_block_size=HW), HW, n_streams=S, group=8,
                             mesh=jmesh, ola=ola)
    for t in range(n_blocks):
        if t == 6:
            for p in (plain, shard, jpool):
                p.reset_streams([0, 5, 15])
        a = _stack(plain.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        b = _stack(shard.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        np.testing.assert_array_equal(a, b)
        want = _stack(jpool.push_blocks(blocks[t, :, 0], blocks[t, :, 1]))
        if np.abs(want).max() > 0:
            assert snr_db(want, b) > 80.0
        else:
            assert np.abs(b).max() == 0.0
    _assert_tree_equal(plain.snapshot(), shard.snapshot())
    rows = plain.extract_streams([3, 12])
    _assert_tree_equal(rows, shard.extract_streams([3, 12]))
    for p in (plain, shard):
        p.load_streams([12, 2], rows)
    x = np.concatenate([blocks[0], blocks[1]], axis=-1)
    np.testing.assert_array_equal(_stack(plain.push_blocks_multi(x[:, 0], x[:, 1])),
                                  _stack(shard.push_blocks_multi(x[:, 0], x[:, 1])))
    # A snapshot of either restores into the other.
    shard.restore(plain.snapshot())
    plain.restore(shard.snapshot())
    np.testing.assert_array_equal(_stack(plain.push_blocks(blocks[2, :, 0], blocks[2, :, 1])),
                                  _stack(shard.push_blocks(blocks[2, :, 0], blocks[2, :, 1])))
    # The sustained runner of each gives the same C outputs.
    slabs = torch.as_tensor(np.ascontiguousarray(_blocks(4, S, 12).transpose(0, 2, 1, 3)))
    outs = []
    for p in (plain, shard):
        run, fresh = p.make_sustained_runner(4)
        outs.append(run(fresh(), slabs)[1].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("push", ["push_blocks", "push_blocks_multi"])
@pytest.mark.parametrize("ola", ["time", "spectral"])
@pytest.mark.parametrize("devices,path", [(["cpu", "cpu", "cpu:0", "cpu:0"], "slice"),
                                          (["cpu", "cpu:0", "cpu", "cpu:0"], "index")])
def test_mesh_pool_exchange_paths(devices, path, ola, push):
    # A part whose rows are one range (two shards side by side on a
    # device) moves as a slice, one copy each way; a part of shards apart
    # moves by an index.  Either way the sharded pool is the unsharded
    # pool bit for bit, through a reset of rows on both parts.
    cfg = _cfg()
    S, hops, n_blocks = 16, 1 if push == "push_blocks" else 2, 6
    shard = CudaStreamPool(cfg, HW, S, device="cpu", ola=ola, mesh=make_mesh({"data": 4}, devices=devices))
    assert ["index" if rows is None else "slice" for rows in shard._slices] == [path] * 2
    plain = CudaStreamPool(cfg, HW, S, device="cpu", ola=ola)
    blocks = (_blocks(n_blocks * hops, S, 21).reshape(n_blocks, hops, S, 2, HW).transpose(0, 2, 3, 1, 4)
              .reshape(n_blocks, S, 2, hops * HW))
    for t, b in enumerate(blocks):
        if t == 3:
            for p in (plain, shard):
                p.reset_streams([1, 6, 13])  # rows of both parts, on either mesh
        want, got = (_stack(getattr(p, push)(b[:, 0], b[:, 1])) for p in (plain, shard))
        np.testing.assert_array_equal(want, got)
    _assert_tree_equal(plain.snapshot(), shard.snapshot())


@pytest.mark.parametrize("kind", ["repeated", "distinct"])
def test_batch_pool_on_a_mesh_matches_unsharded(kind):
    cfg = _cfg()
    S = 8
    blocks = _blocks(8, S, 13)
    plain = BatchStreamingUpmixer(cfg, HW, S, device="cpu")
    shard = BatchStreamingUpmixer(cfg, HW, S, device="cpu", mesh=_mesh(kind))
    assert shard.plan.n_streams == S // 2
    for t, b in enumerate(blocks):
        if t == 5:
            plain.reset_streams([1])
            shard.reset_streams([1])
        np.testing.assert_array_equal(_stack(plain.push_blocks(b[:, 0], b[:, 1])),
                                      _stack(shard.push_blocks(b[:, 0], b[:, 1])))
    _assert_tree_equal(plain.snapshot(), shard.snapshot())


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_mesh_sharded_pool_server(engine):
    # tests/test_serve_stream.py::test_mesh_sharded_pool_server: a session
    # on a server whose pool is split over a mesh gets the single-stream
    # engine's output.
    srv = run_stream_server(0, sr=SR, n_streams=4, hw_block_size=HW, band_edges=EDGES, lockstep=True,
                            verbose=False, device="cpu", mesh=_mesh("distinct"), engine=engine)
    try:
        assert srv.pool.mesh is not None and len(srv.pool._parts) == 2
        L, R = make_stereo(8 * HW, SR, seed=77)
        L, R = L.astype(np.float32), R.astype(np.float32)
        _check(stream_client(*srv.address, L, R), _aligned_reference(L, R))
    finally:
        srv.close()


@pytest.mark.parametrize("ola", ["time", "spectral"])
def test_checkpoint_restores_across_mesh_topologies(tmp_path, ola):
    # tests/test_serve_stream.py::test_checkpoint_restores_across_mesh_topologies:
    # a checkpoint of an unsharded pool's server resumes on a sharded one and
    # back, the exact continuation of an uninterrupted run.
    def plain_factory():
        return CudaStreamPool(_cfg(), HW, 4, device="cpu", ola=ola)

    def mesh_factory():
        return CudaStreamPool(_cfg(), HW, 4, device="cpu", ola=ola, mesh=_mesh("distinct"))

    n_blocks, cut = 12, 5
    path = str(tmp_path / "sessions.npz")
    for src_factory, dst_factory in ((plain_factory, mesh_factory), (mesh_factory, plain_factory)):
        L, R = make_stereo(n_blocks * HW, SR, seed=105)
        L, R = L.astype(np.float32), R.astype(np.float32)
        with StreamServer(plain_factory(), lockstep=True) as srv:
            ref = stream_client(*srv.address, L, R)
        srv_a = StreamServer(src_factory(), lockstep=True).start()
        sess = StreamSession(*srv_a.address)
        part1 = _send_and_read(sess, L, R, 0, cut, 0)
        assert srv_a.save_checkpoint(path) == 1
        sess.close()
        srv_a.close()
        srv_b = StreamServer(dst_factory(), lockstep=True, checkpoint=path).start()
        try:
            sess2 = StreamSession(*srv_b.address, token=sess.token)
            assert sess2.server_in_frames == cut * HW
            for b in range(cut, n_blocks):
                sess2.send_block(L[b * HW : (b + 1) * HW], R[b * HW : (b + 1) * HW])
            sess2.finish()
            part2 = sess2.recv_frames(n_blocks * HW - len(part1))
            sess2.close()
        finally:
            srv_b.close()
        np.testing.assert_array_equal(np.concatenate([part1, part2]), np.column_stack(ref))


def test_cli_pool_mesh_serves(tmp_path):
    # --pool-mesh data=2 on the CPU: the server's pool is split over the
    # mesh (the pool --pool-engine names) and serves a client.
    import re
    import subprocess
    import sys
    import time

    from helpers import cpu_child_env

    cmd = [sys.executable, "-m", "upmix_tpu_torch.cli", "-", "--serve-stream", "0", "--sr", str(SR),
           "--hw-block", str(HW), "--band-edges", ",".join(str(e) for e in EDGES), "--streams", "4",
           "--pool-mesh", "data=2", "--pool-engine", "cuda", "--pool-ola", "spectral", "--lockstep",
           "--device", "cpu"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=cpu_child_env())
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "stream server on" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
        assert "stream server on" in line and "CudaStreamPool" in line, line
        host, port = re.search(r"stream server on ([\d.]+):(\d+)", line).groups()
        L, R = make_stereo(6 * HW, SR, seed=93)
        L, R = L.astype(np.float32), R.astype(np.float32)
        _check(stream_client(host, int(port), L, R, timeout=120.0), _aligned_reference(L, R))
    finally:
        proc.terminate()
        proc.wait(timeout=30)
