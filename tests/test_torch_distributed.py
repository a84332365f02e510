"""The port's meshes that span processes, mirroring tests/test_distributed.py:
real OS processes bring up `torch.distributed` (a coordinator on
localhost, gloo over TCP, CPU mesh entries) and run the port's pod check
(`upmix_tpu_torch.parallel.pod_check`): the cross-process all_reduce, the
global-mesh sequence-sharded pipeline with its halos sent and received
across the process boundary, and `local_file_shard` offline jobs, each
gated > 60 dB against the float64 path, and once more under torchrun's
environment.  Then the shards that two
processes return on a spanning {"seq": 8} and {"seq": 4, "data": 2} mesh,
assembled here, against the NumPy oracle (> 60 dB), the JAX
ShardedUpmixer with its Pallas kernels in interpret mode (> 80 dB, the bar
of tests/test_torch_sharded.py: bf16x3 products there, float32 FFTs here)
and the port's one-process ShardedUpmixer (bit for bit); the module's
small functions against the JAX package's; and a lost peer, which must
fail its partner within the timeout.
"""

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import cpu_child_env, make_stereo, snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.oracle import oracle_multiband
from upmix_tpu.parallel import ShardedUpmixer as JaxShardedUpmixer
from upmix_tpu.parallel import local_file_shard as jax_local_file_shard
from upmix_tpu.parallel import make_mesh as jax_make_mesh
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.parallel import (
    ShardedUpmixer,
    global_devices,
    is_initialized,
    local_file_shard,
    make_mesh,
    process_count,
    process_index,
    sequence_plan,
)

ROOT = Path(__file__).resolve().parent.parent
EDGES, SR, MAX_BLOCK = [0.0, 400.0, 1600.0], 8000.0, 512
TIMEOUT = 120  # seconds a child pair may take (each takes a few)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(argvs, timeout=TIMEOUT):
    """Start one child per argv at once; returns [(rc, stdout, stderr)]."""
    procs = [subprocess.Popen(argv, cwd=ROOT, env=cpu_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def test_pod_check_two_processes(tmp_path):
    # 2 processes x 4 local CPU entries -> one 8-entry GLOBAL mesh.
    from upmix_tpu_torch.io.wav import write_wav

    n_proc, n_local = 2, 4
    files = []
    for i in range(3):  # 3 files over 2 processes: uneven round-robin
        L, R = make_stereo(4000, SR, seed=20 + i)
        path = tmp_path / f"in{i}.wav"
        write_wav(path, np.column_stack([L, R]).astype(np.float32), 8000)
        files.append(str(path))
    port = _free_port()
    reports = [tmp_path / f"pod{pid}.json" for pid in range(n_proc)]
    runs = _run_pair([
        [sys.executable, "-m", "upmix_tpu_torch.parallel.pod_check",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n_proc), "--process-id", str(pid),
         "--device", "cpu", "--local-devices", str(n_local), "--backend", "gloo",
         "--files", *files, "--report", str(reports[pid])]
        for pid in range(n_proc)
    ])
    for rc, out, err in runs:
        assert rc == 0, f"rc={rc}\n{out}\n{err}"
        assert "POD_CHECK_OK" in out, out + err

    paths_seen = []
    for pid, path in enumerate(reports):
        rep = json.loads(path.read_text())
        assert rep["ok"] is True and rep["backend"] == "gloo"
        topo = rep["topology"]
        assert topo == {"process_index": pid, "process_count": n_proc, "local_devices": n_local,
                        "global_devices": n_proc * n_local}
        # The cross-process all_reduce gave the true global sum.
        assert abs(rep["collective"]["got"] - rep["collective"]["want"]) < 1e-3
        # Each process gated exactly its own 4 output shards of the 8-way
        # global run, all > 60 dB against the float64 path, at the
        # process's contiguous starts.
        shards = rep["seq_sharded"]["shards"]
        assert len(shards) == n_local
        for s in shards:
            assert s["snr_db"] > 60.0, rep["seq_sharded"]
        chunk = rep["seq_sharded"]["chunk"]
        assert sorted(s["start"] for s in shards) == [(pid * n_local + k) * chunk for k in range(n_local)]
        # File jobs: round-robin shares, each gated against the float64 path.
        assert [j["path"] for j in rep["file_jobs"]] == files[pid::n_proc]
        for j in rep["file_jobs"]:
            assert min(j["snr_db"]) > 60.0, j
            paths_seen.append(j["path"])
    # The two processes together covered every file exactly once.
    assert sorted(paths_seen) == sorted(files)


def test_pod_check_under_torchrun():
    # No --coordinator: init_distributed reads torchrun's environment
    # (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK).
    (rc, out, err), = _run_pair([[
        sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-port", str(_free_port()),
        "-m", "upmix_tpu_torch.parallel.pod_check", "--device", "cpu", "--local-devices", "2", "--backend", "gloo"]])
    assert rc == 0, out + err
    for pid in range(2):
        assert f"POD_CHECK_OK process {pid}/2 devices local=2 global=4 shards=2 files=0" in out, out + err


# Each process builds the pipeline on the global mesh, runs it on the whole
# input, then again with every sample outside its own shards set to NaN: a
# read of another process's part would spread NaN through the output.
# argv: port, rank, axes JSON, input .npy, output .npz.
SPANNING_CHILD = r"""
import json, sys
import numpy as np
import torch
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.parallel import build_sharded_offline_fn, init_distributed, make_mesh
port, rank, axes, x_path, out = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3]), sys.argv[4], sys.argv[5]
init_distributed(f"127.0.0.1:{port}", 2, rank, ["cpu"] * 4, backend="gloo")
x = torch.as_tensor(np.load(x_path))
cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
fn, plan = build_sharded_offline_fn(cfg, x.shape[-1], make_mesh(axes))
shards = fn(x)
poisoned = torch.full_like(x, float("nan"))
for s in shards:
    poisoned[s.index[0], :, s.index[2]] = x[s.index[0], :, s.index[2]]
again = fn(poisoned)
assert [a.index for a in again] == [s.index for s in shards]
assert all(torch.equal(a.data, s.data) for a, s in zip(again, shards))
np.savez(out, index=np.array([[s.index[0].start, s.index[0].stop, s.index[2].start, s.index[2].stop]
                              for s in shards]), data=np.stack([s.data.numpy() for s in shards]))
print("SPANNING_OK", len(shards))
"""


@pytest.mark.parametrize("axes", [{"seq": 8}, {"seq": 4, "data": 2}], ids=["seq8", "seq4_data2"])
def test_spanning_mesh_against_jax_and_one_process(tmp_path, axes):
    cfg, jcfg = UpmixConfig.make(EDGES, sr=SR, max_block_size=MAX_BLOCK), JaxUpmixConfig.make(
        EDGES, sr=SR, max_block_size=MAX_BLOCK)
    n, batch = 5000, axes.get("data", 1)
    plan = sequence_plan(cfg, n, axes["seq"])
    pairs = [make_stereo(n, SR, seed=30 + b) for b in range(batch)]
    x = np.stack([np.stack([L, R]) for L, R in pairs]).astype(np.float32)
    x_path = tmp_path / "x.npy"
    np.save(x_path, np.pad(x, ((0, 0), (0, 0), (0, plan.n_padded - n))))
    port = _free_port()
    outs = [tmp_path / f"shards{r}.npz" for r in range(2)]
    runs = _run_pair([[sys.executable, "-c", SPANNING_CHILD, str(port), str(r), json.dumps(axes), str(x_path),
                       str(outs[r])] for r in range(2)])
    for rc, out, err in runs:
        assert rc == 0 and "SPANNING_OK 4" in out, f"rc={rc}\n{out}\n{err}"

    # Assemble the eight shards; each sample of the output exactly once.
    y = np.zeros((batch, 3, plan.n_padded), np.float32)
    seen = np.zeros((batch, plan.n_padded), int)
    for r, path in enumerate(outs):
        with np.load(path) as f:
            for (r0, r1, s0, s1), part in zip(f["index"], f["data"]):
                assert s1 - s0 == plan.chunk
                y[r0:r1, :, s0:s1] = part
                seen[r0:r1, s0:s1] += 1
                # Process r holds the r-th half of the seq axis.
                assert r * plan.n_padded // 2 <= s0 < (r + 1) * plan.n_padded // 2
    assert (seen == 1).all()
    y = y[..., :n]

    one = ShardedUpmixer(cfg, make_mesh(axes, devices=["cpu"] * 8)).process_batch(x).numpy()
    np.testing.assert_array_equal(y, one)
    jax_y = np.asarray(JaxShardedUpmixer(jcfg, jax_make_mesh(axes), kernel="mm", use_pallas=True).process_batch(x))
    for b, (L, R) in enumerate(pairs):
        ref = oracle_multiband(L, R, jcfg)
        for c in range(3):
            assert snr_db(ref[c], y[b, c]) > 60.0, (b, c)
            assert snr_db(jax_y[b, c], y[b, c]) > 80.0, (b, c)


@pytest.mark.parametrize(
    "n_paths,index,count",
    [(5, 0, 2), (5, 1, 2), (5, 2, 3), (2, 1, 3), (0, 0, 1), (7, 6, 7), (3, 3, 3), (3, -1, 2), (3, 0, 0)],
)
def test_local_file_shard_matches_jax(n_paths, index, count):
    paths = [f"f{i}.wav" for i in range(n_paths)]
    try:
        want = jax_local_file_shard(paths, index=index, count=count)
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{str(e).replace('[', '.').replace(')', '.')}$"):
            local_file_shard(paths, index=index, count=count)
        return
    assert local_file_shard(paths, index=index, count=count) == want


def test_before_init():
    assert not is_initialized()
    assert process_index() == 0 and process_count() == 1
    assert local_file_shard(["a", "b", "c"]) == ["a", "b", "c"]
    assert global_devices() == [(0, torch.device("cuda", i)) for i in range(torch.cuda.device_count())]


def test_sharded_upmixer_refuses_a_spanning_mesh():
    cfg = UpmixConfig.make(EDGES, sr=SR, max_block_size=MAX_BLOCK)
    mesh = make_mesh({"seq": 2}, devices=[(0, "cpu"), (1, "cpu")])
    assert mesh.processes.tolist() == [0, 1] and not mesh.fully_addressable
    with pytest.raises(ValueError, match="build_sharded_offline_fn"):
        ShardedUpmixer(cfg, mesh)
    assert make_mesh({"seq": 2}, devices=["cpu", "cpu"]).fully_addressable


INIT_TWICE_CHILD = r"""
import sys
import torch
from upmix_tpu_torch.parallel import distributed, global_devices, init_distributed, make_mesh
first = init_distributed(f"127.0.0.1:{sys.argv[1]}", 1, 0, ["cpu", "cpu:0"], backend="gloo")
assert first == {"process_index": 0, "process_count": 1, "local_devices": 2, "global_devices": 2}, first
assert init_distributed() == first
assert distributed.is_initialized() and distributed.process_index() == 0 and distributed.process_count() == 1
assert global_devices() == [(0, torch.device("cpu")), (0, torch.device("cpu", 0))]
mesh = make_mesh()
assert mesh.shape == {"seq": 2} and mesh.fully_addressable
print("INIT_TWICE_OK")
"""


def test_second_init_returns_the_same_record():
    (rc, out, err), = _run_pair([[sys.executable, "-c", INIT_TWICE_CHILD, str(_free_port())]])
    assert rc == 0 and "INIT_TWICE_OK" in out, out + err


# argv: port, rank, when ("before" or "after" init).  Rank 1 exits at
# `when`; rank 0 brings the group up and runs a spanning pipeline, with
# every wait bounded by a short distributed.TIMEOUT.
LOST_PEER_CHILD = r"""
import datetime, os, sys
import torch
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.parallel import build_sharded_offline_fn, distributed, init_distributed, make_mesh
port, rank, when = sys.argv[1], int(sys.argv[2]), sys.argv[3]
distributed.TIMEOUT = datetime.timedelta(seconds=3)
if rank == 1 and when == "before":
    sys.exit(0)
init_distributed(f"127.0.0.1:{port}", 2, rank, ["cpu"], backend="gloo")
if rank == 1:
    os._exit(0)  # gone, as a crash would leave it
cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
fn, plan = build_sharded_offline_fn(cfg, 4000, make_mesh({"seq": 2}))
fn(torch.zeros((1, 2, plan.n_padded)))
print("NO_FAILURE")
"""


@pytest.mark.parametrize("when", ["before", "after"])
def test_a_lost_peer_fails_its_partner_within_the_timeout(when):
    port = _free_port()
    t0 = time.perf_counter()
    runs = _run_pair([[sys.executable, "-c", LOST_PEER_CHILD, str(port), str(r), when] for r in range(2)], timeout=60)
    took = time.perf_counter() - t0
    (rc0, out0, err0), (rc1, _, _) = runs
    assert rc1 == 0
    assert rc0 != 0 and "NO_FAILURE" not in out0, out0 + err0
    assert "Error" in err0, err0  # raised: a store timeout, or gloo's closed connection
    assert took < 40, took
