"""The port's spans (`upmix_tpu_torch/utils/tracing.py`) at the layer
boundaries of `Upmixer.process` and `CudaStreamPool.push_blocks`, on the
CPU: nothing is recorded without a profiler; under one, the span tree
(one root a call, children inside their parents, one call id); the
outputs bit for bit those with spans off; no profiler event of the
program's own; a bounded store; and the exported Chrome trace's clock.
The cases on the card (launch counts, each card of a mesh) are in
tests/test_torch_cuda.py."""

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.offline import Upmixer
from upmix_tpu_torch.models.streaming import CudaStreamPool, StreamingUpmixer
from upmix_tpu_torch.parallel import make_mesh
from upmix_tpu_torch.utils import tracing
from upmix_tpu_torch.utils.profiling import SPAN_TRACK, trace

HW, S = 256, 4
POOL = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=8000.0, hw_block_size=HW)
OFFLINE = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
OFFLINE_SPANS = ["offline.stage_in", "offline.program", "offline.segment", "offline.kernels", "offline.spill"]


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _blocks(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 2, S, HW)).astype(np.float32) * 0.3


def _signal(n=10000, seed=1):
    return np.random.default_rng(seed).standard_normal((2, n)).astype(np.float32)


def _calls(records) -> list:
    """The roots in start order, each with its call's spans, after checking
    the tree: one root a call whose id is the call's, every other span's
    parent in its call and the span inside its parent."""
    by_id = {r.id: r for r in records}
    calls = {}
    for r in records:
        calls.setdefault(r.call, []).append(r)
    out = []
    for call, rs in calls.items():
        (root,) = [r for r in rs if r.parent is None]
        assert root.id == call
        for r in rs:
            if r.parent is not None:
                p = by_id[r.parent]
                assert p.call == call and p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (r, p)
        out.append((root, rs))
    return sorted(out, key=lambda c: c[0].start_ns)


def _children(rs, parent) -> list:
    return [r.name for r in sorted(rs, key=lambda r: r.start_ns) if r.parent == parent.id]


def test_nothing_recorded_without_a_profiler():
    pool = CudaStreamPool(POOL, HW, S, device="cpu")
    for b in _blocks(2):
        pool.push_blocks(b[0], b[1])
    pool.push_blocks_multi(np.zeros((S, 2 * HW), np.float32), np.zeros((S, 2 * HW), np.float32))
    up = Upmixer(OFFLINE, device="cpu", chunk=4096)
    x = _signal()
    up.process(x[0], x[1])
    up.process_np(x[0], x[1])
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_pool_span_tree():
    pool = CudaStreamPool(POOL, HW, S, device="cpu")
    blocks = _blocks(2)

    def run():
        for b in blocks:
            pool.push_blocks(b[0], b[1])
        pool.push_blocks_multi(np.zeros((S, 3 * HW), np.float32), np.zeros((S, 3 * HW), np.float32))

    _profiled(run)
    calls = _calls(tracing.spans())
    assert [root.name for root, _ in calls] == ["pool.push"] * 3
    for (root, rs), hops in zip(calls, (1, 1, 3)):
        # the plain versions launch nothing, the edge product least of all
        assert root.attrs == {"streams": S, "hops": hops, "launches": 0, "edge_launches": 0}
        assert _children(rs, root) == ["pool.stage", "pool.step"]
        (step,) = [r for r in rs if r.name == "pool.step"]
        assert _children(rs, step) == ["pool.shift", "pool.kernels"] and step.card is None


def test_mesh_pool_spans_each_part():
    # "cpu" and "cpu:0" are two devices to the pool: each part is
    # scattered, stepped and gathered apart, as over two cards.  Every
    # input is sent before any part steps; each part's rows are one range,
    # so each moves as a slice.
    pool = CudaStreamPool(POOL, HW, S, mesh=make_mesh({"data": 2}, devices=["cpu", "cpu:0"]))
    b = _blocks(1)[0]
    _profiled(lambda: pool.push_blocks(b[0], b[1]))
    ((root, rs),) = _calls(tracing.spans())
    assert _children(rs, root) == ["pool.stage", "pool.scatter", "pool.scatter", "pool.step", "pool.step",
                                   "pool.gather", "pool.gather"]
    for step in (r for r in rs if r.name == "pool.step"):
        assert _children(rs, step) == ["pool.shift", "pool.kernels"]
    for r in rs:
        if r.name in ("pool.scatter", "pool.gather"):
            assert r.attrs == {"path": "slice"}, r


def _plain_k3s(monkeypatch):
    """Route a CPU pool's spectral step through the card's three-step
    path (`ops/pool.py::_spectral_cuda`, its spans and its launch counts),
    each step's kernels replaced by its plain version; the edge step
    counts a gather and a product for each launch group through the
    launch path, as on the card (a library whose every launch succeeds)."""
    from upmix_tpu_torch.ops import _build
    from upmix_tpu_torch.ops import pool as ops

    class Succeeds:
        def __getattr__(self, entry):
            return lambda *args: 0

    k = _build.kernels("cpu", Succeeds())  # used unentered: its launches alone, on stream None

    def edge(carries, specs, t, plan, hops, routes):
        for _ in routes.groups:
            k.launch("K3s.edge", "pool_spectral_edge_gather")
            k.launch("K3s.edge", "pool_spectral_edge")
        return ops.spectral_edge_plain(carries, specs, t, plan, hops)

    def whole(carries, specs, t, plan, hops, routes, out):
        got = ops.spectral_whole_plain(carries, specs, t, plan, hops)
        return got if out is None else out + got

    monkeypatch.setattr(ops, "pool_step_spectral_plain", ops._spectral_cuda)
    monkeypatch.setattr(ops, "_forward_cuda", ops.spectral_forward_plain)
    monkeypatch.setattr(ops, "_edge_cuda", edge)
    monkeypatch.setattr(ops, "_whole_cuda", whole)


def test_spectral_pool_spans_split_k3s(monkeypatch):
    # K3s's forward, edge product and inverse each in a span inside
    # `pool.kernels`; the root counts the edge product's launches.  The
    # time pool keeps its spans, with no edge launch.
    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048)
    time_pool = CudaStreamPool(cfg, 2048, S, device="cpu")
    spectral = CudaStreamPool(cfg, 2048, S, device="cpu", ola="spectral")
    plain = CudaStreamPool(cfg, 2048, S, device="cpu", ola="spectral")
    routes = spectral.plan.spectral_routes(1)
    assert [g.buckets for g in routes.groups] == [(0, 1)]
    blocks = np.random.default_rng(3).standard_normal((5, 2, S, 2048)).astype(np.float32) * 0.3
    _plain_k3s(monkeypatch)
    got, _ = _profiled(lambda: [torch.stack(spectral.push_blocks(b[0], b[1])) for b in blocks]
                       + [torch.stack(time_pool.push_blocks(b[0], b[1])) for b in blocks[:1]])
    calls = _calls(tracing.spans())
    monkeypatch.undo()
    for out, b in zip(got, blocks):  # the three steps compute the spectral dataflow
        assert torch.allclose(out, torch.stack(plain.push_blocks(b[0], b[1])), rtol=0, atol=1e-6)
    assert len(calls) == 6
    for root, rs in calls[:5]:
        assert root.attrs == {"streams": S, "hops": 1, "launches": 2, "edge_launches": 2}
        (kernels,) = [r for r in rs if r.name == "pool.kernels"]
        assert _children(rs, kernels) == ["pool.forward", "pool.edge", "pool.inverse"]
        steps = {r.name: r for r in rs if r.parent == kernels.id}
        # the FFT frames of a stream's call, all of them on the register core
        assert steps["pool.forward"].attrs == {"buckets": 4, "fft_frames": 43, "reg_frames": 43}
        assert steps["pool.edge"].attrs == {"buckets": 2, "frames": sum(routes.groups[0].n_edge)}
        assert steps["pool.inverse"].attrs == {"buckets": 2, "fft_frames": 46, "reg_frames": 46}
        assert {r.card for r in steps.values()} == {None}  # a CPU pool names no card
    root, rs = calls[5]
    assert root.attrs == {"streams": S, "hops": 1, "launches": 0, "edge_launches": 0}
    assert [r.name for r in rs] == ["pool.stage", "pool.shift", "pool.kernels", "pool.step", "pool.push"]


def test_offline_span_tree():
    up = Upmixer(OFFLINE, device="cpu", chunk=4096, max_programs=1)
    x, y = _signal(10000), _signal(6000, seed=2)

    def run():
        up.process(x[0], x[1])  # built
        up.process_np(x[0], x[1])  # cached, then the stems to the host
        up.process(y[0], y[1])  # built, the first program evicted

    _profiled(run)
    calls = _calls(tracing.spans())
    assert [root.name for root, _ in calls] == ["offline.process", "offline.process", "offline.to_host",
                                               "offline.process"]
    programs = []
    for root, rs in calls:
        if root.name == "offline.to_host":
            assert _children(rs, root) == [] and root.attrs == {"samples": 10000, "launches": 0}
            continue
        assert _children(rs, root) == OFFLINE_SPANS and root.attrs["launches"] == 0
        programs += [r.attrs for r in rs if r.name == "offline.program"]
    assert [calls[i][0].attrs["samples"] for i in (0, 1, 3)] == [10000, 10000, 6000]
    assert programs == [{"built": True, "evicted": 0}, {"built": False, "evicted": 0}, {"built": True, "evicted": 1}]


def test_whole_file_program_is_one_kernels_span():
    up = Upmixer(OFFLINE, device="cpu", chunk=0)
    x = _signal()
    _profiled(lambda: up.process(x[0], x[1]))
    ((root, rs),) = _calls(tracing.spans())
    assert _children(rs, root) == ["offline.stage_in", "offline.program", "offline.kernels"]


def test_outputs_identical_with_spans_on_and_off():
    blocks = _blocks(6)
    x = _signal()
    on_pool, off_pool = (CudaStreamPool(POOL, HW, S, device="cpu") for _ in range(2))
    on_up, off_up = (Upmixer(OFFLINE, device="cpu", chunk=4096) for _ in range(2))
    on, _ = _profiled(lambda: [torch.stack(on_pool.push_blocks(b[0], b[1])) for b in blocks]
                      + [torch.stack(on_up.process(x[0], x[1]))])
    off = [torch.stack(off_pool.push_blocks(b[0], b[1])) for b in blocks] + [torch.stack(off_up.process(x[0], x[1]))]
    assert len(tracing.spans()) == 6 * 5 + 6
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_no_profiler_event_of_the_program():
    # A record_function range would also put a row on the device's
    # timeline, which the benchmark would count as device work.
    pool = CudaStreamPool(POOL, HW, S, device="cpu")
    up = Upmixer(OFFLINE, device="cpu", chunk=4096)
    b, x = _blocks(1)[0], _signal()
    _, prof = _profiled(lambda: (pool.push_blocks(b[0], b[1]), up.process_np(x[0], x[1])))
    assert tracing.spans()
    assert [e.name for e in prof.events() if e.name.startswith(("offline.", "pool."))] == []


def test_spans_outside_a_call_record_nothing():
    # The single-stream engine and the sustained runner step through the
    # same `_batch_step`, whose spans are children of a `pool.push` alone.
    one = StreamingUpmixer(POOL, HW, device="cpu")
    pool = CudaStreamPool(POOL, HW, S, device="cpu")
    run, fresh = pool.make_sustained_runner(2)
    blocks = torch.as_tensor(_blocks(2))
    _profiled(lambda: (one.push_block(np.zeros(HW, np.float32), np.zeros(HW, np.float32)), run(fresh(), blocks)))
    assert tracing.spans() == []


def test_a_call_records_on_its_own_thread_only():
    pool = CudaStreamPool(POOL, HW, S, device="cpu")
    b = _blocks(1)[0]
    elsewhere = []

    def other():
        with tracing.span("pool.step"):
            elsewhere.append(1)

    def run():
        with tracing.root("pool.push"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            pool.push_blocks(b[0], b[1])  # a root inside a recording call is a span of it

    _profiled(run)
    ((root, rs),) = _calls(tracing.spans())
    assert elsewhere == [1] and _children(rs, root) == ["pool.push"]
    assert [r.name for r in rs].count("pool.step") == 1


def test_a_full_store_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 4)
    pool = CudaStreamPool(POOL, HW, S, device="cpu")
    blocks = _blocks(3)
    _profiled(lambda: [pool.push_blocks(b[0], b[1]) for b in blocks])
    assert len(tracing.spans()) == 4 and tracing.dropped() == 3 * 5 - 4
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_exported_trace_puts_the_spans_on_the_profiler_clock(tmp_path):
    # Each `pool.stage` span holds `_blocks`'s torch.stack, and each
    # `pool.shift` span the history's torch.cat: CPU ops the profiler
    # stamped on its own clock.
    pool = CudaStreamPool(POOL, HW, S, device="cpu")
    blocks = _blocks(4)
    with trace(str(tmp_path)):
        for b in blocks:
            pool.push_blocks(b[0], b[1])
    (path,) = [os.path.join(r, f) for r, _, files in os.walk(tmp_path) for f in files]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "upmix_tpu_torch"]
    assert {e["tid"] for e in spans} == {SPAN_TRACK} and len(spans) == 4 * 5
    for name, op in (("pool.stage", "aten::stack"), ("pool.shift", "aten::cat")):
        ours = [e for e in spans if e["name"] == name]
        ops = [e for e in events if e.get("name") == op and e.get("ph") == "X"]
        assert len(ours) == 4
        for s in ours:
            assert any(s["ts"] <= o["ts"] and o["ts"] + o["dur"] <= s["ts"] + s["dur"] for o in ops), (name, s)
