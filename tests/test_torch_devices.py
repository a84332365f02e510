"""One process over several cards, without a card.

Every call into the CUDA library goes through `ops/_build.py::kernels`:
it runs the block under `on_device` on its tensors' card, for PyTorch's
default stream is the legacy stream of the *current* device, so an
unguarded launch for tensors on cuda:1 runs on cuda:0 (and faults, or
races the copies that fill its inputs).  An AST walk over
`upmix_tpu_torch/ops/` holds every other module to that one path, and a
fake library checks the path itself.  Meshes, the pool's shards and the
pod check's entries spread over distinct cards as the JAX package's
spread over its devices: with `torch.cuda.device_count` patched to 4,
no CUDA call is made.  The card itself is in tests/test_torch_cuda.py
(`-k devices`, two or more cards).
"""

import ast
import contextlib
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import upmix_tpu.parallel as jax_parallel
from upmix_tpu_torch import cli, tune
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.offline import _plan_buckets, plans_from_numpy
from upmix_tpu_torch.models.streaming import _mesh_devices
from upmix_tpu_torch.ops import _build
from upmix_tpu_torch.ops.omnibus import check_kernel_tables
from upmix_tpu_torch.parallel import make_mesh, pod_check
from upmix_tpu_torch.parallel.sharded import _device_grid
from upmix_tpu_torch.utils.tracing import launches

OPS = Path(__file__).resolve().parent.parent / "upmix_tpu_torch" / "ops"
# The ten launch sites: K1, K2, K3, K3s's three steps, K4, K5's two, K6.
LAUNCH_SITES = {
    "_omnibus_cuda", "_fused_cuda", "_pool_cuda", "_forward_cuda", "_edge_cuda", "_whole_cuda", "dot_cuda",
    "_probe_cuda", "empty_launch", "_floor_cuda",
}
# What an ops module may take of `_build`: the launch path, another build
# of the library for it, and the bare guard (plans built on a card).
PATH = {"kernels", "library", "on_device"}


def _is_kernels(node) -> bool:
    """`_build.kernels(...)`."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "kernels"
            and isinstance(node.func.value, ast.Name) and node.func.value.id == "_build")


def bypasses(sources: dict) -> tuple:
    """(faults, functions that reach the launch path) over {module:
    source}: any use of `_build` but PATH, a library opened by ctypes,
    and any use of a `with _build.kernels(...) as k` block's `k` after
    the block (a launch, or a helper handed it, off the guard).  A
    function reaches the path by using `k` inside its block or by being
    handed it there."""
    faults, reach = [], set()
    for mod, src in sources.items():
        tree = ast.parse(src)
        for node in ast.walk(tree):
            where = f"{mod}:{getattr(node, 'lineno', '?')}"
            if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "_build"
                    and node.attr not in PATH):
                faults.append(f"{where} uses _build.{node.attr}")
            if isinstance(node, ast.ImportFrom) and (node.module or "").endswith("_build"):
                faults += [f"{where} imports {a.name} from _build" for a in node.names if a.name not in PATH]
            if isinstance(node, (ast.Attribute, ast.Name)) and getattr(node, "attr", getattr(node, "id", None)) in (
                    "CDLL", "cdll", "LoadLibrary"):
                faults.append(f"{where} opens a library outside _build")
        for fn in [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            for block in [n for n in ast.walk(fn) if isinstance(n, ast.With)]:
                for item in block.items:
                    if not (_is_kernels(item.context_expr) and isinstance(item.optional_vars, ast.Name)):
                        continue
                    k = item.optional_vars.id
                    inside = {id(n) for stmt in block.body for n in ast.walk(stmt)}
                    for use in [n for n in ast.walk(fn) if isinstance(n, ast.Name) and n.id == k
                                and isinstance(n.ctx, ast.Load)]:
                        if id(use) not in inside:
                            faults.append(f"{mod}::{fn.name} uses {k} after its kernels block")
                            continue
                        reach.add(fn.name)
                    for call in [n for stmt in block.body for n in ast.walk(stmt) if isinstance(n, ast.Call)]:
                        if isinstance(call.func, ast.Name) and any(isinstance(a, ast.Name) and a.id == k
                                                                   for a in call.args):
                            reach.add(call.func.id)
    return faults, reach


def test_every_launch_in_ops_runs_under_the_device_guard():
    sources = {p.name: p.read_text() for p in sorted(OPS.glob("*.py")) if p.name != "_build.py"}
    faults, reach = bypasses(sources)
    assert not faults, faults
    assert LAUNCH_SITES <= reach, sorted(LAUNCH_SITES - reach)


@pytest.mark.parametrize("source", [
    "def f(x):\n    lib = _build.load()\n    lib.omni_bucket(1)\n",
    "def f(x):\n    with _build.kernels(x.device) as k:\n        pass\n    k.launch('K1', 'omni_bucket', 1)\n",
    "def f(x):\n    _build.load().dot_chain(1)\n",
    "def f(x, path):\n    ctypes.CDLL(path).pool_floor(1)\n",
    "def helper(k):\n    k.launch('K1', 'omni_bucket', 1)\n\ndef f(x):\n    with _build.kernels(x.device) as k:\n"
    "        helper(k)\n    helper(k)\n",
    "def f(fn):\n    n = getattr(_build._lib, fn)(1)\n",
])
def test_the_guard_check_sees_a_launch_outside_the_guard(source):
    faults, _ = bypasses({"m.py": source})
    assert faults


def test_the_guard_check_passes_guarded_launches():
    source = (
        "def helper(k):\n    k.launch('K1', 'omni_bucket', 1)\n\n"
        "def f(x, path=None):\n    lib = _build.library(path, 'pool_floor') if path else None\n"
        "    with _build.kernels(x.device, lib) as k:\n        helper(k)\n"
        "        k.launch('K6', 'pool_floor', 1)\n"
    )
    faults, reach = bypasses({"m.py": source})
    assert not faults and reach == {"f", "helper"}


class _FakeLibrary:
    """Entries that record their arguments and return the rc set for them."""

    _name = "fake.so"

    def __init__(self, **rc):
        self.calls, self._rc = [], rc

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return self._rc.get(entry, 0)

        return call


def test_the_launch_path_guards_once_appends_the_stream_counts_and_raises(monkeypatch):
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(("in", torch.device(dev)))
        yield
        entered.append(("out", torch.device(dev)))

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(_build, "_once", set())
    lib = _FakeLibrary(pool_reg_bucket=700, empty_launch=2)
    before = launches("K1"), launches("K3s"), launches("K3s.edge"), launches(*("K1", "K2", "K3", "K3s"))
    with _build.kernels("cuda:1", lib) as k:
        assert entered == [("in", torch.device("cuda", 1))]
        k.launch("K1", "omni_bucket", 1, 2)
        k.launch("K3s.edge", "pool_spectral_edge", 3)
        k.once("pool_spectral_roots", 4)
        k.once("pool_spectral_roots", 4)  # once for each library and card
        assert k.query("dot_chain_clusters", 32, 2, 8) == 0
        with pytest.raises(RuntimeError, match="pool_reg_bucket launch failed: cudaError 700"):
            k.launch("K3", "pool_reg_bucket", 5)
        with pytest.raises(RuntimeError, match="empty_launch failed: cudaError 2"):
            k.run("empty_launch", 6, 1, k.stream)
    assert entered == [("in", torch.device("cuda", 1)), ("out", torch.device("cuda", 1))]  # one guard a block
    assert lib.calls == [("omni_bucket", (1, 2, 77)), ("pool_spectral_edge", (3, 77)),
                         ("pool_spectral_roots", (4,)), ("dot_chain_clusters", (32, 2, 8)),
                         ("pool_reg_bucket", (5, 77)), ("empty_launch", (6, 1, 77))]
    # one launch under its kernel each, the failed one too; the edge product's among K3s's; no query or run counted
    assert (launches("K1"), launches("K3s"), launches("K3s.edge"), launches("K1", "K2", "K3", "K3s")) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 3)


def test_on_device_makes_the_card_current_and_restores_it(monkeypatch):
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(("in", torch.device(dev)))
        yield
        entered.append(("out", torch.device(dev)))

    monkeypatch.setattr(torch.cuda, "device", device)
    with _build.on_device("cuda:2") as dev:
        assert entered == [("in", torch.device("cuda", 2))] and dev == torch.device("cuda", 2)
    assert entered[-1] == ("out", torch.device("cuda", 2))
    with _build.on_device(torch.device("cpu")) as dev:  # a plan for the plain versions: no change
        assert dev.type == "cpu"
    assert len(entered) == 2
    with pytest.raises(ValueError, match="cuda devices"), _build.on_device("meta"):
        pass


@pytest.fixture
def four_cards(monkeypatch):
    """torch.cuda.device_count() reads 4; nothing else of CUDA is touched."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def _indices(devices) -> list:
    return [d.index if isinstance(d, torch.device) else d.id for d in np.asarray(devices).reshape(-1)]


MESH_AXES = [None, {"seq": 4}, {"data": 4}, {"data": 2, "seq": 2}, {"seq": 2, "data": 2}, {"data": 2}]


@pytest.mark.parametrize("axes", MESH_AXES, ids=str)
def test_make_mesh_spans_distinct_cards_as_the_jax_mesh_spans_devices(four_cards, axes):
    port = make_mesh(axes)
    ref = jax_parallel.make_mesh(axes, devices=jax.devices()[:4])
    assert port.axis_names == tuple(ref.axis_names)
    assert port.devices.shape == ref.devices.shape
    assert all(d.type == "cuda" for d in port.devices.flat)
    assert _indices(port.devices) == _indices(ref.devices)
    assert len(set(_indices(port.devices))) == port.devices.size  # distinct cards


@pytest.mark.parametrize("axes", [{"data": 2, "seq": 2}, {"seq": 2, "data": 2}], ids=str)
def test_shard_grid_follows_the_jax_mesh(four_cards, axes):
    # The sharded path's [data, seq] grid: the JAX mesh's devices with
    # its axes in that order.
    port = _device_grid(make_mesh(axes), "data", "seq")
    ref = jax_parallel.make_mesh(axes, devices=jax.devices()[:4])
    want = np.asarray(ref.devices).transpose([list(ref.axis_names).index(a) for a in ("data", "seq")])
    assert _indices(port) == _indices(want)


@pytest.mark.parametrize("spec,flag,axes", [
    ("data=2,seq=2", "--mesh", {"data": 2, "seq": 2}),
    ("seq=4", "--mesh", {"seq": 4}),
    ("data=4", "--pool-mesh", {"data": 4}),
])
def test_cli_meshes_span_the_visible_cards(four_cards, spec, flag, axes):
    allowed = ("data",) if flag == "--pool-mesh" else ("data", "seq")
    port = cli.build_mesh(spec, allowed=allowed, flag=flag)
    ref = jax_parallel.make_mesh(axes, devices=jax.devices()[:4])
    assert _indices(port.devices) == _indices(ref.devices)
    assert {d.type for d in port.devices.flat} == {"cuda"}


def test_cli_named_card_repeats_it(four_cards):
    mesh = cli.build_mesh("data=2,seq=2", device="cuda:3")
    assert [str(d) for d in mesh.devices.flat] == ["cuda:3"] * 4


def test_cli_mesh_larger_than_the_cards_is_refused(four_cards):
    with pytest.raises(SystemExit, match="needs 8 devices, have 4"):
        cli.build_mesh("data=2,seq=4")


def test_pool_shards_go_to_distinct_cards(four_cards):
    assert _mesh_devices(make_mesh({"data": 4}), True) == [torch.device("cuda", i) for i in range(4)]
    assert _mesh_devices(make_mesh({"data": 2, "seq": 2}), True) == [torch.device("cuda", 0),
                                                                     torch.device("cuda", 2)]


def test_pod_check_entries_of_bare_cuda_are_distinct_cards(four_cards, monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert pod_check.local_entries("cuda", 4) == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert pod_check.local_entries("cuda", 1) == ["cuda:0"]
    assert pod_check.local_entries("cuda:0", 3) == ["cuda:0"] * 3
    assert pod_check.local_entries("cpu", 2) == ["cpu", "cpu"]
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pod_check.local_entries("cuda", 2) == ["cuda:2", "cuda:3"]
    assert pod_check.local_entries("cuda", 1) == ["cuda:1"]
    with pytest.raises(ValueError, match="needs cards 4 .. 7"):
        pod_check.local_entries("cuda", 4)


def test_kernel_tables_on_another_device_are_refused():
    cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=8000.0, max_block_size=512)
    b = plans_from_numpy(_plan_buckets(cfg, 1), "cpu")[0]
    check_kernel_tables(b, torch.device("cpu"))
    with pytest.raises(ValueError, match="plan buckets live on cpu, input on cuda:1"):
        check_kernel_tables(b, torch.device("cuda", 1))
    for field in ("analysis_window", "synthesis_window", "gains", "twiddles"):
        moved = dataclasses.replace(b, **{field: getattr(b, field).to("meta")})
        with pytest.raises(ValueError, match="plan buckets live on"):
            check_kernel_tables(moved, torch.device("cpu"))


def test_tuner_clock_records_on_the_timed_card(monkeypatch):
    streams = []

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self, stream=None):
            streams.append(stream)

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 2.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: ("stream of", torch.device(device)))
    clock = tune._Clock("cuda:2")
    clock.start()
    assert clock.stop() == 2e-3
    assert streams == [("stream of", torch.device("cuda", 2))] * 2
