"""One process over several cards, without a card.

Every call into the CUDA library runs under `ops/_build.py::on_device`
on its tensors' card: PyTorch's default stream is the legacy stream of
the *current* device, so an unguarded launch for tensors on cuda:1 runs
on cuda:0 (and faults, or races the copies that fill its inputs).  An
AST walk over `upmix_tpu_torch/ops/` holds every launch site to the
guard.  Meshes, the pool's shards and the pod check's entries spread
over distinct cards as the JAX package's spread over its devices: with
`torch.cuda.device_count` patched to 4, no CUDA call is made.  The card
itself is in tests/test_torch_cuda.py (`-k devices`, two or more cards).
"""

import ast
import contextlib
import dataclasses
from pathlib import Path

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

OPS = Path(__file__).resolve().parent.parent / "upmix_tpu_torch" / "ops"
# The ten launch sites: K1, K2, K3, K3s's three steps, K4, K5's two, K6.
LAUNCH_SITES = {
    "_omnibus_cuda", "_fused_cuda", "_pool_cuda", "_forward_cuda", "_edge_cuda", "_whole_cuda", "dot_cuda",
    "_probe_cuda", "empty_launch", "_floor_cuda",
}


def _is_load(node) -> bool:
    """`_build.load()` or `load()`."""
    return (isinstance(node, ast.Call) and not node.args
            and ((isinstance(node.func, ast.Attribute) and node.func.attr == "load"
                  and isinstance(node.func.value, ast.Name) and node.func.value.id == "_build")
                 or (isinstance(node.func, ast.Name) and node.func.id == "load")))


def _is_library(node) -> bool:
    """An expression that is the library: `lib`, `_build.load()`, `lib or _build.load()`."""
    if isinstance(node, ast.Name):
        return node.id == "lib"
    if isinstance(node, ast.BoolOp):
        return any(_is_library(v) for v in node.values)
    return _is_load(node)


def _library_call(node) -> bool:
    """A call into the library: `lib.fn(...)`, `_build.load().fn(...)`,
    `getattr(lib, name)(...)`, or the load itself."""
    if not isinstance(node, ast.Call):
        return False
    if _is_load(node):
        return True
    f = node.func
    if isinstance(f, ast.Attribute):
        return _is_library(f.value)
    return (isinstance(f, ast.Call) and isinstance(f.func, ast.Name) and f.func.id == "getattr"
            and bool(f.args) and _is_library(f.args[0]))


def _guard(node) -> bool:
    return isinstance(node, ast.With) and any(
        isinstance(item.context_expr, ast.Call)
        and getattr(item.context_expr.func, "attr", getattr(item.context_expr.func, "id", None)) == "on_device"
        for item in node.items
    )


def library_calls(source: str):
    """[(function, call name, guarded, function takes `lib`)] of every
    library call in `source`, and [(callee, guarded)] of every call by
    plain name, for the functions that take the library as an argument."""
    tree = ast.parse(source)
    found, calls = [], []

    def walk(node, fn, takes_lib, guarded):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names = [a.arg for a in node.args.args + node.args.kwonlyargs]
            fn, takes_lib, guarded = node.name, "lib" in names, False
        if _guard(node):
            guarded = True
        if _library_call(node):
            f = node.func
            name = "load" if _is_load(node) else getattr(f, "attr", "getattr")
            found.append((fn, name, guarded, takes_lib))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            calls.append((node.func.id, guarded))
        for child in ast.iter_child_nodes(node):
            walk(child, fn, takes_lib, guarded)

    walk(tree, None, False, False)
    return found, calls


def unguarded(sources: dict) -> tuple:
    """(faults, functions that reach the library) over {module: source}:
    a library call outside `on_device`, unless its function takes the
    library as an argument and every call of that function is guarded."""
    found, calls = [], []
    for mod, src in sources.items():
        f, c = library_calls(src)
        found += [(mod, *x) for x in f]
        calls += c
    faults, reach = [], set()
    for mod, fn, name, guarded, takes_lib in found:
        reach.add(fn)
        if guarded:
            continue
        callers = [g for callee, g in calls if callee == fn]
        if not (takes_lib and callers and all(callers)):
            faults.append(f"{mod}::{fn} calls {name} outside on_device")
    return faults, reach


def test_every_launch_in_ops_runs_under_the_device_guard():
    sources = {p.name: p.read_text() for p in sorted(OPS.glob("*.py")) if p.name != "_build.py"}
    faults, reach = unguarded(sources)
    assert not faults, faults
    assert LAUNCH_SITES <= reach, sorted(LAUNCH_SITES - reach)


@pytest.mark.parametrize("source", [
    "def f(x):\n    lib = _build.load()\n    lib.omni_bucket(1)\n",
    "def f(x):\n    with _build.on_device(x.device):\n        lib = _build.load()\n    lib.omni_bucket(1)\n",
    "def f(x):\n    _build.load().dot_chain(1)\n",
    "def f(x, lib=None):\n    (lib or _build.load()).pool_floor(1)\n",
    "def helper(lib):\n    lib.omni_bucket(1)\n\ndef f(x):\n    with _build.on_device(x.device):\n"
    "        helper(_build.load())\n    helper(_build.load())\n",
    "def f(fn):\n    lib = _build.load()\n    n = getattr(lib, fn)(1)\n",
])
def test_the_guard_check_sees_a_launch_outside_the_guard(source):
    faults, _ = unguarded({"m.py": source})
    assert faults


def test_the_guard_check_passes_guarded_launches():
    source = (
        "def helper(lib):\n    lib.omni_bucket(1)\n\n"
        "def f(x, lib=None):\n    with _build.on_device(x.device):\n        helper(_build.load())\n"
        "        (lib or _build.load()).pool_floor(1)\n"
    )
    faults, reach = unguarded({"m.py": source})
    assert not faults and reach == {"f", "helper"}


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
