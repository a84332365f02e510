"""A dry run of every cell at a tiny size on the CPU: set-up, window,
the traced window's reduction and the check run, and the result has the
contract's keys.  Then, in a fresh interpreter, the same dry runs and an
import of every file under benchmark/ must leave no module of JAX or of
the JAX package loaded (top-level names compared whole)."""

import subprocess
import sys

import pytest

import tiny
from tiny import ROOT

CELLS = tiny.cells()


def check_dry(r, trace):
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert "breakdown" in r and r["device"]["window_s"] > 0
        assert "setup_s" not in r["metrics"]
    else:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_dry_run(workload, trace):
    check_dry(tiny.result(workload, trace=trace), trace)


@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_runs_dry(monkeypatch, trace):
    """A cell entered in the spec alone, its traffic patched in memory,
    runs dry with every metric the cell it is entered like reports."""
    from benchmark import run
    from benchmark.drivers import pool

    bench = tiny.joined(tiny.spec(), tiny.NEW, tiny.LIKE)
    olas, release = [], pool.Session.release

    def spy(self):
        olas.append(self.pool.ola)
        release(self)

    monkeypatch.setattr(pool.Session, "release", spy)
    r = tiny.result(tiny.NEW, trace=trace, bench=bench,
                    traffic_patch=run.merged(tiny.patch(tiny.NEW, bench), tiny.NEW_PATCH))
    check_dry(r, trace)
    assert olas == ["spectral"]
    assert set(r["metrics"]) == set(tiny.result(tiny.LIKE, trace=trace)["metrics"])


def test_no_cuda_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(ROOT / ".bench_cache")})
    assert out.returncode == 2 and out.stdout.strip() == ""


CHILD = r"""
import importlib.util, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import tiny
from benchmark import run
for w in {cells!r}:
    assert tiny.result(w, trace=0)["correct"]
for path in sorted(tiny.ROOT.joinpath("benchmark").rglob("*.py")):
    name = "probe_" + str(abs(hash(path)))
    spec = importlib.util.spec_from_file_location(name, path)
    sys.modules[name] = module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
print(",".join(run.forbidden_modules()) or "none")
"""


def test_no_jax_after_dry_runs_and_imports():
    code = CHILD.format(root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"), cells=CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "none"
