"""Tiny versions of every cell for CPU runs: the same configurations and
drivers, a few short files or streams, the kernels' plain versions.

A cell's tiny size is the traffic patch in `tiny/<cell>.json` beside this
file where there is one, else a default that the cell's traffic driver
works out from the traffic file; its devices come from the traffic's mesh
or the cell's chips.  Nothing here is keyed by a cell's name, so a cell
joins these tests by its data files and BENCHMARK.json entries alone."""

import contextlib
import copy
import io
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SIZES = Path(__file__).resolve().parent / "tiny"
SEED = 2147483661  # past 31 bits: seeds reach a little over 2**31
# A cell that no file of tiny/ names, for the tests that a cell joins by its
# entries alone: pool_2048's traffic on the spectral OLA (K3s), patched in memory.
NEW, LIKE, NEW_PATCH = "pool_2048_spectral", "pool_2048", {"ola": "spectral"}


def spec() -> dict:
    """BENCHMARK.json with the cells of `benchmark/pending/` merged in:
    cells built and tested here that BENCHMARK.json does not hold yet."""
    merged = json.loads((ROOT / "BENCHMARK.json").read_text())
    for path in sorted((ROOT / "benchmark" / "pending").glob("*.json")):
        for part, entries in json.loads(path.read_text()).items():
            merged[part] = merged[part] + entries
    return merged


def cells() -> list:
    return [w["name"] for w in spec()["workloads"]]


def joined(bench: dict, name: str, like: str) -> dict:
    """A copy of `bench` with one more cell, `name`, entered as the cell
    `like` is: its entry under the new name, and the new name beside
    `like`'s in the `workloads` of every metric that lists `like`."""
    out = copy.deepcopy(bench)
    out["workloads"].append({**cell(like, bench), "name": name})
    for m in out["end_to_end"] + out["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    return out


def cell(workload: str, bench: dict | None = None) -> dict:
    """The cell's entry in `bench` (default: `spec()`)."""
    return {w["name"]: w for w in (bench or spec())["workloads"]}[workload]


def traffic(workload: str, bench: dict | None = None) -> dict:
    """The cell's traffic file as it stands, unpatched."""
    return json.loads((ROOT / "benchmark" / "traffic" / f"{cell(workload, bench)['traffic']}.json").read_text())


def devices(workload: str, bench: dict | None = None) -> list:
    """One device for each device of the traffic's mesh, else for each of
    the cell's chips.  "cpu" and "cpu:0" alternate: they are two devices
    to the pool, so a mesh over them runs the scatter and gather of a mesh
    over cards."""
    mesh = traffic(workload, bench).get("mesh")
    n = math.prod(mesh.values()) if mesh else cell(workload, bench)["chips"]
    return [("cpu", "cpu:0")[i % 2] for i in range(n)]


def patch(workload: str, bench: dict | None = None) -> dict:
    """The traffic patch of the cell's tiny run: `tiny/<workload>.json`,
    else its driver's default.  A pool: 4 streams a device, 8 at least, a
    reservoir of 3 blocks, a count of checked streams cut to half the pool.
    A grid of files: 3 files of 2-4 s in chunks of 65536 samples, each
    warmed.  A sequence of clips, whose count has to outlast the runs, has
    no default."""
    path = SIZES / f"{workload}.json"
    if path.is_file():
        return json.loads(path.read_text())
    t = traffic(workload, bench)
    if t["driver"] == "pool":
        streams = max(8, 4 * len(devices(workload, bench)))
        check = {"reservoir": 3}
        if t["check"].get("streams", "all") != "all":
            check["streams"] = min(int(t["check"]["streams"]), streams // 2)
        return {"streams": streams, "check": check}
    if t["driver"] == "offline" and t["files"]["kind"] == "grid":
        return {"files": {"count": 3, "min_s": 2, "max_s": 4}, "upmixer": {"chunk": 65536}, "warm_calls": 3}
    raise ValueError(f"{workload}: no default tiny size for its traffic; give it {path.relative_to(ROOT)}")


def control_calls(workload: str, bench: dict | None = None) -> int:
    """Calls a seed in a tiny control run: 0 for a grid of files (the
    traffic's warm calls, one a file), 20 clips of a sequence, 40 blocks."""
    t = traffic(workload, bench)
    if t["driver"] == "offline":
        return 0 if t["files"]["kind"] == "grid" else 20
    return 40


def args(workload: str, seed: int = SEED, seconds: float = 0.3, trace: int = 0):
    from benchmark import run

    return run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)])


def result(workload: str, seed: int = SEED, seconds: float = 0.3, trace: int = 0, bench: dict | None = None,
           traffic_patch: dict | None = None) -> dict:
    """One tiny run's result on the CPU; `bench` stands in for the spec,
    `traffic_patch` for the cell's tiny patch."""
    from benchmark import run

    bench = bench or spec()
    return run.run(args(workload, seed, seconds, trace), devices=devices(workload, bench),
                   traffic_patch=patch(workload, bench) if traffic_patch is None else traffic_patch, spec=bench)


def control(workload: str, seed: int = 7, bench: dict | None = None, traffic_patch: dict | None = None) -> dict:
    """`benchmark/control.py`'s line for one seed of the cell at its tiny
    size: the program's and the control's `max_err`."""
    from benchmark import control as control_

    bench = bench or spec()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = control_.main(["--workload", workload, "--seeds", str(seed), "--calls", str(control_calls(workload, bench))],
                           devices=devices(workload, bench),
                           traffic_patch=patch(workload, bench) if traffic_patch is None else traffic_patch, spec=bench)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
