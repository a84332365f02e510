"""Tiny versions of every cell for CPU runs: the same configurations and
drivers, a few short files or streams, the kernels' plain versions."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PATCHES = {
    "offline_song": {"files": {"count": 3, "min_s": 2, "max_s": 4}, "upmixer": {"chunk": 65536}, "warm_calls": 3},
    "offline_clips": {"files": {"count": 400, "min_s": 0.5, "max_s": 2, "buffer_s": 5}, "check": {"reservoir": 4}},
    "pool_2048": {"streams": 8, "check": {"reservoir": 3}},
    "pool_mesh4_8192": {"streams": 16, "check": {"reservoir": 3, "streams": 8}},
}
# "cpu" and "cpu:0" are two devices to the pool: a mesh over them runs the
# scatter and gather of a mesh over cards.
DEVICES = {"pool_mesh4_8192": ["cpu", "cpu:0", "cpu", "cpu:0"]}
SEED = 2147483661  # past 31 bits: seeds reach a little over 2**31


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


def devices(workload: str) -> list:
    return DEVICES.get(workload, ["cpu"])


def args(workload: str, seed: int = SEED, seconds: float = 0.3, trace: int = 0):
    from benchmark import run

    return run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)])


def result(workload: str, seed: int = SEED, seconds: float = 0.3, trace: int = 0) -> dict:
    """One tiny run's result on the CPU."""
    from benchmark import run

    return run.run(args(workload, seed, seconds, trace), devices=devices(workload), traffic_patch=PATCHES[workload],
                   spec=spec())
