"""Readings that set a cell's limits: the program's and the control's
numbers on many seeds, at the cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--calls N] [--only program|control]

For each seed the cell's session is made as a run makes it, the program
runs `--calls` calls through the timed path (without a window), and the
kept outputs are compared with the float64 reference: the program's
reading.  Then the reference itself, in float32 with every transform's
operands rounded to TF32 (`reference.core.tf32`), is put in the
program's place on the same inputs: the control's reading.  One JSON
line a seed.  The benchmark's own runs never run this.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)


def main(argv=None, devices=None, traffic_patch=None, spec=None) -> int:
    import argparse
    import importlib

    import torch

    from benchmark import run
    from benchmark.reference.core import Reference, tf32

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--calls", type=int, default=0, help="calls a seed (0: the traffic's warm_calls, else 300)")
    p.add_argument("--only", choices=("program", "control"))
    args = p.parse_args(argv)

    spec = spec or run.load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in spec["workloads"]}[args.workload]
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"control: {args.workload} needs {cell['chips']} CUDA device(s)", file=sys.stderr)
            return 2
        devices = [f"cuda:{i}" for i in range(cell["chips"])]
    run.cache_env()
    cfg = run.load_json(ROOT / {c["name"]: c for c in spec["configs"]}[cell["config"]]["file"])
    traffic = run.merged(run.load_json(ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json"), traffic_patch)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    calls = args.calls or (int(traffic["warm_calls"]) if traffic["driver"] == "offline" and
                           traffic["files"]["kind"] == "grid" else 300)
    port = run.port_config(cfg)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        session = driver.Session(cfg, traffic, seed, devices, port)
        session.build()
        session.run(calls=calls)
        session.release()
        exact = Reference(cfg, device=session.device)
        line = {"workload": args.workload, "seed": seed, "calls": calls, "kept": len(session.samples)}
        if args.only != "control":
            line["program"] = session.compare(exact)
        if args.only != "program":
            control = Reference(cfg, device=session.device, dtype=torch.float32, rounding=tf32)
            line["control"] = session.compare(exact, session.control_samples(control))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del session
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
