"""Run one cell of the benchmark once and print one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration file and its traffic file are found by name
through BENCHMARK.json at the root of the checkout.  The run makes its
inputs from the seed, builds the program under test
(`upmix_tpu_torch`) and warms every shape the traffic uses (the set-up),
measures for `--seconds` (`--trace 1`: under torch.profiler), frees the
program, checks the kept outputs against the float64 reference under
`benchmark/reference/`, and prints the result as its last line of
standard output; the numbers compared, each beside its limit, are the
last lines of standard error and the last key of the result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own: `configs/<config>.json`, `traffic/<traffic>.json` (whose
`driver` names a module of `drivers/`), `end_to_end/<metric>.py` and
`layers/<metric>.py`, each with a `read(ctx)` that returns a number or
None.  Exit codes: 0 with a result; 2 without the CUDA devices the cell
asks for; 3 when a JAX module was loaded; anything else on a failure.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".bench_cache"  # the program's kernel caches, at fixed paths in the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "upmix_tpu")

if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@dataclass
class Context:
    """What a metric reader gets: the window, the trace (traced runs), the session."""

    window: object
    trace: object
    session: object


def cache_env():
    for var, sub in (("UPMIX_TORCH_BUILD_DIR", "kernels"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        (CACHE / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merged(base: dict, patch: dict | None) -> dict:
    out = dict(base)
    for k, v in (patch or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def reader(kind: str, name: str):
    """The `read` function of `<kind>/<name>.py`."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def port_config(cfg: dict):
    """The program's configuration object for a configuration file."""
    from upmix_tpu_torch.config import UpmixConfig

    common = {k: cfg[k] for k in ("window", "xover_mode", "threshold_factor", "xo_fraction", "synthesis",
                                  "bin_rounding")}
    if cfg["constructor"] == "make":
        return UpmixConfig.make(cfg["band_edges"], cfg["sr"], overlap=cfg["overlap"],
                                max_block_size=cfg["max_block_size"], **common)
    return UpmixConfig.streaming(cfg["band_edges"], cfg["sr"], cfg["hw_block_size"], **common)


def metrics_of(spec: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "not read"


def run(args, devices=None, traffic_patch=None, spec=None) -> dict | None:
    """One run; returns the result, or None (and says why on stderr) when
    the cell cannot run here.  `spec` stands in for BENCHMARK.json."""
    import torch

    spec = spec or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"run: no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    if devices is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell["chips"]:
            print(f"run: {args.workload} needs {cell['chips']} CUDA device(s), found {found}", file=sys.stderr)
            return None
        devices = [f"cuda:{i}" for i in range(cell["chips"])]
    cache_env()
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(ROOT / config["file"])
    traffic = merged(load_json(HERE / "traffic" / f"{cell['traffic']}.json"), traffic_patch)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    session = driver.Session(cfg, traffic, args.seed, devices, port_config(cfg))
    session.build()
    setup_s = time.perf_counter() - T0
    cuda = session.device.type == "cuda"

    trace = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        from benchmark.trace import record_span, reduce

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            window = session.run(seconds=args.seconds, span=record_span)
        trace = reduce(prof, session.cards)
    else:
        window = session.run(seconds=args.seconds)

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(session.device) if cuda else "cpu",
              "count": len(session.cards),
              "memory_peak_bytes": max(torch.cuda.max_memory_allocated(c) for c in session.cards) if cuda else 0}
    if trace is not None:
        device["busy_s"] = trace.busy_mean_s()
        device["window_s"] = trace.window_s

    ctx = Context(window, trace, session)
    wanted = metrics_of(spec, args.workload, bool(args.trace))
    metrics = {}
    if not args.trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    for m in wanted:
        if m["name"] == "setup_s":
            continue
        value = reader("layers" if args.trace else "end_to_end", m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    session.release()
    from benchmark.reference.core import Reference

    numbers = session.compare(Reference(cfg, device=session.device))
    limits = traffic["check"]["limits"]
    # A number that is not finite fails its limit; JSON has no spelling for it.
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else 1e308, "limit": limits[k]} for k in limits}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(window.calls),
        "failed": 0,
        "metrics": metrics,
        "device": device,
    }
    if trace is not None:
        from benchmark.trace import breakdown

        result["breakdown"] = breakdown(trace)
    result["info"] = {"workload": args.workload, "seed": args.seed, "window_s": window.seconds,
                      "calls": len(window.calls), "setup_s": setup_s,
                      "card": power_limit() if cuda else "cpu"}
    result["checks"] = checks
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, devices=None, traffic_patch=None) -> int:
    args = parse(argv)
    result = run(args, devices=devices, traffic_patch=traffic_patch)
    if result is None:
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"run: the process loaded {', '.join(bad)}; nothing of JAX or the JAX package may run", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
