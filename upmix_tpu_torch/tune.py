"""On-device tuner of the serving pool and of the offline chunk.

Port of `upmix_tpu/tune.py`, with its entry points (`tune_pool`,
`tune_offline`, `main`), its report keys and its protocol:

- Candidates are visited round-robin and each keeps the minimum over its
  visits, so a burst of noise on the host lands on one visit of one
  candidate instead of on a whole candidate.
- Each visit times dependency-chained steps (the pool's carried state
  chains its blocks; offline, a scalar of each output seeds the next
  input) on inputs that were made on the device once per candidate,
  outside the clock.  On the card the clock is a pair of CUDA events
  around the chain; on the CPU, the host's.
- A candidate that fails to build is recorded with its error and left
  out of `best`: mapping what is feasible is part of the sweep.
- `transport_floor_seconds` is the least time of a trivial device step
  fetched to the host, the per-dispatch cost every candidate pays.

The pool's protocols (`protocol=`):

- "dispatch": `blocks` chained `push_blocks` (or `push_blocks_multi` at
  hops > 1) on device-resident inputs, the deployment's dispatch surface
  with its host cost per block.
- "scan": `make_sustained_runner`, the steps of one visit queued with no
  host synchronisation per block: the card's capacity.
- "lockstep": the stream server's cycle, host inputs in and all three
  outputs fetched to the host every cycle (timed on the host's clock,
  the transfers included); `pipelines` = 2 fetches each cycle's outputs
  after launching the next, as StreamServer(pipeline=2) does.

What the TPU tuner swept and the card's pool does not have is gone: no
`groups` (the JAX pool's streams per grid step), no `layout` (its
history layouts) and no `unroll` (steps per scan iteration); the OLA
dataflow is swept instead.  Usage, on the card:

    python -m upmix_tpu_torch.tune --batches 1024,2048 --ola time,spectral \\
        --hops 1,4 --protocol scan
    python -m upmix_tpu_torch.tune --offline --chunks 524288,1048576,2097152,4194304
"""

from __future__ import annotations

import time

import torch

__all__ = ["tune_pool", "tune_offline"]


class _Clock:
    """Seconds of the work between start() and stop(): CUDA events on the
    current stream of a CUDA device (the card that does the work, whichever
    device is current), the host's clock elsewhere."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def start(self):
        if self.cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
            self._a.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._b.record(torch.cuda.current_stream(self.device))
            self._b.synchronize()
            return self._a.elapsed_time(self._b) / 1e3
        return time.perf_counter() - self._t0


def _as_tuple(v, cast=str):
    return (cast(v),) if isinstance(v, (str, int)) else tuple(cast(x) for x in v)


def _transport_floor(device) -> float:
    """Least wall seconds of a trivial step on the device, fetched to the host."""
    x = torch.zeros((), device=device)
    float(x + 1.0)  # off the clock: first use
    floors = []
    for _ in range(5):
        t0 = time.perf_counter()
        float(x + 1.0)
        floors.append(time.perf_counter() - t0)
    return min(floors)


def tune_pool(
    config,
    hw_block: int,
    batch_sizes=(512, 1024, 2048, 4096),
    engine: str = "cuda",
    ola="time",
    blocks: int = 16,
    visits: int = 3,
    include_torch: bool = False,
    protocol: str = "dispatch",
    hops=(1,),
    pipelines=(1,),
    device="cuda",
    verbose: bool = True,
) -> dict:
    """Sweep serving-pool candidates on `device`: every batch size (pool
    streams), OLA dataflow (`ola`, one mode or several), hops (temporal
    batching: blocks a step) and pipeline depth (lockstep only), on
    `engine` ("cuda", "torch" or "auto", as `make_stream_pool` takes
    it), plus one "torch" candidate per batch size with
    `include_torch`.  The batch pool has neither an OLA mode nor a
    multi-hop step: a candidate that resolves to it is timed once per
    batch size and pipeline, and a multi-hop one is recorded as
    infeasible.  Hops that do not divide `blocks` are skipped.

    Capacity: a pool of B streams at t seconds a block serves B * (hw /
    sr) / t streams in real time.  Returns {"results": [...], "best":
    {...} | None, "protocol": {..., "transport_floor_seconds": ...}}."""
    from upmix_tpu_torch.models.streaming import make_stream_pool

    hw_block = int(hw_block)
    block_seconds = hw_block / float(config.sr)
    if protocol not in ("dispatch", "scan", "lockstep"):
        raise ValueError(f"unknown protocol {protocol!r}; one of ('dispatch', 'scan', 'lockstep')")
    pipelines = _as_tuple(pipelines, int)
    if any(p not in (1, 2) for p in pipelines):
        raise ValueError(f"pipelines entries must be 1 or 2, got {pipelines}")
    hops = _as_tuple(hops, int)
    if not hops or any(t < 1 for t in hops):
        raise ValueError(f"hops entries must be >= 1, got {hops}")
    if protocol != "lockstep" and pipelines != (1,):
        raise ValueError(
            "pipelines is a lockstep-protocol knob (the scan and dispatch protocols already queue "
            f"their steps); got pipelines={pipelines} with protocol={protocol!r}"
        )
    olas = _as_tuple(ola)
    device = torch.device(device)
    clock = _Clock(device)

    candidates = []
    for b in batch_sizes:
        if engine == "torch":
            for pp in pipelines:
                candidates.append({"batch": int(b), "engine": "torch", "ola": None, "hops": 1, "pipeline": pp})
        else:
            for o in olas:
                for t in hops:
                    if int(blocks) % t:
                        continue  # a visit covers whole steps
                    for pp in pipelines:
                        candidates.append({"batch": int(b), "engine": engine, "ola": o, "hops": t, "pipeline": pp})
        if include_torch and engine != "torch":
            for pp in pipelines:
                candidates.append({"batch": int(b), "engine": "torch", "ola": None, "hops": 1, "pipeline": pp})

    built, results = [], []
    seen_plain = set()  # (batch, pipeline) of candidates that resolved to the batch pool
    scan_inputs = {}  # (batch, hops) -> device slabs [blocks // hops, 2, batch, hops * hw]
    pools = {}  # (engine, batch, ola, hops) -> (pool, push, xl, xr): pipelines share a build
    for cand in candidates:
        T, P = cand["hops"], cand["pipeline"]
        label = (f"{cand['engine']}/B{cand['batch']}" + (f"/{cand['ola']}" if cand["ola"] else "")
                 + (f"/T{T}" if T > 1 else "") + (f"/P{P}" if P > 1 else ""))
        rec = dict(cand, label=label, ok=False, error=None, seconds_per_block=None, us_per_block_stream=None,
                   streams_per_chip=None)
        results.append(rec)
        key = (cand["engine"], cand["batch"], cand["ola"], T)
        if key in pools:
            rec["visits"] = []
            built.append((rec, pools[key]))
            continue
        try:
            pool = make_stream_pool(config, hw_block, cand["batch"], engine=cand["engine"], device=device,
                                    ola=cand["ola"] or "time")
            if not hasattr(pool, "ola"):
                # The batch pool: no OLA mode and no multi-hop step.
                if T > 1:
                    rec["error"] = "infeasible: resolved engine has no multi-hop (temporal batching) step"
                    continue
                if (cand["batch"], P) in seen_plain:
                    rec["error"] = "duplicate: resolved engine has no OLA mode"
                    continue
                seen_plain.add((cand["batch"], P))
                rec["ola"] = None
            if protocol == "scan":
                run, fresh = pool.make_sustained_runner(blocks, hops=T)
                slab = scan_inputs.get((cand["batch"], T))
                if slab is None:
                    base = scan_inputs.get((cand["batch"], 1))
                    if base is None:
                        gen = torch.Generator(device).manual_seed(cand["batch"])
                        base = torch.randn((blocks, 2, cand["batch"], hw_block), device=device, generator=gen) * 0.3
                        scan_inputs[(cand["batch"], 1)] = base
                    # Every depth consumes the same samples, regrouped T blocks a step.
                    slab = (base.reshape(blocks // T, T, 2, cand["batch"], hw_block).permute(0, 2, 3, 1, 4)
                            .reshape(blocks // T, 2, cand["batch"], T * hw_block).contiguous())
                    scan_inputs[(cand["batch"], T)] = slab
                run(fresh(), slab)  # warm: first launches and allocations off the clock
                entry = ((run, fresh), slab, None)
            else:
                push = pool.push_blocks_multi if T > 1 else pool.push_blocks
                gen = torch.Generator(device).manual_seed(len(built))
                x = torch.randn((2, cand["batch"], T * hw_block), device=device, generator=gen) * 0.3
                c, _, _ = push(x[0], x[1])
                float(c[0, 0])  # warm, off the clock
                if protocol == "lockstep":
                    # Host inputs on purpose: the server uploads each cycle's blocks.
                    xh = x.cpu().numpy()
                    entry = ((pool, push), xh[0], xh[1])
                else:
                    entry = ((pool, push), x[0], x[1])
        except Exception as e:  # a candidate that does not build: recorded, not raised
            rec["error"] = f"{type(e).__name__}: {e}"
            if verbose:
                print(f"tune: {label}: FAILED ({type(e).__name__})", flush=True)
            continue
        rec["visits"] = []
        built.append((rec, entry))
        pools[key] = entry

    transport_floor = _transport_floor(device) if built else None

    for v in range(int(visits)):
        for rec, (fns, xl, xr) in built:
            T, P = rec["hops"], rec["pipeline"]
            if protocol == "scan":
                run, fresh = fns
                st = fresh()  # allocated off the clock
                clock.start()
                run(st, xl)
                dt = clock.stop() / int(blocks)
            elif protocol == "lockstep":
                _, push = fns
                pending = ()
                t0 = time.perf_counter()
                for _ in range(int(blocks) // T):
                    out = push(xl, xr)
                    # P = 2 fetches a cycle's outputs after launching the next.
                    fetch, pending = (pending, out) if P > 1 else (out, ())
                    for o in fetch:
                        o.cpu()
                for o in pending:
                    o.cpu()
                dt = (time.perf_counter() - t0) / int(blocks)
            else:
                _, push = fns
                clock.start()
                for _ in range(int(blocks) // T):
                    push(xl, xr)
                dt = clock.stop() / int(blocks)
            rec["visits"].append(dt)
            if verbose:
                print(f"tune: visit {v} {rec['label']:>24s}: {dt * 1e3:8.3f} ms/block", flush=True)

    best = None
    for rec in results:
        if rec.get("visits"):
            t = min(rec["visits"])
            rec["ok"] = True
            rec["seconds_per_block"] = t
            rec["us_per_block_stream"] = t / rec["batch"] * 1e6
            rec["streams_per_chip"] = rec["batch"] * block_seconds / t
            if best is None or rec["streams_per_chip"] > best["streams_per_chip"]:
                best = rec
        rec.pop("visits", None)
    if verbose and transport_floor is not None:
        print(f"tune: transport floor {transport_floor * 1e3:.3f} ms (trivial step + fetch)", flush=True)
    if verbose and best is not None:
        print(f"tune: best {best['label']}: {best['streams_per_chip']:.0f} realtime streams "
              f"({best['us_per_block_stream']:.3f} us/block/stream)", flush=True)
    return {
        "results": results,
        "best": best,
        "protocol": {"name": protocol, "blocks": int(blocks), "visits": int(visits), "hops": list(hops),
                     "pipelines": list(pipelines), "ola": list(olas), "device": str(device),
                     "estimator": "min-of-visits, interleaved", "transport_floor_seconds": transport_floor},
    }


def tune_offline(
    config=None,
    *,
    sr: float = 44100.0,
    band_edges=(0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0),
    max_block_size: int = 2**16,
    n_samples: int = 2**21,
    chunks=(2**19, 2**20, 2**21, 2**22),
    inner: int = 6,
    visits: int = 3,
    device="cuda",
    verbose: bool = True,
) -> dict:
    """Sweep the offline path's chunk on `device`: each candidate is
    `Upmixer(config, chunk=c)` on n_samples of seeded noise, timed over
    `inner` applications chained in one visit (a scalar of each output
    seeds the next input), interleaved, min of visits; best by realtime
    factor (audio seconds per second).  chunk=0 is the whole-file
    torch.fft program.  A config the geometry routes to the whole-file
    program (`models/offline.py::kernel_config`) builds one candidate and
    records the rest as duplicates, and chunks at or past the input
    length, which all clamp to one segment, build the first of them only.

    Returns {"results": [...], "best": {...} | None, "protocol": {...}}."""
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.offline import Upmixer, kernel_config

    if config is None:
        config = UpmixConfig.make(list(band_edges), sr=sr, max_block_size=max_block_size)
    if inner < 1 or visits < 1:
        raise ValueError("inner and visits must be >= 1")
    device = torch.device(device)
    clock = _Clock(device)
    chunk_active = kernel_config(config)
    if not chunk_active and verbose:
        print("tune: the geometry routes this config to the whole-file program: every candidate is that "
              "program; building one", flush=True)
    gen = torch.Generator(device).manual_seed(0)
    L = torch.randn(n_samples, device=device, generator=gen)
    R = torch.randn(n_samples, device=device, generator=gen)

    results, built = [], []
    first_label = clamped_label = None
    for c in chunks:
        c = int(c)
        label = "whole" if c == 0 else f"chunk={c}"
        rec = {"chunk": c, "label": label, "ok": False}
        results.append(rec)
        if not chunk_active and first_label is not None:
            rec["error"] = f"chunking inactive — identical program to {first_label}"
            continue
        clamps = chunk_active and c >= n_samples
        if clamps and clamped_label is not None:
            rec["error"] = f"clamps to the input length — duplicate of {clamped_label}"
            continue
        try:
            if c < 0:
                raise ValueError(f"chunk must be >= 0, got {c}")
            up = Upmixer(config, device=device, chunk=c)

            def step(up=up):
                seed = torch.zeros((), device=device)
                for _ in range(inner):
                    cc, _ls, _rs = up.process(L + seed, R - seed)
                    seed = cc[0] * 1e-6
                return seed

            float(step())  # first launches and allocations, off the clock
        except Exception as e:  # a candidate that does not build: recorded, not raised
            rec["error"] = f"{type(e).__name__}: {e}"
            if verbose:
                print(f"tune: {label} infeasible: {rec['error']}", flush=True)
            continue
        if clamps:
            clamped_label = label  # only once the candidate has built
        rec["visits"] = []
        built.append((rec, step))
        if first_label is None:
            first_label = label

    for _ in range(int(visits)):
        for rec, step in built:
            clock.start()
            step()
            rec["visits"].append(clock.stop() / int(inner))

    audio_seconds = n_samples / float(config.sr)
    best = None
    for rec in results:
        if rec.get("visits"):
            t = min(rec["visits"])
            rec["ok"] = True
            rec["seconds_per_application"] = t
            rec["realtime_factor"] = audio_seconds / t
            if best is None or rec["realtime_factor"] > best["realtime_factor"]:
                best = rec
        rec.pop("visits", None)
        if verbose and rec["ok"]:
            print(f"tune: {rec['label']}: {rec['realtime_factor']:.1f}x realtime "
                  f"({rec['seconds_per_application'] * 1e3:.3f} ms per {audio_seconds:.1f} s of audio)", flush=True)
    if verbose and best is not None:
        print(f"tune: best {best['label']}: {best['realtime_factor']:.1f}x realtime", flush=True)
    return {
        "results": results,
        "best": best,
        "protocol": {"name": "offline", "n_samples": int(n_samples), "inner": int(inner), "visits": int(visits),
                     "chunk_active": chunk_active, "device": str(device),
                     "estimator": "min-of-visits, interleaved"},
    }


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="upmix_tpu_torch.tune",
        description="tune the serving pool (batch, OLA dataflow, hops, pipeline) or, with --offline, the "
        "offline path's chunk on the attached device",
    )
    ap.add_argument("--offline", action="store_true",
                    help="tune the offline chunk instead of the serving pool (--chunks/--samples/--inner; --sr "
                    "defaults to 44100 and --edges to the reference offline config in this mode)")
    ap.add_argument("--chunks", default="524288,1048576,2097152,4194304",
                    help="offline mode: chunk sizes, comma-separated (0 = the whole-file program)")
    ap.add_argument("--samples", type=int, default=2**21, help="offline mode: input length per application")
    ap.add_argument("--inner", type=int, default=6, help="offline mode: applications chained per visit")
    ap.add_argument("--max-block-size", type=int, default=2**16, help="offline mode: per-band STFT size cap")
    ap.add_argument("--sr", type=float, default=None)
    ap.add_argument("--hw-block", type=int, default=2048)
    ap.add_argument("--edges", default=None,
                    help="band edges in Hz, comma-separated (default: 0,500,2000,8000 for the pool; the reference "
                    "offline 6-band config with --offline)")
    ap.add_argument("--batches", default="512,1024,2048,4096")
    ap.add_argument("--engine", default="cuda", choices=("cuda", "torch", "auto"))
    ap.add_argument("--ola", default="time", help="OLA dataflows to sweep, comma-separated (time, spectral)")
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--visits", type=int, default=3)
    ap.add_argument("--include-torch", action="store_true", help="add a batch-pool candidate per batch size")
    ap.add_argument("--protocol", default="dispatch", choices=("dispatch", "scan", "lockstep"),
                    help="dispatch = chained push_blocks; scan = the sustained runner (the card's capacity); "
                    "lockstep = the server's cycle with host inputs and all outputs fetched")
    ap.add_argument("--hops", default="1", help="temporal batching depths, comma-separated")
    ap.add_argument("--pipelines", default="1", help="pipelined-dispatch depths, comma-separated (lockstep only)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--json", action="store_true", help="print the full report as one JSON line")
    args = ap.parse_args(argv)

    from upmix_tpu_torch.config import UpmixConfig

    if args.offline:
        report = tune_offline(
            sr=args.sr if args.sr is not None else 44100.0,
            band_edges=[float(e) for e in (args.edges or "0,30,120,480,1920,7680").split(",")],
            max_block_size=args.max_block_size, n_samples=args.samples,
            chunks=[int(c) for c in args.chunks.split(",")], inner=args.inner, visits=args.visits,
            device=args.device, verbose=not args.json,
        )
    else:
        config = UpmixConfig.streaming(
            [float(e) for e in (args.edges or "0,500,2000,8000").split(",")],
            sr=args.sr if args.sr is not None else 48000.0, hw_block_size=args.hw_block,
        )
        report = tune_pool(
            config, args.hw_block, batch_sizes=[int(b) for b in args.batches.split(",")], engine=args.engine,
            ola=args.ola.split(","), blocks=args.blocks, visits=args.visits, include_torch=args.include_torch,
            protocol=args.protocol, hops=[int(t) for t in args.hops.split(",")],
            pipelines=[int(p) for p in args.pipelines.split(",")], device=args.device, verbose=not args.json,
        )
    if args.json:
        print(json.dumps(report))
    elif report["best"] is None:
        print("tune: no candidate built", flush=True)
    # A sweep where every candidate failed is a failure in either output format.
    return 0 if report["best"] is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
