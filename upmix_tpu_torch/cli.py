"""Command-line interface of the port.

The same flags and defaults as `upmix_tpu/cli.py` (the reference's
edit-the-source constants of main.py:29-30,62-73 and
bela/upmix.cpp:24-29,525 as flags) for the modes that run on the ported
engines: offline (one or many files; `--mesh` over the devices of this
process, with the data-axis batch for many files), `--streaming`,
`--pipe`, the `--serve` job server, the `--serve-stream` multi-client
stream server (its pool in either OLA dataflow, `--pool-ola`, and on a
mesh, `--pool-mesh`) with its network client (`--connect`) and metrics
(`--fetch-metrics`, `--prometheus`, `--metrics-http`), and `--save-aot`
(a deployment artifact of the offline program, the streaming step or the
serving pool; load it with `upmix_tpu_torch.aot.load`).  `--device`
(default cuda) takes the place of the JAX package's platform choice and
of its `--kernel` flag: on the card the offline path runs the omnibus
kernel, `--mesh` the fused bucket kernel beside it, the streaming modes
and the stream server the pool kernel; `--engine native` runs the C++
host engine on the CPU instead.  Geometries no kernel takes
(`--overlap 0.65`, a non-power-of-two `--max-block-size`) run on
torch.fft, as the JAX CLI runs them on XLA.  `--no-compile-cache` builds
the kernels afresh into a temporary directory for this call.

Usage:
  python -m upmix_tpu_torch.cli song.wav [more.wav ...] --export-mode stereo_sum
  python -m upmix_tpu_torch.cli song.wav --device cpu      # the plain versions
  python -m upmix_tpu_torch.cli song.wav --overlap 0.65    # any overlap: torch.fft where no kernel fits
  python -m upmix_tpu_torch.cli song.wav --window-file w.npy   # a custom window vector (.npy or text)
  python -m upmix_tpu_torch.cli - --serve-stream 7000 --sr 48000
  python -m upmix_tpu_torch.cli song.wav --connect 127.0.0.1:7000
  python -m upmix_tpu_torch.cli - --save-aot pool.upmixaot --sr 48000 --aot-pool 2048 --aot-hops 4
"""

from __future__ import annotations

import argparse
import sys
import time

from upmix_tpu_torch.app import EXPORT_MODES, run_offline
from upmix_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="upmix_tpu_torch",
                                description="Multi-band stereo->LCR upmixer on PyTorch and CUDA")
    try:
        from importlib.metadata import version as _pkg_version

        _version = _pkg_version("upmix-tpu")
    except Exception:
        from upmix_tpu_torch import __version__ as _pkg_fallback

        _version = f"{_pkg_fallback} (uninstalled tree)"
    p.add_argument("--version", action="version", version=f"upmix-tpu-torch {_version}")
    p.add_argument("inputs", nargs="+", help="input WAV file(s)")
    p.add_argument("--out-dir", default="out", help="output directory (default: out)")
    p.add_argument("--export-mode", default="stereo_sum", choices=EXPORT_MODES,
                   help="AB (upmix-vs-original), split (3 stereo files), stereo_sum (Ls+C/2 | Rs+C/2); "
                   "default stereo_sum as in the reference main.py. With --streaming: stereo_sum or split")
    p.add_argument("--band-edges", default="0,30,120,480,1920,7680",
                   help="comma-separated crossover edges in Hz (reference default)")
    p.add_argument("--overlap", type=float, default=0.75, help="STFT overlap (default 0.75)")
    p.add_argument("--window", default="blackman_harris",
                   help="analysis window: blackman_harris, sqrt_hann, hann, blackman, hamming, rect, or a name "
                   "registered via upmix_tpu_torch.ops.windows.register_window (default blackman_harris)")
    p.add_argument("--window-file", default=None, metavar="FILE",
                   help="load a custom analysis-window VECTOR (.npy, or whitespace-separated text) and use it "
                   "instead of --window; it is linearly resampled to each band's block size")
    p.add_argument("--xover-mode", default="raised_cosine", choices=["raised_cosine", "hard_zero"],
                   help="band-edge treatment (default raised_cosine)")
    p.add_argument("--max-block-size", type=int, default=2**16, help="cap on per-band STFT size (default 65536)")
    p.add_argument("--threshold-factor", type=float, default=32.0,
                   help="dynamic-resolution threshold multiplier (default 32)")
    p.add_argument("--synthesis", default=None, choices=["wola", "analysis"],
                   help="synthesis window: WOLA-designed (Python parity) or plain analysis window (C++ "
                   "parity); default wola offline, analysis streaming")
    p.add_argument("--bin-rounding", default=None, choices=["python", "cpp"],
                   help="freq->bin rounding semantics; default python offline, cpp streaming")
    p.add_argument("--subtype", default="FLOAT", choices=["FLOAT", "DOUBLE", "PCM_16", "PCM_24", "PCM_32"],
                   help="output WAV sample format (default 32-bit float)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the kernels' plain versions)")
    p.add_argument("--chunk", type=int, default=None,
                   help="offline chunk size in samples (default 2097152; 0 = the whole-file torch.fft "
                   "program)")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="run the offline pipeline sharded over the visible CUDA devices (--device cuda) "
                   "or over --device repeated (e.g. cuda:0 or cpu: the shards run as rows of one launch): "
                   "'seq=N' splits the sample axis into N shards with halo exchange; "
                   "'data=D,seq=N' adds file-batch data parallelism (many input files ride the data axis "
                   "in one sharded call per sample rate).  Offline mode only")
    p.add_argument("--pad-granularity", type=int, default=None,
                   help="round input lengths up to a multiple of this to share programs across files "
                   "(default 1; --serve defaults to 65536)")
    p.add_argument("--streaming", action="store_true",
                   help="run the block-based streaming engine instead of the offline pipeline")
    p.add_argument("--hw-block", type=int, default=2048,
                   help="streaming hardware block size in samples (default 2048, the reference Bela config)")
    p.add_argument("--engine", default="torch", choices=["torch", "native"],
                   help="streaming engine: torch (the pool kernel on the card) or native (the C++ host shell on "
                   "the CPU; requires `make -C native`)")
    p.add_argument("--serve", action="store_true",
                   help='job-server mode: one JSON job per stdin line ({"in": path, "out_dir"?, '
                   '"export_mode"?} or {"cmd": "ping"|"stats"}), one JSON result per stdout line '
                   "(input must be '-')")
    p.add_argument("--pipe", action="store_true",
                   help="raw-PCM filter mode: interleaved float32 stereo on stdin -> processed float32 on "
                   "stdout (requires --sr; input must be '-')")
    p.add_argument("--sr", type=float, default=None, help="sample rate of the raw stdin stream (--pipe)")
    p.add_argument("--pipe-mix", default="stereo_sum", choices=["stereo_sum", "lcr"],
                   help="pipe output layout (default stereo_sum)")
    p.add_argument("--pipe-raw", action="store_true",
                   help="emit the raw real-time stream instead of the latency-aligned file-filter output")
    p.add_argument("--meter", action="store_true",
                   help="print the realtime factor (audio-sec per wall-sec) after each file")
    p.add_argument("--verbose", action="store_true", help="print per-band config table")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="build the CUDA kernels into a fresh temporary directory for this call instead of reusing "
                   "a cached library (upmix_tpu_torch/_build/, or $UPMIX_TORCH_BUILD_DIR)")
    p.add_argument("--serve-stream", type=int, default=None, metavar="PORT",
                   help="multi-client live-stream server: each TCP connection claims one slot of a shared serving "
                   "pool, one pool dispatch per hardware block serves every live session (requires --sr; port 0 "
                   "picks an ephemeral port; input must be '-')")
    p.add_argument("--streams", type=int, default=16, help="stream-server pool size (concurrent sessions; default 16)")
    p.add_argument("--serve-host", default="127.0.0.1", help="stream-server bind address (default 127.0.0.1)")
    p.add_argument("--lockstep", action="store_true",
                   help="stream-server dispatches when every live session has a block queued (deterministic, for "
                   "file-fed clients) instead of on the wall clock")
    p.add_argument("--pool-engine", choices=("auto", "cuda", "torch"), default="auto",
                   help="stream-server pool engine (default auto: the CUDA pool on the card when the config is "
                   "eligible, else the batched engine; both run the pool step)")
    p.add_argument("--pool-ola", choices=("time", "spectral"), default="time",
                   help="pool OLA dataflow: 'time' ([S, B] carries) or 'spectral' (the last frames' masked spectra); "
                   "the same function by two kernels")
    p.add_argument("--pool-mesh", default=None, metavar="SPEC",
                   help="with --serve-stream: split the session slots over a mesh, 'data=D' (--streams a multiple of "
                   "D; over the visible CUDA devices for --device cuda, else --device repeated D times); the pool is "
                   "the one --pool-engine names (auto: the batch pool)")
    p.add_argument("--pool-group", type=int, default=16,
                   help="the JAX pool's streams per TPU grid step: accepted and ignored (the card's pool has no group)")
    p.add_argument("--serve-hops", type=int, default=1, metavar="T",
                   help="stream-server temporal batching: dispatch T consecutive hardware blocks per pool cycle "
                   "(CUDA pool only), at T block deadlines of added input latency; lockstep clients must send >= T "
                   "blocks ahead")
    p.add_argument("--serve-pipeline", type=int, default=1, choices=(1, 2), metavar="D",
                   help="stream-server dispatch pipelining: 2 keeps one pool cycle in flight, delivering cycle N-1's "
                   "outputs while the card computes cycle N, at one cycle of added output latency")
    p.add_argument("--snapshot-path", default=None, metavar="PATH",
                   help="stream-server session checkpoint file: restored on start (sessions park until their "
                   "clients reconnect with their v2 resume tokens) and written on shutdown")
    p.add_argument("--snapshot-every", type=float, default=None, metavar="SECS",
                   help="with --snapshot-path: also checkpoint live sessions every SECS seconds (the capture pauses "
                   "dispatch while the pool state copies to the host)")
    p.add_argument("--resume-ttl", type=float, default=None, metavar="SECS",
                   help="stream-server parked-session time-to-live: a restored session whose client has not resumed "
                   "within SECS seconds may have its slot reclaimed when the pool is otherwise full (default: hold "
                   "parked sessions forever)")
    p.add_argument("--metrics-http", type=int, default=None, metavar="PORT",
                   help="with --serve-stream: serve metrics over HTTP on PORT (GET /metrics = Prometheus text, "
                   "/metrics.json = the full snapshot; 0 picks an ephemeral port)")
    p.add_argument("--connect", default=None, metavar="HOST:PORT",
                   help="network-client mode: stream the input WAV file(s) through a running --serve-stream server "
                   "instead of processing locally; --pipe-mix picks the returned layout, outputs land in --out-dir. "
                   "The file's sample rate must match the server's")
    p.add_argument("--fetch-metrics", default=None, metavar="HOST:PORT",
                   help="print a running --serve-stream server's metrics snapshot and exit (JSON by default, "
                   "Prometheus text with --prometheus)")
    p.add_argument("--prometheus", action="store_true",
                   help="with --fetch-metrics: print the Prometheus text exposition instead of JSON")
    p.add_argument("--save-aot", default=None, metavar="PATH",
                   help="write a deployment artifact for the active config and exit: the offline program frozen at "
                   "--aot-samples, the streaming step with --aot-stream, or the serving pool with --aot-pool "
                   "(requires --sr; input must be '-'; load with upmix_tpu_torch.aot.load)")
    p.add_argument("--aot-samples", type=int, default=2**21,
                   help="input length the offline artifact is frozen at (default 2097152, about 47.6 s at 44.1 kHz; "
                   "shorter inputs zero-pad)")
    p.add_argument("--aot-stream", action="store_true",
                   help="with --save-aot: the real-time streaming step (C++-parity defaults, --hw-block sized) "
                   "instead of the offline program")
    p.add_argument("--aot-pool", type=int, default=None, metavar="N_STREAMS",
                   help="with --save-aot: the serving-pool step for N concurrent streams (--hw-block sized, "
                   "--pool-ola dataflow) instead of the offline program")
    p.add_argument("--aot-hops", type=int, default=1, metavar="T",
                   help="with --save-aot --aot-pool: freeze the step of T consecutive hardware blocks per call (the "
                   "loaded pool serves through push_blocks_multi with [N, T*hw] inputs)")
    p.add_argument("--aot-platforms", default=None,
                   help="comma-separated platforms the artifact may load on: cuda and/or cpu (default: --device's)")
    return p


def parse_host_port(text: str, flag: str):
    """(host, port) of a HOST:PORT flag, with a CLI error otherwise."""
    host, _, port_s = text.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        port = -1
    if not host or not 0 < port < 65536:
        raise SystemExit(f"error: {flag} expects HOST:PORT, got {text!r}")
    return host, port


def parse_edges(text: str):
    try:
        edges = [float(x) for x in text.split(",") if x.strip() != ""]
    except ValueError:
        raise SystemExit(f"error: --band-edges must be comma-separated numbers, got {text!r}")
    if not edges:
        raise SystemExit("error: --band-edges is empty")
    if any(b <= a for a, b in zip(edges, edges[1:])):
        raise SystemExit("error: --band-edges must be ascending")
    if edges[0] < 0:
        raise SystemExit("error: --band-edges must be non-negative")
    return edges


def parse_mesh_spec(text: str):
    """Parse 'axis=N[,axis=N...]' into an ordered axis dict."""
    axes = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, num = part.partition("=")
        name = name.strip()
        try:
            n = int(num)
        except ValueError:
            n = 0
        if not eq or not name or n < 1:
            raise SystemExit(f"error: mesh spec must be 'axis=N[,axis=N]' with N >= 1, got {text!r}")
        if name in axes:
            raise SystemExit(f"error: duplicate mesh axis {name!r} in {text!r}")
        axes[name] = n
    if not axes:
        raise SystemExit("error: empty mesh spec")
    return axes


def build_mesh(text: str, device: str = "cuda", allowed=("data", "seq"), flag: str = "--mesh"):
    """A mesh from a CLI spec, with CLI-friendly errors: over the visible
    CUDA devices for --device cuda, else over `device` repeated (shards on
    one device run as rows of one launch)."""
    axes = parse_mesh_spec(text)
    bad = [a for a in axes if a not in allowed]
    if bad:
        raise SystemExit(f"error: {flag} axis must be one of {'/'.join(allowed)}, got {bad[0]!r}")
    from upmix_tpu_torch.parallel import make_mesh

    devices = None
    if device != "cuda":
        import math

        devices = [device] * math.prod(axes.values())
    try:
        return make_mesh(axes, devices=devices)
    except ValueError as e:
        raise SystemExit(f"error: {flag} {text!r}: {e}")


def load_window_file(path: str) -> str:
    """Load a window vector from FILE (.npy or text) and register it under
    a content-derived name, which it returns: two runs with the same file
    get the same name, and a changed file cannot reuse a plan built with
    the old one."""
    import hashlib

    import numpy as np

    from upmix_tpu_torch.ops.windows import is_known_window, register_window_vector

    vec = np.load(path) if path.endswith(".npy") else np.loadtxt(path, dtype=np.float64)
    vec = np.asarray(vec, np.float32).ravel()
    name = f"file:{hashlib.sha1(vec.tobytes()).hexdigest()[:10]}"
    if not is_known_window(name):
        register_window_vector(name, vec)
    return name


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.no_compile_cache:
        return _main(args)
    from upmix_tpu_torch.ops import _build

    with _build.fresh_build_dir():
        return _main(args)


def _main(args) -> int:
    if args.window_file is not None:
        try:
            args.window = load_window_file(args.window_file)
        except (OSError, ValueError) as e:
            raise SystemExit(f"error: --window-file {args.window_file!r}: {e}")
    else:
        # Validated here, after --window-file had its chance to register,
        # so that a typo is a one-line exit and not a traceback.
        from upmix_tpu_torch.ops.windows import is_known_window, window_names

        if not is_known_window(args.window):
            raise SystemExit(f"error: unknown --window {args.window!r}; one of {', '.join(sorted(window_names()))} "
                             "(or register one via --window-file / upmix_tpu_torch.ops.windows.register_window)")
    edges = parse_edges(args.band_edges)
    if args.mesh is not None and (args.pipe or args.streaming or args.serve or args.serve_stream is not None
                                  or args.connect is not None):
        raise SystemExit("error: --mesh applies to the offline pipeline only (use --pool-mesh with --serve-stream)")
    if args.pool_mesh is not None and args.serve_stream is None:
        raise SystemExit("error: --pool-mesh requires --serve-stream")
    if args.chunk is not None and args.chunk < 0:
        raise SystemExit("error: --chunk must be >= 0 (0 = whole-file)")
    if args.chunk is not None and args.mesh is not None:
        raise SystemExit("error: --chunk does not apply to --mesh runs (the sharded pipeline manages its own "
                         "chunking)")
    if args.pad_granularity is not None and args.pad_granularity < 1:
        raise SystemExit("error: --pad-granularity must be >= 1")
    try:
        return _run(args, edges)
    except NotImplementedError as e:
        raise SystemExit(f"error: {e}")


def _fetch_metrics(args) -> int:
    import json

    from upmix_tpu_torch.serve_stream import fetch_metrics

    host, port = parse_host_port(args.fetch_metrics, "--fetch-metrics")
    try:
        if args.prometheus:
            print(fetch_metrics(host, port, fmt="prometheus"), end="")
        else:
            print(json.dumps(fetch_metrics(host, port)))
    except (OSError, ConnectionError) as exc:
        raise SystemExit(f"error: {host}:{port}: {exc}")
    return 0


def _connect(args) -> int:
    """Stream each input WAV through a running --serve-stream server (no
    local pool work) and write the returned mix."""
    import os

    import numpy as np

    from upmix_tpu_torch.app import load_stereo
    from upmix_tpu_torch.io import write_wav
    from upmix_tpu_torch.serve_stream import stream_client

    if args.pipe or args.streaming or args.serve or args.serve_stream is not None:
        raise SystemExit("error: --connect is exclusive with --serve/--serve-stream/--pipe/--streaming")
    host, port = parse_host_port(args.connect, "--connect")
    if not args.inputs or args.inputs == ["-"]:
        raise SystemExit("error: --connect needs input WAV files")
    os.makedirs(args.out_dir, exist_ok=True)
    for path in args.inputs:
        L, R, sr, _peak = load_stereo(path)
        t0 = time.perf_counter()
        try:
            outs = stream_client(host, port, L.astype(np.float32), R.astype(np.float32), mix=args.pipe_mix,
                                 timeout=600.0, expect_sr=sr)
        except (OSError, ConnectionError, ValueError) as exc:
            raise SystemExit(f"error: {path}: {exc}")
        dt = time.perf_counter() - t0
        base = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.out_dir, f"{base}_net_{args.pipe_mix}.wav")
        write_wav(out_path, np.column_stack(outs), int(sr), subtype=args.subtype)
        n = len(outs[0])
        print(f"{path}: {n} frames via {host}:{port} in {dt:.2f}s ({n / sr / max(dt, 1e-9):.1f}x realtime) "
              f"-> {out_path}")
    return 0


def _save_aot(args, edges) -> int:
    """Write the --save-aot artifact and print its metadata line."""
    import json

    from upmix_tpu_torch import aot
    from upmix_tpu_torch.config import UpmixConfig

    if args.pipe or args.streaming or args.serve or args.serve_stream is not None:
        raise SystemExit("error: --save-aot is exclusive with --serve/--serve-stream/--pipe/--streaming")
    if args.sr is None or args.sr <= 0:
        raise SystemExit("error: --save-aot requires a positive --sr")
    if args.inputs != ["-"]:
        raise SystemExit("error: --save-aot takes no input files; pass '-'")
    platforms = None
    if args.aot_platforms:
        platforms = [s for s in args.aot_platforms.split(",") if s.strip()]
    if args.aot_stream and args.aot_pool is not None:
        raise SystemExit("error: --aot-stream and --aot-pool are exclusive")
    if args.aot_hops != 1 and args.aot_pool is None:
        raise SystemExit("error: --aot-hops requires --aot-pool")
    try:
        if args.aot_stream or args.aot_pool is not None:
            cfg = UpmixConfig.streaming(
                edges, sr=args.sr, hw_block_size=args.hw_block, window=args.window, xover_mode=args.xover_mode,
                threshold_factor=args.threshold_factor, synthesis=args.synthesis or "analysis",
                bin_rounding=args.bin_rounding or "cpp",
            )
            if args.aot_pool is not None:
                if args.aot_pool < 1:
                    raise SystemExit("error: --aot-pool must be >= 1 streams")
                if args.pool_group < 8:
                    raise SystemExit("error: --pool-group must be >= 8")
                if args.aot_hops < 1:
                    raise SystemExit("error: --aot-hops must be >= 1")
                meta = aot.save_stream_pool(args.save_aot, cfg, args.hw_block, args.aot_pool, group=args.pool_group,
                                            ola=args.pool_ola, hops=args.aot_hops, platforms=platforms,
                                            device=args.device)
            else:
                meta = aot.save_stream_step(args.save_aot, cfg, args.hw_block, platforms=platforms,
                                            device=args.device)
        else:
            if args.aot_samples < 1:
                raise SystemExit("error: --aot-samples must be >= 1")
            cfg = UpmixConfig.make(
                edges, sr=args.sr, overlap=args.overlap, window=args.window, xover_mode=args.xover_mode,
                max_block_size=args.max_block_size, threshold_factor=args.threshold_factor,
                synthesis=args.synthesis or "wola", bin_rounding=args.bin_rounding or "python",
            )
            meta = aot.save_offline(args.save_aot, cfg, args.aot_samples, device=args.device, chunk=args.chunk,
                                    platforms=platforms)
    except ValueError as exc:
        raise SystemExit(f"error: {exc}")
    print(json.dumps({"saved": args.save_aot, **{k: meta[k] for k in ("type", "platforms", "torch_version")}}))
    return 0


def _serve_stream(args, edges) -> int:
    """Serve until ^C or SIGTERM, then checkpoint to --snapshot-path."""
    import signal
    import threading

    from upmix_tpu_torch.serve_stream import run_stream_server

    if args.pipe or args.streaming or args.serve:
        raise SystemExit("error: --serve-stream is exclusive with --serve/--pipe/--streaming")
    if args.sr is None or args.sr <= 0:
        raise SystemExit("error: --serve-stream requires a positive --sr")
    if args.inputs != ["-"]:
        raise SystemExit("error: --serve-stream takes no input files; pass '-'")
    if args.streams < 1:
        raise SystemExit("error: --streams must be >= 1")
    if args.serve_hops < 1:
        raise SystemExit("error: --serve-hops must be >= 1")
    if args.snapshot_every is not None:
        if args.snapshot_path is None:
            raise SystemExit("error: --snapshot-every requires --snapshot-path")
        if args.snapshot_every <= 0:
            raise SystemExit("error: --snapshot-every must be > 0")
    pool_mesh = None
    if args.pool_mesh is not None:
        pool_mesh = build_mesh(args.pool_mesh, args.device, allowed=("data",), flag="--pool-mesh")
    try:
        server = run_stream_server(
            args.serve_stream, sr=args.sr, n_streams=args.streams, hw_block_size=args.hw_block, band_edges=edges,
            host=args.serve_host, lockstep=args.lockstep, window=args.window, xover_mode=args.xover_mode,
            threshold_factor=args.threshold_factor, synthesis=args.synthesis or "analysis",
            bin_rounding=args.bin_rounding or "cpp", engine=args.pool_engine, ola=args.pool_ola,
            group=args.pool_group, mesh=pool_mesh, snapshot_path=args.snapshot_path, snapshot_every=args.snapshot_every,
            metrics_http_port=args.metrics_http, hops=args.serve_hops, pipeline=args.serve_pipeline,
            resume_ttl=args.resume_ttl, device=args.device,
        )
    except ValueError as e:
        # Config-shape problems (pool eligibility, hops, band validation)
        # are user errors, not tracebacks.
        raise SystemExit(f"error: {e}")
    try:
        def _sigterm(*_args):  # a supervisor's restart checkpoints the sessions too
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _sigterm)
        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        pass
    finally:
        if args.snapshot_path is not None:
            n = server.save_checkpoint(args.snapshot_path)
            print(f"checkpointed {n} live sessions to {args.snapshot_path}", flush=True)
        server.close()
    return 0


def _run(args, edges) -> int:
    if args.fetch_metrics is not None:
        return _fetch_metrics(args)
    if args.prometheus:
        raise SystemExit("error: --prometheus requires --fetch-metrics")
    if args.connect is not None:
        return _connect(args)
    if args.save_aot is not None:
        return _save_aot(args, edges)
    if args.metrics_http is not None and args.serve_stream is None:
        raise SystemExit("error: --metrics-http requires --serve-stream")
    if args.serve_stream is not None:
        return _serve_stream(args, edges)
    offline = dict(
        band_edges=edges, overlap=args.overlap, window=args.window, xover_mode=args.xover_mode,
        max_block_size=args.max_block_size, threshold_factor=args.threshold_factor,
        synthesis=args.synthesis or "wola", bin_rounding=args.bin_rounding or "python", subtype=args.subtype,
    )
    streaming = dict(
        hw_block_size=args.hw_block, band_edges=edges, window=args.window, xover_mode=args.xover_mode,
        threshold_factor=args.threshold_factor, synthesis=args.synthesis or "analysis",
        bin_rounding=args.bin_rounding or "cpp", engine=args.engine, device=args.device,
    )
    if args.serve:
        from upmix_tpu_torch.app import run_jobs

        if args.pipe or args.streaming:
            raise SystemExit("error: --serve is exclusive with --pipe/--streaming")
        if args.inputs != ["-"]:
            raise SystemExit("error: --serve reads jobs from stdin; pass '-'")
        # A job server sees arbitrary lengths: bucket them by default.
        serve_pad = args.pad_granularity if args.pad_granularity is not None else 2**16
        n_ok, n_fail = run_jobs(sys.stdin, sys.stdout, out_dir=args.out_dir, export_mode=args.export_mode,
                                pad_granularity=serve_pad, chunk=args.chunk, device=args.device, **offline)
        # 0 when the stream was healthy (no jobs, or at least one success);
        # 1 when jobs came in and every one of them failed.
        return 1 if (n_fail and not n_ok) else 0

    if args.pipe:
        from upmix_tpu_torch.app import run_pipe

        if args.sr is None or args.sr <= 0:
            raise SystemExit("error: --pipe requires a positive --sr (raw PCM has no header)")
        if args.inputs != ["-"]:
            raise SystemExit("error: --pipe reads stdin; pass '-' as the input")
        try:
            run_pipe(sys.stdin, sys.stdout, sr=args.sr, mix=args.pipe_mix, align=not args.pipe_raw, **streaming)
        except BrokenPipeError:
            # Downstream closed early: exit quietly like a pipe filter, with
            # stdout on devnull so shutdown does not complain while flushing.
            import os

            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, sys.stdout.fileno())
        return 0

    if args.streaming:
        from upmix_tpu_torch.app import run_streaming

        if args.export_mode == "AB":
            raise SystemExit("error: --export-mode AB needs the original signal aligned with the upmix; the "
                             "streaming path supports stereo_sum or split")
        for path in args.inputs:
            t0 = time.perf_counter()
            result = run_streaming(path, out_dir=args.out_dir, subtype=args.subtype, export_mode=args.export_mode,
                                   verbose=args.verbose, **streaming)
            _report(args, result, path, t0)
            for out in result.paths:
                print(out)
        return 0

    # Offline: one Upmixer per config across the batch (with
    # --pad-granularity, files of similar length share programs too).
    upmixer_cache = {}
    mesh = build_mesh(args.mesh, args.device) if args.mesh is not None else None
    if mesh is not None and "data" in mesh.shape and len(args.inputs) > 1:
        # The files ride the data axis: one sharded call per sample rate.
        from upmix_tpu_torch.app import run_offline_batch

        t0 = time.perf_counter()
        try:
            results = run_offline_batch(args.inputs, mesh, out_dir=args.out_dir, export_mode=args.export_mode,
                                        verbose=args.verbose, **offline)
        except ValueError as e:
            raise SystemExit(f"error: {e}")
        if args.meter:
            wall = time.perf_counter() - t0
            audio = sum(r.audio_seconds for r in results)
            if wall > 0 and audio > 0:
                print(f"[batch x{len(results)}] {audio:.2f} audio-sec in {wall:.2f} s -> "
                      f"{audio / wall:.1f}x realtime")
        for result in results:
            for out in result.paths:
                print(out)
        return 0
    for path in args.inputs:
        t0 = time.perf_counter()
        try:
            result = run_offline(
                path, out_dir=args.out_dir, export_mode=args.export_mode,
                pad_granularity=args.pad_granularity if args.pad_granularity is not None else 1,
                upmixer_cache=upmixer_cache, mesh=mesh, chunk=args.chunk, verbose=args.verbose,
                device=args.device, **offline,
            )
        except ValueError as e:
            if mesh is None:
                raise
            raise SystemExit(f"error: {e}")  # sharded-geometry rejections are config errors
        _report(args, result, path, t0)
        for out in result.paths:
            print(out)
    return 0


def _report(args, result, path, t0) -> None:
    """Print the realtime factor (the duration comes from the result)."""
    if not args.meter:
        return
    wall = time.perf_counter() - t0
    audio = result.audio_seconds
    if wall > 0 and audio > 0:
        print(f"[{path}] {audio:.2f} audio-sec in {wall:.2f} s -> {audio / wall:.1f}x realtime")


if __name__ == "__main__":
    sys.exit(main())
