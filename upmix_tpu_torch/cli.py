"""Command-line interface of the port.

The same flags and defaults as `upmix_tpu/cli.py` (the reference's
edit-the-source constants of main.py:29-30,62-73 and
bela/upmix.cpp:24-29,525 as flags) for the modes that run on the ported
engines: offline (one or many files; `--mesh` over the devices of this
process, with the data-axis batch for many files), `--streaming`,
`--pipe` and the `--serve` job server.  `--device` (default cuda) takes
the place of the JAX package's platform choice and of its `--kernel`
flag: on the card the offline path runs the omnibus kernel, `--mesh`
the fused bucket kernel beside it, the streaming modes the pool kernel.
Flags of modes that are not ported yet exit with a one-line error.

Usage:
  python -m upmix_tpu_torch.cli song.wav [more.wav ...] --export-mode stereo_sum
  python -m upmix_tpu_torch.cli song.wav --device cpu      # the plain versions
"""

from __future__ import annotations

import argparse
import sys
import time

from upmix_tpu_torch.app import EXPORT_MODES, run_offline
from upmix_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Flags of the JAX CLI whose modes are not ported yet (ROADMAP.md, Queue 1).
NOT_PORTED = {
    "serve_stream": ("--serve-stream", "the multi-client stream server"),
    "connect": ("--connect", "the stream server's network client"),
    "fetch_metrics": ("--fetch-metrics", "the stream server's metrics"),
    "prometheus": ("--prometheus", "the stream server's metrics"),
    "metrics_http": ("--metrics-http", "the stream server's metrics"),
    "save_aot": ("--save-aot", "AOT artifacts"),
    "load_aot": ("--load-aot", "AOT artifacts"),
    "pool_mesh": ("--pool-mesh", "the serving pool on a mesh"),
    "window_file": ("--window-file", "custom windows"),
}


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
                   help="analysis window: blackman_harris, sqrt_hann, hann, blackman, hamming or rect "
                   "(default blackman_harris)")
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
                   help="streaming engine: torch (the pool kernel on the card); native (the C++ host "
                   "shell) is not ported")
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
    for dest, (flag, _what) in NOT_PORTED.items():
        if dest == "prometheus":
            p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
        else:
            p.add_argument(flag, dest=dest, default=None, help=argparse.SUPPRESS)
    return p


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


def build_mesh(text: str, device: str = "cuda"):
    """A --mesh from a CLI spec, with CLI-friendly errors: over the visible
    CUDA devices for --device cuda, else over `device` repeated (shards on
    one device run as rows of one launch)."""
    axes = parse_mesh_spec(text)
    bad = [a for a in axes if a not in ("data", "seq")]
    if bad:
        raise SystemExit(f"error: --mesh axis must be one of data/seq, got {bad[0]!r}")
    from upmix_tpu_torch.parallel import make_mesh

    devices = None
    if device != "cuda":
        import math

        devices = [device] * math.prod(axes.values())
    try:
        return make_mesh(axes, devices=devices)
    except ValueError as e:
        raise SystemExit(f"error: --mesh {text!r}: {e}")


def _check_not_ported(args):
    for dest, (flag, what) in NOT_PORTED.items():
        if getattr(args, dest):
            raise SystemExit(f"error: {flag} ({what}) is not ported to upmix_tpu_torch yet; "
                             "use the JAX package's CLI (python -m upmix_tpu.cli)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _check_not_ported(args)
    from upmix_tpu_torch.ops.windows import BUILTIN_WINDOWS

    if args.window not in BUILTIN_WINDOWS:
        raise SystemExit(f"error: unknown --window {args.window!r}; one of {', '.join(sorted(BUILTIN_WINDOWS))}")
    if args.engine == "native":
        raise SystemExit("error: --engine native (the C++ host shell) is not ported to upmix_tpu_torch; "
                         "use --engine torch")
    edges = parse_edges(args.band_edges)
    if args.mesh is not None and (args.pipe or args.streaming or args.serve):
        raise SystemExit("error: --mesh applies to the offline pipeline only")
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


def _run(args, edges) -> int:
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
