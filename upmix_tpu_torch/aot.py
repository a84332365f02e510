"""Deployment artifacts of the port: a config-specialized program frozen
to one file that a serving host loads and calls.

The port's counterpart of `upmix_tpu/aot.py`, with the same container:
the `UPMIXAOT1\\n` magic, one JSON metadata line, then the payload, so
`read_meta` reads either package's files.  The metadata carries the JAX
keys that mean something here (format, type, the full band-resolved
config with its custom windows, the shapes, ola, hops, platforms) and,
in place of `jax_version`, `torch_version` and the kernel library's
`ops._build.library_key()`.

The payload differs.  The JAX package serializes the traced program
(jax.export StableHLO); the port's programs launch its CUDA kernels
through ctypes, which `torch.export` cannot trace.  So the payload is
what the program is built from: the plan's host-side tables (each
bucket's geometry, windows, gains and one-block FFT twiddles), written
with `np.savez`.  A load rebuilds the plan from the config, checks that
its tables equal the payload's bit for bit (the counterpart of the
StableHLO pinning the program's constants: a tree whose window, gain or
FFT code drifted refuses the artifact), and builds the live program from
the config as the live classes do.  The tables that exist only on the card (the two-stage split's of a
block over 16384 points, the spectral pool's edge weights) are built at
load for a CUDA device, as the live classes build them.  The kernels are
built at load, from this tree's sources; a library key other than the
artifact's is reported on one line.

- `save_offline(path, config, n_samples)` -> `AotOffline`: the whole-file
  offline program (models/offline.py::build_offline_fn, K1 on the card)
  for inputs up to n_samples, padded up and trimmed back.
- `save_stream_step(path, config, hw_block_size)` -> `AotStreamStep`:
  the streaming step (state, [2, hw]) -> (state, [3, hw]) and a stateful
  push_block (models/streaming.py::StreamingUpmixer's).
- `save_stream_pool(path, config, hw_block_size, n_streams)` -> a
  `CudaStreamPool` frozen at the artifact's `hops` (K3, or K3s for
  ola="spectral").

`platforms` records where an artifact may load: ("cuda",) by default
(the device's type), "cpu" for the plain versions; "tpu" artifacts are
the JAX package's.  A JAX artifact is refused by `load`.
"""

from __future__ import annotations

import io
import json
from typing import Sequence

import numpy as np

from upmix_tpu_torch.config import BandSpec, UpmixConfig, config_to_dict
from upmix_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_MAGIC = b"UPMIXAOT1\n"
_FORMAT = 1
PLATFORMS = ("cuda", "cpu")

def config_from_dict(d: dict) -> UpmixConfig:
    """The config of `config_to_dict` (either package's), its custom
    windows registered first (`ops.windows.restore_window`)."""
    from upmix_tpu_torch.ops import windows

    for name, payload in (d.get("custom_windows") or {}).items():
        windows.restore_window(name, payload, check_sizes=[b["block_size"] for b in d["bands"] if b["window"] == name])
    bands = tuple(BandSpec(**b) for b in d["bands"])
    rest = {k: v for k, v in d.items() if k not in ("bands", "custom_windows")}
    return UpmixConfig(bands=bands, **rest)


def _platforms(platforms: Sequence[str] | None, device) -> list:
    import torch

    plats = [torch.device(device).type] if platforms is None else [str(p).lower() for p in platforms]
    if not plats:
        raise ValueError("platforms must be None or a non-empty sequence")
    bad = [p for p in plats if p not in PLATFORMS]
    if bad:
        raise ValueError(f"platform {bad[0]!r}: the port's artifacts load on {' or '.join(PLATFORMS)} "
                         "(TPU artifacts are the JAX package's, upmix_tpu.aot)")
    return plats


def _tables(records) -> dict:
    """The payload: per bucket record (offline `_BucketPlan` or streaming
    `_StreamBucketPlan`) its block and hop, windows, gains and, for a
    block the one-block FFT takes, the FFT kernels' twiddles."""
    from upmix_tpu_torch.ops.fftplan import FFT_MAX, pass_twiddles

    out = {}
    for i, r in enumerate(records):
        out[f"{i}.geometry"] = np.array([r.block_size, r.hop_size], np.int64)
        out[f"{i}.analysis_window"] = np.asarray(r.analysis_window)
        out[f"{i}.synthesis_window"] = np.asarray(r.synthesis_window)
        out[f"{i}.gains"] = np.asarray(r.gains)
        if r.block_size <= FFT_MAX:
            out[f"{i}.twiddles"] = pass_twiddles(r.block_size)
    return out


def _meta(kind: str, config: UpmixConfig, platforms, device, **shapes) -> dict:
    import torch

    from upmix_tpu_torch.ops import _build

    return {
        "format": _FORMAT,
        "type": kind,
        "config": config_to_dict(config),
        **shapes,
        "platforms": _platforms(platforms, device),
        "torch_version": torch.__version__,
        "library_key": _build.library_key(),
    }


def _write(path: str, meta: dict, records) -> dict:
    buf = io.BytesIO()
    np.savez(buf, **_tables(records))
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(json.dumps(meta, sort_keys=True).encode("utf-8"))
        f.write(b"\n")
        f.write(buf.getvalue())
    return meta


def save_offline(path: str, config: UpmixConfig, n_samples: int, device="cuda", chunk: int | None = None,
                 platforms: Sequence[str] | None = None) -> dict:
    """Write an offline-program artifact for inputs of up to `n_samples`;
    returns its metadata.  `device` gives the default platform; `chunk`
    (recorded when given) is `build_offline_fn`'s."""
    from upmix_tpu_torch.models.offline import _plan_buckets

    n = int(n_samples)
    if n < 1:
        raise ValueError("n_samples must be >= 1")
    if chunk is not None and int(chunk) < 0:
        raise ValueError("chunk must be >= 0 (0 = the whole-file program)")
    shapes = {"n_samples": n} if chunk is None else {"n_samples": n, "chunk": int(chunk)}
    return _write(path, _meta("offline", config, platforms, device, **shapes), _plan_buckets(config, 1))


def save_stream_step(path: str, config: UpmixConfig, hw_block_size: int, device="cuda",
                     platforms: Sequence[str] | None = None) -> dict:
    """Write a streaming-step artifact; returns its metadata."""
    from upmix_tpu_torch.ops.pool import _plan_stream_buckets

    hw = int(hw_block_size)
    records = _plan_stream_buckets(config, hw)  # raises for a config that cannot stream at hw
    return _write(path, _meta("stream_step", config, platforms, device, hw_block_size=hw), records)


def save_stream_pool(path: str, config: UpmixConfig, hw_block_size: int, n_streams: int, group: int = 16,
                     layout: str = "quarters", ola: str = "time", platforms: Sequence[str] | None = None,
                     hops: int = 1, device="cuda") -> dict:
    """Write a serving-pool artifact; returns its metadata.  Raises
    ValueError for a config the pool kernel does not take.  `hops=T`
    freezes the step of T blocks a call: the loaded pool serves through
    push_blocks_multi only.  `group` and `layout` (the JAX pool's TPU
    grid step and state layout) are recorded and do nothing."""
    from upmix_tpu_torch.models.streaming import NOT_ELIGIBLE
    from upmix_tpu_torch.ops.pool import _plan_stream_buckets, check_ola, make_pool_plan

    check_ola(ola)
    hw, S, hops = int(hw_block_size), int(n_streams), int(hops)
    if S < 1:
        raise ValueError(f"n_streams must be >= 1, got {S}")
    if hops < 1:
        raise ValueError(f"hops must be >= 1, got {hops}")
    if make_pool_plan(config, hw, S, device="cpu", ola=ola) is None:
        raise ValueError(NOT_ELIGIBLE)
    meta = _meta("stream_pool", config, platforms, device, hw_block_size=hw, n_streams=S, group=int(group),
                 layout=str(layout), ola=ola, hops=hops)
    return _write(path, meta, _plan_stream_buckets(config, hw))


class AotOffline:
    """A loaded offline artifact: process()/process_np() like
    models.Upmixer, for inputs up to the frozen length (zero-padded up,
    trimmed back: Upmixer with pad_granularity=n_samples)."""

    def __init__(self, meta: dict, config: UpmixConfig, device):
        import torch

        from upmix_tpu_torch.models.offline import build_offline_fn

        self.meta = meta
        self.config = config
        self.n_samples = int(meta["n_samples"])
        self.device = torch.device(device)
        self._fn = build_offline_fn(config, self.n_samples, chunk=meta.get("chunk"), device=self.device)

    def process(self, L, R):
        """Stereo in (numpy arrays or tensors) -> (C, Ls, Rs), float32
        tensors of len(L) on the artifact's device."""
        import torch
        import torch.nn.functional as tnf

        n = len(L)
        if n < 1:
            raise ValueError("input must contain at least one sample")
        if len(R) != n:
            raise ValueError(f"channel length mismatch: {n} vs {len(R)}")
        if n > self.n_samples:
            raise ValueError(f"artifact is frozen at {self.n_samples} samples; got {n} "
                             "(build a larger artifact or chunk the input)")
        L = torch.as_tensor(L, dtype=torch.float32, device=self.device)
        R = torch.as_tensor(R, dtype=torch.float32, device=self.device)
        if n != self.n_samples:
            L = tnf.pad(L, (0, self.n_samples - n))
            R = tnf.pad(R, (0, self.n_samples - n))
        c, ls, rs = self._fn(L, R)
        return c[:n], ls[:n], rs[:n]

    def process_np(self, L, R):
        return tuple(t.cpu().numpy() for t in self.process(L, R))


class AotStreamStep:
    """A loaded streaming-step artifact over a StreamingUpmixer: its step
    as init_state() + step(state, block), and its stateful push_block."""

    def __init__(self, meta: dict, config: UpmixConfig, device):
        import torch

        from upmix_tpu_torch.models.streaming import StreamingUpmixer

        self.meta = meta
        self.config = config
        self.hw_block_size = int(meta["hw_block_size"])
        self.device = torch.device(device)
        self._engine = StreamingUpmixer(config, self.hw_block_size, self.device)

    def init_state(self):
        from upmix_tpu_torch.models.streaming import init_stream_state

        return init_stream_state(self.config, self.hw_block_size, self.device)

    def step(self, state, x_block):
        """(state, [2, hw] (L, R)) -> (new state, [3, hw] (C, Ls, Rs))."""
        import torch

        x = torch.as_tensor(x_block, dtype=torch.float32, device=self.device)
        if tuple(x.shape) != (2, self.hw_block_size):
            raise ValueError(f"step expects a [2, {self.hw_block_size}] block; got {tuple(x.shape)}")
        return self._engine._step(state, x)

    def push_block(self, in_l, in_r):
        """Feed one hardware block; returns (C, Ls, Rs) each [hw]."""
        return self._engine.push_block(in_l, in_r)


def _load_pool(meta: dict, config: UpmixConfig, device):
    from upmix_tpu_torch.models.streaming import CudaStreamPool

    pool = CudaStreamPool(config, int(meta["hw_block_size"]), int(meta["n_streams"]), device=device, ola=meta["ola"])
    pool.meta = meta
    pool._aot_hops = int(meta.get("hops", 1))
    return pool


def _read(path: str, payload: bool):
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not an upmix_tpu AOT artifact")
        header = f.readline()
        data = f.read() if payload else None
    meta = json.loads(header.decode("utf-8"))
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path}: unsupported artifact format {meta.get('format')!r}")
    return meta, data


def read_meta(path: str) -> dict:
    """Just the JSON metadata line of an artifact of either package."""
    return _read(path, payload=False)[0]


def _check_tables(path: str, meta: dict, config: UpmixConfig, payload: bytes) -> None:
    """Raise unless the tables this tree builds from the config equal the
    artifact's bit for bit."""
    if meta["type"] == "offline":
        from upmix_tpu_torch.models.offline import _plan_buckets

        records = _plan_buckets(config, 1)
    else:
        from upmix_tpu_torch.ops.pool import _plan_stream_buckets

        records = _plan_stream_buckets(config, int(meta["hw_block_size"]))
    built = _tables(records)
    with np.load(io.BytesIO(payload), allow_pickle=False) as saved:
        frozen = {k: saved[k] for k in saved.files}
    if set(frozen) != set(built):
        raise ValueError(f"{path}: the artifact's tables {sorted(frozen)} are not the {sorted(built)} this tree "
                         "builds from its config")
    for key, want in built.items():
        got = frozen[key]
        if got.dtype != want.dtype or got.shape != want.shape or got.tobytes() != want.tobytes():
            raise ValueError(f"{path}: the artifact's table {key!r} differs from the one this tree builds from its "
                             "config (its window, gain or FFT code changed since the save)")


def load(path: str, device="cuda"):
    """Load an artifact written by save_offline / save_stream_step /
    save_stream_pool (the type is read from the metadata line) onto
    `device`, which must be one of its platforms.  On a CUDA device the
    kernels are built here, not at the first call."""
    import torch

    meta, payload = _read(path, payload=True)
    if "torch_version" not in meta:
        raise ValueError(f"{path}: a JAX package artifact (jax {meta.get('jax_version', '?')}); load it with "
                         "upmix_tpu.aot.load")
    device = torch.device(device)
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path}: saved for platforms {meta['platforms']}; cannot load on {device.type}")
    kind = meta["type"]
    if kind not in ("offline", "stream_step", "stream_pool"):
        raise ValueError(f"{path}: unknown artifact type {kind!r}")
    config = config_from_dict(meta["config"])
    _check_tables(path, meta, config, payload)
    if device.type == "cuda":
        from upmix_tpu_torch.ops import _build

        key = _build.library_key()
        if meta.get("library_key") != key:
            log.warning("%s: saved against kernel library %s; building this tree's %s", path,
                        meta.get("library_key"), key)
        _build.load()
    if kind == "offline":
        return AotOffline(meta, config, device)
    if kind == "stream_step":
        return AotStreamStep(meta, config, device)
    return _load_pool(meta, config, device)
