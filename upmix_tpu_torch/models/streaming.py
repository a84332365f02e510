"""Streaming (block-based, real-time) multiband upmix and the serving pool.

Port of `upmix_tpu/models/streaming.py`.  Every band's readiness
threshold is K * hw samples (K = block/hop, 4 at the reference's fixed
75% overlap), so one shared history of the last K hardware blocks serves
every band, and all bands come online together at the K-th block; until
then a stream emits silence and leaves its overlap-add state alone
(bela/upmix.cpp:232-237, 485-491).

Three engines, one step (`ops/pool.py::pool_step_lcr`: the pool kernel,
K3 in `csrc/pool.cu`, on a CUDA device; its plain torch.fft version on
the CPU):

  - `StreamingUpmixer`: one stream, `push_block` per hardware block or
    `process_signal` over a whole signal.
  - `BatchStreamingUpmixer`: many streams, with slot churn and
    checkpoints in the structure of the JAX package's vmapped XLA engine.
  - `CudaStreamPool`: the serving pool, the counterpart of
    `PallasStreamPool`, with its snapshot structure, `hops` blocks per
    step and a sustained runner.

The two pools share their state and step (`_StreamPool`) and differ only
in the snapshot structure they exchange with the JAX package.  Each
engine's snapshots load into its JAX counterpart and the JAX engine's
load here: a live session moves between the two packages.  State is
updated in place: each push replaces the engine's state tensors and
keeps no copy of the old ones; take `snapshot()` to keep one.  There is
therefore no `donate` knob, and no `group` (a TPU grid-step size).

Output modes: "stereo_sum" is the Bela mix out = side + 0.5 * center
(upmix.cpp:295-303); "lcr" the three discrete channels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from upmix_tpu_torch.config import UpmixConfig, bucket_bands
from upmix_tpu_torch.ops.gains import band_gain_curve
from upmix_tpu_torch.ops.pool import make_pool_plan, plan_from_stream_buckets, pool_step_lcr
from upmix_tpu_torch.ops.windows import design_wola_synthesis_window, make_window

# Readiness latency at the reference's fixed 75% overlap (K = block/hop
# = 4; bela/upmix.cpp:232-237).  Other overlaps give K blocks.
WARMUP_BLOCKS = 4

# Blocks per pool step in StreamingUpmixer.process_signal (bounds the
# frames held at once).
_SIGNAL_HOPS = 64


@dataclass(frozen=True)
class _StreamBucketPlan:
    block_size: int
    hop_size: int
    passes: int  # hw_block // hop
    analysis_window: np.ndarray  # [block]
    synthesis_window: np.ndarray  # [block]
    gains: np.ndarray  # [n_bands_in_bucket, n_bins]


def stream_warmup_blocks(config: UpmixConfig) -> int:
    """Uniform readiness latency in hardware blocks: K = block/hop, which
    must be the same for every band (the shared history needs it)."""
    ks = set()
    for b in config.bands:
        if b.block_size % b.hop_size:
            raise ValueError(
                f"streaming requires hop | block (band block {b.block_size}, hop {b.hop_size})"
            )
        ks.add(b.block_size // b.hop_size)
    if len(ks) != 1:
        raise ValueError(
            f"streaming requires a uniform block/hop ratio across bands, got {sorted(ks)}"
        )
    return ks.pop()


def _plan_stream_buckets(config: UpmixConfig, hw_block_size: int):
    """Numpy bucket records (a copy of the JAX package's, without its
    TPU-only direct-DFT field); raises ValueError for a config that cannot
    stream at this hw block size."""
    warmup = stream_warmup_blocks(config)
    plans = []
    for block_size, bands in bucket_bands(config.bands).items():
        hop = bands[0].hop_size
        if hw_block_size % hop != 0:
            raise ValueError(
                f"hw block size {hw_block_size} must be a multiple of every "
                f"band hop (violated by block {block_size}, hop {hop})"
            )
        # The last pass reads [hw - hop, hw - hop + block) of the K*hw
        # history (the C++ cap is block <= hw*4 at 75%, bela/upmix.cpp:498-506).
        if hw_block_size - hop + block_size > warmup * hw_block_size:
            raise ValueError(
                f"band block size {block_size} exceeds the shared-history "
                f"window ({warmup}x hw_block = {warmup * hw_block_size}); "
                f"build the config with UpmixConfig.streaming "
                f"(max_block_size = hw_block*4)"
            )
        aw = make_window(config.window, block_size)
        if config.synthesis == "wola":
            sw = design_wola_synthesis_window(aw, config.overlap)
        elif config.synthesis == "analysis":
            sw = aw  # C++ parity (bela/upmix.cpp:200-201)
        else:
            raise ValueError(f"unknown synthesis mode {config.synthesis!r}")
        gains = np.stack([band_gain_curve(b, dtype=np.float32) for b in bands])
        plans.append(
            _StreamBucketPlan(
                block_size=block_size,
                hop_size=hop,
                passes=hw_block_size // hop,
                analysis_window=aw,
                synthesis_window=sw,
                gains=gains,
            )
        )
    return plans


def _engine_plan(config: UpmixConfig, hw_block_size: int, n_streams: int, device):
    """The pool plan of the engines, with the kernel's weights on a CUDA
    device; None when every bucket is dead (the engine then emits zeros).
    Raises ValueError for a config that cannot stream at this hw."""
    records = _plan_stream_buckets(config, hw_block_size)
    return plan_from_stream_buckets(records, hw_block_size, stream_warmup_blocks(config), n_streams, device)


def init_stream_state(config: UpmixConfig, hw_block_size: int, device="cuda"):
    """Fresh single-stream state: {"history" [2, K*hw], "t" (blocks seen,
    int32 scalar), "ola" {str(block): [3, block]}}, every bucket keyed as
    in the JAX package."""
    warmup = stream_warmup_blocks(config)
    device = torch.device(device)
    return {
        "history": torch.zeros((2, warmup * hw_block_size), device=device),
        "t": torch.zeros((), dtype=torch.int32, device=device),
        "ola": {str(b): torch.zeros((3, b), device=device) for b in bucket_bands(config.bands)},
    }


def _batch_step(plan, hw: int, state: dict, x: torch.Tensor):
    """The step of every engine: state leaves with a leading stream axis
    ({"history" [S, 2, K*hw], "t" [S], "ola" {str(block): [S, 3, block]}}),
    x [S, 2, hops*hw] -> (new state, out [S, 3, hops*hw]).  Runs
    `pool_step_lcr`: the kernel on a CUDA device, its plain version on
    the CPU."""
    window = state["history"].shape[-1]
    hops = x.shape[-1] // hw
    hist = torch.cat([state["history"][..., hw:], x.to(state["history"].dtype)], dim=-1)
    ola = dict(state["ola"])
    if plan is None:  # every bucket is dead: silence
        out = hist.new_zeros((x.shape[0], 3, hops * hw))
    else:
        keys = [str(b.block) for b in plan.buckets]
        out, new = pool_step_lcr(hist, state["t"] + 1, [ola[k] for k in keys], plan, hops)
        ola.update(zip(keys, new))
    return {"history": hist[..., hist.shape[-1] - window :], "t": state["t"] + hops, "ola": ola}, out


def _stream_step(plan, hw: int):
    def step(state, x_block):
        batched = {
            "history": state["history"][None],
            "t": state["t"].reshape(1),
            "ola": {k: v[None] for k, v in state["ola"].items()},
        }
        new, out = _batch_step(plan, hw, batched, torch.as_tensor(x_block)[None])
        return {
            "history": new["history"][0],
            "t": new["t"][0],
            "ola": {k: v[0] for k, v in new["ola"].items()},
        }, out[0]

    return step


def build_stream_step(config: UpmixConfig, hw_block_size: int, device="cuda"):
    """The streaming step: (state, in_block [2, hw]) -> (state, out [3, hw])
    with out = (C, Ls, Rs); mix with `mix_stereo_sum` for the Bela output."""
    return _stream_step(_engine_plan(config, hw_block_size, 1, device), int(hw_block_size))


def mix_stereo_sum(lcr):
    """Bela output mix (L, R) = (Ls + 0.5*C, Rs + 0.5*C) of lcr [3, ...]
    ordered (C, Ls, Rs) (upmix.cpp:295-303)."""
    c, ls, rs = lcr[0], lcr[1], lcr[2]
    return ls + 0.5 * c, rs + 0.5 * c


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_numpy(tree):
    """Host copy (never a view of the live state, which is updated in place)."""
    return _tree_map(lambda a: a.detach().to("cpu", copy=True).numpy() if torch.is_tensor(a) else np.array(a), tree)


def _check_stream_indices(indices, n_streams: int):
    """Validated int list: an index out of range would land on the wrong
    live session."""
    indices = [int(i) for i in indices]
    bad = [i for i in indices if not 0 <= i < n_streams]
    if bad:
        raise ValueError(f"stream indices {bad} out of range [0, {n_streams})")
    return indices


def _blocks(in_l, in_r, device, shape: tuple, what: str) -> torch.Tensor:
    """Two channel arrays of `shape` -> float32 [*shape[:-1], 2, shape[-1]]
    on `device`; a bad shape raises before anything runs."""
    xl = torch.as_tensor(in_l, dtype=torch.float32, device=device)
    xr = torch.as_tensor(in_r, dtype=torch.float32, device=device)
    if tuple(xl.shape) != tuple(shape) or tuple(xr.shape) != tuple(shape):
        raise ValueError(
            f"{what} expects two {list(shape)} channel arrays; got {tuple(xl.shape)} / {tuple(xr.shape)}"
        )
    return torch.stack([xl, xr], dim=-2)


def _zero_rows(state, indices):
    """Zero the given stream rows of every leaf, in place."""
    _tree_map(lambda a: a.index_fill_(0, torch.tensor(indices, device=a.device), 0), state)


class StreamingUpmixer:
    """One stream: `push_block` per hardware block (real time), or
    `process_signal` over a whole signal, on one device.  `state` has the
    JAX StreamingUpmixer's structure; `restore` takes either package's."""

    def __init__(self, config: UpmixConfig, hw_block_size: int, device="cuda"):
        self.config = config
        self.hw_block_size = int(hw_block_size)
        self.device = torch.device(device)
        self.warmup_blocks = stream_warmup_blocks(config)
        self._plan = _engine_plan(config, self.hw_block_size, 1, self.device)
        self._step = _stream_step(self._plan, self.hw_block_size)
        self.state = init_stream_state(config, self.hw_block_size, self.device)

    def reset(self):
        self.state = init_stream_state(self.config, self.hw_block_size, self.device)

    def snapshot(self):
        """Host (numpy) copy of the state, safe to keep across pushes."""
        return _to_numpy(self.state)

    def restore(self, snap):
        """Load a snapshot of this engine or of the JAX StreamingUpmixer."""
        fresh = init_stream_state(self.config, self.hw_block_size, self.device)
        self.state = _tree_map_like(fresh, snap)

    def push_block(self, in_l, in_r):
        """Feed one hardware block; returns (C, Ls, Rs) each [hw]."""
        x = _blocks(in_l, in_r, self.device, (self.hw_block_size,), "push_block")
        self.state, out = self._step(self.state, x)
        return out[0], out[1], out[2]

    def process_signal(self, L, R, mix: str = "lcr"):
        """Whole-signal streaming from a fresh state (truncated to whole hw
        blocks, like a real-time device; cf. oracle_stream_multiband).
        mix="lcr" returns (C, Ls, Rs), mix="stereo_sum" (outL, outR).
        Runs up to 64 blocks per pool step."""
        if mix not in ("lcr", "stereo_sum"):
            raise ValueError(f"unknown mix {mix!r}; one of ('lcr', 'stereo_sum')")
        hw, K = self.hw_block_size, self.warmup_blocks
        n_blocks = len(L) // hw
        n = n_blocks * hw
        x = _blocks(torch.as_tensor(L)[:n], torch.as_tensor(R)[:n], self.device, (n,), "process_signal")
        hist = torch.cat([x.new_zeros((2, (K - 1) * hw)), x], dim=1)[None]
        lcr = x.new_zeros((3, n))
        if self._plan is not None:  # else every bucket is dead: silence
            carries = [hist.new_zeros((1, 3, b.block)) for b in self._plan.buckets]
            for start in range(0, n_blocks, _SIGNAL_HOPS):
                hops = min(_SIGNAL_HOPS, n_blocks - start)
                seg = hist[..., start * hw : (start + K - 1 + hops) * hw].contiguous()
                t = torch.full((1,), start + 1, dtype=torch.int32, device=self.device)
                out, carries = pool_step_lcr(seg, t, carries, self._plan, hops)
                lcr[:, start * hw : (start + hops) * hw] = out[0]
        if mix == "stereo_sum":
            return mix_stereo_sum(lcr)
        return lcr[0], lcr[1], lcr[2]


def _tree_map_like(like, snap):
    """`snap` (numpy or tensors, lists where `like` has tuples) as tensors
    of `like`'s dtypes and device, checked against `like`'s shapes."""
    if isinstance(like, dict):
        if set(map(str, snap)) != set(like):
            raise ValueError(f"snapshot keys {sorted(map(str, snap))} do not match {sorted(like)}")
        snap = {str(k): v for k, v in snap.items()}
        return {k: _tree_map_like(like[k], snap[k]) for k in like}
    got = torch.tensor(np.asarray(snap), dtype=like.dtype, device=like.device)  # a copy: never alias the snapshot
    if got.shape != like.shape:
        raise ValueError(f"snapshot leaf has shape {tuple(got.shape)}, expected {tuple(like.shape)}")
    return got


def check_ola(ola: str) -> None:
    """Raise unless `ola` is the pool's time-OLA dataflow (the one ported)."""
    if ola == "spectral":
        raise NotImplementedError(
            "ola='spectral' (the spectral-carry dataflow of pallas_pool.py:249) is not "
            "ported yet (ROADMAP.md, Queue 1: the spectral OLA of the pool); ola='time' computes the same function"
        )
    if ola != "time":
        raise ValueError(f"unknown ola mode {ola!r}; one of ('time', 'spectral')")


def _assign_rows(state, idx, rows):
    if isinstance(state, dict):
        for k in state:
            _assign_rows(state[k], idx, rows[k])
    else:
        state[idx] = rows


class _StreamPool:
    """State and step of the two pools: {"history" [S, 2, K*hw], "t" [S],
    "ola" {str(block): [S, 3, block]}}, every bucket keyed, updated by one
    `_batch_step` per push.  Sessions come and go: `reset_streams` zeroes
    slots (each re-warms), `extract_streams` / `load_streams` move single
    sessions.  A subclass gives the plan (`_make_plan`) and the snapshot
    structure it exchanges with the JAX package: `_export` (the state in
    numpy -> snapshot) and `_import` (a snapshot, or rows of one -> state
    tensors)."""

    def __init__(self, config: UpmixConfig, hw_block_size: int, n_streams: int, device="cuda",
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a stream pool on a mesh is not ported yet (ROADMAP.md, Queue 1: the pool on a mesh)"
            )
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.config = config
        self.hw_block_size = int(hw_block_size)
        self.n_streams = int(n_streams)
        self.device = torch.device(device)
        self.warmup_blocks = stream_warmup_blocks(config)
        self.plan = self._make_plan()
        self._ola_blocks = {str(b): b for b in bucket_bands(config.bands)}
        self.state = self._fresh_state()

    def _fresh_state(self, rows: int | None = None):
        S = self.n_streams if rows is None else rows
        hw, K, dev = self.hw_block_size, self.warmup_blocks, self.device
        return {
            "history": torch.zeros((S, 2, K * hw), device=dev),
            "t": torch.zeros((S,), dtype=torch.int32, device=dev),
            "ola": {k: torch.zeros((S, 3, B), device=dev) for k, B in self._ola_blocks.items()},
        }

    def _step(self, state, x):
        """x [S, 2, hops*hw] -> (new state, out [S, 3, hops*hw])."""
        return _batch_step(self.plan, self.hw_block_size, state, x)

    def push_blocks(self, in_l, in_r):
        """One hardware block for every stream: in_l, in_r [S, hw] ->
        (C, Ls, Rs), each [S, hw]."""
        x = _blocks(in_l, in_r, self.device, (self.n_streams, self.hw_block_size), "push_blocks")
        self.state, out = self._step(self.state, x)
        return out[:, 0], out[:, 1], out[:, 2]

    def reset(self):
        self.state = self._fresh_state()

    def reset_streams(self, indices):
        """Zero the given stream slots (ended sessions; the slots re-warm)."""
        _zero_rows(self.state, _check_stream_indices(indices, self.n_streams))

    def snapshot(self):
        """Host (numpy) copy of the state in this pool's snapshot
        structure, safe to keep across pushes."""
        return self._export(_to_numpy(self.state))

    def restore(self, snap):
        """Load a snapshot of this pool or of its JAX counterpart."""
        self.state = self._import(snap, self.n_streams)

    def extract_streams(self, indices, snap=None):
        """Per-stream rows of a snapshot (or of the live state), in the
        snapshot structure with leading dim len(indices): what
        `load_streams` takes."""
        idx = np.asarray(_check_stream_indices(indices, self.n_streams), dtype=np.int64)
        src = self.snapshot() if snap is None else snap
        return _tree_map(lambda a: np.asarray(a)[idx], src)

    def load_streams(self, indices, rows):
        """Write per-stream rows (from `extract_streams` of either package)
        into the given slots, leaving the other streams alone."""
        idx = _check_stream_indices(indices, self.n_streams)
        _assign_rows(self.state, idx, self._import(rows, len(idx)))


class BatchStreamingUpmixer(_StreamPool):
    """Many concurrent streams through one batched step per hardware block,
    on one device, with the state structure of the JAX package's vmapped
    XLA engine: {"history" [S, 2, K*hw], "t" [S], "ola" {str(block):
    [S, 3, block]}}; its snapshots and rows are that structure in numpy."""

    def _make_plan(self):
        return _engine_plan(self.config, self.hw_block_size, self.n_streams, self.device)

    def _export(self, st):
        return st

    def _import(self, snap, rows: int):
        return _tree_map_like(self._fresh_state(rows), snap)


class CudaStreamPool(_StreamPool):
    """The serving pool, the counterpart of the JAX PallasStreamPool: one
    `pool_step_lcr` call per hardware block (or per `hops` blocks) serves
    every stream; on a CUDA device three kernel launches per bucket, on
    the CPU the plain version.

    `snapshot()` returns the JAX pool's quarters structure in numpy
    ({"histL", "histR": K-1 arrays [S, hw], "t", "ola": {str(B): (C, Ls,
    Rs) [S, B]}}, live buckets only); `restore()` takes that or the window
    layout ([S, K*hw] per channel).  No group and no n_streams % group
    rule: any S >= 1.

    Not in this port yet (each raises NotImplementedError): `mesh=`
    (ROADMAP.md, Queue 1: the pool on a mesh), ola="spectral" (the same
    function by another dataflow; the spectral OLA of the pool),
    `_shape_only` AOT loading (aot.py).
    """

    def __init__(self, config: UpmixConfig, hw_block_size: int, n_streams: int, device="cuda",
                 mesh=None, ola: str = "time", _shape_only: bool = False):
        check_ola(ola)
        if _shape_only:
            raise NotImplementedError("AOT pool artifacts are not ported yet (ROADMAP.md, Queue 1: aot.py)")
        self.ola = ola
        super().__init__(config, hw_block_size, n_streams, device, mesh)

    def _make_plan(self):
        plan = make_pool_plan(self.config, self.hw_block_size, self.n_streams, self.device)
        if plan is None:
            raise ValueError(
                "config not eligible for the pool kernel (a hop that does not divide hw "
                "or its block, or no live bucket); use BatchStreamingUpmixer"
            )
        return plan

    def push_blocks_multi(self, in_l, in_r):
        """`hops` consecutive blocks for every stream in one step: [S,
        hops*hw] x 2 -> (C, Ls, Rs), each [S, hops*hw]; hops from the
        width.  One call spans `hops` block deadlines: throughput for
        latency."""
        width = torch.as_tensor(in_l).shape[-1]
        hw = self.hw_block_size
        if width == 0 or width % hw:
            raise ValueError(
                f"push_blocks_multi expects two [{self.n_streams}, k*{hw}] channel arrays; got width {width}"
            )
        x = _blocks(in_l, in_r, self.device, (self.n_streams, width), "push_blocks_multi")
        self.state, out = self._step(self.state, x)
        return out[:, 0], out[:, 1], out[:, 2]

    def make_sustained_runner(self, n_blocks: int, hops: int = 1):
        """(run, fresh): run(state, blocks) with device-resident blocks
        [n_blocks // hops, 2, S, hops*hw] runs every step with no host
        synchronisation per block and returns (final_state, cs), cs [n_blocks
        // hops, S, hops*hw] the C outputs.  Time it with CUDA events for
        the pool's sustained capacity."""
        n_blocks, hops = int(n_blocks), int(hops)
        if hops < 1 or n_blocks % hops:
            raise ValueError(f"n_blocks ({n_blocks}) must be a multiple of hops ({hops})")

        def run(state, blocks):
            cs = []
            for step_blocks in blocks:
                state, out = self._step(state, step_blocks.transpose(0, 1))
                cs.append(out[:, 0])
            return state, torch.stack(cs)

        return run, self._fresh_state

    def _export(self, st):
        hw, nq = self.hw_block_size, self.warmup_blocks
        hist = st["history"]  # the oldest of its nq blocks is dead state
        return {
            "histL": tuple(hist[:, 0, q * hw : (q + 1) * hw] for q in range(1, nq)),
            "histR": tuple(hist[:, 1, q * hw : (q + 1) * hw] for q in range(1, nq)),
            "t": st["t"],
            "ola": {str(b.block): tuple(st["ola"][str(b.block)][:, o] for o in range(3)) for b in self.plan.buckets},
        }

    def _import(self, snap, rows: int):
        hw, nq = self.hw_block_size, self.warmup_blocks
        state = self._fresh_state(rows)  # dead buckets' carries stay zero
        hists = []
        for key in ("histL", "histR"):
            h = np.asarray(snap[key], np.float32)
            if h.ndim == 3:  # quarters: nq-1 arrays [rows, hw]; the dead oldest block left zero
                if h.shape != (nq - 1, rows, hw):
                    raise ValueError(f"snapshot {key} has shape {h.shape}, expected ({nq - 1}, {rows}, {hw})")
                h = np.concatenate([np.zeros((rows, hw), np.float32), *h], axis=1)
            elif h.ndim == 2:  # window: [rows, nq*hw]
                if h.shape != (rows, nq * hw):
                    raise ValueError(f"snapshot {key} has shape {h.shape}, expected ({rows}, {nq * hw})")
            else:
                raise ValueError(f"unrecognized {key} history structure (shape {h.shape})")
            hists.append(h)
        state["history"] = torch.tensor(np.stack(hists, axis=1), device=self.device)
        want = {str(b.block): b.block for b in self.plan.buckets}
        got = {str(k): np.asarray(v, np.float32) for k, v in snap["ola"].items()}
        if set(got) != set(want):
            raise ValueError(f"snapshot buckets {sorted(got)} do not match this pool's {sorted(want)}")
        for k, a in got.items():
            if a.shape != (3, rows, want[k]):
                raise ValueError(
                    f"snapshot carry {k} has shape {a.shape}; this pool takes time-OLA carries "
                    f"(3 x [{rows}, {want[k]}]), not spectral ones"
                )
            state["ola"][k] = torch.tensor(np.ascontiguousarray(a.transpose(1, 0, 2)), device=self.device)
        t = np.asarray(snap["t"], np.int32)
        if t.shape != (rows,):
            raise ValueError(f"snapshot t has shape {t.shape}, expected ({rows},)")
        state["t"] = torch.tensor(t, device=self.device)
        return state


def make_stream_pool(config: UpmixConfig, hw_block_size: int, n_streams: int, engine: str = "auto",
                     device="cuda", mesh=None, ola: str = "time"):
    """The serving pool for this config and device.

    engine "cuda" and "torch" stand for the JAX package's "pallas" and
    "xla": "cuda" is CudaStreamPool, "torch" is BatchStreamingUpmixer.
    Both run the same step (`pool_step_lcr`: the pool kernel on a CUDA
    device, its plain version on the CPU) and differ in the snapshot
    structure they share with the JAX package.  "auto" returns
    CudaStreamPool on a CUDA device whenever the pool plan accepts the
    config, else BatchStreamingUpmixer; on the CPU it returns
    BatchStreamingUpmixer, as the JAX package does on its CPU backend.
    A mesh is not ported yet (ROADMAP.md, Queue 1: the pool on a mesh)."""
    if engine not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown engine {engine!r}; one of ('auto', 'cuda', 'torch')")
    if mesh is not None:
        raise NotImplementedError("a stream pool on a mesh is not ported yet (ROADMAP.md, Queue 1: the pool on a mesh)")
    if engine == "cuda":
        return CudaStreamPool(config, hw_block_size, n_streams, device=device, ola=ola)
    if (
        engine == "auto"
        and torch.device(device).type == "cuda"
        and make_pool_plan(config, int(hw_block_size), int(n_streams), device="cpu") is not None
    ):
        return CudaStreamPool(config, hw_block_size, n_streams, device=device, ola=ola)
    return BatchStreamingUpmixer(config, hw_block_size, n_streams, device=device)
