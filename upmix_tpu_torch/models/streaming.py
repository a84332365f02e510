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
    step, a sustained runner and both OLA dataflows (`ola="spectral"`:
    K3s in `csrc/pool_spectral.cu`).

The two pools share their state and step (`_StreamPool`) and differ only
in the snapshot structure they exchange with the JAX package.  Both take
a mesh and split their streams over its 'data' axis.  Each
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
from upmix_tpu_torch.ops.pool import (
    _plan_stream_buckets,
    check_ola,
    make_pool_plan,
    pack_spectral_carry,
    plan_from_stream_buckets,
    pool_step_lcr,
    stream_warmup_blocks,
    unpack_spectral_carry,
)
from upmix_tpu_torch.utils.tracing import root, span

# Readiness latency at the reference's fixed 75% overlap (K = block/hop
# = 4; bela/upmix.cpp:232-237).  Other overlaps give K blocks.
WARMUP_BLOCKS = 4

# Blocks per pool step in StreamingUpmixer.process_signal (bounds the
# frames held at once).
_SIGNAL_HOPS = 64

NOT_ELIGIBLE = ("config not eligible for the pool kernel (a hop that does not divide hw or its block, or no live "
                "bucket); use BatchStreamingUpmixer")


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
    with span("pool.shift"):
        hist = torch.cat([state["history"][..., hw:], x.to(state["history"].dtype)], dim=-1)
    ola = dict(state["ola"])
    if plan is None:  # every bucket is dead: silence
        out = hist.new_zeros((x.shape[0], 3, hops * hw))
    else:
        keys = [str(b.block) for b in plan.buckets]
        with span("pool.kernels"):
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
    on `device` (numpy views of any strides); a bad shape raises before
    anything runs."""

    def tensor(a):
        if isinstance(a, np.ndarray):
            a = np.ascontiguousarray(a)
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    xl, xr = tensor(in_l), tensor(in_r)
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


def _assign_rows(state, idx, rows):
    if isinstance(state, dict):
        for k in state:
            _assign_rows(state[k], idx, rows[k])
    else:
        state[idx] = rows


def _mesh_devices(mesh, need_data: bool) -> list:
    """The devices of the mesh's 'data' axis, shard order (its other axes
    at index 0); one device when a batch pool's mesh has no 'data' axis."""
    from upmix_tpu_torch.parallel.sharded import _device_grid

    if "data" not in mesh.shape:
        if need_data:
            raise ValueError(
                f"the CUDA pool shards streams over a 'data' mesh axis; mesh has axes {tuple(mesh.shape)}"
            )
        return [mesh.devices.flat[0]]
    return [torch.device(d) for d in _device_grid(mesh, "data", None)[:, 0]]


def _row_slice(rows) -> slice | None:
    """rows as a slice where they are one ascending range, else None."""
    if rows is None or not np.array_equal(rows, np.arange(rows[0], rows[0] + len(rows))):
        return None
    return slice(int(rows[0]), int(rows[0]) + len(rows))


@dataclass(frozen=True, eq=False)
class _Part:
    """The streams of a pool on one device: `rows` (global stream indices,
    in the part's row order) or None for every stream in order."""

    device: torch.device
    rows: np.ndarray | None
    plan: object


class _StreamPool:
    """State and step of the two pools: {"history" [S, 2, K*hw], "t" [S],
    "ola" {str(block): carry}}, updated by one `_batch_step` per push.
    The carries are [S, 3, block] for every bucket (time OLA) or [S, 3,
    Kr - 1, K, 2] for every live bucket (spectral OLA, `ops/pool.py`).
    Sessions come and go: `reset_streams` zeroes slots (each re-warms),
    `extract_streams` / `load_streams` move single sessions.  A subclass
    gives the plan (`_make_plan`) and the snapshot structure it exchanges
    with the JAX package: `_export` (the state in numpy -> snapshot) and
    `_import` (a snapshot, or rows of one -> state tensors).

    With a mesh the streams split evenly over its 'data' axis, shard k
    taking streams [k S/d, (k + 1) S/d); the plan is per shard (S/d
    streams).  Shards that share a device run as rows of one step on it,
    so a mesh of one repeated device is the unsharded pool.  Shards on
    distinct devices keep their state there and step there, with no host
    synchronisation between them; the outputs come back to the first
    device in stream order.  `state` is then a tuple of the devices'
    states; snapshots always have the unsharded structure, so a
    checkpoint restores across mesh topologies."""

    _ola = "time"

    def __init__(self, config: UpmixConfig, hw_block_size: int, n_streams: int, device="cuda",
                 mesh=None, need_data: bool = False):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.config = config
        self.hw_block_size = int(hw_block_size)
        self.n_streams = int(n_streams)
        self.mesh = mesh
        self.warmup_blocks = stream_warmup_blocks(config)
        shards = [torch.device(device)] if mesh is None else _mesh_devices(mesh, need_data)
        if self.n_streams % len(shards):
            raise ValueError(
                f"n_streams {self.n_streams} must divide evenly across the mesh 'data' axis ({len(shards)})"
            )
        local = self.n_streams // len(shards)
        self.device = shards[0]  # where the inputs are taken and the outputs returned
        by_device = {}
        for k, dev in enumerate(shards):
            by_device.setdefault(dev, []).append(k)
        plans = {dev: self._make_plan(local, dev) for dev in by_device}
        self.plan = plans[self.device]
        self._parts = tuple(
            _Part(dev, None if len(by_device) == 1 else
                  np.concatenate([np.arange(k * local, (k + 1) * local) for k in ks]), plans[dev])
            for dev, ks in by_device.items()
        )
        # part and row of each stream
        self._where = np.zeros((self.n_streams, 2), np.int64)
        for p, part in enumerate(self._parts):
            rows = np.arange(self.n_streams) if part.rows is None else part.rows
            self._where[rows] = np.stack([np.full(len(rows), p), np.arange(len(rows))], axis=1)
        self._index = [None if part.rows is None else torch.as_tensor(part.rows, device=self.device)
                       for part in self._parts]
        self._slices = [_row_slice(part.rows) for part in self._parts]
        self._order = (*range(1, len(self._parts)), 0)  # the first device's part last
        self._ola_blocks = {str(b): b for b in bucket_bands(config.bands)}
        self.state = self._fresh_state()

    def _fresh_rows(self, rows: int, device):
        """A fresh state of `rows` streams on `device`."""
        hw, K = self.hw_block_size, self.warmup_blocks
        if self._ola == "spectral":
            ola = {str(b.block): torch.zeros(b.spectral_carry_shape(rows), device=device) for b in self.plan.buckets}
        else:
            ola = {k: torch.zeros((rows, 3, B), device=device) for k, B in self._ola_blocks.items()}
        return {
            "history": torch.zeros((rows, 2, K * hw), device=device),
            "t": torch.zeros((rows,), dtype=torch.int32, device=device),
            "ola": ola,
        }

    def _fresh_state(self):
        return self._form([self._fresh_rows(self.n_streams if p.rows is None else len(p.rows), p.device)
                           for p in self._parts])

    def _form(self, states: list):
        """The per-device states as `state` holds them."""
        return states[0] if len(self._parts) == 1 else tuple(states)

    def _states(self, state) -> list:
        return [state] if len(self._parts) == 1 else list(state)

    def _step(self, state, x):
        """x [S, 2, hops*hw] on self.device -> (new state, out [S, 3,
        hops*hw] on self.device, stream order).

        A copy between two cards runs on the source card's current stream,
        behind whatever is queued there (PyTorch's two-way barrier), so
        every part's input leaves the first device before any part steps,
        and the first device steps last: no card's input waits for its
        step.  The gathers follow that step."""
        hw = self.hw_block_size
        if len(self._parts) == 1:
            with span("pool.step", card=self.device):
                return _batch_step(self._parts[0].plan, hw, state, x)
        xs = self._scatter(x)
        news, outs = [None] * len(self._parts), [None] * len(self._parts)
        for p in self._order:
            with span("pool.step", card=self._parts[p].device):
                news[p], outs[p] = _batch_step(self._parts[p].plan, hw, state[p], xs[p])
        return tuple(news), self._gather(outs, x)

    def _scatter(self, x) -> list:
        """Each part's rows of x [S, ...] on self.device, on the part's
        device: one copy of a slice where the rows are one range, else an
        index-select and its copy."""
        xs = [None] * len(self._parts)
        for p in self._order:
            part, rows = self._parts[p], self._slices[p]
            with span("pool.scatter", card=part.device, path="index" if rows is None else "slice"):
                rows_x = x.index_select(0, self._index[p]) if rows is None else x[rows]
                xs[p] = rows_x.to(part.device, non_blocking=True)
        return xs

    def _gather(self, outs: list, x) -> torch.Tensor:
        """The parts' outputs [rows, 3, width] -> [S, 3, width] on
        self.device (x's), stream order: one copy into a slice where a
        part's rows are one range, else a copy and an index-put."""
        full = x.new_empty((self.n_streams, 3, outs[0].shape[-1]))
        for p in self._order:
            part, rows = self._parts[p], self._slices[p]
            with span("pool.gather", card=part.device, path="index" if rows is None else "slice"):
                if rows is None:
                    full[self._index[p]] = outs[p].to(self.device, non_blocking=True)
                else:
                    full[rows].copy_(outs[p], non_blocking=True)
        return full

    def push_blocks(self, in_l, in_r):
        """One hardware block for every stream: in_l, in_r [S, hw] ->
        (C, Ls, Rs), each [S, hw]."""
        with root("pool.push", edges=True, streams=self.n_streams, hops=1):
            with span("pool.stage"):
                x = _blocks(in_l, in_r, self.device, (self.n_streams, self.hw_block_size), "push_blocks")
            self.state, out = self._step(self.state, x)
            return out[:, 0], out[:, 1], out[:, 2]

    def make_sustained_runner(self, n_blocks: int, hops: int = 1):
        """(run, fresh): run(state, blocks) with device-resident blocks
        [n_blocks // hops, 2, S, hops*hw] runs every step with no host
        synchronisation per block and returns (final_state, cs), cs [n_blocks
        // hops, S, hops*hw] the C outputs.  Time it with CUDA events for
        the pool's sustained capacity.  hops > 1 needs a pool with a
        multi-hop step (CudaStreamPool)."""
        n_blocks, hops = int(n_blocks), int(hops)
        if hops < 1 or n_blocks % hops:
            raise ValueError(f"n_blocks ({n_blocks}) must be a multiple of hops ({hops})")
        if hops > 1 and not hasattr(self, "push_blocks_multi"):
            raise ValueError(f"{type(self).__name__} has no multi-hop (temporal batching) step")

        def run(state, blocks):
            cs = []
            for step_blocks in blocks:
                state, out = self._step(state, step_blocks.transpose(0, 1))
                cs.append(out[:, 0])
            return state, torch.stack(cs)

        return run, self._fresh_state

    def reset(self):
        self.state = self._fresh_state()

    def _by_part(self, indices):
        """[(part number, local rows, positions in `indices`)] of the parts
        the streams `indices` live in."""
        where = self._where[np.asarray(indices, np.int64)]
        out = []
        for p in range(len(self._parts)):
            pos = np.nonzero(where[:, 0] == p)[0]
            if len(pos):
                out.append((p, where[pos, 1].tolist(), pos))
        return out

    def reset_streams(self, indices):
        """Zero the given stream slots (ended sessions; the slots re-warm)."""
        states = self._states(self.state)
        for p, local, _ in self._by_part(_check_stream_indices(indices, self.n_streams)):
            _zero_rows(states[p], local)

    def _host_state(self):
        """The state in numpy with the unsharded structure."""
        states = [_to_numpy(st) for st in self._states(self.state)]
        if len(states) == 1:
            return states[0]

        def merge(*leaves):
            full = np.empty((self.n_streams, *leaves[0].shape[1:]), leaves[0].dtype)
            for part, leaf in zip(self._parts, leaves):
                full[part.rows] = leaf
            return full

        def walk(*trees):
            if isinstance(trees[0], dict):
                return {k: walk(*(t[k] for t in trees)) for k in trees[0]}
            return merge(*trees)

        return walk(*states)

    def snapshot(self):
        """Host (numpy) copy of the state in this pool's snapshot
        structure, safe to keep across pushes; unsharded whatever the
        mesh."""
        return self._export(self._host_state())

    def restore(self, snap):
        """Load a snapshot of this pool or of its JAX counterpart (of any
        mesh topology)."""
        full = self._import(snap, self.n_streams)
        if len(self._parts) == 1:
            self.state = full
            return
        self.state = tuple(
            _tree_map(lambda a, i=index, d=part.device: a.index_select(0, i).to(d), full)
            for part, index in zip(self._parts, self._index)
        )

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
        got = self._import(rows, len(idx))
        states = self._states(self.state)
        for p, local, pos in self._by_part(idx):
            sel = torch.as_tensor(pos, device=self.device)
            dev = self._parts[p].device
            _assign_rows(states[p], local, _tree_map(lambda a: a.index_select(0, sel).to(dev), got))

class BatchStreamingUpmixer(_StreamPool):
    """Many concurrent streams through one batched step per hardware block,
    with the state structure of the JAX package's vmapped XLA engine:
    {"history" [S, 2, K*hw], "t" [S], "ola" {str(block): [S, 3, block]}};
    its snapshots and rows are that structure in numpy.  It has no OLA
    mode (the time OLA) and no multi-hop step.  A mesh splits the streams
    over its 'data' axis (one device when it has none)."""

    def _make_plan(self, n_streams: int, device):
        return _engine_plan(self.config, self.hw_block_size, n_streams, device)

    def _export(self, st):
        return st

    def _import(self, snap, rows: int):
        return _tree_map_like(self._fresh_rows(rows, self.device), snap)


class CudaStreamPool(_StreamPool):
    """The serving pool, the counterpart of the JAX PallasStreamPool: one
    `pool_step_lcr` call per hardware block (or per `hops` blocks) serves
    every stream; on a CUDA device the pool kernels, on the CPU their
    plain versions.

    `ola` picks the dataflow, as in the JAX package: "time" (K3,
    [S, 3, B] carries) or "spectral" (K3s, the masked spectra of each
    bucket's last Kr - 1 frames; the same function to float tolerance,
    not bit for bit).  `snapshot()` returns the JAX pool's quarters
    structure in numpy ({"histL", "histR": K-1 arrays [S, hw], "t",
    "ola": {str(B): ...}}, live buckets only: (C, Ls, Rs) [S, B] for
    "time", the packed [S, 3 (Kr-1) kp] for "spectral");
    `restore()` takes that or the window layout ([S, K*hw] per channel),
    of the same OLA mode (ValueError otherwise, as in the JAX package).
    No group and no n_streams % group rule: any S >= 1.  A mesh needs a
    'data' axis and splits the streams over it (`_StreamPool`).

    `aot.load` freezes the pool at an artifact's `hops` (`_aot_hops`): a
    pool frozen at hops > 1 serves through `push_blocks_multi` only, and
    no other hops than the frozen one run.
    """

    _aot_hops = None  # the hops an AOT-loaded pool is frozen at

    def __init__(self, config: UpmixConfig, hw_block_size: int, n_streams: int, device="cuda",
                 mesh=None, ola: str = "time"):
        check_ola(ola)
        self.ola = self._ola = ola
        super().__init__(config, hw_block_size, n_streams, device, mesh, need_data=True)

    def _make_plan(self, n_streams: int, device):
        plan = make_pool_plan(self.config, self.hw_block_size, n_streams, device, ola=self.ola)
        if plan is None:
            raise ValueError(NOT_ELIGIBLE)
        return plan

    def _check_aot_hops(self, hops: int) -> None:
        if self._aot_hops is not None and hops != self._aot_hops:
            raise ValueError(
                f"multi-hop steps other than hops={self._aot_hops} are unavailable on an AOT-loaded pool (its "
                "artifact froze that step); save the multi-hop artifact (save_stream_pool(hops=...)) or build "
                "a live pool"
            )

    def push_blocks(self, in_l, in_r):
        if self._aot_hops not in (None, 1):
            raise ValueError(
                f"this AOT-loaded pool carries no single-hop program (artifact saved with hops={self._aot_hops}); "
                "feed push_blocks_multi with [n_streams, hops*hw] inputs"
            )
        return super().push_blocks(in_l, in_r)

    def make_sustained_runner(self, n_blocks: int, hops: int = 1):
        self._check_aot_hops(int(hops))
        return super().make_sustained_runner(n_blocks, hops)

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
        self._check_aot_hops(width // hw)
        with root("pool.push", edges=True, streams=self.n_streams, hops=width // hw):
            with span("pool.stage"):
                x = _blocks(in_l, in_r, self.device, (self.n_streams, width), "push_blocks_multi")
            self.state, out = self._step(self.state, x)
            return out[:, 0], out[:, 1], out[:, 2]

    def _export(self, st):
        hw, nq = self.hw_block_size, self.warmup_blocks
        hist = st["history"]  # the oldest of its nq blocks is dead state
        if self.ola == "spectral":
            ola = {str(b.block): pack_spectral_carry(st["ola"][str(b.block)]) for b in self.plan.buckets}
        else:
            ola = {str(b.block): tuple(st["ola"][str(b.block)][:, o] for o in range(3)) for b in self.plan.buckets}
        return {
            "histL": tuple(hist[:, 0, q * hw : (q + 1) * hw] for q in range(1, nq)),
            "histR": tuple(hist[:, 1, q * hw : (q + 1) * hw] for q in range(1, nq)),
            "t": st["t"],
            "ola": ola,
        }

    def _snapshot_carries(self, snap_ola):
        """A snapshot's carries as float32 arrays by bucket key, after
        checking their OLA format against this pool's: one 2-D array a
        bucket is spectral, three [rows, B] a bucket is time; ValueError
        for neither, or for the other mode's."""
        carries = {str(k): np.asarray(v, np.float32) for k, v in snap_ola.items()}
        ndims = {a.ndim for a in carries.values()}
        if ndims == {3} and all(a.shape[0] == 3 for a in carries.values()):
            spectral = False
        elif ndims <= {2}:
            spectral = True
        else:
            raise ValueError(
                f"unrecognized OLA carry structure in snapshot: shapes { {k: a.shape for k, a in carries.items()} }"
            )
        if spectral != (self.ola == "spectral"):
            raise ValueError(
                f"snapshot OLA format ({'spectral' if spectral else 'time'}) does not match this pool's "
                f"ola={self.ola!r}"
            )
        return carries

    def _import(self, snap, rows: int):
        hw, nq = self.hw_block_size, self.warmup_blocks
        state = self._fresh_rows(rows, self.device)  # dead buckets' carries stay zero
        got = self._snapshot_carries(snap["ola"])
        hists = []
        for key in ("histL", "histR"):
            h = np.asarray(snap[key], np.float32)
            if nq == 1 and h.size == 0:  # quarters of a one-block window: none
                h = h.reshape(0, rows, hw)
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
        live = {str(b.block): b for b in self.plan.buckets}
        if set(got) != set(live):
            raise ValueError(f"snapshot buckets {sorted(got)} do not match this pool's {sorted(live)}")
        for k, a in got.items():
            b = live[k]
            if self.ola == "spectral":
                carry = unpack_spectral_carry(a, b.overlap - 1, b.kept)
                if carry.shape[0] != rows:
                    raise ValueError(f"snapshot carry {k} has {carry.shape[0]} rows, expected {rows}")
            else:
                if a.shape != (3, rows, b.block):
                    raise ValueError(f"snapshot carry {k} has shape {a.shape}, expected (3, {rows}, {b.block})")
                carry = np.ascontiguousarray(a.transpose(1, 0, 2))
            state["ola"][k] = torch.tensor(carry, device=self.device)
        t = np.asarray(snap["t"], np.int32)
        if t.shape != (rows,):
            raise ValueError(f"snapshot t has shape {t.shape}, expected ({rows},)")
        state["t"] = torch.tensor(t, device=self.device)
        return state


def make_stream_pool(config: UpmixConfig, hw_block_size: int, n_streams: int, engine: str = "auto",
                     device="cuda", mesh=None, ola: str = "time"):
    """The serving pool for this config and device, chosen as the JAX
    package's make_stream_pool chooses (upmix_tpu/models/streaming.py:1037).

    engine "cuda" and "torch" stand for the JAX package's "pallas" and
    "xla": "cuda" is CudaStreamPool in the requested OLA mode (sharded
    over a mesh's 'data' axis when given one), "torch" is
    BatchStreamingUpmixer, which has no OLA mode and ignores `ola`.  Both
    run the same step (the pool kernels on a CUDA device, their plain
    versions on the CPU) and differ in the snapshot structure they share
    with the JAX package.  "auto" on a CUDA device with no mesh returns
    CudaStreamPool in the requested mode when the pool plan accepts the
    config; otherwise (the CPU, as the JAX package on its CPU backend; a
    mesh; an ineligible config) BatchStreamingUpmixer.  (The JAX "auto"
    falls back from a spectral plan its TPU layout refuses to a time one;
    the port's two dataflows take the same configs, so there is none.)"""
    if engine not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown engine {engine!r}; one of ('auto', 'cuda', 'torch')")
    check_ola(ola)
    if engine == "cuda" or (
        engine == "auto"
        and mesh is None
        and torch.device(device).type == "cuda"
        and make_pool_plan(config, int(hw_block_size), int(n_streams), device="cpu") is not None
    ):
        return CudaStreamPool(config, hw_block_size, n_streams, device=device, mesh=mesh, ola=ola)
    return BatchStreamingUpmixer(config, hw_block_size, n_streams, device=device, mesh=mesh)
