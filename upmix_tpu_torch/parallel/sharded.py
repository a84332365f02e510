"""Sharded offline pipeline: a batch axis over the mesh's ``data`` axis and
the sample axis of long inputs over its ``seq`` axis.

Port of `upmix_tpu/parallel/sharded.py`, for the devices of one process.
Each ``seq`` shard takes a contiguous chunk of samples (a multiple of
every block and hop, so shard edges land on every bucket's frame grid).
Frames that straddle a shard edge need the right neighbour's first
``halo = max(block - hop)`` samples, and a shard's overlap-add spills
``halo`` output samples into the right neighbour's head.  Both halo
exchanges are explicit steps around a per-shard body that does not
communicate (`_local_lcr`):

  - input: each shard receives its right neighbour's first `halo`
    samples; the last shard receives zeros (its halo lies in the padding);
  - output: each shard's tail [chunk:] is added into its right
    neighbour's head.

Between devices of one process both are copies; meshes that span
processes (`torch.distributed`) are a later item of ROADMAP.md.

Shards that share a device run as rows of one launch per kernel and
bucket, so a mesh may repeat a device: `make_mesh({"data": 2, "seq": 4},
devices=["cuda:0"] * 8)` runs a 2 x 4 mesh on one card, as XLA's virtual
host devices do for the JAX package.  Inside the body each bucket goes to
the kernel whose design fits it: the fused bucket kernel (ops/fused.py)
for buckets within its gate, one omnibus call (ops/omnibus.py) over the
rest.  A bucket no kernel takes (hop not dividing the block, or a block
that is not a power of two: `ops/omnibus.py::kernel_geometry`) runs
inside every shard's [chunk + halo] input on torch.fft, as the JAX body
runs it on XLA (`upmix_tpu/parallel/sharded.py:213-240`): gather
framing, the spectral core, the overlap-add, added into the
shard's output before the output-halo add.  `sequence_plan` makes the
chunk a multiple of lcm(block, hop) for every bucket, so shard edges
land on every bucket's frame grid at any overlap.  A mesh without a
``seq`` axis is pure data parallelism: each device's rows go through
the offline path (`models/offline.py::build_offline_rows_fn`, which
routes by geometry itself).  There is no `kernel=` or `use_pallas=`
knob: the geometry decides the route, as everywhere in the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as tnf

from upmix_tpu_torch.config import UpmixConfig, bucket_bands
from upmix_tpu_torch.models.offline import _spectral_lcr, build_offline_rows_fn, plans_from_numpy
from upmix_tpu_torch.ops.framing import frame_signal, overlap_add
from upmix_tpu_torch.ops.fused import fused_bucket_lcr_batch, takes_fused
from upmix_tpu_torch.ops.gains import band_gain_curve
from upmix_tpu_torch.ops.omnibus import kernel_geometry, make_omnibus_plan, omnibus_lcr_batch
from upmix_tpu_torch.ops.windows import design_wola_synthesis_window, make_window


@dataclass(frozen=True, eq=False)
class Mesh:
    """Devices on named axes: `devices` is an object array of
    torch.device whose shape gives the axes' sizes, in the order of
    `axis_names`."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(axis_sizes: dict | None = None, devices=None) -> Mesh:
    """Build a mesh over `devices` (default: every visible CUDA device).

    axis_sizes e.g. {"data": 2, "seq": 4}; defaults to all devices on one
    ``seq`` axis (the long-file case).  `devices` may repeat a device:
    its shards then run as rows of one launch.
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if axis_sizes is None:
        axis_sizes = {"seq": len(devices)}
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes[n] for n in names)
    total = math.prod(sizes)
    if total > len(devices) or total < 1:
        raise ValueError(f"mesh needs {total} devices, have {len(devices)}")
    arr = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        arr[i] = d
    return Mesh(arr.reshape(sizes), names)


def _device_grid(mesh: Mesh, data_axis: str | None, seq_axis: str | None) -> np.ndarray:
    """[D, Q] object array: the device of data index d and seq index q
    (size 1 for an axis that is None; other axes at index 0)."""
    names = mesh.axis_names
    sub = mesh.devices[tuple(slice(None) if n in (data_axis, seq_axis) else 0 for n in names)]
    kept = [n for n in names if n in (data_axis, seq_axis)]
    sub = sub.transpose([kept.index(a) for a in (data_axis, seq_axis) if a is not None])
    if data_axis is None:
        sub = sub[None]
    if seq_axis is None:
        sub = sub[:, None]
    return sub


@dataclass(frozen=True)
class _SeqBucketPlan:
    block_size: int
    hop_size: int
    analysis_window: np.ndarray
    synthesis_window: np.ndarray
    gains: np.ndarray  # [n_bands, n_bins]


@dataclass(frozen=True)
class SequencePlan:
    """Host-side geometry of a sequence-sharded run."""

    n_samples: int
    n_devices: int
    chunk: int  # samples per device (multiple of every hop)
    halo: int  # max(block - hop) over buckets
    n_padded: int  # chunk * n_devices


def _plan_seq_buckets(config: UpmixConfig):
    plans = []
    for block_size, bands in bucket_bands(config.bands).items():
        hop = bands[0].hop_size
        aw = make_window(config.window, block_size)
        if config.synthesis == "wola":
            sw = design_wola_synthesis_window(aw, config.overlap)
        elif config.synthesis == "analysis":
            sw = aw
        else:
            raise ValueError(f"unknown synthesis mode {config.synthesis!r}")
        gains = np.stack([band_gain_curve(b, dtype=np.float32) for b in bands])
        plans.append(
            _SeqBucketPlan(
                block_size=block_size,
                hop_size=hop,
                analysis_window=aw,
                synthesis_window=sw,
                gains=gains,
            )
        )
    return plans


def sequence_plan(config: UpmixConfig, n_samples: int, n_seq: int) -> SequencePlan:
    """Choose the per-device chunk size: a multiple of every bucket's block
    size (so per-device frame counts divide the grouped-framing factor K)
    AND hop size (so shard boundaries land on the global frame grid —
    required for exactness at ANY overlap, not just power-of-two ones;
    found by the round-5 config fuzz at overlap=0.65), at least as large
    as the largest input halo ``block - hop``."""
    buckets = _plan_seq_buckets(config)
    unit = 1
    for p in buckets:
        bu = p.block_size * p.hop_size // math.gcd(p.block_size, p.hop_size)
        unit = unit * bu // math.gcd(unit, bu)
    if unit > (1 << 24):
        # Pathological overlaps (hop coprime to the blocks) drive the
        # frame-grid LCM into the tens of millions of samples per device;
        # reject at config time rather than compile an absurd chunk.
        raise ValueError(
            f"sequence sharding needs a per-device chunk that is a "
            f"multiple of every block AND hop; this config's LCM is "
            f"{unit} samples (> {1 << 24}) — use a divisible overlap "
            "(hop | block) or process unsharded"
        )
    halo = max(p.block_size - p.hop_size for p in buckets)
    chunk = max(math.ceil(n_samples / (n_seq * unit)), 1) * unit
    while chunk < halo:
        chunk += unit
    n_padded = chunk * n_seq
    if n_padded > max(4 * n_samples, n_samples + (1 << 22)):
        # The frame-grid unit can dwarf a short input (e.g. overlap 0.65
        # with blocks 256+512 gives unit ~8.2M): padding a clip by
        # orders of magnitude would look like a hang/OOM, not a run.
        # Reject cleanly; the unsharded pipeline handles any length.
        raise ValueError(
            f"sequence sharding would pad {n_samples} samples to "
            f"{n_padded} (chunk {chunk} x {n_seq} devices; frame-grid "
            f"unit {unit}) — input too short for this config's shard "
            "geometry; process unsharded or use a divisible overlap"
        )
    return SequencePlan(
        n_samples=n_samples,
        n_devices=n_seq,
        chunk=chunk,
        halo=halo,
        n_padded=chunk * n_seq,
    )


def route_buckets(buckets, chunk: int):
    """(omnibus plan or None, fused buckets): each live bucket of a device
    plan to K2 when the JAX package's fused gate admits it
    (`ops/fused.py::takes_fused`), else to the omnibus (K1).  The device
    plan holds the buckets of `kernel_geometry` only (`_device_plans`)."""
    live = [b for b in buckets if b is not None]
    fused = tuple(b for b in live if takes_fused(b))
    return make_omnibus_plan([b for b in live if not takes_fused(b)], chunk), fused


def split_plans(config: UpmixConfig) -> tuple:
    """(kernel plans, leftover plans) of the config's buckets
    (`_SeqBucketPlan`): the kernels take the first (`kernel_geometry`),
    torch.fft the rest inside each shard (`_leftover_lcr`)."""
    plans = _plan_seq_buckets(config)
    ok = [p for p in plans if kernel_geometry(p.block_size, p.hop_size)]
    return ok, [p for p in plans if not kernel_geometry(p.block_size, p.hop_size)]


def _leftover_lcr(x_ext: torch.Tensor, plan: _SeqBucketPlan, chunk: int) -> torch.Tensor:
    """One leftover bucket inside a shard: x_ext [rows, 2, >= chunk + B - H]
    -> [rows, 3, chunk + B - H].  Frames f = 0 .. chunk/H - 1 start in
    the shard (sequence_plan makes chunk % H == 0); gather framing, the
    spectral core and the overlap-add, as the JAX body
    (`upmix_tpu/parallel/sharded.py:213-227`)."""
    B, H = plan.block_size, plan.hop_size
    F = chunk // H
    frames = frame_signal(x_ext[..., : (F - 1) * H + B], B, H, F)
    return overlap_add(_spectral_lcr(plan, frames), H)


def _local_lcr(x_ext: torch.Tensor, chunk: int, halo: int, omni_plan, fused: tuple, leftover: tuple) -> torch.Tensor:
    """Per-shard body, no communication: x_ext [rows, 2, chunk + halo]
    (each shard's samples and its input halo) -> [rows, 3, chunk + halo],
    the shard's output with its spill tail past `chunk`."""
    y = x_ext.new_zeros((x_ext.shape[0], 3, chunk + halo))
    parts = []
    if omni_plan is not None:
        parts.append((omnibus_lcr_batch, omni_plan, omni_plan.halo))
    parts += [(fused_bucket_lcr_batch, b, b.spill) for b in fused]
    for kernel, plan, spill in parts:
        main, tail = kernel(x_ext[..., : chunk + spill].contiguous(), plan)
        y[..., :chunk] += main
        y[..., chunk : chunk + spill] += tail
    for plan in leftover:
        contrib = _leftover_lcr(x_ext, plan, chunk)
        y[..., : contrib.shape[-1]] += contrib
    return y


def _run_grouped(items, body) -> list:
    """items: (device, tensor [rows_i, ...]) pairs.  Items that share a
    device run as rows of one body(device, rows) call; returns each
    item's rows of the result, in order."""
    groups = {}
    for k, (dev, _) in enumerate(items):
        groups.setdefault(dev, []).append(k)
    out = [None] * len(items)
    for dev, ks in groups.items():
        rows = torch.cat([items[k][1].to(dev) for k in ks])
        for k, part in zip(ks, body(dev, rows).split([items[k][1].shape[0] for k in ks])):
            out[k] = part
    return out


def build_sharded_offline_fn(
    config: UpmixConfig,
    n_samples: int,
    mesh: Mesh,
    data_axis: str | None = "data",
    seq_axis: str | None = "seq",
    buckets: dict | None = None,
):
    """Build the sharded pipeline.

    Returns (fn, plan): fn maps x [batch, 2, n_padded] -> y [batch, 3,
    n_padded] float32 on the mesh's first device, with batch split over
    `data_axis` (if present in the mesh; batch must divide evenly) and
    samples over `seq_axis`.  A mesh without `seq_axis` is pure data
    parallelism (one sequence shard, no halo exchange).  Use `plan` to
    pad and trim.  `buckets` maps a device to its device plan
    (`plans_from_numpy`) and is filled in for devices it lacks, so a
    caller can share the plans between lengths.  Buckets off the kernels'
    geometry run on torch.fft inside each shard (`_leftover_lcr`).
    """
    shape = mesh.shape
    if seq_axis is not None and seq_axis not in shape:
        seq_axis = None
    if data_axis is not None and data_axis not in shape:
        data_axis = None
    grid = _device_grid(mesh, data_axis, seq_axis)
    n_data, n_seq = grid.shape
    out_dev = mesh.devices.flat[0]
    buckets = {} if buckets is None else buckets
    kernel_plans, leftover = split_plans(config)
    for dev in set(grid.flat):
        if dev not in buckets:
            buckets[dev] = plans_from_numpy(kernel_plans, dev)
    # Dead leftovers (all gains zero) add nothing.
    leftover = tuple(p for p in leftover if p.gains.any())

    def split_batch(x, n_padded):
        if x.dim() != 3 or x.shape[1] != 2 or x.shape[2] != n_padded or x.shape[0] % n_data:
            raise ValueError(
                f"expected x [batch, 2, {n_padded}] with batch a multiple of {n_data}, "
                f"got {tuple(x.shape)}"
            )
        return x.shape[0] // n_data

    if seq_axis is None:
        # Pure data parallelism: no shard edges in the sample axis, so none
        # of the sequence machinery applies; each device's rows go through
        # the chunked offline path.
        rows_fns = {
            dev: build_offline_rows_fn(config, n_samples, device=dev, buckets=buckets[dev])
            for dev in set(grid.flat)
        }
        plan = SequencePlan(
            n_samples=n_samples, n_devices=1, chunk=n_samples, halo=0, n_padded=n_samples,
        )

        def fn(x: torch.Tensor) -> torch.Tensor:
            bl = split_batch(x, n_samples)
            items = [(grid[d, 0], x[d * bl : (d + 1) * bl]) for d in range(n_data)]
            ys = _run_grouped(items, lambda dev, rows: rows_fns[dev](rows))
            return torch.cat([y.to(out_dev) for y in ys])

        return fn, plan

    plan = sequence_plan(config, n_samples, n_seq)
    chunk, halo = plan.chunk, plan.halo
    routes = {dev: route_buckets(buckets[dev], chunk) for dev in set(grid.flat)}

    def fn(x: torch.Tensor) -> torch.Tensor:
        bl = split_batch(x, plan.n_padded)
        shards = [
            [x[d * bl : (d + 1) * bl, :, q * chunk : (q + 1) * chunk].to(grid[d, q]) for q in range(n_seq)]
            for d in range(n_data)
        ]
        # Input halo: each shard gets its right neighbour's first `halo`
        # samples (chunk >= halo); the last shard gets zeros.
        items = []
        for d in range(n_data):
            for q in range(n_seq):
                own = shards[d][q]
                if q + 1 < n_seq:
                    head = shards[d][q + 1][..., :halo].to(own.device)
                else:
                    head = own.new_zeros(own.shape[:-1] + (halo,))
                items.append((grid[d, q], torch.cat([own, head], dim=-1)))
        ys = _run_grouped(items, lambda dev, rows: _local_lcr(rows, chunk, halo, *routes[dev], leftover))
        # Output halo: each shard's tail [chunk:] lands on its right
        # neighbour's head (disjoint from that neighbour's own tail).
        y = torch.empty((x.shape[0], 3, plan.n_padded), dtype=torch.float32, device=out_dev)
        for d in range(n_data):
            for q in range(n_seq):
                own = ys[d * n_seq + q]
                if q > 0:
                    own[..., :halo] += ys[d * n_seq + q - 1][..., chunk:].to(own.device)
                y[d * bl : (d + 1) * bl, :, q * chunk : (q + 1) * chunk] = own[..., :chunk]
        return y

    return fn, plan


class ShardedUpmixer:
    """Mesh-sharded offline upmixer for batches of (long) inputs.

    process_batch(x): x [batch, 2, n] float — returns [batch, 3, n]
    (C, Ls, Rs) on the mesh's first device.  The batch axis is
    data-parallel; the sample axis is sequence-parallel with halo
    exchange.
    """

    def __init__(self, config: UpmixConfig, mesh: Mesh | None = None):
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh()
        self._cache = {}
        self._buckets = {}  # device -> device plan, shared by every length
        # Fail n-independent geometry problems (pathological frame-grid
        # LCM) at construction, not first process(); the n-dependent
        # padding-blowup check still runs per call in sequence_plan.
        # A data-only mesh has no sequence shards, hence no frame-grid
        # constraints at all.
        if "seq" in self.mesh.shape:
            sequence_plan(config, 1 << 30, self.mesh.shape["seq"])

    def _compiled(self, n_padded: int):
        if n_padded not in self._cache:
            self._cache[n_padded] = build_sharded_offline_fn(
                self.config, n_padded, self.mesh, buckets=self._buckets
            )
        return self._cache[n_padded]

    def process_batch(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.ndim != 3 or x.shape[1] != 2:
            raise ValueError(f"expected [batch, 2, n], got {tuple(x.shape)}")
        batch, _, n = x.shape
        fn, plan = self._compiled(n)
        pad_b = 0
        if "data" in self.mesh.shape:
            # The batch axis must divide evenly across the data axis.
            d = self.mesh.shape["data"]
            pad_b = -(-batch // d) * d - batch
        if pad_b or plan.n_padded != n:
            x = tnf.pad(x, (0, plan.n_padded - n, 0, 0, 0, pad_b))
        return fn(x)[:batch, :, :n]

    def process(self, L, R):
        """Single stereo pair convenience: returns (C, Ls, Rs)."""
        x = torch.stack([torch.as_tensor(L, dtype=torch.float32), torch.as_tensor(R, dtype=torch.float32)])
        y = self.process_batch(x[None])[0]
        return y[0], y[1], y[2]

    def process_np(self, L, R):
        """Upmixer-compatible numpy-out variant."""
        return tuple(t.cpu().numpy() for t in self.process(L, R))
