"""The fused bucket engine: one bucket over a batch of segments, one launch.

Port of `upmix_tpu/ops/pallas_upmix.py` (fused_bucket_lcr_batch, the TPU
kernel that takes the buckets the omnibus leaves over), with the same
contract:

    x [S, 2, chunk + B - H] float32 -> (main [S, 3, chunk], spill [S, 3, B - H])

Segment s's frames f = 0 .. chunk/H - 1 read x[s, :, f*H : f*H + B] and
go through the windowed banded DFT, gain x center mask summed over the
bucket's bands, the inverse and the overlap-add; `spill` is the part past
`chunk`, which the caller adds into the next segment's head.  The plan
is the bucket's device record (`ops/omnibus.py::OmnibusBucket`: geometry,
windows, kept-bin gains and, for the kernel, the f32 direct-DFT weights
that `with_direct_weights` adds); `chunk` is read from x.  There is no bf16 hi/lo weight split:
that exists only for Mosaic.

On a CUDA tensor `fused_bucket_lcr_batch` launches `csrc/fused.cu`; on a
CPU tensor it runs `fused_bucket_lcr_batch_plain` (torch.fft).  There is
no fallback between the two.

Routing.  The port's omnibus takes any bucket, so nothing is left over as
on the TPU; the sharded path sends a bucket here when the JAX package's
gate for building a fused plan admits it (hop | block and B * 2K * 4 <=
7 MiB per direction, `upmix_tpu/models/offline.py:320`), and only such
buckets carry the direct-DFT weights (`parallel/sharded.py::route_buckets`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from upmix_tpu_torch.ops.dftmm import make_direct_plan
from upmix_tpu_torch.ops.omnibus import (
    OmnibusBucket,
    make_bucket,
    make_omnibus_plan,
    omnibus_lcr_batch_plain,
)

# CUDA kernel launches made by fused_bucket_lcr_batch (one per call).
LAUNCHES = 0

# The JAX package's fused-plan gate: weight bytes per direction.
FUSED_WEIGHT_BYTES = 7 << 20

# Dynamic shared memory of one thread block (the spectra of its frames):
# two blocks fit an SM's 228 KB beside their static tiles.
_SMEM_BUDGET = 100 * 1024
_TILE_ROWS = 64  # the inverse's row tile (csrc/tile.cuh: BM); 3 T rows fit one

# The device record of a bucket is the omnibus's (geometry, windows,
# kept-bin gains), built from a `_BucketPlan` of either package; None for
# a bucket whose gains are all zero.
FusedBucket = OmnibusBucket


def with_direct_weights(bucket: FusedBucket) -> FusedBucket:
    """The bucket with the direct-DFT weight slices the kernel multiplies
    by ([B, 2K] with the analysis window, [2K, B] with the synthesis
    window), on the bucket's device; a CPU bucket is returned as it is
    (the plain version needs none)."""
    device = bucket.gains.device
    if device.type == "cpu" or bucket.w_fwd is not None:
        return bucket
    dp = make_direct_plan(
        bucket.block, bucket.lo, bucket.lo + bucket.kept - 1,
        bucket.analysis_window.cpu().numpy(), bucket.synthesis_window.cpu().numpy(),
    )

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    return dataclasses.replace(bucket, w_fwd=dev(dp.w_fwd), w_inv=dev(dp.w_inv))


def make_fused_bucket(p, device) -> FusedBucket | None:
    """Device record of one bucket plan for the fused kernel, weights included."""
    b = make_bucket(p, device)
    return None if b is None else with_direct_weights(b)


def tile_frames(bucket: FusedBucket) -> int:
    """Output frame positions T per thread block of the kernel: as many as
    the spectra of its T + B/H - 1 frames (3 x 2K floats each) allow in
    `_SMEM_BUDGET`, and 3 T rows within one 64-row tile; 0 when not even
    one fits."""
    n_frames = _SMEM_BUDGET // (3 * 2 * bucket.kept * 4)
    return max(0, min(n_frames - (bucket.block // bucket.hop - 1), _TILE_ROWS // 3))


def takes_fused(bucket: FusedBucket) -> bool:
    """The routing gate: the bucket's weights within FUSED_WEIGHT_BYTES per
    direction and at least one frame position per block."""
    return bucket.block * 2 * bucket.kept * 4 <= FUSED_WEIGHT_BYTES and tile_frames(bucket) > 0


def _chunk(x: torch.Tensor, bucket: FusedBucket) -> int:
    chunk = x.shape[-1] - bucket.spill if x.dim() == 3 else -1
    if x.dim() != 3 or x.shape[1] != 2 or chunk < bucket.hop or chunk % bucket.hop:
        raise ValueError(
            f"expected x [S, 2, chunk + {bucket.spill}] with chunk a positive multiple of "
            f"hop {bucket.hop}, got {tuple(x.shape)}"
        )
    return chunk


def fused_bucket_lcr_batch(x: torch.Tensor, bucket: FusedBucket):
    """x [S, 2, chunk + B - H] float32 -> (main [S, 3, chunk], spill
    [S, 3, B - H]), views of one [S, 3, chunk + B - H] tensor.  A CPU
    tensor runs the plain version; a CUDA tensor runs the kernel."""
    if x.device.type == "cpu":
        return fused_bucket_lcr_batch_plain(x, bucket)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bucket_lcr_batch runs on cpu or cuda, not {x.device}")
    chunk = _chunk(x, bucket)
    y = _fused_cuda(x, bucket, chunk)
    return y[:, :, :chunk], y[:, :, chunk:]


def fused_bucket_lcr(x: torch.Tensor, bucket: FusedBucket):
    """Single segment: x [2, chunk + B - H] -> (main [3, chunk], spill [3, B - H])."""
    main, spill = fused_bucket_lcr_batch(x[None], bucket)
    return main[0], spill[0]


def _fused_cuda(x: torch.Tensor, b: FusedBucket, chunk: int) -> torch.Tensor:
    global LAUNCHES
    from upmix_tpu_torch.ops import _build

    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the fused kernel takes a contiguous float32 tensor")
    if b.w_fwd is None or b.w_fwd.device != x.device:
        raise ValueError(
            f"bucket lives on {b.gains.device} without direct weights (with_direct_weights), input on {x.device}"
        )
    T = tile_frames(b)
    if T < 1:
        raise ValueError(f"bucket B={b.block} K={b.kept}: its spectra do not fit the kernel's block")
    lib = _build.load()
    S, _, width = x.shape
    y = torch.empty((S, 3, width), dtype=torch.float32, device=x.device)
    rc = lib.fused_lcr(
        x.data_ptr(), b.w_fwd.data_ptr(), b.w_inv.data_ptr(), b.gains.data_ptr(), y.data_ptr(),
        S, chunk // b.hop, b.hop, b.block, b.kept, b.gains.shape[0], T, width,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"fused_lcr launch failed: cudaError {rc}")
    return y


def fused_bucket_lcr_batch_plain(x: torch.Tensor, bucket: FusedBucket):
    """The plain PyTorch version, same contract: the omnibus's plain
    version over this one bucket (torch.fft, in x's dtype: float64 gives
    a reference for the float32 kernel)."""
    return omnibus_lcr_batch_plain(x, make_omnibus_plan([bucket], _chunk(x, bucket)))
