"""The fused bucket engine: one bucket over a batch of segments.

Port of `upmix_tpu/ops/pallas_upmix.py` (fused_bucket_lcr_batch, the TPU
kernel that takes the buckets the omnibus leaves over), with the same
contract:

    x [S, 2, chunk + B - H] float32 -> (main [S, 3, chunk], spill [S, 3, B - H])

Segment s's frames f = 0 .. chunk/H - 1 read x[s, :, f*H : f*H + B] and
go through the windowed FFT, gain x center mask summed over the bucket's
bands, the inverse and the overlap-add; `spill` is the part past
`chunk`, which the caller adds into the next segment's head.  The plan
is the bucket's device record (`ops/omnibus.py::OmnibusBucket`:
geometry, windows, kept-bin gains, FFT tables); `chunk` is read from x.

This is the omnibus's function on one bucket, so on a CUDA tensor
`fused_bucket_lcr_batch` launches the omnibus's kernels (`csrc/omnibus.cu`
on `csrc/fft.cuh`) on that bucket alone, writing its span rather than
adding into it: one launch up to `fftplan.FFT_MAX` points, two for a
wider bucket (`launches_per_bucket`), at `omnibus.launch_geometry`.  On a CPU tensor it runs
`fused_bucket_lcr_batch_plain` (torch.fft).  There is no fallback
between the two.

Routing.  The port's omnibus takes every bucket of kernel geometry
(`omnibus.kernel_geometry`: a power-of-two block whose hop divides it);
the sharded path sends such a bucket here when the JAX package's gate
for building a fused plan admits it (hop | block and B * 2K * 4 <= 7 MiB
per direction, `upmix_tpu/models/offline.py:320`;
`parallel/sharded.py::route_buckets`), and runs the other geometries on
torch.fft inside each shard.
"""

from __future__ import annotations

import torch

from upmix_tpu_torch.ops import _build
from upmix_tpu_torch.ops.omnibus import (
    OmnibusBucket,
    check_kernel_tables,
    launch_bucket,
    make_omnibus_plan,
    omnibus_lcr_batch_plain,
)

# The JAX package's fused-plan gate: weight bytes per direction.
FUSED_WEIGHT_BYTES = 7 << 20

# The device record of a bucket is the omnibus's (geometry, windows,
# kept-bin gains, FFT tables), built by `omnibus.make_bucket` from a
# `_BucketPlan` of either package.
FusedBucket = OmnibusBucket


def takes_fused(bucket: FusedBucket) -> bool:
    """The routing gate, the JAX package's (`upmix_tpu/models/offline.py:
    320`): hop | block and the bucket's direct-DFT weights, B x 2K
    float32, within FUSED_WEIGHT_BYTES per direction.  The kernel builds no
    such weights; the gate keeps the JAX package's routing."""
    return bucket.block % bucket.hop == 0 and bucket.block * 2 * bucket.kept * 4 <= FUSED_WEIGHT_BYTES


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
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the fused kernel takes a contiguous float32 tensor")
    check_kernel_tables(b, x.device)
    S, _, width = x.shape
    with _build.kernels(x.device) as k:
        y = torch.empty((S, 3, width), dtype=torch.float32, device=x.device)
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        launch_bucket(k, "K2", x, y, b, chunk // b.hop, False, n_sm)
    return y


def fused_bucket_lcr_batch_plain(x: torch.Tensor, bucket: FusedBucket):
    """The plain PyTorch version, same contract: the omnibus's plain
    version over this one bucket (torch.fft, in x's dtype: float64 gives
    a reference for the float32 kernel)."""
    return omnibus_lcr_batch_plain(x, make_omnibus_plan([bucket], _chunk(x, bucket)))
