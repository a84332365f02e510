"""Mesh-sharded execution: data parallelism over batches of files and
sequence parallelism over the sample axis of long inputs, on the devices
of one process (port of `upmix_tpu/parallel/sharded.py`)."""

from upmix_tpu_torch.parallel.sharded import (
    Mesh,
    ShardedUpmixer,
    build_sharded_offline_fn,
    make_mesh,
    sequence_plan,
)

__all__ = [
    "Mesh",
    "ShardedUpmixer",
    "build_sharded_offline_fn",
    "make_mesh",
    "sequence_plan",
]
