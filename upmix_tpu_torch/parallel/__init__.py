"""Mesh-sharded execution: data parallelism over batches of files and
sequence parallelism over the sample axis of long inputs, on the devices
of one process or of several processes that share one global mesh
(`torch.distributed`; port of `upmix_tpu/parallel/`)."""

from upmix_tpu_torch.parallel.distributed import (
    global_devices,
    init_distributed,
    is_initialized,
    local_file_shard,
    process_count,
    process_index,
)
from upmix_tpu_torch.parallel.pod_check import run_pod_check
from upmix_tpu_torch.parallel.sharded import (
    Mesh,
    Shard,
    ShardedUpmixer,
    build_sharded_offline_fn,
    make_mesh,
    sequence_plan,
)

__all__ = [
    "Mesh",
    "Shard",
    "ShardedUpmixer",
    "build_sharded_offline_fn",
    "global_devices",
    "init_distributed",
    "is_initialized",
    "local_file_shard",
    "make_mesh",
    "process_count",
    "process_index",
    "run_pod_check",
    "sequence_plan",
]
