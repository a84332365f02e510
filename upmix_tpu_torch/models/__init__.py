from upmix_tpu_torch.models.batch import BatchUpmixer
from upmix_tpu_torch.models.offline import Upmixer, upmix_offline
from upmix_tpu_torch.models.streaming import (
    BatchStreamingUpmixer,
    CudaStreamPool,
    StreamingUpmixer,
    make_stream_pool,
    mix_stereo_sum,
)

# parallel.sharded imports models.offline, so its names load on first use.
_PARALLEL = ("ShardedUpmixer", "make_mesh")

__all__ = [
    "Upmixer",
    "upmix_offline",
    "BatchUpmixer",
    "StreamingUpmixer",
    "BatchStreamingUpmixer",
    "CudaStreamPool",
    "make_stream_pool",
    "mix_stereo_sum",
    *_PARALLEL,
]


def __getattr__(name):
    if name in _PARALLEL:
        from upmix_tpu_torch.parallel import sharded

        return getattr(sharded, name)
    raise AttributeError(f"module 'upmix_tpu_torch.models' has no attribute {name!r}")
