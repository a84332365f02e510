from upmix_tpu_torch.models.offline import Upmixer, upmix_offline
from upmix_tpu_torch.models.streaming import (
    BatchStreamingUpmixer,
    CudaStreamPool,
    StreamingUpmixer,
    make_stream_pool,
    mix_stereo_sum,
)

__all__ = [
    "Upmixer",
    "upmix_offline",
    "StreamingUpmixer",
    "BatchStreamingUpmixer",
    "CudaStreamPool",
    "make_stream_pool",
    "mix_stereo_sum",
]
