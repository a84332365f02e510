from upmix_tpu_torch.utils.logging import get_logger
from upmix_tpu_torch.utils.profiling import RealtimeMeter, time_fn

__all__ = ["get_logger", "RealtimeMeter", "time_fn"]
