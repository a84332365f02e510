from upmix_tpu_torch.models.offline import Upmixer, upmix_offline

__all__ = ["Upmixer", "upmix_offline"]
