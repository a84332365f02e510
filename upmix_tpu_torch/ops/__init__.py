"""Host plans, tensor ops and the kernels' wrappers of the torch port.

The package exports the names `upmix_tpu.ops` exports, from the port's
own modules: the windows and the gain curves (numpy) and the tensor
framing, overlap-add and mask (torch, loaded on first use, so that a
numpy-only import of the windows does not load torch)."""

from upmix_tpu_torch.ops.gains import band_gain_curve
from upmix_tpu_torch.ops.windows import (
    design_wola_synthesis_window,
    make_blackman,
    make_blackman_harris,
    make_hamming,
    make_hann,
    make_rect,
    make_sqrt_hann,
    make_window,
    register_window,
    register_window_vector,
)

_TENSOR_OPS = {"frame_signal": "framing", "overlap_add": "framing", "center_mask": "mask"}

__all__ = [
    "design_wola_synthesis_window",
    "make_window",
    "make_blackman_harris",
    "make_sqrt_hann",
    "make_hann",
    "make_blackman",
    "make_hamming",
    "make_rect",
    "register_window",
    "register_window_vector",
    "band_gain_curve",
    "frame_signal",
    "overlap_add",
    "center_mask",
]


def __getattr__(name):
    if name in _TENSOR_OPS:
        import importlib

        return getattr(importlib.import_module(f"upmix_tpu_torch.ops.{_TENSOR_OPS[name]}"), name)
    raise AttributeError(f"module 'upmix_tpu_torch.ops' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_TENSOR_OPS))
