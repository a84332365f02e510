"""ctypes bindings for the native C++ streaming host shell (the port's
copy of `upmix_tpu/native`; it runs on the host CPU, not the card).

The shared library (native/libupmix_host.so, built with `make -C native`)
implements the streaming semantics in pure C++ for low-latency local
playback without an accelerator, the native equivalent of the
reference's real-time engine (bela/upmix.cpp), held against the NumPy
oracle and the port's streaming engine by tests/test_torch_native.py.
"""

from upmix_tpu_torch.native.host import (
    NativeStreamingUpmixer,
    is_available,
    library_path,
)

__all__ = ["NativeStreamingUpmixer", "is_available", "library_path"]
