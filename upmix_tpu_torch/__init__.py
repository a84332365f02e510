"""upmix_tpu_torch — the PyTorch/CUDA port of upmix_tpu.

The offline whole-file upmix (the JAX package's main path) runs here on
PyTorch tensors, with its one Pallas kernel (the omnibus) rewritten as a
hand-written CUDA kernel for Hopper (`csrc/omnibus.cu`).  The layout
mirrors `upmix_tpu/` so each module's counterpart is easy to find:

  - config: UpmixConfig / BandSpec / bucket_bands / EPS, re-exported from
    the jax-free `upmix_tpu.config`
  - ops.windows, ops.gains, ops.dftmm: numpy host plans (copies of the
    JAX package's, pinned to it by tests)
  - ops.framing, ops.mask: tensor framing / overlap-add and the mask
  - ops.omnibus: the kernel's wrapper, its plain version and its plan
  - models.offline: Upmixer / upmix_offline

This package never imports jax: the machines it runs on need not have it.
"""

from upmix_tpu_torch.config import EPS, BandSpec, UpmixConfig, bucket_bands

__all__ = ["EPS", "BandSpec", "UpmixConfig", "bucket_bands", "Upmixer", "upmix_offline"]


def __getattr__(name):
    # Keep bare `import upmix_tpu_torch` light (no torch import).
    if name in ("Upmixer", "upmix_offline"):
        import upmix_tpu_torch.models as _m

        return getattr(_m, name)
    raise AttributeError(f"module 'upmix_tpu_torch' has no attribute {name!r}")
