"""Band configuration, shared with the JAX package.

`upmix_tpu.config` imports only the standard library, so the port reuses
it as is: one definition of band chaining and block sizing for both
packages.  The one exception is a window name that is not built in:
`BandSpec.__post_init__` then looks the name up in `upmix_tpu.ops.windows`,
which imports jax.  The port supports the built-in windows only and
refuses other configs (`require_builtin_windows`).
"""

from __future__ import annotations

from upmix_tpu.config import _WINDOW_NAMES as BUILTIN_WINDOWS
from upmix_tpu.config import EPS, BandSpec, UpmixConfig, bucket_bands

__all__ = [
    "BUILTIN_WINDOWS",
    "EPS",
    "BandSpec",
    "UpmixConfig",
    "bucket_bands",
    "require_builtin_windows",
]


def require_builtin_windows(config: UpmixConfig) -> None:
    """Raise NotImplementedError for a config that names a custom window."""
    names = {config.window} | {b.window for b in config.bands}
    custom = sorted(names - set(BUILTIN_WINDOWS))
    if custom:
        raise NotImplementedError(
            f"custom window {custom[0]!r}: the torch port supports only the "
            f"built-in windows {BUILTIN_WINDOWS} (custom windows are a later "
            "item of ROADMAP.md, Queue 1)"
        )
