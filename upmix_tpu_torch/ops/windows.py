"""Analysis windows, the runtime registry of custom windows and the WOLA
synthesis-window design.

Numpy copies of `upmix_tpu/ops/windows.py` (the built-in windows, the
registry: `register_window`, `register_window_vector`, `window_names`,
`is_known_window`, `window_payload`, `restore_window`,
`custom_window_vector`, and `design_wola_synthesis_window`):
the port imports nothing of the JAX package.  tests/test_torch_ops.py
pins every built-in window to the JAX package's output bit for bit, and
tests/test_torch_windows.py the registry.  A registered name is accepted
wherever a built-in one is (configs, the CLI's --window); the kernels
take the windows as arrays of their plans, so a custom window runs on
them unchanged.
"""

from __future__ import annotations

import numpy as np

from upmix_tpu_torch.config import EPS


def make_blackman_harris(N: int) -> np.ndarray:
    """4-term Blackman-Harris, a0..a3 = 0.35875/0.48829/0.14128/0.01168."""
    n = np.arange(N)
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    w = (
        a0
        - a1 * np.cos(2 * np.pi * n / (N - 1))
        + a2 * np.cos(4 * np.pi * n / (N - 1))
        - a3 * np.cos(6 * np.pi * n / (N - 1))
    )
    return w.astype(np.float32)


def make_sqrt_hann(N: int) -> np.ndarray:
    """Square-root Hann."""
    return np.sqrt(np.hanning(N)).astype(np.float32)


def make_hann(N: int) -> np.ndarray:
    """Hann."""
    return np.hanning(N).astype(np.float32)


def make_blackman(N: int) -> np.ndarray:
    """Blackman."""
    return np.blackman(N).astype(np.float32)


def make_hamming(N: int) -> np.ndarray:
    """Hamming."""
    return np.hamming(N).astype(np.float32)


def make_rect(N: int) -> np.ndarray:
    """Rectangular."""
    return np.ones(N, dtype=np.float32)


_WINDOWS = {
    "blackman_harris": make_blackman_harris,
    "sqrt_hann": make_sqrt_hann,
    "hann": make_hann,
    "blackman": make_blackman,
    "hamming": make_hamming,
    "rect": make_rect,
}
BUILTIN_WINDOWS = tuple(_WINDOWS)

# User-registered windows: name -> fn(N) -> array[N].  The name flows
# through BandSpec / UpmixConfig unchanged and make_window resolves it.
_CUSTOM: dict = {}


def register_window(name: str, fn, overwrite: bool = False) -> str:
    """Register a custom analysis-window generator under `name`.

    `fn(N) -> array[N]` is called per band with that band's block size.
    Registration is process-wide; redefining a name needs overwrite=True
    and fresh model objects (plans hold the windows they were built with).
    """
    name = str(name)
    if name in _WINDOWS:
        raise ValueError(f"{name!r} is a built-in window name")
    if name in _CUSTOM and not overwrite:
        raise ValueError(
            f"window {name!r} already registered; pass overwrite=True "
            "(and rebuild any models created with the old definition)"
        )
    probe = np.asarray(fn(16), dtype=np.float32)
    if probe.shape != (16,) or not np.all(np.isfinite(probe)):
        raise ValueError(
            f"window fn for {name!r} must return a finite length-N 1-D "
            f"array; got shape {probe.shape}"
        )
    _CUSTOM[name] = fn
    return name


def window_from_vector(vec):
    """A window generator from a fixed VECTOR: a band whose block size is
    the vector's length gets it verbatim, any other linear resampling over
    [0, 1] with the endpoints aligned.  The float32 vector is kept as
    `.vector`."""
    base = np.asarray(vec, dtype=np.float32).ravel()
    if base.size < 2:
        raise ValueError("window vector needs at least 2 samples")
    if not np.all(np.isfinite(base)):
        raise ValueError("window vector must be finite")

    def fn(N: int) -> np.ndarray:
        N = int(N)
        if N == base.size:
            return base.copy()
        x = np.linspace(0.0, 1.0, N)
        xp = np.linspace(0.0, 1.0, base.size)
        return np.interp(x, xp, base.astype(np.float64)).astype(np.float32)

    fn.vector = base
    return fn


def register_window_vector(name: str, vec, overwrite: bool = False) -> str:
    """register_window() for a fixed coefficient vector, resampled per band
    (window_from_vector)."""
    return register_window(name, window_from_vector(vec), overwrite=overwrite)


def window_names() -> tuple:
    """Every valid window name, built-ins first."""
    return tuple(_WINDOWS) + tuple(_CUSTOM)


def is_known_window(name: str) -> bool:
    return name in _WINDOWS or name in _CUSTOM


def is_builtin_window(name: str) -> bool:
    return name in _WINDOWS


def make_window(name: str, N: int) -> np.ndarray:
    fn = _WINDOWS.get(name) or _CUSTOM.get(name)
    if fn is None:
        raise ValueError(
            f"unknown window {name!r}; one of {sorted(window_names())} "
            "(register custom windows via upmix_tpu_torch.ops.windows.register_window)"
        )
    w = np.asarray(fn(int(N)), dtype=np.float32)
    if w.shape != (int(N),):
        raise ValueError(f"window {name!r} returned shape {w.shape}, expected ({N},)")
    return w


def window_payload(name: str, sizes) -> dict:
    """JSON-safe record of a registered custom window: a vector-backed one
    (register_window_vector, --window-file) as its vector, any other as
    its values at `sizes` (the block sizes of the config being saved).
    `config.config_to_dict` carries it, so two processes whose windows of
    one name differ give different dicts."""
    fn = _CUSTOM.get(name)
    if fn is None:
        raise ValueError(f"{name!r} is not a registered custom window")
    vec = getattr(fn, "vector", None)
    if vec is not None:
        return {"kind": "vector", "coeffs": [float(v) for v in vec]}
    return {
        "kind": "sampled",
        "sizes": {str(int(n)): [float(v) for v in make_window(name, int(n))] for n in sorted({int(s) for s in sizes})},
    }


def _payload_reference_coeffs(payload: dict) -> dict:
    """{size: float32 coefficients} the payload pins, for conflict checks."""
    kind = payload.get("kind")
    if kind == "vector":
        vec = np.asarray(payload["coeffs"], np.float32)
        return {int(vec.size): vec}
    if kind == "sampled":
        return {int(k): np.asarray(v, np.float32) for k, v in payload["sizes"].items()}
    raise ValueError(f"unknown window payload kind {kind!r}")


def restore_window(name: str, payload: dict, check_sizes=()) -> str:
    """Re-register `name` from a `window_payload`.

    A name already known keeps its live registration, but only after its
    coefficients are checked against the payload's at the payload's own
    sizes and at `check_sizes` (the restoring config's block sizes: a
    vector registration can agree at the vector's length and resample
    differently at the sizes in use); a registration that differs raises,
    since the plans would silently run another window."""
    if is_known_window(name):
        refs = _payload_reference_coeffs(payload)
        if payload.get("kind") == "vector":
            ref_fn = window_from_vector(np.asarray(payload["coeffs"], np.float32))
            for n in check_sizes:
                refs.setdefault(int(n), ref_fn(int(n)))
        for n, want in refs.items():
            got = make_window(name, n)
            if got.shape != want.shape or not np.allclose(got, want, rtol=1e-6, atol=1e-7):
                raise ValueError(
                    f"window {name!r} is already registered in this process with coefficients that differ from "
                    f"the artifact's at N={n}; unregister or rename the live registration before restoring this "
                    "artifact"
                )
        return name
    kind = payload.get("kind")
    if kind == "vector":
        return register_window_vector(name, np.asarray(payload["coeffs"], np.float32))
    if kind == "sampled":
        table = {int(k): np.asarray(v, np.float32) for k, v in payload["sizes"].items()}
        if not table:
            raise ValueError(f"sampled window payload for {name!r} is empty")
        resample = window_from_vector(table[max(table)])

        def fn(N: int) -> np.ndarray:
            N = int(N)
            if N in table:
                return table[N].copy()
            # A length off the table (a config edited after the restore):
            # resampled from the longest stored evaluation.
            return resample(N)

        return register_window(name, fn)
    raise ValueError(f"unknown window payload kind {kind!r} for {name!r}")


def custom_window_vector(name: str):
    """The registered vector behind `name` if it was vector-backed
    (register_window_vector, --window-file), else None: the native engine
    takes it to resample per band as the plans do."""
    fn = _CUSTOM.get(name)
    return getattr(fn, "vector", None) if fn is not None else None


def design_wola_synthesis_window(analysis_window: np.ndarray, overlap: float) -> np.ndarray:
    """w_S(n) = w_A(n) / (sum_k w_A^2((n + k*H) mod L) + EPS), with each
    term squared in float32 and summed in float64 as the reference does."""
    L = len(analysis_window)
    hop = int(L * (1.0 - overlap))
    if hop < 1:
        raise ValueError("Overlap too large; resulting hop size < 1.")
    K = int(round(1.0 / (1.0 - overlap)))
    aw = np.asarray(analysis_window)
    idx = (np.arange(L)[:, None] + np.arange(K)[None, :] * hop) % L
    terms = (aw[idx] * aw[idx]).astype(np.float64)
    denom = terms.sum(axis=1) + EPS
    return (aw / denom).astype(analysis_window.dtype)
