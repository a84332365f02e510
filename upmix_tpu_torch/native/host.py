"""ctypes loader and Python wrapper for the native streaming engine.

The port's copy of `upmix_tpu/native/host.py`: it loads the same
`native/libupmix_host.so` (`make -C native`, the repo's own C++; no
framework), and a custom window's per-band vectors come from the port's
`config.chain_bands` and `ops.windows.make_window`, bit for bit the JAX
package's."""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libupmix_host.so",
)

_XOVER_MODES = {"raised_cosine": 0, "hard_zero": 1}
_SYNTHESIS = {"wola": 0, "analysis": 1}
_ROUNDING = {"python": 0, "cpp": 1}
_WINDOWS = {
    "blackman_harris": 0,
    "sqrt_hann": 1,
    "hann": 2,
    "blackman": 3,
    "hamming": 4,
    "rect": 5,
}

_f32p = ctypes.POINTER(ctypes.c_float)


def library_path() -> str:
    return _LIB_PATH


def is_available() -> bool:
    try:
        return _load() is not None
    except OSError:
        return False


_ABI_VERSION = 5  # must match upmix_abi_version() in upmix_host.cpp

_PRECISIONS = {"double": 0, "float": 1}


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_LIB_PATH)
        # A stale library would silently drop trailing arguments (the C
        # calling convention ignores extras) — refuse version mismatches.
        try:
            got = lib.upmix_abi_version()
        except AttributeError:
            got = 1
        if got != _ABI_VERSION:
            raise OSError(
                f"{_LIB_PATH}: ABI version {got}, expected {_ABI_VERSION} — "
                "rebuild with `make -C native`"
            )
        lib.upmix_create.restype = ctypes.c_void_p
        lib.upmix_create.argtypes = [
            ctypes.c_double,  # sr
            ctypes.c_int,  # hw_block
            ctypes.POINTER(ctypes.c_double),  # edges
            ctypes.c_int,  # n_edges
            ctypes.c_int,  # xover_mode
            ctypes.c_int,  # synthesis
            ctypes.c_int,  # rounding
            ctypes.c_double,  # threshold_multi
            ctypes.c_double,  # xo_fraction
            ctypes.c_int,  # window
            ctypes.c_int,  # n_threads
            ctypes.c_int,  # precision
        ]
        lib.upmix_create_custom.restype = ctypes.c_void_p
        lib.upmix_create_custom.argtypes = [
            ctypes.c_double,  # sr
            ctypes.c_int,  # hw_block
            ctypes.POINTER(ctypes.c_double),  # edges
            ctypes.c_int,  # n_edges
            ctypes.c_int,  # xover_mode
            ctypes.c_int,  # synthesis
            ctypes.c_int,  # rounding
            ctypes.c_double,  # threshold_multi
            ctypes.c_double,  # xo_fraction
            _f32p,  # win_data (all bands' windows, concatenated)
            ctypes.POINTER(ctypes.c_longlong),  # win_off (n_win + 1)
            ctypes.c_int,  # n_win
            ctypes.c_int,  # n_threads
            ctypes.c_int,  # precision
        ]
        lib.upmix_destroy.argtypes = [ctypes.c_void_p]
        lib.upmix_num_bands.restype = ctypes.c_int
        lib.upmix_num_bands.argtypes = [ctypes.c_void_p]
        lib.upmix_band_block_size.restype = ctypes.c_int
        lib.upmix_band_block_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.upmix_latency_blocks.restype = ctypes.c_int
        lib.upmix_latency_blocks.argtypes = [ctypes.c_void_p]
        lib.upmix_process_block.restype = ctypes.c_int
        lib.upmix_process_block.argtypes = [ctypes.c_void_p] + [_f32p] * 5
        lib.upmix_process_stereo_sum.restype = ctypes.c_int
        lib.upmix_process_stereo_sum.argtypes = (
            [ctypes.c_void_p, _f32p, _f32p, ctypes.c_int, _f32p, _f32p]
        )
        lib.upmix_reset.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


class NativeStreamingUpmixer:
    """C++ streaming engine with the same surface as StreamingUpmixer.

    band_edges are raw Hz edges (Nyquist appended automatically, as in
    chain_bands); the engine is fixed 75% overlap with block sizes capped
    at hw_block*4 (streaming semantics).
    """

    def __init__(
        self,
        band_edges,
        sr: float,
        hw_block_size: int,
        xover_mode: str = "raised_cosine",
        synthesis: str = "wola",
        bin_rounding: str = "python",
        threshold_factor: float = 32.0,
        xo_fraction: float = 0.25,
        window: str = "blackman_harris",
        n_threads: int = 1,
        precision: str = "double",
    ):
        """n_threads: band-parallel worker count inside the engine (the
        native equivalent of the reference's ThreadPoolExecutor over
        bands, center_extraction.py:499-511).  1 = serial (default —
        real-time callers usually pin one core), 0 = auto
        (min(n_bands, cores)).  Outputs are bit-identical either way:
        the band sum is reduced in band order on the calling thread.

        precision: working precision of the FFT/mask pipeline.
        "double" (default) matches the oracle's float64 spectra;
        "float" is the fast mode — half the memory traffic, roughly
        2x throughput on SIMD cores, still >60 dB vs the oracle
        (engine outputs are float32 either way)."""
        if precision not in _PRECISIONS:
            raise ValueError(
                f"unknown precision {precision!r}; one of "
                f"{tuple(_PRECISIONS)}"
            )
        lib = _load()
        edges = np.asarray(list(band_edges), dtype=np.float64)
        self._lib = lib
        self.hw_block_size = int(hw_block_size)
        self.sr = float(sr)
        if window in _WINDOWS:
            self._h = lib.upmix_create(
                ctypes.c_double(self.sr),
                self.hw_block_size,
                edges.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                len(edges),
                _XOVER_MODES[xover_mode],
                _SYNTHESIS[synthesis],
                _ROUNDING[bin_rounding],
                ctypes.c_double(threshold_factor),
                ctypes.c_double(xo_fraction),
                _WINDOWS[window],
                int(n_threads),
                _PRECISIONS[precision],
            )
        else:
            # Registered custom window (ops.windows registry):
            # generate each band's float32 coefficients in Python — the
            # SAME vectors the oracle and the JAX kernels bake — and pass
            # them through the concatenated-windows create.  Band block
            # sizes come from the same chain_bands sizing rule the C++
            # engine applies internally (hw*4 cap, 8-band clamp).
            from upmix_tpu_torch.config import MAX_BANDS_STREAM, chain_bands
            from upmix_tpu_torch.ops.windows import make_window

            bands = chain_bands(
                [float(e) for e in edges],
                overlap=0.75,
                window=window,  # validates registry membership
                sr=self.sr,
                xover_mode=xover_mode,
                max_block_size=self.hw_block_size * 4,
                threshold_factor=threshold_factor,
                xo_fraction=xo_fraction,
                bin_rounding=bin_rounding,
            )[:MAX_BANDS_STREAM]
            vecs = [make_window(window, b.block_size) for b in bands]
            win_data = np.ascontiguousarray(
                np.concatenate(vecs), dtype=np.float32
            )
            win_off = np.zeros(len(vecs) + 1, dtype=np.int64)
            win_off[1:] = np.cumsum([len(v) for v in vecs])
            self._h = lib.upmix_create_custom(
                ctypes.c_double(self.sr),
                self.hw_block_size,
                edges.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                len(edges),
                _XOVER_MODES[xover_mode],
                _SYNTHESIS[synthesis],
                _ROUNDING[bin_rounding],
                ctypes.c_double(threshold_factor),
                ctypes.c_double(xo_fraction),
                _ptr(win_data),
                win_off.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                len(vecs),
                int(n_threads),
                _PRECISIONS[precision],
            )
        if not self._h:
            raise ValueError(
                "upmix_create failed (bad sr/hw_block/edges combination)"
            )

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.upmix_destroy(h)
            self._h = None

    @property
    def num_bands(self) -> int:
        return self._lib.upmix_num_bands(self._h)

    @property
    def block_sizes(self):
        return [
            self._lib.upmix_band_block_size(self._h, i)
            for i in range(self.num_bands)
        ]

    @property
    def latency_blocks(self) -> int:
        return self._lib.upmix_latency_blocks(self._h)

    def reset(self):
        self._lib.upmix_reset(self._h)

    def push_block(self, in_l, in_r):
        """One hardware block in → (C, Ls, Rs) out, each [hw]."""
        hw = self.hw_block_size
        in_l = np.ascontiguousarray(in_l, dtype=np.float32)
        in_r = np.ascontiguousarray(in_r, dtype=np.float32)
        if in_l.shape != (hw,) or in_r.shape != (hw,):
            raise ValueError(f"blocks must be shape ({hw},)")
        c = np.empty(hw, np.float32)
        ls = np.empty(hw, np.float32)
        rs = np.empty(hw, np.float32)
        self._lib.upmix_process_block(
            self._h, _ptr(in_l), _ptr(in_r), _ptr(c), _ptr(ls), _ptr(rs)
        )
        return c, ls, rs

    def process_signal(self, L, R, mix: str = "lcr"):
        """Whole-signal streaming (truncates to whole hw blocks)."""
        hw = self.hw_block_size
        n = (len(L) // hw) * hw
        L = np.ascontiguousarray(L[:n], dtype=np.float32)
        R = np.ascontiguousarray(R[:n], dtype=np.float32)
        if mix == "stereo_sum":
            out_l = np.empty(n, np.float32)
            out_r = np.empty(n, np.float32)
            rc = self._lib.upmix_process_stereo_sum(
                self._h, _ptr(L), _ptr(R), n, _ptr(out_l), _ptr(out_r)
            )
            if rc != 0:
                raise RuntimeError("upmix_process_stereo_sum failed")
            return out_l, out_r
        if mix != "lcr":
            raise ValueError(f"unknown mix {mix!r}; one of ('lcr', 'stereo_sum')")
        C = np.empty(n, np.float32)
        Ls = np.empty(n, np.float32)
        Rs = np.empty(n, np.float32)
        for s in range(0, n, hw):
            c, ls, rs = self.push_block(L[s : s + hw], R[s : s + hw])
            C[s : s + hw] = c
            Ls[s : s + hw] = ls
            Rs[s : s + hw] = rs
        return C, Ls, Rs
