"""Audio file I/O: dependency-free RIFF/WAVE codec + optional soundfile.

The port's own copy of `upmix_tpu/io/wav.py` (the port loads nothing of
the JAX package), pinned to it by tests/test_torch_app.py.

The reference reads anything libsndfile supports via `soundfile`
(main.py:22,43,119 — FLAC/AIFF/OGG included).  This module ships a
dependency-free RIFF/WAVE codec with the same conventions (reads return
float64 normalized to [-1, 1) for integer PCM; writes default to 32-bit
IEEE float) and uses `soundfile` opportunistically when it is installed:
non-WAV inputs (FLAC, AIFF, OGG, ...) are routed to soundfile, and raise
a clear error telling the user to install it otherwise.

Supported natively: PCM 8(read)/16/24/32-bit, IEEE float32/float64,
WAVE_FORMAT_EXTENSIBLE wrapping either, any channel count, arbitrary
chunk order.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

try:  # pragma: no cover - environment-dependent
    import soundfile as _sf

    if not hasattr(_sf, "read"):  # guard against injected stubs
        _sf = None
except ImportError:
    _sf = None

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE

_SUBTYPES = {
    "PCM_16": (_FMT_PCM, 16),
    "PCM_24": (_FMT_PCM, 24),
    "PCM_32": (_FMT_PCM, 32),
    "FLOAT": (_FMT_FLOAT, 32),
    "DOUBLE": (_FMT_FLOAT, 64),
}


def read_wav(path, always_2d: bool = False):
    """Read a WAV file → (data, sample_rate).

    data is float64; 1-D for mono unless always_2d, else [frames, channels].
    Integer PCM is normalized by 2**(bits-1) (soundfile convention).
    Non-WAV containers (FLAC/AIFF/OGG/...) are read via `soundfile` when
    installed (reference: main.py:43 reads anything libsndfile supports).
    Raises ValueError for unreadable/unsupported files either way.
    """
    with open(path, "rb") as f:
        head = f.read(12)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        if _sf is not None:
            try:
                data, sr = _sf.read(path, always_2d=always_2d, dtype="float64")
            except Exception as e:  # LibsndfileError is a RuntimeError
                raise ValueError(f"{path}: unreadable audio file ({e})") from e
            return data, int(sr)
        raise ValueError(
            f"{path}: not a RIFF/WAVE file (install `soundfile` to read "
            "FLAC/AIFF/OGG and other libsndfile formats)"
        )
    raw = Path(path).read_bytes()

    fmt = None
    data = None
    pos = 12
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        body = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = _parse_fmt(body)
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, channels, sr, bits = fmt

    if tag == _FMT_PCM and bits == 8:
        # 8-bit WAV PCM is UNSIGNED with a 128 midpoint (RIFF spec).
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
    elif tag == _FMT_PCM and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float64) / 2.0**15
    elif tag == _FMT_PCM and bits == 24:
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        i = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i = (i << 8) >> 8  # sign-extend 24 → 32
        x = i.astype(np.float64) / 2.0**23
    elif tag == _FMT_PCM and bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float64) / 2.0**31
    elif tag == _FMT_FLOAT and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float64)
    elif tag == _FMT_FLOAT and bits == 64:
        x = np.frombuffer(data, dtype="<f8").astype(np.float64)
    else:
        raise ValueError(f"{path}: unsupported format tag={tag} bits={bits}")

    frames = len(x) // channels
    x = x[: frames * channels].reshape(frames, channels)
    if channels == 1 and not always_2d:
        x = x[:, 0]
    return x, sr


def _parse_fmt(body: bytes):
    if len(body) < 16:
        raise ValueError(f"fmt chunk too short ({len(body)} bytes)")
    tag, channels, sr, _byte_rate, _align, bits = struct.unpack_from("<HHIIHH", body, 0)
    if channels < 1:
        raise ValueError(f"fmt chunk declares {channels} channels")
    if tag == _FMT_EXTENSIBLE:
        if len(body) < 40:
            raise ValueError("EXTENSIBLE fmt chunk too short")
        sub = struct.unpack_from("<H", body, 24)[0]
        tag = sub
    return tag, channels, sr, bits


def write_wav(path, data: np.ndarray, sr: int, subtype: str = "FLOAT") -> None:
    """Write a WAV file. data: [frames] or [frames, channels] floats.

    subtype ∈ PCM_16 | PCM_24 | PCM_32 | FLOAT | DOUBLE.  Integer subtypes
    scale by 2**(bits-1) and clip to full scale.
    """
    if subtype not in _SUBTYPES:
        raise ValueError(f"unknown subtype {subtype!r}; one of {sorted(_SUBTYPES)}")
    tag, bits = _SUBTYPES[subtype]

    x = np.asarray(data)
    if x.ndim == 1:
        x = x[:, None]
    channels = x.shape[1]

    if tag == _FMT_FLOAT:
        payload = x.astype("<f4" if bits == 32 else "<f8").tobytes()
    else:
        full = 2.0 ** (bits - 1)
        q = np.clip(np.round(x * full), -full, full - 1).astype(np.int64)
        if bits == 16:
            payload = q.astype("<i2").tobytes()
        elif bits == 32:
            payload = q.astype("<i4").tobytes()
        else:  # 24-bit: pack low 3 bytes of little-endian int32
            b32 = q.astype("<i4").tobytes()
            arr = np.frombuffer(b32, dtype=np.uint8).reshape(-1, 4)
            payload = arr[:, :3].tobytes()

    block_align = channels * bits // 8
    byte_rate = sr * block_align
    fmt_body = struct.pack("<HHIIHH", tag, channels, sr, byte_rate, block_align, bits)
    if tag == _FMT_FLOAT:
        # float WAVs conventionally carry a fact chunk
        fact = struct.pack("<4sII", b"fact", 4, x.shape[0])
    else:
        fact = b""

    data_chunk = struct.pack("<4sI", b"data", len(payload)) + payload
    if len(payload) & 1:
        data_chunk += b"\x00"
    fmt_chunk = struct.pack("<4sI", b"fmt ", len(fmt_body)) + fmt_body
    riff_size = 4 + len(fmt_chunk) + len(fact) + len(data_chunk)
    out = struct.pack("<4sI4s", b"RIFF", riff_size, b"WAVE") + fmt_chunk + fact + data_chunk
    Path(path).write_bytes(out)
