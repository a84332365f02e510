"""Offline stereo->LCR upmix on the PyTorch/CUDA port, end to end.

The port's counterpart of 01_offline_upmix.py: a small stereo WAV (a
shared tone that should land in the center channel and two panned tones
for the sides) through `upmix_tpu_torch.models.Upmixer`, the three
discrete channels written out.  On the card the offline kernel (K1)
runs; with --cpu its plain version (torch.fft).

    python examples/torch_01_offline_upmix.py [workdir] [--cpu]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.io import read_wav, write_wav
from upmix_tpu_torch.models import Upmixer

args = [a for a in sys.argv[1:] if a != "--cpu"]
DEVICE = "cpu" if "--cpu" in sys.argv[1:] else "cuda"
workdir = args[0] if args else "."
os.makedirs(workdir, exist_ok=True)

# --- synthesize an input -----------------------------------------------
sr = 44100
n = 2**17  # ~3 s
t = np.arange(n) / sr
center = 0.4 * np.sin(2 * np.pi * 440 * t)  # in both channels
L = (center + 0.3 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
R = (center + 0.3 * np.sin(2 * np.pi * 2500 * t)).astype(np.float32)
in_path = os.path.join(workdir, "example_in.wav")
write_wav(in_path, np.stack([L, R], axis=1), sr)

# --- configure & run ----------------------------------------------------
# The reference's default band edges (main.py:62-73); each band gets its
# own FFT size (long windows for low bands, short for high ones).
cfg = UpmixConfig.make([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], sr=float(sr))
for b in cfg.bands:
    print(f"band {b.f_low:7.1f}-{b.f_high:7.1f} Hz  block={b.block_size:6d}  hop={b.hop_size}")

x, got_sr = read_wav(in_path, always_2d=True)
C, Ls, Rs = Upmixer(cfg, device=DEVICE).process_np(x[:, 0].astype(np.float32), x[:, 1].astype(np.float32))

for name, y in (("C", C), ("Ls", Ls), ("Rs", Rs)):
    out = os.path.join(workdir, f"example_torch_{name}.wav")
    write_wav(out, y, sr)
    print(f"wrote {out}  (peak {np.abs(y).max():.3f})")

# The shared 440 Hz tone must dominate C; the panned tones the sides.
steady = slice(cfg.bands[0].block_size, None)  # skip the window warm-up


def tone_energy(y, f):
    spec = np.abs(np.fft.rfft(y[steady]))
    b = int(round(f * len(y[steady]) / sr))
    return spec[max(0, b - 2) : b + 3].sum()


print(f"[{DEVICE}] C   440 Hz: {tone_energy(C, 440):9.1f}   1 kHz: {tone_energy(C, 1000):7.1f}")
print(f"[{DEVICE}] Ls  440 Hz: {tone_energy(Ls, 440):9.1f}   1 kHz: {tone_energy(Ls, 1000):7.1f}")
assert got_sr == sr
assert np.all(np.isfinite(C)) and np.all(np.isfinite(Ls)) and np.all(np.isfinite(Rs))
assert tone_energy(C, 440) > 10 * tone_energy(C, 1000), "shared tone must land in C"
assert tone_energy(Ls, 1000) > 10 * tone_energy(Ls, 440), "panned tone must land in Ls"
assert tone_energy(Rs, 2500) > 10 * tone_energy(Rs, 440), "panned tone must land in Rs"
print("separation checks passed")
