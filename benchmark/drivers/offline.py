"""Offline traffic: files or clips from host audio to three host stems
through one `upmix_tpu_torch.models.offline.Upmixer`, in a closed loop.

A call hands the Upmixer two host float32 channels and ends when its
three stems are NumPy arrays on the host (`process`, then `.cpu()` of
each stem: `Upmixer.process_np`).  Kept for the check: one output of
each distinct file (a grid of files, each drawn uniformly among its
calls), or a uniform sample of the clips plus the longest clip (a
sequence, every clip used once).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import generate, roofline
from benchmark.trace import no_span
from benchmark.window import Call, Window


class Session:
    """One run's offline traffic: inputs from the seed, the Upmixer, the
    window and what it kept for the check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, devices: list, port_config):
        self.cfg, self.traffic = cfg, traffic
        self.port_config = port_config
        self.device = torch.device(devices[0])
        self.cards = [self.device.index or 0] if self.device.type == "cuda" else [0]
        self.sr = float(cfg["sr"])
        files = traffic["files"]
        gen = generate.torch_generator(seed, self.device)
        if files["kind"] == "grid":
            self.lengths = generate.grid_lengths(files, self.sr, seed)
            self._files = [generate.audio(traffic["audio"], (n,), gen, self.device).cpu().numpy()
                           for n in self.lengths]
        elif files["kind"] == "sequence":
            self.lengths = generate.sequence_lengths(files, self.sr, seed, int(files["count"]))
            buffer_n = int(float(files["buffer_s"]) * self.sr)
            self._buffer = generate.audio(traffic["audio"], (buffer_n,), gen, self.device).cpu().numpy()
            self._offsets = generate.sequence_offsets(self.lengths, buffer_n, seed)
        else:
            raise ValueError(f"unknown files kind {files['kind']!r}")
        self.grid = files["kind"] == "grid"
        self.index = 0  # the next input's index
        self.samples = []  # (L, R, (C, Ls, Rs)) kept for the check
        self._seen, self._by_file, self._pool, self._longest = {}, {}, [], None
        self._rng = generate.rng(seed, 4)
        self.upmixer = None

    def _input(self, i: int):
        if self.grid:
            a = self._files[i % len(self._files)]
            return i % len(self._files), a[0], a[1]
        if i >= len(self.lengths):
            raise RuntimeError(f"the traffic's {len(self.lengths)} clips are used up; raise files.count")
        off, n = self._offsets[i], self.lengths[i]
        return i, self._buffer[0, off : off + n], self._buffer[1, off : off + n]

    def build(self):
        from upmix_tpu_torch.models.offline import Upmixer

        self.upmixer = Upmixer(self.port_config, device=self.device, **self.traffic.get("upmixer", {}))
        for _ in range(int(self.traffic["warm_calls"])):
            self._call(no_span, keep=False)

    def _call(self, span, keep=True) -> Call:
        key, L, R = self._input(self.index)
        self.index += 1
        t0 = time.perf_counter()
        with span("bench.call"):
            with span("bench.process"):
                c, ls, rs = self.upmixer.process(L, R)
            with span("bench.to_host"):
                stems = (c.cpu().numpy(), ls.cpu().numpy(), rs.cpu().numpy())
        t1 = time.perf_counter()
        if keep:
            self._keep(key, L, R, stems)
        return Call(t0, t1, len(L) / self.sr, samples=len(L))

    def _keep(self, key, L, R, stems):
        """Reservoir sampling: one call of each grid file, or `reservoir`
        clips of the sequence, each uniform over what the window ran."""
        self._seen[key] = self._seen.get(key, 0) + 1
        if self.grid:
            if self._rng.integers(0, self._seen[key]) == 0:
                self._by_file[key] = (L, R, stems)
            return
        size, n = int(self.traffic["check"]["reservoir"]), len(self._seen)
        if len(self._pool) < size:
            self._pool.append((L, R, stems))
        elif (j := self._rng.integers(0, n)) < size:
            self._pool[j] = (L, R, stems)
        if self._longest is None or len(L) > len(self._longest[0]):
            self._longest = (L, R, stems)

    def run(self, seconds=None, calls=None, span=no_span) -> Window:
        """A closed loop for `seconds` (whole calls: the last one ends past
        the mark) or for a number of `calls`."""
        start = time.perf_counter()
        w = Window(start, start)
        with span("bench.window"):
            while True:
                w.calls.append(self._call(span))
                w.end = w.calls[-1].end
                if (calls is not None and len(w.calls) >= calls) or (seconds is not None and w.seconds >= seconds):
                    break
        if self.grid:
            self.samples = [self._by_file[k] for k in sorted(self._by_file)]
        else:
            self.samples = self._pool + [self._longest]
        return w

    def least_seconds(self, call: Call) -> float:
        return roofline.offline_file(self.cfg, call.samples)["seconds"]

    def release(self):
        self.upmixer = None
        self._by_file, self._pool, self._longest = {}, [], None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def control_samples(self, reference) -> list:
        """The kept inputs with `reference` (the control) in the program's place."""
        return [(L, R, tuple(reference.offline(L, R).float().cpu().numpy())) for L, R, _ in self.samples]

    def compare(self, reference, samples=None) -> dict:
        """max over kept calls and stems of max |stem - reference| / RMS of
        the reference stem."""
        errs = []
        for L, R, stems in self.samples if samples is None else samples:
            ref = reference.offline(L, R)
            for k in range(3):
                got = torch.as_tensor(np.asarray(stems[k])).to(ref.device, ref.dtype)
                errs.append(float((got - ref[k]).abs().max() / ref[k].pow(2).mean().sqrt()))
        return {"max_err": max(errs) if all(math.isfinite(e) for e in errs) else math.inf}
