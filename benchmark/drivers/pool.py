"""Stream-pool traffic: one hardware block for every stream per call of
`upmix_tpu_torch.models.streaming.CudaStreamPool.push_blocks`, alone or
on a mesh from `upmix_tpu_torch.parallel.make_mesh`, in a closed loop.

As the stream server stages a cycle, a call's input comes from pinned
host memory (a seeded ring of `ring_blocks` blocks: stream s's signal
repeats every ring), is copied to the pool's first card, and the three
stems go back to pinned host memory; the call ends when they are there.
Kept for the check: a uniform sample of the window's blocks (reservoir
sampling into pinned slots, so keeping costs the window nothing) and its
last block, for every stream or a stratified sample of streams.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import generate, roofline
from benchmark.reference.plan import bands
from benchmark.trace import no_span
from benchmark.window import Call, Window

GROUP = 1024  # streams a reference piece


class Session:
    """One run's pool traffic: the pinned ring from the seed, the pool, the
    window and the blocks it kept for the check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, devices: list, port_config):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.port_config = port_config
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.cuda = self.device.type == "cuda"
        self.cards = sorted({d.index or 0 for d in self.devices}) if self.cuda else [0]
        self.hw, self.streams = int(cfg["hw_block_size"]), int(traffic["streams"])
        self.warmup = bands(cfg)[0].block // bands(cfg)[0].hop
        r = int(traffic["ring_blocks"])
        gen = generate.torch_generator(seed, self.device)
        sig = generate.audio(traffic["audio"], (self.streams, r * self.hw), gen, self.device)
        self.ring = self._host((r, 2, self.streams, self.hw))
        self.ring.copy_(sig.unflatten(-1, (r, self.hw)).permute(2, 0, 1, 3))
        del sig
        self.block = 0  # global index of the next block
        self.samples = []  # (global block, host outputs [3, S, hw])
        self._rng = generate.rng(seed, 5)
        self.pool = None

    def _host(self, shape):
        return torch.empty(shape, dtype=torch.float32, pin_memory=self.cuda)

    def build(self):
        from upmix_tpu_torch.models.streaming import CudaStreamPool
        from upmix_tpu_torch.parallel import make_mesh

        mesh = self.traffic.get("mesh")
        if mesh:
            mesh = make_mesh(mesh, devices=self.devices)
        self.pool = CudaStreamPool(self.port_config, self.hw, self.streams, device=self.device, mesh=mesh,
                                   ola=self.traffic.get("ola", "time"))
        self.x = torch.empty((2, self.streams, self.hw), device=self.device)
        self.scratch = self._host((3, self.streams, self.hw))
        self.slots = [self._host((3, self.streams, self.hw)) for _ in range(int(self.traffic["check"]["reservoir"]))]
        self.done = torch.cuda.Event() if self.cuda else None
        for _ in range(int(self.traffic["warm_blocks"])):
            self._call(self.scratch, no_span)

    def _call(self, dest, span) -> Call:
        ring = self.ring
        t0 = time.perf_counter()
        with span("bench.block"):
            with span("bench.stage_in"):
                self.x.copy_(ring[self.block % len(ring)], non_blocking=True)
            with span("bench.push"):
                tp = time.perf_counter()
                c, ls, rs = self.pool.push_blocks(self.x[0], self.x[1])
                dispatch = time.perf_counter() - tp
            with span("bench.fetch"):
                dest.copy_(torch.stack([c, ls, rs]), non_blocking=True)
                if self.done is not None:
                    self.done.record(torch.cuda.current_stream(self.device))
                    self.done.synchronize()
        self.block += 1
        return Call(t0, time.perf_counter(), 1.0, dispatch=dispatch)

    def run(self, seconds=None, calls=None, span=no_span) -> Window:
        """A closed loop for `seconds` (whole blocks) or `calls` blocks."""
        kept = [None] * len(self.slots)  # global block in each slot
        start = time.perf_counter()
        w = Window(start, start)
        with span("bench.window"):
            while True:
                j = len(w.calls)
                slot = j if j < len(kept) else int(self._rng.integers(0, j + 1))
                dest = self.slots[slot] if slot < len(kept) else self.scratch
                if slot < len(kept):
                    kept[slot] = self.block
                w.calls.append(self._call(dest, span))
                w.end = w.calls[-1].end
                if (calls is not None and len(w.calls) >= calls) or (seconds is not None and w.seconds >= seconds):
                    break
        self.samples = [(b, out) for b, out in zip(kept, self.slots) if b is not None]
        if dest is self.scratch:
            self.samples.append((self.block - 1, self.scratch))
        return w

    def least_seconds(self, call: Call) -> float:
        return roofline.pool_block(self.cfg, self.streams)["seconds"] * call.units

    def release(self):
        self.pool = self.x = None
        if self.cuda:
            for d in self.devices:
                torch.cuda.synchronize(d)
            torch.cuda.empty_cache()

    def _checked_streams(self) -> np.ndarray:
        """Every stream, or `check.streams` of them drawn from the seed in
        eight equal strata of the stream index (so every shard of a mesh
        of up to eight has rows in it)."""
        want = self.traffic["check"].get("streams", "all")
        if want == "all" or int(want) >= self.streams:
            return np.arange(self.streams)
        strata = np.array_split(np.arange(self.streams), 8)
        r = generate.rng(self.seed, 6)
        per = -(-int(want) // 8)
        return np.sort(np.concatenate([r.choice(s, size=min(per, len(s)), replace=False) for s in strata]))

    def _reference_blocks(self, reference, streams: np.ndarray, blocks: list) -> list:
        """[len(blocks), 3, len(group), hw] for each group of `streams`."""
        ring = self.ring.to(reference.device)
        hw, r = self.hw, len(self.ring)
        out = []
        for g0 in range(0, len(streams), GROUP):
            index = torch.as_tensor(streams[g0 : g0 + GROUP], device=reference.device)

            def signal(a, z, index=index):
                b0, b1 = a // hw, (z - 1) // hw
                parts = [ring[b % r].index_select(1, index) for b in range(b0, b1 + 1)]
                return torch.cat(parts, dim=-1)[..., a - b0 * hw : z - b0 * hw]

            out.append(reference.stream_blocks(signal, hw, self.warmup, blocks))
        return out

    def control_samples(self, reference) -> list:
        """The kept blocks with `reference` (the control) in the program's
        place, on the checked streams (the rest left zero)."""
        streams = self._checked_streams()
        blocks = [b for b, _ in self.samples]
        full = torch.zeros((len(blocks), 3, self.streams, self.hw))
        for g0, part in zip(range(0, len(streams), GROUP), self._reference_blocks(reference, streams, blocks)):
            full[:, :, streams[g0 : g0 + GROUP]] = part.float().cpu()
        return [(b, full[i]) for i, b in enumerate(blocks)]

    def compare(self, reference, samples=None) -> dict:
        """max over kept blocks, checked streams and stems of |stem -
        reference|, over the RMS of the reference stem."""
        samples = self.samples if samples is None else samples
        streams = self._checked_streams()
        blocks = [b for b, _ in samples]
        worst = torch.zeros(3, dtype=torch.float64)
        power, count = torch.zeros(3, dtype=torch.float64), 0
        for g0, ref in zip(range(0, len(streams), GROUP), self._reference_blocks(reference, streams, blocks)):
            index = torch.as_tensor(streams[g0 : g0 + GROUP])
            got = torch.stack([out.index_select(1, index) for _, out in samples]).to(ref.device, ref.dtype)
            worst = torch.maximum(worst, (got - ref).abs().amax(dim=(0, 2, 3)).cpu())
            power += ref.pow(2).sum(dim=(0, 2, 3)).cpu()
            count += ref[:, 0].numel()
        err = float((worst / (power / count).sqrt()).max())
        return {"max_err": err if math.isfinite(err) else math.inf}
