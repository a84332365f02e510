"""The reference upmix in plain PyTorch, float64 by default.

Per bucket: frames of the input at every hop, analysis window, real FFT,
per band the gain and the center mask (coherence times one minus the
balance; center_extraction.py:372-384), the bands summed, inverse FFT,
synthesis window, overlap-add (any hop, dividing the block or not).
`offline` gives a whole file's (C, Ls, Rs) with the offline framing
(frames at k * hop from sample 0, the input zero-padded past its end,
the sum trimmed to the input's length);
`stream_blocks` gives chosen hardware blocks of a stream pool's output,
where a band's overlap-add stream is delayed by K - 1 hardware blocks and
every block before that is silence (bela/upmix.cpp:95-120, 232-237).

The same code computes the control: `dtype=torch.float32` with `rounding`
a function applied to every transform's operands (the windowed frames
and the masked spectra), such as `tf32`.  Work runs in pieces of frames
and of streams, so a song or a pool of thousands of streams fits on one
card.  It imports nothing of the program under test.
"""

from __future__ import annotations

import torch

from benchmark.reference.plan import EPS, buckets

# Elements of one piece's frames [2, frames, block]: bounds the memory.
PIECE = 1 << 24


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties to
    even); complex tensors part by part."""
    if x.is_complex():
        return torch.view_as_complex(tf32(torch.view_as_real(x).contiguous()))
    i = x.contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & -0x2000
    return i.view(torch.float32)


class Reference:
    """The configuration's buckets as tensors on `device` in `dtype`."""

    def __init__(self, cfg: dict, device="cpu", dtype=torch.float64, rounding=None):
        self.dtype, self.device = dtype, torch.device(device)
        self.rounding = rounding or (lambda t: t)

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        self.buckets = [(b.block, b.hop, t(b.gains), t(b.analysis), t(b.synthesis)) for b in buckets(cfg)]

    def _frames_lcr(self, frames, gains, aw, sw):
        """frames [..., 2, F, B] -> [..., 3, F, B] windowed (C, Ls, Rs)."""
        r = self.rounding
        spec = torch.fft.rfft(r(frames * aw))
        sl, sr = spec[..., 0, :, :], spec[..., 1, :, :]
        acc = None
        for g in gains:
            gl, gr = sl * g, sr * g
            ml, mr = gl.abs(), gr.abs()
            coherence = (gl * gr.conj()).abs() / (ml * mr + EPS)
            balance = (ml - mr) / (ml + mr + EPS)
            c = 0.5 * coherence * (1.0 - balance.abs()) * (gl + gr)
            parts = torch.stack([c, gl - c, gr - c], dim=-3)
            acc = parts if acc is None else acc + parts
        return torch.fft.irfft(r(acc), n=aw.shape[-1]) * sw

    @staticmethod
    def _ola(rec, hop):
        """rec [..., 3, F, B] -> [..., 3, (F - 1) hop + B], any hop.  Where
        hop does not divide B, each frame is zero-padded to ceil(B / hop)
        whole hops and the sum cut to its length."""
        *lead, F, B = rec.shape
        k = -(-B // hop)
        if B % hop:
            rec = torch.nn.functional.pad(rec, (0, k * hop - B))
        acc = rec.new_zeros((*lead, F + k - 1, hop))
        parts = rec.unflatten(-1, (k, hop))
        for q in range(k):
            acc[..., q : q + F, :] += parts[..., q, :]
        return acc.flatten(-2)[..., : (F - 1) * hop + B]

    def _bucket_span(self, x, block, hop, gains, aw, sw, first, count):
        """Overlap-add of frames first .. first + count - 1 (frame i reads
        x[..., i * hop : i * hop + block], x [..., 2, n] zero past its end):
        [..., 3, (count - 1) hop + block], sample 0 at first * hop."""
        need = (first + count - 1) * hop + block
        if x.shape[-1] < need:
            x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
        rows = max(1, x[..., 0, 0].numel())
        step = max(1, PIECE // (2 * block * rows))
        y = x.new_zeros((*x.shape[:-2], 3, (count - 1) * hop + block))
        for f0 in range(0, count, step):
            f1 = min(count, f0 + step)
            seg = x[..., (first + f0) * hop : (first + f1 - 1) * hop + block]
            frames = seg.unfold(-1, block, hop)
            part = self._ola(self._frames_lcr(frames, gains, aw, sw), hop)
            y[..., f0 * hop : f0 * hop + part.shape[-1]] += part
        return y

    def offline(self, L, R) -> torch.Tensor:
        """(C, Ls, Rs) [3, n] of one file, L and R host arrays of n samples."""
        x = torch.stack([torch.as_tensor(L), torch.as_tensor(R)]).to(self.device, self.dtype)
        n = x.shape[-1]
        out = x.new_zeros((3, n))
        for block, hop, gains, aw, sw in self.buckets:
            frames = -(-n // hop)
            out += self._bucket_span(x, block, hop, gains, aw, sw, 0, frames)[..., :n]
        return out

    def stream_blocks(self, signal, hw: int, warmup: int, blocks) -> torch.Tensor:
        """Pool outputs [len(blocks), 3, streams, hw] at the given global
        block indices.  `signal(a, z)` returns the streams' input samples
        [2, streams, z - a] from sample a (>= 0) of every stream's signal."""
        out = None
        for j, t in enumerate(blocks):
            n0 = (t - warmup + 1) * hw  # the block's first sample of the bands' overlap-add
            if n0 < 0:
                continue  # still warming up: silence
            for block, hop, gains, aw, sw in self.buckets:
                first = max(0, (n0 - block) // hop + 1)
                last = (n0 + hw - 1) // hop
                x = signal(first * hop, last * hop + block).to(self.device, self.dtype).transpose(0, 1)
                if out is None:
                    out = x.new_zeros((len(blocks), 3, x.shape[0], hw))
                y = self._bucket_span(x, block, hop, gains, aw, sw, 0, last - first + 1)
                off = n0 - first * hop
                out[j] += y[..., off : off + hw].transpose(0, 1)
        if out is None:
            out = torch.zeros((len(blocks), 3, signal(0, 1).shape[1], hw), dtype=self.dtype, device=self.device)
        return out
