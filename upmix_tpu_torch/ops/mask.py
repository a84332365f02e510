"""Cross-spectral center-extraction mask (port of `upmix_tpu/ops/mask.py`
and of the SoA gain-mask-band-sum in `upmix_tpu/ops/pallas_upmix.py`).

  cross        = L * conj(R)
  coherence    = |cross| / (|L| |R| + EPS)
  balance      = (|L| - |R|) / (|L| + |R| + EPS)
  centerFactor = coherence * (1 - |balance|)
  C  = 0.5 * centerFactor * (L + R);   Ls = L - C;   Rs = R - C

`center_mask` works on complex tensors (the whole-file path).  `mask_sum`
is the form the omnibus kernel computes: separate real and imaginary
parts, per band gain then mask, summed over bands.  It is the one
statement of that math in the port: the kernel's plain version calls it
and `csrc/omnibus.cu::mask_kernel` follows it line for line.
"""

from __future__ import annotations

import torch

from upmix_tpu_torch.config import EPS


def center_mask(spec_l: torch.Tensor, spec_r: torch.Tensor):
    """(C, Ls, Rs) spectra from complex L/R spectra of one shape."""
    cross_mag = torch.abs(spec_l * torch.conj(spec_r))
    mag_l = torch.abs(spec_l)
    mag_r = torch.abs(spec_r)
    coherence = cross_mag / (mag_l * mag_r + EPS)
    balance = (mag_l - mag_r) / (mag_l + mag_r + EPS)
    center_factor = coherence * (1.0 - torch.abs(balance))
    spec_c = (0.5 * center_factor) * (spec_l + spec_r)
    return spec_c, spec_l - spec_c, spec_r - spec_c


def mask_soa(slre, slim, srre, srim):
    """Center part (re, im) of one band's gained spectra.  |L conj R| is
    |L||R|, so coherence is cross / (cross + EPS)."""
    magl = torch.sqrt(slre * slre + slim * slim)
    magr = torch.sqrt(srre * srre + srim * srim)
    cross = magl * magr
    coh = cross / (cross + EPS)
    bal = (magl - magr) / (magl + magr + EPS)
    f = 0.5 * coh * (1.0 - torch.abs(bal))
    return f * (slre + srre), f * (slim + srim)


def mask_sum(slre, slim, srre, srim, gains):
    """Per band: gain, then mask; summed over bands (never sum the gains
    first: the mask is nonlinear).  `gains` iterates over per-band gain
    tensors broadcastable to the spectra.  Returns
    (c_re, c_im, l_re, l_im, r_re, r_im)."""
    c_re = c_im = l_re = l_im = r_re = r_im = 0.0
    for g in gains:
        glre, glim = slre * g, slim * g
        grre, grim = srre * g, srim * g
        cre, cim = mask_soa(glre, glim, grre, grim)
        c_re = c_re + cre
        c_im = c_im + cim
        l_re = l_re + (glre - cre)
        l_im = l_im + (glim - cim)
        r_re = r_re + (grre - cre)
        r_im = r_im + (grim - cim)
    return c_re, c_im, l_re, l_im, r_re, r_im
