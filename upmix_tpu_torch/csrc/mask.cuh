// The gain x center mask x band sum of one kept bin, for every kernel
// that masks (K1, K2, K3, K3s; through fft.cuh::unpack_mask).  It follows
// upmix_tpu_torch/ops/mask.py::mask_sum line for line: per band, gain,
// then mask, summed over bands (never the gains first: the mask is
// nonlinear).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float EPS = 1e-12f;  // upmix_tpu_torch.config.EPS

// (lre, lim), (rre, rim): the L and R spectra of one bin; gains [nb, K],
// column j.  out: c_re, c_im, l_re, l_im, r_re, r_im.
__device__ __forceinline__ void mask_sum_bin(float lre, float lim, float rre, float rim,
                                             const float* __restrict__ gains, int K, int nb, int j,
                                             float out[6]) {
  float c_re = 0.f, c_im = 0.f, l_re = 0.f, l_im = 0.f, r_re = 0.f, r_im = 0.f;
  for (int b = 0; b < nb; ++b) {
    const float g = gains[b * K + j];
    const float glre = lre * g, glim = lim * g;
    const float grre = rre * g, grim = rim * g;
    const float magl = sqrtf(glre * glre + glim * glim);
    const float magr = sqrtf(grre * grre + grim * grim);
    const float cross = magl * magr;
    const float coh = cross / (cross + EPS);
    const float bal = (magl - magr) / (magl + magr + EPS);
    const float fac = 0.5f * coh * (1.0f - fabsf(bal));
    const float cre = fac * (glre + grre);
    const float cim = fac * (glim + grim);
    c_re += cre;
    c_im += cim;
    l_re += glre - cre;
    l_im += glim - cim;
    r_re += grre - cre;
    r_im += grim - cim;
  }
  out[0] = c_re;
  out[1] = c_im;
  out[2] = l_re;
  out[3] = l_im;
  out[4] = r_re;
  out[5] = r_im;
}

}  // namespace
