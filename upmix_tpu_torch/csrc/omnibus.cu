// Omnibus offline upmix for Hopper (sm_90a): every bucket of a config,
// framing -> windowed banded DFT -> gain x center mask summed over bands
// -> inverse with the synthesis window -> overlap-add, merged into one
// [S, 3, chunk + halo] output.
//
// Replaces upmix_tpu/ops/pallas_omnibus.py::omnibus_lcr_batch (the TPU
// kernel of the offline main path).  What it computes is the same; how is
// thought through again for the card:
//
//   * Transform: the direct banded DFT for every bucket.  Each bucket keeps
//     K bins, so forward and inverse are real products against the
//     precomputed weight slices of ops/dftmm.py ([B, 2K] with the analysis
//     window folded in, [2K, B] with the synthesis window, 2/N and the
//     DC/Nyquist halves folded in).  10 * (chunk/H) * B * K multiply-adds
//     per bucket: about 7.5e10 for the 6-band 44.1 kHz config per 2^21
//     samples.
//   * Bound: FP32 FMA throughput of the two products (about 70 FMAs per
//     byte of weights and signal read); memory only for the small mask pass
//     and the output.  Products run as FP32 FMA on the SIMT cores, never
//     TF32 (about three decimal digits, below the 60 dB bar).
//   * Design: three launches per bucket, all on the caller's stream.
//       1. forward_kernel: a 64x64x16 shared-memory tiled GEMM with
//          implicit framing (row (s, ch, f) reads x[s, ch, f*H + n]
//          directly, no frame tensor) and a split over the block length
//          when the bucket has too few output tiles to fill the SMs.
//          Each split writes its own partial: no atomics.
//       2. mask_kernel: sums the partials in a fixed order, then per band
//          gain -> mask -> band sum (ops/mask.py::mask_sum line for line).
//       3. inverse_kernel: the same tiled GEMM, with the overlap-add folded
//          into the product: output sample q*H + r of bucket b is
//          sum_g sum_j spec[q - g, j] * w_inv[j, g*H + r], so each output
//          element is owned by one thread (no atomics) and the B/H frames
//          that cover it are summed inside the dot product.  Buckets add
//          into the output in a fixed launch order (the widest spill first,
//          which stores instead of adding), so the result is deterministic
//          run to run.
//
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 16;  // depth per shared-memory stage
constexpr int THREADS = 256;
constexpr int TM = 4;  // rows per thread
constexpr int TN = 4;  // columns per thread
constexpr float EPS = 1e-12f;  // upmix_tpu.config.EPS

// acc[TM][TN] += As[k][rows of this thread] x Ws[k][columns of this thread]
__device__ __forceinline__ void tile_fma(float (*As)[BM + 4], float (*Ws)[BN + 4],
                                         float acc[TM][TN], int tr, int tc) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][tr * TM]);
    const float4 b = *reinterpret_cast<const float4*>(&Ws[k][tc * TN]);
    const float av[TM] = {a.x, a.y, a.z, a.w};
    const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// part[z, m, n] = sum_{k in split z} x[m / F, (m % F) * H + k] * w[k, n]
// m = (s * 2 + ch) * F + f over M = S * 2 * F rows; n < N = 2K.
__global__ void __launch_bounds__(THREADS)
forward_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ part,
               int M, int N, int F, int H, int B, long long x_row, int depth) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * depth;
  const int k_end = min(B, k_begin + depth);

  // Loads: A as 4 rows x 1 column per thread, W as 4 depth rows x 1 column.
  const int a_col = tid & (BK - 1);
  const int a_row = tid / BK;  // 0..15, plus 16 * i
  const float* a_ptr[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_row + 16 * i;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_ptr[i] = x + (long long)(mm / F) * x_row + (long long)(mm % F) * H;
  }
  const int w_col = tid & (BN - 1);
  const int w_row = tid / BN;  // 0..3, plus 4 * i
  const int n = n0 + w_col;
  const bool w_ok = n < N;

  float acc[TM][TN] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + a_col;
      As[a_col][a_row + 16 * i] = (a_ok[i] && k < k_end) ? a_ptr[i][k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = w_row + 4 * i;
      const int k = k0 + kr;
      Ws[kr][w_col] = (w_ok && k < k_end) ? w[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
    tile_fma(As, Ws, acc, tid / (BN / TN), tid % (BN / TN));
    __syncthreads();
  }

  float* out = part + (long long)blockIdx.z * M * N;
  const int r0 = m0 + (tid / (BN / TN)) * TM;
  const int c0 = n0 + (tid % (BN / TN)) * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (r0 + i >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (c0 + j < N) out[(long long)(r0 + i) * N + c0 + j] = acc[i][j];
  }
}

// spec[s, o, f, :] = masked, band-summed (re | im) of output o (C, Ls, Rs)
// from the forward partials of frame f: per band gain -> mask -> sum,
// exactly ops/mask.py::mask_sum.
__global__ void __launch_bounds__(THREADS)
mask_kernel(const float* __restrict__ part, const float* __restrict__ gains, float* __restrict__ spec,
            int S, int F, int K, int nb, int P) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)S * F * K) return;
  const int j = (int)(idx % K);
  const long long sf = idx / K;
  const int f = (int)(sf % F);
  const long long s = sf / F;
  const int N = 2 * K;
  const long long M = 2LL * S * F;
  const long long row_l = (2 * s) * F + f;
  const long long row_r = (2 * s + 1) * F + f;

  float lre = 0.f, lim = 0.f, rre = 0.f, rim = 0.f;
  for (int p = 0; p < P; ++p) {  // fixed order: deterministic
    const float* pp = part + (long long)p * M * N;
    lre += pp[row_l * N + j];
    lim += pp[row_l * N + K + j];
    rre += pp[row_r * N + j];
    rim += pp[row_r * N + K + j];
  }

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
  float* out = spec + ((3 * s) * F + f) * N + j;
  const long long o_stride = (long long)F * N;
  out[0] = c_re;
  out[K] = c_im;
  out[o_stride] = l_re;
  out[o_stride + K] = l_im;
  out[2 * o_stride] = r_re;
  out[2 * o_stride + K] = r_im;
}

// y[so, q*H + r] (+)= sum_{g < B/H} sum_{j < N2} spec[so, q - g, j] * w_inv[j, g*H + r]
// over rows m = so * Fq + q (so = s * 3 + o, Fq = F + B/H - 1) and r < H:
// the inverse product and the overlap-add in one.
__global__ void __launch_bounds__(THREADS)
inverse_kernel(const float* __restrict__ spec, const float* __restrict__ w_inv, float* __restrict__ y,
               int S, int F, int H, int B, int N2, long long y_row, int accumulate) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Ws[BK][BN + 4];
  const int Kf = B / H;
  const int Fq = F + Kf - 1;
  const int M = S * 3 * Fq;
  const int D = Kf * N2;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  const int a_col = tid & (BK - 1);
  const int a_row = tid / BK;
  const float* a_base[4];
  int a_q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_row + 16 * i;
    const int mm = m < M ? m : 0;
    a_base[i] = spec + (long long)(mm / Fq) * F * N2;
    a_q[i] = m < M ? mm % Fq : -F - Kf;  // out of range: every f < 0
  }
  const int w_col = tid & (BN - 1);
  const int w_row = tid / BN;
  const int r = n0 + w_col;
  const bool w_ok = r < H;

  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < D; k0 += BK) {
    {
      const int kk = k0 + a_col;
      const int g = kk / N2;
      const int j = kk - g * N2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = a_q[i] - g;
        As[a_col][a_row + 16 * i] =
            (kk < D && f >= 0 && f < F) ? a_base[i][(long long)f * N2 + j] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = w_row + 4 * i;
      const int kk = k0 + kr;
      const int g = kk / N2;
      const int j = kk - g * N2;
      Ws[kr][w_col] = (w_ok && kk < D) ? w_inv[(long long)j * B + g * H + r] : 0.f;
    }
    __syncthreads();
    tile_fma(As, Ws, acc, tid / (BN / TN), tid % (BN / TN));
    __syncthreads();
  }

  const int row0 = m0 + (tid / (BN / TN)) * TM;
  const int col0 = n0 + (tid % (BN / TN)) * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = row0 + i;
    if (m >= M) break;
    float* yrow = y + (long long)(m / Fq) * y_row + (long long)(m % Fq) * H;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int c = col0 + jj;
      if (c >= H) continue;
      yrow[c] = accumulate ? yrow[c] + acc[i][jj] : acc[i][jj];
    }
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" {

// part: [splits, M, N] with M = S * 2 * F rows of x [S, 2, x_row].
int omni_forward(const float* x, const float* w_fwd, float* part, int M, int N, int F, int H,
                 int B, long long x_row, int splits, void* stream) {
  int depth = cdiv(B, splits);
  depth = cdiv(depth, BK) * BK;
  const dim3 grid(cdiv(M, BM), cdiv(N, BN), splits);
  forward_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, w_fwd, part, M, N, F, H, B,
                                                              x_row, depth);
  return (int)cudaGetLastError();
}

// spec: [S, 3, F, 2K] from part [P, S * 2 * F, 2K] and gains [nb, K].
int omni_mask(const float* part, const float* gains, float* spec, int S, int F, int K, int nb,
              int P, void* stream) {
  const long long total = (long long)S * F * K;
  mask_kernel<<<cdiv(total, THREADS), THREADS, 0, (cudaStream_t)stream>>>(part, gains, spec, S,
                                                                          F, K, nb, P);
  return (int)cudaGetLastError();
}

// y: [S, 3, y_row]; writes (accumulate = 0) or adds into y[..., :F*H + B - H].
int omni_inverse(const float* spec, const float* w_inv, float* y, int S, int F, int H, int B,
                 int N2, long long y_row, int accumulate, void* stream) {
  const long long M = (long long)S * 3 * (F + B / H - 1);
  const dim3 grid(cdiv(M, BM), cdiv(H, BN), 1);
  inverse_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(spec, w_inv, y, S, F, H, B, N2,
                                                              y_row, accumulate);
  return (int)cudaGetLastError();
}

}  // extern "C"
