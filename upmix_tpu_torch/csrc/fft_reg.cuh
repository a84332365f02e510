// FP32 FFTs of power-of-two length held in registers, for the pool's two
// dataflows up to FFT_MAX points: pool.cu's K3 (the time OLA,
// pool_reg_kernel) and pool_spectral.cu's K3s (spectral_forward_kernel
// and spectral_inverse_kernel).  K1 and K2 (omnibus.cu) and the two-stage
// split over FFT_MAX points keep fft.cuh's passes.
//
// An n-point transform is run by a team of T = n / 16 threads (one thread
// below 16 points), each holding R = 16 values (all n below 16).  It takes
// the Stockham stages of ops/fftplan.py::reg_radices: radix 16 for every
// four bits of log2 n, then one stage of the 2, 4 or 8 points left.  A
// stage of radix P after NS points of the earlier stages: virtual thread v
// (thread j runs v = j + h T, h < R / P) reads x[v + r n / P], r < P,
// multiplies x_r by exp(-/+ 2 pi i (v mod NS) r / (NS P)), takes the
// P-point DFT y_k in registers (radix-2 butterflies in place, whose
// twiddles are the 16th roots of unity) and writes y_k at (v / NS) NS P +
// v mod NS + k NS.  Thread j so reads positions j + slot T at every stage,
// and input and output are in natural order: the forward reads a frame's
// samples, the inverse its kept bins, straight into registers
// (neighbouring threads on neighbouring addresses), and the result is left
// in natural order for the mask or the overlap-add.
//
// Between stages the values go through the team's exchange buffer in
// shared memory, padded by one float2 every 16 (reg_pad), so that the 16
// threads of a half-warp hit distinct banks in both patterns (positions
// j + slot T, and the writes at stride NS = 1); all of the team's reads
// come before any of its writes, so an exchange costs two barriers of the
// team alone (reg_sync: __syncwarp over its lanes inside one warp, else a
// named barrier of its warps), and the teams of a block run apart.  8192
// points take stages of 16, 16, 16 and 2: three exchanges where fft.cuh
// takes seven barriered passes over the whole block.  The last stage
// writes the natural-order result, unpadded, over the team's own buffer.
// The block's dynamic shared memory starts with the teams' buffers, team
// t's at t * PADDED (forward_transform and inverse_transform put their
// results there).
//
// Twiddles: ops/fftplan.py::reg_twiddles, computed in float64 and
// rounded once to float32 (no __sinf/__cosf): w_16^k for k < 4 first
// (the butterflies take w_16^(4 + k) = -i w_16^k), then per stage after
// the first exp(-2 pi i m r / (NS P)) at [(r - 1) NS + m], so the threads
// of a warp read neighbouring entries.  The butterflies' w_16^k, the same
// for every n, are copied once into constant memory (reg_w16), where they
// are operands that hold no register; each source that includes this
// header has its own copy, set by its entry (pool.cu's pool_reg_roots,
// pool_spectral.cu's pool_spectral_roots).  The inverse conjugates every
// twiddle, unnormalised (sum_k X[k] e^{+2 pi i k n / N}).

#pragma once

#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int REG_R = 16;  // values a thread holds: ops/fftplan.py::REG_RADIX

__constant__ float2 reg_w16[4];  // w_16^0..3: the head of every reg_twiddles table

__host__ __device__ constexpr int reg_brev(int k, int bits) {
  return bits == 0 ? 0 : ((k & 1) << (bits - 1)) | reg_brev(k >> 1, bits - 1);
}

__host__ __device__ constexpr int reg_log2(int n) { return n <= 1 ? 0 : 1 + reg_log2(n >> 1); }

// The geometry of a 2^LOG2N-point transform, known at compile time.
template <int LOG2N>
struct RegGeo {
  static constexpr int N = 1 << LOG2N;
  static constexpr int R = N < REG_R ? N : REG_R;  // values a thread holds
  static constexpr int T = N / R;                  // threads a transform
  static constexpr int STAGES = LOG2N == 0 ? 0 : LOG2N < 4 ? 1 : LOG2N / 4 + (LOG2N % 4 != 0);
  static constexpr int PADDED = N + N / 16;  // the exchange buffer, float2

  __host__ __device__ static constexpr int radix(int i) {
    return LOG2N < 4 ? N : i < LOG2N / 4 ? REG_R : 1 << (LOG2N % 4);
  }
  // Points of the stages before stage i.
  __host__ __device__ static constexpr int ns(int i) { return i == 0 ? 1 : ns(i - 1) * radix(i - 1); }
  // Where stage i's twiddles start in reg_twiddles (stage 0 takes none).
  __host__ __device__ static constexpr int tw_at(int i) {
    return i <= 1 ? 4 : tw_at(i - 1) + (radix(i - 1) - 1) * ns(i - 1);
  }
};

__device__ __forceinline__ int reg_pad(int a) { return a + (a >> 4); }

// A barrier of the T threads of team `team` (T a power of two): its lanes
// of the warp below 32 threads, else named barrier team + 1 of its warps
// (at most 15 teams a block; barrier 0 is __syncthreads').
__device__ __forceinline__ void reg_named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <int T>
__device__ __forceinline__ void reg_sync(int team) {
  if constexpr (T < 32) {
    __syncwarp(((1u << T) - 1) << (threadIdx.x & 31 & ~(T - 1)));
  } else if constexpr (T == 32) {
    __syncwarp();
  } else {
    reg_named_sync(team + 1, T);
  }
}

// x times w_16^k (conjugated for the inverse).  k is a constant once the
// butterflies are unrolled.
template <bool INV>
__device__ __forceinline__ float2 w16_mul(float2 x, int k) {
  if (k & 3) x = INV ? cmulc(x, reg_w16[k & 3]) : cmul(x, reg_w16[k & 3]);
  if (k & 4) x = INV ? make_float2(-x.y, x.x) : make_float2(x.y, -x.x);
  return x;
}

// The radix-2 passes of span L, L / 2, .., 2 of a P-point DFT in place:
// v[s] ends as output bin reg_brev(s, log2 P).
template <int P, int L, bool INV>
__device__ __forceinline__ void reg_passes(float2 (&v)[P]) {
  if constexpr (L >= 2) {
#pragma unroll
    for (int b = 0; b < P; b += L) {
#pragma unroll
      for (int i = 0; i < L / 2; ++i) {
        const float2 x = v[b + i], y = v[b + i + L / 2];
        v[b + i] = make_float2(x.x + y.x, x.y + y.y);
        v[b + i + L / 2] = w16_mul<INV>(make_float2(x.x - y.x, x.y - y.y), i * (16 / L));
      }
    }
    reg_passes<P, L / 2, INV>(v);
  }
}

// Stage I on the thread's values, x[h + r H] = input r of virtual thread
// h (H = R / P): twiddles, the P-point DFTs, and x[h + k H] = output k.
template <int LOG2N, int I, bool INV>
__device__ __forceinline__ void reg_stage(float2 (&x)[RegGeo<LOG2N>::R], int j, const float2* __restrict__ tw) {
  using G = RegGeo<LOG2N>;
  constexpr int P = G::radix(I), NS = G::ns(I), H = G::R / P, AT = G::tw_at(I);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int m = (j + h * G::T) & (NS - 1);
    float2 y[P];
#pragma unroll
    for (int r = 0; r < P; ++r) {
      y[r] = x[h + r * H];
      if (NS > 1 && r > 0) {
        const float2 t = __ldg(tw + AT + (r - 1) * NS + m);
        y[r] = INV ? cmulc(y[r], t) : cmul(y[r], t);
      }
    }
    reg_passes<P, P, INV>(y);
#pragma unroll
    for (int k = 0; k < P; ++k) x[h + k * H] = y[reg_brev(k, reg_log2(P))];
  }
}

// Where stage I writes the value the thread holds at `slot`.
template <int LOG2N, int I>
__device__ __forceinline__ int reg_out_pos(int j, int slot) {
  using G = RegGeo<LOG2N>;
  constexpr int P = G::radix(I), NS = G::ns(I), H = G::R / P;
  const int v = j + (slot % H) * G::T;
  return (v / NS) * NS * P + (v & (NS - 1)) + (slot / H) * NS;
}

template <int LOG2N, bool INV, int I>
__device__ __forceinline__ void reg_stages(float2 (&x)[RegGeo<LOG2N>::R], int j, int team, float2* ex,
                                           const float2* __restrict__ tw) {
  using G = RegGeo<LOG2N>;
  if constexpr (I < G::STAGES) {
    constexpr bool LAST = I + 1 == G::STAGES;
    if constexpr (I > 0) {
      reg_sync<G::T>(team);  // the team's writes of stage I - 1
#pragma unroll
      for (int s = 0; s < G::R; ++s) x[s] = ex[reg_pad(j + s * G::T)];
      reg_sync<G::T>(team);  // the team has read: its writes may begin
    }
    reg_stage<LOG2N, I, INV>(x, j, tw);
#pragma unroll
    for (int s = 0; s < G::R; ++s) {
      const int p = reg_out_pos<LOG2N, I>(j, s);
      ex[LAST ? p : reg_pad(p)] = x[s];
    }
    reg_stages<LOG2N, INV, I + 1>(x, j, team, ex, tw);
  }
}

// The 2^LOG2N-point transform (the inverse, unnormalised, with INV) of the
// values of team `team`: its thread j < T holds x[slot] = input position
// j + slot T.  ex: the team's exchange buffer [PADDED], which ends holding
// the result in natural order at [0, N).  Only the team's threads call
// this, and synchronise (reg_sync, or the whole block) before reading ex.
template <int LOG2N, bool INV>
__device__ __forceinline__ void reg_fft(float2 (&x)[RegGeo<LOG2N>::R], int j, int team, float2* ex,
                                        const float2* __restrict__ tw) {
  if constexpr (RegGeo<LOG2N>::STAGES == 0) {
    ex[j] = x[0];
  } else {
    reg_stages<LOG2N, INV, 0>(x, j, team, ex, tw);
  }
}

constexpr int REG_MAX_LOG2 = 14;  // FFT_MAX points: a team of 1024 threads

// CALL(L) for the bucket's log2 B (BucketArgs a), each size its own
// instantiation.
#define REG_CASES(CALL) \
  switch (a.logB) {     \
    case 0: CALL(0); break;   \
    case 1: CALL(1); break;   \
    case 2: CALL(2); break;   \
    case 3: CALL(3); break;   \
    case 4: CALL(4); break;   \
    case 5: CALL(5); break;   \
    case 6: CALL(6); break;   \
    case 7: CALL(7); break;   \
    case 8: CALL(8); break;   \
    case 9: CALL(9); break;   \
    case 10: CALL(10); break; \
    case 11: CALL(11); break; \
    case 12: CALL(12); break; \
    case 13: CALL(13); break; \
    case 14: CALL(14); break; \
    default: break;           \
  }

// One forward transform: thread j of team `team` loads its samples j +
// slot T of the frame at xs (L) and xs + width (R), windowed by aw and
// packed as L + i R, and reg_fft's forward leaves the frame's
// spectrum in natural order at the team's part of buf.  forward_frame is
// the transform inline; forward_transform a call of it, so that the
// caller's state waits on the stack and leaves the transform its
// registers.
template <int LOG2N>
__device__ __forceinline__ void forward_frame(const float* __restrict__ xs, long long width,
                                               const float* __restrict__ aw, const float2* __restrict__ tw) {
  using G = RegGeo<LOG2N>;
  extern __shared__ float4 smem[];
  const int team = threadIdx.x / G::T, j = threadIdx.x % G::T;
  float2 v[G::R];
#pragma unroll
  for (int slot = 0; slot < G::R; ++slot) {
    const int n = j + slot * G::T;
    const float wn = __ldg(aw + n);
    v[slot] = make_float2(wn * xs[n], wn * xs[width + n]);
  }
  reg_fft<LOG2N, false>(v, j, team, reinterpret_cast<float2*>(smem) + team * G::PADDED, tw);
}

template <int LOG2N>
__device__ __noinline__ void forward_transform(const float* __restrict__ xs, long long width,
                                               const float* __restrict__ aw, const float2* __restrict__ tw) {
  forward_frame<LOG2N>(xs, width, aw, tw);
}

// One inverse transform: thread j of team `team` takes bins j +
// slot T of the Hermitian-packed W = u + i v (kept bins lo .. lo + K - 1
// of u and v; v null is zeros): W[k] at each kept bin k, its mirror at B -
// k (only the real parts at DC and Nyquist, as irfft reads them), zeros
// elsewhere by selection; then reg_fft's inverse leaves the samples
// in natural order at the team's part of buf.  inverse_frame is the
// transform inline; inverse_transform a call of it, so that the caller's
// state waits on the stack and leaves the transform its registers.
template <int LOG2N>
__device__ __forceinline__ void inverse_frame(const float2* u, const float2* v, int lo, int K,
                                               const float2* __restrict__ tw) {
  using G = RegGeo<LOG2N>;
  extern __shared__ float4 smem[];
  const int team = threadIdx.x / G::T, j = threadIdx.x % G::T;
  float2 x[G::R];
#pragma unroll
  for (int slot = 0; slot < G::R; ++slot) {
    const int k = j + slot * G::T, km = G::N - k;
    const bool kept = (unsigned)(k - lo) < (unsigned)K;
    const bool mirror = !kept && 2 * k > G::N && (unsigned)(km - lo) < (unsigned)K;
    const int i = kept ? k - lo : mirror ? km - lo : 0;  // every read in bounds: the loads go together
    const float2 p = u[i], q0 = (v != nullptr ? v : u)[i];
    const float2 q = v != nullptr ? q0 : make_float2(0.f, 0.f);
    x[slot] = kept ? ((k == 0 || 2 * k == G::N) ? make_float2(p.x, q.x) : make_float2(p.x - q.y, p.y + q.x))
                   : mirror ? make_float2(p.x + q.y, q.x - p.y) : make_float2(0.f, 0.f);
  }
  reg_fft<LOG2N, true>(x, j, team, reinterpret_cast<float2*>(smem) + team * G::PADDED, tw);
}

template <int LOG2N>
__device__ __noinline__ void inverse_transform(const float2* u, const float2* v, int lo, int K,
                                               const float2* __restrict__ tw) {
  inverse_frame<LOG2N>(u, v, lo, K, tw);
}

}  // namespace
