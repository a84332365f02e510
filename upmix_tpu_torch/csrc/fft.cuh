// FP32 FFTs of power-of-two length in shared memory, run by one thread
// block, and the kernels launched on them: windowed stereo frames -> one
// packed complex FFT per frame -> L and R at the kept bins -> gain x
// center mask x band sum (mask.cuh) -> Hermitian-packed inverse FFTs of
// the three outputs -> synthesis window and overlap-add into the caller's
// epilogue (a Sink, below).  omnibus.cu's K1 and K2 run every bucket on
// them; the pool's K3 (pool.cu) and K3s (pool_spectral.cu) only the
// two-stage split of a bucket over FFT_MAX points, and take smaller ones
// to fft_reg.cuh's register core.  unpack_mask and put_pair serve every
// kernel of the pool too.
//
// Transforms (ops/fftplan.py states the same on the host):
//   * fft_forward: in place, decimation in frequency, a radix-2 pass first
//     when log2 n is odd, then radix-4 passes.  Bin k comes out at
//     fft_pos(k) (digit-reversed); no reordering pass.
//   * fft_inverse: the forward's passes undone in reverse order with
//     conjugate twiddles, unnormalised (sum_k X[k] e^{+2 pi i k n / N}):
//     takes bin k at fft_pos(k), gives sample n at n.
//   * Twiddles from a table that the host computed in float64 and rounded
//     once to float32 (ops/fftplan.py::pass_twiddles; no __sinf/__cosf),
//     laid out pass by pass: a radix-2 pass reads exp(-2 pi i u / n) at
//     [u], a radix-4 pass of span L exp(-2 pi i k u / L) at [(k - 1) L/4 +
//     u], so the threads of a warp read neighbouring entries.
// Each butterfly's four values are read and written by one thread, so the
// passes need no second buffer: a 16384-point frame takes 128 KB.
//
// Packings:
//   * stereo in: z = aw * (L + i R); X_L[k] = (Z[k] + conj Z[N-k]) / 2,
//     X_R[k] = (Z[k] - conj Z[N-k]) / 2i (upmix_tpu/ops/fftmm.py:154-166);
//   * two real outputs in: W[k] = U[k] + i V[k] and W[N-k] = conj U[k] +
//     i conj V[k] at the kept bins (only the real parts at DC and Nyquist,
//     as irfft reads them), so ifft(W) = u + i v.  C + i Ls of a frame is
//     written in place over the frame's forward spectrum (every position
//     that is not a kept bin or its mirror zeroed), so only Rs needs room
//     of its own, K values a frame, and shared memory holds any K: a
//     16384-point frame with all 8193 bins kept takes 192 KB.  Rs of
//     frames 2j and 2j + 1 share one transform; a lone frame (G = 1) waits
//     for the next one when two Rs spectra fit beside it (`pair`), else
//     goes alone.
//
// Kernels, each templated on a Sink, the epilogue.  A Sink gives, for row
// s (a segment of K1 or K2, a stream of K3):
//   int first_frame(int s)             frames below it are skipped: never
//                                      read, so a NaN stays in its own row;
//   void init(int s, long long p)      the start of the three outputs at
//                                      position p (zero, a carry, or
//                                      nothing when adding to an earlier
//                                      bucket's output);
//   float* at(int s, int o, long long p)  output o's element at p.
//   * frames_kernel (B <= FFT_MAX = 16384, one launch): block (bx, s) owns
//     output hops [bx T, bx T + T) of row s, starts them (init), and adds
//     every frame that reaches them, G at a time, including the B/H - 1
//     frames that reach in from the left, which the block to the left
//     computes too.  Each output sample is owned by
//     one block and summed in frame order: no atomics, the same bits every
//     run.
//   * wide_forward_kernel + wide_inverse_kernel (B > FFT_MAX, two
//     launches): a frame over 16384 points does not fit one block's
//     227 KB, so it takes the two-stage split B = N1 x N2 of
//     upmix_tpu/ops/fftmm.py:336-437, as the TPU kernel did
//     (pallas_omnibus.py:377-409); N2 = 128, or B / 8192 past 2^20 points
//     (ops/fftplan.py::wide_split), so N1 <= 8192.  Launch 1: each block runs the N1-point
//     FFTs of `cols` of the N2 columns of one frame and sums, for each
//     needed bin k (the kept bins and their mirrors), its columns' share
//     of stage 2 with the twiddle w_B^(k b): N2/cols blocks per frame
//     write partial spectra.  Launch 2: a block owns `cols` columns
//     (positions p with p mod N2 in them) of T hops; per frame it sums the
//     partials in a fixed order and masks, `kt` kept bins at a time (so K
//     does not bound shared memory), computes stage-2 rows only where a
//     kept bin lands (the row restriction of pallas_omnibus.py:390-396),
//     runs the N1-point inverse FFTs and adds the frame in, frames in
//     order.  Launch 2 reads its masked spectra through a Spectra source:
//     PartialSpectra sums launch 1's partials and masks them; the pool's
//     spectral OLA (pool_spectral.cu) reads stored masked spectra, and
//     frames before a stream's first ready hop, which add only from the
//     source's lowest(s) position on.

#pragma once

#include <cuda_runtime.h>

#include "mask.cuh"

namespace {

constexpr int FFT_THREADS = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// The base-4 digit reversal of the low m bits of x (m even): the bits
// reversed, then each digit's two bits swapped back.
__device__ __forceinline__ int digit_reverse4(int x, int m) {
  if (m == 0) return 0;
  const unsigned r = __brev((unsigned)x) >> (32 - m);
  return (int)(((r & 0x55555555u) << 1) | ((r >> 1) & 0x55555555u));
}

// Where the forward transform of 2^log2n points leaves bin k: its radix-2
// digit (when log2n is odd) on top, then its radix-4 digits reversed.
__device__ __forceinline__ int fft_pos(int k, int log2n) {
  const int m = log2n & ~1;
  return (log2n & 1) ? ((k & 1) << m) | digit_reverse4(k >> 1, m) : digit_reverse4(k, m);
}

// The bin the forward transform of 2^log2n points leaves at pos (fft_pos
// inverted).
__device__ __forceinline__ int fft_bin(int pos, int log2n) {
  const int m = log2n & ~1;
  const int r = digit_reverse4(pos & ((1 << m) - 1), m);
  return (log2n & 1) ? (pos >> m) | (r << 1) : r;
}

// `count` transforms of n = 2^log2n points, transform t at buf[t * n];
// tw: pass_twiddles(n).  The caller has synchronised after writing buf;
// returns synchronised.
__device__ void fft_forward(float2* buf, int log2n, int count, const float2* __restrict__ tw) {
  const int n = 1 << log2n;
  int L = n;
  if (log2n & 1) {
    const int M = n >> 1;
    for (int t = threadIdx.x; t < count * M; t += blockDim.x) {
      const int u = t & (M - 1);
      float2* p = buf + (t - u) * 2 + u;
      const float2 a = p[0], b = p[M];
      p[0] = make_float2(a.x + b.x, a.y + b.y);
      p[M] = cmul(make_float2(a.x - b.x, a.y - b.y), tw[u]);
    }
    L = M;
    tw += M;
    __syncthreads();
  }
  for (; L >= 4; L >>= 2) {
    const int M = L >> 2;
    for (int t = threadIdx.x; t < count * (n >> 2); t += blockDim.x) {
      const int u = t & (M - 1);
      float2* p = buf + (t - u) * 4 + u;
      const float2 x0 = p[0], x1 = p[M], x2 = p[2 * M], x3 = p[3 * M];
      const float2 s02 = make_float2(x0.x + x2.x, x0.y + x2.y);
      const float2 d02 = make_float2(x0.x - x2.x, x0.y - x2.y);
      const float2 s13 = make_float2(x1.x + x3.x, x1.y + x3.y);
      const float2 d13 = make_float2(x1.x - x3.x, x1.y - x3.y);
      p[0] = make_float2(s02.x + s13.x, s02.y + s13.y);
      p[M] = cmul(make_float2(d02.x + d13.y, d02.y - d13.x), tw[u]);
      p[2 * M] = cmul(make_float2(s02.x - s13.x, s02.y - s13.y), tw[M + u]);
      p[3 * M] = cmul(make_float2(d02.x - d13.y, d02.y + d13.x), tw[2 * M + u]);
    }
    tw += 3 * M;
    __syncthreads();
  }
}

// The inverse of fft_forward's passes, times n (conjugate twiddles first,
// then the conjugate butterfly), in reverse order.
// The radix-4 pass of span L reads its twiddles at [top - L + base] of
// pass_twiddles(n) (the passes before it in forward order take the rest).
__device__ void fft_inverse(float2* buf, int log2n, int count, const float2* __restrict__ tw) {
  const int n = 1 << log2n;
  const int top = (log2n & 1) ? n >> 1 : n;  // widest radix-4 span
  const int base = (log2n & 1) ? n >> 1 : 0;  // the radix-2 pass's twiddles
  for (int L = 4; L <= top; L <<= 2) {
    const int M = L >> 2;
    const float2* tp = tw + base + top - L;
    for (int t = threadIdx.x; t < count * (n >> 2); t += blockDim.x) {
      const int u = t & (M - 1);
      float2* p = buf + (t - u) * 4 + u;
      const float2 y0 = p[0];
      const float2 y1 = cmulc(p[M], tp[u]);
      const float2 y2 = cmulc(p[2 * M], tp[M + u]);
      const float2 y3 = cmulc(p[3 * M], tp[2 * M + u]);
      const float2 s02 = make_float2(y0.x + y2.x, y0.y + y2.y);
      const float2 d02 = make_float2(y0.x - y2.x, y0.y - y2.y);
      const float2 s13 = make_float2(y1.x + y3.x, y1.y + y3.y);
      const float2 d13 = make_float2(y1.x - y3.x, y1.y - y3.y);
      p[0] = make_float2(s02.x + s13.x, s02.y + s13.y);
      p[M] = make_float2(d02.x - d13.y, d02.y + d13.x);
      p[2 * M] = make_float2(s02.x - s13.x, s02.y - s13.y);
      p[3 * M] = make_float2(d02.x + d13.y, d02.y - d13.x);
    }
    __syncthreads();
  }
  if (log2n & 1) {
    const int M = n >> 1;
    for (int t = threadIdx.x; t < count * M; t += blockDim.x) {
      const int u = t & (M - 1);
      float2* p = buf + (t - u) * 2 + u;
      const float2 a = p[0];
      const float2 b = cmulc(p[M], tw[u]);
      p[0] = make_float2(a.x + b.x, a.y + b.y);
      p[M] = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }
}

// One bucket's geometry and tables on the device.
struct BucketArgs {
  const float* aw;     // [B] analysis window
  const float* sw;     // [B] synthesis window
  const float* gains;  // [nb, K]
  const float2* tw;    // pass_twiddles of the block's transform (B, or N1 when split)
  int B, logB, H, K, lo, nb;
};

inline BucketArgs bucket_args(const float* aw, const float* sw, const float* gains, const float* tw, int B, int H,
                              int K, int lo, int nb) {
  BucketArgs a;
  a.aw = aw;
  a.sw = sw;
  a.gains = gains;
  a.tw = reinterpret_cast<const float2*>(tw);
  a.B = B;
  a.logB = 0;
  while ((1 << a.logB) < B) ++a.logB;
  a.H = H;
  a.K = K;
  a.lo = lo;
  a.nb = nb;
  return a;
}

// The two-stage split's tables (ops/fftplan.py::wide_split).
struct WideArgs {
  const float2* tw1;     // pass_twiddles(N1)
  const float2* stage2;  // [B]: exp(-2 pi i m / B)
  const int* rows;       // stage-1 row of each (tile, row) pair
  const int* row_ptr;    // entries of pair r at row_ptr[r] .. row_ptr[r + 1]
  const int* entries;    // 2 j + mirror: bin lo + j, or its mirror B - lo - j
  const int* tile_ptr;   // pairs of tile t (bins t kt .. t kt + kt - 1) at tile_ptr[t] ..
  int n1, cols, n_tiles, kt;
};

// k b mod B, the stage-2 twiddle's index: unsigned, so the product wraps
// mod 2^32, which B (a power of two) divides, at any block size.
__device__ __forceinline__ unsigned stage2_index(int k, int b, int B) {
  return ((unsigned)k * (unsigned)b) & (unsigned)(B - 1);
}

// C, Ls, Rs of kept bin j from the packed stereo spectrum values at bin k
// (Z) and its mirror (Zm), through the mask.
__device__ __forceinline__ void unpack_mask(float2 Z, float2 Zm, const BucketArgs& a, int j, float2* out) {
  const float lre = 0.5f * (Z.x + Zm.x), lim = 0.5f * (Z.y - Zm.y);
  const float rre = 0.5f * (Z.y + Zm.y), rim = 0.5f * (Zm.x - Z.x);
  float m[6];
  mask_sum_bin(lre, lim, rre, rim, a.gains, a.K, a.nb, j, m);
  out[0] = make_float2(m[0], m[1]);
  out[1] = make_float2(m[2], m[3]);
  out[2] = make_float2(m[4], m[5]);
}

// W[k] = u + i v at bin k (position pk) and its mirror (position pm).
__device__ __forceinline__ void put_pair(float2* t, int k, int pk, int pm, float2 u, float2 v, int B) {
  if (k == 0 || 2 * k == B) {
    t[pk] = make_float2(u.x, v.x);
  } else {
    t[pk] = make_float2(u.x - v.y, u.y + v.x);
    t[pm] = make_float2(u.x + v.y, v.x - u.y);
  }
}

// Is bin k a kept bin or the mirror of one?
__device__ __forceinline__ bool kept_or_mirror(int k, const BucketArgs& a) {
  return (unsigned)(k - a.lo) < (unsigned)a.K || (unsigned)(((a.B - k) & (a.B - 1)) - a.lo) < (unsigned)a.K;
}

// Frames f_base + g, g < G, of the rows xs (L) and xs + ch_stride (R),
// frame f at xs[f * H]: windowed, packed and transformed; then at each
// kept bin the mask, C + i Ls written back in place and Rs into rs[g * K
// + j], and every other position zeroed: buf is ready for the C + i Ls
// inverse.  A frame outside [f_lo, f_hi) is zeros (a select: its samples
// are never read).  The kept bins and their mirrors are distinct
// positions (kept bins lie in [0, B/2]), each pair read and written by
// one thread, so the mask runs in place without a second buffer.
__device__ void forward_mask(float2* buf, float2* rs, const float* __restrict__ xs, long long ch_stride,
                             int f_base, int G, int f_lo, int f_hi, const BucketArgs& a) {
  const int B = a.B;
  for (int idx = threadIdx.x; idx < G * B; idx += blockDim.x) {
    const int g = idx >> a.logB;
    const int n = idx & (B - 1);
    const int f = f_base + g;
    float2 z = make_float2(0.f, 0.f);
    if (f >= f_lo && f < f_hi) {
      const float w = a.aw[n];
      const long long off = (long long)f * a.H + n;
      z = make_float2(w * xs[off], w * xs[ch_stride + off]);
    }
    buf[idx] = z;
  }
  __syncthreads();
  fft_forward(buf, a.logB, G, a.tw);
  for (int idx = threadIdx.x; idx < G * a.K; idx += blockDim.x) {
    const int g = idx / a.K;
    const int k = a.lo + idx - g * a.K;
    float2* t = buf + (g << a.logB);
    const int pk = fft_pos(k, a.logB), pm = fft_pos((B - k) & (B - 1), a.logB);
    float2 m[3];
    unpack_mask(t[pk], t[pm], a, k - a.lo, m);
    put_pair(t, k, pk, pm, m[0], m[1], B);
    rs[idx] = m[2];
  }
  for (int idx = threadIdx.x; idx < G * B; idx += blockDim.x)
    if (!kept_or_mirror(fft_bin(idx & (B - 1), a.logB), a)) buf[idx] = make_float2(0.f, 0.f);
  __syncthreads();
}

// The inverse transforms of the Rs of nf frames (rs[g * K + j]), frames
// 2t and 2t + 1 in transform t; sample n of transform t then at buf[t * B
// + n] (times B).
__device__ void rs_inverse(float2* buf, const float2* rs, int nf, const BucketArgs& a) {
  const int B = a.B;
  const int nt = (nf + 1) >> 1;
  for (int idx = threadIdx.x; idx < nt * B; idx += blockDim.x) buf[idx] = make_float2(0.f, 0.f);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nt * a.K; idx += blockDim.x) {
    const int t = idx / a.K;
    const int j = idx - t * a.K;
    const int k = a.lo + j;
    const float2 u = rs[2 * t * a.K + j];
    const float2 v = 2 * t + 1 < nf ? rs[(2 * t + 1) * a.K + j] : make_float2(0.f, 0.f);
    put_pair(buf + (t << a.logB), k, fft_pos(k, a.logB), fft_pos((B - k) & (B - 1), a.logB), u, v, B);
  }
  __syncthreads();
  fft_inverse(buf, a.logB, nt, a.tw);
}

// Sample n of frame g's output o after the C + i Ls inverse (o = 0 C, 1
// Ls) or rs_inverse (o = 2 Rs), unwindowed and unscaled.
__device__ __forceinline__ float frame_sample(const float2* buf, int o, int g, int n, int logB) {
  if (o < 2) {
    const float2 v = buf[(g << logB) + n];
    return o == 0 ? v.x : v.y;
  }
  const float2 v = buf[((g >> 1) << logB) + n];
  return (g & 1) ? v.y : v.x;
}

// The overlap-add of frames f_base .. f_base + G - 1 (those in [f_lo,
// f_hi)) at position p, hop H: sum over the frames that cover p, in frame
// order, of output o, synthesis-windowed and scaled by 1/B.
__device__ __forceinline__ float ola_sample(const float2* buf, int o, long long p, int f_base, int G, int f_lo,
                                            int f_hi, const BucketArgs& a) {
  const long long d = p - (long long)f_base * a.H;
  const int qq = (int)(d / a.H);
  const int r = (int)(d - (long long)qq * a.H);
  const int Kf = a.B / a.H;
  const int g_lo = max(0, max(qq - Kf + 1, f_lo - f_base));
  const int g_hi = min(G - 1, min(qq, f_hi - 1 - f_base));
  const float inv = 1.0f / (float)a.B;
  float acc = 0.f;
  for (int g = g_lo; g <= g_hi; ++g) {
    const int n = (qq - g) * a.H + r;
    acc += frame_sample(buf, o, g, n, a.logB) * (a.sw[n] * inv);
  }
  return acc;
}

// After an inverse: output o (0: C and Ls, 2: Rs) of frames fb .. fb + nf
// - 1 into the block's span [p0, p1) of row s of the sink; synchronises.
template <class Sink>
struct FrameOla {
  const float2* buf;
  Sink sink;
  BucketArgs a;
  int s, f_lo, f_hi;
  long long p0, p1;

  __device__ void operator()(int o, int fb, int nf) const {
    const long long lo_p = max(p0, (long long)fb * a.H);
    const long long hi_p = min(p1, (long long)(fb + nf - 1) * a.H + a.B);
    for (long long p = lo_p + threadIdx.x; p < hi_p; p += blockDim.x) {
      if (o == 0) {
        *sink.at(s, 0, p) += ola_sample(buf, 0, p, fb, nf, f_lo, f_hi, a);
        *sink.at(s, 1, p) += ola_sample(buf, 1, p, fb, nf, f_lo, f_hi, a);
      } else {
        *sink.at(s, 2, p) += ola_sample(buf, 2, p, fb, nf, f_lo, f_hi, a);
      }
    }
    __syncthreads();
  }
};

// Frames f_begin .. f_end - 1 through the pipeline, G at a time, with
// ola(o, f_base, n) after each inverse.  With `pair` (G = 1) the Rs of two
// frames share one transform: rs holds two frames, and the Rs inverse runs
// every second frame (and after the last).
template <class Ola>
__device__ void run_frames(float2* buf, float2* rs, const float* __restrict__ xs, long long ch_stride, int f_begin,
                           int f_end, int G, bool pair, const BucketArgs& a, const Ola& ola) {
  if (!pair) {
    for (int fb = f_begin; fb < f_end; fb += G) {
      forward_mask(buf, rs, xs, ch_stride, fb, G, f_begin, f_end, a);
      fft_inverse(buf, a.logB, G, a.tw);
      ola(0, fb, G);
      rs_inverse(buf, rs, G, a);
      ola(2, fb, G);
    }
    return;
  }
  for (int fb = f_begin; fb < f_end; ++fb) {
    const int slot = (fb - f_begin) & 1;
    forward_mask(buf, rs + slot * a.K, xs, ch_stride, fb, 1, f_begin, f_end, a);
    fft_inverse(buf, a.logB, 1, a.tw);
    ola(0, fb, 1);
    if (slot == 1 || fb + 1 == f_end) {
      rs_inverse(buf, rs, slot + 1, a);
      ola(2, fb - slot, slot + 1);
    }
  }
}

// Block (blockIdx.x, s = blockIdx.y) owns hops [q0, q0 + T) of the n_hops
// hops of row s's output, q0 = blockIdx.x * T; x [rows, 2, width], frame f
// at f * H, f < F.
template <class Sink>
__global__ void __launch_bounds__(FFT_THREADS)
frames_kernel(const float* __restrict__ x, long long width, Sink sink, BucketArgs a, int F, int n_hops, int T, int G,
              int pair) {
  extern __shared__ float4 smem[];
  float2* buf = reinterpret_cast<float2*>(smem);  // [G * B]
  float2* rs = buf + (size_t)G * a.B;             // [(pair ? 2 : G) * K]
  const int s = blockIdx.y;
  const int q0 = blockIdx.x * T;
  const int q1 = min(q0 + T, n_hops);
  const long long p0 = (long long)q0 * a.H, p1 = (long long)q1 * a.H;
  for (long long p = p0 + threadIdx.x; p < p1; p += blockDim.x) sink.init(s, p);
  __syncthreads();
  const int f_begin = max(q0 - (a.B / a.H - 1), sink.first_frame(s));
  const int f_end = min(q1, F);
  run_frames(buf, rs, x + (long long)s * 2 * width, width, f_begin, f_end, G, pair != 0, a,
             FrameOla<Sink>{buf, sink, a, s, f_begin, f_end, p0, p1});
}

// Launch 1 of a split bucket.  Block (column group, frame f, row s):
// part[s, f, group, i] = sum over its columns b of A[k_i mod N1, b] w_B^(k_i b),
// A = the N1-point FFTs of the windowed packed frame's columns
// z[a * N2 + b]; bins k_i = lo + i (i < K), then B - lo - (i - K).
template <class Sink>
__global__ void __launch_bounds__(FFT_THREADS)
wide_forward_kernel(const float* __restrict__ x, long long width, float2* __restrict__ part, Sink sink,
                    BucketArgs a, WideArgs w, int F) {
  extern __shared__ float4 smem[];
  float2* buf = reinterpret_cast<float2*>(smem);  // [cols][n1]
  const int f = blockIdx.y;
  const int s = blockIdx.z;
  if (f < sink.first_frame(s)) return;  // a frame the inverse skips: never read
  const int B = a.B, n1 = w.n1, cols = w.cols;
  const int log_n1 = 31 - __clz(n1);
  const int n2 = B / n1;
  const int b0 = blockIdx.x * cols;
  const float* xl = x + (long long)s * 2 * width + (long long)f * a.H;
  const float* xr = xl + width;
  for (int idx = threadIdx.x; idx < cols * n1; idx += blockDim.x) {
    const int c = idx % cols;
    const int r = idx / cols;
    const int n = r * n2 + b0 + c;
    const float wn = a.aw[n];
    buf[c * n1 + r] = make_float2(wn * xl[n], wn * xr[n]);
  }
  __syncthreads();
  fft_forward(buf, log_n1, cols, w.tw1);
  float2* out = part + (((long long)s * F + f) * (n2 / cols) + blockIdx.x) * 2 * a.K;
  for (int i = threadIdx.x; i < 2 * a.K; i += blockDim.x) {
    const int k = i < a.K ? a.lo + i : (B - (a.lo + i - a.K)) & (B - 1);
    const int pos = fft_pos(k & (n1 - 1), log_n1);
    float2 acc = make_float2(0.f, 0.f);
    for (int c = 0; c < cols; ++c) {
      const float2 v = cmul(buf[c * n1 + pos], w.stage2[stage2_index(k, b0 + c, B)]);
      acc.x += v.x;
      acc.y += v.y;
    }
    out[i] = acc;
  }
}

// The masked spectra of a split bucket's frames from launch 1's partials
// part [rows, F, N2 / cols, 2K]: the groups summed in a fixed order, then
// the mask.  load(s, f, j, out) writes C, Ls, Rs of kept bin j of frame
// f; lowest(s) is the first position frames may add into.
struct PartialSpectra {
  const float2* part;
  BucketArgs a;
  int F, groups;

  __device__ void load(int s, int f, int j, float2* out) const {
    const float2* pf = part + ((long long)s * F + f) * groups * 2 * a.K;
    float2 Z = make_float2(0.f, 0.f), Zm = make_float2(0.f, 0.f);
    for (int g = 0; g < groups; ++g) {  // fixed order: deterministic
      const float2 u = pf[g * 2 * a.K + j], v = pf[g * 2 * a.K + a.K + j];
      Z.x += u.x;
      Z.y += u.y;
      Zm.x += v.x;
      Zm.y += v.y;
    }
    unpack_mask(Z, Zm, a, j, out);
  }

  __device__ long long lowest(int) const { return 0; }
};

// Launch 2 of a split bucket.  Block (column group, hop block, row s) owns
// positions p = q * H + r, q0 <= q < q0 + T, with p mod N2 in its columns;
// per frame that reaches them: C + i Ls, then (every second frame, and
// after the last) the Rs of two frames, each a transform: per tile of kt
// kept bins the masked spectra loaded into spec (src.load), stage 2
// backwards on the rows that carry a bin of the tile (added into buf),
// then the N1-point inverse FFTs and the frame's samples added in at
// positions from src.lowest(s) on.  With one tile the masked spectra of
// both frames stay in spec for the Rs transform; with several, the Rs
// transform loads its two frames again.
template <class Sink, class Spectra>
__global__ void __launch_bounds__(FFT_THREADS)
wide_inverse_kernel(Spectra src, Sink sink, BucketArgs a, WideArgs w, int F, int n_hops, int T) {
  extern __shared__ float4 smem[];
  const int B = a.B, H = a.H, K = a.K, n1 = w.n1, cols = w.cols, kt_max = w.kt;
  float2* buf = reinterpret_cast<float2*>(smem);  // [cols][n1]
  float2* spec = buf + (size_t)cols * n1;         // [2][kt][3]: two frames' C, Ls, Rs
  const int log_n1 = 31 - __clz(n1);
  const int n2 = B / n1;
  const int Kf = B / H;
  const int b0 = blockIdx.x * cols;
  const int q0 = blockIdx.y * T;
  const int q1 = min(q0 + T, n_hops);
  const int s = blockIdx.z;
  const float inv = 1.0f / (float)B;
  const long long r0 = (long long)q0 * H / n2, r1 = (long long)q1 * H / n2;  // rows of N2 positions
  for (long long idx = threadIdx.x; idx < (r1 - r0) * cols; idx += blockDim.x)
    sink.init(s, (r0 + idx / cols) * n2 + b0 + idx % cols);
  __syncthreads();
  const int f_begin = max(sink.first_frame(s), q0 - (Kf - 1)), f_end = min(F, q1);
  for (int f = f_begin; f < f_end; ++f) {
    const int slot = (f - f_begin) & 1;
    const int passes = (slot == 1 || f + 1 == f_end) ? 2 : 1;
    for (int pass = 0; pass < passes; ++pass) {
      // pass 0: C + i Ls of frame f; pass 1: Rs of frame f - slot + i Rs of frame f (slot 1)
      for (int idx = threadIdx.x; idx < cols * n1; idx += blockDim.x) buf[idx] = make_float2(0.f, 0.f);
      for (int t = 0; t < w.n_tiles; ++t) {
        const int j0 = t * kt_max;
        const int kt = min(kt_max, K - j0);
        if (pass == 0 || w.n_tiles > 1) {
          const int nfr = pass == 0 ? 1 : slot + 1;
          for (int idx = threadIdx.x; idx < nfr * kt; idx += blockDim.x) {
            const int i = idx / kt;
            const int jj = idx - i * kt;
            const int ff = pass == 0 ? f : f - slot + i;
            const int sl = pass == 0 ? slot : i;
            src.load(s, ff, j0 + jj, spec + 3 * (sl * kt_max + jj));
          }
        }
        __syncthreads();
        const int pa = w.tile_ptr[t], pb = w.tile_ptr[t + 1];
        for (int idx = threadIdx.x; idx < (pb - pa) * cols; idx += blockDim.x) {
          const int r = pa + idx / cols;
          const int c = idx % cols;
          const int b = b0 + c;
          float2 acc = make_float2(0.f, 0.f);
          for (int e = w.row_ptr[r]; e < w.row_ptr[r + 1]; ++e) {
            const int jj = (w.entries[e] >> 1) - j0;
            const int k = a.lo + j0 + jj;
            const float2 u = pass == 0 ? spec[3 * (slot * kt_max + jj)] : spec[3 * jj + 2];
            const float2 v = pass == 0 ? spec[3 * (slot * kt_max + jj) + 1]
                                       : (slot == 1 ? spec[3 * (kt_max + jj) + 2] : make_float2(0.f, 0.f));
            float2 val;
            int kk = k;
            if (k == 0 || 2 * k == B) {
              val = make_float2(u.x, v.x);
            } else if (w.entries[e] & 1) {
              val = make_float2(u.x + v.y, v.x - u.y);
              kk = B - k;
            } else {
              val = make_float2(u.x - v.y, u.y + v.x);
            }
            const float2 tv = cmulc(val, w.stage2[stage2_index(kk, b, B)]);
            acc.x += tv.x;
            acc.y += tv.y;
          }
          float2& d = buf[c * n1 + fft_pos(w.rows[r], log_n1)];
          d = make_float2(d.x + acc.x, d.y + acc.y);
        }
        __syncthreads();
      }
      fft_inverse(buf, log_n1, cols, w.tw1);
      // The frames of this transform (f, or f - slot and f) at each of the
      // block's positions they cover, summed in frame order.
      const int fa = pass == 0 ? f : f - slot;
      const int nf = pass == 0 ? 1 : slot + 1;
      const long long ra = max(max((long long)q0 * H, (long long)fa * H), src.lowest(s)) / n2;
      const long long rb = min((long long)q1 * H, (long long)(fa + nf - 1) * H + B) / n2;
      for (long long idx = threadIdx.x; idx < (rb - ra) * cols; idx += blockDim.x) {
        const int c = (int)(idx % cols);
        const long long p = (ra + idx / cols) * n2 + b0 + c;
        float acc0 = 0.f, acc1 = 0.f;
        for (int i = 0; i < nf; ++i) {
          const long long n = p - (long long)(fa + i) * H;
          if (n < 0 || n >= B) continue;
          const float2 v = buf[c * n1 + (int)(n / n2)];
          const float wn = a.sw[n] * inv;
          if (pass == 0) {
            acc0 += v.x * wn;
            acc1 += v.y * wn;
          } else {
            acc0 += (i == 0 ? v.x : v.y) * wn;
          }
        }
        if (pass == 0) {
          *sink.at(s, 0, p) += acc0;
          *sink.at(s, 1, p) += acc1;
        } else {
          *sink.at(s, 2, p) += acc0;
        }
      }
      __syncthreads();
    }
  }
}

// Host launchers; each returns cudaGetLastError().

template <class Sink>
int launch_frames(const float* x, long long width, Sink sink, BucketArgs a, int rows, int F, int n_hops, int T, int G,
                  int pair, void* stream) {
  const size_t smem = (sizeof(float2) * ((size_t)G * a.B + (size_t)(pair ? 2 : G) * a.K) + 15) & ~(size_t)15;
  const cudaError_t err =
      cudaFuncSetAttribute(frames_kernel<Sink>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_hops + T - 1) / T, rows, 1);
  frames_kernel<Sink><<<grid, FFT_THREADS, smem, (cudaStream_t)stream>>>(x, width, sink, a, F, n_hops, T, G, pair);
  return (int)cudaGetLastError();
}

template <class Sink>
int launch_wide_forward(const float* x, long long width, float* part, Sink sink, BucketArgs a, WideArgs w, int rows,
                        int F, void* stream) {
  const size_t smem = sizeof(float2) * (size_t)w.cols * w.n1;
  const cudaError_t err =
      cudaFuncSetAttribute(wide_forward_kernel<Sink>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B / w.n1 / w.cols, F, rows);
  wide_forward_kernel<Sink><<<grid, FFT_THREADS, smem, (cudaStream_t)stream>>>(
      x, width, reinterpret_cast<float2*>(part), sink, a, w, F);
  return (int)cudaGetLastError();
}

template <class Sink, class Spectra>
int launch_wide_inverse_from(Spectra src, Sink sink, BucketArgs a, WideArgs w, int rows, int F, int n_hops, int T,
                             void* stream) {
  const size_t smem = (sizeof(float2) * ((size_t)w.cols * w.n1 + (size_t)2 * w.kt * 3) + 15) & ~(size_t)15;
  const cudaError_t err = cudaFuncSetAttribute(wide_inverse_kernel<Sink, Spectra>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B / w.n1 / w.cols, (n_hops + T - 1) / T, rows);
  wide_inverse_kernel<Sink, Spectra><<<grid, FFT_THREADS, smem, (cudaStream_t)stream>>>(src, sink, a, w, F, n_hops,
                                                                                          T);
  return (int)cudaGetLastError();
}

template <class Sink>
int launch_wide_inverse(const float* part, Sink sink, BucketArgs a, WideArgs w, int rows, int F, int n_hops, int T,
                        void* stream) {
  const PartialSpectra src{reinterpret_cast<const float2*>(part), a, F, a.B / w.n1 / w.cols};
  return launch_wide_inverse_from(src, sink, a, w, rows, F, n_hops, T, stream);
}

}  // namespace
