// The serving-pool step's spectral-OLA dataflow for Hopper (sm_90a): K3s.
//
// Replaces the spectral body of the TPU kernel
// upmix_tpu/ops/pallas_pool.py::pool_step_lcr (_spectral_bucket, chosen by
// plan.ola in _build_pool_kernel).  It computes the time OLA's function
// (pool.cu) by another dataflow: a bucket's state is the masked spectra
// (C, Ls, Rs at the K kept bins, unnormalised) of its last Kr - 1 frames,
// Kr = B/H, instead of [S, 3, B] time-domain carries.
//
//   * A stream's "virtual frames" v run from f0 - (Kr - 1) to F - 1, where
//     F = hops * P is this call's frames (frame f at f * H of the history)
//     and f0 = i0 * P the first frame of its first ready hop, i0 =
//     clamp(warmup - t[s], 0, hops): v < f0 is carried slot v - f0 + Kr -
//     1, v >= f0 a new frame.  Not-ready hops come first in a call, so
//     this is the JAX body's hop-by-hop gate with the carry held and
//     chained: the not-ready hops' frames are never read, and their output
//     is exact zeros.
//   * Output position n (< hops * hw) is zero below i0 * hw, else the sum
//     over the virtual frames v covering n of irfft(frame v's kept bins)
//     [n - v H] times the synthesis window; the new carry is the last Kr
//     - 1 virtual frames (the carry as it was when no hop is ready).
//
// Design (ops/pool.py states each step's plain version):
//   1. spectral_forward_kernel: window, packed-stereo FFT and mask
//      (fft.cuh's unpack_mask) of the new frames into spec [S, 3, F, K]
//      float2, and the new carry: its new frames from the same values, its
//      older ones copied from the carry.  The FFTs are fft_reg.cuh's, held
//      in registers: a block of at least REG_FORWARD_THREADS threads runs
//      one frame a team of B / 16 threads, the (stream, frame) pairs in
//      turn, each thread loading its 16 windowed samples straight from the
//      history; a team waits only on its own barriers, and skips a frame
//      of a not-ready hop.  Over FFT_MAX points the split's wide_forward_kernel
//      (pool.cu's pool_wide_forward) writes partials and
//      spectral_mask_kernel sums and masks them into spec and the carry.
//   2. The edge product, for the buckets the plan sends to it
//      (ops/pool.py::takes_edge_product: those whose every frame of a
//      one-block call is an edge frame, the 8192 and 4096 buckets at hw
//      2048).  An "edge frame" v, whose span [vH, vH + B) the output [0,
//      hops * hw) cuts (the Kr - 1 carried frames reaching in from the
//      left, the last Kr - 1 new ones), adds only a sliver of the output
//      from K kept bins, so it is no inverse FFT but a product: out[(s,
//      o), n] = sum over edge frames v and k < 2K of spec_v[(s, o), k] w[n
//      - vH, k], w the inverse weight (synthesis window and 1/B, 2/B
//      folded in; ops/pool.py::make_edge_weight) read at each frame's
//      sample offset, never expanded.  In split precision, bf16x3 as K4's
//      rung of that name (int8_dot.cu): hi + lo of each operand, three
//      products into float32 sums.  Two launches for up to
//      EDGE_MAX_BUCKETS buckets:
//      a. spectral_edge_gather_kernel: each row's edge frames (carried or
//         new, zeros outside its window) split into hi + lo, [2, 3 S,
//         n_edge, Kp] (the weight is split once, in the plan);
//      b. spectral_edge_kernel: block (128 samples, 128 rows (s, o)) runs
//         the buckets' edge frames that reach its samples, 32 values of
//         one frame a stage, copied by cp.async into a two-stage ring
//         (the next stage lands while this one multiplies), on the tensor
//         cores: mma.sync fed by ldmatrix, 8 warps of 32 rows x 64
//         samples, two blocks an SM.
//      Rows of streams below their first ready hop are written as zeros
//      by selection, so a NaN in a not-ready carry stays in its row.
//   3. spectral_inverse_kernel, one block per stream (as pool.cu's K3):
//      the rest, "whole frames" (inside the output), and every frame of a
//      bucket the product does not take, a round of frames at a time in
//      frame order: the Hermitian-packed inverse FFTs (fft_reg.cuh's) of
//      C + i Ls of each frame and of the Rs of two frames, a team each,
//      the kept bins read from the spectra straight into its registers (no
//      zeroed buffer), then each output sample's frames of the round added
//      in frame order onto the product's output, as fft.cuh's FrameOla
//      adds them (ola_round: the three outputs in one pass, a thread's
//      reads of four positions in flight together).  Over FFT_MAX points,
//      fft.cuh's wide_inverse_kernel with a SpectralState as its source.
// Every output element is owned by one block of each launch and added to
// in a fixed order (the product's buckets, frames and stages in order, no
// split of the depth, then the whole frames bucket by bucket), so the
// result is deterministic and does not depend on the other rows of the
// launch.
// What bounds it on the H100: the product's operations are 3 x 2 x 2K a
// sample and frame (5.8e10 FLOP a block at S = 2048, hw 2048, hops 1,
// where the inverse FFTs it replaces were 1.0e10), but on the tensor
// cores: it is bound by issuing them (mma.sync, three per product) and
// by its shared-memory fragment loads.  The FFT kernels keep each frame
// in registers and pass it through shared memory once a stage of 16 (two
// barriers of its team a stage, where fft.cuh's core takes one pass and
// one barrier of the block every radix 4); at 64 registers a thread (two
// blocks of 512 threads an SM) each transform and overlap-add is a call
// of its own, so that the caller's state waits on the stack and does not
// spill the FFT's registers.  The forward is bound by the history it reads
// and the spectra it writes, the inverse by its overlap-add's reads and
// writes of the output.  The new spectra and the gathered operand go
// through device memory between the launches.
//
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include <cuda_bf16.h>

#include <climits>
#include <cstdint>

#include "fft.cuh"
#include "fft_reg.cuh"

namespace {

// The masked spectra of a stream's virtual frames: carry [S, 3, Kr - 1, K]
// and spec [S, 3, F, K] (float2).  Also fft.cuh's Spectra source.
struct SpectralState {
  const float2* carry;
  const float2* spec;
  const int* t;
  int F, K, Kr, H, per_hop, warmup, hops;

  __device__ int first_new(int s) const { return min(max(warmup - t[s], 0), hops) * per_hop; }

  __device__ const float2* frame(int s, int o, int v) const {
    const int f0 = first_new(s);
    const long long so = (long long)s * 3 + o;
    return v >= f0 ? spec + (so * F + v) * K : carry + (so * (Kr - 1) + v - f0 + Kr - 1) * K;
  }

  __device__ void load(int s, int v, int j, float2* out) const {
    for (int o = 0; o < 3; ++o) out[o] = frame(s, o, v)[j];
  }

  // Carried frames reach below the first ready hop: that output is done.
  __device__ long long lowest(int s) const { return (long long)first_new(s) * H; }
};

// out [S, 3, hops * hw]: written (zeros first), or added into, by the
// frames from v_lo on (the whole frames: 0, or every frame: 1 - Kr).
struct SpectralSink {
  float* out;
  SpectralState st;
  long long row;
  int accumulate, v_lo;

  __device__ int first_frame(int s) const { return max(v_lo, st.first_new(s) - (st.Kr - 1)); }

  __device__ void init(int s, long long n) const {
    if (accumulate) return;
    for (int o = 0; o < 3; ++o) out[((long long)s * 3 + o) * row + n] = 0.f;
  }

  __device__ float* at(int s, int o, long long n) const { return out + ((long long)s * 3 + o) * row + n; }
};

// Slot `slot` of the new carry of stream s, output o: virtual frame F -
// (Kr - 1) + slot.
__device__ __forceinline__ float2* carry_slot(float2* carry_out, const SpectralState& st, int s, int o, int slot) {
  return carry_out + (((long long)s * 3 + o) * (st.Kr - 1) + slot) * st.K;
}

// The new carry's slots that hold frames from before this call's first
// ready hop, copied from the carry by threads lane, lane + stride, ..
// (those of the stream's first frame).
__device__ void copy_old_slots(float2* carry_out, const SpectralState& st, int s, int lane, int stride) {
  const int f0 = st.first_new(s), n = st.Kr - 1;
  if (st.F - n >= f0) return;  // every slot holds a new frame
  for (int idx = lane; idx < 3 * n * st.K; idx += stride) {
    const int o = idx / (n * st.K);
    const int r = idx - o * n * st.K;
    const int slot = r / st.K;
    const int j = r - slot * st.K;
    const int v = st.F - n + slot;
    if (v < f0) carry_slot(carry_out, st, s, o, slot)[j] = st.frame(s, o, v)[j];
  }
}

// Masked spectra m[3] of kept bin j of new frame f: into spec, and into the
// new carry when f is one of the last Kr - 1 frames.
__device__ __forceinline__ void store_frame(float2* spec, float2* carry_out, const SpectralState& st, int s, int f,
                                            int j, const float2* m) {
  const int n = st.Kr - 1;
  for (int o = 0; o < 3; ++o) {
    spec[(((long long)s * 3 + o) * st.F + f) * st.K + j] = m[o];
    if (f >= st.F - n) carry_slot(carry_out, st, s, o, f - (st.F - n))[j] = m[o];
  }
}

// Threads a block of the two FFT kernels: at least these, and one team of
// a transform (ops/fftplan.py::REG_FORWARD_THREADS, REG_INVERSE_THREADS).
constexpr int REG_FORWARD_THREADS = 256;
constexpr int REG_INVERSE_THREADS = 512;

inline int reg_block(int log2n, int least) { return max(least, log2n < 4 ? 1 : 1 << (log2n - 4)); }

// Step 1 on 2^LOG2N points.  Team i of block b takes the g-th (stream,
// frame) pair, g = b * teams + i, frame f = g mod F of stream s = g / F; a
// frame of a not-ready hop is never read, transformed nor stored.
template <int LOG2N>
__device__ __forceinline__ void forward_frames(const float* __restrict__ x, long long width, const SpectralState& st,
                                               float2* __restrict__ spec, float2* __restrict__ carry_out,
                                               const BucketArgs& a, int S) {
  using G = RegGeo<LOG2N>;
  extern __shared__ float4 smem[];
  const int team = threadIdx.x / G::T, j = threadIdx.x % G::T;
  const long long g = (long long)blockIdx.x * (blockDim.x / G::T) + team;
  const int s = (int)(g / st.F), f = (int)(g - (long long)s * st.F);
  if (s >= S) return;
  if (f == 0) copy_old_slots(carry_out, st, s, j, G::T);
  if (f < st.first_new(s)) return;
  forward_transform<LOG2N>(x + (long long)s * 2 * width + (long long)f * a.H, width, a.aw, a.tw);
  reg_sync<G::T>(team);
  const float2* z = reinterpret_cast<const float2*>(smem) + team * G::PADDED;  // [N]
  for (int jj = j; jj < a.K; jj += G::T) {
    const int k = a.lo + jj;
    float2 m[3];
    unpack_mask(z[k], z[(G::N - k) & (G::N - 1)], a, jj, m);
    store_frame(spec, carry_out, st, s, f, jj, m);
  }
}

// Step 1.  Frames of the history x [S, 2, width], frame f at f * H: those
// of ready hops windowed, packed, transformed and masked (forward_frames).
__global__ void __launch_bounds__(1024)
spectral_forward_kernel(const float* __restrict__ x, long long width, SpectralState st, float2* __restrict__ spec,
                        float2* __restrict__ carry_out, BucketArgs a, int S) {
#define REG_FORWARD(L) forward_frames<L>(x, width, st, spec, carry_out, a, S)
  REG_CASES(REG_FORWARD)
#undef REG_FORWARD
}

constexpr int MASK_THREADS = 256;

// Step 1 of a split bucket, its second launch: thread (f * K + j, stream s) sums
// the partials part [S, F, groups, 2K] of kept bin j of frame f in a fixed
// order and masks them (the sums and mask of fft.cuh's PartialSpectra).
__global__ void __launch_bounds__(MASK_THREADS)
spectral_mask_kernel(const float2* __restrict__ part, SpectralState st, float2* __restrict__ spec,
                     float2* __restrict__ carry_out, BucketArgs a, int groups) {
  const int s = blockIdx.y;
  if (blockIdx.x == 0) copy_old_slots(carry_out, st, s, threadIdx.x, MASK_THREADS);
  const int idx = blockIdx.x * MASK_THREADS + threadIdx.x;
  if (idx >= st.F * a.K) return;
  const int f = idx / a.K;
  const int j = idx - f * a.K;
  if (f < st.first_new(s)) return;
  float2 m[3];
  PartialSpectra{part, a, st.F, groups}.load(s, f, j, m);
  store_frame(spec, carry_out, st, s, f, j, m);
}

// The spectra of transform t of a round of nf frames from fb: t < nf
// takes u, v = C, Ls of frame fb + t, t >= nf the Rs of frames fb + 2 (t -
// nf) and the next (v null past the round).
__device__ __forceinline__ void round_spectra(const SpectralState& st, int s, int fb, int nf, int t, const float2*& u,
                                              const float2*& v) {
  if (t < nf) {
    u = st.frame(s, 0, fb + t);
    v = st.frame(s, 1, fb + t);
  } else {
    const int f = fb + 2 * (t - nf);
    u = st.frame(s, 2, f);
    v = f + 1 < fb + nf ? st.frame(s, 2, f + 1) : nullptr;
  }
}

// The overlap-add of a round's frames fb .. fb + nf - 1 (frame v at v H)
// into positions [first, last) of a stream's outputs (output o at out + o
// row): with `cl` C and Ls from the C + i Ls transforms at cls (transform
// g at g * PADDED), with `rr` Rs from the Rs transforms at rs (frames 2t
// and 2t + 1 in transform t).  At each position p each output's sum over
// the frames in frame order of sample p - vH, synthesis-windowed and
// scaled by 1/N, is added to the output, as fft.cuh's FrameOla adds it.
// A thread takes OLA_SPAN positions at a time and reads all their outputs
// before it writes any, so that the reads are in flight together; a call,
// whose registers the caller's state does not crowd.
constexpr int OLA_SPAN = 4;

template <int LOG2N>
__device__ __noinline__ void ola_round(float* out, long long row, long long first, long long last,
                                       const float2* cls, const float2* rs, bool cl, bool rr, int fb, int nf, int H,
                                       const float* __restrict__ sw) {
  constexpr int N = RegGeo<LOG2N>::N, PADDED = RegGeo<LOG2N>::PADDED;
  const int Kf = N / H;
  const int d0 = (int)(first - (long long)fb * H), span = (int)max(0LL, last - first);
  const float inv = 1.0f / (float)N;
  for (int i0 = threadIdx.x; i0 < span; i0 += OLA_SPAN * blockDim.x) {
    float sum[OLA_SPAN][3], old[OLA_SPAN][3];
#pragma unroll
    for (int u = 0; u < OLA_SPAN; ++u) {
      const int d = d0 + i0 + u * blockDim.x;  // p - fb H
      const int qq = d / H, r = d - qq * H;
      const int g_lo = max(0, qq - Kf + 1), g_hi = min(nf - 1, qq);
      sum[u][0] = sum[u][1] = sum[u][2] = 0.f;
      for (int g = g_lo; g <= g_hi && i0 + u * (int)blockDim.x < span; ++g) {
        const int n = (qq - g) * H + r;
        const float w = sw[n] * inv;
        if (cl) {
          const float2 v = cls[g * PADDED + n];
          sum[u][0] += v.x * w;
          sum[u][1] += v.y * w;
        }
        if (rr) {
          const float2 v = rs[(g >> 1) * PADDED + n];
          sum[u][2] += ((g & 1) ? v.y : v.x) * w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < OLA_SPAN; ++u) {
      const int i = i0 + u * blockDim.x;
#pragma unroll
      for (int o = 0; o < 3; ++o)
        if (i < span && (o < 2 ? cl : rr)) old[u][o] = out[o * row + first + i];
    }
#pragma unroll
    for (int u = 0; u < OLA_SPAN; ++u) {
      const int i = i0 + u * blockDim.x;
#pragma unroll
      for (int o = 0; o < 3; ++o)
        if (i < span && (o < 2 ? cl : rr)) out[o * row + first + i] = old[u][o] + sum[u][o];
    }
  }
}

// Step 3 on 2^LOG2N points.  Block (hop block, stream s) owns output hops
// [q0, q0 + T) of the n_hops; the frames in [sink.v_lo, v_hi) that reach
// them, `round` at a time in frame order, round + ceil(round / 2) <= teams
// transforms (with one team, the C + i Ls and the Rs transform in turn):
// team t < nf the C + i Ls of frame fb + t, the next ones the Rs of frames
// fb + 2 (t - nf) and the next; then each output sample's frames of the
// round added in frame order (ola_round).
template <int LOG2N>
__device__ __forceinline__ void inverse_frames(const SpectralState& st, const SpectralSink& sink, const BucketArgs& a,
                                               int n_hops, int T, int v_hi) {
  using G = RegGeo<LOG2N>;
  extern __shared__ float4 smem[];
  const float2* buf = reinterpret_cast<const float2*>(smem);  // [teams][PADDED]: samples at [0, N) of each
  const int s = blockIdx.y;
  const int q0 = blockIdx.x * T;
  const int q1 = min(q0 + T, n_hops);
  const long long p0 = (long long)q0 * a.H, p1 = (long long)q1 * a.H;
  for (long long p = p0 + threadIdx.x; p < p1; p += blockDim.x) sink.init(s, p);
  const int f_begin = max(q0 - (G::N / a.H - 1), sink.first_frame(s));
  const int f_end = min(q1, v_hi);
  const int teams = blockDim.x / G::T;
  const int round = max(1, 2 * teams / 3);
  const long long lo_p = max(p0, st.lowest(s));
  for (int fb = f_begin; fb < f_end; fb += round) {
    const int nf = min(round, f_end - fb), nt = nf + (nf + 1) / 2;
    for (int t0 = 0; t0 < nt; t0 += teams) {  // one pass, or two with one team
      const int t = t0 + (int)threadIdx.x / G::T;
      if (t < nt) {  // a team with no transform waits at the block's barrier
        const float2 *u, *v;
        round_spectra(st, s, fb, nf, t, u, v);
        inverse_transform<LOG2N>(u, v, a.lo, a.K, a.tw);
      }
      __syncthreads();
      // this pass's C + i Ls transforms, its Rs ones, at the positions in [lo_p, p1) the round reaches
      ola_round<LOG2N>(sink.at(s, 0, 0), sink.row, max(lo_p, (long long)fb * a.H),
                       min(p1, (long long)(fb + nf - 1) * a.H + G::N), buf, buf + (nf - t0) * G::PADDED, t0 == 0,
                       t0 <= nf && nt <= t0 + teams, fb, nf, a.H, a.sw);
      __syncthreads();
    }
  }
}

// Step 3: the whole frames of one bucket into out (inverse_frames).
__global__ void __launch_bounds__(1024)
spectral_inverse_kernel(SpectralState st, SpectralSink sink, BucketArgs a, int n_hops, int T, int v_hi) {
#define REG_INVERSE(L) inverse_frames<L>(st, sink, a, n_hops, T, v_hi)
  REG_CASES(REG_INVERSE)
#undef REG_INVERSE
}

// A test of the core through the two kernels' own transforms: count
// transforms of 2^log2n points a team each.  Forward: x [count, 2, N] the
// real and imaginary planes of each input (frames of a history of width
// N, windowed by aw, ones for a plain FFT); inverse: x [count, 2, N / 2 +
// 1] float2 the half spectra U, V of two real signals, every bin kept, so
// that the output is N (u + i v).  y [count, N] float2 in natural order.
__global__ void __launch_bounds__(1024)
spectral_reg_fft_kernel(const float* __restrict__ x, float2* __restrict__ y, const float* __restrict__ aw,
                        const float2* __restrict__ tw, int count, int inverse, BucketArgs a) {
#define REG_TEST(L)                                                                                    \
  do {                                                                                                 \
    using G = RegGeo<L>;                                                                               \
    extern __shared__ float4 smem[];                                                                   \
    const int team = threadIdx.x / G::T, j = threadIdx.x % G::T;                                       \
    const long long t = (long long)blockIdx.x * (blockDim.x / G::T) + team;                            \
    if (t >= count) return;                                                                            \
    if (inverse) {                                                                                     \
      const float2* u = reinterpret_cast<const float2*>(x) + t * 2 * (G::N / 2 + 1);                   \
      inverse_transform<L>(u, u + G::N / 2 + 1, 0, G::N / 2 + 1, tw);                                  \
    } else {                                                                                           \
      forward_transform<L>(x + t * 2 * G::N, G::N, aw, tw);                                            \
    }                                                                                                  \
    reg_sync<G::T>(team);                                                                              \
    const float2* z = reinterpret_cast<const float2*>(smem) + team * G::PADDED;                        \
    for (int n = j; n < G::N; n += G::T) y[t * G::N + n] = z[n];                                      \
  } while (0)
  REG_CASES(REG_TEST)
#undef REG_TEST
}

// ---------------------------------------------------------------------------
// Step 2: the edge product on the tensor cores (the gather, then the product).

constexpr int EDGE_BM = 128;  // rows (s, o) a block
constexpr int EDGE_BN = 128;  // output samples a block
constexpr int EDGE_BK = 32;   // depth a stage: 16 kept bins of one frame, (re, im) pairs
constexpr int EDGE_THREADS = 256;  // 8 warps: 4 down the rows x 2 across the samples, 32 x 64 each
constexpr int EDGE_STAGES = 2;  // the cp.async ring: two stages, two blocks an SM
constexpr int EDGE_MAX_BUCKETS = 8;
constexpr int EDGE_MT = 2;  // 16-row tiles a warp
constexpr int EDGE_NT = 8;  // 8-sample tiles a warp
constexpr int GATHER_THREADS = 256;

// Index checks of the product's loads, for a build with -DEDGE_CHECKS
// (a fault traps where it happens).
#ifdef EDGE_CHECKS
#define EDGE_CHECK(c) \
  do {                \
    if (!(c)) __trap(); \
  } while (0)
#else
#define EDGE_CHECK(c) ((void)0)
#endif

// The operands' element, and their shared-memory row stride in elements:
// padded so that a warp's fragment loads of eight rows hit distinct banks,
// and a whole number of 16 bytes.
using EdgeT = __nv_bfloat16;
constexpr int EDGE_LD = EDGE_BK + 8;

// One stage: [hi, lo] x [A: BM rows | W: BN samples] x EDGE_LD.
constexpr int EDGE_STAGE = 2 * (EDGE_BM + EDGE_BN) * EDGE_LD;
constexpr size_t EDGE_SMEM = sizeof(EdgeT) * EDGE_STAGES * EDGE_STAGE;

// One bucket the product takes.  Its edge frames e = 0 .. n_edge - 1 are v
// = e + 1 - Kr for e < Kr - 1 (reaching in from the left), then v = right
// + e - (Kr - 1), right = max(0, F - Kr + 1).  a: the gathered split
// operand [hi, lo][rows][n_edge][Kp] (step 2a writes it); w: the split
// weight [hi, lo][B][Kp] (sample n's Kp values contiguous, rows 2K .. Kp -
// 1 zeros; ops/pool.py::split_edge_weight).
struct EdgeBucket {
  const void* w;
  void* a;
  const float2* carry;  // [S, 3, Kr - 1, K]
  const float2* spec;   // [S, 3, F, K]
  int B, H, K, Kp, F, Kr, P, n_edge;

  __device__ int right() const { return max(0, F - Kr + 1); }
  __device__ int frame(int e) const { return e < Kr - 1 ? e + 1 - Kr : right() + e - (Kr - 1); }
  __device__ int edge_index(int v) const { return v < 0 ? v + Kr - 1 : Kr - 1 + v - right(); }
};

struct EdgeArgs {
  EdgeBucket b[EDGE_MAX_BUCKETS];
  int nb;
  const int* t;
  float* out;  // [rows, N]: written, or added into (accumulate)
  int rows, N, hw, hops, warmup, accumulate;
};

__device__ __forceinline__ int first_ready_hop(const EdgeArgs& a, int row) {
  return min(max(a.warmup - a.t[row / 3], 0), a.hops);
}

// hi + lo of two values at hi[0..1] and lo[0..1].
__device__ __forceinline__ void split_store(float x0, float x1, EdgeT* hi, EdgeT* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
}

// Step 2a.  Thread (row, edge frame e, bin pair j) of bucket blockIdx.y:
// the frame's masked (re, im) of kept bin j, split into hi + lo, at values
// 2j, 2j + 1 of a; zeros for a frame outside the row's window and for j
// >= K (a select: nothing else is read).
__global__ void __launch_bounds__(GATHER_THREADS)
spectral_edge_gather_kernel(EdgeArgs a) {
  EdgeBucket e;
#pragma unroll
  for (int i = 0; i < EDGE_MAX_BUCKETS; ++i)
    if (i == (int)blockIdx.y) e = a.b[i];
  const int half = e.Kp / 2;
  const long long idx = (long long)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (idx >= (long long)a.rows * e.n_edge * half) return;
  const int j = (int)(idx % half);
  const int ei = (int)(idx / half % e.n_edge);
  const int row = (int)(idx / half / e.n_edge);
  const int v = e.frame(ei);
  const int f0 = first_ready_hop(a, row) * e.P, nc = e.Kr - 1;
  float2 val = make_float2(0.f, 0.f);
  if (j < e.K) {
    if (v >= f0) {
      EDGE_CHECK(v < e.F);
      val = e.spec[((long long)row * e.F + v) * e.K + j];
    } else if (v >= f0 - nc) {
      EDGE_CHECK(v - f0 + nc >= 0);
      val = e.carry[((long long)row * nc + v - f0 + nc) * e.K + j];
    }
  }
  EdgeT* base = static_cast<EdgeT*>(e.a);
  const long long at = ((long long)row * e.n_edge + ei) * e.Kp + 2 * j;
  split_store(val.x, val.y, base + at, base + (long long)a.rows * e.n_edge * e.Kp + at);
}

// The first edge frame v' >= v of bucket e that reaches samples [n0, n0 +
// EDGE_BN), or INT_MAX: v' in [1 - Kr, -1] or [right, F - 1], with v' H <
// n0 + EDGE_BN and v' H + B > n0.
__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((b - 1 - a) / b); }

__device__ int next_edge_frame(const EdgeBucket& e, int n0, int v) {
  const int lo = max(1 - e.Kr, floor_div(n0 - e.B, e.H) + 1);
  const int hi = min(e.F - 1, floor_div(n0 + EDGE_BN - 1, e.H));
  v = max(v, lo);
  if (v >= 0 && v < e.right()) v = e.right();
  return v <= hi ? v : INT_MAX;
}

// A stage of the product: bucket bi, edge frame v, values [32 c, 32 c + 32).
struct EdgeStep {
  int bi, v, c;
};

// From (bi, v): the first bucket and edge frame at or after it that reach
// the block's samples.
__device__ bool edge_seek(const EdgeBucket* eb, int nb, int n0, EdgeStep& st) {
  for (; st.bi < nb; ++st.bi, st.v = INT_MIN / 2) {
    st.v = next_edge_frame(eb[st.bi], n0, st.v);
    if (st.v != INT_MAX) return true;
  }
  return false;
}

__device__ bool edge_next(const EdgeBucket* eb, int nb, int n0, EdgeStep& st) {
  if (++st.c < eb[st.bi].Kp / EDGE_BK) return true;
  st.c = 0;
  ++st.v;
  return edge_seek(eb, nb, n0, st);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from src into shared dst, or zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A stage's copies into shared memory: rows m0 .. m0 + BM of a (zeros past
// the last row) and samples n0 .. n0 + BN of the weight at n - vH (zeros
// outside the frame and past the output), 32 values each, hi and lo.
__device__ __forceinline__ void edge_issue(const EdgeBucket& e, const EdgeStep& st, int m0, int n0,
                                           const EdgeArgs& a, EdgeT* stage) {
  using T = EdgeT;
  constexpr int LD = EDGE_LD;
  constexpr int CH = EDGE_BK * (int)sizeof(T) / 16;  // 16-byte pieces of a row's 32 values
  constexpr int PER = 2 * EDGE_BM * CH / EDGE_THREADS;
  const T* ab = static_cast<const T*>(e.a);
  const T* wb = static_cast<const T*>(e.w);
  const long long a_half = (long long)a.rows * e.n_edge * e.Kp, w_half = (long long)e.B * e.Kp;
  const int ei = e.edge_index(st.v);
  T* A = stage;
  T* W = stage + 2 * EDGE_BM * LD;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * EDGE_THREADS;  // (hi/lo, row, piece)
    const int q = idx % CH;
    const int r = idx / CH % EDGE_BM;
    const int h = idx / (CH * EDGE_BM);
    const int row = m0 + r;
    const bool ok = row < a.rows;
    const T* src = ab + h * a_half + ((long long)(ok ? row : 0) * e.n_edge + ei) * e.Kp + st.c * EDGE_BK + q * (16 / sizeof(T));
    cp_async16(A + (h * EDGE_BM + r) * LD + q * (16 / sizeof(T)), src, ok);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * EDGE_THREADS;  // (hi/lo, sample, piece)
    const int q = idx % CH;
    const int nn = idx / CH % EDGE_BN;
    const int h = idx / (CH * EDGE_BN);
    const int n = n0 + nn;
    const int m = n - st.v * e.H;
    const bool ok = n < a.N && m >= 0 && m < e.B;
    EDGE_CHECK(st.c * EDGE_BK + EDGE_BK <= e.Kp);
    const T* src = wb + h * w_half + (long long)(ok ? m : 0) * e.Kp + st.c * EDGE_BK + q * (16 / sizeof(T));
    cp_async16(W + (h * EDGE_BN + nn) * LD + q * (16 / sizeof(T)), src, ok);
  }
}

// Four 8 x 8 matrices of 16-bit values from shared memory (PTX ISA,
// ldmatrix): lane l gives the address of row l % 8 of matrix l / 8 and
// receives, of each, row l / 4 at values 2 (l % 4), + 1.
template <typename T>
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const T* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void edge_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's 32 rows x 64 samples of one stage: per k-step of 16 values
// lo x hi, then hi x lo, then hi x hi into the float32 sums, each pass
// over the warp's 16 tiles, so that consecutive products go to different
// sums (PTX ISA, mma.m16n8k16 fragments: A rows g, g + 8 at values 2t, +
// 8; B sample g at the same values).
__device__ __forceinline__ void edge_compute(const EdgeT* stage, float (&acc)[EDGE_MT][EDGE_NT][4]) {
  constexpr int LD = EDGE_LD;
  constexpr int KS = 16;  // values a k-step
  const EdgeT* A = stage;
  const EdgeT* W = stage + 2 * EDGE_BM * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  // ldmatrix.x4: lane l addresses row l % 8 of 8 x 8 matrix l / 8; A's
  // four are rows +0 / +8 at values +0 / +8 (a0..a3), W's the samples of
  // two 8-wide tiles at values +0 / +8 (b0, b1 of each).
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int ks = 0; ks < EDGE_BK / KS; ++ks) {
    uint32_t fa[2][EDGE_MT][4], fb[2][EDGE_NT][2];  // [hi, lo]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int mt = 0; mt < EDGE_MT; ++mt) {
        const int row = h * EDGE_BM + wm * 32 + mt * 16 + (mi & 1) * 8 + ri;
        ldmatrix4(fa[h][mt], A + row * LD + ks * KS + (mi >> 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < EDGE_NT / 2; ++np) {
        const int nn = h * EDGE_BN + wn * 64 + np * 16 + (mi >> 1) * 8 + ri;
        uint32_t r[4];
        ldmatrix4(r, W + nn * LD + ks * KS + (mi & 1) * 8);
        fb[h][2 * np][0] = r[0];
        fb[h][2 * np][1] = r[1];
        fb[h][2 * np + 1][0] = r[2];
        fb[h][2 * np + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const int ha = pass == 0 ? 1 : 0, hb = pass == 1 ? 1 : 0;  // lo x hi, hi x lo, hi x hi
#pragma unroll
      for (int nt = 0; nt < EDGE_NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < EDGE_MT; ++mt) edge_mma(acc[mt][nt], fa[ha][mt], fb[hb][nt][0], fb[hb][nt][1]);
    }
  }
}


// Step 2b.  Block (samples [n0, n0 + BN), rows [m0, m0 + BM)): the
// buckets' edge frames that reach its samples, a stage at a time through
// a ring of EDGE_STAGES copies in flight; then each sum written (or
// added) at or above its stream's first ready position, zeros below.
__global__ void __launch_bounds__(EDGE_THREADS, 2)
spectral_edge_kernel(EdgeArgs a) {
  constexpr int STAGE = EDGE_STAGE;
  extern __shared__ float4 smem[];
  EdgeT* stages = reinterpret_cast<EdgeT*>(smem);
  __shared__ EdgeBucket eb[EDGE_MAX_BUCKETS];
#pragma unroll
  for (int i = 0; i < EDGE_MAX_BUCKETS; ++i)
    if (threadIdx.x == i && i < a.nb) eb[i] = a.b[i];
  __syncthreads();
  const int n0 = blockIdx.x * EDGE_BN, m0 = blockIdx.y * EDGE_BM;
  float acc[EDGE_MT][EDGE_NT][4];
#pragma unroll
  for (int mt = 0; mt < EDGE_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < EDGE_NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
  EdgeStep ld{0, INT_MIN / 2, 0};
  bool more = edge_seek(eb, a.nb, n0, ld);
  int issued = 0;
#pragma unroll
  for (int s = 0; s < EDGE_STAGES - 1; ++s) {
    if (more) {
      edge_issue(eb[ld.bi], ld, m0, n0, a, stages + s * STAGE);
      ++issued;
      more = edge_next(eb, a.nb, n0, ld);
    }
    cp_async_commit();
  }
  for (int i = 0; i < issued; ++i) {
    cp_async_wait<EDGE_STAGES - 2>();
    __syncthreads();
    if (more) {
      edge_issue(eb[ld.bi], ld, m0, n0, a, stages + (issued % EDGE_STAGES) * STAGE);
      ++issued;
      more = edge_next(eb, a.nb, n0, ld);
    }
    cp_async_commit();
    edge_compute(stages + (i % EDGE_STAGES) * STAGE, acc);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mt = 0; mt < EDGE_MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + mt * 16 + g + 8 * h;
      if (row >= a.rows) continue;
      const int first = first_ready_hop(a, row) * a.hw;
      float* out = a.out + (long long)row * a.N;
#pragma unroll
      for (int nt = 0; nt < EDGE_NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn * 64 + nt * 8 + 2 * t + c;
          if (n >= a.N) continue;
          const float v = acc[mt][nt][2 * h + c];
          if (a.accumulate) {
            if (n >= first) out[n] += v;
          } else {
            out[n] = n >= first ? v : 0.f;
          }
        }
      }
    }
  }
}

int launch_edge_gather(const EdgeArgs& a, void* stream) {
  long long most = 0;
  for (int i = 0; i < a.nb; ++i) most = max(most, (long long)a.rows * a.b[i].n_edge * (a.b[i].Kp / 2));
  const dim3 grid((unsigned)((most + GATHER_THREADS - 1) / GATHER_THREADS), a.nb, 1);
  spectral_edge_gather_kernel<<<grid, GATHER_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_edge(const EdgeArgs& a, void* stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(spectral_edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)EDGE_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + EDGE_BN - 1) / EDGE_BN, (a.rows + EDGE_BM - 1) / EDGE_BM, 1);
  spectral_edge_kernel<<<grid, EDGE_THREADS, EDGE_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

SpectralState spectral_state(const float* carry, const float* spec, const int* t, int F, int K, int B, int H, int hw,
                             int hops, int warmup) {
  return SpectralState{reinterpret_cast<const float2*>(carry), reinterpret_cast<const float2*>(spec), t, F, K,
                       B / H, H, hw / H, warmup, hops};
}

}  // namespace

extern "C" {

// carry, carry_out: [S, 3, Kr - 1, K, 2]; spec: [S, 3, F, K, 2] with F =
// hops * hw / H; hist: [S, 2, width]; t: [S] int32; tw: the register
// core's twiddles (ops/fftplan.py::reg_twiddles(B)), B <= FFT_MAX.
int pool_spectral_forward(const float* hist, const int* t, const float* carry, float* spec, float* carry_out,
                          const float* aw, const float* gains, const float* tw, int S, int B, int H, int K, int lo,
                          int nb, int hw, int hops, int warmup, long long width, void* stream) {
  const int F = hops * (hw / H);
  const SpectralState st = spectral_state(carry, spec, t, F, K, B, H, hw, hops, warmup);
  const BucketArgs a = bucket_args(aw, nullptr, gains, tw, B, H, K, lo, nb);
  if (a.logB > REG_MAX_LOG2 || (1 << a.logB) != B) return (int)cudaErrorInvalidValue;
  const int threads = reg_block(a.logB, REG_FORWARD_THREADS), team = max(1, B / REG_R);
  const size_t smem = sizeof(float2) * (size_t)(threads / team) * (B + B / 16);
  const cudaError_t err =
      cudaFuncSetAttribute(spectral_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)S * F, per = threads / team;
  const dim3 grid((unsigned)((pairs + per - 1) / per), 1, 1);
  spectral_forward_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      hist, width, st, reinterpret_cast<float2*>(spec), reinterpret_cast<float2*>(carry_out), a, S);
  return (int)cudaGetLastError();
}

// The register core's butterfly twiddles w_16^0..3 (the head of
// ops/fftplan.py::reg_twiddles, float32 [4, 2] in host memory) into the
// current device's constant memory: once a device, before the two FFT
// kernels' first launch there.
int pool_spectral_roots(const float* w16) {
  return (int)cudaMemcpyToSymbol(reg_w16, w16, sizeof(float2) * 4);
}

// The register core through the kernels' transforms (a test): count
// transforms of B <= FFT_MAX points, x and y as spectral_reg_fft_kernel
// takes them; aw: [B] the forward's window.
int pool_spectral_reg_fft(const float* x, float* y, const float* aw, const float* tw, int B, int count, int inverse,
                          void* stream) {
  const BucketArgs a = bucket_args(nullptr, nullptr, nullptr, tw, B, 1, 0, 0, 0);
  if (a.logB > REG_MAX_LOG2 || (1 << a.logB) != B || count < 1) return (int)cudaErrorInvalidValue;
  const int threads = reg_block(a.logB, REG_FORWARD_THREADS), team = max(1, B / REG_R);
  const size_t smem = sizeof(float2) * (size_t)(threads / team) * (B + B / 16);
  const cudaError_t err =
      cudaFuncSetAttribute(spectral_reg_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per = threads / team;
  spectral_reg_fft_kernel<<<(count + per - 1) / per, threads, smem, (cudaStream_t)stream>>>(
      x, reinterpret_cast<float2*>(y), aw, reinterpret_cast<const float2*>(tw), count, inverse, a);
  return (int)cudaGetLastError();
}

// part: [S, F, groups, 2K, 2] from pool_wide_forward; the rest as
// pool_spectral_forward.
int pool_spectral_mask(const float* part, const int* t, const float* carry, float* spec, float* carry_out,
                       const float* gains, int S, int B, int H, int K, int lo, int nb, int groups, int hw, int hops,
                       int warmup, void* stream) {
  const int F = hops * (hw / H);
  const SpectralState st = spectral_state(carry, spec, t, F, K, B, H, hw, hops, warmup);
  const BucketArgs a = bucket_args(nullptr, nullptr, gains, nullptr, B, H, K, lo, nb);
  const dim3 grid((F * K + MASK_THREADS - 1) / MASK_THREADS, S, 1);
  spectral_mask_kernel<<<grid, MASK_THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(part), st, reinterpret_cast<float2*>(spec),
      reinterpret_cast<float2*>(carry_out), a, groups);
  return (int)cudaGetLastError();
}

// The edge product of nb <= EDGE_MAX_BUCKETS buckets, in two launches:
// pool_spectral_edge_gather (stage 0), then pool_spectral_edge (stage 1),
// with the same arguments.  w: their split weights [2, B, Kp]; abuf: the
// gathered operands [2, 3 S, n_edge, Kp] (both bf16);
// carry, spec: their states (as pool_spectral_forward's); geo[5 i ..] = B,
// H, K, Kp, n_edge of bucket i; out [S, 3, hops * hw] written (accumulate
// = 0) or added into.
static int edge_launch(int stage, const void* const* w, void* const* abuf, const float* const* carry,
                       const float* const* spec, const int* geo, int nb, const int* t, float* out, int S, int hw,
                       int hops, int warmup, int accumulate, void* stream) {
  if (nb < 1 || nb > EDGE_MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  EdgeArgs a{};
  for (int i = 0; i < nb; ++i) {
    const int B = geo[5 * i], H = geo[5 * i + 1], K = geo[5 * i + 2], Kp = geo[5 * i + 3], n_edge = geo[5 * i + 4];
    if (H <= 0 || B % H || hw % H || Kp % EDGE_BK || Kp < 2 * K || n_edge < 1) return (int)cudaErrorInvalidValue;
    a.b[i] = EdgeBucket{w[i], abuf[i], reinterpret_cast<const float2*>(carry[i]),
                        reinterpret_cast<const float2*>(spec[i]), B, H, K, Kp, hops * (hw / H), B / H, hw / H, n_edge};
  }
  a.nb = nb;
  a.t = t;
  a.out = out;
  a.rows = 3 * S;
  a.N = hops * hw;
  a.hw = hw;
  a.hops = hops;
  a.warmup = warmup;
  a.accumulate = accumulate;
  return stage == 0 ? launch_edge_gather(a, stream) : launch_edge(a, stream);
}

int pool_spectral_edge_gather(const void* const* w, void* const* abuf, const float* const* carry,
                              const float* const* spec, const int* geo, int nb, const int* t, float* out, int S,
                              int hw, int hops, int warmup, int accumulate, void* stream) {
  return edge_launch(0, w, abuf, carry, spec, geo, nb, t, out, S, hw, hops, warmup, accumulate, stream);
}

int pool_spectral_edge(const void* const* w, void* const* abuf, const float* const* carry, const float* const* spec,
                       const int* geo, int nb, const int* t, float* out, int S, int hw, int hops, int warmup,
                       int accumulate, void* stream) {
  return edge_launch(1, w, abuf, carry, spec, geo, nb, t, out, S, hw, hops, warmup, accumulate, stream);
}

// out: [S, 3, hops * hw], written (accumulate = 0) or added into by the
// frames [v_lo, v_hi); one block per stream; tw: reg_twiddles(B), B <=
// FFT_MAX.
int pool_spectral_inverse(const float* carry, const float* spec, const int* t, float* out, const float* sw,
                          const float* tw, int S, int B, int H, int K, int lo, int hw, int hops, int warmup,
                          int v_lo, int v_hi, int accumulate, void* stream) {
  const int F = hops * (hw / H);
  const SpectralState st = spectral_state(carry, spec, t, F, K, B, H, hw, hops, warmup);
  const SpectralSink sink{out, st, (long long)hops * hw, accumulate, v_lo};
  const BucketArgs a = bucket_args(nullptr, sw, nullptr, tw, B, H, K, lo, 0);
  if (a.logB > REG_MAX_LOG2 || (1 << a.logB) != B) return (int)cudaErrorInvalidValue;
  const int threads = reg_block(a.logB, REG_INVERSE_THREADS), team = max(1, B / REG_R);
  const size_t smem = sizeof(float2) * (size_t)(threads / team) * (B + B / 16);
  const cudaError_t err =
      cudaFuncSetAttribute(spectral_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(1, S, 1);
  spectral_inverse_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(st, sink, a, F, F, v_hi);
  return (int)cudaGetLastError();
}

// The same for a split bucket (B > FFT_MAX): fft.cuh's wide_inverse_kernel
// on the stored spectra, one hop block per stream (its frame count
// argument bounds the frames it adds: v_hi).
int pool_spectral_wide_inverse(const float* carry, const float* spec, const int* t, float* out, const float* sw,
                               const float* tw1, const float* stage2, const int* rows, const int* row_ptr,
                               const int* entries, const int* tile_ptr, int n_tiles, int kt, int S, int B, int H,
                               int K, int lo, int n1, int cols, int hw, int hops, int warmup, int v_lo, int v_hi,
                               int accumulate, void* stream) {
  const int F = hops * (hw / H);
  const SpectralState st = spectral_state(carry, spec, t, F, K, B, H, hw, hops, warmup);
  const SpectralSink sink{out, st, (long long)hops * hw, accumulate, v_lo};
  const WideArgs w{reinterpret_cast<const float2*>(tw1), reinterpret_cast<const float2*>(stage2),
                   rows, row_ptr, entries, tile_ptr, n1, cols, n_tiles, kt};
  return launch_wide_inverse_from(st, sink, bucket_args(nullptr, sw, nullptr, tw1, B, H, K, lo, 0), w, S, v_hi, F, F,
                                  stream);
}

}  // extern "C"
