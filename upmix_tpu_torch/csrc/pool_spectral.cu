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
// Design: two launches over fft.cuh's FFTs in shared memory.
//   1. spectral_forward_kernel, block (group of G frames, stream): window,
//      packed-stereo FFT and mask (fft.cuh's unpack_mask) of the new
//      frames into spec [S, 3, F, K] float2, and the new carry: its new
//      frames from the same values, its older ones copied from the carry.
//      Over FFT_MAX points the split's wide_forward_kernel (pool.cu's
//      pool_wide_forward) writes partials and spectral_mask_kernel sums
//      and masks them into spec and the carry: three launches.
//   2. spectral_inverse_kernel, one block per stream (as pool.cu's K3):
//      per G frames, carried then new, in frame order, the Hermitian-packed
//      inverse FFT of C + i Ls and of the Rs of two frames, then fft.cuh's
//      FrameOla adds each output sample's frames in frame order.  Every
//      output element is owned by one block and buckets add in a fixed
//      order, so the result is deterministic.  Over FFT_MAX points,
//      fft.cuh's wide_inverse_kernel with a SpectralState as its source.
// What it costs against K3: the carried frames' inverses are done again
// in every call (Kr - 1 of them a stream and bucket), and the new frames'
// spectra go through device memory between the launches.  The bytes of
// the carries fall from 3 B to 6 (Kr - 1) K floats a stream and bucket.
//
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include "fft.cuh"

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

// out [S, 3, hops * hw]: written (zeros first), or added into.
struct SpectralSink {
  float* out;
  SpectralState st;
  long long row;
  int accumulate;

  __device__ int first_frame(int s) const { return st.first_new(s) - (st.Kr - 1); }

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
// ready hop, copied from the carry (by the stream's first block).
__device__ void copy_old_slots(float2* carry_out, const SpectralState& st, int s) {
  const int f0 = st.first_new(s), n = st.Kr - 1;
  for (int idx = threadIdx.x; idx < 3 * n * st.K; idx += blockDim.x) {
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

// Launch 1.  Block (frame group, stream s): frames f = blockIdx.x * G + g of
// the history x [S, 2, width]; those of ready hops are windowed, packed,
// transformed and masked.
__global__ void __launch_bounds__(FFT_THREADS)
spectral_forward_kernel(const float* __restrict__ x, long long width, SpectralState st, float2* __restrict__ spec,
                        float2* __restrict__ carry_out, BucketArgs a, int G) {
  extern __shared__ float4 smem[];
  float2* buf = reinterpret_cast<float2*>(smem);  // [G * B]
  const int s = blockIdx.y;
  if (blockIdx.x == 0) copy_old_slots(carry_out, st, s);
  const int fb = blockIdx.x * G;
  const int f_lo = max(fb, st.first_new(s)), f_hi = min(fb + G, st.F);
  if (f_lo >= f_hi) return;  // the whole group is in not-ready hops: never read
  const float* xs = x + (long long)s * 2 * width;
  const int B = a.B;
  for (int idx = threadIdx.x; idx < G * B; idx += blockDim.x) {
    const int g = idx >> a.logB;
    const int n = idx & (B - 1);
    const int f = fb + g;
    float2 z = make_float2(0.f, 0.f);
    if (f >= f_lo && f < f_hi) {
      const float w = a.aw[n];
      const long long off = (long long)f * a.H + n;
      z = make_float2(w * xs[off], w * xs[width + off]);
    }
    buf[idx] = z;
  }
  __syncthreads();
  fft_forward(buf, a.logB, G, a.tw);
  for (int idx = threadIdx.x; idx < G * a.K; idx += blockDim.x) {
    const int g = idx / a.K;
    const int j = idx - g * a.K;
    const int f = fb + g;
    if (f < f_lo || f >= f_hi) continue;
    const int k = a.lo + j;
    const float2* t = buf + (g << a.logB);
    float2 m[3];
    unpack_mask(t[fft_pos(k, a.logB)], t[fft_pos((B - k) & (B - 1), a.logB)], a, j, m);
    store_frame(spec, carry_out, st, s, f, j, m);
  }
}

constexpr int MASK_THREADS = 256;

// Launch 2 of a split bucket's forward: thread (f * K + j, stream s) sums
// the partials part [S, F, groups, 2K] of kept bin j of frame f in a fixed
// order and masks them (the sums and mask of fft.cuh's PartialSpectra).
__global__ void __launch_bounds__(MASK_THREADS)
spectral_mask_kernel(const float2* __restrict__ part, SpectralState st, float2* __restrict__ spec,
                     float2* __restrict__ carry_out, BucketArgs a, int groups) {
  const int s = blockIdx.y;
  if (blockIdx.x == 0) copy_old_slots(carry_out, st, s);
  const int idx = blockIdx.x * MASK_THREADS + threadIdx.x;
  if (idx >= st.F * a.K) return;
  const int f = idx / a.K;
  const int j = idx - f * a.K;
  if (f < st.first_new(s)) return;
  float2 m[3];
  PartialSpectra{part, a, st.F, groups}.load(s, f, j, m);
  store_frame(spec, carry_out, st, s, f, j, m);
}

// The last launch.  Block (hop block, stream s) owns output hops [q0, q0 +
// T) of the n_hops = F; the frames that reach them, G at a time in frame
// order: C + i Ls in one transform a frame, the Rs of frames 2t and 2t + 1
// in transform t.
__global__ void __launch_bounds__(FFT_THREADS)
spectral_inverse_kernel(SpectralState st, SpectralSink sink, BucketArgs a, int n_hops, int T, int G) {
  extern __shared__ float4 smem[];
  float2* buf = reinterpret_cast<float2*>(smem);  // [G * B]
  const int s = blockIdx.y;
  const int B = a.B;
  const int q0 = blockIdx.x * T;
  const int q1 = min(q0 + T, n_hops);
  const long long p0 = (long long)q0 * a.H, p1 = (long long)q1 * a.H;
  for (long long p = p0 + threadIdx.x; p < p1; p += blockDim.x) sink.init(s, p);
  __syncthreads();
  const int f_begin = max(q0 - (B / a.H - 1), sink.first_frame(s));
  const int f_end = min(q1, st.F);
  const FrameOla<SpectralSink> ola{buf, sink, a, s, f_begin, f_end, max(p0, st.lowest(s)), p1};
  for (int fb = f_begin; fb < f_end; fb += G) {
    const int nf = min(G, f_end - fb);
    for (int pass = 0; pass < 2; ++pass) {
      // pass 0: C + i Ls of each frame; pass 1: the Rs of frames 2t, 2t + 1.
      const int nt = pass == 0 ? nf : (nf + 1) >> 1;
      for (int idx = threadIdx.x; idx < nt * B; idx += blockDim.x) buf[idx] = make_float2(0.f, 0.f);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nt * a.K; idx += blockDim.x) {
        const int tt = idx / a.K;
        const int j = idx - tt * a.K;
        const int k = a.lo + j;
        float2 u, v;
        if (pass == 0) {
          u = st.frame(s, 0, fb + tt)[j];
          v = st.frame(s, 1, fb + tt)[j];
        } else {
          u = st.frame(s, 2, fb + 2 * tt)[j];
          v = 2 * tt + 1 < nf ? st.frame(s, 2, fb + 2 * tt + 1)[j] : make_float2(0.f, 0.f);
        }
        put_pair(buf + (tt << a.logB), k, fft_pos(k, a.logB), fft_pos((B - k) & (B - 1), a.logB), u, v, B);
      }
      __syncthreads();
      fft_inverse(buf, a.logB, nt, a.tw);
      ola(pass == 0 ? 0 : 2, fb, nf);
    }
  }
}

SpectralState spectral_state(const float* carry, const float* spec, const int* t, int F, int K, int B, int H, int hw,
                             int hops, int warmup) {
  return SpectralState{reinterpret_cast<const float2*>(carry), reinterpret_cast<const float2*>(spec), t, F, K,
                       B / H, H, hw / H, warmup, hops};
}

}  // namespace

extern "C" {

// carry, carry_out: [S, 3, Kr - 1, K, 2]; spec: [S, 3, F, K, 2] with F =
// hops * hw / H; hist: [S, 2, width]; t: [S] int32; G frames a block.
int pool_spectral_forward(const float* hist, const int* t, const float* carry, float* spec, float* carry_out,
                          const float* aw, const float* gains, const float* tw, int S, int B, int H, int K, int lo,
                          int nb, int hw, int hops, int warmup, int G, long long width, void* stream) {
  const int F = hops * (hw / H);
  const SpectralState st = spectral_state(carry, spec, t, F, K, B, H, hw, hops, warmup);
  const BucketArgs a = bucket_args(aw, nullptr, gains, tw, B, H, K, lo, nb);
  const size_t smem = sizeof(float2) * (size_t)G * B;
  const cudaError_t err =
      cudaFuncSetAttribute(spectral_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F + G - 1) / G, S, 1);
  spectral_forward_kernel<<<grid, FFT_THREADS, smem, (cudaStream_t)stream>>>(
      hist, width, st, reinterpret_cast<float2*>(spec), reinterpret_cast<float2*>(carry_out), a, G);
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

// out: [S, 3, hops * hw], written (accumulate = 0) or added into; one
// block per stream.
int pool_spectral_inverse(const float* carry, const float* spec, const int* t, float* out, const float* sw,
                          const float* tw, int S, int B, int H, int K, int lo, int hw, int hops, int warmup, int G,
                          int accumulate, void* stream) {
  const int F = hops * (hw / H);
  const SpectralState st = spectral_state(carry, spec, t, F, K, B, H, hw, hops, warmup);
  const SpectralSink sink{out, st, (long long)hops * hw, accumulate};
  const BucketArgs a = bucket_args(nullptr, sw, nullptr, tw, B, H, K, lo, 0);
  const size_t smem = sizeof(float2) * (size_t)G * B;
  const cudaError_t err =
      cudaFuncSetAttribute(spectral_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(1, S, 1);
  spectral_inverse_kernel<<<grid, FFT_THREADS, smem, (cudaStream_t)stream>>>(st, sink, a, F, F, G);
  return (int)cudaGetLastError();
}

// The same for a split bucket (B > FFT_MAX): fft.cuh's wide_inverse_kernel
// on the stored spectra, one hop block per stream.
int pool_spectral_wide_inverse(const float* carry, const float* spec, const int* t, float* out, const float* sw,
                               const float* tw1, const float* stage2, const int* rows, const int* row_ptr,
                               const int* entries, const int* tile_ptr, int n_tiles, int kt, int S, int B, int H,
                               int K, int lo, int n1, int cols, int hw, int hops, int warmup, int accumulate,
                               void* stream) {
  const int F = hops * (hw / H);
  const SpectralState st = spectral_state(carry, spec, t, F, K, B, H, hw, hops, warmup);
  const SpectralSink sink{out, st, (long long)hops * hw, accumulate};
  const WideArgs w{reinterpret_cast<const float2*>(tw1), reinterpret_cast<const float2*>(stage2),
                   rows, row_ptr, entries, tile_ptr, n1, cols, n_tiles, kt};
  return launch_wide_inverse_from(st, sink, bucket_args(nullptr, sw, nullptr, tw1, B, H, K, lo, 0), w, S, F, F, F,
                                  stream);
}

}  // extern "C"
