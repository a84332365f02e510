// Serving-pool step for Hopper (sm_90a): one hardware block, or `hops`
// blocks, for every stream at once, with per-stream warmup gating and the
// per-bucket overlap-add carries.  Plus the pool's floor probe.
//
// The pool step replaces the TPU kernel
// upmix_tpu/ops/pallas_pool.py::pool_step_lcr (body _build_pool_kernel).
// What it computes is the same; how is thought through again for the card:
//
//   * Per bucket (block B, hop H, P = hw/H frames per block, K kept bins)
//     and stream, F = hops * P frames of the history [S, 2, (nq-1+hops)*hw]
//     (frame f at f*H) go through fft.cuh's kernels (packed-stereo FFT,
//     mask.cuh's mask, Hermitian-packed inverse FFTs) with PoolSink as the
//     epilogue: frames_kernel, one thread block per stream, G frames a pass
//     in shared memory, up to 16384 points; the two-stage split in two
//     launches over that (a hardware block of 8192 or more samples).
//   * Bound: by bytes, 0.852 GB per block at 2048 streams for the 48 kHz /
//     2048 Bela config (history read, carries read and written, outputs
//     written: 0.254 ms at 3.35 TB/s); its FFTs are 9.02e9 FLOP (0.135 ms
//     at the FP32 peak).  So nothing but those bytes goes through device
//     memory: a frame's spectra stay in shared memory from the forward
//     FFT to the inverse, and one launch per bucket does the overlap-add,
//     the carry and the gate (a split bucket's partial spectra alone go
//     through device memory, between its two launches).
//   * A stream's output positions n (q*H + r, q < F + B/H) take
//         carry[s, o, n - i0*hw]   (when 0 <= n - i0*hw < B)
//       + sum_{frames f0 <= f < F covering n} frame_f[n - f*H]
//     where i0 = clamp(warmup - t[s], 0, hops) is the first ready hop and
//     f0 = i0 * P its first frame.  Positions n < hops*hw are the output
//     (zero below i0*hw, where nothing lands), the rest the new carry (the
//     carry as it was when no hop is ready).  Not-ready hops come first in
//     a call, since t + i grows, so this equals hop-by-hop gating with the
//     carry chained.  Frames of not-ready hops are skipped (PoolSink::
//     first_frame), never multiplied by zero, and a block's frames are its
//     own stream's, so a NaN stays in its own rows.  A block first writes
//     the carry term (or adds it to the previous bucket's output), then
//     adds its frames in order: every output element is owned by one
//     block and buckets add in a fixed order, so the result is
//     deterministic.
//
// floor_kernel replaces the probe scripts/bench_pool_floor.py
// (main.make_call), which DMAs each group's whole [G, window] history of
// both channels into VMEM and writes three [G, hw] outputs from it.  Here
// one thread block per stream stages that stream's whole [2, window]
// history in shared memory (16-byte loads, coalesced), then writes the
// outputs from it: "copy" the sums and slices of bench_pool_floor.py:75-78,
// "frame" also the framed rows of every bucket (see ops/pool_floor.py).
// So it moves what the pool step must move of the history and the
// outputs: bound by bytes, 184 MB at 2048 streams and window 8192 (55 us
// at 3.35 TB/s).  The same float32 sums in the same order as its plain
// version, so the output matches bit for bit.
//
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include "fft.cuh"
#include "tile.cuh"

namespace {

// out [S, 3, hops*hw] (written, or added into when accumulate), carries
// [S, 3, B], t [S].
struct PoolSink {
  float* out;
  const float* carry_in;
  float* carry_out;
  const int* t;
  int B, hw, hops, warmup, per_hop, accumulate;

  __device__ int ready_hop(int s) const { return min(max(warmup - t[s], 0), hops); }

  __device__ int first_frame(int s) const { return ready_hop(s) * per_hop; }

  __device__ void init(int s, long long n) const {
    const long long row = (long long)hops * hw;
    const long long cpos = n - (long long)ready_hop(s) * hw;
    for (int o = 0; o < 3; ++o) {
      const long long so = (long long)s * 3 + o;
      const float c = (cpos >= 0 && cpos < B) ? carry_in[so * B + cpos] : 0.f;
      if (n < row) {
        float* e = out + so * row + n;
        *e = accumulate ? *e + c : c;
      } else {
        carry_out[so * B + n - row] = c;
      }
    }
  }

  __device__ float* at(int s, int o, long long n) const {
    const long long so = (long long)s * 3 + o, row = (long long)hops * hw;
    return n < row ? out + so * row + n : carry_out + so * B + n - row;
  }
};

constexpr int MAX_FLOOR_BUCKETS = 8;  // ops/pool_floor.py: MAX_BUCKETS

struct FloorGeom {
  int n;  // buckets; 0 for the copy mode
  int B[MAX_FLOOR_BUCKETS];
  int M[MAX_FLOOR_BUCKETS];
};

__global__ void __launch_bounds__(THREADS)
floor_kernel(const float* __restrict__ hist, float* __restrict__ out, int W, int hw, FloorGeom geo) {
  extern __shared__ __align__(16) float row[];  // [2, W]: this stream's L then R
  const int s = blockIdx.x;
  const float* src = hist + (long long)s * 2 * W;
  if (W % 2 == 0 && (reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < W / 2; i += blockDim.x)
      reinterpret_cast<float4*>(row)[i] = reinterpret_cast<const float4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < 2 * W; i += blockDim.x) row[i] = src[i];
  }
  __syncthreads();
  const float* L = row;
  const float* R = row + W;
  float* o = out + (long long)s * 3 * hw;
  for (int n = threadIdx.x; n < hw; n += blockDim.x) {
    if (geo.n == 0) {
      o[n] = L[n] + R[n];
      o[hw + n] = L[W - hw + n];
      o[2 * hw + n] = R[W - hw + n];
      continue;
    }
    float acc = 0.f;
    for (int b = 0; b < geo.n; ++b) {
      const int Bk = geo.B[b], Mk = geo.M[b];
      // Row s of the framed matrix: frame s % M of stream s / M.
      const float x = n < min(hw, Bk) ? hist[(long long)(s / Mk) * 2 * W + (s % Mk) * Bk + n] : 0.f;
      acc = b == 0 ? x : acc + x;
    }
    o[n] = acc;
    o[hw + n] = acc + L[n];
    o[2 * hw + n] = acc + R[n];
  }
}

}  // namespace

extern "C" {

// out: [S, 3, hops*hw], written (accumulate = 0) or added into;
// carry_in, carry_out: [S, 3, B]; hist: [S, 2, width]; t: [S] int32;
// F = hops * P frames, G a pass.
int pool_bucket(const float* hist, const float* carry_in, const int* t, float* out, float* carry_out,
                const float* aw, const float* sw, const float* gains, const float* tw, int S, int B, int H, int K,
                int lo, int nb, int hw, int hops, int warmup, int G, int pair, long long width, int accumulate,
                void* stream) {
  const int F = hops * (hw / H);
  const PoolSink sink{out, carry_in, carry_out, t, B, hw, hops, warmup, hw / H, accumulate};
  return launch_frames(hist, width, sink, bucket_args(aw, sw, gains, tw, B, H, K, lo, nb), S, F, F + B / H,
                       F + B / H, G, pair, stream);
}

// The two-stage split, launch 1: part [S, F, N2 / cols, 2K] complex from
// the frames of ready hops.
int pool_wide_forward(const float* hist, const int* t, float* part, const float* aw, const float* tw1,
                      const float* stage2, int S, int B, int H, int K, int lo, int n1, int cols, int hw, int hops,
                      int warmup, long long width, void* stream) {
  const PoolSink sink{nullptr, nullptr, nullptr, t, B, hw, hops, warmup, hw / H, 1};
  const WideArgs w{reinterpret_cast<const float2*>(tw1), reinterpret_cast<const float2*>(stage2),
                   nullptr, nullptr, nullptr, nullptr, n1, cols, 0, 0};
  return launch_wide_forward(hist, width, part, sink, bucket_args(aw, nullptr, nullptr, tw1, B, H, K, lo, 0), w,
                             S, hops * (hw / H), stream);
}

// Launch 2: out and the new carries as pool_bucket writes them, from part.
int pool_wide_inverse(const float* part, const float* carry_in, const int* t, float* out, float* carry_out,
                      const float* sw, const float* gains, const float* tw1, const float* stage2, const int* rows,
                      const int* row_ptr, const int* entries, const int* tile_ptr, int n_tiles, int kt, int S, int B,
                      int H, int K, int lo, int nb, int n1, int cols, int hw, int hops, int warmup, int accumulate,
                      void* stream) {
  const int F = hops * (hw / H);
  const PoolSink sink{out, carry_in, carry_out, t, B, hw, hops, warmup, hw / H, accumulate};
  const WideArgs w{reinterpret_cast<const float2*>(tw1), reinterpret_cast<const float2*>(stage2),
                   rows, row_ptr, entries, tile_ptr, n1, cols, n_tiles, kt};
  return launch_wide_inverse(part, sink, bucket_args(nullptr, sw, gains, tw1, B, H, K, lo, nb), w, S, F, F + B / H,
                             F + B / H, stream);
}

// out: [S, 3, hw] from hist [S, 2, W]; geom: n_buckets (B, M) pairs.
// One stream's [2, W] history must fit one block's shared memory.
int pool_floor(const float* hist, float* out, int S, int W, int hw, int n_buckets,
               const int* geom, void* stream) {
  if (n_buckets < 0 || n_buckets > MAX_FLOOR_BUCKETS) return (int)cudaErrorInvalidValue;
  FloorGeom geo = {};
  geo.n = n_buckets;
  for (int b = 0; b < n_buckets; ++b) {
    geo.B[b] = geom[2 * b];
    geo.M[b] = geom[2 * b + 1];
  }
  const size_t smem = sizeof(float) * 2 * (size_t)W;
  const cudaError_t err =
      cudaFuncSetAttribute(floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  floor_kernel<<<S, THREADS, smem, (cudaStream_t)stream>>>(hist, out, W, hw, geo);
  return (int)cudaGetLastError();
}

}  // extern "C"
