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
// both channels into VMEM and writes three [G, hw] outputs from it: "copy"
// the sums and slices of bench_pool_floor.py:75-78, "frame" also the
// framed rows of every bucket (see ops/pool_floor.py).  It moves what the
// pool step must move of the history and the outputs: every history byte
// read from HBM once, the outputs written once, 184 MB at 2048 streams and
// window 8192 (55 us at 3.35 TB/s).  Bound by bytes, with nothing to
// reuse: an output element needs L and R at one column, or a bucket's row.
//
// Design.  A streaming pass over the history, no shared memory: thread
// (s, c) loads the 16-byte column c of stream s's L and R rows with
// non-caching loads that the compiler may not drop (the probe must read
// every byte, and most columns feed no output), then writes what that
// column feeds with 16-byte streaming stores: column c < hw gives out0
// (and in "frame" mode out1, out2), column c >= window - hw gives out1,
// out2 in "copy" mode.  A bucket's row with M = 1 is the thread's own L
// column; a row with M > 1 (stream s / M, frame s % M) is read with a
// 16-byte load issued with the history's: it lies in the first M*B
// samples of the first S/M streams, which L2 holds.  Small blocks, many
// loads in flight on every SM, no staging and no tail wave.  The first
// version of this kernel staged each stream's whole [2, window] history
// (64 KB) in shared memory before writing: 3 blocks an SM, loads and
// stores apart, its rows read with scalar loads (26.6% of the bound in
// "frame" mode, PERF.md).
// The same float32 sums in the same order as its plain version, so the
// output matches it bit for bit.  Unaligned geometries (a window or hw
// not a multiple of 4, a pointer off 16 bytes) run the same pass on
// single floats.
//
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include "fft.cuh"

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
constexpr int FLOOR_THREADS = 256;

struct FloorGeom {
  int n;  // buckets; 0 for the copy mode
  int B[MAX_FLOOR_BUCKETS];
  int M[MAX_FLOOR_BUCKETS];
};

// A history load that is issued even when its value feeds no output, and
// allocates no L1 line (each byte is read once).
__device__ __forceinline__ float4 load_once(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ float load_once(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

// T = float4 (V = 4 floats a column) or float (V = 1); W, hw, every B a
// multiple of V.  Thread idx: stream idx / (W / V), column idx % (W / V).
template <typename T>
__global__ void __launch_bounds__(FLOOR_THREADS)
floor_kernel(const float* __restrict__ hist, float* __restrict__ out, long long n_cols, int W, int hw,
             FloorGeom geo) {
  constexpr int V = sizeof(T) / sizeof(float);
  const long long idx = (long long)blockIdx.x * FLOOR_THREADS + threadIdx.x;
  if (idx >= n_cols) return;
  const int Wv = W / V;
  const int s = (int)(idx / Wv);
  const int n = (int)(idx - (long long)s * Wv) * V;  // first sample of the column
  const T* L = reinterpret_cast<const T*>(hist + (long long)s * 2 * W + n);
  const T l = load_once(L);
  const T r = load_once(L + Wv);
  T* o = reinterpret_cast<T*>(out + (long long)s * 3 * hw + n);
  const int hv = hw / V;
  if (geo.n == 0) {
    if (n < hw) __stcs(o, add(l, r));
    if (n >= W - hw) {
      T* tail = reinterpret_cast<T*>(out + (long long)s * 3 * hw + n - (W - hw));
      __stcs(tail + hv, l);
      __stcs(tail + 2 * hv, r);
    }
    return;
  }
  if (n >= hw) return;
  // Rows of buckets with M > 1 first, all in flight at once.
  T row[MAX_FLOOR_BUCKETS];
#pragma unroll
  for (int b = 0; b < MAX_FLOOR_BUCKETS; ++b) {
    if (b < geo.n && geo.M[b] > 1 && n < min(hw, geo.B[b])) {
      const int Mk = geo.M[b];
      // Row s of the framed matrix: frame s % M of stream s / M.
      row[b] = __ldg(reinterpret_cast<const T*>(hist + (long long)(s / Mk) * 2 * W + (s % Mk) * geo.B[b] + n));
    }
  }
  T acc = zero<T>();
#pragma unroll
  for (int b = 0; b < MAX_FLOOR_BUCKETS; ++b) {
    if (b < geo.n) {
      const T x = n < min(hw, geo.B[b]) ? (geo.M[b] > 1 ? row[b] : l) : zero<T>();
      acc = b == 0 ? x : add(acc, x);
    }
  }
  __stcs(o, acc);
  __stcs(o + hv, add(acc, l));
  __stcs(o + 2 * hv, add(acc, r));
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
int pool_floor(const float* hist, float* out, int S, int W, int hw, int n_buckets,
               const int* geom, void* stream) {
  if (n_buckets < 0 || n_buckets > MAX_FLOOR_BUCKETS || S < 1 || hw < 1 || hw > W) return (int)cudaErrorInvalidValue;
  FloorGeom geo = {};
  geo.n = n_buckets;
  bool vec = W % 4 == 0 && hw % 4 == 0 && (reinterpret_cast<unsigned long long>(hist) & 15) == 0 &&
             (reinterpret_cast<unsigned long long>(out) & 15) == 0;
  for (int b = 0; b < n_buckets; ++b) {
    geo.B[b] = geom[2 * b];
    geo.M[b] = geom[2 * b + 1];
    vec = vec && geo.B[b] % 4 == 0;
  }
  const long long n_cols = (long long)S * (vec ? W / 4 : W);
  const unsigned grid = (unsigned)((n_cols + FLOOR_THREADS - 1) / FLOOR_THREADS);
  if (vec)
    floor_kernel<float4><<<grid, FLOOR_THREADS, 0, (cudaStream_t)stream>>>(hist, out, n_cols, W, hw, geo);
  else
    floor_kernel<float><<<grid, FLOOR_THREADS, 0, (cudaStream_t)stream>>>(hist, out, n_cols, W, hw, geo);
  return (int)cudaGetLastError();
}

}  // extern "C"
