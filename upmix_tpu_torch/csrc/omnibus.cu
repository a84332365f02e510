// Omnibus offline upmix for Hopper (sm_90a), one bucket per launch (two
// over 16384 points): framing -> windowed FFT -> gain x center mask summed
// over bands -> inverse FFTs with the synthesis window -> overlap-add, into
// one [S, 3, chunk + halo] output that every bucket of a config adds into.
//
// Replaces upmix_tpu/ops/pallas_omnibus.py::omnibus_lcr_batch (the TPU
// kernel of the offline main path), and upmix_tpu/ops/pallas_upmix.py::
// fused_bucket_lcr_batch (K2), which computes the same function on one
// bucket: ops/fused.py launches omni_bucket (and the split's pair) with
// accumulate = 0.  What it computes is the same; how is thought through
// again for the card:
//
//   * Work: the function's own algorithm, FP32 FFTs in shared memory
//     (fft.cuh): per frame one packed-stereo forward FFT and 1.5
//     Hermitian-packed inverse FFTs (2 when a frame's Rs goes alone).  The
//     bench config does about 6.3e9 FLOP of FFTs per 2^21-sample chunk.
//   * Bound: by operations, 6.29e9 FLOP of FFTs per chunk (0.094 ms at
//     the FP32 peak); the bytes (x read, y written) take a seventh of
//     that.  The FFT passes are bound by shared-memory traffic, a radix-4
//     butterfly reading and writing its four values once per pass, so
//     the design keeps a frame's whole path on chip: the forward FFT, the
//     mask (mask.cuh, the one statement of the mask on the card) and the
//     inverse of a frame never leave shared memory; device memory sees x
//     once and y's overlap-add.
//   * The kernels are fft.cuh's, with OmniSink as the epilogue: a thread
//     block owns T output hops of one segment (ops/omnibus.py::
//     launch_geometry picks T and the G frames a pass), the first bucket
//     of a plan zeroes its span, the others add, in the plan's fixed
//     launch order.  Buckets over 16384 points take the two-stage split,
//     two launches, its partials in `part`.
//
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include "fft.cuh"

namespace {

// Rows y [S, 3, width]: zeroed (accumulate = 0) or added into.
struct OmniSink {
  float* y;
  long long width;
  int accumulate;

  __device__ int first_frame(int) const { return 0; }

  __device__ void init(int s, long long p) const {
    if (accumulate) return;
    float* r = y + (long long)s * 3 * width + p;
    r[0] = 0.f;
    r[width] = 0.f;
    r[2 * width] = 0.f;
  }

  __device__ float* at(int s, int o, long long p) const { return y + ((long long)s * 3 + o) * width + p; }
};

}  // namespace

extern "C" {

// y: [S, 3, width]; writes (accumulate = 0) or adds into y[..., :F*H + B - H]
// from x [S, 2, width]; T hops per block, G frames a pass.
int omni_bucket(const float* x, float* y, const float* aw, const float* sw, const float* gains, const float* tw,
                int S, int B, int H, int K, int lo, int nb, int F, int T, int G, int pair, long long width,
                int accumulate, void* stream) {
  return launch_frames(x, width, OmniSink{y, width, accumulate}, bucket_args(aw, sw, gains, tw, B, H, K, lo, nb), S,
                       F, F + B / H - 1, T, G, pair, stream);
}

// part: [S, F, N2 / cols, 2K] complex from x [S, 2, width].
int omni_wide_forward(const float* x, float* part, const float* aw, const float* tw1, const float* stage2, int S,
                      int B, int H, int K, int lo, int n1, int cols, int F, long long width, void* stream) {
  const WideArgs w{reinterpret_cast<const float2*>(tw1), reinterpret_cast<const float2*>(stage2),
                   nullptr, nullptr, nullptr, nullptr, n1, cols, 0, 0};
  return launch_wide_forward(x, width, part, OmniSink{nullptr, width, 1},
                             bucket_args(aw, nullptr, nullptr, tw1, B, H, K, lo, 0), w, S, F, stream);
}

// y: [S, 3, width], written (accumulate = 0) or added into, from part.
int omni_wide_inverse(const float* part, float* y, const float* sw, const float* gains, const float* tw1,
                      const float* stage2, const int* rows, const int* row_ptr, const int* entries,
                      const int* tile_ptr, int n_tiles, int kt, int S, int B, int H, int K, int lo, int nb, int n1,
                      int cols, int F, int T, long long width, int accumulate, void* stream) {
  const WideArgs w{reinterpret_cast<const float2*>(tw1), reinterpret_cast<const float2*>(stage2),
                   rows, row_ptr, entries, tile_ptr, n1, cols, n_tiles, kt};
  return launch_wide_inverse(part, OmniSink{y, width, accumulate}, bucket_args(nullptr, sw, gains, tw1, B, H, K, lo, nb),
                             w, S, F, F + B / H - 1, T, stream);
}

}  // extern "C"
