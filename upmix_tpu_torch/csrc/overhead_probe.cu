// Fixed-cost probe for Hopper (sm_90a): the omnibus grid's structure with
// a trivial body, to measure what a launch and a thread block cost.
//
// Replaces the TPU kernel of scripts/bench_overhead_probe.py (main.build,
// the pallas_call at :67).  That kernel runs a grid (1, n_tiles); step i
// gets n_views [1, 2, TILE] views of x' = x + seed at tiles i + v (the
// BlockSpec copies them into VMEM) and n_weights [128, 128] weights, and
// writes out[0, :, i*TILE:(i+1)*TILE] = row 0 of view 0 + sum_k w_k[0, 0]
// (three times) and, at the last step, the spill [1, 3, halo] from an
// accumulator that starts at 0 and is halved every step, so exactly 0.
//
// On the card: one thread block per tile (128 at N = 2^21, one wave).
// Each view's [2, TILE] tile goes through shared memory as the BlockSpec
// moved it: in pieces of 2 x 4096 floats (four views of 16384 samples are
// 512 KB, more than a block's 227 KB), double-buffered with cp.async, and
// the block reads row 0 of view 0 from there.  cp.async is volatile, so
// nvcc keeps every view's copy although only view 0 is read.  Each block
// reads each weight's [0, 0] (served by L2) and sums them in order; the
// seed is a device scalar, added as the script's x + seed; no carry
// crosses blocks: the block of the last tile writes the spill, its
// accumulator's 0.  The sums are the plain version's (x + seed) + s in
// float32, so the output matches it bit for bit.
//
// Bound: bytes.  The function reads x's row 0 once and writes out and the
// spill once: 4 * (N + 3 N + 3 halo) bytes, about 33.6 MB, 10 us at
// 3.35 TB/s.  The staging moves n_views * 8 * N bytes besides (the cost
// being probed), mostly from L2: x is 17 MB.
//
// Plain C interface (ctypes); each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_PIECE = 4096;   // floats of one row staged at a time
constexpr int MAX_WEIGHTS = 64;

struct Weights {
  const float* p[MAX_WEIGHTS];
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ x, long long xw, const float* __restrict__ seed, Weights w,
             int n_weights, int n_views, int tile, int piece, long long N, float* __restrict__ out,
             float* __restrict__ spill, int halo) {
  extern __shared__ __align__(16) float stage[];  // [2 buffers][2 rows][piece]
  const int i = blockIdx.x, tid = threadIdx.x;
  const int pieces = tile / piece, total = n_views * pieces;
  float s = 0.f;
  for (int k = 0; k < n_weights; ++k) s = __fadd_rn(s, __ldg(w.p[k]));
  const float sd = __ldg(seed);

  auto stage_piece = [&](int idx) {
    float* dst = stage + (idx & 1) * 2 * piece;
    const long long col = (long long)(i + idx / pieces) * tile + (long long)(idx % pieces) * piece;
    const int quads = piece / 4;
    for (int q = tid; q < 2 * quads; q += THREADS) {
      const int row = q / quads, off = (q % quads) * 4;
      cp_async16(dst + row * piece + off, x + row * xw + col + off);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  stage_piece(0);
  for (int idx = 0; idx < total; ++idx) {
    if (idx + 1 < total) {
      stage_piece(idx + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (idx < pieces) {  // view 0: row 0 of this piece
      const float* row0 = stage + (idx & 1) * 2 * piece;
      const long long base = (long long)i * tile + (long long)idx * piece;
      for (int j = tid; j < piece; j += THREADS) {
        const float y = __fadd_rn(__fadd_rn(row0[j], sd), s);
        out[base + j] = y;
        out[N + base + j] = y;
        out[2 * N + base + j] = y;
      }
    }
    __syncthreads();
  }
  if (i == gridDim.x - 1) {
    const float acc = 0.f * 0.5f;  // the accumulator: 0, halved at every step
    for (int j = tid; j < 3 * halo; j += THREADS) spill[j] = acc;
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// x [1, 2, xw] (xw a multiple of 4, >= (n_tiles + n_views - 1) * tile),
// seed a device float, weights[k] device pointers (only [0, 0] is read);
// out [1, 3, n_tiles * tile], spill [1, 3, halo].
int overhead_probe(const float* x, long long xw, const float* seed, const void* const* weights, int n_weights,
                   int n_views, int n_tiles, int tile, float* out, float* spill, int halo, void* stream) {
  if (n_weights < 0 || n_weights > MAX_WEIGHTS || n_views < 1 || n_tiles < 1 || tile < 4 || tile % 4 ||
      xw % 4)
    return (int)cudaErrorInvalidValue;
  const int piece = tile < MAX_PIECE ? tile : MAX_PIECE;
  if (tile % piece) return (int)cudaErrorInvalidValue;
  Weights w = {};
  for (int k = 0; k < n_weights; ++k) w.p[k] = static_cast<const float*>(weights[k]);
  const int smem = (int)sizeof(float) * 2 * 2 * piece;
  static int smem_set = 0;  // set the attribute once, not on every launch
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  probe_kernel<<<n_tiles, THREADS, smem, (cudaStream_t)stream>>>(
      x, xw, seed, w, n_weights, n_views, tile, piece, (long long)n_tiles * tile, out, spill, halo);
  return (int)cudaGetLastError();
}

// `count` launches of an empty kernel on `blocks` blocks of the probe's
// width, from one host call: the floor of a launch without Python.
int empty_launch(int blocks, int count, void* stream) {
  for (int k = 0; k < count; ++k) empty_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
