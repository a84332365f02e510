// Fixed-cost probe for Hopper (sm_90a): the omnibus grid's structure with
// a trivial body, to measure what a launch and a thread block that must
// receive n_views [2, TILE] views of x cost.
//
// Replaces the TPU kernel of scripts/bench_overhead_probe.py (main.build,
// the pallas_call at :67).  That kernel runs a grid (1, n_tiles); step i
// gets n_views [1, 2, TILE] views of x' = x + seed at tiles i + v (the
// BlockSpec copies them into VMEM) and n_weights [128, 128] weights, and
// writes out[0, :, i*TILE:(i+1)*TILE] = row 0 of view 0 + sum_k w_k[0, 0]
// (three times) and, at the last step, the spill [1, 3, halo] from an
// accumulator that starts at 0 and is halved every step, so exactly 0.
//
// Bound: bytes.  The function reads x's row 0 once and writes out and the
// spill once: 4 * (N + 3 N + 3 halo) bytes, about 33.6 MB, 10 us at
// 3.35 TB/s.  The views are the cost being probed: every view's tile
// still lands in the shared memory of the thread block that owns the
// output tile, as the BlockSpecs put it in VMEM, so the time grows with
// n_views.
//
// Design.  One thread block per tile (128 at N = 2^21 for 132 SMs: the
// bound is HBM's, which 128 SMs saturate, each needing about 25 GB/s of
// its port).  Its views reach it in pieces of [2, PIECE] floats, one
// bulk copy per row (cp.async.bulk) issued by thread 0 into a ring of
// STAGES slots of shared memory, each slot completed by an mbarrier that
// counts its bytes; the ring stays full: a slot is refilled as soon as
// its piece has landed and been read.  The block walks its views piece
// by piece (piece 0 of every view, then piece 1, ...), so it writes its
// output all along while the later views are staged: row 0 of view 0's
// pieces plus seed and the weights' sum, three channels, with 16-byte
// streaming stores (st.global.cs).  The spill is split over every block
// (the accumulator is exactly 0, so any block may write any part); the
// weights' [0, 0] are loaded in parallel, first thing, and summed once
// per block, in order.  The sums are the plain version's (x + seed) + s in float32, so
// the output matches it bit for bit.
//
// Thread-block clusters that stage each tile once and multicast it to
// every block taking it as a view (.multicast::cluster) were built and
// timed: slower at every cluster size on the H100 (PERF.md, section 6).  L2
// serves the repeated views; the blocks' requests in flight are what
// count, and a cluster steps its blocks in lockstep.
//
// Plain C interface (ctypes); each launcher returns the CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIECE = 4096;  // floats of one row a slot holds
constexpr int STAGES = 6;    // slots of the ring
constexpr int MAX_WEIGHTS = 64;

struct Weights {
  const float* p[MAX_WEIGHTS];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// One row of a piece into a slot; the slot's mbarrier counts the bytes.
__device__ __forceinline__ void stage_row(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of `bar` with this parity to complete; a wait that
// never completes traps instead of hanging.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}

__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ x, long long xw, const float* __restrict__ seed, Weights w,
             int n_weights, int n_views, int tile, int piece, long long N, float* __restrict__ out,
             float* __restrict__ spill, int halo) {
  extern __shared__ __align__(16) float stage[];  // [STAGES][2 rows][piece], the mbarriers, the weights
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + STAGES * 2 * piece);
  float* wv = reinterpret_cast<float*>(full + STAGES);  // [MAX_WEIGHTS + 1]: each weight's [0, 0], then their sum
  const int tid = threadIdx.x, i = blockIdx.x;
  const int pieces = (tile + piece - 1) / piece;
  const int steps = n_views * pieces;  // step k: piece k / n_views of view k % n_views

  // Thread 0: piece k / n_views of view k % n_views into slot k % STAGES.
  auto issue = [&](int k) {
    const int v = k % n_views, p = k / n_views, s = k % STAGES;
    const int len = min(piece, tile - p * piece);
    const long long col = (long long)(i + v) * tile + (long long)p * piece;
    float* dst = stage + s * 2 * piece;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(smem_u32(full + s)),
                 "r"(8u * len) : "memory");
    stage_row(dst, x + col, 4u * len, full + s);
    stage_row(dst + piece, x + xw + col, 4u * len, full + s);
  };

  const float wk = tid < n_weights ? __ldg(w.p[tid]) : 0.f;  // in flight while thread 0 starts the copies
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int k = 0; k < min(steps, STAGES); ++k) issue(k);
  }
  {  // this block's share of the spill: the accumulator, 0 halved at every step
    const long long total = 3LL * halo, share = (total + gridDim.x - 1) / gridDim.x;
    const long long lo = min(total, (long long)i * share), hi = min(total, lo + share);
    const float acc = 0.f * 0.5f;
    for (long long j = lo + tid; j < hi; j += THREADS) __stcs(spill + j, acc);
  }
  if (tid < n_weights) wv[tid] = wk;
  __syncthreads();  // the mbarriers are live and the weights loaded
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < n_weights; ++k) s = __fadd_rn(s, wv[k]);
    wv[MAX_WEIGHTS] = s;
  }
  __syncthreads();
  const float sd = __ldg(seed), sw = wv[MAX_WEIGHTS];
  for (int k = 0; k < steps; ++k) {
    const int s = k % STAGES;
    wait_phase(full + s, (uint32_t)(k / STAGES) & 1u);
    if (k % n_views == 0) {  // view 0's row 0 gives the output tile, three channels
      const int p = k / n_views, len = min(piece, tile - p * piece);
      const float4* row0 = reinterpret_cast<const float4*>(stage + s * 2 * piece);
      const long long base = (long long)i * tile + (long long)p * piece;
      float4* o0 = reinterpret_cast<float4*>(out + base);
      float4* o1 = reinterpret_cast<float4*>(out + N + base);
      float4* o2 = reinterpret_cast<float4*>(out + 2 * N + base);
      for (int j = tid; j < len / 4; j += THREADS) {
        const float4 a = row0[j];
        float4 y;
        y.x = __fadd_rn(__fadd_rn(a.x, sd), sw);
        y.y = __fadd_rn(__fadd_rn(a.y, sd), sw);
        y.z = __fadd_rn(__fadd_rn(a.z, sd), sw);
        y.w = __fadd_rn(__fadd_rn(a.w, sd), sw);
        __stcs(o0 + j, y);
        __stcs(o1 + j, y);
        __stcs(o2 + j, y);
      }
    }
    __syncthreads();  // every thread is past its wait on slot s (and done reading it)
    if (tid == 0 && k + STAGES < steps) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(k + STAGES);
    }
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
  if (n_weights < 0 || n_weights > MAX_WEIGHTS || n_views < 1 || n_tiles < 1 || tile < 4 || tile % 4 || xw % 4 ||
      halo < 1)
    return (int)cudaErrorInvalidValue;
  Weights w = {};
  for (int k = 0; k < n_weights; ++k) w.p[k] = static_cast<const float*>(weights[k]);
  const int piece = tile < PIECE ? tile : PIECE;
  const int smem = (int)(sizeof(float) * STAGES * 2 * piece + sizeof(uint64_t) * STAGES +
                         sizeof(float) * (MAX_WEIGHTS + 1));
  static int smem_set = 0;  // set the attribute once per size, not on every launch
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
