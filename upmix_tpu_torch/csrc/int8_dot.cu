// Precision-rung probe for Hopper (sm_90a): CHAIN chained products
// x <- apply(x) with x [M, 512] float32 and W [512, 512] an orthonormal
// DCT-II, for each way of computing an f32 product on the card.
//
// Replaces the TPU kernel of scripts/bench_int8_dot.py (build, the
// pallas_call at :142), which timed bf16x3 against the int8 split rungs
// on the TPU's matrix unit.  The variants and their arithmetic are the
// script's (bench_int8_dot.py:79-126), written out in
// ops/int8_dot.py::int8_dot_chain_plain:
//
//   bf16x3   x split into bf16 hi/lo per step; xh.wh + xh.wl + xl.wh
//   bf16x1   bf16(x).wh
//   int8x3   per-row scale sa = max|x| / 127 (clamped at 1e-30), q = x *
//            (1/sa), xh = clip(rint(q)), xl = clip(rint((q - xh) * 254));
//            y = (phh + pcross / 254) * sa * sw with int32 products
//   int8x3f  int8x3 at the fixed scale 8/127 (clips |x| > 8)
//   int8x1   clip(rint(x * 127/8)).wh * sa * sw
// and two rows of the card's own:
//   fp32     x.W on the FP32 SIMT cores (what K1-K3 do today)
//   tf32x3   3xTF32 on the tensor cores: x split into tf32 hi/lo
//            (round to nearest, ties away, as cvt.rna), three products.
//
// Bound: operations.  Each apply is 1 or 3 products of 2 M K^2 FLOP at
// the unit's dense peak (bf16 989, int8 1979, TF32 495, FP32 67 TFLOP/s);
// x and the weights (<= 2 MB) are read once, so the bytes are negligible.
//
// Design.  Rows of x are independent through the whole chain (y = x W
// works row by row; the int8 scale is per row), so a strip of R = 32 rows
// never meets another strip: one launch per chain, no sync across strips.
// At the probe's M = 512 one thread block per strip would give 16 blocks
// for 132 SMs, so each strip gets a thread-block cluster of CS = 1, 2, 4
// or 8 CTAs (ops/int8_dot.py::cluster_size picks CS from M, strips x CS
// <= the SM count, and from what the card reports: W resident, clusters
// at once; CS = 1, as at M = 4224, launches plain blocks that exchange
// nothing: __syncthreads and their own shared memory).  CTA r of a
// cluster owns 512 / CS output columns for the whole chain and keeps
// every product's sum over k to itself, so the int8 rungs stay bit for
// bit and the float rungs keep their sum order.
//
//   * Each CTA holds the strip's A operands (the split of x: bf16 or
//     tf32 hi/lo, int8 hi/lo, or fp32 x transposed) for all 512 columns
//     in shared memory.  After each apply a CTA splits its own columns of
//     the new x from its registers and stores them into every peer's
//     strip through distributed shared memory (map_shared_rank), then the
//     cluster synchronises: x never goes back to HBM between applies.
//     The split's cost (once per element, in the CTA that owns it) is in
//     the time, as on the TPU.
//   * int8x3's row scale needs max|x| over the whole row: each CTA stores
//     its columns' partial maxima into every peer, and after the cluster
//     barrier each CTA takes the max of the CS partials (exact, so the
//     scale is the script's: max * (1/127), clamped at 1e-30, then a
//     reciprocal and a multiply).
//   * The CTA's W columns stay resident in shared memory for the whole
//     chain where they fit beside the strip (`mma_resident`: bf16x1 and
//     int8x3(f) at CS >= 4, bf16x3 at CS = 8, int8x1 at CS >= 2;
//     `fp32_resident`: CS = 8; never tf32x3, whose hi and lo weights take
//     2 MB), loaded once by bulk asynchronous copies (cp.async.bulk,
//     completion on an mbarrier); otherwise each
//     warp reads its fragments from L2 (<= 2 MB, 50 MB L2) one k-step
//     ahead.  The host packs W n-tile by n-tile (pack_fragments), so a
//     CTA's columns are one contiguous range at any CS.  fp32 reads W
//     row-major, so a k-step's reads by a CTA's warps are one contiguous
//     2 KB row (64-column blocks 128 KB apart cost 3% at M = 4224 on an
//     H100, PERF.md); its resident slice comes in one 256 B copy per k.
//   * Products: mma.sync (bf16 m16n8k16 into f32, s8 m16n8k32 into s32,
//     tf32 m16n8k8 into f32); 8 warps tile the strip's 32 rows x the
//     CTA's columns.  wgmma needs 64-row tiles per warpgroup; with 32-row
//     strips a CTA has half a tile, and 64-row strips in clusters of 16
//     (non-portable) would leave the chain bound by the same cluster
//     barriers and stores, so mma.sync is kept.  Three-pass variants
//     carry the running sum in the y registers, so the f32 sums are taken
//     in the script's order ((A + B) + C; phh + pcross / 254) with the _rn
//     intrinsics (no FMA contraction).  fp32 runs on the SIMT cores from
//     the transposed strip (broadcast float4 loads, one FMA chain per
//     output in k order).
//
// Plain C interface (ctypes); the launcher returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int K = 512;         // the script's K: W is [K, K]
constexpr int R = 32;          // rows of x per strip
constexpr int THREADS = 256;   // 8 warps
constexpr int NT = K / 8;      // n-tiles of 8 columns
constexpr int XS = K + 4;      // f32 row stride (floats): conflict-free A loads
constexpr int HS = K + 8;      // bf16 row stride (elements)
constexpr int IS = K + 16;     // int8 row stride (bytes)
constexpr int TS = R + 4;      // fp32 transposed strip stride (floats)
constexpr int SMEM_MAX = 232448;  // what one block may use on sm_90

enum Variant { FP32 = 0, BF16X1, BF16X3, TF32X3, INT8X1, INT8X3, INT8X3F, N_VARIANTS };
enum Kind { KBF16, KTF32, KINT8 };

// Constants rounded from double as the script's float32 arrays see them.
__device__ constexpr float INV127 = (float)(1.0 / 127.0);
__device__ constexpr float INV254 = (float)(1.0 / 254.0);
__device__ constexpr float FIXED_SCALE = (float)(8.0 / 127.0);
__device__ constexpr float TINY = (float)1e-30;

template <int V>
struct Rung {
  static constexpr int KIND = (V == BF16X1 || V == BF16X3) ? KBF16 : (V == TF32X3 ? KTF32 : KINT8);
  static constexpr int PARTS = (V == BF16X1 || V == INT8X1) ? 1 : 2;  // hi (and lo) of A and of W
  static constexpr int KT = KIND == KBF16 ? 16 : (KIND == KTF32 ? 8 : 32);  // k per mma
  static constexpr int KS = K / KT;
  static constexpr int A_PART = KIND == KBF16 ? R * HS * 2 : (KIND == KTF32 ? R * XS * 4 : R * IS);
  static constexpr int W_PART = K * K * (KIND == KBF16 ? 2 : (KIND == KTF32 ? 4 : 1));  // bytes, all columns
};

// Shared memory of mma_chain_kernel<V, CS>: A parts, the resident W
// slice, partial maxima [CS][R], the warps' row maxima [8][R], an mbarrier.
template <int V, int CS>
__host__ __device__ constexpr int mma_tail() { return (CS * R + 8 * R) * 4 + 16; }
template <int V, int CS>
__host__ __device__ constexpr bool mma_resident() {
  return Rung<V>::PARTS * (Rung<V>::A_PART + Rung<V>::W_PART / CS) + mma_tail<V, CS>() <= SMEM_MAX;
}
template <int V, int CS>
__host__ __device__ constexpr int mma_smem() {
  return Rung<V>::PARTS * (Rung<V>::A_PART + (mma_resident<V, CS>() ? Rung<V>::W_PART / CS : 0)) + mma_tail<V, CS>();
}
// fp32_chain_kernel<CS>: the transposed strip, the resident W slice
// (column block of 64, CS = 8 only), an mbarrier.
template <int CS>
__host__ __device__ constexpr bool fp32_resident() { return K * TS * 4 + K * K * 4 / CS + 16 <= SMEM_MAX; }
template <int CS>
__host__ __device__ constexpr int fp32_smem() { return K * TS * 4 + (fp32_resident<CS>() ? K * K * 4 / CS : 0) + 16; }

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  // Round to nearest, ties away from zero, to 10 mantissa bits.
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ float clip127(float v) { return fminf(fmaxf(v, -127.f), 127.f); }

// The bulk copy of a CTA's resident weights: thread 0 starts it at the
// kernel's head, every thread waits on the mbarrier before its first
// product.  A wait that never completes traps instead of hanging.
__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bulk_start(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(0u) : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}

// The cluster's barrier, this CTA's rank and a peer's copy of a shared
// address.  CS = 1 is launched as a plain block (no cluster attribute):
// __syncthreads and the CTA's own shared memory, no cluster barrier or
// distributed shared-memory stores.
template <int CS>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (CS == 1) __syncthreads();
  else cg::this_cluster().sync();
}

template <int CS>
__device__ __forceinline__ int cta_rank() {
  if constexpr (CS == 1) return 0;
  else return (int)cg::this_cluster().block_rank();
}

template <int CS, typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  if constexpr (CS == 1) return p;
  else return cg::this_cluster().map_shared_rank(p, rank);
}

template <int KIND, typename T>
__device__ __forceinline__ void mma(T (&d)[4], const uint32_t (&a)[4], uint2 b) {
  if constexpr (KIND == KBF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
  } else if constexpr (KIND == KTF32) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
  }
}

// A fragment register of the 16-row tile: row `row`, k-step ks, columns
// t*V and t*V + KT/2 (hi = 0, 1) (PTX ISA, mma.m16n8k*).
template <int KIND>
__device__ __forceinline__ uint32_t load_a(const unsigned char* A, int row, int ks, int t, int hi) {
  if constexpr (KIND == KBF16) {
    const int col = ks * 16 + 2 * t + 8 * hi;
    return *reinterpret_cast<const uint32_t*>(A + (row * HS + col) * 2);
  } else if constexpr (KIND == KTF32) {
    const int col = ks * 8 + t + 4 * hi;
    return *reinterpret_cast<const uint32_t*>(A + (row * XS + col) * 4);
  } else {
    const int col = ks * 32 + 4 * t + 16 * hi;
    return *reinterpret_cast<const uint32_t*>(A + row * IS + col);
  }
}

// The warp's tile: MT m-tiles of 16 rows from row m0, NTW n-tiles of 8
// columns from the CTA's n-tile n0; W in fragment order, n-tile major:
// uint2 index (nt * KS + ks) * 32 + lane from the CTA's first n-tile.
template <int V, int MT, int NTW, bool RES, typename T>
__device__ __forceinline__ void run_pass(const unsigned char* A, const uint2* __restrict__ W, int m0, int n0,
                                         T (&acc)[MT][NTW][4]) {
  constexpr int KIND = Rung<V>::KIND;
  constexpr int KS = Rung<V>::KS;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint2* wp = W + (size_t)n0 * KS * 32 + lane;
  auto ld = [&](int j, int ks) -> uint2 {
    const uint2* p = wp + ((size_t)j * KS + ks) * 32;
    if constexpr (RES) return *p;
    else return __ldg(p);
  };
  uint2 b[NTW], bn[NTW];
#pragma unroll
  for (int j = 0; j < NTW; ++j) b[j] = ld(j, 0);
#pragma unroll 1
  for (int ks = 0; ks < KS; ++ks) {
    if (ks + 1 < KS) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) bn[j] = ld(j, ks + 1);
    }
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[mt][r] = load_a<KIND>(A, m0 + mt * 16 + g + 8 * (r & 1), ks, t, r >> 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NTW; ++j) mma<KIND>(acc[mt][j], a[mt], b[j]);
#pragma unroll
    for (int j = 0; j < NTW; ++j) b[j] = bn[j];
  }
}

template <int V, int CS>
__global__ void __launch_bounds__(THREADS, 1)
mma_chain_kernel(const float* __restrict__ x_in, float* __restrict__ x_out, const uint2* __restrict__ wh,
                 const uint2* __restrict__ wl, const float* __restrict__ sw, int chain) {
  using Rg = Rung<V>;
  constexpr int KIND = Rg::KIND;
  constexpr int P = Rg::PARTS;
  constexpr int MT = CS == 8 ? 1 : 2;         // m-tiles per warp
  constexpr int NTW = 16 / (CS * MT);          // n-tiles per warp
  constexpr int WARPS_N = 4 * MT;              // warps across the CTA's columns (8 / (2 / MT))
  constexpr int CTA_NT = NT / CS;              // the CTA's n-tiles
  constexpr bool RES = mma_resident<V, CS>();
  constexpr int W_SLICE = RES ? Rg::W_PART / CS : 0;  // bytes of one resident part
  using Acc = typename std::conditional<KIND == KINT8, int, float>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* A = smem;                                                    // [P][R rows]
  uint2* Ws = reinterpret_cast<uint2*>(smem + P * Rg::A_PART);                // [P][CTA_NT][KS][32]
  float* pmax = reinterpret_cast<float*>(smem + P * (Rg::A_PART + W_SLICE));  // [CS][R]
  float* red = pmax + CS * R;                                                 // [WARPS_N][R]
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + 8 * R);

  const int rank = cta_rank<CS>();
  const size_t row0 = (size_t)(blockIdx.x / CS) * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = wm * MT * 16, n0 = wn * NTW;   // the warp's first row and n-tile (of the CTA's)
  const int c0 = (rank * CTA_NT + n0) * 8;      // its first column
  const size_t w_off = (size_t)rank * CTA_NT * Rg::KS * 32;  // the CTA's n-tiles in the packed W
  const uint2* Wh = RES ? Ws : wh + w_off;
  const uint2* Wl = RES ? Ws + W_SLICE / 8 : (wl ? wl + w_off : nullptr);

  if constexpr (RES) {
    if (tid == 0) {
      bulk_start(bar, P * W_SLICE);
      bulk_load(Ws, wh + w_off, W_SLICE, bar);
      if constexpr (P == 2) bulk_load(Ws + W_SLICE / 8, wl + w_off, W_SLICE, bar);
    }
  }

  // y: this thread's elements of x (element e of n-tile j, m-tile mt at
  // row m0 + mt*16 + g + 8*(e >> 1), column c0 + j*8 + 2t + (e & 1)).
  float y[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            x_in + (row0 + m0 + mt * 16 + g + 8 * h) * K + c0 + j * 8 + 2 * t);
        y[mt][j][2 * h] = v.x;
        y[mt][j][2 * h + 1] = v.y;
      }
  float sa[MT][2];  // row scales of the rows this thread holds (int8 rungs)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) sa[mt][0] = sa[mt][1] = FIXED_SCALE;

  cluster_sync<CS>();  // every CTA of the cluster runs before a peer writes its shared memory
  if constexpr (RES) bulk_wait(bar);

  for (int step = 0; step < chain; ++step) {
    // 1. int8x3: the rows' partial maxima over this CTA's columns, into
    //    every peer's pmax[rank].
    if constexpr (V == INT8X3) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = 0.f;
#pragma unroll
          for (int j = 0; j < NTW; ++j) m = fmaxf(m, fmaxf(fabsf(y[mt][j][2 * h]), fabsf(y[mt][j][2 * h + 1])));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if (t == 0) red[wn * R + m0 + mt * 16 + g + 8 * h] = m;
        }
      __syncthreads();
      if (tid < R) {
        float m = 0.f;
        for (int w = 0; w < WARPS_N; ++w) m = fmaxf(m, red[w * R + tid]);
        for (int p = 0; p < CS; ++p) *peer<CS>(pmax + rank * R + tid, p) = m;
      }
    }
    cluster_sync<CS>();  // every peer is done reading its strip; the maxima are in
    if constexpr (V == INT8X3) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = 0.f;
          for (int p = 0; p < CS; ++p) m = fmaxf(m, pmax[p * R + m0 + mt * 16 + g + 8 * h]);
          sa[mt][h] = fmaxf(__fmul_rn(m, INV127), TINY);
        }
    }

    // 2. Split this thread's elements, and store them into every peer's strip.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + mt * 16 + g + 8 * h, c = c0 + j * 8 + 2 * t;
          const float x0 = y[mt][j][2 * h], x1 = y[mt][j][2 * h + 1];
          if constexpr (KIND == KBF16) {
            const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
            const __nv_bfloat162 hv = __halves2bfloat162(h0, h1);
            const __nv_bfloat162 lv = __halves2bfloat162(__float2bfloat16_rn(__fsub_rn(x0, __bfloat162float(h0))),
                                                         __float2bfloat16_rn(__fsub_rn(x1, __bfloat162float(h1))));
            const int off = (r * HS + c) * 2;
            for (int p = 0; p < CS; ++p) {
              unsigned char* dst = peer<CS>(A, p);
              *reinterpret_cast<__nv_bfloat162*>(dst + off) = hv;
              if constexpr (P == 2) *reinterpret_cast<__nv_bfloat162*>(dst + Rg::A_PART + off) = lv;
            }
          } else if constexpr (KIND == KTF32) {
            const float h0 = __uint_as_float(tf32_bits(x0)), h1 = __uint_as_float(tf32_bits(x1));
            const float2 hv = make_float2(h0, h1);
            const float2 lv = make_float2(__uint_as_float(tf32_bits(__fsub_rn(x0, h0))),
                                          __uint_as_float(tf32_bits(__fsub_rn(x1, h1))));
            const int off = (r * XS + c) * 4;
            for (int p = 0; p < CS; ++p) {
              unsigned char* dst = peer<CS>(A, p);
              *reinterpret_cast<float2*>(dst + off) = hv;
              *reinterpret_cast<float2*>(dst + Rg::A_PART + off) = lv;
            }
          } else {
            const float inv = __fdiv_rn(1.f, sa[mt][h]);
            const float q0 = __fmul_rn(x0, inv), q1 = __fmul_rn(x1, inv);
            const float e0 = clip127(rintf(q0)), e1 = clip127(rintf(q1));
            const uint16_t hv = (uint16_t)(uint8_t)(int8_t)(int)e0 | ((uint16_t)(uint8_t)(int8_t)(int)e1 << 8);
            uint16_t lv = 0;
            if constexpr (P == 2) {
              const float l0 = clip127(rintf(__fmul_rn(__fsub_rn(q0, e0), 254.f)));
              const float l1 = clip127(rintf(__fmul_rn(__fsub_rn(q1, e1), 254.f)));
              lv = (uint16_t)(uint8_t)(int8_t)(int)l0 | ((uint16_t)(uint8_t)(int8_t)(int)l1 << 8);
            }
            const int off = r * IS + c;
            for (int p = 0; p < CS; ++p) {
              unsigned char* dst = peer<CS>(A, p);
              *reinterpret_cast<uint16_t*>(dst + off) = hv;
              if constexpr (P == 2) *reinterpret_cast<uint16_t*>(dst + Rg::A_PART + off) = lv;
            }
          }
        }
    cluster_sync<CS>();  // the strip's split is whole in every CTA

    // 3. Products: hi.Wh, then (hi.Wl, lo.Wh) for three passes; y carries
    //    the f32 running sum.
    Acc acc[MT][NTW][4];
    auto zero = [&]() {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
    };
    zero();
    run_pass<V, MT, NTW, RES>(A, Wh, m0, n0, acc);
    if constexpr (P == 2) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[mt][j][e] = (float)acc[mt][j][e];
      zero();
      run_pass<V, MT, NTW, RES>(A, Wl, m0, n0, acc);
      if constexpr (KIND != KINT8) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NTW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) y[mt][j][e] = __fadd_rn(y[mt][j][e], acc[mt][j][e]);
        zero();
      }
      run_pass<V, MT, NTW, RES>(A + Rg::A_PART, Wh, m0, n0, acc);  // int8: pcross = hi.Wl + lo.Wh in int32
    }

    // 4. Epilogue: the new x in y.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + 2 * t + (e & 1);
          const float s = sa[mt][e >> 1];
          float v;
          if constexpr (V == BF16X1) {
            v = acc[mt][j][e];
          } else if constexpr (KIND != KINT8) {
            v = __fadd_rn(y[mt][j][e], acc[mt][j][e]);
          } else if constexpr (V == INT8X1) {
            v = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][j][e]), s), sw[c]);
          } else {
            const float u = __fadd_rn(y[mt][j][e], __fmul_rn(__int2float_rn(acc[mt][j][e]), INV254));
            v = __fmul_rn(__fmul_rn(u, s), sw[c]);
          }
          y[mt][j][e] = v;
        }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(x_out + (row0 + m0 + mt * 16 + g + 8 * h) * K + c0 + j * 8 + 2 * t) =
            make_float2(y[mt][j][2 * h], y[mt][j][2 * h + 1]);
}

// fp32: SIMT FMAs.  The CTA's 512 / CS columns in groups of 64; warp w
// takes column group w % (8 / CS) and rows [rg RT, rg RT + RT), rg = w /
// (8 / CS), RT = 32 / CS; lane l owns columns 64 g + l and 64 g + 32 + l.
// The strip is kept transposed (xt[k][r]) so a k's rows are broadcast
// float4 loads; W is row-major [K][K].
template <int CS>
__global__ void __launch_bounds__(THREADS, 1)
fp32_chain_kernel(const float* __restrict__ x_in, float* __restrict__ x_out, const float* __restrict__ w,
                  int chain) {
  constexpr int GROUPS = 8 / CS;  // column groups of 64 per CTA
  constexpr int RT = R / CS;      // rows per thread
  constexpr bool RES = fp32_resident<CS>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* xt = reinterpret_cast<float*>(smem);        // [K][TS]
  float* ws = xt + K * TS;                           // [K][64] when resident
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + K * TS * 4 + (RES ? K * K * 4 / CS : 0));

  const int rank = cta_rank<CS>();
  const size_t row0 = (size_t)(blockIdx.x / CS) * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cb = rank * GROUPS + warp % GROUPS;  // the warp's column block of 64
  const int r0 = (warp / GROUPS) * RT;
  const int c0 = cb * 64 + lane, c1 = c0 + 32;
  const float* wg = RES ? ws + lane : w + c0;

  if constexpr (RES) {  // the CTA's column block (cb = rank), row by row
    if (warp == 0) {
      if (lane == 0) bulk_start(bar, K * 64 * 4);
      __syncwarp();
      for (int k = lane; k < K; k += 32) bulk_load(ws + k * 64, w + (size_t)k * K + cb * 64, 64 * 4, bar);
    }
  }
  float y[RT][2];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    y[i][0] = x_in[(row0 + r0 + i) * K + c0];
    y[i][1] = x_in[(row0 + r0 + i) * K + c1];
  }
  cluster_sync<CS>();
  if constexpr (RES) bulk_wait(bar);

  auto ld = [&](int k, int off) -> float {
    if constexpr (RES) return wg[k * 64 + off];
    else return __ldg(wg + k * K + off);
  };
  for (int step = 0; step < chain; ++step) {
    cluster_sync<CS>();  // every peer is done reading its strip
#pragma unroll
    for (int q = 0; q < RT / 4; ++q) {
      const float4 v0 = make_float4(y[4 * q][0], y[4 * q + 1][0], y[4 * q + 2][0], y[4 * q + 3][0]);
      const float4 v1 = make_float4(y[4 * q][1], y[4 * q + 1][1], y[4 * q + 2][1], y[4 * q + 3][1]);
      for (int p = 0; p < CS; ++p) {
        float* dst = peer<CS>(xt, p);
        *reinterpret_cast<float4*>(dst + c0 * TS + r0 + 4 * q) = v0;
        *reinterpret_cast<float4*>(dst + c1 * TS + r0 + 4 * q) = v1;
      }
    }
    cluster_sync<CS>();  // the strip is whole in every CTA
    float acc[RT][2];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = 0.f;
    float w0 = ld(0, 0), w1 = ld(0, 32);
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      float n0 = 0.f, n1 = 0.f;
      if (k + 1 < K) {
        n0 = ld(k + 1, 0);
        n1 = ld(k + 1, 32);
      }
      const float4* xk = reinterpret_cast<const float4*>(xt + k * TS + r0);
#pragma unroll
      for (int q = 0; q < RT / 4; ++q) {
        const float4 v = xk[q];
        acc[4 * q][0] = fmaf(v.x, w0, acc[4 * q][0]);
        acc[4 * q][1] = fmaf(v.x, w1, acc[4 * q][1]);
        acc[4 * q + 1][0] = fmaf(v.y, w0, acc[4 * q + 1][0]);
        acc[4 * q + 1][1] = fmaf(v.y, w1, acc[4 * q + 1][1]);
        acc[4 * q + 2][0] = fmaf(v.z, w0, acc[4 * q + 2][0]);
        acc[4 * q + 2][1] = fmaf(v.z, w1, acc[4 * q + 2][1]);
        acc[4 * q + 3][0] = fmaf(v.w, w0, acc[4 * q + 3][0]);
        acc[4 * q + 3][1] = fmaf(v.w, w1, acc[4 * q + 3][1]);
      }
      w0 = n0;
      w1 = n1;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      y[i][0] = acc[i][0];
      y[i][1] = acc[i][1];
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    x_out[(row0 + r0 + i) * K + c0] = y[i][0];
    x_out[(row0 + r0 + i) * K + c1] = y[i][1];
  }
}

// Launches kernel over M / R strips, a cluster of cs CTAs each, with smem
// bytes of dynamic shared memory; with `clusters` set, stores how many
// such clusters the card holds at once instead of launching.
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int M, int cs, int smem, cudaStream_t stream, int* clusters,
                           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M / R * cs, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
  cfg.numAttrs = cs > 1;  // a cluster of one launches as plain blocks (cluster_sync)
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct ChainArgs {
  const float* x_in;
  float* x_out;
  const void* wh;
  const void* wl;
  const float* sw;
  int M, chain;
  cudaStream_t stream;
  int* clusters;  // set: store the clusters the card holds at once, launch nothing
  int* resident;  // set: store whether the CTAs keep their W columns resident, launch nothing
};

template <int V, int CS>
cudaError_t launch_rung(const ChainArgs& a) {
  if (a.resident) {
    if constexpr (V == FP32) *a.resident = fp32_resident<CS>();
    else *a.resident = mma_resident<V, CS>();
    return cudaSuccess;
  }
  if constexpr (V == FP32) {
    return launch_cluster(fp32_chain_kernel<CS>, a.M, CS, fp32_smem<CS>(), a.stream, a.clusters, a.x_in, a.x_out,
                          static_cast<const float*>(a.wh), a.chain);
  } else {
    return launch_cluster(mma_chain_kernel<V, CS>, a.M, CS, mma_smem<V, CS>(), a.stream, a.clusters, a.x_in,
                          a.x_out, static_cast<const uint2*>(a.wh), static_cast<const uint2*>(a.wl), a.sw,
                          a.chain);
  }
}

template <int V>
cudaError_t launch_variant(const ChainArgs& a, int cs) {
  switch (cs) {
    case 1: return launch_rung<V, 1>(a);
    case 2: return launch_rung<V, 2>(a);
    case 4: return launch_rung<V, 4>(a);
    case 8: return launch_rung<V, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const ChainArgs& a, int variant, int cs) {
  switch (variant) {
    case FP32: return launch_variant<FP32>(a, cs);
    case BF16X1: return launch_variant<BF16X1>(a, cs);
    case BF16X3: return launch_variant<BF16X3>(a, cs);
    case TF32X3: return launch_variant<TF32X3>(a, cs);
    case INT8X1: return launch_variant<INT8X1>(a, cs);
    case INT8X3: return launch_variant<INT8X3>(a, cs);
    case INT8X3F: return launch_variant<INT8X3F>(a, cs);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x_out [M, 512] = CHAIN applies of `variant` (enum Variant) to x_in [M,
// 512]; M a multiple of 32, a cluster of `cluster` CTAs (1, 2, 4 or 8) per
// 32-row strip.  wh, wl: the split weights in fragment order, n-tile major
// (fp32: wh is W row-major, [512][512]); sw [512] the int8 column scales.
int dot_chain(const float* x_in, float* x_out, const void* wh, const void* wl, const float* sw, int M,
              int variant, int chain, int cluster, void* stream) {
  if (M <= 0 || M % R || chain < 0) return (int)cudaErrorInvalidValue;
  const ChainArgs a{x_in, x_out, wh, wl, sw, M, chain, (cudaStream_t)stream, nullptr, nullptr};
  return (int)dispatch(a, variant, cluster);
}

// How many clusters of dot_chain's kernel for (M, variant, cluster) the
// card runs at once (cudaOccupancyMaxActiveClusters), or -1 on an error.
int dot_chain_clusters(int M, int variant, int cluster) {
  int n = -1;
  const ChainArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, M, 0, nullptr, &n, nullptr};
  return dispatch(a, variant, cluster) == cudaSuccess ? n : -1;
}

// 1 when the CTAs of (variant, cluster) keep their W columns resident in
// shared memory, 0 when they read them from L2, -1 for no such kernel.
int dot_chain_resident(int variant, int cluster) {
  int r = -1;
  const ChainArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, nullptr, nullptr, &r};
  return dispatch(a, variant, cluster) == cudaSuccess ? r : -1;
}

}  // extern "C"
