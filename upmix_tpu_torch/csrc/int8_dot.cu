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
// Design: rows of x are independent through the whole chain (y = x W
// works row by row and the int8 scale is per row), so one thread block
// owns a strip of R = 32 rows and keeps it in shared memory for all CHAIN
// products: one launch per chain, no sync between blocks.  Each step the
// block splits its strip once into shared memory (the split's cost is in
// the time, as on the TPU), then each of the 8 warps computes 32 rows x
// 64 columns of every product with mma.sync (bf16 m16n8k16 into f32, s8
// m16n8k32 into s32, tf32 m16n8k8 into f32).  W is not staged: the split
// weights are at most 2 MB and live in L2 (50 MB); the host packs them in
// mma fragment order (ops/int8_dot.py::pack_fragments), so each warp
// reads its B fragments as 8-byte loads, 256 contiguous bytes a warp,
// one k-step ahead of its products.  Three-pass variants keep the running
// sum in a second register accumulator, so the f32 sums are taken in the
// script's order ((A + B) + C; phh + pcross / 254) with the _rn
// intrinsics (no FMA contraction): the int8 variants reproduce their
// plain version bit for bit, the float ones differ only in the order of
// each product's own sum.  fp32 runs on the SIMT cores from a transposed
// copy of the strip (8 broadcast float4 loads per 64 FMAs a thread).
//
// Plain C interface (ctypes); the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int K = 512;         // the script's K: W is [K, K]
constexpr int R = 32;          // rows of x per thread block
constexpr int THREADS = 256;   // 8 warps, each 64 output columns
constexpr int NT = K / 8;      // n-tiles of 8 columns
constexpr int XS = K + 4;      // f32 strip row stride (floats): conflict-free A loads
constexpr int HS = K + 8;      // bf16 row stride (elements)
constexpr int IS = K + 16;     // int8 row stride (bytes)
constexpr int TS = R + 4;      // fp32 transposed strip stride (floats)
constexpr int REGION_A = R * XS * 4;   // the f32 strip (tf32: its hi half)
constexpr int REGION_B = 2 * R * HS * 2;  // bf16 hi+lo; >= tf32 lo, int8 hi+lo
constexpr int SMEM_BYTES = REGION_A + REGION_B + R * 4;
static_assert(K * TS * 4 <= REGION_A + REGION_B, "fp32 strip fits");
static_assert(R * XS * 4 <= REGION_B && 2 * R * IS <= REGION_B, "split buffers fit");

enum Variant { FP32 = 0, BF16X1, BF16X3, TF32X3, INT8X1, INT8X3, INT8X3F, N_VARIANTS };
enum Kind { KBF16, KTF32, KINT8 };

// Constants rounded from double as the script's float32 arrays see them.
__device__ constexpr float INV127 = (float)(1.0 / 127.0);
__device__ constexpr float INV254 = (float)(1.0 / 254.0);
__device__ constexpr float FIXED_SCALE = (float)(8.0 / 127.0);
__device__ constexpr float TINY = (float)1e-30;

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  // Round to nearest, ties away from zero, to 10 mantissa bits.
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ float clip127(float v) { return fminf(fmaxf(v, -127.f), 127.f); }

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

// A fragment register r (0..3) of the 16-row tile at `row0`, k-step ks:
// rows g and g + 8, columns t*V and t*V + KT/2 (PTX ISA, mma.m16n8k*).
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

// acc += A[32 rows, K] . W[K, this warp's 64 columns], W in fragment order:
// uint2 index (ks * NT + nt) * 32 + lane.
template <int KIND, typename T>
__device__ __forceinline__ void run_pass(const unsigned char* A, const uint2* __restrict__ W,
                                         T (&acc)[2][8][4]) {
  constexpr int KT = KIND == KBF16 ? 16 : (KIND == KTF32 ? 8 : 32);
  constexpr int KS = K / KT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint2* wp = W + warp * 8 * 32 + lane;
  uint2 b[8], bn[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = __ldg(wp + j * 32);
#pragma unroll 1
  for (int ks = 0; ks < KS; ++ks) {
    if (ks + 1 < KS) {
#pragma unroll
      for (int j = 0; j < 8; ++j) bn[j] = __ldg(wp + ((ks + 1) * NT + j) * 32);
    }
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[mt][r] = load_a<KIND>(A, mt * 16 + g + 8 * (r & 1), ks, t, r >> 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j) mma<KIND>(acc[mt][j], a[mt], b[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = bn[j];
  }
}

template <typename T>
__device__ __forceinline__ void zero(T (&acc)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
}

// Accumulator element (mt, j, e) sits at row mt*16 + g + 8*(e >> 1),
// column warp*64 + j*8 + 2*t + (e & 1).
template <typename F>
__device__ __forceinline__ void for_each_acc(F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f(mt, j, e, mt * 16 + g + 8 * (e >> 1), warp * 64 + j * 8 + 2 * t + (e & 1));
}

// Row scales of int8x3: one warp per 4 rows, max |x| by shuffles.
__device__ __forceinline__ void row_scales(const float* xs, float* sa) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp * (R / 8); r < (warp + 1) * (R / 8); ++r) {
    float m = 0.f;
    for (int c = lane; c < K; c += 32) m = fmaxf(m, fabsf(xs[r * XS + c]));
#pragma unroll
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) sa[r] = fmaxf(__fmul_rn(m, INV127), TINY);
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS, 1)
mma_chain_kernel(const float* __restrict__ x_in, float* __restrict__ x_out, const uint2* __restrict__ wh,
                 const uint2* __restrict__ wl, const float* __restrict__ sw, int chain) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);                // [R][XS]
  unsigned char* buf = smem + REGION_A;                      // split copies
  float* sa = reinterpret_cast<float*>(smem + REGION_A + REGION_B);  // [R]
  constexpr int KIND = (V == BF16X1 || V == BF16X3) ? KBF16 : (V == TF32X3 ? KTF32 : KINT8);
  using Acc = typename std::conditional<KIND == KINT8, int, float>::type;
  const size_t row0 = (size_t)blockIdx.x * R;
  const int tid = threadIdx.x;

  for (int i = tid; i < R * K / 4; i += THREADS) {
    const int r = i / (K / 4), c = (i % (K / 4)) * 4;
    *reinterpret_cast<float4*>(xs + r * XS + c) =
        *reinterpret_cast<const float4*>(x_in + (row0 + r) * K + c);
  }
  if constexpr (V == INT8X1 || V == INT8X3F) {
    if (tid < R) sa[tid] = FIXED_SCALE;
  }
  __syncthreads();

  // A operands: hi at A_hi, lo at A_lo.
  const unsigned char* A_hi = buf;
  const unsigned char* A_lo = buf + (KIND == KBF16 ? R * HS * 2 : R * IS);
  if constexpr (KIND == KTF32) {
    A_hi = smem;  // the strip is split in place: hi over x, lo in buf
    A_lo = buf;
  }

  for (int step = 0; step < chain; ++step) {
    // 1. Split the strip.
    if constexpr (V == INT8X3) {
      row_scales(xs, sa);
      __syncthreads();
    }
    for (int i = tid; i < R * K; i += THREADS) {
      const int r = i / K, c = i % K;
      const float x = xs[r * XS + c];
      if constexpr (KIND == KBF16) {
        const __nv_bfloat16 h = __float2bfloat16_rn(x);
        reinterpret_cast<__nv_bfloat16*>(buf)[r * HS + c] = h;
        if constexpr (V == BF16X3)
          reinterpret_cast<__nv_bfloat16*>(buf)[R * HS + r * HS + c] =
              __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(h)));
      } else if constexpr (KIND == KTF32) {
        const float h = __uint_as_float(tf32_bits(x));
        xs[r * XS + c] = h;
        reinterpret_cast<float*>(buf)[r * XS + c] = __uint_as_float(tf32_bits(__fsub_rn(x, h)));
      } else {
        const float q = __fmul_rn(x, __fdiv_rn(1.f, sa[r]));
        const float h = clip127(rintf(q));
        buf[r * IS + c] = (unsigned char)(signed char)(int)h;
        if constexpr (V != INT8X1)
          buf[R * IS + r * IS + c] = (unsigned char)(signed char)(int)clip127(rintf(__fmul_rn(__fsub_rn(q, h), 254.f)));
      }
    }
    __syncthreads();

    // 2. Products: A = hi.Wh, then (hi.Wl, lo.Wh) for three passes.
    const uint2* Wh = wh;
    const uint2* Wl = wl;
    Acc acc[2][8][4];
    float tot[2][8][4];
    zero(acc);
    run_pass<KIND>(A_hi, Wh, acc);
    if constexpr (V == BF16X3 || V == TF32X3 || V == INT8X3 || V == INT8X3F) {
      for_each_acc([&](int mt, int j, int e, int, int) { tot[mt][j][e] = (float)acc[mt][j][e]; });
      zero(acc);
      run_pass<KIND>(A_hi, Wl, acc);
      if constexpr (KIND != KINT8) {
        for_each_acc([&](int mt, int j, int e, int, int) { tot[mt][j][e] = __fadd_rn(tot[mt][j][e], acc[mt][j][e]); });
        zero(acc);
      }
      run_pass<KIND>(A_lo, Wh, acc);  // int8: pcross = hi.Wl + lo.Wh in int32
    }
    __syncthreads();  // every warp is done reading the split strip

    // 3. Epilogue: y into the strip.
    for_each_acc([&](int mt, int j, int e, int r, int c) {
      float y;
      if constexpr (V == BF16X1) {
        y = acc[mt][j][e];
      } else if constexpr (KIND != KINT8) {
        y = __fadd_rn(tot[mt][j][e], acc[mt][j][e]);
      } else if constexpr (V == INT8X1) {
        y = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][j][e]), sa[r]), sw[c]);
      } else {
        const float s = __fadd_rn(tot[mt][j][e], __fmul_rn(__int2float_rn(acc[mt][j][e]), INV254));
        y = __fmul_rn(__fmul_rn(s, sa[r]), sw[c]);
      }
      xs[r * XS + c] = y;
    });
    __syncthreads();
  }

  for (int i = tid; i < R * K / 4; i += THREADS) {
    const int r = i / (K / 4), c = (i % (K / 4)) * 4;
    *reinterpret_cast<float4*>(x_out + (row0 + r) * K + c) = *reinterpret_cast<const float4*>(xs + r * XS + c);
  }
}

// fp32: SIMT FMAs.  Warp w, lane l owns columns 64w + l and 64w + 32 + l
// for all 32 rows; the strip is kept transposed (xt[k][r]) so the 32 rows
// of one k are 8 broadcast float4 loads.
__global__ void __launch_bounds__(THREADS, 1)
fp32_chain_kernel(const float* __restrict__ x_in, float* __restrict__ x_out, const float* __restrict__ w,
                  int chain) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xt = reinterpret_cast<float*>(smem);  // [K][TS]
  const size_t row0 = (size_t)blockIdx.x * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = warp * 64 + lane, c1 = c0 + 32;

  for (int i = tid; i < R * K; i += THREADS) xt[(i % K) * TS + i / K] = x_in[(row0 + i / K) * K + i % K];
  __syncthreads();
  for (int step = 0; step < chain; ++step) {
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
    float w0 = __ldg(w + c0), w1 = __ldg(w + c1);
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      float n0 = 0.f, n1 = 0.f;
      if (k + 1 < K) {
        n0 = __ldg(w + (k + 1) * K + c0);
        n1 = __ldg(w + (k + 1) * K + c1);
      }
      const float4* xk = reinterpret_cast<const float4*>(xt + k * TS);
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
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
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xt[c0 * TS + r] = acc[r][0];
      xt[c1 * TS + r] = acc[r][1];
    }
    __syncthreads();
  }
  for (int i = tid; i < R * K; i += THREADS) x_out[(row0 + i / K) * K + i % K] = xt[(i % K) * TS + i / K];
}

template <int V>
cudaError_t launch_mma(const float* x_in, float* x_out, const void* wh, const void* wl, const float* sw, int M,
                       int chain, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(mma_chain_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  mma_chain_kernel<V><<<M / R, THREADS, SMEM_BYTES, stream>>>(
      x_in, x_out, static_cast<const uint2*>(wh), static_cast<const uint2*>(wl), sw, chain);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_out [M, 512] = CHAIN applies of `variant` (enum Variant) to x_in [M,
// 512]; M a multiple of 32.  wh, wl: the split weights in fragment order
// (fp32: wh is W [512, 512] row-major); sw [512] the int8 column scales.
int dot_chain(const float* x_in, float* x_out, const void* wh, const void* wl, const float* sw, int M,
              int variant, int chain, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || M % R || chain < 0) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case FP32: {
      static bool ready = false;
      if (!ready) {
        const cudaError_t err =
            cudaFuncSetAttribute(fp32_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        ready = true;
      }
      fp32_chain_kernel<<<M / R, THREADS, SMEM_BYTES, s>>>(x_in, x_out, static_cast<const float*>(wh), chain);
      return (int)cudaGetLastError();
    }
    case BF16X1: return (int)launch_mma<BF16X1>(x_in, x_out, wh, wl, sw, M, chain, s);
    case BF16X3: return (int)launch_mma<BF16X3>(x_in, x_out, wh, wl, sw, M, chain, s);
    case TF32X3: return (int)launch_mma<TF32X3>(x_in, x_out, wh, wl, sw, M, chain, s);
    case INT8X1: return (int)launch_mma<INT8X1>(x_in, x_out, wh, wl, sw, M, chain, s);
    case INT8X3: return (int)launch_mma<INT8X3>(x_in, x_out, wh, wl, sw, M, chain, s);
    case INT8X3F: return (int)launch_mma<INT8X3F>(x_in, x_out, wh, wl, sw, M, chain, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
