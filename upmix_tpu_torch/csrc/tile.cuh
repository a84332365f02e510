// The shared-memory tile of the FP32 SIMT products in omnibus.cu, pool.cu
// and fused.cu: 64x64 output tiles, a depth of 16 per stage, 256 threads each
// holding a 4x4 block of the sum in registers.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 16;  // depth per shared-memory stage
constexpr int THREADS = 256;
constexpr int TM = 4;  // rows per thread
constexpr int TN = 4;  // columns per thread

// acc[TM][TN] += As[k][rows of this thread] x Ws[k][columns of this thread]
__device__ __forceinline__ void tile_fma(float (*As)[BM + 4], float (*Ws)[BN + 4],
                                         float acc[TM][TN], int tr, int tc) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][tr * TM]);
    const float4 b = *reinterpret_cast<const float4*>(&Ws[k][tc * TN]);
    const float av[TM] = {a.x, a.y, a.z, a.w};
    const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace
