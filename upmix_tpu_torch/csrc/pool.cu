// Serving-pool step for Hopper (sm_90a): one hardware block, or `hops`
// blocks, for every stream at once, with per-stream warmup gating and the
// per-bucket overlap-add carries.  Plus the pool's floor probe.
//
// pool_inverse replaces, with omnibus.cu's forward and mask kernels, the
// TPU kernel upmix_tpu/ops/pallas_pool.py::pool_step_lcr (body
// _build_pool_kernel).  What it computes is the same; how is thought
// through again for the card:
//
//   * Per bucket (block B, hop H, P = hw/H frames per block, K kept bins)
//     and stream, F = hops * P frames of the history [S, 2, (nq-1+hops)*hw]
//     go through the direct banded DFT: the forward product is
//     omnibus.cu's forward_kernel (implicit framing: frame f of row
//     (s, ch) starts at f*H, so over hops this is the omnibus step with
//     chunk = hops*hw), the mask is omnibus.cu's mask_kernel.  Work: 10 *
//     P * B * K multiply-adds per stream, bucket and block (4.67e7 for the
//     48 kHz / 2048 Bela config), 1.9e11 FLOP per block at 2048 streams.
//   * Bound: FP32 FMA throughput of the two products (2.85 ms per block
//     at 2048 streams at 67 TFLOP/s); the bytes (history 134 MB, carries
//     333 MB read and written, outputs 50 MB) take about 0.25 ms at
//     3.35 TB/s.
//     Products are FP32 FMA on the SIMT cores, never TF32.
//   * Design of pool_inverse_kernel: the inverse product, the overlap-add,
//     the carry and the gate in one launch per bucket.  Output position
//     n = q*H + r (q < F + B/H) of row (s, o) is
//         sum_{g < B/H, f = q - g, f0 <= f < F} spec[s, o, f] . w_inv[:, g*H + r]
//       + carry[s, o, n - i0*hw]   (when 0 <= n - i0*hw < B)
//     where i0 = clamp(warmup - t[s], 0, hops) is the first ready hop and
//     f0 = i0 * P its first frame.  Positions n < hops*hw are the output
//     (zero below i0*hw), the rest the new carry (the carry as it was
//     when no hop is ready).  Not-ready hops come first in a call, since
//     t + i grows, so this equals hop-by-hop gating with the carry
//     chained, and a carry loaded with t < warmup waits for the first
//     ready hop.  Frames of not-ready hops are skipped by a select, never
//     multiplied by zero, so a NaN in one stream stays in its own rows.
//     Rows run q-major (m = q * 3S + s*3 + o): a 64-row tile shares q
//     once 3S >= 64, so it sums only the frames g that exist for that q
//     (P + B/H - 1 products per row group instead of B/H per row: the
//     8192 bucket has P = 1 and B/H = 4).  Every output element is owned
//     by one thread and buckets add in a fixed order: deterministic.
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

#include "tile.cuh"

namespace {

__device__ __forceinline__ int first_ready_hop(const int* t, int s, int warmup, int hops) {
  return min(max(warmup - t[s], 0), hops);
}

__global__ void __launch_bounds__(THREADS)
pool_inverse_kernel(const float* __restrict__ spec, const float* __restrict__ w_inv,
                    const float* __restrict__ carry_in, const int* __restrict__ t,
                    float* __restrict__ out, float* __restrict__ carry_out, int S, int F, int H,
                    int B, int N2, int hw, int hops, int warmup, int accumulate) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Ws[BK][BN + 4];
  const int Kf = B / H;
  const int P = hw / H;
  const int SO = S * 3;
  const int M = (F + Kf) * SO;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Frames that exist for this tile's output positions q: f = q - g in [0, F).
  const int q_first = m0 / SO;
  const int q_last = min(m0 + BM - 1, M - 1) / SO;
  const int k_begin = max(0, q_first - (F - 1)) * N2;
  const int k_end = (min(Kf - 1, q_last) + 1) * N2;

  const int a_col = tid & (BK - 1);
  const int a_row = tid / BK;
  const float* a_base[4];
  int a_q[4], a_f0[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_row + 16 * i;
    const bool ok = m < M;
    const int so = ok ? m % SO : 0;
    a_base[i] = spec + (long long)so * F * N2;
    a_q[i] = ok ? m / SO : -F - Kf;  // out of range: every f < 0
    a_f0[i] = first_ready_hop(t, so / 3, warmup, hops) * P;
  }
  const int w_col = tid & (BN - 1);
  const int w_row = tid / BN;
  const int r = n0 + w_col;
  const bool w_ok = r < H;

  float acc[TM][TN] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    {
      const int kk = k0 + a_col;
      const int g = kk / N2;
      const int j = kk - g * N2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = a_q[i] - g;
        As[a_col][a_row + 16 * i] =
            (kk < k_end && f >= a_f0[i] && f < F) ? a_base[i][(long long)f * N2 + j] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = w_row + 4 * i;
      const int kk = k0 + kr;
      const int g = kk / N2;
      const int j = kk - g * N2;
      Ws[kr][w_col] = (w_ok && kk < k_end) ? w_inv[(long long)j * B + g * H + r] : 0.f;
    }
    __syncthreads();
    tile_fma(As, Ws, acc, tid / (BN / TN), tid % (BN / TN));
    __syncthreads();
  }

  const int out_row = hops * hw;
  const int row0 = m0 + (tid / (BN / TN)) * TM;
  const int col0 = n0 + (tid % (BN / TN)) * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = row0 + i;
    if (m >= M) break;
    const int q = m / SO;
    const int so = m % SO;
    const int i0 = first_ready_hop(t, so / 3, warmup, hops);
    const float* cin = carry_in + (long long)so * B;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int c = col0 + jj;
      if (c >= H) continue;
      const int n = q * H + c;
      const int cpos = n - i0 * hw;
      const float v = acc[i][jj] + ((cpos >= 0 && cpos < B) ? cin[cpos] : 0.f);
      if (n < out_row) {
        const float e = n >= i0 * hw ? v : 0.f;
        float* o = out + (long long)so * out_row + n;
        *o = accumulate ? *o + e : e;
      } else {
        const int jpos = n - out_row;
        carry_out[(long long)so * B + jpos] = i0 < hops ? v : cin[jpos];
      }
    }
  }
}

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
// carry_in, carry_out: [S, 3, B]; spec: [S, 3, F, N2]; t: [S] int32.
int pool_inverse(const float* spec, const float* w_inv, const float* carry_in, const int* t,
                 float* out, float* carry_out, int S, int F, int H, int B, int N2, int hw,
                 int hops, int warmup, int accumulate, void* stream) {
  const long long M = (long long)(F + B / H) * S * 3;
  const dim3 grid(cdiv(M, BM), cdiv(H, BN), 1);
  pool_inverse_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      spec, w_inv, carry_in, t, out, carry_out, S, F, H, B, N2, hw, hops, warmup, accumulate);
  return (int)cudaGetLastError();
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
