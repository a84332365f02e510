// Fused single-bucket offline upmix for Hopper (sm_90a): framing ->
// windowed banded DFT -> gain x center mask summed over bands -> inverse
// with the synthesis window -> overlap-add, for one bucket over a batch of
// independent segments, in one launch.  x [S, 2, chunk + B - H] in,
// y [S, 3, chunk + B - H] out (main = y[..., :chunk], spill the rest).
//
// Replaces upmix_tpu/ops/pallas_upmix.py::fused_bucket_lcr_batch (the TPU
// kernel that takes the buckets the omnibus leaves over, and the sharded
// path's narrow buckets).  What it computes is the same; how is thought
// through again for the card:
//
//   * The TPU kernel walks a segment's frames in sequential tiles and
//     carries each tile's overlap-add spill to the next in VMEM.  Thread
//     blocks run in parallel and in no order, so nothing is carried: a
//     block owns T output frame positions q (samples q*H .. q*H + H - 1)
//     of one segment and computes every frame that reaches them, the T
//     frames that start there and the Kf - 1 = B/H - 1 frames that reach
//     in from the left.  Those Kf - 1 frames are recomputed by the block
//     to their left too (Kf - 1 of every T + Kf - 1 forward products), and
//     no sum crosses blocks: no atomics, the same result every run.
//   * Work: the direct banded DFT against the f32 weight slices of
//     ops/dftmm.py ([B, 2K] with the analysis window, [2K, B] with the
//     synthesis window), 10 * B * K multiply-adds per frame.  The weights
//     (at most 7 MiB per direction, the routing gate of ops/fused.py) are
//     read by every block and stay in the 50 MB L2.
//   * Bound: the function's least work is its FFTs, so by operations; the
//     kernel's own products are FP32 FMA on the SIMT cores (never TF32:
//     about three decimal digits, below the 60 dB bar), in the 64x64x16
//     shared-memory tile of tile.cuh.
//   * Nothing but x and y goes through device memory: the block's spectra
//     (3 x (T + Kf - 1) x 2K floats) live in shared memory from the forward
//     product through the mask (mask.cuh, the one statement of the mask on
//     the card) to the inverse, which folds the overlap-add into its
//     product as omnibus.cu's inverse_kernel does.  T is chosen by the
//     wrapper so that two blocks fit an SM.  With 16 warps per SM the
//     latency of a k-step's loads is not hidden by the other block alone:
//     each step's operands for the next step are loaded into registers
//     before its FMAs run.
//
// Plain C interface (ctypes); the launcher returns cudaGetLastError().

#include "mask.cuh"
#include "tile.cuh"

namespace {

// Block (blockIdx.x, s = blockIdx.y) owns output positions q in [q0, q0 + T)
// of the Fq = F + Kf - 1 positions of segment s, q0 = blockIdx.x * T, and
// holds frames f = q0 - (Kf - 1) + i, i < nF = T + Kf - 1 (zero spectra for
// frames outside [0, F)).
__global__ void __launch_bounds__(THREADS)
fused_kernel(const float* __restrict__ x, const float* __restrict__ w_fwd,
             const float* __restrict__ w_inv, const float* __restrict__ gains, float* __restrict__ y,
             int F, int H, int B, int K, int nb, int T, long long width) {
  extern __shared__ __align__(16) float spec[];  // [3][nF][2K]: L, R; then C, Ls, Rs
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int Kf = B / H;
  const int N2 = 2 * K;
  const int nF = T + Kf - 1;
  const int q0 = blockIdx.x * T;
  const int f_first = q0 - (Kf - 1);
  const long long s = blockIdx.y;
  const float* xs = x + s * 2 * width;
  const int tr = tid / (BN / TN);
  const int tc = tid % (BN / TN);
  const int a_col = tid & (BK - 1);
  const int a_row = tid / BK;  // 0..15, plus 16 * i
  const int w_col = tid & (BN - 1);
  const int w_row = tid / BN;  // 0..3, plus 4 * i

  // 1. Forward: spec[ch][i][n] = sum_k x[s, ch, f*H + k] * w_fwd[k, n],
  //    rows m = ch * nF + i (implicit framing, as omnibus.cu's forward).
  const int M1 = 2 * nF;
  for (int m0 = 0; m0 < M1; m0 += BM) {
    const float* a_ptr[4];
    bool a_ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + a_row + 16 * i;
      const int ch = m < nF ? 0 : 1;
      const int f = f_first + m - ch * nF;
      a_ok[i] = m < M1 && f >= 0 && f < F;
      a_ptr[i] = a_ok[i] ? xs + ch * width + (long long)f * H : xs;
    }
    for (int n0 = 0; n0 < N2; n0 += BN) {
      const int n = n0 + w_col;
      const bool w_ok = n < N2;
      float acc[TM][TN] = {};
      float a_next[4], w_next[4];  // the next k-step's operands, in flight during this step's FMAs
      auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + a_col;
          a_next[i] = (a_ok[i] && k < B) ? a_ptr[i][k] : 0.f;
          const int kw = k0 + w_row + 4 * i;
          w_next[i] = (w_ok && kw < B) ? w_fwd[(long long)kw * N2 + n] : 0.f;
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < B; k0 += BK) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          As[a_col][a_row + 16 * i] = a_next[i];
          Ws[w_row + 4 * i][w_col] = w_next[i];
        }
        __syncthreads();
        if (k0 + BK < B) fetch(k0 + BK);
        tile_fma(As, Ws, acc, tr, tc);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + tr * TM + i;
        if (m >= M1) break;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = n0 + tc * TN + j;
          if (c < N2) spec[m * N2 + c] = acc[i][j];
        }
      }
    }
  }
  __syncthreads();

  // 2. Mask, in place: slots 0 and 1 hold L and R and become C and Ls,
  //    slot 2 becomes Rs.  Each (frame, bin) is read and written by one
  //    thread.
  for (int idx = tid; idx < nF * K; idx += THREADS) {
    const int i = idx / K;
    const int j = idx - i * K;
    float* s0 = spec + i * N2;
    float* s1 = spec + (nF + i) * N2;
    float* s2 = spec + (2 * nF + i) * N2;
    float mo[6];
    mask_sum_bin(s0[j], s0[K + j], s1[j], s1[K + j], gains, K, nb, j, mo);
    s0[j] = mo[0];
    s0[K + j] = mo[1];
    s1[j] = mo[2];
    s1[K + j] = mo[3];
    s2[j] = mo[4];
    s2[K + j] = mo[5];
  }
  __syncthreads();

  // 3. Inverse with the overlap-add: y[s, o, q*H + r] =
  //    sum_{g < Kf} sum_{j < 2K} spec[o][q - q0 + Kf - 1 - g][j] * w_inv[j, g*H + r]
  //    over rows m = o * T + (q - q0), q < Fq.
  const int M3 = 3 * T;
  const int D = Kf * N2;
  const int Fq = F + Kf - 1;
  for (int m0 = 0; m0 < M3; m0 += BM) {
    int a_off[4];  // spec offset of row m's frame at g = 0, or -1 past the rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + a_row + 16 * i;
      const int o = m / T;
      a_off[i] = m < M3 ? (o * nF + (m - o * T) + Kf - 1) * N2 : -1;
    }
    for (int r0 = 0; r0 < H; r0 += BN) {
      const int r = r0 + w_col;
      const bool w_ok = r < H;
      float acc[TM][TN] = {};
      float a_next[4], w_next[4];
      auto fetch = [&](int k0) {
        const int kk = k0 + a_col;
        const int g = kk / N2;
        const int j = kk - g * N2;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a_next[i] = (a_off[i] >= 0 && kk < D) ? spec[a_off[i] - g * N2 + j] : 0.f;
          const int kw = k0 + w_row + 4 * i;
          const int gw = kw / N2;
          const int jw = kw - gw * N2;
          w_next[i] = (w_ok && kw < D) ? w_inv[(long long)jw * B + gw * H + r] : 0.f;
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          As[a_col][a_row + 16 * i] = a_next[i];
          Ws[w_row + 4 * i][w_col] = w_next[i];
        }
        __syncthreads();
        if (k0 + BK < D) fetch(k0 + BK);
        tile_fma(As, Ws, acc, tr, tc);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + tr * TM + i;
        if (m >= M3) break;
        const int o = m / T;
        const int q = q0 + m - o * T;
        if (q >= Fq) continue;
        float* yrow = y + (s * 3 + o) * width + (long long)q * H;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = r0 + tc * TN + j;
          if (c < H) yrow[c] = acc[i][j];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// y: [S, 3, width] from x [S, 2, width], width = F*H + B - H; w_fwd [B, 2K],
// w_inv [2K, B], gains [nb, K]; T output frame positions per block.
int fused_lcr(const float* x, const float* w_fwd, const float* w_inv, const float* gains, float* y,
              int S, int F, int H, int B, int K, int nb, int T, long long width, void* stream) {
  const int Kf = B / H;
  const size_t smem = sizeof(float) * 3 * (size_t)(T + Kf - 1) * 2 * K;
  const cudaError_t err =
      cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(F + Kf - 1, T), S, 1);
  fused_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(x, w_fwd, w_inv, gains, y, F, H, B,
                                                              K, nb, T, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
