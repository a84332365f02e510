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
//     (frame f at f*H): packed-stereo FFT, mask.cuh's mask
//     (fft.cuh::unpack_mask), Hermitian-packed inverse FFTs of C + i Ls
//     and of the Rs of two frames, the synthesis window and the overlap-add
//     onto the carry, gated per stream (PoolSink).  Up to FFT_MAX = 16384
//     points one launch a bucket, pool_reg_kernel, on fft_reg.cuh's
//     register core; over that the two-stage split of fft.cuh in two
//     launches (pool_wide_forward, pool_wide_inverse: a hardware block of
//     8192 or more samples).
//   * Bound: by bytes, 0.852 GB per block at 2048 streams for the 48 kHz /
//     2048 Bela config (history read, carries read and written, outputs
//     written: 0.254 ms at 3.35 TB/s); its FFTs are 9.02e9 FLOP (0.135 ms
//     at the FP32 peak).  So nothing but those bytes goes through device
//     memory: a frame stays on chip from the history load to the
//     overlap-add (a split bucket's partial spectra alone go through device
//     memory, between its two launches).
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
// pool_reg_kernel<log2 B>, a kernel for each bucket size, one block a
// stream (ops/fftplan.py::reg_pool_launch: 512 threads, two blocks an SM;
// 1024 at 4096 points, whose two teams would round one frame at a time;
// one team of B / 16 threads from 8192 points): a round of nf frames at a
// time in frame order,
//   1. team t < nf: the forward transform of frame fb + t (its 16 windowed
//      samples a thread straight from the history into registers), then
//      at its kept bins the mask: C + i Ls Hermitian-packed in place over
//      the spectrum in the team's exchange buffer, Rs into the block's Rs
//      buffer (forward_mask);
//   2. team t < nf: the C + i Ls inverse from its own buffer
//      (inverse_in_place, the other positions zeros by selection); team
//      nf + i: the Rs of frames 2i and 2i + 1 from the Rs buffer
//      (fft_reg.cuh's inverse_frame); nf + ceil(nf / 2) transforms
//      on the block's teams;
//   3. the round's frames added at each output position in frame order,
//      the three outputs in one pass (pool_ola), onto what an earlier
//      round wrote there or else onto the position's init (PoolRow), so
//      that a position is read and written once a round; a separate pass
//      inits only the positions no frame reaches.
// With one team (8192 and 16384 points) a round is one frame: its C + i Ls, then,
// every second frame and after the last, the Rs of the two (`pair`, where
// the two Rs spectra fit in shared memory; else each alone).  The masked
// spectra never leave shared memory.  At 64 registers a thread the
// kernel holds little besides the transform: the launch's arguments and
// the block's stream wait in shared memory (PoolArgs), each size is a
// kernel of its own (not a switch inside one, whose sizes would share
// one allocation), and the transforms are inline where a block holds
// several teams, calls with one team (pool_forward, pool_inverse; PR 24's
// finding on K3s).  All FP32.

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
#include "fft_reg.cuh"

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

// One stream's outputs in the register path: out [3, row] and the new
// carry [3, B] at positions p < row and p >= row, and what PoolSink::init
// starts position p of output o with (the carry term at p - c0, c0 = i0
// hw, added to the previous bucket's output when accumulating).
struct PoolRow {
  float* out;
  float* carry;
  const float* carry_in;
  long long row;
  int B, c0, accumulate;

  __device__ float* at(int o, long long p) const { return p < row ? out + o * row + p : carry + o * B + (p - row); }

  __device__ float init(int o, long long p) const {
    const long long cpos = p - c0;
    const float c = (cpos >= 0 && cpos < B) ? carry_in[o * B + cpos] : 0.f;
    return accumulate && p < row ? out[o * row + p] + c : c;
  }
};

// The launch's arguments and the block's stream, written to shared memory
// once a block, so that the steps below read them there and the kernel
// keeps nothing live across them but its frame counters: a thread's 64
// registers go to the transforms, not to holding the caller's state.
struct PoolArgs {
  BucketArgs a;
  const float* xs;  // the block's history: L, and R at + width
  long long width, n_pos, reach_lo, reach_hi;  // the frames reach [reach_lo, reach_hi) of [0, n_pos)
  PoolRow r;
  int F, round, pair, f_begin;
};

__shared__ PoolArgs pool_args;

// The init of the positions [first, last) that no frame reaches, all
// three outputs.
__device__ __forceinline__ void pool_init(long long first, long long last) {
  const PoolRow& r = pool_args.r;
  for (long long p = first + threadIdx.x; p < last; p += blockDim.x) {
    float v[3];
#pragma unroll
    for (int o = 0; o < 3; ++o) v[o] = r.init(o, p);
#pragma unroll
    for (int o = 0; o < 3; ++o) *r.at(o, p) = v[o];
  }
}

// fft_reg.cuh's loaders for K3: inline while a block holds several teams
// (5-10% faster on the card than calls, though the kernel then spills a
// few hundred bytes), calls with one team of 512 or 1024 threads (8192
// and 16384 points), where inline transforms ran at half the speed.
template <int LOG2N>
__device__ __forceinline__ void pool_forward(const float* __restrict__ xs, long long width, const float* __restrict__ aw,
                                             const float2* __restrict__ tw) {
  if constexpr (RegGeo<LOG2N>::T >= 512) {
    forward_transform<LOG2N>(xs, width, aw, tw);
  } else {
    forward_frame<LOG2N>(xs, width, aw, tw);
  }
}

template <int LOG2N>
__device__ __forceinline__ void pool_inverse(const float2* u, const float2* v, int lo, int K,
                                             const float2* __restrict__ tw) {
  if constexpr (RegGeo<LOG2N>::T >= 512) {
    inverse_transform<LOG2N>(u, v, lo, K, tw);
  } else {
    inverse_frame<LOG2N>(u, v, lo, K, tw);
  }
}

// Step 1 for the team's frame f: the forward transform from the history,
// the team's barrier, then at each kept bin k of its spectrum z (natural
// order in its exchange buffer) the mask: C + i Ls written back
// Hermitian-packed, W[k] and W[B - k] (only the real parts at DC and
// Nyquist, as irfft reads them), and Rs into rs[k - lo].  A kept bin and
// its mirror are read and written by one thread, and kept bins lie in [0,
// B / 2], so the pairs are distinct and the mask runs in place.
template <int LOG2N>
__device__ __forceinline__ void forward_mask(int f, float2* __restrict__ rs) {
  using G = RegGeo<LOG2N>;
  extern __shared__ float4 smem[];
  const int team = threadIdx.x / G::T, j = threadIdx.x % G::T;
  const BucketArgs& a = pool_args.a;
  pool_forward<LOG2N>(pool_args.xs + (long long)f * a.H, pool_args.width, a.aw, a.tw);
  reg_sync<G::T>(team);
  float2* z = reinterpret_cast<float2*>(smem) + team * G::PADDED;
  for (int jj = j; jj < a.K; jj += G::T) {
    const int k = a.lo + jj, km = (G::N - k) & (G::N - 1);
    float2 m[3];
    unpack_mask(z[k], z[km], a, jj, m);
    put_pair(z, k, k, km, m[0], m[1], G::N);
    rs[jj] = m[2];
  }
}

// Step 2's C + i Ls inverse: thread j of team `team` takes positions j +
// slot T of its buffer as forward_mask left them, the kept bins and their
// mirrors, zeros elsewhere by selection, and reg_fft's inverse leaves the
// samples in natural order in the same buffer.
template <int LOG2N>
__device__ __forceinline__ void inverse_in_place(int lo, int K, const float2* __restrict__ tw) {
  using G = RegGeo<LOG2N>;
  extern __shared__ float4 smem[];
  const int team = threadIdx.x / G::T, j = threadIdx.x % G::T;
  float2* z = reinterpret_cast<float2*>(smem) + team * G::PADDED;
  float2 x[G::R];
#pragma unroll
  for (int slot = 0; slot < G::R; ++slot) {
    const int k = j + slot * G::T, km = G::N - k;
    const bool kept = (unsigned)(k - lo) < (unsigned)K;
    const bool mirror = !kept && 2 * k > G::N && (unsigned)(km - lo) < (unsigned)K;
    const float2 w = z[k];
    x[slot] = kept || mirror ? w : make_float2(0.f, 0.f);
  }
  reg_sync<G::T>(team);  // every thread has read the buffer: the transform may write it
  reg_fft<LOG2N, true>(x, j, team, z, tw);
}

// Step 3: the overlap-add of a round's frames fb .. fb + nf - 1 (frame v
// at v H) into positions [first, last) of the block's stream (PoolRow):
// with CL, C and Ls from the C + i Ls transforms at cls (frame g's at g *
// PADDED), with RR, Rs from the Rs transforms at rs (frames 2t and 2t + 1
// in transform t).  At each position each output's sum over the frames
// in frame order of sample p - vH, synthesis-windowed and scaled by 1/B,
// is added to what an earlier round wrote there, or, from `fresh` on,
// where no earlier round reached, to the position's init: so a position
// is read and written once a round, and init's own pass takes only the
// positions that no frame reaches.  A position a thread: the outputs'
// reads go first, then the sums from shared memory while they fly (four
// positions a thread held the reads of four in flight, and spilled and
// ran slower on the card); one instantiation for each pair (CL, RR) the
// kernel takes.
template <int LOG2N, bool CL, bool RR>
__device__ __forceinline__ void pool_ola(long long first, long long last, long long fresh, const float2* cls,
                                         const float2* rs, int fb, int nf) {
  constexpr int N = RegGeo<LOG2N>::N, PADDED = RegGeo<LOG2N>::PADDED;
  constexpr int O0 = CL ? 0 : 2, O1 = RR ? 3 : 2;  // the outputs added: [O0, O1)
  const PoolRow& r = pool_args.r;
  const int H = pool_args.a.H, Kf = N / H;
  const float* __restrict__ sw = pool_args.a.sw;
  const float inv = 1.0f / (float)N;
  for (long long p = first + threadIdx.x; p < last; p += blockDim.x) {
    float old[3], sum[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int o = O0; o < O1; ++o) old[o] = p >= fresh ? r.init(o, p) : *r.at(o, p);
    const int d = (int)(p - (long long)fb * H);  // p - fb H
    const int qq = d / H, rem = d - qq * H;
    for (int g = max(0, qq - Kf + 1); g <= min(nf - 1, qq); ++g) {
      const int n = (qq - g) * H + rem;
      const float w = sw[n] * inv;
      if (CL) {
        const float2 v = cls[g * PADDED + n];
        sum[0] += v.x * w;
        sum[1] += v.y * w;
      }
      if (RR) {
        const float2 v = rs[(g >> 1) * PADDED + n];
        sum[2] += ((g & 1) ? v.y : v.x) * w;
      }
    }
#pragma unroll
    for (int o = O0; o < O1; ++o) *r.at(o, p) = old[o] + sum[o];
  }
}

// The block's stream on 2^LOG2N points, from pool_args: the positions no
// frame reaches through init, then its frames from the first ready one, a
// round at a time (steps 1-3 above).  rs: the block's Rs buffer after the
// teams' exchange buffers, `round` frames' K values, or with one team two
// (pair) or one.
template <int LOG2N>
__device__ __forceinline__ void pool_frames() {
  using G = RegGeo<LOG2N>;
  extern __shared__ float4 smem[];
  float2* buf = reinterpret_cast<float2*>(smem);  // [teams][PADDED]
  const int teams = blockDim.x / G::T, team = threadIdx.x / G::T;
  float2* rs = buf + teams * G::PADDED;
  const int F = pool_args.F, f_begin = pool_args.f_begin, H = pool_args.a.H;
  pool_init(0, pool_args.reach_lo);
  pool_init(pool_args.reach_hi, pool_args.n_pos);
  if (teams > 1) {
    const int round = pool_args.round;
    for (int fb = f_begin; fb < F; fb += round) {
      const int nf = min(round, F - fb), nt = nf + (nf + 1) / 2;
      if (team < nf) forward_mask<LOG2N>(fb + team, rs + team * pool_args.a.K);
      __syncthreads();  // every frame's Rs in the buffer
      if (team < nf) {
        inverse_in_place<LOG2N>(pool_args.a.lo, pool_args.a.K, pool_args.a.tw);
      } else if (team < nt) {
        const int i = team - nf, K = pool_args.a.K;
        pool_inverse<LOG2N>(rs + 2 * i * K, 2 * i + 1 < nf ? rs + (2 * i + 1) * K : nullptr, pool_args.a.lo, K,
                                 pool_args.a.tw);
      }
      __syncthreads();
      pool_ola<LOG2N, true, true>((long long)fb * H, (long long)(fb + nf - 1) * H + G::N,
                                  fb == f_begin ? pool_args.reach_lo : (long long)(fb - 1) * H + G::N, buf,
                                  buf + nf * G::PADDED, fb, nf);
      __syncthreads();  // the round is added: its buffers may be written, its positions read
    }
    return;
  }
  const int pair = pool_args.pair;
  for (int f = f_begin; f < F; ++f) {
    const int slot = pair ? (f - f_begin) & 1 : 0;
    forward_mask<LOG2N>(f, rs + slot * pool_args.a.K);
    __syncthreads();
    inverse_in_place<LOG2N>(pool_args.a.lo, pool_args.a.K, pool_args.a.tw);
    __syncthreads();
    pool_ola<LOG2N, true, false>((long long)f * H, (long long)f * H + G::N,
                                 f == f_begin ? pool_args.reach_lo : (long long)(f - 1) * H + G::N, buf, buf, f, 1);
    __syncthreads();
    if (!pair || slot == 1 || f + 1 == F) {
      const int fa = f - slot;  // the transform's first frame; Rs reached (fa - 1) H + B before it
      pool_inverse<LOG2N>(rs, slot == 1 ? rs + pool_args.a.K : nullptr, pool_args.a.lo, pool_args.a.K,
                               pool_args.a.tw);
      __syncthreads();
      pool_ola<LOG2N, false, true>((long long)fa * H, (long long)f * H + G::N,
                                   fa == f_begin ? pool_args.reach_lo : (long long)(fa - 1) * H + G::N, buf, buf,
                                   fa, slot + 1);
      __syncthreads();
    }
  }
}

// K3 up to FFT_MAX points on 2^LOG2N: out [S, 3, hops * hw] and carry_out
// [S, 3, B] (PoolSink) from the history x [S, 2, width]; one block a
// stream, thread 0 writing its PoolArgs.
template <int LOG2N>
__global__ void __launch_bounds__(1024)
pool_reg_kernel(PoolSink sink, const float* __restrict__ x, long long width, BucketArgs a, int F, int round,
                int pair) {
  if (threadIdx.x == 0) {
    const int s = blockIdx.x, f_begin = sink.first_frame(s);
    const long long row = (long long)sink.hops * sink.hw, n_pos = (long long)F * a.H + a.B;
    const bool any = f_begin < F;
    pool_args = PoolArgs{a, x + (long long)s * 2 * width, width, n_pos, any ? (long long)f_begin * a.H : n_pos,
                         any ? (long long)(F - 1) * a.H + a.B : n_pos,
                         PoolRow{sink.out + (long long)s * 3 * row, sink.carry_out + (long long)s * 3 * a.B,
                                 sink.carry_in + (long long)s * 3 * a.B, row, a.B, sink.ready_hop(s) * sink.hw,
                                 sink.accumulate},
                         F, round, pair, f_begin};
  }
  __syncthreads();
  pool_frames<LOG2N>();
}

// The launch of the bucket's size's kernel.
template <int LOG2N>
cudaError_t pool_reg_launch(const PoolSink& sink, const float* x, long long width, const BucketArgs& a, int F, int round,
                            int pair, int S, int threads, size_t smem, void* stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(pool_reg_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pool_reg_kernel<LOG2N><<<S, threads, smem, (cudaStream_t)stream>>>(sink, x, width, a, F, round, pair);
  return cudaGetLastError();
}

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
// carry_in, carry_out: [S, 3, B]; hist: [S, 2, width]; t: [S] int32; tw:
// the register core's twiddles (ops/fftplan.py::reg_twiddles(B)), B <=
// FFT_MAX; threads, round, pair: ops/fftplan.py::reg_pool_launch.
int pool_reg_bucket(const float* hist, const float* carry_in, const int* t, float* out, float* carry_out,
                    const float* aw, const float* sw, const float* gains, const float* tw, int S, int B, int H,
                    int K, int lo, int nb, int hw, int hops, int warmup, int threads, int round, int pair,
                    long long width, int accumulate, void* stream) {
  const BucketArgs a = bucket_args(aw, sw, gains, tw, B, H, K, lo, nb);
  const int team = max(1, B / REG_R), teams = threads / team;
  if (a.logB > REG_MAX_LOG2 || (1 << a.logB) != B || threads > 1024 || teams < 1 || threads % team || round < 1 ||
      (team >= 64 && teams > 15) || (teams > 1 && round + (round + 1) / 2 > teams) || (teams == 1 && round != 1))
    return (int)cudaErrorInvalidValue;
  const int n_rs = teams > 1 ? round : pair ? 2 : 1;
  const size_t smem = sizeof(float2) * ((size_t)teams * (B + B / 16) + (size_t)n_rs * K);
  const PoolSink sink{out, carry_in, carry_out, t, B, hw, hops, warmup, hw / H, accumulate};
  cudaError_t err = cudaErrorInvalidValue;
#define POOL_REG(L) \
  err = pool_reg_launch<L>(sink, hist, width, a, hops * (hw / H), round, teams == 1 && pair, S, threads, smem, stream)
  REG_CASES(POOL_REG)
#undef POOL_REG
  return (int)err;
}

// The register core's butterfly twiddles w_16^0..3 (the head of
// ops/fftplan.py::reg_twiddles, float32 [4, 2] in host memory) into this
// source's constant memory on the current device: once a device, before
// pool_reg_kernel's first launch there.
int pool_reg_roots(const float* w16) { return (int)cudaMemcpyToSymbol(reg_w16, w16, sizeof(float2) * 4); }

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

// Launch 2: out and the new carries as pool_reg_bucket writes them, from part.
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
