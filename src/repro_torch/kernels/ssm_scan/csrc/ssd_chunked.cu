// Chunked SSD scan (Mamba2 / mLSTM sequence mixing), float32, heads folded
// into rows: per row, per chunk of Q tokens, with an (N, P) state h carried
// from chunk to chunk,
//     cum   = cumsum(log a)                                   (Q)
//     y     = (C h) e^cum + ((C B^T) . e^(cum_t - cum_s) . tril) (x dt)
//     h    <- h e^cum_Q + B^T (x dt e^(cum_Q - cum))
// The state starts from h0 (zero when h0 is null) and is written out as
// h_out after the last chunk: prefill hands it to the decode cache.
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py, ssm_scan_kernel (the
// Pallas kernel _ssd_kernel), whose oracle is models/ssm.py ssd_chunked.
//
// Design.  The TPU kernel keeps the whole (N, P) state in VMEM and walks
// the chunks of a row as the sequential grid axis.  At mLSTM's N = P = 384
// that state is 576 KB, more than an SM's shared memory, and one CTA a row
// leaves most of the card idle.  Here the scan is split into the work that
// needs nothing from earlier chunks, done for every (row, chunk) at once,
// and a short recurrence over the chunks' states:
//   1. intra  (row, chunk): cum, the chunk's in-chunk cumsum of log a (one
//             warp: four tokens a lane, then a shuffle scan), written to
//             `cum`; and M = (C B^T) . e^(cum_t - cum_s) . dt_s for
//             s <= t, 0 above the diagonal, written to `M` (warps skip
//             the 8-column tiles of C B^T above their rows);
//   2. states (row, chunk, 128 x 128 tile of the state): S_c = B^T (x dt
//             e^(cum_Q - cum)), written to `states`;
//   3. pass   (row, 1024 state entries): h_c = h_{c-1} e^(cum_Q,c) + S_c
//             over the chunks, from h0; the state entering each chunk is
//             written over S_c in place and the last state to h_out;
//   4. out    (row, chunk, 128 state columns): y = e^cum (C h_prev) +
//             M x, M x stopping at each warp's last row; C h_prev is
//             skipped where h_prev is zero (the first chunk without h0).
// M goes through device memory (64 KB a chunk) rather than being
// recomputed by each of out's column tiles: out's tiles would repeat
// C B^T three times at P = 384.  Every product (C B^T, B^T (x dt tail),
// C h, M x) runs on the tensor cores in 3xTF32 (below), with
// mma.sync.m16n8k8: 256 threads, 8 warps, each a 16-to-64-row by
// 32-to-128-column tile of the product, two CTAs an SM.  Each product's
// depth is walked in tiles of 32, copied raw by cp.async into one of two
// shared-memory buffers while the warps multiply the other, one barrier
// a tile.  Warps split their fragments into TF32 (hi, lo) pairs in
// registers as they load them, so the split runs beside the products
// with no pass of its own; the tiles' row strides (4 or 8 mod 32 words)
// make a warp's fragment loads hit 32 distinct banks.  The scales ride
// where they cost least: dt into M, dt e^(cum_Q - cum) on x's fragments
// in states, e^cum on the C h_prev accumulators in out.  Masks are
// selected, never multiplied: above the diagonal e^(cum_t - cum_s)
// overflows to inf after about 88 nats, and inf * 0 is nan.  Four
// launches a numerator call.
//
// P = 1 (mLSTM's denominator) takes its own path: with one state column
// the products are matrix-vector, and the scan is cheapest as the
// recurrence h_t = a_t h_{t-1} + B_t (x dt)_t, y_t = C_t . h_t, one thread
// per state row n:
//   1. vec_states (row, chunk, 128 rows n): the chunk's state from zero,
//             S_c = h_Q; the first CTA of a chunk also writes its cum;
//   2. pass, as above, with P = 1;
//   3. vec_out (row, chunk): the recurrence again from h_prev, one
//             thread a row n (up to 512 at a time), C_t . h_t summed
//             over a warp by shuffles and over the warps in shared
//             memory.
// No C B^T at all.  Three launches a denominator call.  No library.
//
// 3xTF32.  A TF32 operand keeps 10 of float32's 23 mantissa bits, and one
// TF32 product misses the port's 1e-4 logit bound.  Each operand x is
// split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), so x - hi - lo is
// below 2^-22 |x|, and a product takes three mma.sync.m16n8k8 TF32
// instructions with float32 sums, hi lo + lo hi first and then hi hi; the
// dropped lo lo is below 2^-22 of the product (the scheme of
// flash_attention/csrc/flash_fwd.cu, whose mma helpers are copied here).
// rna_tf32 rounds with two integer operations in place of a cvt.
//
// Bound.  At BH = 32 rows, S = 1024, N = P = 384, Q = 128 the numerator
// needs 22.6 GFLOP (the causal triangles of C B^T and M (x dt), C h and
// B^T (x dt)): 0.34 ms at the 67 TFLOP/s of float32 FMAs on the CUDA
// cores, 0.14 ms for 3xTF32's three passes at 495 TFLOP/s on the tensor
// cores.  Its inputs and outputs are 221 MB (0.07 ms at 3.35 TB/s), but
// the chunk states make 151 MB of scratch that the states stage writes,
// the pass reads and writes, and out reads: 0.18 ms more of device
// memory.  The denominator reads B and C, 101 MB (0.03 ms): bytes bind.
//
// Scratch.  The wrapper allocates, in float32, cum (BH, S), the chunk
// states (BH, S/Q, N, P) and, for P > 1, M (BH, S/Q, Q, Q).  All grow
// linearly with the sequence, and the states dominate at BH S N P / Q x 4
// bytes: at BH 32, N = P = 384, Q 128 they are 151 MB at S 1024 and
// 4.8 GB at S 32768.  A chained pass that hands each chunk's state to
// the next instead of storing them all would remove them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;        // largest chunk
constexpr int kThreads = 256;  // 8 warps: intra, states and out
constexpr int kK = 32;         // depth of one staged tile of a product
constexpr int kTile = 128;     // state rows / columns of a states or out CTA
// Row strides, in floats, of the staged tiles: 4 mod 32 for a tile kK wide,
// whose fragments a warp reads along rows (banks 4 g + t), 8 mod 32 for a
// tile kTile wide, read across rows (banks 8 t + g).
constexpr int kLdA = kK + 4;
constexpr int kLdT = kTile + 8;
constexpr int kVecMaxThreads = 512;  // vec_out: one thread a state row

// ------------------------------------------------ 3xTF32 on mma.sync

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32 for finite x.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (below 2^-22 |x|), both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d += a b: one m16n8k8 product on the tensor cores, TF32 in, float32 sums.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: d += a b for a = ah + al, b = bh + bl; the small products first,
// al bl dropped.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32(d, ah, bl);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bh);
}

// acc[i][j] += A[m0 + 16 i .., k] B[k, n0 + 8 j ..] over k < 8 ksteps, for
// the n tiles j < jn, from raw float32 tiles: A (m, k) at a[m * AM + k * AK]
// and B (k, n) at b[k * BK + n * BN], B's row k times bs[k] where SCALE.
// Lane (g, t) loads the fragments of the PTX m16n8k8 TF32 layout (A rows
// g, g + 8 and columns t, t + 4; B rows t, t + 4 and column g) and splits
// each value into its (hi, lo) pair.
template <int WM, int WN, int AM, int AK, int BK, int BN, bool SCALE>
__device__ __forceinline__ void warp_mma(float (&acc)[WM][WN][4],
                                         const float* a, const float* b,
                                         const float* bs, int m0, int n0,
                                         int ksteps, int jn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < ksteps; ++kk) {
    const int k = 8 * kk + t;
    uint32_t ah[WM][4], al[WM][4];
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      const int m = m0 + 16 * i + g;
      const int at[4] = {m * AM + k * AK, (m + 8) * AM + k * AK,
                         m * AM + (k + 4) * AK, (m + 8) * AM + (k + 4) * AK};
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(a[at[r]], ah[i][r], al[i][r]);
    }
    const float s0 = SCALE ? bs[k] : 1.f, s1 = SCALE ? bs[k + 4] : 1.f;
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      if (j >= jn) break;
      const int n = n0 + 8 * j + g;
      uint32_t bh[2], bl[2];
      split_tf32(b[k * BK + n * BN] * s0, bh[0], bl[0]);
      split_tf32(b[(k + 4) * BK + n * BN] * s1, bh[1], bl[1]);
#pragma unroll
      for (int i = 0; i < WM; ++i) mma_3xtf32(acc[i][j], ah[i], al[i], bh, bl);
    }
  }
}

template <int WM, int WN>
__device__ __forceinline__ void zero(float (&acc)[WM][WN][4]) {
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
}

// Stores a warp's accumulator tile, rows m0 + 16 i .. and columns n0 + 8 j
// .., into out (row stride ld) inside [0, rows) x [0, cols); two columns a
// store where ld is even (then so are cols and every offset).
template <int WM, int WN>
__device__ __forceinline__ void store_tile(const float (&acc)[WM][WN][4],
                                           float* out, int64_t ld, int m0,
                                           int n0, int rows, int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool pairs = (ld & 1) == 0;
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * i + g + 8 * h;
      if (m >= rows) continue;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        float* o = out + m * ld + n;
        if (pairs && n < cols) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (n < cols) o[0] = acc[i][j][2 * h];
          if (n + 1 < cols) o[1] = acc[i][j][2 * h + 1];
        }
      }
    }
}

// ------------------------------------------------ staging by cp.async

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Global -> shared without registers; `in` false writes zeros and reads
// nothing (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows [0, R) and columns [0, C) of src (row stride ld) into raw (row
// stride LD) by cp.async, zeros at rows >= rows or columns >= cols.  vec:
// 16-byte copies, for src 16-byte aligned and ld and cols multiples of 4.
template <int R, int C, int LD>
__device__ __forceinline__ void load_tile(float* raw, const float* src,
                                          int64_t ld, int rows, int cols,
                                          bool vec) {
  if (vec) {
#pragma unroll 4
    for (int e = threadIdx.x; e < R * C / 4; e += kThreads) {
      const int r = e / (C / 4), c = 4 * (e % (C / 4));
      const bool in = r < rows && c < cols;
      cp_async16(raw + r * LD + c, in ? src + r * ld + c : src, in);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < R * C; e += kThreads) {
      const int r = e / C, c = e % C;
      const bool in = r < rows && c < cols;
      cp_async4(raw + r * LD + c, in ? src + r * ld + c : src, in);
    }
  }
}

// The chunk's cum[0..kQ) = inclusive cumsum of loga[0..Q), tokens past Q
// adding 0; called by one whole warp.
__device__ __forceinline__ void chunk_cumsum(const float* loga, int Q,
                                             float* cum) {
  const int lane = threadIdx.x & 31;
  float v[4], run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * lane + i;
    run += t < Q ? loga[t] : 0.f;
    v[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) cum[4 * lane + i] = before + v[i];
}

struct Dims {
  int64_t S;  // tokens a row
  int P, N, Q, NC;
};

// Intra, states and out walk their products' depth in tiles of kK, two
// raw buffers of each operand: tile i waits for its copy, the barrier
// frees the other buffers (every warp is done with tile i - 1), tile
// i + 1's copy starts into them, and the warps multiply tile i.

// --------------------------------------------------------------- 1. intra
// One CTA per (row, chunk).  Warp w owns rows 16 w .. 16 w + 15 of C B^T
// and only its columns s < 16 w + 16 (the causal triangle).
constexpr int kIntraBuf = 2 * kQ * kLdA;  // floats of one stage: C and B
constexpr size_t kIntraSmem = sizeof(float) * (2 * kIntraBuf + 2 * kQ);

__global__ void __launch_bounds__(kThreads, 2)
ssd_intra_kernel(const float* __restrict__ loga, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ cum, float* __restrict__ M, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* sCum = smem + 2 * kIntraBuf;
  float* sDt = sCum + kQ;
  const int rc = blockIdx.x;  // row * NC + chunk
  const int64_t tok = static_cast<int64_t>(rc) * d.Q;
  const float* C0 = Cm + tok * d.N;
  const float* B0 = Bm + tok * d.N;
  const bool vec = d.N % 4 == 0 && aligned16(Cm) && aligned16(Bm);
  const auto stage = [&](int i) {  // C (t, n) and B (s, n) at row * kLdA
    float* buf = smem + (i & 1) * kIntraBuf;
    const int n0 = i * kK;
    load_tile<kQ, kK, kLdA>(buf, C0 + n0, d.N, d.Q, d.N - n0, vec);
    load_tile<kQ, kK, kLdA>(buf + kQ * kLdA, B0 + n0, d.N, d.Q, d.N - n0,
                            vec);
  };
  stage(0);
  cp_async_commit();
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    chunk_cumsum(loga + tok, d.Q, sCum);
    for (int t = threadIdx.x; t < d.Q; t += 32) cum[tok + t] = sCum[t];
  }
  for (int t = threadIdx.x; t < kQ; t += kThreads)
    sDt[t] = t < d.Q ? dt[tok + t] : 0.f;
  const int m0 = 16 * warp;
  const bool live = m0 < d.Q;
  const int jn = 2 * warp + 2;  // 8-column tiles at or left of the diagonal
  float acc[1][16][4];
  zero(acc);
  const int tiles = (d.N + kK - 1) / kK;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < tiles) stage(i + 1);
    cp_async_commit();
    const float* buf = smem + (i & 1) * kIntraBuf;
    if (live)
      warp_mma<1, 16, kLdA, 1, 1, kLdA, false>(acc, buf, buf + kQ * kLdA,
                                                nullptr, m0, 0, kK / 8, jn);
  }
  if (!live) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* Mc = M + static_cast<int64_t>(rc) * d.Q * d.Q;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = m0 + g + 8 * (c >> 1), s = 8 * j + 2 * t + (c & 1);
      // select: above the diagonal the exponential may be inf
      if (r < d.Q && s < d.Q)
        Mc[r * d.Q + s] = j < jn && s <= r ? acc[0][j][c] *
                                                 expf(sCum[r] - sCum[s]) *
                                                 sDt[s]
                                           : 0.f;
    }
}

// -------------------------------------------------------------- 2. states
// One CTA per (tile of 128 x 128 state entries, row and chunk), the tile
// fastest in the grid's one dimension (as in out).  Warps as
// 2 (state rows n) x 4 (state columns p), each 64 x 32.
constexpr int kStatesBuf = 2 * kK * kLdT;  // B (s, n) and x (s, p)
constexpr size_t kStatesSmem = sizeof(float) * (2 * kStatesBuf + kQ);

__global__ void __launch_bounds__(kThreads, 2)
ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ cum,
                  float* __restrict__ states, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* sScale = smem + 2 * kStatesBuf;  // dt e^(cum_Q - cum)
  const int ptiles = (d.P + kTile - 1) / kTile;
  const int state_tiles = ptiles * ((d.N + kTile - 1) / kTile);
  const int tile = blockIdx.x % state_tiles;
  const int n0 = (tile / ptiles) * kTile;
  const int p0 = (tile % ptiles) * kTile;
  const int rc = blockIdx.x / state_tiles;
  const int64_t tok = static_cast<int64_t>(rc) * d.Q;
  const float* B0 = Bm + tok * d.N + n0;
  const float* X0 = x + tok * d.P + p0;
  const bool vecB = d.N % 4 == 0 && aligned16(Bm);
  const bool vecX = d.P % 4 == 0 && aligned16(x);
  const auto stage = [&](int i) {  // rows s0 .. s0 + kK - 1 at row * kLdT
    float* buf = smem + (i & 1) * kStatesBuf;
    const int s0 = i * kK;
    load_tile<kK, kTile, kLdT>(buf, B0 + s0 * d.N, d.N, d.Q - s0, d.N - n0,
                               vecB);
    load_tile<kK, kTile, kLdT>(buf + kK * kLdT, X0 + s0 * d.P, d.P, d.Q - s0,
                               d.P - p0, vecX);
  };
  stage(0);
  cp_async_commit();
  for (int s = threadIdx.x; s < kQ; s += kThreads)
    sScale[s] = s < d.Q ? dt[tok + s] * expf(cum[tok + d.Q - 1] - cum[tok + s])
                        : 0.f;
  const int warp = threadIdx.x >> 5;
  const int wm = 64 * (warp & 1), wn = 32 * (warp >> 1);
  const bool live = n0 + wm < d.N && p0 + wn < d.P;
  float acc[4][4][4];
  zero(acc);
  const int tiles = (d.Q + kK - 1) / kK;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // and sScale
    if (i + 1 < tiles) stage(i + 1);
    cp_async_commit();
    const float* buf = smem + (i & 1) * kStatesBuf;
    const int ksteps = (min(kK, d.Q - i * kK) + 7) / 8;
    // A (n, s) = B (s, n); B (s, p) = x (s, p) dt e^(cum_Q - cum)
    if (live)
      warp_mma<4, 4, 1, kLdT, kLdT, 1, true>(acc, buf, buf + kK * kLdT,
                                             sScale + i * kK, wm, wn, ksteps,
                                             4);
  }
  if (!live) return;
  store_tile(acc, states + (static_cast<int64_t>(rc) * d.N + n0) * d.P + p0,
             d.P, wm, wn, d.N - n0, d.P - p0);
}

// ---------------------------------------------------------------- 3. pass
// One thread per V state entries of a row (V = 4, one float4, where N P
// and h0 allow), the chunks in order, the next chunk's load issued before
// this chunk's store.  states[c] holds S_c on entry and the state that
// enters chunk c on exit.
__device__ __forceinline__ void load(float (&r)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
}
__device__ __forceinline__ void load(float (&r)[1], const float* p) {
  r[0] = *p;
}
__device__ __forceinline__ void store(float* p, const float (&r)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ void store(float* p, const float (&r)[1]) {
  *p = r[0];
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(const float* __restrict__ cum, const float* __restrict__ h0,
                float* __restrict__ states, float* __restrict__ h_out,
                Dims d) {
  const int64_t NP = static_cast<int64_t>(d.N) * d.P;
  const int64_t per_row = (NP / V + kThreads - 1) / kThreads;  // CTAs
  const int64_t row = blockIdx.x / per_row;
  const int64_t e = ((blockIdx.x % per_row) * kThreads + threadIdx.x) * V;
  if (e >= NP) return;
  const float* cr = cum + row * d.S;
  float* st = states + row * d.NC * NP + e;
  float h[V], s[V], nx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) h[i] = nx[i] = 0.f;
  if (h0 != nullptr) load(h, h0 + row * NP + e);
  load(s, st);
  for (int c = 0; c < d.NC; ++c) {
    if (c + 1 < d.NC) load(nx, st + (c + 1) * NP);
    store(st + c * NP, h);
    const float decay = expf(cr[static_cast<int64_t>(c) * d.Q + d.Q - 1]);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      h[i] = h[i] * decay + s[i];
      s[i] = nx[i];
    }
  }
  store(h_out + row * NP + e, h);
}

// ----------------------------------------------------------------- 4. out
// One CTA per (128 state columns, row and chunk): rows t of y against
// columns p.  Warps as 4 (rows) x 2 (columns), each 32 x 64.  Depth
// tiles 0 .. nN - 1 are C h_prev over N (none where h_prev is zero), whose
// sums are then scaled by e^cum, and nQ tiles of M x over the chunk's
// tokens follow.
constexpr int kOutBuf = kQ * kLdA + kK * kLdT;  // C or M (t, *), h or x
constexpr size_t kOutSmem = sizeof(float) * (2 * kOutBuf + kQ);

__global__ void __launch_bounds__(kThreads, 2)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ Cm,
               const float* __restrict__ cum, const float* __restrict__ M,
               const float* __restrict__ h_prev, float* __restrict__ y,
               int h_prev_zero_first, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* sE = smem + 2 * kOutBuf;  // e^cum
  const int ptiles = (d.P + kTile - 1) / kTile;
  const int p0 = (blockIdx.x % ptiles) * kTile;
  const int rc = blockIdx.x / ptiles;
  const int64_t tok = static_cast<int64_t>(rc) * d.Q;
  const float* C0 = Cm + tok * d.N;
  const float* H0 = h_prev + static_cast<int64_t>(rc) * d.N * d.P + p0;
  const float* M0 = M + static_cast<int64_t>(rc) * d.Q * d.Q;
  const float* X0 = x + tok * d.P + p0;
  const bool vecC = d.N % 4 == 0 && aligned16(Cm);
  const bool vecP = d.P % 4 == 0 && aligned16(x);  // h_prev is 16-aligned
  const bool vecM = d.Q % 4 == 0;
  const int nN = (d.N + kK - 1) / kK, nQ = (d.Q + kK - 1) / kK;
  const int first = rc % d.NC == 0 && h_prev_zero_first ? nN : 0;
  const auto stage = [&](int i) {
    float* buf = smem + (i & 1) * kOutBuf;
    if (i < nN) {
      const int n0 = i * kK;
      load_tile<kQ, kK, kLdA>(buf, C0 + n0, d.N, d.Q, d.N - n0, vecC);
      load_tile<kK, kTile, kLdT>(buf + kQ * kLdA,
                                 H0 + static_cast<int64_t>(n0) * d.P, d.P,
                                 d.N - n0, d.P - p0, vecP);
    } else {
      const int s0 = (i - nN) * kK;
      load_tile<kQ, kK, kLdA>(buf, M0 + s0, d.Q, d.Q, d.Q - s0, vecM);
      load_tile<kK, kTile, kLdT>(buf + kQ * kLdA, X0 + s0 * d.P, d.P,
                                 d.Q - s0, d.P - p0, vecP);
    }
  };
  stage(first);
  cp_async_commit();
  for (int t = threadIdx.x; t < kQ; t += kThreads)
    sE[t] = t < d.Q ? expf(cum[tok + t]) : 0.f;
  const int warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 3), wn = 64 * (warp >> 2);
  const bool live = wm < d.Q && p0 + wn < d.P;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  float acc[2][8][4];
  zero(acc);
  for (int i = first; i < nN + nQ; ++i) {
    cp_async_wait_all();
    __syncthreads();  // and sE
    if (i + 1 < nN + nQ) stage(i + 1);
    cp_async_commit();
    if (i == nN) {  // C h_prev done: scale row t by e^cum_t
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][j][c] *= sE[wm + 16 * a + g + 8 * (c >> 1)];
    }
    const float* buf = smem + (i & 1) * kOutBuf;
    const int depth = i < nN ? d.N - i * kK : d.Q - (i - nN) * kK;
    // M is 0 above the diagonal: a tile past the warp's last row is skipped
    const bool work = live && (i < nN || (i - nN) * kK < wm + 32);
    if (work)
      warp_mma<2, 8, kLdA, 1, kLdT, 1, false>(
          acc, buf, buf + kQ * kLdA, nullptr, wm, wn,
          (min(kK, depth) + 7) / 8, 8);
  }
  if (!live) return;
  store_tile(acc, y + tok * d.P + p0, d.P, wm, wn, d.Q, d.P - p0);
}

// ------------------------------------------------------- P = 1: vec path
// One thread per state row n: the chunk's state from zero by the
// recurrence.  The first CTA of each chunk writes the chunk's cum.
constexpr int kVecThreads = 128;

__global__ void __launch_bounds__(kVecThreads)
ssd_vec_states_kernel(const float* __restrict__ x,
                      const float* __restrict__ loga,
                      const float* __restrict__ dt,
                      const float* __restrict__ Bm, float* __restrict__ cum,
                      float* __restrict__ states, Dims d) {
  __shared__ float sA[kQ], sU[kQ], sCum[kQ];
  const int ntiles = (d.N + kVecThreads - 1) / kVecThreads;
  const int rc = blockIdx.x / ntiles;
  const int64_t tok = static_cast<int64_t>(rc) * d.Q;
  for (int t = threadIdx.x; t < d.Q; t += kVecThreads) {
    sA[t] = expf(loga[tok + t]);
    sU[t] = x[tok + t] * dt[tok + t];
  }
  if (blockIdx.x % ntiles == 0 && threadIdx.x < 32) {
    chunk_cumsum(loga + tok, d.Q, sCum);
    for (int t = threadIdx.x; t < d.Q; t += 32) cum[tok + t] = sCum[t];
  }
  __syncthreads();
  const int n = (blockIdx.x % ntiles) * kVecThreads + threadIdx.x;
  if (n >= d.N) return;
  const float* b = Bm + tok * d.N + n;
  float h = 0.f;
#pragma unroll 8
  for (int t = 0; t < d.Q; ++t) h = sA[t] * h + b[t * d.N] * sU[t];
  states[static_cast<int64_t>(rc) * d.N + n] = h;
}

// One CTA per (row, chunk), one thread per state row n (blockDim.x of
// them at a time), from h_prev by the recurrence; y_t = C_t . h_t is
// summed over each warp by shuffles and over the warps in shared memory,
// in a fixed order.
__global__ void __launch_bounds__(kVecMaxThreads)
ssd_vec_out_kernel(const float* __restrict__ x, const float* __restrict__ loga,
                   const float* __restrict__ dt, const float* __restrict__ Bm,
                   const float* __restrict__ Cm,
                   const float* __restrict__ h_prev, float* __restrict__ y,
                   Dims d) {
  __shared__ float sA[kQ], sU[kQ], sPart[kVecMaxThreads / 32][kQ];
  const int rc = blockIdx.x;
  const int64_t tok = static_cast<int64_t>(rc) * d.Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x / 32;
  for (int t = threadIdx.x; t < d.Q; t += blockDim.x) {
    sA[t] = expf(loga[tok + t]);
    sU[t] = x[tok + t] * dt[tok + t];
  }
  __syncthreads();
  for (int g0 = 0; g0 < d.N; g0 += blockDim.x) {
    const int n = g0 + threadIdx.x;
    const bool in = n < d.N;
    const float* b = Bm + tok * d.N + (in ? n : 0);
    const float* c = Cm + tok * d.N + (in ? n : 0);
    float h = in ? h_prev[static_cast<int64_t>(rc) * d.N + n] : 0.f;
#pragma unroll 8
    for (int t = 0; t < d.Q; ++t) {
      const int64_t at = static_cast<int64_t>(t) * d.N;
      h = sA[t] * h + (in ? b[at] : 0.f) * sU[t];
      float part = in ? c[at] * h : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) sPart[warp][t] = g0 == 0 ? part : sPart[warp][t] + part;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < d.Q; t += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += sPart[w][t];
    y[tok + t] = s;
  }
}

// ------------------------------------------------------------- launches

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

int pass(const float* cum, const float* h0, float* states, float* h_out,
         long long BH, const Dims& d, cudaStream_t st) {
  const long long NP = static_cast<long long>(d.N) * d.P;
  if (NP % 4 == 0 && aligned16(h0)) {
    const auto grid = static_cast<unsigned>(
        BH * ((NP / 4 + kThreads - 1) / kThreads));
    ssd_pass_kernel<4><<<grid, kThreads, 0, st>>>(cum, h0, states, h_out, d);
  } else {
    const auto grid =
        static_cast<unsigned>(BH * ((NP + kThreads - 1) / kThreads));
    ssd_pass_kernel<1><<<grid, kThreads, 0, st>>>(cum, h0, states, h_out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The chunked scan, launched on `stream`; returns the first error of
// cudaGetLastError() after each launch (or of setting a kernel's
// shared-memory limit).  x, y: (BH, S, P); loga, dt: (BH, S); Bm, Cm:
// (BH, S, N); h0 (may be null), h_out: (BH, N, P); all contiguous float32.
// Q (1..128) divides S.  Scratch, uninitialized: cum (BH, S); states
// (BH, S / Q, N, P); M (BH, S / Q, Q, Q), unused (may be null) at P = 1;
// states and M 16-byte aligned.  Launches intra, states, pass and out (4),
// or at P = 1 vec_states, pass and vec_out (3).
int ssd_chunked_f32(const void* x, const void* loga, const void* dt,
                    const void* Bm, const void* Cm, const void* h0, void* y,
                    void* h_out, void* cum, void* states, void* M,
                    long long BH, long long S, int P, int N, int Q,
                    void* stream) {
  if (Q < 1 || Q > kQ || S % Q != 0 || P < 1 || N < 1 || BH < 1 ||
      !aligned16(states) || (P > 1 && !aligned16(M)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* lf = static_cast<const float*>(loga);
  const auto* df = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(Bm);
  const auto* cf = static_cast<const float*>(Cm);
  const auto* hf = static_cast<const float*>(h0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(h_out);
  auto* cm = static_cast<float*>(cum);
  auto* sf = static_cast<float*>(states);
  auto* mf = static_cast<float*>(M);
  auto st = static_cast<cudaStream_t>(stream);
  const Dims d{S, P, N, Q, static_cast<int>(S / Q)};
  const unsigned chunks = static_cast<unsigned>(BH * d.NC);
  int err;
  if (P == 1) {
    const unsigned g1 = chunks * ((N + kVecThreads - 1) / kVecThreads);
    ssd_vec_states_kernel<<<g1, kVecThreads, 0, st>>>(xf, lf, df, bf, cm, sf,
                                                      d);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    if ((err = pass(cm, hf, sf, of, BH, d, st)) != 0) return err;
    const int warps = (N + 31) / 32;
    const int threads = warps < kVecMaxThreads / 32 ? 32 * warps
                                                     : kVecMaxThreads;
    ssd_vec_out_kernel<<<chunks, threads, 0, st>>>(xf, lf, df, bf, cf, sf, yf,
                                                   d);
    return static_cast<int>(cudaGetLastError());
  }
  if ((err = static_cast<int>(prepare(ssd_intra_kernel, kIntraSmem))) ||
      (err = static_cast<int>(prepare(ssd_states_kernel, kStatesSmem))) ||
      (err = static_cast<int>(prepare(ssd_out_kernel, kOutSmem))))
    return err;
  ssd_intra_kernel<<<chunks, kThreads, kIntraSmem, st>>>(lf, df, bf, cf, cm,
                                                         mf, d);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const unsigned tiles = static_cast<unsigned>(
      ((N + kTile - 1) / kTile) * ((P + kTile - 1) / kTile));
  ssd_states_kernel<<<tiles * chunks, kThreads, kStatesSmem, st>>>(
      xf, df, bf, cm, sf, d);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  if ((err = pass(cm, hf, sf, of, BH, d, st)) != 0) return err;
  ssd_out_kernel<<<((P + kTile - 1) / kTile) * chunks, kThreads, kOutSmem,
                   st>>>(xf, cf, cm, mf, sf, yf, hf == nullptr, d);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_chunked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
