// Flash attention, forward, float32: for each (batch, query head) row and
// each query, softmax(q k^T / sqrt(hd)) v over the keys it may see, by an
// online softmax over tiles of keys that carries the row max m, the row sum
// l and the unnormalized output acc, all float32:
//     s     = q k^T * scale, masked to NEG_INF
//     m'    = max(m, max s);   p = exp(s - m') where visible, else 0
//     l     = l e^(m - m') + sum p;   acc = acc e^(m - m') + p v
//     out   = acc / max(l, 1e-30)
// Masks, as in the TPU kernel: causal k <= q; window k > q - window; true
// lengths k < seq_k (here a device int32, the decode cache's valid length,
// or a host int) and q < Sq.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (the Pallas kernel _flash_kernel), whose oracle is
// flash_attention/ref.py and models/attention.py gqa_attention.
//
// Layout.  q, o (B, Sq, H, hd) and k, v (B, Skv, K, hd), contiguous: the
// reference's own layout.  Row r = b H + h reads KV head h / (H / K), so
// neither the head fold nor the GQA repeat of the TPU wrapper is
// materialized.
//
// Design.  The TPU kernel runs the grid (row, query block, KV block) in
// order on one core and carries (m, l, acc) in VMEM across the KV axis.
// Here CTAs run in no order, so each CTA owns its rows' carry and walks the
// KV tiles itself.  One entry point, two launch configurations, chosen by
// the number of queries:
//   * tile (Sq > 4, prefill): one CTA per (row, tile of BQ queries), the
//     heaviest causal tiles launched first.  Both products run on the
//     tensor cores in 3xTF32 (below), with mma.sync.m16n8k8.  Each warp
//     owns 16 query rows, one m16 tile: the scores of a tile of 64 keys
//     stay in its mma accumulators (32 floats a thread), the online
//     softmax runs on those fragments (row max and sum reduced over the
//     four lanes of a quad; a tile none of whose scores the warp's rows
//     may miss skips the masks), and P passes to the P v product's A
//     operand in registers.  For tf32 m16n8k8 a thread's accumulator
//     holds the columns (2t, 2t+1) of its rows while its A fragment holds
//     (t, t+4), so the P v product takes the 8 keys of each k step in the
//     order (0, 2, 4, 6, 1, 3, 5, 7), on P's side and on V's B fragment
//     alike (a sum over keys in any order is the same sum).  The head is
//     zero-filled to HDP, a multiple of 8.  Q, K and V are staged by
//     cp.async (16 bytes a thread where hd % 4 == 0 and the pointers
//     allow, 4 otherwise) into raw buffers, and split once into TF32 hi
//     and lo planes: Q once per CTA, K and V once per tile, each in the
//     layout its fragments read with one load and no register moves (see
//     Tile); V passes through K's split buffer after the scores, and the
//     next tile's K is in flight beside the scores, its V beside p v.  BQ
//     = 128 (8 warps) up to hd = 104 (165 KB of shared memory at hd = 80,
//     one CTA an SM), 64 above.  A warp whose rows see no key of a tile
//     skips its products, exactly as if every score were masked.
//     mma.sync, not wgmma: wgmma takes its B operand from shared memory
//     K-major in a swizzled layout, from 4-warp groups.  The split passes
//     here already write exact TF32 planes, K head-contiguous and V
//     transposed, so writing them swizzled is the next step; this first
//     tensor-core design keeps to one warp per 16 rows.
//   * decode (Sq <= 4): one CTA cluster per (sequence, KV head) and pass
//     of query rows (one pass up to 4 rows, passes of 8 where a GQA group
//     has more), of n_split CTAs (1..8, the portable cluster size;
//     kernel.py's decode_splits picks it from B K, the rows, Skv and the
//     SM count, never from kv_len) that split the key range [lo, hi) into
//     shares of whole 64-key tiles.
//     Each CTA serves every query row of its pass, so a key is read from
//     device memory once for the G query heads that share it, not G
//     times.  Its 8 warps take the CTA's keys 8 at a time in turn, each
//     warp with its own loads in flight and its own online softmax, and
//     no barrier until the merge; serving 2 to 4 rows, a warp loads its
//     next 8 keys while it scores these.  A lane holds head columns lane + 32 j
//     of the step's 8 keys, so each load is a whole row of K or V, and
//     of each query row's q and acc.  A row's 8 partial dots are
//     reduce-scattered across the warp (three halving rounds, then two
//     full ones: 9 shuffles, each lane left with one key's score), the
//     softmax's max and sum over the 8 keys take three rounds each, and
//     p v takes each key's p by one shuffle.  Float32 FMAs on the CUDA
//     cores.  The warps' (m, l, acc) merge in shared memory; then each
//     CTA syncs the cluster, rank r merges rows r, r + n_split, ... from
//     its peers' shared memory (distributed shared memory) and writes
//     them, and a second cluster sync keeps every CTA's shared memory
//     alive until its peers have read it (a cluster of one CTA writes its
//     rows at once).  A split whose tiles lie past kv_len loads nothing
//     and joins both syncs with m = NEG_INF, l = 0.
//     One launch (cudaLaunchKernelEx with a cluster dimension): no second
//     merge kernel, no atomics.  The float32 instance holds the keys in
//     flight in registers, not in a ring of shared-memory tiles: a
//     cp.async ring of three 64-key stages, with its arithmetic taken out,
//     streamed slower than these loads at one query head a KV head
//     (PERF.md, section 6).
//   * decode over the int8 KV cache (entry flash_fwd_decode_i8): the same
//     configuration, instanced for int8 K/V with one float32 scale a row
//     (token, KV head) in ks, vs (B, Skv, K, 1), the reference's
//     _quant_kv layout.  Each warp keeps its keys and its lanes' columns,
//     but copies its steps into a ring of its own in shared memory
//     (kRingStages = 4 steps a warp) by cp.async and holds the next three
//     in flight while it scores one, at one row as at eight: at a byte a
//     code a step is short (1,344 bytes at hd 80), so loads a lane issues
//     for itself, a byte a column, leave a warp too few bytes in flight
//     to stream, and registers cannot hold more steps.  A step's 16 rows
//     of codes go 16 bytes a cp.async where hd and the addresses of k and
//     v allow, else 4 (kernel.py's decode_copy_bytes picks it on the
//     host); where none divides hd (hd 7) the lanes load the codes a byte
//     each and store them into the slot themselves.  Each scale is one
//     4-byte copy.  A lane's share of the copies is fixed once (RingCopy).
//     A warp waits on its own copy groups, then __syncwarp; no CTA
//     barrier before the merge.  It dequantizes from the slot,
//     float(code) * scale, one rounding as the reference's
//     k_cache.astype(f32) * ksc, the code made a float by an integer xor
//     and a float subtraction, not a conversion (code_f32), K's 8 rows
//     for every row's score and then V's for the updates (never both in
//     registers), and runs the float32 instance's arithmetic
//     (step_score, step_update), so it is bitwise that instance over the
//     dequantized copy at the same n_split.  No float copy of the cache
//     is made; keys past the valid length are zero-filled and read
//     nothing.  Its instances are bounded for 2 CTAs an SM up to 4 rows,
//     1 at 8 (kDecBlocks), and its one-row passes take more key splits
//     than the float instance's (kernel.py's int8_decode_splits); the
//     ring takes 43,008 bytes a CTA at hd 80 and 67,584 at hd 128.  The
//     tile configuration takes no int8 (kernel.py raises for Sq > 4).
// Both take the same key range [lo, hi) from the masks, so KV tiles no
// query can reach are never loaded (the TPU kernel's block skip), and both
// apply the same mask function to every score.  No library.  One launch
// per attention call: 32 per prefill and 32 per decode step of
// stablelm-3b.
//
// 3xTF32.  A TF32 operand keeps 10 of float32's 23 mantissa bits: one
// TF32 product misses the port's 1e-4 logit bound (1.9e-3 on stablelm-3b's
// logits).  Here each operand x is split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi), so x - hi - lo is below 2^-22 |x|, and a product takes
// three mma.sync.m16n8k8 TF32 instructions with float32 sums, hi lo + lo hi
// first and then hi hi; the dropped lo lo is below 2^-22 of the product.
// Emulated in numpy (tests/test_torch_attention.py, S 256, hd 80, causal)
// the scheme lands 6.0e-7 from float64, within float32's own rounding,
// while one TF32 pass is 9.8e-4 off; the kernel is held to the reference
// kernel tests' 2e-5.  The softmax scale is applied to the float32 scores
// after the product.
//
// Bound.  Prefill at B = 8, H = 32, S = 1024, hd = 80, causal: the causal
// triangle needs 43.0 GFLOP, 0.64 ms at the 67 TFLOP/s of float32 FMAs on
// the CUDA cores, the bound chip_smoke.py reports; in 3xTF32 the tensor
// cores do three times that, 0.26 ms at 495 TFLOP/s TF32 (mma.sync
// reaches only part of that rate).  It moves 335.5 MB (0.10 ms at 3.35
// TB/s).  Decode: reading the valid K and V once binds.  At kv_len 1025
// that is 168.1 MB (0.0502 ms) for stablelm-3b's 32 KV heads of 80 and
// 67 MB (0.0201 ms) for seamless-m4t-large-v2's 16 of 64 and
// mixtral-8x7b's 8 of 128; the FMAs, 2 G Sq per K/V float, take 2.5% (G
// 1) to 10% (G 4) of the CUDA cores' float32 rate at that byte rate.  The
// CTAs the grid needs to stream at that rate come from the key splits.
// The int8 instance reads hd + 4 bytes a K or V row (codes and a scale):
// at kv_len 1025, with q and o, 44.2 MB (0.0132 ms) for stablelm-3b,
// 17.6 MB (0.0052 ms) for mixtral-8x7b, 17.9 MB (0.0053 ms) for
// seamless's decoder self-attention and 2.6 MB (0.0008 ms) for
// granite-20b's MQA group of 48, near or below a launch's own latency.
// Its FMAs are the float instance's, so at that byte rate they take about
// four times their share above, 10% (G 1) to 40% (G 4) of the rate, and
// its dequantization (a load, a convert and a product a code from shared
// memory) about as many instructions again: at one row it has to keep
// both the copies and the arithmetic of 16 warps an SM going.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Masked scores are a finite -1e30, never -inf: a row with no visible key
// yet has s = m' = NEG_INF, and exp(-inf - -inf) would be nan.  The
// exponential is then re-masked by a select, not a product (exp(0) = 1).
constexpr float kNegInf = -1e30f;
constexpr int kBK = 64;          // keys of a KV tile
constexpr int kMaxHd = 128;
constexpr int kDecodeMaxSq = 4;  // Sq at or below which decode is taken
constexpr int kMaxSplit = 8;     // key splits a cluster: the portable size

struct Shape {
  int B, Sq, Skv, H, K, hd, seq_k, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int q, int k, int seq_q, int seq_k,
                                        const Shape& sh) {
  return k < seq_k && q < seq_q && (!sh.causal || k <= q) &&
         (sh.window == 0 || k > q - sh.window);
}

// The true KV length: the device int32 when given, clamped to the cache.
__device__ __forceinline__ int true_len(const int* kv_len, const Shape& sh) {
  const int n = kv_len != nullptr ? *kv_len : sh.seq_k;
  return max(0, min(n, sh.Skv));
}

// Keys [lo, hi) that queries q_first..q_last may see: tiles outside are
// skipped (the TPU kernel's @pl.when over unreachable KV blocks).
__device__ __forceinline__ void key_range(int q_first, int q_last, int seq_k,
                                          const Shape& sh, int* lo, int* hi) {
  *hi = sh.causal ? min(seq_k, q_last + 1) : seq_k;
  *lo = sh.window ? max(0, q_first - sh.window + 1) : 0;
}

// ------------------------------------------------------- tile configuration

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An asynchronous copy of N bytes from global memory to the shared-window
// address dst (smem_u32): 16 bypass L1 (.cg), 8 and 4 pass through it;
// `in` false writes zeros and reads nothing (src-size 0).
template <int N>
__device__ __forceinline__ void cp_async_to(uint32_t dst, const void* src,
                                            bool in) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(in ? N : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo + (below 2^-22 |x|): both TF32, rounded to nearest, ties away.
__device__ __forceinline__ uint2 split_tf32(float x) {
  uint32_t hi, lo;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  return make_uint2(hi, lo);
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

constexpr size_t kSmemMax = 232448;  // shared memory a CTA may have

// 2^x in one MUFU.EX2 (relative error about 2^-22; results below 2^-126,
// far under the 2e-5 bound next to the row's largest term 1, flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the tile configuration at head HDP, 32-bit words; each
// split tile is two planes, hi then lo, laid out so that every mma
// fragment a lane needs is one load into the registers the instruction
// takes:
//   Q   [warp][k step][lane][4]: the lane's A fragment (a0..a3), one
//       128-bit load;
//   K   [key][head, LDK]: within each 8 head columns, column t at 2t and
//       t + 4 at 2t + 1, so (b0, b1) is one 64-bit load;
//   V^T [head][key, LDV]: keys 2t and 2t + 1, (b0, b1) of the p v
//       product, side by side, one 64-bit load.
// V^T passes through K's buffer after the scores.  Raw K and V tiles
// stage the cp.async copies.
template <int HDP>
struct Tile {
  // row strides: 8 mod 16 words, so a warp's 64-bit loads of rows g and
  // columns 2t hit distinct banks
  static constexpr int LDK = HDP % 16 ? HDP : HDP + 8;
  static constexpr int LDV = kBK + 8;
  static constexpr int KW = 2 * kBK * LDK;  // words of split K
  static constexpr int VW = 2 * HDP * LDV;  // words of split V^T
  static constexpr int SW = KW > VW ? KW : VW;  // words of the split buffer
  static constexpr size_t bytes(int bq) {
    return sizeof(uint32_t) *
           (static_cast<size_t>(2 * bq * HDP) + SW + 2 * kBK * HDP);
  }
  // queries of a CTA: 16 a warp, 8 warps while shared memory allows
  static constexpr int BQ = bytes(128) <= kSmemMax ? 128 : 64;
  static constexpr int NT = 2 * BQ;  // threads
  static constexpr size_t SMEM = bytes(BQ);
};

// Rows row0..row0 + ROWS - 1 of src (row stride `step`, hd floats a row)
// into dst (ROWS x HDP floats) by cp.async, rows at or past `end`
// zero-filled and never read; columns hd..HDP-1 are left alone.
template <int HDP, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t step, int row0, int end,
                                          int hd, bool vec) {
  if (vec) {
    constexpr int CPR = HDP / 4;  // 16-byte chunks a row
#pragma unroll 4
    for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
      const int j = c / CPR, x = (c - j * CPR) * 4, row = row0 + j;
      const bool in = row < end;
      if (x < hd)
        cp_async_to<16>(smem_u32(dst + j * HDP + x),
                        in ? src + row * step + x : src, in);
    }
  } else {
#pragma unroll 4
    for (int c = threadIdx.x; c < ROWS * HDP; c += NT) {
      const int j = c / HDP, x = c - j * HDP, row = row0 + j;
      const bool in = row < end;
      if (x < hd)
        cp_async_to<4>(smem_u32(dst + j * HDP + x),
                       in ? src + row * step + x : src, in);
    }
  }
}

// Zeros columns hd..HDP-1 (fewer than 8) of a ROWS x HDP raw tile.
template <int HDP, int ROWS, int NT>
__device__ __forceinline__ void zero_pad(float* dst, int hd) {
  for (int c = threadIdx.x; c < ROWS * 8; c += NT) {
    const int x = hd + (c & 7);
    if (x < HDP) dst[(c >> 3) * HDP + x] = 0.f;
  }
}

// The raw BQ x HDP Q tile into A fragments: lane (g, t) of warp w at k
// step kk holds rows 16 w + g, + 8 and columns 8 kk + t, + 4.
template <int HDP, int BQ, int NT>
__device__ __forceinline__ void split_q(uint4* hi, uint4* lo,
                                        const float* raw) {
  constexpr int NK = HDP / 8;
#pragma unroll 2
  for (int e = threadIdx.x; e < BQ / 16 * NK * 32; e += NT) {
    const int lane = e & 31, kk = (e >> 5) % NK, w = (e >> 5) / NK;
    const float* x = raw + (16 * w + (lane >> 2)) * HDP + 8 * kk + (lane & 3);
    const uint2 a0 = split_tf32(x[0]), a1 = split_tf32(x[8 * HDP]);
    const uint2 a2 = split_tf32(x[4]), a3 = split_tf32(x[8 * HDP + 4]);
    hi[e] = make_uint4(a0.x, a1.x, a2.x, a3.x);
    lo[e] = make_uint4(a0.y, a1.y, a2.y, a3.y);
  }
}

// The raw kBK x HDP K tile into rows of stride LDK, each 8 head columns
// in the order (0, 4, 1, 5, 2, 6, 3, 7).
template <int HDP, int LDK, int NT>
__device__ __forceinline__ void split_k(uint32_t* hi, uint32_t* lo,
                                        const float* raw) {
#pragma unroll 2
  for (int e = threadIdx.x; e < kBK * HDP / 8; e += NT) {
    const int j = e / (HDP / 8), c = 8 * (e - j * (HDP / 8));
    const float4 x = *reinterpret_cast<const float4*>(raw + j * HDP + c);
    const float4 y = *reinterpret_cast<const float4*>(raw + j * HDP + c + 4);
    const uint2 a0 = split_tf32(x.x), a4 = split_tf32(y.x);
    const uint2 a1 = split_tf32(x.y), a5 = split_tf32(y.y);
    const uint2 a2 = split_tf32(x.z), a6 = split_tf32(y.z);
    const uint2 a3 = split_tf32(x.w), a7 = split_tf32(y.w);
    uint4* h = reinterpret_cast<uint4*>(hi + j * LDK + c);
    uint4* l = reinterpret_cast<uint4*>(lo + j * LDK + c);
    h[0] = make_uint4(a0.x, a4.x, a1.x, a5.x);
    h[1] = make_uint4(a2.x, a6.x, a3.x, a7.x);
    l[0] = make_uint4(a0.y, a4.y, a1.y, a5.y);
    l[1] = make_uint4(a2.y, a6.y, a3.y, a7.y);
  }
}

// The raw kBK x HDP V tile, transposed into rows of stride LDV.
template <int HDP, int LDV, int NT>
__device__ __forceinline__ void split_v(uint32_t* hi, uint32_t* lo,
                                        const float* raw) {
#pragma unroll 2
  for (int e = threadIdx.x; e < kBK / 4 * HDP; e += NT) {
    const int j = 4 * (e / HDP), d = e - (j / 4) * HDP;
    const uint2 a0 = split_tf32(raw[j * HDP + d]);
    const uint2 a1 = split_tf32(raw[(j + 1) * HDP + d]);
    const uint2 a2 = split_tf32(raw[(j + 2) * HDP + d]);
    const uint2 a3 = split_tf32(raw[(j + 3) * HDP + d]);
    *reinterpret_cast<uint4*>(hi + d * LDV + j) =
        make_uint4(a0.x, a1.x, a2.x, a3.x);
    *reinterpret_cast<uint4*>(lo + d * LDV + j) =
        make_uint4(a0.y, a1.y, a2.y, a3.y);
  }
}

// The online softmax of one warp's tile on its score fragments: s[j][c]
// is row qr[c >> 1], key k0 + 8 j + 2 t + (c & 1), in log2 units (scale
// times log2 e).  MASKED tiles hold a key or row some query may not see:
// those scores become kNegInf and their exponentials are selected to 0.
template <bool MASKED, int NK>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&m)[2],
                                               float (&l)[2],
                                               float (&acc)[NK][4],
                                               const int (&qr)[2], int k0,
                                               int t, int seq_k, float sl2,
                                               const Shape& sh) {
  uint32_t vis = 0;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (MASKED) {
        const bool in = visible(qr[c >> 1], k0 + 8 * j + 2 * t + (c & 1),
                                sh.Sq, seq_k, sh);
        vis |= static_cast<uint32_t>(in) << (4 * j + c);
        s[j][c] = in ? s[j][c] * sl2 : kNegInf;
      } else {
        s[j][c] *= sl2;
      }
      mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
    }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = exp2_approx(m[i] - m_new);
    m[i] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = exp2_approx(s[j][c] - m[c >> 1]);
      s[j][c] = !MASKED || ((vis >> (4 * j + c)) & 1u) ? p : 0.f;  // select
      sum[c >> 1] += s[j][c];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    l[i] = l[i] * corr[i] + sum[i];
  }
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] *= corr[c >> 1];
}

// HDP: the head width padded to a multiple of 8.
template <int HDP>
__global__ void __launch_bounds__(Tile<HDP>::NT, 1)
flash_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  const int* __restrict__ kv_len, Shape sh) {
  using C = Tile<HDP>;
  constexpr int BQ = C::BQ, NT = C::NT, LDK = C::LDK, LDV = C::LDV;
  constexpr int NK = HDP / 8;  // k steps of q k^T, n tiles of p v
  extern __shared__ uint4 smem4[];
  uint4* sQh = smem4;                      // BQ HDP / 4 fragments each
  uint4* sQl = sQh + BQ * HDP / 4;
  uint32_t* sKh = reinterpret_cast<uint32_t*>(sQl + BQ * HDP / 4);
  uint32_t* sKl = sKh + kBK * LDK;
  uint32_t* sVh = sKh;  // HDP x LDV each, after the scores
  uint32_t* sVl = sVh + HDP * LDV;
  float* rawK = reinterpret_cast<float*>(sKh + C::SW);
  float* rawV = rawK + kBK * HDP;                // kBK x HDP each
  float* rawQ = reinterpret_cast<float*>(sKh);  // BQ x HDP, staged once

  const int hd = sh.hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread in group
  const int r = blockIdx.x;
  const int b = r / sh.H, h = r % sh.H, kvh = h / (sh.H / sh.K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int seq_k = true_len(kv_len, sh);
  const int64_t q_step = static_cast<int64_t>(sh.H) * hd;  // token stride
  const int64_t k_step = static_cast<int64_t>(sh.K) * hd;
  const float* qb = q + (static_cast<int64_t>(b) * sh.Sq * sh.H + h) * hd;
  const float* kb = k + (static_cast<int64_t>(b) * sh.Skv * sh.K + kvh) * hd;
  const float* vb = v + (static_cast<int64_t>(b) * sh.Skv * sh.K + kvh) * hd;
  float* ob = o + (static_cast<int64_t>(b) * sh.Sq * sh.H + h) * hd;
  const bool vec = (hd & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const float sl2 = sh.scale * 1.4426950408889634f;  // scale * log2 e

  int lo, hi;
  key_range(q0, min(q0 + BQ, sh.Sq) - 1, seq_k, sh, &lo, &hi);
  const int kfirst = (lo / kBK) * kBK;
  const int ntiles = hi > kfirst ? (hi - kfirst + kBK - 1) / kBK : 0;
  load_rows<HDP, BQ, NT>(rawQ, qb, q_step, q0, sh.Sq, hd, vec);
  cp_async_commit();
  if (ntiles > 0) {
    load_rows<HDP, kBK, NT>(rawK, kb, k_step, kfirst, hi, hd, vec);
    cp_async_commit();
    load_rows<HDP, kBK, NT>(rawV, vb, k_step, kfirst, hi, hd, vec);
    cp_async_commit();
  }
  // head columns hd..HDP-1: never copied, always zero
  zero_pad<HDP, BQ, NT>(rawQ, hd);
  zero_pad<HDP, kBK, NT>(rawK, hd);
  zero_pad<HDP, kBK, NT>(rawV, hd);
  if (ntiles > 0) {
    cp_async_wait<2>();  // Q has landed
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  split_q<HDP, BQ, NT>(sQh, sQl, rawQ);

  // this warp's rows: wq, wq + 1, ..., and the keys they may see
  const int wq = q0 + 16 * warp;
  const int qr[2] = {wq + g, wq + g + 8};  // the thread's two rows
  int wlo, whi;
  key_range(wq, min(wq + 16, sh.Sq) - 1, seq_k, sh, &wlo, &whi);
  const bool wlive = wq < sh.Sq;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kfirst + it * kBK;
    const bool more = it + 1 < ntiles;
    cp_async_wait<1>();  // K of this tile has landed
    __syncthreads();     // ... for every thread; the last p v is done
    split_k<HDP, LDK, NT>(sKh, sKl, rawK);
    __syncthreads();
    // the next K's loads run beside the scores and the softmax
    if (more) load_rows<HDP, kBK, NT>(rawK, kb, k_step, k0 + kBK, hi, hd, vec);
    cp_async_commit();  // empty at the last tile: the count stays even

    const bool work = wlive && k0 < whi && k0 + kBK > wlo;
    float s[8][4];
    if (work) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
      // s = q k^T: A from split Q (rows g, g + 8; columns t, t + 4 of
      // each k step), B from split K (key g, columns t, t + 4)
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint4 xh = sQh[(warp * NK + kk) * 32 + lane];
        const uint4 xl = sQl[(warp * NK + kk) * 32 + lane];
        const uint32_t ah[4] = {xh.x, xh.y, xh.z, xh.w};
        const uint32_t al[4] = {xl.x, xl.y, xl.z, xl.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int at = (8 * j + g) * LDK + 8 * kk + 2 * t;
          const uint2 yh = *reinterpret_cast<const uint2*>(sKh + at);
          const uint2 yl = *reinterpret_cast<const uint2*>(sKl + at);
          const uint32_t bh[2] = {yh.x, yh.y}, bl[2] = {yl.x, yl.y};
          mma_3xtf32(s[j], ah, al, bh, bl);
        }
      }
      // a tile every score of which the warp's rows see needs no mask
      const bool full = k0 + kBK <= seq_k && wq + 16 <= sh.Sq &&
                        (!sh.causal || k0 + kBK - 1 <= wq) &&
                        (sh.window == 0 || k0 > wq + 15 - sh.window);
      if (full) {
        online_softmax<false>(s, m, l, acc, qr, k0, t, seq_k, sl2, sh);
      } else {
        online_softmax<true>(s, m, l, acc, qr, k0, t, seq_k, sl2, sh);
      }
    }

    cp_async_wait<1>();  // V of this tile has landed
    __syncthreads();     // ... for every thread; every q k^T is done
    split_v<HDP, LDV, NT>(sVh, sVl, rawV);
    __syncthreads();
    // the next V's loads run beside p v
    if (more) load_rows<HDP, kBK, NT>(rawV, vb, k_step, k0 + kBK, hi, hd, vec);
    cp_async_commit();

    if (work) {
      // acc += p v over 8 k steps of 8 keys, each taken in the order 2t,
      // 2t + 1 (A columns t, t + 4): P straight from the accumulators, V's
      // B fragment from keys 2t and 2t + 1 of head column g
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 p0 = split_tf32(s[j][0]), p1 = split_tf32(s[j][2]);
        const uint2 p2 = split_tf32(s[j][1]), p3 = split_tf32(s[j][3]);
        const uint32_t ah[4] = {p0.x, p1.x, p2.x, p3.x};
        const uint32_t al[4] = {p0.y, p1.y, p2.y, p3.y};
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int at = (8 * n + g) * LDV + 8 * j + 2 * t;
          const uint2 yh = *reinterpret_cast<const uint2*>(sVh + at);
          const uint2 yl = *reinterpret_cast<const uint2*>(sVl + at);
          const uint32_t bh[2] = {yh.x, yh.y}, bl[2] = {yl.x, yl.y};
          mma_3xtf32(acc[n], ah, al, bh, bl);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qr[i];
    if (row >= sh.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < hd) ob[row * q_step + col] = acc[n][2 * i] / den;
      if (col + 1 < hd) ob[row * q_step + col + 1] = acc[n][2 * i + 1] / den;
    }
  }
}

// ----------------------------------------------------- decode configuration

constexpr int kDecWarps = 8;  // warps of a decode CTA
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kStepKeys = 8;  // keys a warp takes a step

// Shared memory of a decode CTA serving up to `rows` query rows, floats:
// each warp's (m, l, acc), and the CTA's, which its cluster peers read.
__host__ __device__ __forceinline__ int dec_smem_floats(int hd, int rows) {
  return (kDecWarps + 1) * rows * (hd + 2);
}

// Reduce-scatter of the 8 keys' partial dots of a lane across the warp:
// after three halving rounds (xor 16, 8, 4) and two full ones (xor 2, 1),
// 9 shuffles in all, each lane holds the whole score of key (lane >> 2) &
// 7.
__device__ __forceinline__ float reduce_scatter8(float (&x)[kStepKeys],
                                                 int lane) {
#pragma unroll
  for (int h = 4, off = 16; h >= 1; h >>= 1, off >>= 1) {
    const bool up = lane & off;  // keeps the upper half of its values
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? x[i] : x[i + h];
      const float keep = up ? x[i + h] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float s = x[0];
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

// The step's arithmetic of one query row, shared by the float32 and int8
// instances so that both do the same float operations in the same order:
// the score of the lane's key sk, q . k over the lane's columns
// reduce-scattered across the warp, ...
template <int DJ>
__device__ __forceinline__ float step_score(const float (&qv)[DJ],
                                            const float (&kk)[kStepKeys][DJ],
                                            int lane) {
  float part[kStepKeys];
#pragma unroll
  for (int u = 0; u < kStepKeys; ++u) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) a = fmaf(qv[j], kk[u][j], a);
    part[u] = a;
  }
  return reduce_scatter8(part, lane);
}

// ... and the online softmax over the step's keys in log2 units, a lane
// holding key sk's score s: masked scores are kNegInf and their
// exponentials selected to 0; acc += p v with each key's p by a shuffle.
template <int DJ>
__device__ __forceinline__ void step_update(float s, bool vis, float sl2,
                                            float& m, float& l,
                                            float (&acc)[DJ],
                                            const float (&vv)[kStepKeys][DJ]) {
  const float x = vis ? s * sl2 : kNegInf;
  float mx = x;
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
  const float m_new = fmaxf(m, mx);
  const float p = vis ? exp2_approx(x - m_new) : 0.f;  // select
  float sum = p;
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 8);
  sum += __shfl_xor_sync(0xffffffffu, sum, 16);
  const float corr = exp2_approx(m - m_new);
  l = l * corr + sum;
  m = m_new;
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] *= corr;
#pragma unroll
  for (int u = 0; u < kStepKeys; ++u) {
    const float pu = __shfl_sync(0xffffffffu, p, u << 2);
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[j] = fmaf(pu, vv[u][j], acc[j]);
  }
}

// A warp's float32 step in registers: keys k0..k0 + 7 of K and V, columns
// lane + 32 j of each.
template <int DJ>
struct StepRegs {
  float k[kStepKeys][DJ], v[kStepKeys][DJ];
};

// Loads keys k0..k0 + 7; keys at or past `end` are 0 and load nothing.
template <int DJ>
__device__ __forceinline__ void load_step(StepRegs<DJ>& st, const float* kb,
                                          const float* vb, int64_t step,
                                          int k0, int end, int hd, int lane) {
#pragma unroll
  for (int u = 0; u < kStepKeys; ++u) {
    const bool in = k0 + u < end;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = lane + 32 * j;
      const int64_t at = (k0 + u) * step + col;
      st.k[u][j] = in && col < hd ? kb[at] : 0.f;
      st.v[u][j] = in && col < hd ? vb[at] : 0.f;
    }
  }
}

template <typename KV>
constexpr bool kInt8 = std::is_same<KV, int8_t>::value;

// The int8 instance's ring: kRingStages slots a warp, each one step, the
// 8 K and then the 8 V rows of codes (hd bytes each at a stride of hd
// rounded up to 16) and then their 16 float32 scales, K's first.
constexpr int kRingStages = 4;

__host__ __device__ __forceinline__ int ring_row(int hd) {
  return (hd + 15) & ~15;
}

__host__ __device__ __forceinline__ int ring_slot(int hd) {
  return 2 * kStepKeys * (ring_row(hd) + static_cast<int>(sizeof(float)));
}

__host__ __device__ __forceinline__ int ring_bytes(int hd) {
  return kDecWarps * kRingStages * ring_slot(hd);
}

// A lane's share of copying each step into its warp's ring, fixed for the
// whole loop: chunk x (`copy` bytes; hd / copy <= 32 chunks a row) of
// rows r0, r0 + rpp, ... of the step's 16 (lanes past them copy none),
// and for lanes 0..15 one scale, K's first.  Addresses are of key 0 and
// slot 0.
struct RingCopy {
  const int8_t* k;  // the chunk's K and V codes
  const int8_t* v;
  const float* s;   // the lane's scale
  uint32_t dst;     // the chunk of row r0 in the ring (shared window)
  uint32_t sdst;    // the scale in the ring
  int r0, rpp;
};

__device__ __forceinline__ RingCopy ring_copy(uint32_t ring,
                                              const int8_t* kb,
                                              const int8_t* vb,
                                              const float* ksb,
                                              const float* vsb, int64_t sstep,
                                              int hd, int copy, int lane) {
  const int rrow = ring_row(hd);
  int x = 0, r0 = 2 * kStepKeys, rpp = 0;
  if (copy > 1) {
    const int cpr = hd / copy;
    rpp = 32 / cpr;
    r0 = lane / cpr;
    x = (lane - r0 * cpr) * copy;
    if (r0 >= rpp) r0 = 2 * kStepKeys;
  }
  return {kb + x, vb + x,
          (lane < kStepKeys ? ksb : vsb) + (lane & (kStepKeys - 1)) * sstep,
          ring + static_cast<uint32_t>(r0 * rrow + x),
          ring + static_cast<uint32_t>(2 * kStepKeys * rrow + 4 * lane), r0,
          rpp};
}

template <int N>
__device__ __forceinline__ void copy_codes(const RingCopy& c, uint32_t slot,
                                           int64_t step, int k0, int end,
                                           int rrow) {
  uint32_t dst = c.dst + slot;
  for (int row = c.r0; row < 2 * kStepKeys;
       row += c.rpp, dst += c.rpp * rrow) {
    const int u = row & (kStepKeys - 1);
    const bool in = k0 + u < end;
    const int8_t* src = (row < kStepKeys ? c.k : c.v) + (k0 + u) * step;
    cp_async_to<N>(dst, in ? src : c.k, in);
  }
}

// Copies keys k0..k0 + 7 of K and V, codes and scales, into the ring slot
// at byte `slot` of the ring (generic address `at`) by cp.async, committed
// by the caller.  Where hd takes no 4-byte copy (copy 1) the lanes load
// the codes a byte each and store them into the slot themselves.  Keys at
// or past `end` are zero-filled and read nothing.
__device__ __forceinline__ void copy_step(const RingCopy& c, int8_t* at,
                                          uint32_t slot, int64_t step,
                                          int64_t sstep, int k0, int end,
                                          int hd, int copy, int lane) {
  const int rrow = ring_row(hd);
  if (lane < 2 * kStepKeys) {
    const bool in = k0 + (lane & (kStepKeys - 1)) < end;
    cp_async_to<4>(c.sdst + slot, in ? c.s + k0 * sstep : c.s, in);
  }
  switch (copy) {
    case 16:
      copy_codes<16>(c, slot, step, k0, end, rrow);
      break;
    case 4:
      copy_codes<4>(c, slot, step, k0, end, rrow);
      break;
    default:
      for (int row = 0; row < 2 * kStepKeys; ++row) {
        const int u = row & (kStepKeys - 1);
        const bool in = k0 + u < end;
        const int8_t* src = (row < kStepKeys ? c.k : c.v) + (k0 + u) * step;
        for (int x = lane; x < hd; x += 32)
          at[row * rrow + x] = in ? src[x] : int8_t(0);
      }
  }
}

// float(c) for an int8 code c from its byte b, zero-extended, without a
// conversion instruction (int to float runs at a quarter of the FMA rate
// or less, and a code takes one a row it serves): b ^ 0x80 is c + 128,
// 0 to 255, so b ^ 0x4B400080 is the float 1.5 * 2^23 + 128 + c exactly
// (its unit in the last place is 1), and taking 1.5 * 2^23 + 128 away
// again leaves c exactly.
__device__ __forceinline__ float code_f32(uint32_t b) {
  return __uint_as_float(b ^ 0x4B400080u) - 12583040.f;
}

// Rows base..base + 7 of a landed slot (K's at 0, V's at kStepKeys) as
// float32: each code times its key's scale, one rounding, as the
// reference's k_cache.astype(f32) * ksc; columns past hd (read from
// within the slot) are 0, and only the last of a lane's DJ columns can
// be past it (the instance serves 32 (DJ - 1) < hd <= 32 DJ).
template <int DJ>
__device__ __forceinline__ void dequant_rows(const int8_t* slot, int base,
                                             int hd, int lane,
                                             float (&x)[kStepKeys][DJ]) {
  const int rrow = ring_row(hd);
  const float4* sc =
      reinterpret_cast<const float4*>(slot + 2 * kStepKeys * rrow) +
      base / 4;
  const float4 s0 = sc[0], s1 = sc[1];
  const float scale[kStepKeys] = {s0.x, s0.y, s0.z, s0.w,
                                  s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int u = 0; u < kStepKeys; ++u)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = lane + 32 * j;
      const float code = code_f32(
          reinterpret_cast<const uint8_t*>(slot)[(base + u) * rrow + col]);
      x[u][j] = j < DJ - 1 || col < hd ? code * scale[u] : 0.f;
    }
}

// CTAs an SM that a decode instance's registers are bounded for: the
// float32 ones hold their keys in flight in registers (2 CTAs at one row,
// 1 above); the int8 ones hold theirs in the ring, 2 CTAs up to 4 rows
// (4 at one row measured no faster), 1 at 8 rows (2 spill).
template <int RMAX, typename KV>
constexpr int kDecBlocks =
    kInt8<KV> ? (RMAX == 8 ? 1 : 2) : (RMAX == 1 ? 2 : 1);

// One cluster of n_split CTAs (gridDim.x = B K n_split, the cluster along
// x) per (b, KV head) and pass of up to RMAX query rows (blockIdx.y): the
// CTA of rank `split` takes the split-th share of the pass's 64-key tiles
// and every query row of the pass, row r = qp G + g for query qp of head
// kvh G + g.  A lane holds head columns lane + 32 j, j < DJ.  KV: float
// K/V, or int8 codes with their scales ks, vs (B, Skv, K, 1; null for
// float), copied `copy` bytes a cp.async into the ring (copy_step).
template <int DJ, int RMAX, typename KV>
__global__ void __launch_bounds__(kDecThreads, kDecBlocks<RMAX, KV>)
flash_decode_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, float* __restrict__ o,
                    const int* __restrict__ kv_len, Shape sh, int copy) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int bk = blockIdx.x / n_split;
  const int b = bk / sh.K, kvh = bk - b * sh.K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = sh.hd;
  const int G = sh.H / sh.K, R = G * sh.Sq;
  const int rows = min(R, RMAX);  // rows the shared memory is sized for
  const int row0 = blockIdx.y * RMAX, nr = min(RMAX, R - row0);

  // the int8 ring first, then each warp's (m, l, acc) and the CTA's
  extern __shared__ __align__(16) float dsm[];
  // [warp][rows][hd]
  float* sAccW = dsm + (kInt8<KV> ? ring_bytes(hd) / 4 : 0);
  float* sAcc = sAccW + kDecWarps * rows * hd;     // [rows][hd]
  float* sMw = sAcc + rows * hd;                   // [warp][rows]
  float* sLw = sMw + kDecWarps * rows;
  float* sM = sLw + kDecWarps * rows;              // [rows]
  float* sL = sM + rows;

  // the pass's keys [lo, hi) and this CTA's tiles of them, [kfirst, kend)
  const int seq_k = true_len(kv_len, sh);
  int lo, hi;
  key_range(row0 / G, (row0 + nr - 1) / G, seq_k, sh, &lo, &hi);
  const int ntiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;
  const int kfirst = lo + split * ntiles / n_split * kBK;
  const int kend = min(hi, lo + (split + 1) * ntiles / n_split * kBK);

  const int64_t q_row = static_cast<int64_t>(sh.H) * hd;  // token stride
  const int64_t k_step = static_cast<int64_t>(sh.K) * hd;
  const int64_t row_kv = static_cast<int64_t>(b) * sh.Skv * sh.K + kvh;
  const KV* kb = k + row_kv * hd;
  const KV* vb = v + row_kv * hd;
  const float sl2 = sh.scale * 1.4426950408889634f;  // scale * log2 e
  const int sk = (lane >> 2) & 7;  // the key whose score a lane ends with
  int qp[RMAX];
  float qv[RMAX][DJ], acc[RMAX][DJ], m[RMAX], l[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int gr = row0 + min(r, nr - 1);
    qp[r] = gr / G;
    const float* qr =
        q + (b * sh.Sq + qp[r]) * q_row + (kvh * G + gr % G) *
        static_cast<int64_t>(hd);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = lane + 32 * j;
      qv[r][j] = col < hd ? qr[col] : 0.f;
      acc[r][j] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  // the warps take the CTA's keys 8 at a time in turn, each its own online
  // softmax and no barrier until the merge; every row of the instance in
  // each step, so that the rows' chains interleave (a pass's rows past nr
  // repeat its last one and are never stored)
  constexpr int kRound = kDecWarps * kStepKeys;
  if constexpr (kInt8<KV>) {
    // each warp's next kRingStages - 1 steps are in flight in its ring
    // while it scores this one, at any number of rows
    const int slot_bytes = ring_slot(hd);
    int8_t* ring = reinterpret_cast<int8_t*>(dsm) +
                   warp * kRingStages * slot_bytes;
    const uint32_t ring_s = smem_u32(ring);
    const RingCopy rc = ring_copy(ring_s, kb, vb, ks + row_kv, vs + row_kv,
                                  sh.K, hd, copy, lane);
    int k_in = kfirst + warp * kStepKeys;  // the next step to copy
#pragma unroll
    for (int i = 0; i < kRingStages - 1; ++i, k_in += kRound) {
      if (k_in < kend)
        copy_step(rc, ring + i * slot_bytes, i * slot_bytes, k_step, sh.K,
                  k_in, kend, hd, copy, lane);
      cp_async_commit();
    }
    int stage = 0;
    for (int k0 = kfirst + warp * kStepKeys; k0 < kend; k0 += kRound) {
      __syncwarp();  // every lane is done with the slot copied into next
      if (k_in < kend) {
        const int back = (stage == 0 ? kRingStages - 1 : stage - 1) *
                         slot_bytes;
        copy_step(rc, ring + back, back, k_step, sh.K, k_in, kend, hd, copy,
                  lane);
      }
      cp_async_commit();
      k_in += kRound;
      cp_async_wait<kRingStages - 1>();  // this lane's copies of the step
      __syncwarp();                      // ... and every other lane's
      const int8_t* slot = ring + stage * slot_bytes;
      stage = stage + 1 == kRingStages ? 0 : stage + 1;
      float s[RMAX];
      {
        float kk[kStepKeys][DJ];
        dequant_rows(slot, 0, hd, lane, kk);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) s[r] = step_score(qv[r], kk, lane);
      }
      float vv[kStepKeys][DJ];
      dequant_rows(slot, kStepKeys, hd, lane, vv);
      const bool vis_key = k0 + sk < kend;
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        step_update(s[r], vis_key && visible(qp[r], k0 + sk, sh.Sq, seq_k, sh),
                    sl2, m[r], l[r], acc[r], vv);
    }
  } else {
    // with 2 to 4 rows a warp's next 8 keys are in flight in registers
    // while it scores these (a row's arithmetic is short enough for the
    // other warps' loads to cover, and 8 rows leave no registers for a
    // second step)
    constexpr bool kAhead = RMAX > 1 && RMAX <= 4;
    StepRegs<DJ> cur;  // this step's keys
    if (kAhead)
      load_step(cur, kb, vb, k_step, kfirst + warp * kStepKeys, kend, hd,
                lane);
    for (int k0 = kfirst + warp * kStepKeys; k0 < kend; k0 += kRound) {
      StepRegs<DJ> nxt;
      if (kAhead)
        load_step(nxt, kb, vb, k_step, k0 + kRound, kend, hd, lane);
      else
        load_step(cur, kb, vb, k_step, k0, kend, hd, lane);
      const bool vis_key = k0 + sk < kend;
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        const float s = step_score(qv[r], cur.k, lane);
        step_update(s, vis_key && visible(qp[r], k0 + sk, sh.Sq, seq_k, sh),
                    sl2, m[r], l[r], acc[r], cur.v);
      }
      if (kAhead) cur = nxt;
    }
  }

  // each warp's (m, l, acc), then the CTA's
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= nr) break;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = lane + 32 * j;
      if (col < hd) sAccW[(warp * rows + r) * hd + col] = acc[r][j];
    }
    if (lane == 0) {
      sMw[warp * rows + r] = m[r];
      sLw[warp * rows + r] = l[r];
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * hd; e += kDecThreads) {
    const int r = e / hd;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, sMw[w * rows + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float wt = exp2_approx(sMw[w * rows + r] - M);  // 0: no key
      L = fmaf(sLw[w * rows + r], wt, L);
      A = fmaf(sAccW[w * rows * hd + e], wt, A);
    }
    if (n_split == 1) {  // the CTA saw every key: its rows are done
      const int gr = row0 + r;
      o[(b * sh.Sq + gr / G) * q_row +
        (kvh * G + gr % G) * static_cast<int64_t>(hd) + e - r * hd] =
          A / fmaxf(L, 1e-30f);
      continue;
    }
    sAcc[e] = A;
    if (e - r * hd == 0) {
      sM[r] = M;
      sL[r] = L;
    }
  }
  if (n_split == 1) return;

  // merge: every CTA's (m, l, acc) is in its shared memory; rank `split`
  // merges rows split, split + n_split, ... reading its peers' through
  // distributed shared memory, and writes them
  cluster.sync();
  const int mine = nr > split ? (nr - split + n_split - 1) / n_split : 0;
  for (int e = tid; e < mine * hd; e += kDecThreads) {
    const int r = split + n_split * (e / hd), col = e % hd;
    float M = kNegInf;
    for (int j = 0; j < n_split; ++j)
      M = fmaxf(M, *cluster.map_shared_rank(sM + r, j));
    float L = 0.f, O = 0.f;
    for (int j = 0; j < n_split; ++j) {
      // 0 for a CTA that saw no key of the row
      const float wt = exp2_approx(*cluster.map_shared_rank(sM + r, j) - M);
      L = fmaf(*cluster.map_shared_rank(sL + r, j), wt, L);
      O = fmaf(*cluster.map_shared_rank(sAcc + r * hd + col, j), wt, O);
    }
    const int gr = row0 + r;
    o[(b * sh.Sq + gr / G) * q_row +
      (kvh * G + gr % G) * static_cast<int64_t>(hd) + col] =
        O / fmaxf(L, 1e-30f);
  }
  cluster.sync();  // peers' shared memory stays until every read is done
}

template <int HDP>
int launch_tile(const float* q, const float* k, const float* v, float* o,
                const int* kv_len, const Shape& sh, cudaStream_t stream) {
  using C = Tile<HDP>;
  if (sh.Sq > 65535 * C::BQ) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tile_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sh.B * sh.H, (sh.Sq + C::BQ - 1) / C::BQ);
  flash_tile_kernel<HDP><<<grid, C::NT, C::SMEM, stream>>>(q, k, v, o,
                                                           kv_len, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DJ, int RMAX, typename KV>
int launch_decode(const float* q, const KV* k, const KV* v, const float* ks,
                  const float* vs, float* o, const int* kv_len,
                  const Shape& sh, int n_split, int copy,
                  cudaStream_t stream) {
  const int R = sh.H / sh.K * sh.Sq;
  // the float32 instances take at most 37,440 bytes (8 rows of 128),
  // under the 48 KB a launch may take without raising the kernel's limit;
  // the int8 ones add their ring (up to 67,584 bytes at hd 128)
  const size_t smem =
      sizeof(float) * dec_smem_floats(sh.hd, R < RMAX ? R : RMAX) +
      (kInt8<KV> ? ring_bytes(sh.hd) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<DJ, RMAX, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.B * sh.K * n_split, (R + RMAX - 1) / RMAX);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, flash_decode_kernel<DJ, RMAX, KV>, q, k, v,
                         ks, vs, o, kv_len, sh, copy);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The decode instance for the head's width (DJ columns a lane) and the
// rows of a pass: one head at one query; up to 4 (a GQA group of 4 at one
// query, or one head at four); larger groups in passes of 8.
template <int RMAX, typename KV>
int launch_decode_rows(const float* q, const KV* k, const KV* v,
                       const float* ks, const float* vs, float* o,
                       const int* kv_len, const Shape& sh, int n_split,
                       int copy, cudaStream_t stream) {
  switch ((sh.hd + 31) / 32) {
    case 1:
      return launch_decode<1, RMAX>(q, k, v, ks, vs, o, kv_len, sh, n_split,
                                    copy, stream);
    case 2:
      return launch_decode<2, RMAX>(q, k, v, ks, vs, o, kv_len, sh, n_split,
                                    copy, stream);
    case 3:
      return launch_decode<3, RMAX>(q, k, v, ks, vs, o, kv_len, sh, n_split,
                                    copy, stream);
    default:
      return launch_decode<4, RMAX>(q, k, v, ks, vs, o, kv_len, sh, n_split,
                                    copy, stream);
  }
}

template <typename KV>
int launch_decode_any(const float* q, const KV* k, const KV* v,
                      const float* ks, const float* vs, float* o,
                      const int* kv_len, const Shape& sh, int n_split,
                      int copy, cudaStream_t stream) {
  const int rows = sh.H / sh.K * sh.Sq;  // query rows a (b, KV head) serves
  if (rows == 1)
    return launch_decode_rows<1>(q, k, v, ks, vs, o, kv_len, sh, n_split,
                                 copy, stream);
  if (rows <= 4)
    return launch_decode_rows<4>(q, k, v, ks, vs, o, kv_len, sh, n_split,
                                 copy, stream);
  return launch_decode_rows<8>(q, k, v, ks, vs, o, kv_len, sh, n_split, copy,
                               stream);
}

bool bad_shape(int B, int Sq, int Skv, int H, int K, int hd, int window,
               int n_split) {
  return B < 1 || Sq < 1 || Skv < 1 || H < 1 || K < 1 || H % K != 0 ||
         hd < 1 || hd > kMaxHd || window < 0 || n_split < 1 ||
         n_split > kMaxSplit;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit or of the cluster launch).
// q, o: (B, Sq, H, hd); k, v: (B, Skv, K, hd); all contiguous float32;
// H % K == 0, 1 <= hd <= 128.  kv_len: a device int32 holding the valid
// KV length, or null for seq_k.  n_split: the decode configuration's key
// splits, 1..8 (kernel.py's decode_splits); Sq > 4 ignores it.
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  const void* kv_len, int B, int Sq, int Skv, int H, int K,
                  int hd, int seq_k, int causal, int window, int n_split,
                  float scale, void* stream) {
  if (bad_shape(B, Sq, Skv, H, K, hd, window, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, Sq, Skv, H, K, hd, seq_k, causal != 0, window, scale};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  const auto* len = static_cast<const int*>(kv_len);
  auto st = static_cast<cudaStream_t>(stream);
  if (Sq <= kDecodeMaxSq)
    return launch_decode_any<float>(qf, kf, vf, nullptr, nullptr, of, len,
                                    sh, n_split, 0, st);
  switch ((hd + 7) / 8) {
    case 1: return launch_tile<8>(qf, kf, vf, of, len, sh, st);
    case 2: return launch_tile<16>(qf, kf, vf, of, len, sh, st);
    case 3: return launch_tile<24>(qf, kf, vf, of, len, sh, st);
    case 4: return launch_tile<32>(qf, kf, vf, of, len, sh, st);
    case 5: return launch_tile<40>(qf, kf, vf, of, len, sh, st);
    case 6: return launch_tile<48>(qf, kf, vf, of, len, sh, st);
    case 7: return launch_tile<56>(qf, kf, vf, of, len, sh, st);
    case 8: return launch_tile<64>(qf, kf, vf, of, len, sh, st);
    case 9: return launch_tile<72>(qf, kf, vf, of, len, sh, st);
    case 10: return launch_tile<80>(qf, kf, vf, of, len, sh, st);
    case 11: return launch_tile<88>(qf, kf, vf, of, len, sh, st);
    case 12: return launch_tile<96>(qf, kf, vf, of, len, sh, st);
    case 13: return launch_tile<104>(qf, kf, vf, of, len, sh, st);
    case 14: return launch_tile<112>(qf, kf, vf, of, len, sh, st);
    case 15: return launch_tile<120>(qf, kf, vf, of, len, sh, st);
    default: return launch_tile<128>(qf, kf, vf, of, len, sh, st);
  }
}

// The int8 decode instance: k, v (B, Skv, K, hd) int8 codes and ks, vs
// (B, Skv, K, 1) float32 scales, all contiguous; Sq <= 4 (the decode
// configuration alone); `copy`, the bytes of a code copy: 16 or 4 where
// they divide hd and the addresses of k and v, else 1 (kernel.py's
// decode_copy_bytes); the rest as flash_fwd_f32.
int flash_fwd_decode_i8(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, void* o,
                        const void* kv_len, int B, int Sq, int Skv, int H,
                        int K, int hd, int seq_k, int causal, int window,
                        int n_split, int copy, float scale, void* stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  if (bad_shape(B, Sq, Skv, H, K, hd, window, n_split) || Sq > kDecodeMaxSq ||
      (copy != 1 && copy != 4 && copy != 16) || hd % copy ||
      at % copy)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, Sq, Skv, H, K, hd, seq_k, causal != 0, window, scale};
  return launch_decode_any<int8_t>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<float*>(o),
      static_cast<const int*>(kv_len), sh, n_split, copy,
      static_cast<cudaStream_t>(stream));
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
