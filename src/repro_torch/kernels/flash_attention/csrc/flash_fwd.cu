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
// KV tiles itself.  One entry point, two launch configurations of 256
// threads, chosen by the number of queries:
//   * tile (Sq > 4, prefill): one CTA per (row, tile of 64 queries), the
//     heaviest causal tiles launched first.  Q (transposed), K
//     (transposed), V and P tiles of 64 keys in shared memory (81 KB at
//     hd = 80, two CTAs an SM).  The threads form a 16 x 16 grid; thread
//     (ty, tx) computes the scores of rows 4 ty..4 ty+3 against keys
//     4 tx..4 tx+3 (two float4 loads, 16 FMAs per step of the head), keeps
//     m and l of its four rows in registers (row max and sum are reduced
//     over the 16 threads of a row by shuffles), and accumulates the
//     output of its four rows at columns tx + 16 j.
//   * rows (Sq <= 4, decode): one CTA per (row, query), so a one-token
//     decode does not pad its query to a 64-row tile at 64x the work.  Each
//     of the 8 warps walks every 8th group of 8 keys; a lane holds head
//     dims lane + 32 j of q and of acc, the score is a warp sum, and the
//     warps' (m, l, acc) are merged through shared memory at the end.
// Both take the same key range [lo, hi) from the masks, so KV tiles no
// query can reach are never loaded (the TPU kernel's block skip), and both
// apply the same mask function to every score.  Products are float32 FMAs
// on the CUDA cores: no tensor cores (TF32 keeps 10 mantissa bits, too few
// for the port's 1e-4 bound), no library.  One launch per attention call:
// 32 per prefill and 32 per decode step of stablelm-3b.
//
// Bound.  Prefill at B = 8, H = 32, S = 1024, hd = 80, causal: the causal
// triangle needs 43.0 GFLOP (0.64 ms at 67 TFLOP/s float32) and moves
// 335.5 MB (0.10 ms at 3.35 TB/s): operations bind.  Decode at kv_len
// about 1040: reading the valid K and V, about 170 MB (0.05 ms), binds.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Masked scores are a finite -1e30, never -inf: a row with no visible key
// yet has s = m' = NEG_INF, and exp(-inf - -inf) would be nan.  The
// exponential is then re-masked by a select, not a product (exp(0) = 1).
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;          // queries of a tile CTA
constexpr int kBK = 64;          // keys of a KV tile
constexpr int kLdT = kBK + 4;    // leading dim of the transposed tiles
constexpr int kMaxHd = 128;
constexpr int kRowsMaxSq = 4;    // Sq at or below which each query has a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kU = 8;            // keys a warp takes per step (rows config)

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

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t tile_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(2 * hd + kBK) * kLdT +
                          static_cast<size_t>(kBK) * hd);
}

// CPT = ceil(hd / 16): output columns per thread.
template <int CPT>
__global__ void __launch_bounds__(kThreads)
flash_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  const int* __restrict__ kv_len, Shape sh) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hd = sh.hd;
  float* sQt = smem;                  // hd x kLdT: Q tile, transposed
  float* sKt = sQt + hd * kLdT;       // hd x kLdT: K tile, transposed
  float* sPt = sKt + hd * kLdT;       // kBK x kLdT: probabilities, transposed
  float* sV = sPt + kBK * kLdT;       // kBK x hd

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r = blockIdx.x;
  const int b = r / sh.H, h = r % sh.H, kvh = h / (sh.H / sh.K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int seq_k = true_len(kv_len, sh);
  const int64_t q_step = static_cast<int64_t>(sh.H) * hd;  // token stride
  const int64_t k_step = static_cast<int64_t>(sh.K) * hd;
  const float* qb = q + (static_cast<int64_t>(b) * sh.Sq * sh.H + h) * hd;
  const float* kb = k + (static_cast<int64_t>(b) * sh.Skv * sh.K + kvh) * hd;
  const float* vb = v + (static_cast<int64_t>(b) * sh.Skv * sh.K + kvh) * hd;
  float* ob = o + (static_cast<int64_t>(b) * sh.Sq * sh.H + h) * hd;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int i = e / hd, d = e - i * hd, s = q0 + i;
    sQt[d * kLdT + i] = s < sh.Sq ? qb[s * q_step + d] : 0.f;
  }
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  key_range(q0, min(q0 + kBQ, sh.Sq) - 1, seq_k, sh, &lo, &hi);
  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();  // Q is staged; the last tile's readers are done
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int j = e / hd, d = e - j * hd, t = k0 + j;
      const bool in = t < hi;  // keys past hi are masked: never loaded
      sKt[d * kLdT + j] = in ? kb[t * k_step + d] : 0.f;
      sV[j * hd + d] = in ? vb[t * k_step + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sQt[d * kLdT + 4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&sKt[d * kLdT + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(qp, k0 + 4 * tx + j, sh.Sq, seq_k, sh);
        s[i][j] = vis[j] ? s[i][j] * sh.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;  // select, not * mask
        sum += p[i][j];
      }
      l[i] = l[i] * corr + row_sum16(sum);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sPt[(4 * tx + j) * kLdT + 4 * ty]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      const float4 pp = *reinterpret_cast<const float4*>(&sPt[t * kLdT + 4 * ty]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < hd ? sV[t * hd + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= sh.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) ob[s * q_step + col] = acc[i][c] / den;
    }
  }
}

// DJ = ceil(hd / 32): head dims per lane.
template <int DJ>
__global__ void __launch_bounds__(kThreads)
flash_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  const int* __restrict__ kv_len, Shape sh) {
  __shared__ float sM[kWarps], sL[kWarps];
  __shared__ float sAcc[kWarps][kMaxHd];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int hd = sh.hd;
  const int r = blockIdx.x, qp = blockIdx.y;
  const int b = r / sh.H, h = r % sh.H, kvh = h / (sh.H / sh.K);
  const int seq_k = true_len(kv_len, sh);
  const int64_t k_step = static_cast<int64_t>(sh.K) * hd;
  const int64_t qo = ((static_cast<int64_t>(b) * sh.Sq + qp) * sh.H + h) * hd;
  const float* kb = k + (static_cast<int64_t>(b) * sh.Skv * sh.K + kvh) * hd;
  const float* vb = v + (static_cast<int64_t>(b) * sh.Skv * sh.K + kvh) * hd;

  float qv[DJ], acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int col = lane + 32 * j;
    qv[j] = col < hd ? q[qo + col] : 0.f;
    acc[j] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  int lo, hi;
  key_range(qp, qp, seq_k, sh, &lo, &hi);
  for (int t0 = lo + w * kU; t0 < hi; t0 += kWarps * kU) {
    float kk[kU][DJ], vv[kU][DJ];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bool in = t0 + u < hi;  // keys past hi are masked: never loaded
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int col = lane + 32 * j;
        const int64_t at = (t0 + u) * k_step + col;
        kk[u][j] = in && col < hd ? kb[at] : 0.f;
        vv[u][j] = in && col < hd ? vb[at] : 0.f;
      }
    }
    float s[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < DJ; ++j) part = fmaf(qv[j], kk[u][j], part);
      s[u] = part;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kU; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    bool vis[kU];
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      vis[u] = visible(qp, t0 + u, sh.Sq, seq_k, sh);
      s[u] = vis[u] ? s[u] * sh.scale : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float p[kU], sum = 0.f;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      p[u] = vis[u] ? expf(s[u] - m_new) : 0.f;  // select, not * mask
      sum += p[u];
    }
    l = l * corr + sum;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      float a = acc[j] * corr;
#pragma unroll
      for (int u = 0; u < kU; ++u) a = fmaf(p[u], vv[u][j], a);
      acc[j] = a;
    }
    m = m_new;
  }

  if (lane == 0) {
    sM[w] = m;
    sL[w] = l;
  }
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int col = lane + 32 * j;
    if (col < hd) sAcc[w][col] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < hd) {
    float M = kNegInf;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) M = fmaxf(M, sM[i]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const float e = expf(sM[i] - M);  // 0 for a warp that saw no key
      L += sL[i] * e;
      O += sAcc[i][threadIdx.x] * e;
    }
    o[qo + threadIdx.x] = O / fmaxf(L, 1e-30f);
  }
}

template <int CPT>
int launch_tile(const float* q, const float* k, const float* v, float* o,
                const int* kv_len, const Shape& sh, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(sh.hd);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tile_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sh.B * sh.H, (sh.Sq + kBQ - 1) / kBQ);
  flash_tile_kernel<CPT><<<grid, kThreads, smem, stream>>>(q, k, v, o,
                                                           kv_len, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int DJ>
int launch_rows(const float* q, const float* k, const float* v, float* o,
                const int* kv_len, const Shape& sh, cudaStream_t stream) {
  const dim3 grid(sh.B * sh.H, sh.Sq);
  flash_rows_kernel<DJ><<<grid, kThreads, 0, stream>>>(q, k, v, o, kv_len,
                                                       sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit).  q, o: (B, Sq, H, hd); k, v:
// (B, Skv, K, hd); all contiguous float32; H % K == 0, 1 <= hd <= 128.
// kv_len: a device int32 holding the valid KV length, or null for seq_k.
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  const void* kv_len, int B, int Sq, int Skv, int H, int K,
                  int hd, int seq_k, int causal, int window, float scale,
                  void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || K < 1 || H % K != 0 ||
      hd < 1 || hd > kMaxHd || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, Sq, Skv, H, K, hd, seq_k, causal != 0, window, scale};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  const auto* len = static_cast<const int*>(kv_len);
  auto st = static_cast<cudaStream_t>(stream);
  if (Sq <= kRowsMaxSq) {
    switch ((hd + 31) / 32) {
      case 1: return launch_rows<1>(qf, kf, vf, of, len, sh, st);
      case 2: return launch_rows<2>(qf, kf, vf, of, len, sh, st);
      case 3: return launch_rows<3>(qf, kf, vf, of, len, sh, st);
      default: return launch_rows<4>(qf, kf, vf, of, len, sh, st);
    }
  }
  if (Sq > 65535 * kBQ) return static_cast<int>(cudaErrorInvalidValue);
  switch ((hd + 15) / 16) {
    case 1: return launch_tile<1>(qf, kf, vf, of, len, sh, st);
    case 2: return launch_tile<2>(qf, kf, vf, of, len, sh, st);
    case 3: return launch_tile<3>(qf, kf, vf, of, len, sh, st);
    case 4: return launch_tile<4>(qf, kf, vf, of, len, sh, st);
    case 5: return launch_tile<5>(qf, kf, vf, of, len, sh, st);
    case 6: return launch_tile<6>(qf, kf, vf, of, len, sh, st);
    case 7: return launch_tile<7>(qf, kf, vf, of, len, sh, st);
    default: return launch_tile<8>(qf, kf, vf, of, len, sh, st);
  }
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
