// Paged decode attention, float32: one query token per sequence attends
// over its KV tokens, which lie in fixed-size pages scattered through a
// pool and are found through the sequence's page table (the EdgeKV page
// pool's data plane: local pages and deduplicated global pages alike).
// For query head g of KV head kvh of sequence b, over the positions
// t < lengths[b]:
//     s_t = q . k_t * scale;   out = sum_t softmax(s)_t v_t
// by an online softmax over the pages that carries the row max m, the row
// sum l and the unnormalized output acc, all float32:
//     m' = max(m, max s);   p = exp(s - m') where valid, else 0
//     l  = l e^(m - m') + sum p;   acc = acc e^(m - m') + p v
//     out = acc / max(l, 1e-30)          (zeros for a sequence of length 0)
//
// Replaces: src/repro/kernels/paged_attention/kernel.py,
// paged_attention_kernel (the Pallas kernel _paged_kernel), whose oracle is
// paged_attention/ref.py.
//
// Layout.  q, o (B, K, G, hd); pools k, v (K, N, page, hd); page_table
// (B, P_max) and lengths (B,) int32 on the device, read by the kernel, so
// a call needs no host sync.  All contiguous.
//
// Design.  The TPU grid (B, K, P_max) walks the pages of one (b, kvh) in
// order on one core and carries (m, l, acc) in VMEM; its scalar-prefetched
// table drives each step's page DMA.  Here one CTA takes one (b, kvh) and
// up to GB = 8 of its G query heads (more heads take more CTAs, each
// reading the pages again: only MQA-like G > 8 does).  The CTA reads its
// own lengths[b] and walks only pages p < min(ceil(len / page), P_max):
// a table entry past the length is never read, whatever it holds.  Each
// page is cut into chunks of up to kT = 8 tokens, and the 8 warps take the
// chunks in turn, each warp with its own (m, l, acc) for the CTA's heads:
//   * a chunk of K and of V (T x hd contiguous floats in the pool: 2,560
//     B each at page 8, hd 80) is copied to the warp's shared buffers,
//     16 B a lane, coalesced; one copy serves all the CTA's query heads;
//   * scores: lane (t, r) = (lane / 4, lane % 4) sums dims r, r + 4, ...
//     of q_g . k_t for every head, and the 4 lanes of a token add by
//     shuffles (rows padded so the 8 tokens hit distinct banks);
//   * softmax over the chunk by shuffles across the 8 tokens; the
//     exponential is selected by the mask, never multiplied by it;
//   * p v: lane owns dims lane + 32 j of acc for every head.
// At the end the warps' carries merge in shared memory, as K4's decode
// branch does.  No tensor cores (TF32 is too coarse for the port's bounds),
// no library.
//
// Bound.  Bytes: the unique pool pages that valid positions touch (a
// shared prefix page counted once however many sequences hold it), K and
// V, plus q and o.  At stablelm-3b's decode (B 8, K = H = 32, hd 80, page
// 8, lengths about 1040 with 256 shared tokens) that is about 134 MB, 0.04
// ms at 3.35 TB/s; the operations (4 hd per query head and position, 0.2
// GFLOP) are far below.  The kernel reads a shared page once per
// sequence; the repeats come from L2.  Known shortfall: a warp waits for
// each chunk's loads before its arithmetic, and the arithmetic (staging
// addresses, shuffles, exponentials) is long beside 5 to 8 KB of data, so
// an SM moves far less than its share of the memory rate; with few KV
// heads (B 8 x K 8 = 64 CTAs, mixtral's GQA) half the 132 SMs also have
// no CTA.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Masked scores are a finite -1e30, never -inf: a row with no valid key
// yet has s = m' = NEG_INF, and exp(-inf - -inf) would be nan.
constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 8;            // tokens of a chunk: 4 lanes a token
constexpr int kMaxHd = 128;
constexpr int kMaxGB = 8;        // query heads of a CTA

struct Shape {
  int B, K, G, hd, N, page, P_max, ngb, ld, vec;
  float scale;
};

// Row stride of the shared K/V chunks and of q: hd rounded up to a
// multiple of 4 whose quarter is odd, so the rows of the 8 tokens start in
// 8 distinct groups of 4 banks, and float4 stores stay aligned.
int row_stride(int hd) { return 4 * (((hd + 3) / 4) | 1); }

size_t smem_bytes(int gb, int hd) {
  const int ld = row_stride(hd);
  return sizeof(float) * (static_cast<size_t>(gb) * ld +
                          static_cast<size_t>(kWarps) * 2 * kT * ld);
}

// Copy T tokens of K and V (T x hd contiguous floats each) to the warp's
// buffers, rows of ld.  DJ = ceil(hd / 32), so a lane moves at most 2 DJ
// float4 of each.
template <int DJ>
__device__ __forceinline__ void stage(const float* __restrict__ ksrc,
                                      const float* __restrict__ vsrc,
                                      float* sK, float* sV, int T, int lane,
                                      const Shape& sh) {
  const int hd = sh.hd, ld = sh.ld;
  if (sh.vec) {  // hd % 4 == 0 and 16-byte aligned pools: a float4 a lane
    const int n4 = T * hd / 4;
    const float4* k4 = reinterpret_cast<const float4*>(ksrc);
    const float4* v4 = reinterpret_cast<const float4*>(vsrc);
    constexpr int kPer = 2 * DJ;
    float4 a[kPer], c[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {  // every load in flight before a store
      const int e = lane + 32 * i;
      if (e < n4) {
        a[i] = k4[e];
        c[i] = v4[e];
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      if (e < n4) {
        const int f = 4 * e, t = f / hd, d = f - t * hd;
        *reinterpret_cast<float4*>(&sK[t * ld + d]) = a[i];
        *reinterpret_cast<float4*>(&sV[t * ld + d]) = c[i];
      }
    }
  } else {
    for (int f = lane; f < T * hd; f += 32) {
      const int t = f / hd, d = f - t * hd;
      sK[t * ld + d] = ksrc[f];
      sV[t * ld + d] = vsrc[f];
    }
  }
}

// GB: query heads a CTA carries (1, 2, 4 or 8); DJ = ceil(hd / 32): head
// dims a lane owns in p v.
template <int GB, int DJ>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ o,
                    Shape sh) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hd = sh.hd, ld = sh.ld, page = sh.page;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gblk = blockIdx.x % sh.ngb;
  const int bk = blockIdx.x / sh.ngb;          // b K + kvh
  const int b = bk / sh.K, kvh = bk % sh.K;
  const int g0 = gblk * GB, gn = min(GB, sh.G - g0);
  float* sQ = smem;                            // GB x ld
  float* sK = sQ + GB * ld + w * 2 * kT * ld;  // this warp's kT x ld
  float* sV = sK + kT * ld;

  const float* qb = q + (static_cast<int64_t>(bk) * sh.G + g0) * hd;
  for (int e = threadIdx.x; e < GB * ld; e += kThreads) {
    const int g = e / ld, d = e - g * ld;
    sQ[e] = g < gn && d < hd ? qb[g * hd + d] : 0.f;
  }
  // the sequence's own length and table row: no scalar prefetch, no host
  const int len = max(0, min(lengths[b], sh.P_max * page));
  const int n_pages = (len + page - 1) / page;
  const int cpp = (page + kT - 1) / kT;        // chunks a page
  const int* row = page_table + static_cast<int64_t>(b) * sh.P_max;
  __syncthreads();

  float m[GB], l[GB], acc[GB][DJ];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[g][j] = 0.f;
  }
  const int t_me = lane >> 2, r_me = lane & 3;

  for (int c = w; c < n_pages * cpp; c += kWarps) {
    const int p = c / cpp, t0 = (c - p * cpp) * kT;
    const int pos0 = p * page + t0;
    if (pos0 >= len) continue;                 // the last page's tail
    const int T = min(kT, page - t0);
    // an entry within the length is clamped into the pool: never a read
    // outside it, whatever the caller put there
    const int slot = min(max(row[p], 0), sh.N - 1);
    const int64_t base =
        ((static_cast<int64_t>(kvh) * sh.N + slot) * page + t0) * hd;
    __syncwarp();                              // the last chunk's readers
    stage<DJ>(k + base, v + base, sK, sV, T, lane, sh);
    __syncwarp();

    // scores of token t_me against every head, dims r_me + 4 i
    float part[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) part[g] = 0.f;
    if (t_me < T) {
      for (int d = r_me; d < hd; d += 4) {
        const float kv = sK[t_me * ld + d];
#pragma unroll
        for (int g = 0; g < GB; ++g) part[g] = fmaf(sQ[g * ld + d], kv, part[g]);
      }
    }
    const bool valid = t_me < T && pos0 + t_me < len;
    float pr[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float s = part[g];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s = valid ? s * sh.scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      pr[g] = valid ? expf(s - m_new) : 0.f;   // select, not * mask
      float sum = pr[g];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[g][j] *= corr;
      m[g] = m_new;
    }
    // p v: lane owns dims lane + 32 j; token t's weights from lane 4 t
    for (int t = 0; t < T; ++t) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = lane + 32 * j;
        vv[j] = d < hd ? sV[t * ld + d] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float pt = __shfl_sync(0xffffffffu, pr[g], 4 * t);
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[g][j] = fmaf(pt, vv[j], acc[g][j]);
      }
    }
  }

  // merge the warps' carries; the K/V buffers are free again
  __syncthreads();
  float* sM = smem + GB * ld;                  // kWarps x GB
  float* sL = sM + kWarps * GB;                // kWarps x GB
  float* sAcc = sL + kWarps * GB;              // kWarps x GB x hd
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      sM[w * GB + g] = m[g];
      sL[w * GB + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) sAcc[(w * GB + g) * hd + d] = acc[g][j];
    }
  __syncthreads();
  float* ob = o + (static_cast<int64_t>(bk) * sh.G + g0) * hd;
  for (int e = threadIdx.x; e < gn * hd; e += kThreads) {
    const int g = e / hd, d = e - g * hd;
    float M = kNegInf;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) M = fmaxf(M, sM[i * GB + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const float x = expf(sM[i * GB + g] - M);  // 0 for a warp with no key
      L += sL[i * GB + g] * x;
      O += sAcc[(i * GB + g) * hd + d] * x;
    }
    ob[g * hd + d] = O / fmaxf(L, 1e-30f);
  }
}

template <int GB, int DJ>
int launch(const float* q, const float* k, const float* v, const int* pt,
           const int* len, float* o, const Shape& sh, cudaStream_t stream) {
  const size_t smem = smem_bytes(GB, sh.hd);
  const cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<GB, DJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ctas = static_cast<int64_t>(sh.B) * sh.K * sh.ngb;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  paged_decode_kernel<GB, DJ><<<static_cast<unsigned>(ctas), kThreads, smem,
                                stream>>>(q, k, v, pt, len, o, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int GB>
int launch_hd(const float* q, const float* k, const float* v, const int* pt,
              const int* len, float* o, const Shape& sh, cudaStream_t st) {
  switch ((sh.hd + 31) / 32) {
    case 1: return launch<GB, 1>(q, k, v, pt, len, o, sh, st);
    case 2: return launch<GB, 2>(q, k, v, pt, len, o, sh, st);
    case 3: return launch<GB, 3>(q, k, v, pt, len, o, sh, st);
    default: return launch<GB, 4>(q, k, v, pt, len, o, sh, st);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit).  q, o: (B, K, G, hd); k, v:
// (K, N, page, hd); page_table (B, P_max) and lengths (B,) int32 on the
// device; all contiguous; float32 but the tables; 1 <= hd <= 128.
int paged_decode_f32(const void* q, const void* k, const void* v,
                     const void* page_table, const void* lengths, void* o,
                     int B, int K, int G, int hd, int N, int page, int P_max,
                     float scale, void* stream) {
  if (B < 1 || K < 1 || G < 1 || hd < 1 || hd > kMaxHd || N < 1 ||
      page < 1 || P_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gb = G == 1 ? 1 : G == 2 ? 2 : G <= 4 ? 4 : kMaxGB;
  const bool aligned = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const Shape sh{B, K, G, hd, N, page, P_max, (G + gb - 1) / gb,
                 row_stride(hd), hd % 4 == 0 && aligned ? 1 : 0, scale};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* len = static_cast<const int*>(lengths);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (gb) {
    case 1: return launch_hd<1>(qf, kf, vf, pt, len, of, sh, st);
    case 2: return launch_hd<2>(qf, kf, vf, pt, len, of, sh, st);
    case 4: return launch_hd<4>(qf, kf, vf, pt, len, of, sh, st);
    default: return launch_hd<kMaxGB>(qf, kf, vf, pt, len, of, sh, st);
  }
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
