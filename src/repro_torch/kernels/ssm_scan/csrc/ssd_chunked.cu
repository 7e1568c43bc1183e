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
// that state is 576 KB, more than one SM's shared memory, so here the
// state is split by columns: one CTA per (row, tile of PT state columns)
// holds h[:, p0:p0+PT] (96 KB at PT = 64) in shared memory and walks the
// chunks of its row in a loop.  Every CTA of a row recomputes C B^T for
// its tile; for P <= 16 (mLSTM's denominator, P = 1) the tile is 16 wide.
// One launch per scan.  Per chunk, 256 threads as a 16 x 16 grid, each
// owning rows t = ty + 16 i (i < 8) of every (Q, *) product:
//   1. loga -> cum (one thread, in order, from shared memory); x dt tile;
//   2. one pass over N in depth-32 tiles of C and B (transposed into
//      shared memory) accumulates both C h (the inter-chunk term) and
//      C B^T in registers;
//   3. M = (C B^T) e^(cum_t - cum_s) is written where s <= t and 0 is
//      selected elsewhere: above the diagonal cum_t - cum_s > 0, and after
//      ~88 nats expf gives inf, so a product with a 0/1 mask would give
//      inf * 0 = NaN;
//   4. y = e^cum (C h) + M (x dt), stored;
//   5. x dt is scaled by e^(cum_Q - cum) in place, and the state is
//      updated in passes of 128 rows from tiles of B.
// Plain CUDA-core FMAs from shared memory, no tensor cores, no library.
//
// Bound.  At BH = 32 rows, S = 1024, N = P = 384, Q = 128 the function
// needs about 25.8 GFLOP (float32, outside the tensor cores: 0.39 ms at
// 67 TFLOP/s) and moves about 0.2 GB (0.06 ms at 3.35 TB/s): operations
// bind.  This design adds the recomputed C B^T per state tile.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;        // largest chunk
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kK = 32;         // depth of one tile of the contraction over N
constexpr int kNT = 128;       // state rows per pass of the state update
constexpr int kLd = kQ + 1;    // padded leading dimension of the scratch

// Shared memory, in floats: the state tile (N x PT), one scratch region
// (the C and B tiles, then M, then a B tile of the state update), x dt
// (kQ x PT) and three per-token vectors.
constexpr int kScratch = kQ * kLd;
static_assert(2 * kK * kLd <= kScratch, "C and B tiles fit the scratch");
static_assert(kQ * kNT <= kScratch, "a state-update B tile fits the scratch");

template <int PT>
size_t smem_bytes(int N) {
  return sizeof(float) * (static_cast<size_t>(N) * PT + kScratch +
                          kQ * PT + 3 * kQ);
}

template <int PT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunked_kernel(const float* __restrict__ x, const float* __restrict__ loga,
                   const float* __restrict__ dt, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ h0,
                   float* __restrict__ y, float* __restrict__ h_out,
                   int64_t S, int P, int N, int Q) {
  constexpr int J = PT / 16;  // columns per thread
  extern __shared__ float smem[];
  float* sH = smem;                                   // N x PT
  float* sR = sH + static_cast<size_t>(N) * PT;       // scratch
  float* sX = sR + kScratch;                          // kQ x PT
  float* sCum = sX + kQ * PT;                         // kQ
  float* sEcum = sCum + kQ;                           // e^cum
  float* sTail = sEcum + kQ;                          // e^(cum_Q - cum)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int tiles = (P + PT - 1) / PT;
  const int64_t row = blockIdx.x / tiles;
  const int p0 = static_cast<int>(blockIdx.x % tiles) * PT;
  const int64_t tok0 = row * S;  // the row's first token

  for (int e = tid; e < N * PT; e += kThreads) {
    const int n = e / PT, p = p0 + e % PT;
    sH[e] = (h0 != nullptr && p < P) ? h0[(row * N + n) * P + p] : 0.f;
  }

  for (int64_t t0 = 0; t0 < S; t0 += Q) {
    const int64_t tok = tok0 + t0;
    __syncthreads();  // the previous chunk's readers are done
    for (int t = tid; t < kQ; t += kThreads)
      sCum[t] = t < Q ? loga[tok + t] : 0.f;
    __syncthreads();
    if (tid == 0) {  // cumsum in token order, as the plain version
      float c = 0.f;
      for (int t = 0; t < Q; ++t) {
        c += sCum[t];
        sCum[t] = c;
      }
    }
    for (int e = tid; e < kQ * PT; e += kThreads) {
      const int s = e / PT, p = p0 + e % PT;
      sX[e] = (s < Q && p < P) ? x[(tok + s) * P + p] * dt[tok + s] : 0.f;
    }
    __syncthreads();
    for (int t = tid; t < kQ; t += kThreads) {
      sEcum[t] = t < Q ? expf(sCum[t]) : 0.f;
      sTail[t] = t < Q ? expf(sCum[Q - 1] - sCum[t]) : 0.f;
    }

    // C h and C B^T, contracted over N in tiles of depth kK
    float acc[8][J];
    float cb[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) cb[i][j] = 0.f;
    }
    float* sCt = sR;              // kK x kLd: C[t][k] at k * kLd + t
    float* sBt = sR + kK * kLd;   // kK x kLd: B[s][k] at k * kLd + s
    for (int k0 = 0; k0 < N; k0 += kK) {
      for (int e = tid; e < kK * kQ; e += kThreads) {
        const int t = e / kK, k = e % kK;
        const bool in = t < Q && k0 + k < N;
        const int64_t g = (tok + t) * N + k0 + k;
        sCt[k * kLd + t] = in ? Cm[g] : 0.f;
        sBt[k * kLd + t] = in ? Bm[g] : 0.f;
      }
      __syncthreads();
      const int kn = N - k0 < kK ? N - k0 : kK;
      for (int k = 0; k < kn; ++k) {
        float a[8], b[8], hb[J];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sCt[k * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = sBt[k * kLd + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < J; ++j) hb[j] = sH[(k0 + k) * PT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) cb[i][j] = fmaf(a[i], b[j], cb[i][j]);
#pragma unroll
          for (int j = 0; j < J; ++j)
            acc[i][j] = fmaf(a[i], hb[j], acc[i][j]);
        }
      }
      __syncthreads();
    }

    // M: select, never multiply by a mask (exp above the diagonal may be
    // inf)
    float* sM = sR;  // kQ x kLd, M[t][s] at t * kLd + s
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = tx + 16 * j;
        sM[t * kLd + s] = (s <= t && t < Q)
                              ? cb[i][j] * expf(sCum[t] - sCum[s])
                              : 0.f;
      }
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] *= sEcum[t];
    }
    __syncthreads();

    // y = e^cum (C h) + M (x dt)
    for (int s = 0; s < Q; ++s) {
      float a[8], b[J];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sM[(ty + 16 * i) * kLd + s];
#pragma unroll
      for (int j = 0; j < J; ++j) b[j] = sX[s * PT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int p = p0 + tx + 16 * j;
        if (t < Q && p < P) y[(tok + t) * P + p] = acc[i][j];
      }
    }
    __syncthreads();  // M and x dt are read no more

    // h <- h e^cum_Q + B^T (x dt e^(cum_Q - cum))
    for (int e = tid; e < kQ * PT; e += kThreads) sX[e] *= sTail[e / PT];
    const float decay = expf(sCum[Q - 1]);
    float* sB = sR;  // kQ x kNT, B[s][n0 + n] at s * kNT + n
    for (int n0 = 0; n0 < N; n0 += kNT) {
      __syncthreads();  // x dt scaled; the previous pass's B tile is done
      for (int e = tid; e < kQ * kNT; e += kThreads) {
        const int s = e / kNT, n = n0 + e % kNT;
        sB[e] = (s < Q && n < N) ? Bm[(tok + s) * N + n] : 0.f;
      }
      __syncthreads();
      float u[8][J];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < J; ++j) u[i][j] = 0.f;
      }
      for (int s = 0; s < Q; ++s) {
        float a[8], b[J];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sB[s * kNT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < J; ++j) b[j] = sX[s * PT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < J; ++j) u[i][j] = fmaf(a[i], b[j], u[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + ty + 16 * i;
        if (n < N) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            float* h = &sH[n * PT + tx + 16 * j];
            *h = *h * decay + u[i][j];
          }
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * PT; e += kThreads) {
    const int n = e / PT, p = p0 + e % PT;
    if (p < P) h_out[(row * N + n) * P + p] = sH[e];
  }
}

template <int PT>
int launch(const float* x, const float* loga, const float* dt,
           const float* Bm, const float* Cm, const float* h0, float* y,
           float* h_out, long long BH, long long S, int P, int N, int Q,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<PT>(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunked_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (P + PT - 1) / PT;
  ssd_chunked_kernel<PT>
      <<<static_cast<unsigned>(BH * tiles), kThreads, smem, stream>>>(
          x, loga, dt, Bm, Cm, h0, y, h_out, S, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit).  x, y: (BH, S, P); loga, dt:
// (BH, S); Bm, Cm: (BH, S, N); h0 (may be null), h_out: (BH, N, P); all
// contiguous float32.  Q (1..128) divides S.
int ssd_chunked_f32(const void* x, const void* loga, const void* dt,
                    const void* Bm, const void* Cm, const void* h0, void* y,
                    void* h_out, long long BH, long long S, int P, int N,
                    int Q, void* stream) {
  if (Q < 1 || Q > kQ || S % Q != 0 || P < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* lf = static_cast<const float*>(loga);
  const auto* df = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(Bm);
  const auto* cf = static_cast<const float*>(Cm);
  const auto* hf = static_cast<const float*>(h0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(h_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (P <= 16)
    return launch<16>(xf, lf, df, bf, cf, hf, yf, of, BH, S, P, N, Q, st);
  return launch<64>(xf, lf, df, bf, cf, hf, yf, of, BH, S, P, N, Q, st);
}

// Shared memory the launch of ssd_chunked_f32 needs for these widths.
long long ssd_chunked_smem_bytes(int P, int N) {
  return static_cast<long long>(P <= 16 ? smem_bytes<16>(N)
                                        : smem_bytes<64>(N));
}

const char* ssd_chunked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
