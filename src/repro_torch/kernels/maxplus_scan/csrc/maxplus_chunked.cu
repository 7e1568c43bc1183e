// Warp-scan kernel for the batched max-plus departure recurrence
//     d_i = max(a_i, d_{i-1}) + s_i ,   one independent recurrence per row.
//
// Replaces: src/repro/kernels/maxplus_scan/kernel.py, maxplus_depart_kernel
// (bodies _mp_body / _mp_kernel / _mp_kernel_init), the Pallas TPU kernel
// that walks each row in chunks with a VMEM carry.
//
// Design.  Per tile the recurrence unrolls to the closed form
//     d_i = S_i + max( cummax_{j<=i} (a_j - E_j), carry )
// with S the inclusive and E the exclusive in-tile cumsum of s.  One warp
// owns one row (rows spread over the warps of a CTA; this takes the place
// of the TPU kernel's block_rows) and walks it in tiles of 32*V elements,
// V consecutive elements per lane.  Each lane scans its V elements
// sequentially; two __shfl_up_sync inclusive scans (a sum, a max) combine
// the lane aggregates.  The carry, the tile's last d, lives in a register
// and is broadcast from lane 31.  Elements past L load as a = -inf, s = 0,
// which leaves every real element and the carry unchanged, so ragged rows
// need no padding and the result does not depend on the rows per CTA.
//
// Bound.  Memory: each element reads a and s and writes d once (24 bytes
// in float64, 12 in float32) and costs a few adds and maxes, far below
// the card's arithmetic rate.  To keep more bytes in flight the next
// tile's loads are issued before the current tile is scanned.
//
// No multiplications appear, so no contraction can change the rounding;
// the build still passes --fmad=false.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename T, int V>
__device__ __forceinline__ void load_tile(const T* __restrict__ a,
                                          const T* __restrict__ s,
                                          int64_t e0, int64_t L, T* av,
                                          T* sv) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int64_t i = e0 + k;
    const bool in = i < L;
    av[k] = in ? a[i] : static_cast<T>(-INFINITY);
    sv[k] = in ? s[i] : static_cast<T>(0);
  }
}

template <typename T, int V>
__global__ void maxplus_chunked_kernel(const T* __restrict__ a,
                                       const T* __restrict__ s,
                                       const T* __restrict__ init,
                                       T* __restrict__ out, int64_t R,
                                       int64_t L) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (row >= R) return;  // uniform across the warp
  const T neg = static_cast<T>(-INFINITY);
  const T* ar = a + row * L;
  const T* sr = s + row * L;
  T* orow = out + row * L;
  T carry = init != nullptr ? init[row] : neg;

  constexpr int kTile = 32 * V;
  T av[V], sv[V], an[V], sn[V];
  load_tile<T, V>(ar, sr, static_cast<int64_t>(lane) * V, L, av, sv);
  for (int64_t base = 0; base < L; base += kTile) {
    const int64_t e0 = base + static_cast<int64_t>(lane) * V;
    if (base + kTile < L) load_tile<T, V>(ar, sr, e0 + kTile, L, an, sn);

    // lane aggregate of s, then its exclusive warp prefix
    T lsum = static_cast<T>(0);
#pragma unroll
    for (int k = 0; k < V; ++k) lsum += sv[k];
    T incl = lsum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    T excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = static_cast<T>(0);

    // in-lane cumsums and running max of a_j - E_j
    T S[V], m[V];
    T E = excl, run = neg;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      S[k] = E + sv[k];
      run = fmax(run, av[k] - E);
      m[k] = run;
      E = S[k];
    }
    // exclusive warp max of the lane maxima
    T mi = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(kFull, mi, off);
      if (lane >= off) mi = fmax(mi, y);
    }
    T mex = __shfl_up_sync(kFull, mi, 1);
    if (lane == 0) mex = neg;
    const T lo = fmax(mex, carry);

    T last = neg;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const T d = S[k] + fmax(m[k], lo);
      if (e0 + k < L) orow[e0 + k] = d;
      last = d;
    }
    carry = __shfl_sync(kFull, last, 31);
    if (base + kTile < L) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        av[k] = an[k];
        sv[k] = sn[k];
      }
    }
  }
}

template <typename T, int V>
int launch(const void* a, const void* s, const void* init, void* out,
           long long R, long long L, int warps, void* stream) {
  const long long blocks = (R + warps - 1) / warps;
  maxplus_chunked_kernel<T, V><<<static_cast<unsigned>(blocks), 32 * warps,
                                 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(s),
      static_cast<const T*>(init), static_cast<T*>(out), R, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError();
// `init` may be null (idle leader, carry starts at -inf).
int maxplus_chunked_f64(const void* a, const void* s, const void* init,
                        void* out, long long R, long long L, int warps,
                        void* stream) {
  return launch<double, 4>(a, s, init, out, R, L, warps, stream);
}

int maxplus_chunked_f32(const void* a, const void* s, const void* init,
                        void* out, long long R, long long L, int warps,
                        void* stream) {
  return launch<float, 8>(a, s, init, out, R, L, warps, stream);
}

const char* maxplus_chunked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
