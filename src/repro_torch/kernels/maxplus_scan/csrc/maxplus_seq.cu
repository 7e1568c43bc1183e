// Exact sequential kernel for the batched max-plus departure recurrence
//     d_i = max(a_i, d_{i-1}) + s_i ,   one independent recurrence per row,
// stepped one op at a time in the working type: one max and one add per
// op, in the simulator engine's own float order.  Its output is bitwise
// equal to the sequential oracle; the closed-loop sweep needs exactly
// that, since a reassociated scan moves departures by ulps and an ulp can
// flip two near-tied arrivals in the next round's queue order.
//
// Replaces: src/repro/kernels/maxplus_scan/ref.py, maxplus_depart_ref, the
// lax.scan the closed-loop sweep runs as its default "seq" backend (the
// exact counterpart of the Pallas kernel in kernel.py,
// maxplus_depart_kernel).
//
// Design.  One thread per row.  A CTA is one warp that owns 32 rows and
// walks them in tiles of 32 rows x kCols columns staged through shared
// memory: the warp loads and stores each tile row by row, so global
// accesses coalesce along L, and each lane then steps its own row through
// the tile.  Optional `reset` flags (restart at an idle leader) and a
// per-row `init` carry follow maxplus_depart_ref.
//
// Bound.  In bytes it is the same 24 bytes per float64 element as the
// warp-scan kernel, but the dependent max-add chain runs on one thread per
// row: with about 1000 rows (the million-client sweep) only about 32 warps
// exist for 132 SMs, so the chain latency, not bandwidth, sets the time.
//
// The build passes --fmad=false; there is no product to contract anyway.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64;

template <typename T>
__global__ void maxplus_seq_kernel(const T* __restrict__ a,
                                   const T* __restrict__ s,
                                   const uint8_t* __restrict__ reset,
                                   const T* __restrict__ init,
                                   T* __restrict__ out, int64_t R,
                                   int64_t L) {
  __shared__ T ta[32][kCols + 1];  // arrivals in, departures out
  __shared__ T ts[32][kCols + 1];
  __shared__ uint8_t tr[32][kCols + 1];
  const int lane = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int64_t mine = row0 + lane;
  const int rows = static_cast<int>(R - row0 < 32 ? R - row0 : 32);
  const T neg = static_cast<T>(-INFINITY);
  T d = (init != nullptr && mine < R) ? init[mine] : neg;

  for (int64_t c0 = 0; c0 < L; c0 += kCols) {
    const int cols = static_cast<int>(L - c0 < kCols ? L - c0 : kCols);
    for (int j = 0; j < rows; ++j) {
      const int64_t g = (row0 + j) * L + c0;
      for (int c = lane; c < cols; c += 32) {
        ta[j][c] = a[g + c];
        ts[j][c] = s[g + c];
        if (reset != nullptr) tr[j][c] = reset[g + c];
      }
    }
    __syncwarp();
    if (lane < rows) {
      for (int c = 0; c < cols; ++c) {
        const T prev = (reset != nullptr && tr[lane][c]) ? neg : d;
        d = fmax(ta[lane][c], prev) + ts[lane][c];
        ta[lane][c] = d;
      }
    }
    __syncwarp();
    for (int j = 0; j < rows; ++j) {
      const int64_t g = (row0 + j) * L + c0;
      for (int c = lane; c < cols; c += 32) out[g + c] = ta[j][c];
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* a, const void* s, const void* reset, const void* init,
           void* out, long long R, long long L, void* stream) {
  const long long blocks = (R + 31) / 32;
  maxplus_seq_kernel<T><<<static_cast<unsigned>(blocks), 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(s),
      static_cast<const uint8_t*>(reset), static_cast<const T*>(init),
      static_cast<T*>(out), R, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError();
// `reset` (one byte per element) and `init` (one value per row) may be
// null.
int maxplus_seq_f64(const void* a, const void* s, const void* reset,
                    const void* init, void* out, long long R, long long L,
                    void* stream) {
  return launch<double>(a, s, reset, init, out, R, L, stream);
}

int maxplus_seq_f32(const void* a, const void* s, const void* reset,
                    const void* init, void* out, long long R, long long L,
                    void* stream) {
  return launch<float>(a, s, reset, init, out, R, L, stream);
}

const char* maxplus_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
