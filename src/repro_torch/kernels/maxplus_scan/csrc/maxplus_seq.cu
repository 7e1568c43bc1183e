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
// Bound.  The larger of two times.  Bytes: a and s read and d written
// once, 24 bytes a float64 element (196.6 MB, 0.059 ms at 3.35 TB/s for
// (1000, 8192)).  The dependent chain: one thread steps its row's L ops in
// order, each a max and an add whose latencies add up (8192 steps at about
// 15 to 20 cycles, 0.07 to 0.1 ms); no reassociation may shorten it.  With
// about eight rows on each SM, the SMs together move bytes at about the
// memory rate while their chains run, so the two times are close and the
// kernel must overlap them.
//
// Design.  Rows are spread over every SM: a CTA owns rpc = ceil(R / SMs)
// rows (1 to 32; 8 for the million-client sweep's 1000 rows, 125 CTAs),
// one consumer thread each in warp 0, and warp 1 is a producer.  The
// producer keeps a ring of `ns` stages of kCols columns of every row in
// flight: a and s by cp.async of one element a thread (no alignment trap:
// every element is aligned to its size, whatever L), the `reset` bytes by
// 4-byte cp.async of the aligned words that cover the chunk, the consumer
// indexing from the chunk's offset in its first word (those words lie in
// the same aligned 4 bytes as a byte of the tensor, so they never leave
// its allocation).  Each producer lane's cp.async.mbarrier.arrive.noinc
// marks a stage full when its copies land.  The consumer waits on a full
// stage, steps its row through it, writing d over a in place (8 columns
// read ahead into registers, so shared-memory latency stays off the
// chain), and arrives on the stage's empty barrier; the producer then
// stores the stage's d to device memory with plain stores and refills it.
// Staging and write-back thus run beside the chains, and a chain waits
// only for a stage that is late.  Optional `reset` flags (restart at an
// idle leader) and a per-row `init` carry follow maxplus_depart_ref: each
// op does prev = reset ? -inf : d; d = fmax(a, prev) + s.
//
// The build passes --fmad=false; there is no product to contract anyway.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;        // columns of a stage
constexpr int kLd = kCols + 1;    // staged row stride: rows on distinct banks
constexpr int kLdReset = kCols + 8;  // bytes of a staged reset row
constexpr int kAhead = 8;         // columns read ahead of the chain
constexpr int kMaxRows = 32;      // rows of a CTA at most
constexpr int kMaxStages = 6;
constexpr size_t kSmemBudget = 160 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared.b64 state, [%0];\n}\n"
      ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// An arrive on `bar` once every cp.async this thread issued has landed;
// the barrier's count includes it (noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N)
               : "memory");
}

// Steps d through `cols` staged columns of one row, d over a in place.
template <typename T, bool RESET>
__device__ __forceinline__ T step_stage(T d, T* pa, const T* ps,
                                        const uint8_t* pr, int cols) {
  const T neg = static_cast<T>(-INFINITY);
  if (cols == kCols) {
    T va[kAhead], vs[kAhead];
    bool vr[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      va[u] = pa[u];
      vs[u] = ps[u];
      vr[u] = RESET && pr[u];
    }
#pragma unroll
    for (int c0 = 0; c0 < kCols; c0 += kAhead) {
      // the next columns are read before this block's d is stored
      T na[kAhead], ns[kAhead];
      bool nr[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int c = c0 + kAhead + u < kCols ? c0 + kAhead + u : 0;
        na[u] = pa[c];
        ns[u] = ps[c];
        nr[u] = RESET && pr[c];
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const T prev = vr[u] ? neg : d;
        d = fmax(va[u], prev) + vs[u];
        va[u] = d;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        pa[c0 + u] = va[u];
        va[u] = na[u];
        vs[u] = ns[u];
        vr[u] = nr[u];
      }
    }
  } else {
    for (int c = 0; c < cols; ++c) {
      const T prev = (RESET && pr[c]) ? neg : d;
      d = fmax(pa[c], prev) + ps[c];
      pa[c] = d;
    }
  }
  return d;
}

// Warp 0: one consumer thread per row; warp 1: the producer.
template <typename T, bool RESET>
__global__ void __launch_bounds__(64, 1)
maxplus_seq_kernel(const T* __restrict__ a, const T* __restrict__ s,
                   const uint8_t* __restrict__ reset,
                   const T* __restrict__ init, T* __restrict__ out,
                   int64_t R, int64_t L, int rpc, int ns) {
  extern __shared__ uint4 smem4[];
  T* sa = reinterpret_cast<T*>(smem4);  // [ns][rpc][kLd]: a in, d out
  T* ss = sa + ns * rpc * kLd;          // [ns][rpc][kLd]
  uint8_t* sr = reinterpret_cast<uint8_t*>(ss + ns * rpc * kLd);
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];

  const int lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rpc;
  const int rows = static_cast<int>(R - row0 < rpc ? R - row0 : rpc);
  const int64_t nch = (L + kCols - 1) / kCols;
  if (threadIdx.x == 0) {
    for (int k = 0; k < ns; ++k) {
      mbar_init(&full[k], 32);   // the producer lanes' cp.async arrives
      mbar_init(&empty[k], 32);  // the consumer lanes
    }
  }
  __syncthreads();

  if (threadIdx.x >= 32) {  // producer
    auto write_back = [&](int64_t i, int k) {
      const int64_t c0 = i * kCols;
      const int cols = static_cast<int>(L - c0 < kCols ? L - c0 : kCols);
      for (int j = 0; j < rows; ++j) {
        const T* src = sa + (k * rpc + j) * kLd;
        T* dst = out + (row0 + j) * L + c0;
        for (int c = lane; c < cols; c += 32) dst[c] = src[c];
      }
    };
    for (int64_t i = 0; i < nch; ++i) {
      const int k = static_cast<int>(i % ns);
      if (i >= ns) {
        mbar_wait(&empty[k], static_cast<uint32_t>(i / ns - 1) & 1u);
        write_back(i - ns, k);
      }
      const int64_t c0 = i * kCols;
      const int cols = static_cast<int>(L - c0 < kCols ? L - c0 : kCols);
      for (int j = 0; j < rows; ++j) {
        const int64_t g = (row0 + j) * L + c0;
        T* da = sa + (k * rpc + j) * kLd;
        T* ds = ss + (k * rpc + j) * kLd;
        for (int c = lane; c < cols; c += 32) {
          cp_async<sizeof(T)>(da + c, a + g + c);
          cp_async<sizeof(T)>(ds + c, s + g + c);
        }
        if (RESET) {
          const uintptr_t first = reinterpret_cast<uintptr_t>(reset + g);
          const uintptr_t w0 = first & ~static_cast<uintptr_t>(3);
          const int words = static_cast<int>((first - w0) + cols + 3) >> 2;
          uint8_t* dr = sr + (k * rpc + j) * kLdReset;
          for (int w = lane; w < words; w += 32)
            cp_async<4>(dr + 4 * w, reinterpret_cast<const void*>(w0 + 4 * w));
        }
      }
      cp_async_arrive(&full[k]);
    }
    const int64_t tail = nch > ns ? nch - ns : 0;
    for (int64_t i = tail; i < nch; ++i) {
      const int k = static_cast<int>(i % ns);
      mbar_wait(&empty[k], static_cast<uint32_t>(i / ns) & 1u);
      write_back(i, k);
    }
    return;
  }

  // consumer
  const T neg = static_cast<T>(-INFINITY);
  T d = (init != nullptr && lane < rows) ? init[row0 + lane] : neg;
  for (int64_t i = 0; i < nch; ++i) {
    const int k = static_cast<int>(i % ns);
    mbar_wait(&full[k], static_cast<uint32_t>(i / ns) & 1u);
    if (lane < rows) {
      const int64_t c0 = i * kCols;
      const int cols = static_cast<int>(L - c0 < kCols ? L - c0 : kCols);
      const uint8_t* pr = nullptr;
      if (RESET) {
        const uintptr_t first =
            reinterpret_cast<uintptr_t>(reset + (row0 + lane) * L + c0);
        pr = sr + (k * rpc + lane) * kLdReset + (first & 3);
      }
      d = step_stage<T, RESET>(d, sa + (k * rpc + lane) * kLd,
                               ss + (k * rpc + lane) * kLd, pr, cols);
    }
    mbar_arrive(&empty[k]);
  }
}

int sm_count(int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

template <typename T, bool RESET>
int launch_with(const void* a, const void* s, const void* reset,
                const void* init, void* out, long long R, long long L,
                cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const long long per = (R + sms - 1) / sms;
  const int rpc = static_cast<int>(per < 1 ? 1 : per > kMaxRows ? kMaxRows
                                                                  : per);
  const size_t stage = static_cast<size_t>(rpc) *
                       (2 * kLd * sizeof(T) + (RESET ? kLdReset : 0));
  const size_t fit = kSmemBudget / stage;
  const int ns = static_cast<int>(fit < 2 ? 2 : fit > kMaxStages ? kMaxStages
                                                                   : fit);
  const size_t smem = ns * stage;
  auto kernel = maxplus_seq_kernel<T, RESET>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (R + rpc - 1) / rpc;
  kernel<<<static_cast<unsigned>(blocks), 64, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(s),
      static_cast<const uint8_t*>(reset), static_cast<const T*>(init),
      static_cast<T*>(out), R, L, rpc, ns);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* s, const void* reset, const void* init,
           void* out, long long R, long long L, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return reset != nullptr
             ? launch_with<T, true>(a, s, reset, init, out, R, L, st)
             : launch_with<T, false>(a, s, reset, init, out, R, L, st);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (or
// the error of reading the SM count or raising the shared-memory limit);
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
