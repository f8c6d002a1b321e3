// Decoupled row gather for Hopper: out[i, :] = table[idx[i], :].
//
// Replaces src/repro/kernels/dae_gather/kernel.py::gather_pipelined
// (_gather_block_kernel), the scalar-prefetch form: there the index
// vector sits in SMEM and the Pallas pipeline issues block i+1's DMA
// while block i is copied out, one (1, block_d) block per grid step.
//
// Bound on this card: bytes.  The gather moves 2 * M * D * elem bytes
// (each row read once and written once) and does no arithmetic, so its
// floor is that over 3.35 TB/s; at the model's embedding
// (M = slots * chunk rows of a (151936, 2560) f32 table) it is a few
// microseconds, under the cost of one launch.
//
// Design: there is no scalar prefetch on the GPU, so each CTA reads its
// own indices and walks rows i = blockIdx.x, blockIdx.x + gridDim.x, ...
// Memory-level parallelism comes from many CTAs in flight on the 132
// SMs, each thread holding independent 16-byte loads, instead of a ring
// inside one core.  Rows move as 16-byte vectors when the row size and
// both base pointers allow it, element by element otherwise.  JAX's lane
// padding of D to a multiple of 128 (ops.py:38) is dropped: it copied
// the whole table when D % 128 != 0, and the GPU needs no lane tiling.
// Indices are clamped into [0, N) so a bad index never reads outside the
// table; callers pass indices already in range.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // 16-byte loads in flight per thread
constexpr long long kMaxGrid = 1 << 20;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                   T* __restrict__ out, long long n, long long d, long long m,
                   int vec) {
  for (long long i = blockIdx.x; i < m; i += gridDim.x) {
    long long r = __ldg(idx + i);
    r = r < 0 ? 0 : (r >= n ? n - 1 : r);
    const T* src = table + r * d;
    T* dst = out + i * d;
    if (vec) {
      // all of a thread's loads of the row are issued before its stores
      const long long nv = d * (long long)sizeof(T) / 16;
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(dst);
      for (long long j0 = threadIdx.x; j0 < nv; j0 += kThreads * kUnroll) {
        int4 buf[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long j = j0 + u * kThreads;
          if (j < nv) buf[u] = __ldg(s4 + j);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long j = j0 + u * kThreads;
          if (j < nv) d4[j] = buf[u];
        }
      }
    } else {
      for (long long j = threadIdx.x; j < d; j += blockDim.x) dst[j] = src[j];
    }
  }
}

}  // namespace

// elem_bytes 4 (float32) or 2 (bfloat16, float16): the gather copies
// bits, so one instantiation per element size serves every dtype.
extern "C" int dae_gather_rows(const void* table, const void* idx, void* out,
                               long long n, long long d, long long m,
                               int elem_bytes, int vec, void* stream) {
  if (m <= 0) return 0;
  const unsigned grid = (unsigned)(m < kMaxGrid ? m : kMaxGrid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (elem_bytes == 4) {
    gather_rows_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(table), ix, static_cast<uint32_t*>(out),
        n, d, m, vec);
  } else if (elem_bytes == 2) {
    gather_rows_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(table), ix, static_cast<uint16_t*>(out),
        n, d, m, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
