// Decoupled row gather for Hopper: out[i, :] = table[idx[i], :].
//
// Replaces src/repro/kernels/dae_gather/kernel.py::gather_pipelined
// (_gather_block_kernel), the scalar-prefetch form: there the index
// vector sits in SMEM and the Pallas pipeline issues block i+1's DMA
// while block i is copied out, one (1, block_d) block per grid step.
//
// Bound on this card: bytes.  The gather moves 2 * M * D * elem bytes
// (each row read once and written once) and does no arithmetic, so its
// floor is that over 3.35 TB/s; at the models' embeddings (M = 8 at a
// decode step, 256 at a prefill chunk, 4096 at granite's forward, of
// 10 KB (qwen3-4b) or 6 KB (granite) float32 rows) that is 0.05 to 15
// microseconds, so the small shapes are a matter of latency: one index
// load and one row load in a row, behind the launch.
//
// Design.  There is no scalar prefetch on the GPU, so a CTA reads its own
// index.  The work is items of (row, column slice): a slice is at most
// kSliceUnits units, and each of the CTA's 256 threads issues all of its
// (up to kUnroll) loads of the slice before its first store, so its DRAM
// round trips overlap instead of queueing behind its stores.  A row of
// up to 16 KB is one item (both models' embeddings: 10 KB and 6 KB f32
// rows); a wider row is cut into slices that run on separate CTAs
// rather than in turn on one.  CTAs walk the items (blockIdx.x,
// + gridDim.x, ...), a row's slices on neighbouring CTAs.
//   Measured on the H100 under the cold timer (PERF.md §6): the
// gather takes a device-to-device copy of the same bytes plus about one
// dependent index load at every main-path shape, as index_select does.
// Items of one warp that spread M = 8 over all 132 SMs, or cut rows to
// fill one wave at M = 4096, were no faster, so rows stay whole where
// they fit a CTA.
//   The unit is the widest that the row size and both base pointers allow
// (csrc/rows.cuh's modes): 16-byte vectors, 4-byte words, or 2-byte
// elements for unaligned views and odd bf16/f16 widths.  JAX's lane
// padding of D to a multiple of 128 (ops.py:38) is dropped: it copied the
// whole table when D % 128 != 0, and the GPU needs no lane tiling.
// Indices are clamped into [0, N) so a bad index never reads outside the
// table; callers pass indices already in range.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                       // loads a thread holds
constexpr int kSliceUnits = kThreads * kUnroll;  // units an item

template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_items_kernel(const U* __restrict__ table,
                    const int32_t* __restrict__ idx, U* __restrict__ out,
                    long long n, long long units, long long items,
                    int slices) {
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long i = it / slices;
    const long long c0 = (it - i * slices) * kSliceUnits;
    const long long c1 = min(c0 + kSliceUnits, units);
    const long long r = rows::clamp_index(__ldg(idx + i), n);
    const U* src = table + r * units;
    U* dst = out + i * units;
    U buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + threadIdx.x + u * kThreads;
      if (c < c1) buf[u] = __ldg(src + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + threadIdx.x + u * kThreads;
      if (c < c1) dst[c] = buf[u];
    }
  }
}

template <typename U>
int launch(const void* table, const void* idx, void* out, long long n,
           long long units, long long m, int slices, int ctas,
           cudaStream_t st) {
  gather_items_kernel<U><<<ctas, kThreads, 0, st>>>(
      static_cast<const U*>(table), static_cast<const int32_t*>(idx),
      static_cast<U*>(out), n, units, m * slices, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// table (N, row_bytes / elem) row-major, idx (M,) int32, out (M, ...).
// `unit` (16, 4 or 2 bytes) divides row_bytes and both base pointers;
// each row is `slices` items of up to 1024 units, walked by `ctas` CTAs.
extern "C" int dae_gather_rows(const void* table, const void* idx, void* out,
                               long long n, long long row_bytes, long long m,
                               int unit, int slices, int ctas, void* stream) {
  if (m <= 0 || row_bytes <= 0) return 0;
  const uintptr_t both = reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out);
  const long long units = row_bytes / (unit > 0 ? unit : 1);
  if (n < 1 || (unit != 16 && unit != 4 && unit != 2) ||
      row_bytes % unit != 0 || both % unit != 0 ||
      (long long)slices * kSliceUnits < units || slices < 1 || ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (unit == 16) {
    return launch<int4>(table, idx, out, n, units, m, slices, ctas, st);
  }
  if (unit == 4) {
    return launch<uint32_t>(table, idx, out, n, units, m, slices, ctas, st);
  }
  return launch<unsigned short>(table, idx, out, n, units, m, slices, ctas,
                                st);
}
