// One indirect hop for Hopper: va = a[addrs], vb = b[clip(va + offset)].
//
// Replaces src/repro/kernels/compiled/kernel.py::ring_deref
// (_deref_kernel), the compiler's template for an INDIRECT stream: phase
// 1 rings the (NA, 1) int32 index port and banks the landed scalars in
// SMEM, phase 2 rings the (NB, WB) data port through that bank.  Returns
// both: (M, 1) int32 and (M, WB).
//
// Bound on this card: bytes.  It reads M addresses, M index words and M
// rows of b (each distinct row once) and writes M words and M rows, with
// one add and one clip per item, so its floor is those bytes over
// 3.35 TB/s.
//
// Design.  One CTA owns one chunk of items and runs both phases of the
// TPU kernel in order, each through ring::access_execute (csrc/ring.cuh):
//   phase 1  rif_a stages of one 4-byte cp.async (ring::copy4) each, from
//            a[clamp(addrs[k], 0, NA-1)]; execute writes out_a[k] and puts
//            clip(va + offset, 0, NB-1) into `bank`, a chunk-long int32
//            array in shared memory: the CUDA form of the TPU kernel's
//            SMEM address bank (kernel.py:104-107), and the inter-phase
//            channel;
//   phase 2  rif_b stages of one b row each, read at bank[k], moved as
//            16- or 4-byte copies by csrc/rows.cuh.
// The add is done in 64 bits, so va + offset never wraps before the clip.
// The last CTA takes the ragged rest of the items.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "ring.cuh"
#include "rows.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
ring_deref_kernel(const int32_t* __restrict__ a,
                  const unsigned char* __restrict__ b,
                  const int32_t* __restrict__ addrs,
                  int32_t* __restrict__ out_a, unsigned char* __restrict__ out_b,
                  long long na, long long nb, long long row_bytes, long long m,
                  long long offset, int chunk, int rif_a, int rif_b,
                  int pitch, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring_b = smem;                                 // rif_b rows
  int32_t* ring_a = reinterpret_cast<int32_t*>(smem + (size_t)rif_b * pitch);
  int32_t* bank = ring_a + rif_a;                               // chunk words
  const long long base = (long long)blockIdx.x * chunk;
  const int cnt = (int)min((long long)chunk, m - base);

  // phase 1: the index port, one scalar per request
  ring::access_execute(
      cnt, rif_a,
      [&](int k, int slot) {
        if (threadIdx.x == 0) {
          const long long r = rows::clamp_index(__ldg(addrs + base + k), na);
          ring::copy4(ring_a + slot, a + r);
        }
      },
      [&](int k, int slot) {
        if (threadIdx.x == 0) {
          const int32_t v = ring_a[slot];
          out_a[base + k] = v;
          bank[k] = (int32_t)rows::clamp_index((long long)v + offset, nb);
        }
      });
  __syncthreads();   // the bank is complete

  // phase 2: the data port, one row per request, addressed by the bank
  ring::access_execute(
      cnt, rif_b,
      [&](int k, int slot) {
        rows::request(ring_b + (size_t)slot * pitch, b + bank[k] * row_bytes,
                      row_bytes, mode);
      },
      [&](int k, int slot) {
        rows::store(out_b + (base + k) * row_bytes,
                    ring_b + (size_t)slot * pitch, row_bytes, mode);
      });
}

}  // namespace

// a (NA, 1) int32; b (NB, WB) of 4-byte elements; addrs (M,) int32;
// out_a (M, 1) int32; out_b (M, WB).  `chunk` items per CTA.
extern "C" int ring_deref_rows(const void* a, const void* b, const void* addrs,
                               void* out_a, void* out_b, long long na,
                               long long nb, long long wb, long long m,
                               long long offset, int chunk, int rif_a,
                               int rif_b, void* stream) {
  if (m <= 0) return 0;
  if (na < 1 || nb < 1 || nb > (1LL << 31) || wb < 1 || chunk < 1 ||
      rif_a < 1 || rif_a > ring::kMaxRif || rif_b < 1 ||
      rif_b > ring::kMaxRif) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_bytes = wb * 4;
  const int mode = rows::pick(row_bytes, b, out_b);
  const long long pitch = (row_bytes + 15) / 16 * 16;
  const long long smem = pitch * rif_b + 4LL * (rif_a + chunk);
  if (smem > (1 << 30)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ring_deref_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (m + chunk - 1) / chunk;
  ring_deref_kernel<<<(unsigned)grid,
                      rows::threads_for(row_bytes, mode, kMaxThreads),
                      (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const unsigned char*>(b),
      static_cast<const int32_t*>(addrs), static_cast<int32_t*>(out_a),
      static_cast<unsigned char*>(out_b), na, nb, row_bytes, m, offset, chunk,
      rif_a, rif_b, (int)pitch, mode);
  return (int)cudaGetLastError();
}
