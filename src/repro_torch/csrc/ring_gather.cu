// Explicit-ring row gather for Hopper: out[k, :] = src[idx[k], :].
//
// One body for two TPU kernels that compute the same function:
//   src/repro/kernels/dae_gather/kernel.py::gather_rif (_gather_rif_kernel),
//     the explicit-RIF form of the decoupled gather, on (N, D) tables of
//     float32, bfloat16 or float16;
//   src/repro/kernels/compiled/kernel.py::ring_gather (_gather_kernel), the
//     compiler's STATIC-stream template, which generalises it to any
//     (N, W) int32 or float32 port (W = 1 for the compiler's scalar ports).
//
// Bound on this card: bytes.  The gather reads each requested row once
// and writes it once and does no arithmetic, so its floor is
// 2 * M * W * elem bytes (rows read once each where indices repeat) over
// 3.35 TB/s.
//
// Design.  The TPU kernel takes `chunk` rows per grid step and keeps
// `rif` row DMAs in flight through access_execute.  Here one CTA owns one
// chunk and walks it through ring::access_execute (csrc/ring.cuh) with a
// `rif`-stage shared-memory ring of one row each, so `rif` means what it
// means on the TPU: row copies in flight per chunk.  The CTA reads its
// own indices (there is no scalar prefetch) and clamps each into [0, N),
// as dae_gather.cu does.  Rows move as 16-byte cp.async copies where the
// row size and both base pointers allow it, as 4-byte copies where they
// are 4-byte multiples, and 2-byte rows of odd width through registers
// (csrc/rows.cuh).  The last CTA takes the ragged rest, so M needs no
// padding to a multiple of the chunk.  Memory-level parallelism is
// rif rows per CTA times the CTAs resident on an SM (up to 32).
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "ring.cuh"
#include "rows.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
ring_gather_kernel(const unsigned char* __restrict__ src,
                   const int32_t* __restrict__ idx,
                   unsigned char* __restrict__ out, long long n,
                   long long row_bytes, long long m, int chunk, int rif,
                   int pitch, int mode) {
  extern __shared__ __align__(16) unsigned char ring_buf[];
  const long long base = (long long)blockIdx.x * chunk;
  const int cnt = (int)min((long long)chunk, m - base);
  auto fetch = [&](int k, int slot) {
    const long long r = rows::clamp_index(__ldg(idx + base + k), n);
    rows::request(ring_buf + (size_t)slot * pitch, src + r * row_bytes,
                  row_bytes, mode);
  };
  auto execute = [&](int k, int slot) {
    rows::store(out + (base + k) * row_bytes,
                ring_buf + (size_t)slot * pitch, row_bytes, mode);
  };
  ring::access_execute(cnt, rif, fetch, execute);
}

}  // namespace

// src (N, W) of elem_bytes 4 or 2, row-major; idx (M,) int32; out (M, W).
// `chunk` rows per CTA, `rif` ring stages of one row each.
extern "C" int ring_gather_rows(const void* src, const void* idx, void* out,
                                long long n, long long w, long long m,
                                int elem_bytes, int chunk, int rif,
                                void* stream) {
  if (m <= 0 || w <= 0) return 0;
  if (n < 1 || (elem_bytes != 4 && elem_bytes != 2) || chunk < 1 ||
      rif < 1 || rif > ring::kMaxRif) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_bytes = w * elem_bytes;
  const int mode = rows::pick(row_bytes, src, out);
  const long long pitch = (row_bytes + 15) / 16 * 16;
  const long long smem = pitch * rif;
  if (smem > (1 << 30)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ring_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (m + chunk - 1) / chunk;
  ring_gather_kernel<<<(unsigned)grid,
                       rows::threads_for(row_bytes, mode, kMaxThreads),
                       (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src),
      static_cast<const int32_t*>(idx), static_cast<unsigned char*>(out), n,
      row_bytes, m, chunk, rif, (int)pitch, mode);
  return (int)cudaGetLastError();
}
