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
// chunk with a `rif`-slot shared-memory ring of one row each, so `rif`
// means what it means on the TPU: row copies in flight per chunk.  The
// CTA reads its own indices (there is no scalar prefetch) and clamps each
// into [0, N), as dae_gather.cu does.  The last CTA takes the ragged
// rest, so M needs no padding to a multiple of the chunk.  Two bodies:
//  * bulk (rows whose size and both base pointers are 16-byte
//    multiples): one thread a CTA issues every copy.
//    Row k comes in as one cp.async.bulk completing on its slot's
//    (k % rif) mbarrier and goes out as one bulk copy from shared to
//    global memory; the slot is refilled with row k + rif once that copy
//    has read it (cp.async.bulk.wait_group.read).  No thread touches the
//    data and no CTA barrier sits between rows, so the CTA is one thread
//    and its ring.  The launch takes `ctas` CTAs, each walking every
//    ctas-th chunk with its ring running on across them, so the rows in
//    flight (rif x ctas) are set to what the memory needs, not to the
//    number of chunks: too few leave the bandwidth unused, too many
//    interleave so many output streams that the writes lose locality;
//  * registers (every other row: 4-byte words and 2-byte rows of odd
//    width): ring::access_execute, each row copied in by the CTA's
//    threads with cp.async (4 bytes) or plain loads (2 bytes), then
//    stored by the same threads (csrc/rows.cuh), two CTA barriers a row.
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

// A place in a bulk CTA's stream of rows: the CTA's chunks are
// blockIdx.x, + gridDim.x, ..., so the row is base + k with k < chunk,
// and moving on crosses into the CTA's next chunk.
struct Cursor {
  long long base;
  int k;
  __device__ __forceinline__ long long row() const { return base + k; }
  __device__ __forceinline__ void advance(int by, int chunk,
                                          long long stride) {
    for (k += by; k >= chunk; k -= chunk) base += stride;
  }
};

__global__ void __launch_bounds__(1)
ring_gather_bulk_kernel(const unsigned char* __restrict__ src,
                        const int32_t* __restrict__ idx,
                        unsigned char* __restrict__ out, long long n,
                        uint32_t row_bytes, long long m, int chunk, int rif) {
  extern __shared__ __align__(16) unsigned char ring_buf[];
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring_buf + (size_t)rif * row_bytes);
  for (int s = 0; s < rif; ++s) ring::mbar_init(&full[s], 1);
  ring::mbar_init_fence();
  // the CTA's rows, chunk after chunk, as one stream q = 0 .. nq - 1:
  // the ring runs on across chunks
  const int nq = rows::stream_items(m, chunk);
  const long long stride = (long long)gridDim.x * chunk;
  auto slot = [&](int q) { return ring_buf + (size_t)(q % rif) * row_bytes; };
  auto request = [&](int q, int32_t i) {        // stream row q is src[i]
    uint64_t* bar = &full[q % rif];
    ring::mbar_expect(bar, row_bytes);
    ring::bulk_copy(slot(q), src + rows::clamp_index(i, n) * row_bytes,
                    row_bytes, bar);
  };
  Cursor cur{(long long)blockIdx.x * chunk, 0};
  Cursor ahead = cur;                  // after the prologue: rif rows on
  for (int q = 0; q < min(nq, rif); ++q) {      // prologue
    request(q, __ldg(idx + ahead.row()));
    ahead.advance(1, chunk, stride);
  }
  for (int q = 0; q < nq; ++q) {
    const bool more = q + rif < nq;
    // the next index's load overlaps the wait for this row
    const int32_t next = more ? __ldg(idx + ahead.row()) : 0;
    ring::mbar_wait(&full[q % rif], (uint32_t)(q / rif) & 1);
    ring::fence_proxy_async();
    ring::bulk_store(out + cur.row() * row_bytes, slot(q), row_bytes);
    ring::bulk_commit();
    if (more) {
      ring::bulk_wait_read<0>();              // the store has read the slot
      request(q + rif, next);
    }
    cur.advance(1, chunk, stride);
    ahead.advance(1, chunk, stride);
  }
  ring::bulk_wait<0>();                       // every row written
}

}  // namespace

// src (N, W) of elem_bytes 4 or 2, row-major; idx (M,) int32; out (M, W).
// `chunk` rows per CTA, `rif` ring slots of one row each.  Rows and
// both base pointers 16-byte multiples: the bulk body on `ctas` CTAs (0:
// one a chunk), each taking every ctas-th chunk; else the register body,
// one CTA a chunk (`ctas` unused).
extern "C" int ring_gather_rows(const void* src, const void* idx, void* out,
                                long long n, long long w, long long m,
                                int elem_bytes, int chunk, int rif, int ctas,
                                void* stream) {
  if (m <= 0 || w <= 0) return 0;
  if (n < 1 || (elem_bytes != 4 && elem_bytes != 2) || chunk < 1 ||
      rif < 1 || rif > ring::kMaxRif || ctas < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_bytes = w * elem_bytes;
  const int mode = rows::pick(row_bytes, src, out);
  const long long pitch = (row_bytes + 15) / 16 * 16;
  const long long grid = (m + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == rows::kVec16) {
    const long long smem = pitch * rif + 8LL * rif;
    if (smem > (1 << 30)) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        ring_gather_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long g = ctas > 0 && ctas < grid ? ctas : grid;
    ring_gather_bulk_kernel<<<(unsigned)g, 1, (size_t)smem, st>>>(
        static_cast<const unsigned char*>(src),
        static_cast<const int32_t*>(idx), static_cast<unsigned char*>(out), n,
        (uint32_t)row_bytes, m, chunk, rif);
    return (int)cudaGetLastError();
  }
  const long long smem = pitch * rif;
  if (smem > (1 << 30)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ring_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ring_gather_kernel<<<(unsigned)grid,
                       rows::threads_for(row_bytes, mode, kMaxThreads),
                       (size_t)smem, st>>>(
      static_cast<const unsigned char*>(src),
      static_cast<const int32_t*>(idx), static_cast<unsigned char*>(out), n,
      row_bytes, m, chunk, rif, (int)pitch, mode);
  return (int)cudaGetLastError();
}
