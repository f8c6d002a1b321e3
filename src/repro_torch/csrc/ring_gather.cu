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
// A row larger than one ring slot can be (the TPU kernel takes any
// (1, W) row into VMEM; here 227 KB of shared memory hold one slot at
// most) moves in pieces: the wrapper passes `piece` bytes, a multiple
// of 16, and both bodies walk a stream of (row, piece) items, piece p
// of row k being item k * pieces + p, the last piece of a row the
// ragged rest.  Then `chunk` and `rif` count pieces; rows that fit a
// slot are one piece each, and nothing changes for them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "ring.cuh"
#include "rows.cuh"

namespace {

constexpr int kMaxThreads = 256;

// Item v of the stream of (row, piece) items: row v / pieces, the
// piece's byte offset in the row and its bytes.  Whole rows
// (kPieces false) compute none of it: the bulk body at small rows is
// bound by its one thread's work a row.
struct Piece {
  long long row, offset, bytes;
};

template <bool kPieces>
__device__ __forceinline__ Piece piece_at(long long v, long long row_bytes,
                                          long long piece, int pieces) {
  if constexpr (kPieces) {
    const long long row = v / pieces, offset = (v - row * pieces) * piece;
    return Piece{row, offset, min(piece, row_bytes - offset)};
  } else {
    return Piece{v, 0, row_bytes};
  }
}

template <bool kPieces>
__global__ void __launch_bounds__(kMaxThreads)
ring_gather_kernel(const unsigned char* __restrict__ src,
                   const int32_t* __restrict__ idx,
                   unsigned char* __restrict__ out, long long n,
                   long long row_bytes, long long items, int chunk, int rif,
                   int pitch, int mode, long long piece, int pieces) {
  extern __shared__ __align__(16) unsigned char ring_buf[];
  const long long base = (long long)blockIdx.x * chunk;
  const int cnt = (int)min((long long)chunk, items - base);
  auto fetch = [&](int k, int slot) {
    const Piece p = piece_at<kPieces>(base + k, row_bytes, piece, pieces);
    const long long r = rows::clamp_index(__ldg(idx + p.row), n);
    rows::request(ring_buf + (size_t)slot * pitch,
                  src + r * row_bytes + p.offset, p.bytes, mode);
  };
  auto execute = [&](int k, int slot) {
    const Piece p = piece_at<kPieces>(base + k, row_bytes, piece, pieces);
    rows::store(out + p.row * row_bytes + p.offset,
                ring_buf + (size_t)slot * pitch, p.bytes, mode);
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

template <bool kPieces>
__global__ void __launch_bounds__(1)
ring_gather_bulk_kernel(const unsigned char* __restrict__ src,
                        const int32_t* __restrict__ idx,
                        unsigned char* __restrict__ out, long long n,
                        long long row_bytes, long long items, int chunk,
                        int rif, uint32_t pitch, long long piece,
                        int pieces) {
  extern __shared__ __align__(16) unsigned char ring_buf[];
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring_buf + (size_t)rif * pitch);
  for (int s = 0; s < rif; ++s) ring::mbar_init(&full[s], 1);
  ring::mbar_init_fence();
  // the CTA's items, chunk after chunk, as one stream q = 0 .. nq - 1:
  // the ring runs on across chunks
  const int nq = rows::stream_items(items, chunk);
  const long long stride = (long long)gridDim.x * chunk;
  auto slot = [&](int q) { return ring_buf + (size_t)(q % rif) * pitch; };
  // stream item q is piece v of the output, from row i of src
  auto request = [&](int q, long long v, int32_t i) {
    const Piece p = piece_at<kPieces>(v, row_bytes, piece, pieces);
    uint64_t* bar = &full[q % rif];
    ring::mbar_expect(bar, (uint32_t)p.bytes);
    ring::bulk_copy(slot(q),
                    src + rows::clamp_index(i, n) * row_bytes + p.offset,
                    (uint32_t)p.bytes, bar);
  };
  auto index = [&](long long v) {
    return __ldg(idx + (kPieces ? v / pieces : v));
  };
  Cursor cur{(long long)blockIdx.x * chunk, 0};
  Cursor ahead = cur;                  // after the prologue: rif items on
  for (int q = 0; q < min(nq, rif); ++q) {      // prologue
    request(q, ahead.row(), index(ahead.row()));
    ahead.advance(1, chunk, stride);
  }
  for (int q = 0; q < nq; ++q) {
    const bool more = q + rif < nq;
    // the next index's load overlaps the wait for this item
    const int32_t next = more ? index(ahead.row()) : 0;
    ring::mbar_wait(&full[q % rif], (uint32_t)(q / rif) & 1);
    ring::fence_proxy_async();
    const Piece p = piece_at<kPieces>(cur.row(), row_bytes, piece, pieces);
    ring::bulk_store(out + p.row * row_bytes + p.offset, slot(q),
                     (uint32_t)p.bytes);
    ring::bulk_commit();
    if (more) {
      ring::bulk_wait_read<0>();              // the store has read the slot
      request(q + rif, ahead.row(), next);
    }
    cur.advance(1, chunk, stride);
    ahead.advance(1, chunk, stride);
  }
  ring::bulk_wait<0>();                       // every row written
}

}  // namespace

// src (N, W) of elem_bytes 4 or 2, row-major; idx (M,) int32; out (M, W).
// Rows move in pieces of `piece` bytes (a multiple of 16; 0 or at least
// the row: whole rows).  `chunk` items per CTA, `rif` ring slots of one
// item each.  Rows and both base pointers 16-byte multiples: the bulk
// body on `ctas` CTAs (0: one a chunk), each taking every ctas-th chunk;
// else the register body, one CTA a chunk (`ctas` unused).
extern "C" int ring_gather_rows(const void* src, const void* idx, void* out,
                                long long n, long long w, long long m,
                                int elem_bytes, int chunk, int rif, int ctas,
                                long long piece, void* stream) {
  if (m <= 0 || w <= 0) return 0;
  if (n < 1 || (elem_bytes != 4 && elem_bytes != 2) || chunk < 1 ||
      rif < 1 || rif > ring::kMaxRif || ctas < 0 || piece < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_bytes = w * elem_bytes;
  if (piece == 0 || piece >= row_bytes) piece = row_bytes;
  if (piece < row_bytes && piece % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long pieces_ll = (row_bytes + piece - 1) / piece;
  if (pieces_ll > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int pieces = (int)pieces_ll;
  const long long items = m * pieces;
  const int mode = rows::pick(row_bytes, src, out);
  const long long pitch = (piece + 15) / 16 * 16;
  const long long grid = (items + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == rows::kVec16) {
    const long long smem = pitch * rif + 8LL * rif;
    if (smem > (1 << 30)) return (int)cudaErrorInvalidValue;
    const auto kernel = pieces > 1 ? ring_gather_bulk_kernel<true>
                                   : ring_gather_bulk_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long g = ctas > 0 && ctas < grid ? ctas : grid;
    kernel<<<(unsigned)g, 1, (size_t)smem, st>>>(
        static_cast<const unsigned char*>(src),
        static_cast<const int32_t*>(idx), static_cast<unsigned char*>(out), n,
        row_bytes, items, chunk, rif, (uint32_t)pitch, piece, pieces);
    return (int)cudaGetLastError();
  }
  const long long smem = pitch * rif;
  if (smem > (1 << 30)) return (int)cudaErrorInvalidValue;
  const auto kernel = pieces > 1 ? ring_gather_kernel<true>
                                 : ring_gather_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, rows::threads_for(piece, mode, kMaxThreads),
           (size_t)smem, st>>>(
      static_cast<const unsigned char*>(src),
      static_cast<const int32_t*>(idx), static_cast<unsigned char*>(out), n,
      row_bytes, items, chunk, rif, (int)pitch, mode, piece, pieces);
  return (int)cudaGetLastError();
}
