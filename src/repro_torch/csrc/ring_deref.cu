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
// 3.35 TB/s.  The index words are random 4-byte reads, so each costs a
// 32-byte sector: the index hop alone is a random gather of M words.
//
// Design.  The TPU kernel's two phases become two streams that overlap:
// the index stream runs ahead of the row stream, so no row waits for the
// whole bank.  Persistent one-warp CTAs (the wrapper sizes their count
// to the card) each walk their chunks (blockIdx.x, + gridDim.x, ...) as
// one stream of items, in batches of 32, one item a lane:
//   * the index hop: lane l loads the address of its item (coalesced),
//     one batch before it loads a[address] (32 independent loads in
//     flight), then writes out_a (coalesced) and banks the item's row of
//     b, clip(va + offset, 0, NB - 1), and its place in the output.  The
//     bank is a ring of `rif_a` + 1 batches in shared memory: the CUDA
//     form of the TPU kernel's SMEM address bank (kernel.py:104-107),
//     and the channel between the streams.  The hop of batch i + rif_a
//     + 1 is issued before batch i's rows are waited for, and lands in
//     batch i's bank slot once they are out;
//   * the rows of batch i, by the warp's registers: the warp loads the
//     batch's rows, eight units a lane in flight, then stores them, in
//     16-byte units where the row size and both bases are 16-byte
//     multiples and in 4-byte units elsewhere (the C entry picks from
//     the rows, as csrc/rows.cuh's pick does for ring_gather.cu).  The
//     rows are 4 or 128 bytes on the paths; there the register body was
//     faster than one cp.async.bulk a row through ring_gather.cu's row
//     ring (PERF.md §6), whose single issuing lane waits once a row for
//     its store to read the slot.
// Arguments: `chunk` items a chunk of a CTA's stream; `rif_a` the
// batches of 32 the index stream runs ahead of the rows (the bank holds
// rif_a + 1); `rif_b`, the TPU kernel's row slots, has no counterpart in
// the register body, which moves a whole batch at a time: the wrapper
// checks it and does not pass it on.
// The add is done in 64 bits, so va + offset never wraps before the clip.
// Addresses are clamped into [0, NA).  The last chunk may be ragged.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "ring.cuh"
#include "rows.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kUnroll = 8;           // a lane's loads in flight

// The rows' unit by csrc/rows.cuh's mode: 16 bytes (kVec16) or 4 bytes.
template <int P> struct Unit {
  using V = uint32_t;
};
template <> struct Unit<rows::kVec16> {
  using V = int4;
};

// The warp copies the `n` rows of one batch, unit by unit, row r from
// b[row[r]] to out_b[item[r]].
template <int P>
__device__ __forceinline__ void copy_batch(
    const unsigned char* __restrict__ b, unsigned char* __restrict__ out_b,
    uint32_t row_bytes, const int32_t* row, const long long* item, int n) {
  using V = typename Unit<P>::V;
  const int upr = (int)(row_bytes / sizeof(V));   // units a row
  const int total = n * upr;
  const int dr = kWarp / upr, dc = kWarp % upr;   // a step of 32 units
  int r = threadIdx.x / upr, c = threadIdx.x % upr;
  for (int t0 = threadIdx.x; t0 < total; t0 += kWarp * kUnroll) {
    V v[kUnroll];
    int rr[kUnroll], cc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      rr[u] = r;
      cc[u] = c;
      if (t0 + u * kWarp < total) {
        v[u] = __ldg(reinterpret_cast<const V*>(
            b + (long long)row[r] * row_bytes + (size_t)c * sizeof(V)));
      }
      c += dc;
      r += dr;
      if (c >= upr) {
        c -= upr;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u * kWarp < total) {
        *reinterpret_cast<V*>(out_b + item[rr[u]] * row_bytes +
                              (size_t)cc[u] * sizeof(V)) = v[u];
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kWarp)
ring_deref_kernel(const int32_t* __restrict__ a,
                  const unsigned char* __restrict__ b,
                  const int32_t* __restrict__ addrs,
                  int32_t* __restrict__ out_a, unsigned char* __restrict__ out_b,
                  long long na, long long nb, uint32_t row_bytes, long long m,
                  long long offset, int chunk, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the bank: depth batches of 32 items' places (int64) and rows of b
  // (int32)
  long long* bank_item = reinterpret_cast<long long*>(smem);
  int32_t* bank_row = reinterpret_cast<int32_t*>(bank_item + depth * kWarp);
  const int lane = threadIdx.x;
  const int span = depth * kWarp;      // the bank's items: stream q at q % span

  const int nq = rows::stream_items(m, chunk);
  const int nbat = (nq + kWarp - 1) / kWarp;
  auto item = [&](int q) -> long long {   // the item at stream place q
    const int j = q / chunk;
    return ((long long)blockIdx.x + (long long)j * gridDim.x) * chunk +
           (q - j * chunk);
  };
  auto bank = [&](int q, long long it, int32_t va) {
    out_a[it] = va;
    bank_item[q % span] = it;
    bank_row[q % span] = (int32_t)rows::clamp_index((long long)va + offset, nb);
  };

  // prologue: the first `depth` batches, every address load before every
  // index load
  const int pro = min(depth, nbat);
#pragma unroll 4
  for (int i = 0; i < pro; ++i) {
    const int q = i * kWarp + lane;
    if (q < nq) {
      const long long it = item(q);
      bank_item[q % span] = it;
      bank_row[q % span] = __ldg(addrs + it);
    }
  }
#pragma unroll 4
  for (int i = 0; i < pro; ++i) {
    const int q = i * kWarp + lane;
    if (q < nq) {
      bank(q, bank_item[q % span],
           __ldg(a + rows::clamp_index(bank_row[q % span], na)));
    }
  }
  __syncwarp();

  // the addresses of the batch `depth` on, loaded an iteration before
  // its index words
  int qn = depth * kWarp + lane;
  long long it_n = 0;
  int32_t ad_n = 0;
  if (qn < nq) {
    it_n = item(qn);
    ad_n = __ldg(addrs + it_n);
  }
  for (int i = 0; i < nbat; ++i) {
    // the hop of batch i + depth: its index load is in flight while the
    // rows of batch i move
    const int qh = qn;
    const long long it_h = it_n;
    int32_t va = 0;
    if (qh < nq) va = __ldg(a + rows::clamp_index(ad_n, na));
    qn += kWarp;
    if (qn < nq) {
      it_n = item(qn);
      ad_n = __ldg(addrs + it_n);
    }
    const int first = i * kWarp, n = min(kWarp, nq - first);
    copy_batch<P>(b, out_b, row_bytes, bank_row + first % span,
                  bank_item + first % span, n);
    __syncwarp();                     // batch i's bank slot is free
    if (qh < nq) bank(qh, it_h, va);
    __syncwarp();
  }
}

template <int P>
int launch(const void* a, const void* b, const void* addrs, void* out_a,
           void* out_b, long long na, long long nb, long long row_bytes,
           long long m, long long offset, int chunk, int depth,
           long long ctas, cudaStream_t st) {
  const size_t smem = 12 * kWarp * depth;    // 6.5 KB at rif_a 16
  ring_deref_kernel<P><<<(unsigned)ctas, kWarp, smem, st>>>(
      static_cast<const int32_t*>(a), static_cast<const unsigned char*>(b),
      static_cast<const int32_t*>(addrs), static_cast<int32_t*>(out_a),
      static_cast<unsigned char*>(out_b), na, nb, (uint32_t)row_bytes, m,
      offset, chunk, depth);
  return (int)cudaGetLastError();
}

}  // namespace

// a (NA, 1) int32; b (NB, WB) of 4-byte elements; addrs (M,) int32;
// out_a (M, 1) int32; out_b (M, WB).  `chunk` items a stream chunk, on
// `ctas` persistent one-warp CTAs (at most one a chunk); the index
// stream runs `rif_a` batches of 32 ahead of the rows.
extern "C" int ring_deref_rows(const void* a, const void* b, const void* addrs,
                               void* out_a, void* out_b, long long na,
                               long long nb, long long wb, long long m,
                               long long offset, int chunk, int rif_a,
                               long long ctas, void* stream) {
  if (m <= 0) return 0;
  if (na < 1 || nb < 1 || nb > (1LL << 31) || wb < 1 || chunk < 1 ||
      rif_a < 1 || rif_a > ring::kMaxRif || ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_bytes = wb * 4;
  const int mode = rows::pick(row_bytes, b, out_b);
  if (row_bytes > 0xffffffffLL || mode == rows::kElem2) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_chunks = (m + chunk - 1) / chunk;
  const long long g = ctas < n_chunks ? ctas : n_chunks;
  const int depth = rif_a + 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mode == rows::kVec16
             ? launch<rows::kVec16>(a, b, addrs, out_a, out_b, na, nb,
                                    row_bytes, m, offset, chunk, depth, g, st)
             : launch<rows::kWord4>(a, b, addrs, out_a, out_b, na, nb,
                                    row_bytes, m, offset, chunk, depth, g,
                                    st);
}
