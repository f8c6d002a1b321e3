// Decoupled block-sparse matrix-vector product for Hopper (paper
// Listing 2): out[row_ids[i]] += val_blocks[i] @ vec_tiles[col_ids[i]].
//
// Replaces src/repro/kernels/dae_spmv/kernel.py::bsr_spmv (_spmv_kernel).
// There one output block row accumulates across consecutive grid steps
// (ring_step over the whole block stream, the first step of a row
// zeroing it), which relies on the TPU running its grid in order.  CUDA
// blocks run in no order, so here one CTA owns one whole block row.
//
// Bound on this card: bytes.  Each (BM, BK) float32 block is read once
// and used for 2 * BM * BK flops, 0.5 flop per byte; the floor is the
// blocks, the vector tiles they touch, the ids and the output over
// 3.35 TB/s.
//
// Design: CTA r finds its range of blocks [start, end) in the sorted
// row_ids on the device (two warp-wide 32-ary searches, about five
// dependent loads each at 500,000 blocks; no host sync, no row-pointer
// array), then streams its blocks through the csrc/ring.cuh ring: a
// stage holds one value block and the vector tile col_ids[i] picks, and
// `rif` stages are in flight (4.6 KB each at 8 x 128, so 74 KB at rif
// 16; three CTAs per SM keep about 220 KB in flight).  Warp m owns row m
// of the block row: each lane multiplies float4s of the row and of the
// tile and keeps one float32 partial, summed in block order; a butterfly
// across the lanes then gives the row's value.  The order is fixed, so
// the result is deterministic and needs no atomics; it differs from
// XLA's scatter-add order in the last bits.  8 rows is too few for the
// tensor cores, and the kernel needs none.  A block row with no block
// comes out as zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "ring.cuh"

namespace {

constexpr int kMaxRows = 32;          // BM: one warp per row of a block

// First index i in [0, n) with ids[i] >= key (n if none), ids sorted
// ascending.  The whole warp calls it with the same arguments: 32 probes
// split [lo, hi) into 33 parts per round.
__device__ __forceinline__ long long warp_lower_bound(
    const int32_t* __restrict__ ids, long long n, int key) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long p = lo + (hi - lo) * (lane + 1) / 33;      // lo <= p < hi
    const unsigned ge = __ballot_sync(0xffffffffu, __ldg(ids + p) >= key);
    const long long p_last = __shfl_sync(0xffffffffu, p, 31);
    const int f = ge ? __ffs(ge) - 1 : 0;
    const long long p_f = __shfl_sync(0xffffffffu, p, f);
    const long long p_before = __shfl_sync(0xffffffffu, p, f > 0 ? f - 1 : 0);
    if (ge == 0) {
      lo = p_last + 1;
    } else {
      hi = p_f;
      if (f > 0) lo = p_before + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kMaxRows * 32)
bsr_spmv_kernel(const float* __restrict__ val,
                const int32_t* __restrict__ row_ids,
                const int32_t* __restrict__ col_ids,
                const float* __restrict__ vec, float* __restrict__ out,
                long long nb, long long kb, int bm, int bk, int rif) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring_buf = reinterpret_cast<float*>(smem);
  const int block_elems = bm * bk;
  const int stage = block_elems + bk;                 // floats per ring slot
  const int r = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const long long start = warp_lower_bound(row_ids, nb, r);
  const long long end = warp_lower_bound(row_ids, nb, r + 1);
  const int n = (int)(end - start);

  auto fetch = [&](int k, int slot) {
    const long long i = start + k;
    float* dst = ring_buf + (size_t)slot * stage;
    long long col = __ldg(col_ids + i);
    col = col < 0 ? 0 : (col >= kb ? kb - 1 : col);
    ring::request_rows(dst, 0, val + i * block_elems, 0, 1,
                       block_elems * (int)sizeof(float));
    ring::request_rows(dst + block_elems, 0, vec + col * bk, 0, 1,
                       bk * (int)sizeof(float));
  };
  float acc = 0.f;
  auto execute = [&](int k, int slot) {
    const float* s = ring_buf + (size_t)slot * stage;
    const float4* a = reinterpret_cast<const float4*>(s + warp * bk);
    const float4* x = reinterpret_cast<const float4*>(s + block_elems);
    for (int q = lane; q < bk / 4; q += 32) {
      const float4 av = a[q], xv = x[q];
      acc = fmaf(av.x, xv.x, acc);
      acc = fmaf(av.y, xv.y, acc);
      acc = fmaf(av.z, xv.z, acc);
      acc = fmaf(av.w, xv.w, acc);
    }
  };
  ring::access_execute(n, rif, fetch, execute);

  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[(long long)r * bm + warp] = acc;
}

}  // namespace

// val (NB, BM, BK) float32; row_ids (NB,) int32 sorted ascending;
// col_ids (NB,) int32; vec (KB, BK) float32; out (NRB, BM) float32.
extern "C" int dae_bsr_spmv(const void* val, const void* row_ids,
                            const void* col_ids, const void* vec, void* out,
                            long long nb, long long nrb, long long kb, int bm,
                            int bk, int rif, void* stream) {
  if (nrb <= 0) return 0;
  if (bm < 1 || bm > kMaxRows || bk < 4 || bk % 4 != 0 || kb < 1 ||
      rif < 1 || rif > ring::kMaxRif || nb < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)rif * (bm * bk + bk) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bsr_spmv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  bsr_spmv_kernel<<<(unsigned)nrb, bm * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(val), static_cast<const int32_t*>(row_ids),
      static_cast<const int32_t*>(col_ids), static_cast<const float*>(vec),
      static_cast<float*>(out), nb, kb, bm, bk, rif);
  return (int)cudaGetLastError();
}
