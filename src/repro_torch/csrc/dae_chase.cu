// Decoupled pointer chasing for Hopper: the block binary search and the
// lock-step hash-chain walk (paper §4.2, Listings 4 and 5).
//
// Replaces src/repro/kernels/dae_chase/kernel.py::searchsorted_blocks
// (_searchsorted_kernel) and ::hash_probe (_hash_probe_kernel).
//
// Bound on this card: bytes, and the latency of dependent loads.  Both
// kernels do a handful of compares per loaded byte, so the floor is the
// bytes their data needs over 3.35 TB/s.  What stands between a kernel
// and that floor is memory-level parallelism: by Little's law the card
// needs about 3.35 TB/s x ~1 us = ~3 MB in flight, so about 6,500
// 512-byte block probes or 100,000 16-byte entry loads outstanding.
//
// searchsorted_kernel.  ops.py resolves each key to the block holding
// its insertion point (a searchsorted on the first element of every
// block, the top of the B-tree); this kernel resolves the position
// inside the block.  One warp is one CTA and owns `chunk` keys: it
// stages their block ids and keys in shared memory (the TPU kernel's
// scalar prefetch), then walks them through the csrc/ring.cuh ring with
// `rif` block probes in flight, one 16-byte cp.async per lane for a
// 128-element block.  Each response is answered by one compare per
// element and a warp sum: the 'right' insertion point is
// blk * block + #{x in block : x <= key}, clipped to n (padding
// sentinels are +inf / INT_MAX, so they never count below a real key).
// In flight: rif * block * 4 bytes per CTA (8 KB at rif 16), and about
// 23 such CTAs per SM by shared memory, some 190 KB per SM.
//
// hash_probe_kernel.  One thread per chain, `chunk` chains per CTA.  An
// entry is one 16-byte row [key, val, next, 0]: the TPU kernel padded it
// to a 512-byte row for the DMA granule (ENTRY_LANES = 128), here one
// vector load fetches it, 32x fewer bytes.  Each thread walks its chain
// level by level, up to max_steps levels, with one load in flight per
// live chain: a CTA of 64 chains keeps 64 loads in flight per level, and
// 32 CTAs per SM keep 2048.  A chain that resolved (hit) or died
// (pointer -1) is predicated off: it issues no further loads, where the
// TPU kernel (Listing 5) keeps re-requesting its clipped address to keep
// the request/response pairing structural.  The output is the same
// either way; the GPU has no pairing to keep, and the skipped loads are
// pure bandwidth.  A pointer past the table reads its last entry, as the
// reference's clip does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "ring.cuh"

namespace {

constexpr int kSearchThreads = 32;   // one warp per CTA
constexpr int kMaxChunk = 1024;      // keys a CTA stages; threads a hash CTA runs

template <typename T>
__global__ void __launch_bounds__(kSearchThreads)
searchsorted_kernel(const T* __restrict__ tiles,
                    const int32_t* __restrict__ blk,
                    const T* __restrict__ keys, int32_t* __restrict__ out,
                    long long nb, int block, long long m, long long n,
                    int chunk, int rif) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring_buf = reinterpret_cast<T*>(smem);                  // rif blocks
  int32_t* s_blk = reinterpret_cast<int32_t*>(ring_buf + (size_t)rif * block);
  T* s_key = reinterpret_cast<T*>(s_blk + chunk);
  const long long base = (long long)blockIdx.x * chunk;
  const int cnt = (int)min((long long)chunk, m - base);
  for (int k = threadIdx.x; k < cnt; k += kSearchThreads) {
    const int32_t b = __ldg(blk + base + k);
    s_blk[k] = b < 0 ? 0 : (b >= nb ? (int32_t)(nb - 1) : b);
    s_key[k] = __ldg(keys + base + k);
  }
  __syncthreads();

  const int row_bytes = block * (int)sizeof(T);
  auto fetch = [&](int k, int slot) {
    ring::request_rows(ring_buf + (size_t)slot * block, row_bytes,
                       tiles + (long long)s_blk[k] * block, row_bytes, 1,
                       row_bytes);
  };
  auto execute = [&](int k, int slot) {
    const T* row = ring_buf + (size_t)slot * block;
    const T key = s_key[k];
    int within = 0;
    for (int j = threadIdx.x; j < block; j += kSearchThreads) {
      within += row[j] <= key ? 1 : 0;
    }
    within = __reduce_add_sync(0xffffffffu, within);
    if (threadIdx.x == 0) {
      const long long idx = (long long)s_blk[k] * block + within;
      out[base + k] = (int32_t)(idx < n ? idx : n);
    }
  };
  ring::access_execute(cnt, rif, fetch, execute);
}

__global__ void __launch_bounds__(kMaxChunk)
hash_probe_kernel(const int4* __restrict__ packed,
                  const int32_t* __restrict__ heads,
                  const int32_t* __restrict__ keys, int32_t* __restrict__ out,
                  long long n, long long m, int max_steps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  long long cur = __ldg(heads + i);
  const int32_t key = __ldg(keys + i);
  int32_t val = -1;
  for (int s = 0; s < max_steps && cur >= 0; ++s) {
    const int4 e = __ldg(packed + (cur < n ? cur : n - 1));   // [key, val, next, 0]
    if (e.x == key) {
      val = e.y;
      break;
    }
    cur = e.z;
  }
  out[i] = val;
}

template <typename T>
int launch_search(const void* tiles, const void* blk, const void* keys,
                  void* out, long long nb, int block, long long m, long long n,
                  int chunk, int rif, void* stream) {
  const size_t smem = (size_t)rif * block * sizeof(T) +
                      (size_t)chunk * (sizeof(int32_t) + sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      searchsorted_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (m + chunk - 1) / chunk;
  searchsorted_kernel<T><<<(unsigned)grid, kSearchThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tiles), static_cast<const int32_t*>(blk),
      static_cast<const T*>(keys), static_cast<int32_t*>(out), nb, block, m,
      n, chunk, rif);
  return (int)cudaGetLastError();
}

}  // namespace

// tiles (NB, block) int32 or float32 (is_float), sorted and padded with
// sentinels; blk (M,) int32 block of each key; keys (M,) in the tiles'
// type; out (M,) int32.
extern "C" int dae_searchsorted_blocks(const void* tiles, const void* blk,
                                       const void* keys, void* out,
                                       long long nb, int block, long long m,
                                       long long n, int chunk, int rif,
                                       int is_float, void* stream) {
  if (m <= 0) return 0;
  if (nb < 1 || block < 4 || block % 4 != 0 || chunk < 1 ||
      chunk > kMaxChunk || rif < 1 || rif > ring::kMaxRif) {
    return (int)cudaErrorInvalidValue;
  }
  return is_float ? launch_search<float>(tiles, blk, keys, out, nb, block, m,
                                         n, chunk, rif, stream)
                  : launch_search<int32_t>(tiles, blk, keys, out, nb, block,
                                           m, n, chunk, rif, stream);
}

// packed (N, 4) int32 rows [key, val, next, 0]; heads, keys, out (M,)
// int32.  `chunk` chains per CTA.
extern "C" int dae_hash_probe(const void* packed, const void* heads,
                              const void* keys, void* out, long long n,
                              long long m, int chunk, int max_steps,
                              void* stream) {
  if (m <= 0) return 0;
  if (n < 1 || chunk < 1 || chunk > kMaxChunk || max_steps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long grid = (m + chunk - 1) / chunk;
  hash_probe_kernel<<<(unsigned)grid, chunk, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(packed), static_cast<const int32_t*>(heads),
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(out), n, m,
      max_steps);
  return (int)cudaGetLastError();
}
