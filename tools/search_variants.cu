// Kernels that tools/ring_sweep.py's `search` part times beside the
// package's searchsorted_blocks (csrc/dae_chase.cu); none is part of the
// package.  Built at first use like a chase program's kernel, with
// src/repro_torch/csrc on the include path.
//
// search_units: the package's searchsorted_kernel, included from
// csrc/dae_chase.cu, at the unit sizes the package does not launch: 32
// and 128 bytes (2 and 8 lanes a key) beside its 64.
//
// calib_reads: the cost of a random access on the card, by size and by
// dependence.  L lanes own one key and read one unit of 16 * L bytes of
// the key's block with one 16-byte load each; each lane group keeps K
// keys in flight.  With `depth` above 1 the next unit of a key depends
// on the sum of the one before, so its read waits for it: `depth`
// dependent reads a key.  The sums go to `out` so no read is dead.
//
// search_bulk: the other design of the block search, the whole block
// by bulk copy (PERF.md §6).  Persistent CTAs of one producer warp and
// four consumer warps walk their chunks of keys as one stream; lane 0
// of the producer copies each key's block into a `slots`-deep ring of
// mbarrier slots with one cp.async.bulk, a consumer warp counts
// #{x <= key} over the landed block and frees the slot.  No CTA barrier
// sits between keys.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dae_chase.cu"
#include "ring.cuh"
#include "rows.cuh"

namespace {

template <int L, int K>
__global__ void __launch_bounds__(32)
calib_reads(const int32_t* __restrict__ tiles,
            const int32_t* __restrict__ blk, int32_t* __restrict__ out,
            long long nb, int block, long long m, int depth) {
  constexpr int E = 4 * L, G = 32 / L;
  const int g = threadIdx.x / L, r = threadIdx.x % L;
  const int units = block / E;
  const long long base = (long long)blockIdx.x * G * K;
  long long row[K];
  int u[K], acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const long long k = base + j * G + g;
    const int32_t b = k < m ? __ldg(blk + k) : 0;
    row[j] = (long long)(b < 0 ? 0 : (b >= nb ? nb - 1 : b)) * block;
    u[j] = units / 2;
    acc[j] = 0;
  }
  for (int d = 0; d < depth; ++d) {
    int4 v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = __ldg(reinterpret_cast<const int4*>(tiles + row[j] + u[j] * E +
                                                 4 * r));
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      int c = v[j].x + v[j].y + v[j].z + v[j].w;
#pragma unroll
      for (int o = 1; o < L; o <<= 1) c += __shfl_xor_sync(kFull, c, o);
      acc[j] += c;
      u[j] = (int)((unsigned)c % (unsigned)units);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const long long k = base + j * G + g;
    if (k < m && r == 0) out[k] = acc[j];
  }
}

template <int L>
int launch_calib(const int32_t* tiles, const int32_t* blk, int32_t* out,
                 long long nb, int block, long long m, int depth,
                 cudaStream_t st) {
  constexpr int K = 8;
  const long long grid = (m + (32 / L) * K - 1) / ((32 / L) * K);
  calib_reads<L, K><<<(unsigned)grid, 32, 0, st>>>(tiles, blk, out, nb,
                                                    block, m, depth);
  return (int)cudaGetLastError();
}

constexpr int kConsumers = 4;

// A place in a persistent CTA's stream of keys, as ring_gather.cu's
// Cursor: the key is base + k with k < chunk, and moving on crosses into
// the CTA's next chunk (no division on the producer's serial path).
struct Cursor {
  long long base;
  int k;
  __device__ __forceinline__ long long row() const { return base + k; }
  __device__ __forceinline__ void advance(int chunk, long long stride) {
    if (++k == chunk) {
      k = 0;
      base += stride;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(32 * (1 + kConsumers))
search_bulk(const T* __restrict__ tiles, const int32_t* __restrict__ blk,
            const T* __restrict__ keys, int32_t* __restrict__ out,
            long long nb, int block, long long m, long long n, int chunk,
            int slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bytes = (uint32_t)block * sizeof(T);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)slots * bytes);
  uint64_t* empty = full + slots;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      ring::mbar_init(&full[s], 1);
      ring::mbar_init(&empty[s], 1);
    }
    ring::mbar_init_fence();
  }
  __syncthreads();
  const int nq = rows::stream_items(m, chunk);
  auto item = [&](int q) -> long long {
    const int j = q / chunk;
    return ((long long)blockIdx.x + (long long)j * gridDim.x) * chunk +
           (q - j * chunk);
  };
  auto block_of = [&](long long k) -> long long {
    const int32_t b = __ldg(blk + k);
    return b < 0 ? 0 : (b >= nb ? nb - 1 : b);
  };
  if (warp == 0) {
    if (lane == 0) {
      const long long stride = (long long)gridDim.x * chunk;
      Cursor cur{(long long)blockIdx.x * chunk, 0};
      for (int q = 0; q < nq; ++q) {
        const int s = q % slots;
        if (q >= slots) ring::mbar_wait(&empty[s], (uint32_t)(q / slots - 1) & 1);
        ring::mbar_expect(&full[s], bytes);
        ring::bulk_copy(smem + (size_t)s * bytes,
                        tiles + block_of(cur.row()) * block, bytes, &full[s]);
        cur.advance(chunk, stride);
      }
    }
    return;
  }
  for (int q = warp - 1; q < nq; q += kConsumers) {
    const int s = q % slots;
    const long long k = item(q);
    const T key = __ldg(keys + k);
    const long long b = block_of(k);
    ring::mbar_wait(&full[s], (uint32_t)(q / slots) & 1);
    const T* row = reinterpret_cast<const T*>(smem + (size_t)s * bytes);
    int c = 0;
    for (int j = lane; j < block; j += 32) c += row[j] <= key;
    c = __reduce_add_sync(kFull, c);
    __syncwarp();
    if (lane == 0) {
      const long long idx = b * block + c;
      out[k] = (int32_t)(idx < n ? idx : n);
      ring::mbar_arrive(&empty[s]);
    }
  }
}

template <typename T>
int launch_bulk(const void* tiles, const void* blk, const void* keys,
                void* out, long long nb, int block, long long m, long long n,
                int chunk, int slots, long long ctas, cudaStream_t st) {
  const size_t smem = (size_t)slots * block * sizeof(T) + 16 * slots;
  cudaError_t e = cudaFuncSetAttribute(
      search_bulk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_chunks = (m + chunk - 1) / chunk;
  search_bulk<T><<<(unsigned)(ctas < n_chunks ? ctas : n_chunks),
                   32 * (1 + kConsumers), smem, st>>>(
      static_cast<const T*>(tiles), static_cast<const int32_t*>(blk),
      static_cast<const T*>(keys), static_cast<int32_t*>(out), nb, block, m,
      n, chunk, slots);
  return (int)cudaGetLastError();
}

}  // namespace

// tiles (NB, block) int32, blk and out (M,) int32: `depth` reads of
// `unit_bytes` (32 to 512) a key at its block; block a multiple of the
// unit's elements.
extern "C" int calib_random_reads(const void* tiles, const void* blk,
                                  void* out, long long nb, int block,
                                  long long m, int unit_bytes, int depth,
                                  void* stream) {
  auto t = static_cast<const int32_t*>(tiles);
  auto b = static_cast<const int32_t*>(blk);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || depth < 1 || block % (unit_bytes / 4) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (unit_bytes) {
    case 32: return launch_calib<2>(t, b, o, nb, block, m, depth, st);
    case 64: return launch_calib<4>(t, b, o, nb, block, m, depth, st);
    case 128: return launch_calib<8>(t, b, o, nb, block, m, depth, st);
    case 256: return launch_calib<16>(t, b, o, nb, block, m, depth, st);
    case 512: return launch_calib<32>(t, b, o, nb, block, m, depth, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The whole-block design: the arguments of dae_searchsorted_blocks, with
// `slots` ring slots a CTA and `ctas` persistent CTAs.
extern "C" int search_bulk_blocks(const void* tiles, const void* blk,
                                  const void* keys, void* out, long long nb,
                                  int block, long long m, long long n,
                                  int chunk, int slots, long long ctas,
                                  int is_float, void* stream) {
  if (m <= 0) return 0;
  if (nb < 1 || block < 4 || block % 4 != 0 || chunk < 1 || slots < 1 ||
      ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  return is_float ? launch_bulk<float>(tiles, blk, keys, out, nb, block, m,
                                       n, chunk, slots, ctas, st)
                  : launch_bulk<int32_t>(tiles, blk, keys, out, nb, block,
                                         m, n, chunk, slots, ctas, st);
}

// The package's unit search at `unit_bytes` 32, 64 or 128: the arguments
// of dae_searchsorted_blocks, whose `levels` the caller plans for the
// unit.
extern "C" int search_unit_blocks(const void* tiles, const void* blk,
                                  const void* keys, void* out, long long nb,
                                  int block, long long m, long long n,
                                  int chunk, int kpt, int unit_bytes,
                                  int levels, int is_float, void* stream) {
  switch (unit_bytes) {
    case 32:
      return search_blocks<2>(tiles, blk, keys, out, nb, block, m, n, chunk,
                              kpt, levels, is_float, stream);
    case 64:
      return search_blocks<4>(tiles, blk, keys, out, nb, block, m, n, chunk,
                              kpt, levels, is_float, stream);
    case 128:
      return search_blocks<8>(tiles, blk, keys, out, nb, block, m, n, chunk,
                              kpt, levels, is_float, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
