// Decoupled merge of sorted runs for Hopper (paper Listing 3, merge-path
// form): output tile t is the T smallest of a[sa[t] : sa[t] + T] and
// b[sb[t] : sb[t] + T], where elements at or past ea[t] (eb[t]) read as
// the +inf / INT_MAX sentinel.
//
// Replaces src/repro/kernels/dae_merge/kernel.py::merge_tiles
// (_merge_kernel, with bitonic_merge_first_half).  There the splits are
// scalar-prefetched and two rings DMA the windows `rif` grid steps
// ahead; the windows are padded with sentinels by copying each run.
// Here the per-tile ends take the place of that padding, so one launch
// merges every pair of runs of a merge-sort pass: a window stops at its
// own run's end, wherever the next run starts.
//
// Bound on this card: bytes.  A tile reads 2T elements and writes T, with
// T log T compares; the floor is each input read once and each output
// written once over 3.35 TB/s.
//
// Design: one CTA of T threads walks `per_cta` consecutive tiles through
// the csrc/ring.cuh ring, `rif` window pairs in flight (2 KB per pair at
// T 256 int32).  The windows start at any element, so each thread issues
// 4-byte cp.async copies (ring::copy4), coalesced across the warp, or
// stores a sentinel past the run's end.  The merge: with
// v = a_win ++ reverse(b_win) bitonic, the first stage of the network
// leaves the T smallest in the lower half, min(a[i], b[T-1-i]), itself
// bitonic; the remaining log2 T stages sort it, one element per thread,
// through shared memory for distances of 32 and more and by warp
// shuffles below.  This is the lower half of the reference's full
// network, so the output is the same, element for element.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include "exports.cuh"
#include "ring.cuh"

namespace {

constexpr int kMaxTile = 1024;

template <typename T>
__device__ __forceinline__ T lower(T x, T y) { return y < x ? y : x; }
template <typename T>
__device__ __forceinline__ T upper(T x, T y) { return y < x ? x : y; }

template <typename T>
__global__ void __launch_bounds__(kMaxTile)
merge_tiles_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const int32_t* __restrict__ sa,
                   const int32_t* __restrict__ ea,
                   const int32_t* __restrict__ sb,
                   const int32_t* __restrict__ eb, T* __restrict__ out,
                   long long n_out, int n_tiles, int tile, int per_cta,
                   int rif, T big) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring_buf = reinterpret_cast<T*>(smem);        // rif x [a win | b win]
  T* scratch = ring_buf + (size_t)rif * 2 * tile;  // one tile
  const int first = blockIdx.x * per_cta;
  const int cnt = min(per_cta, n_tiles - first);
  const int i = threadIdx.x;                       // blockDim.x == tile
  const unsigned lanes =
      tile >= 32 ? 0xffffffffu : ((1u << tile) - 1u);

  auto fetch = [&](int k, int slot) {
    const int t = first + k;
    T* wa = ring_buf + (size_t)slot * 2 * tile;
    T* wb = wa + tile;
    const long long ia = (long long)__ldg(sa + t) + i;
    const long long ib = (long long)__ldg(sb + t) + i;
    if (ia < __ldg(ea + t)) ring::copy4(wa + i, a + ia); else wa[i] = big;
    if (ib < __ldg(eb + t)) ring::copy4(wb + i, b + ib); else wb[i] = big;
  };
  auto execute = [&](int k, int slot) {
    const T* wa = ring_buf + (size_t)slot * 2 * tile;
    const T* wb = wa + tile;
    T v = lower(wa[i], wb[tile - 1 - i]);
    for (int d = tile >> 1; d >= 32; d >>= 1) {
      scratch[i] = v;
      __syncthreads();
      const T o = scratch[i ^ d];
      __syncthreads();
      v = (i & d) ? upper(v, o) : lower(v, o);
    }
    for (int d = min(tile >> 1, 16); d >= 1; d >>= 1) {
      const T o = __shfl_xor_sync(lanes, v, d);
      v = (i & d) ? upper(v, o) : lower(v, o);
    }
    const long long pos = (long long)(first + k) * tile + i;
    if (pos < n_out) out[pos] = v;
  };
  ring::access_execute(cnt, rif, fetch, execute);
}

template <typename T>
int launch(const void* a, const void* b, const void* sa, const void* ea,
           const void* sb, const void* eb, void* out, long long n_out,
           int n_tiles, int tile, int per_cta, int rif, T big, void* stream) {
  const size_t smem = (size_t)(rif * 2 + 1) * tile * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      merge_tiles_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n_tiles + per_cta - 1) / per_cta;
  merge_tiles_kernel<T><<<grid, tile, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int32_t*>(sa), static_cast<const int32_t*>(ea),
      static_cast<const int32_t*>(sb), static_cast<const int32_t*>(eb),
      static_cast<T*>(out), n_out, n_tiles, tile, per_cta, rif, big);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b int32 or float32 (is_float) runs; sa, ea, sb, eb (n_tiles,) int32
// window starts and run ends, in elements; out (n_out,) with
// n_out <= n_tiles * tile.  tile a power of two, 2 .. 1024.
extern "C" int dae_merge_tiles(const void* a, const void* b, const void* sa,
                               const void* ea, const void* sb, const void* eb,
                               void* out, long long n_out, int n_tiles,
                               int tile, int per_cta, int rif, int is_float,
                               void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile < 2 || tile > kMaxTile || (tile & (tile - 1)) != 0 ||
      per_cta < 1 || rif < 1 || rif > ring::kMaxRif) {
    return (int)cudaErrorInvalidValue;
  }
  return is_float
             ? launch<float>(a, b, sa, ea, sb, eb, out, n_out, n_tiles, tile,
                             per_cta, rif, INFINITY, stream)
             : launch<int32_t>(a, b, sa, ea, sb, eb, out, n_out, n_tiles,
                               tile, per_cta, rif, INT32_MAX, stream);
}
