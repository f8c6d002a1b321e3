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
// needs about 3.35 TB/s x ~1 us = ~3 MB in flight.
//
// searchsorted_kernel.  ops.py resolves each key to the block holding
// its insertion point (a searchsorted on the first element of every
// block, the top of the B-tree); this kernel resolves the position
// inside the block: blk * block + #{x in block : x <= key}, clipped to
// n (padding sentinels are +inf / INT_MAX, so they count only for a key
// at the sentinel, which the clip then sends to n).  The TPU kernel
// fetched the whole block for every key.  Keys arrive in random order
// and the table is ten times the L2, so on this card the blocks of one
// key almost never meet another key's in cache, and what a key costs is
// its random DRAM accesses: tools/ring_sweep.py's `search` part times
// random reads by size and by dependence (PERF.md §6).  So a key reads
// only the units (16 * L bytes) its search needs:
//   * L lanes own one key; each lane loads one 16-byte slice of a unit,
//     so a warp instruction fetches 32 / L whole units;
//   * the search runs over the block's units [lo, hi): it reads unit
//     u = (lo + hi) / 2 whole and counts c = #{x in unit : x <= key}
//     over the group (a shuffle sum).  c = 0 puts the boundary before
//     the unit (hi = u), c = the unit's length after it (lo = u + 1),
//     anything else inside it, which ends the search at u * E + c.  An
//     empty range ends it at lo * E.  The count is of x <= key, so
//     duplicates and a boundary on a unit's edge fall out right: the
//     answer is the length of the prefix of x <= key, whatever repeats.
//     At most `levels` (the bit length of the block's unit count) reads;
//   * each lane group keeps K keys in flight: one level's reads of all
//     K keys are issued before any is used, and the warp runs a level
//     until no key of it is left (keys that ended are predicated off).
// The unit is 64 bytes (L = kLanes = 4): on the H100 a random read of up
// to 64 bytes costs one DRAM access, and from 128 bytes its bytes
// (PERF.md §6).  A block smaller than a unit is read as one unit whose
// lanes past the block's end count nothing.
// Arguments: `chunk` keys a CTA (one warp; the last CTA takes the ragged
// rest), walked in passes of 32 / L * K keys; `rif` sets K, the keys a
// lane group has in flight (the wrapper's plan: a power of two, at most
// 4 and at most what one chunk fills: at K = 4 a thread takes 63
// registers, so an SM holds its 32 one-warp CTAs; K = 8 takes 121 and
// halves them, and measured slower); `levels` comes from the host plan
// (kernel.py::search_plan).  The kernel is written for any L: the
// package launches kLanes only, tools/search_variants.cu the other unit
// sizes for the sweep.
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

namespace {

constexpr int kMaxChunk = 1024;      // keys a search CTA owns; threads a hash CTA runs
constexpr int kLanes = 4;            // lanes a key: 64-byte units
constexpr unsigned kFull = 0xffffffffu;   // every lane of a warp

// Four elements of the tiles' type from one 16-byte load.
template <typename T> struct Quad;
template <> struct Quad<int32_t> {
  using V = int4;
};
template <> struct Quad<float> {
  using V = float4;
};

template <typename T, int L, int K>
__global__ void __launch_bounds__(32)
searchsorted_kernel(const T* __restrict__ tiles,
                    const int32_t* __restrict__ blk,
                    const T* __restrict__ keys, int32_t* __restrict__ out,
                    long long nb, int block, long long m, long long n,
                    int chunk, int levels) {
  using V = typename Quad<T>::V;
  constexpr int E = 4 * L;             // elements a unit
  constexpr int G = 32 / L;            // lane groups a warp
  const int g = threadIdx.x / L;
  const int r = threadIdx.x % L;       // the lane's slice of a unit
  const int units = (block + E - 1) / E;
  const long long base = (long long)blockIdx.x * chunk;
  const int cnt = (int)min((long long)chunk, m - base);
  for (int p = 0; p < cnt; p += G * K) {
    T key[K];
    long long row[K];                  // first element of the key's block
    int lo[K], hi[K], res[K];          // res < 0 while the key searches
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = p + j * G + g;
      lo[j] = 0;
      hi[j] = units;
      res[j] = -1;
      row[j] = 0;
      key[j] = T(0);
      if (k < cnt) {
        const int32_t b = __ldg(blk + base + k);
        row[j] = (long long)(b < 0 ? 0 : (b >= nb ? nb - 1 : b)) * block;
        key[j] = __ldg(keys + base + k);
      } else {
        res[j] = 0;                    // no key: never searches
      }
    }
    for (int lvl = 0; lvl < levels; ++lvl) {
      V v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {    // every read of the level in flight
        const int s = ((lo[j] + hi[j]) >> 1) * E + 4 * r;
        if (res[j] < 0 && s < block) {
          v[j] = __ldg(reinterpret_cast<const V*>(tiles + row[j] + s));
        }
      }
      bool live = false;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int u = (lo[j] + hi[j]) >> 1;
        const int s = u * E + 4 * r;
        int c = 0;
        if (res[j] < 0 && s < block) {
          c = (v[j].x <= key[j]) + (v[j].y <= key[j]) + (v[j].z <= key[j]) +
              (v[j].w <= key[j]);
        }
#pragma unroll
        for (int o = 1; o < L; o <<= 1) c += __shfl_xor_sync(kFull, c, o);
        if (res[j] < 0) {
          const int len = min(E, block - u * E);
          if (c == 0) {
            hi[j] = u;
          } else if (c == len) {
            lo[j] = u + 1;
          } else {
            res[j] = u * E + c;
          }
          if (res[j] < 0 && lo[j] == hi[j]) res[j] = min(lo[j] * E, block);
          live |= res[j] < 0;
        }
      }
      if (!__any_sync(kFull, live)) break;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = p + j * G + g;
      if (k < cnt && r == 0) {
        const long long idx = row[j] + res[j];
        out[base + k] = (int32_t)(idx < n ? idx : n);
      }
    }
  }
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

template <typename T, int L>
int launch_search(const void* tiles, const void* blk, const void* keys,
                  void* out, long long nb, int block, long long m, long long n,
                  int chunk, int kpt, int levels, void* stream) {
  auto t = static_cast<const T*>(tiles);
  auto b = static_cast<const int32_t*>(blk);
  auto k = static_cast<const T*>(keys);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const long long grid = (m + chunk - 1) / chunk;
#define SEARCH_K(K)                                                        \
  case K:                                                                  \
    searchsorted_kernel<T, L, K><<<(unsigned)grid, 32, 0, st>>>(           \
        t, b, k, o, nb, block, m, n, chunk, levels);                       \
    break;
  switch (kpt) {
    SEARCH_K(1)
    SEARCH_K(2)
    SEARCH_K(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SEARCH_K
  return (int)cudaGetLastError();
}

// The C entry's checks, for the unit of L lanes.
template <int L>
int search_blocks(const void* tiles, const void* blk, const void* keys,
                  void* out, long long nb, int block, long long m, long long n,
                  int chunk, int kpt, int levels, int is_float, void* stream) {
  if (m <= 0) return 0;
  if (nb < 1 || block < 4 || block % 4 != 0 || chunk < 1 ||
      chunk > kMaxChunk || levels < 1 ||
      reinterpret_cast<uintptr_t>(tiles) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return is_float
             ? launch_search<float, L>(tiles, blk, keys, out, nb, block, m,
                                       n, chunk, kpt, levels, stream)
             : launch_search<int32_t, L>(tiles, blk, keys, out, nb, block,
                                         m, n, chunk, kpt, levels, stream);
}

}  // namespace

// tiles (NB, block) int32 or float32 (is_float), sorted and padded with
// sentinels, 16-byte aligned; blk (M,) int32 block of each key; keys (M,)
// in the tiles' type; out (M,) int32.  `chunk` keys a CTA, `kpt` keys a
// lane group in flight (1, 2 or 4), at most `levels` 64-byte unit reads
// a key.
extern "C" int dae_searchsorted_blocks(const void* tiles, const void* blk,
                                       const void* keys, void* out,
                                       long long nb, int block, long long m,
                                       long long n, int chunk, int kpt,
                                       int levels, int is_float,
                                       void* stream) {
  return search_blocks<kLanes>(tiles, blk, keys, out, nb, block, m, n, chunk,
                               kpt, levels, is_float, stream);
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
