// One row of any width through a csrc/ring.cuh ring slot: the request
// side (global -> shared, asynchronous where the alignment allows) and
// the execute side (shared -> global), shared by ring_gather.cu and
// ring_deref.cu.
//
// A row is `bytes` bytes starting at `src`.  The mode is the widest unit
// that both the row size and every row start allow:
//   kVec16  16-byte cp.async.cg copies and int4 stores;
//   kWord4  4-byte cp.async.ca copies (ring::copy4) and 32-bit stores,
//           for 4-byte rows such as the compiler's W = 1 scalar ports;
//   kElem2  2-byte elements (bf16/f16 rows of odd width): cp.async has no
//           2-byte form, so these take a plain load through registers
//           into the slot.  The ring still orders them, but each thread's
//           loads are synchronous: the path is right, not fast.
// The ring slot is 16-byte aligned in every mode.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace rows {

enum Mode : int { kVec16 = 0, kWord4 = 1, kElem2 = 2 };

__host__ __device__ inline int unit(int mode) {
  return mode == kVec16 ? 16 : (mode == kWord4 ? 4 : 2);
}

// The widest mode for rows of `bytes` whose starts are `src` + k * bytes
// and `dst` + k * bytes.
inline int pick(long long bytes, const void* src, const void* dst) {
  const uintptr_t both = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst);
  if (bytes % 16 == 0 && both % 16 == 0) return kVec16;
  if (bytes % 4 == 0 && both % 4 == 0) return kWord4;
  return kElem2;
}

// Threads of a CTA that moves one row per step: one per unit, in whole
// warps, 32 to `max_threads`.
inline int threads_for(long long bytes, int mode, int max_threads) {
  long long t = (bytes / unit(mode) + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : (t > max_threads ? max_threads : t));
}

// Request side: issue this thread's share of the row's copies.
__device__ __forceinline__ void request(unsigned char* slot,
                                        const unsigned char* src,
                                        long long bytes, int mode) {
  const int step = unit(mode) * blockDim.x;
  long long c = (long long)threadIdx.x * unit(mode);
  if (mode == kVec16) {
    for (; c < bytes; c += step) ring::copy16(slot + c, src + c);
  } else if (mode == kWord4) {
    for (; c < bytes; c += step) ring::copy4(slot + c, src + c);
  } else {
    for (; c < bytes; c += step) {
      *reinterpret_cast<unsigned short*>(slot + c) =
          __ldg(reinterpret_cast<const unsigned short*>(src + c));
    }
  }
}

// Execute side: write the landed row out.
__device__ __forceinline__ void store(unsigned char* dst,
                                      const unsigned char* slot,
                                      long long bytes, int mode) {
  const int step = unit(mode) * blockDim.x;
  long long c = (long long)threadIdx.x * unit(mode);
  if (mode == kVec16) {
    for (; c < bytes; c += step) {
      *reinterpret_cast<int4*>(dst + c) =
          *reinterpret_cast<const int4*>(slot + c);
    }
  } else if (mode == kWord4) {
    for (; c < bytes; c += step) {
      *reinterpret_cast<uint32_t*>(dst + c) =
          *reinterpret_cast<const uint32_t*>(slot + c);
    }
  } else {
    for (; c < bytes; c += step) {
      *reinterpret_cast<unsigned short*>(dst + c) =
          *reinterpret_cast<const unsigned short*>(slot + c);
    }
  }
}

__device__ __forceinline__ long long clamp_index(long long r, long long n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

}  // namespace rows
