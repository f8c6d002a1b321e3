// Lock-step dependent chase for Hopper, specialised per traced program.
//
// Replaces src/repro/kernels/compiled/kernel.py::ring_chase (_chase_kernel),
// the compiler's template for a DEPENDENT stream: per item an int32
// state of width S, `max_steps` levels of addr_fn -> load of one port
// row of W int32 -> step_fn, then out_fn gives (store_addr, store_value).
//
// Bound on this card: the latency of dependent loads, and the integer
// work.  Each level's load waits on the previous level's step, so what
// the card can do is set by how many independent loads are in flight
// (Little's law: ~3.35 TB/s x ~1 us); the floor counted for a run is
// its distinct rows read once plus the state read and the outputs
// written over 3.35 TB/s, or its int32 operations over the card's
// integer rate, whichever is larger.
//
// Design.  The TPU kernel traces addr_fn/step_fn/out_fn into its body
// (kernel.py:180-209).  Here compile/chase.py traces them once into a
// register program and emits it as straight-line C++: a struct with
// `addr`, `step` and `out` over int32_t values held in registers, with
// constants as literals (so `// 2` is a shift), S and W as constants.
// A generated .cu includes this header, defines that struct and expands
// REPRO_CHASE_ENTRY, and kernels/common.py builds it at first use under
// build/repro_torch/chase/ (csrc/*.cu are built alone; this header is
// not).  The kernel:
//   * holds R items per thread (R = the wrapper's rif, a template
//     parameter from 1 to 16), their states in registers: no interpreter,
//     no local memory, no shared memory;
//   * per level computes every item's address and issues all R row loads
//     (plain vectorised loads of 4, 8, 16 or 2 x 16 bytes) before it
//     consumes any: those are its requests in flight;
//   * walks every item through exactly max_steps levels, clipped tail
//     loads included (Listing 5, kernel.py:192-200), so the results equal
//     compile/chase.py's run_numpy bit for bit;
//   * takes 128 threads a CTA, with __launch_bounds__ asking for as many
//     CTAs per SM as R items' registers allow (full occupancy at R <= 2
//     for small states).
// Arithmetic is numpy's int32: + - * wrap (done in uint32), // and %
// round toward minus infinity, x // 0 and x % 0 are 0, INT_MIN // -1
// wraps, compares give 0/1.  The helpers below compile for the host too,
// so the CPU tests run the generated functions under g++.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define REPRO_CHASE_FN __host__ __device__ __forceinline__
#else
#define REPRO_CHASE_FN inline
#endif

namespace chase {

// compile/chase.py's limits (MAX_STATE, MAX_ROW, MAX_REGS, MAX_INSTR):
// the tracer raises above them
constexpr int kMaxState = 8;
constexpr int kMaxRow = 8;
constexpr int kMaxRegs = 64;
constexpr int kMaxInstr = 512;

REPRO_CHASE_FN int32_t add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
REPRO_CHASE_FN int32_t sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
REPRO_CHASE_FN int32_t mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
REPRO_CHASE_FN int32_t neg(int32_t a) { return (int32_t)(0u - (uint32_t)a); }

REPRO_CHASE_FN int32_t fdiv(int32_t a, int32_t b) {
  if (b == 0) return 0;
  if (b == -1) return neg(a);              // INT_MIN // -1 wraps
  int32_t q = a / b;
  const int32_t r = a - q * b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}

REPRO_CHASE_FN int32_t fmod(int32_t a, int32_t b) {
  if (b == 0 || b == -1) return 0;
  int32_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

}  // namespace chase

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace chase {

constexpr int kThreads = 128;

// CTAs per SM to ask of __launch_bounds__: as many as the registers an
// item keeps across a level (its state and its row) allow, R items a
// thread, with room for the step's temporaries.
template <class P, int R>
struct Occupancy {
  static constexpr int regs = (R * (P::S + P::W) + 24 + 7) / 8 * 8;
  static constexpr int fit = 65536 / (kThreads * regs);
  static constexpr int value = fit < 1 ? 1 : (fit > 16 ? 16 : fit);
};

template <int W>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ src,
                                         int32_t (&row)[W]) {
  if constexpr (W == 1) {
    row[0] = __ldg(src);
  } else if constexpr (W == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(src));
    row[0] = x.x; row[1] = x.y;
  } else if constexpr (W == 4 || W == 8) {
#pragma unroll
    for (int q = 0; q < W; q += 4) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(src + q));
      row[q] = x.x; row[q + 1] = x.y; row[q + 2] = x.z; row[q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) row[q] = __ldg(src + q);
  }
}

// Item j of thread t in CTA c is (c * R + j) * kThreads + t, so each of
// the R state loads and output stores of a warp is coalesced.  Items past
// m shadow item m - 1 and store nothing.
template <class P, int R>
__global__ void __launch_bounds__(kThreads, (Occupancy<P, R>::value))
chase_kernel(const int32_t* __restrict__ port, long long n,
             const int32_t* __restrict__ state0,
             int32_t* __restrict__ out_addr, int32_t* __restrict__ out_val,
             long long m, int max_steps) {
  constexpr int S = P::S, W = P::W;
  const long long base = (long long)blockIdx.x * kThreads * R + threadIdx.x;
  int32_t st[R][S];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    long long item = base + (long long)j * kThreads;
    if (item >= m) item = m - 1;
#pragma unroll
    for (int q = 0; q < S; ++q) st[j][q] = __ldg(state0 + item * S + q);
  }
  for (int level = 0; level < max_steps; ++level) {
    int32_t row[R][W];
#pragma unroll
    for (int j = 0; j < R; ++j) {           // access: every request
      long long a = P::addr(st[j]);
      a = a < 0 ? 0 : (a >= n ? n - 1 : a);
      load_row<W>(port + a * W, row[j]);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {           // execute: every response
      int32_t next[S];
      P::step(st[j], row[j], next);
#pragma unroll
      for (int q = 0; q < S; ++q) st[j][q] = next[q];
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long item = base + (long long)j * kThreads;
    if (item < m) {
      int32_t oa, ov;
      P::out(st[j], oa, ov);
      out_addr[item] = oa;
      out_val[item] = ov;
    }
  }
}

template <class P, int R>
int launch_items(const void* port, long long n, const void* state0,
                 void* out_addr, void* out_val, long long m, int max_steps,
                 void* stream) {
  const long long per_cta = (long long)kThreads * R;
  const long long grid = (m + per_cta - 1) / per_cta;
  chase_kernel<P, R><<<(unsigned)grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(port), n,
      static_cast<const int32_t*>(state0), static_cast<int32_t*>(out_addr),
      static_cast<int32_t*>(out_val), m, max_steps);
  return (int)cudaGetLastError();
}

template <class P>
int launch(const void* port, long long n, const void* state0, void* out_addr,
           void* out_val, long long m, int items, int max_steps,
           void* stream) {
  static_assert(P::S >= 1 && P::S <= kMaxState, "state width");
  static_assert(P::W >= 1 && P::W <= kMaxRow, "row width");
  if (m <= 0) return 0;
  if (n < 1 || max_steps < 0) return (int)cudaErrorInvalidValue;
#define REPRO_CHASE_R(R)                                                   \
  case R: return launch_items<P, R>(port, n, state0, out_addr, out_val, m, \
                                    max_steps, stream);
  switch (items) {
    REPRO_CHASE_R(1) REPRO_CHASE_R(2) REPRO_CHASE_R(3) REPRO_CHASE_R(4)
    REPRO_CHASE_R(5) REPRO_CHASE_R(6) REPRO_CHASE_R(7) REPRO_CHASE_R(8)
    REPRO_CHASE_R(9) REPRO_CHASE_R(10) REPRO_CHASE_R(11) REPRO_CHASE_R(12)
    REPRO_CHASE_R(13) REPRO_CHASE_R(14) REPRO_CHASE_R(15) REPRO_CHASE_R(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_CHASE_R
}

}  // namespace chase

// The C entry point of one program's library: port (N, W) int32 rows;
// state0 (M, S) int32 row-major; out_addr and out_val (M,) int32; each
// thread walks `items` items (1 .. 16, kernels/ring.py MAX_RIF).  S and
// W are the program's own.
#define REPRO_CHASE_ENTRY(PROG)                                              \
  extern "C" int ring_chase_items(const void* port, long long n,            \
                                  const void* state0, void* out_addr,       \
                                  void* out_val, long long m, int items,    \
                                  int max_steps, void* stream) {            \
    return chase::launch<PROG>(port, n, state0, out_addr, out_val, m, items, \
                               max_steps, stream);                          \
  }

#endif  // __CUDACC__
