// Lock-step dependent chase for Hopper, specialised per traced program.
//
// Replaces src/repro/kernels/compiled/kernel.py::ring_chase (_chase_kernel),
// the compiler's template for a DEPENDENT stream: per item an int32
// state of width S, `max_steps` levels of addr_fn -> load of one port
// row of W int32 -> step_fn, then out_fn gives (store_addr, store_value).
// The TPU kernel takes any S and W: its state sits in SMEM and its rows
// stream through a VMEM ring.  So does this one, on three paths.
//
// Bound on this card: the latency of dependent row loads, then the bytes
// of the distinct rows, then the integer work.  Each level's load waits
// on the previous level's step, so what the card can do is set by how
// many independent rows are in flight (Little's law: ~3.35 TB/s x ~1 us);
// the floor counted for a run is its distinct rows read once plus the
// state read and the outputs written over 3.35 TB/s, or its int32
// operations over the card's integer rate, whichever is larger.
//
// Design.  The TPU kernel traces addr_fn/step_fn/out_fn into its body
// (kernel.py:180-209).  Here compile/chase.py traces them once into a
// register program and emits it as straight-line C++: a struct with
// `addr`, `step` and `out` templates over int32_t values held in
// registers, with constants as literals (so `// 2` is a shift), S and W
// as constants, and each input word read where it is first used (so a
// step that reads 3 words of a 1024-word row loads 3).  `step` may write
// its result over its input state: it reads every input it needs before
// it stores any.  A generated .cu includes this header, defines that
// struct and expands REPRO_CHASE_ENTRY, and kernels/common.py builds it
// at first use under build/repro_torch/chase/ (csrc/*.cu are built
// alone; this header is not).  launch<P> takes the path the wrapper
// names (kernels/compiled/kernel.py::chase_path, planned_path below);
// a path a program's library does not hold returns an error.
//
// The register path (S <= kRegState and W <= kRegRow):
//   * holds R items per thread (R = the wrapper's rif, a template
//     parameter from 1 to 16), their states and rows in registers: no
//     interpreter, no local memory, no shared memory;
//   * per level computes every item's address and issues all R row loads
//     (plain vectorised loads of 4, 8, 16 or 2 x 16 bytes) before it
//     consumes any: those are its requests in flight;
//   * takes 128 threads a CTA, with __launch_bounds__ asking for as many
//     CTAs per SM as R items' registers allow (full occupancy at R <= 2
//     for small states).
//
// The shared-memory path (anything wider, up to rows of kStreamRow
// words where one warp's R = 1 region fits), the ring of ROADMAP's north
// star: each warp owns 32 x R items (item j of lane l is slot j * 32 + l)
// and a region of dynamic shared memory holding one row per item, the
// items' addresses and, where the state does not fit registers, the
// states:
//   * per level every lane writes its R addresses, then the warp copies
//     all 32 x R rows with cp.async, the row's 16-byte units spread over
//     the lanes (so a warp instruction moves neighbouring units of few
//     rows), one commit group per level and one wait before the execute
//     half: every row of the level is in flight before any is consumed.
//     16-byte copies where W % 4 == 0 and the port starts 16-byte
//     aligned (then every row does), 4-byte copies otherwise, both
//     allocating in L1: the first levels' few rows are read by every
//     item, and copies through L2 alone queued all those reads at the
//     L2 slice of each row (a B+-tree search ran 11x slower; PERF.md
//     §6);
//   * the step reads row words straight from shared memory (the row is a
//     pointer), so rows of any width cost shared memory, not registers;
//   * layout: rows at a pitch of WP words.  A warp's lanes read word q of
//     their 32 rows at once.  With 4-byte copies WP is odd (padded by one
//     word when W is even), so the 32 reads fall in 32 banks.  With
//     16-byte copies a row must start 16-byte aligned, so all 32 reads
//     share q's bank residue mod 4 and 8 banks is the most they can
//     reach: WP / 4 is odd (padded by 4 words when W / 4 is even), so
//     the rows start in 8 different bank quads and no bank takes more
//     than 4 of the 32 reads (unpadded, W = 32 would put all 32 in one);
//   * the state stays in registers while a thread's R states hold at
//     most kRegStateWords words, and otherwise lives in the warp's region
//     at an odd pitch (one bank per lane), stepped in place;
//   * a CTA takes up to 4 warps, fewer where a warp's region is large
//     (one warp at 4 KB rows); above 48 KB the launch opts in with
//     cudaFuncSetAttribute.  An R whose region exceeds the card's
//     227 KB is refused (the wrapper raises with the byte count), and R
//     values whose region can never fit are not instantiated, so a wide
//     program does not pay their build time;
//   * depth: a thread steps its R items one after another after the
//     level's wait, so the warps an SM hide the row loads, not R, and
//     each item a thread adds to a warp's region takes shared memory
//     that more warps could use.  The compiler plans R = 1 here
//     (kernels/compiled/kernel.py::chase_plan_rif): tools/ring_sweep.py
//     bptree on an H100 found it the fastest depth at rows of 16 to 128
//     words, the time growing as the warps an SM fall (PERF.md §6).
//
// The streamed path (rows of kStreamRow words and more, and every
// program whose one-warp, R = 1 region does not fit: 8 KB and 16 KB
// B+-tree nodes, states of thousands of words).  Past 227 KB a warp
// cannot hold its 32 rows, and far below that the shared-memory path
// runs one warp an SM (4 KB rows), so this path streams the rows through
// the warp's region a window at a time:
//   * one item a lane; per level each lane computes its address, then
//     the warp copies window k (words 32k .. 32k + 31) of all 32 rows
//     into one of D + 1 buffers with 16-byte cp.async (.ca: the top
//     levels' rows are read by every item), 8 lanes a 128-byte row
//     piece, 4-byte copies where the rows are not 16-byte aligned;
//   * the step is emitted a second time as stream_step
//     (compile/chase.py): at a row word's first use it loads that word's
//     16-byte unit (every word of it the step reads) with one
//     ld.shared.v4, and before a unit of another window it calls
//     row.window<I>(), which issues window I + D, waits for window I and
//     switches buffers.  The order of windows is known when the program
//     is emitted (P::kWindows), so no test runs at run time, and D
//     windows are always in flight while the warp computes on one;
//   * layout: a buffer is 32 rows of a 32-word window at a pitch of 9
//     16-byte units (odd), so the 32 lanes' 16-byte reads of one unit
//     spread over the 8 bank quads (4 wavefronts, the least 512 bytes
//     take) and so do the copies' writes;
//   * a warp's region is (D + 1) x 4.5 KB: 24 warps an SM at D = 1 by
//     shared memory (the B+-tree step takes 46 registers), against the
//     shared-memory path's 3 at 2 KB rows and 1 at 4 KB rows;
//   * the state stays in registers up to kRegStateWords words and lives
//     in a global scratch otherwise, word q of lane l at q * 32 + l, so
//     a warp's accesses to one word coalesce;
//   * measured on an H100 (tools/ring_sweep.py bptree, 2^22 keys over
//     2^27 int32, PERF.md §6): against the shared-memory path the two tie
//     at 128-word rows (1.02 vs 1.06 ms) and this path wins from 256
//     words on (1.91 vs 3.59 ms at 256, 6.86 vs 35.86 at 1024), hence
//     kStreamRow; D = 1 is the fastest depth at 2048 and 4096 words
//     (15.21 and 31.78 ms; D = 4 31.53 and 61.17, the warps an SM
//     falling to 8), hence kStreamDepth, chosen from those two widths
//     (at 1024 and 1536 words D = 4 and D = 2 were 3-6 % faster).  Two
//     other designs lost: each lane's row left in place with one bulk
//     prefetch into L2 and its units read through L1 (ld.global.nc)
//     took 24.76 and 48.53 ms, as 32 lanes reading 32 different rows
//     make every load touch 32 lines where this path's copies touch 4;
//     and the shared-memory path with 2 to 8 whole rows a turn in a
//     warp's region, the lanes taking turns, took 78.84 ms and more at
//     2048 words;
//   * a program's library holds depth kStreamDepth alone, and the path
//     only where it is planned (nvcc took 130 s for the 4096-word
//     search's depths 1-4); tools/ring_sweep.py builds every depth.
// Every path walks every item through exactly max_steps levels, clipped
// tail loads included (Listing 5, kernel.py:192-200), so the results
// equal compile/chase.py's run_numpy bit for bit.  Items past m shadow
// item m - 1 and store nothing.
// Arithmetic is numpy's int32: + - * wrap (done in uint32), // and %
// round toward minus infinity, x // 0 and x % 0 are 0, INT_MIN // -1
// wraps, compares give 0/1.  The helpers and the layouts below compile
// for the host too, so the CPU tests run the generated functions under
// g++ and hold the wrapper's layout and path arithmetic to this file's.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define REPRO_CHASE_FN __host__ __device__ __forceinline__
#else
#define REPRO_CHASE_FN inline
#endif

namespace chase {

// the register path's thresholds (kernels/compiled/kernel.py REG_STATE,
// REG_ROW); a wider program takes the shared-memory or streamed path
constexpr int kRegState = 8;
constexpr int kRegRow = 8;
// the shared-memory path keeps a thread's R states in registers up to
// this many words (kernels/compiled/kernel.py REG_STATE_WORDS)
constexpr int kRegStateWords = 64;
// what one block may opt into on sm_90 (227 KB); regions above it are
// never instantiated
constexpr long long kSmemOptin = 232448;
// the streamed path (kernels/compiled/kernel.py WINDOW_WORDS,
// STREAM_PITCH, STREAM_ROW, STREAM_DEPTH, STREAM_MAX_DEPTH): windows of
// 32 words of each of a warp's 32 rows, at a pitch of 9 16-byte units;
// planned from kStreamRow words on and wherever the shared-memory path
// cannot run, at kStreamDepth windows in flight, the one depth a
// program's library holds.  The build of tools/ring_sweep.py
// (REPRO_CHASE_SWEEP) holds the path at every width past the register
// path and at every depth 1 .. kStreamMaxDepth.
constexpr int kWindowWords = 32;
constexpr int kStreamPitch = kWindowWords + 4;
constexpr int kStreamRow = 256;
constexpr int kStreamDepth = 1;
constexpr int kStreamMaxDepth = 4;
#if defined(REPRO_CHASE_SWEEP)
constexpr bool kSweepBuild = true;
#else
constexpr bool kSweepBuild = false;
#endif

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

// -- the shared-memory path's layout (kernels/compiled/kernel.py mirrors it)

REPRO_CHASE_FN constexpr bool register_path(int s, int w) {
  return s <= kRegState && w <= kRegRow;
}

// words from one row's start to the next's
REPRO_CHASE_FN constexpr int row_pitch(int w) {
  return w % 4 == 0 ? ((w / 4) % 2 == 1 ? w : w + 4)
                    : (w % 2 == 1 ? w : w + 1);
}

// words from one item's state to the next's, where the state is shared
REPRO_CHASE_FN constexpr int state_pitch(int s) {
  return s % 2 == 1 ? s : s + 1;
}

REPRO_CHASE_FN constexpr bool state_in_registers(int s, int r) {
  return s * r <= kRegStateWords;
}

REPRO_CHASE_FN constexpr long long round4(long long words) {
  return (words + 3) / 4 * 4;
}

// bytes of one warp's region: 32 x r rows, their addresses and, where
// the states do not fit registers, the states
REPRO_CHASE_FN constexpr long long warp_smem_bytes(int s, int w, int r) {
  return 4 * (round4(32LL * r * row_pitch(w)) + 32LL * r +
              (state_in_registers(s, r) ? 0
                                        : round4(32LL * r * state_pitch(s))));
}

// -- the streamed path's layout and the choice of path

// bytes of one warp's region at depth d: d + 1 window buffers of 32 rows
// at kStreamPitch words, and the rows' numbers
REPRO_CHASE_FN constexpr long long stream_warp_bytes(int d) {
  return 4LL * ((d + 1) * 32LL * kStreamPitch + 32);
}

// a lane's one state stays in registers up to kRegStateWords words, and
// otherwise lives in a global scratch, lane-major
REPRO_CHASE_FN constexpr bool stream_state_in_registers(int s) {
  return s <= kRegStateWords;
}

REPRO_CHASE_FN constexpr bool smem_fits(int s, int w) {
  return warp_smem_bytes(s, w, 1) <= kSmemOptin;
}

// the path a launch takes unless the caller names one: 0 registers,
// 1 shared memory, 2 streamed
REPRO_CHASE_FN constexpr int planned_path(int s, int w) {
  return register_path(s, w) ? 0
                             : (smem_fits(s, w) && w < kStreamRow ? 1 : 2);
}

// whether a program's library holds the streamed path: where it is
// planned (everywhere past the register path in the sweep's build)
REPRO_CHASE_FN constexpr bool stream_built(int s, int w) {
  return planned_path(s, w) == 2 || (kSweepBuild && !register_path(s, w));
}

// whether a library that holds the streamed path holds depth d
REPRO_CHASE_FN constexpr bool stream_depth_built(int d) {
  return d == kStreamDepth || (kSweepBuild && 1 <= d && d <= kStreamMaxDepth);
}

// A window's 16-byte unit of one row, as the streamed step reads it
struct Unit {
  int32_t x, y, z, w;
};

}  // namespace chase

#if defined(__CUDACC__)

#include <cuda_runtime.h>

#include "ring.cuh"

namespace chase {

constexpr int kThreads = 128;

// -- the register path ------------------------------------------------------

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
// the R state loads and output stores of a warp is coalesced.
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

// -- the shared-memory path -------------------------------------------------

// A 16-byte cp.async that allocates in L1 (.ca), where ring::copy16 goes
// through L2 only (.cg): a chase's top rows (a tree's root) are read by
// every item, and through L2 alone all of those reads queue at the one
// L2 slice that holds each such row (PERF.md §6).
__device__ __forceinline__ void copy16_l1(void* smem_dst,
                                          const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem_src) : "memory");
}

// One warp's 32 x R rows of this level: lane l moves units l, l + 32, ...
// of the flattened (row, unit) space, the row's address read back from
// the warp's address slots.  UNIT words a copy (4 or 1).
template <int W, int WP, int ITEMS, int UNIT>
__device__ __forceinline__ void copy_rows(int32_t* rows,
                                          const int32_t* addrs,
                                          const int32_t* __restrict__ port,
                                          int lane) {
  constexpr int kUnits = W / UNIT;                 // units a row
#pragma unroll 4
  for (int u = lane; u < ITEMS * kUnits; u += 32) {
    const int r = u / kUnits, c = (u - r * kUnits) * UNIT;
    const int32_t* src = port + (long long)addrs[r] * W + c;
    if constexpr (UNIT == 4) {
      copy16_l1(rows + r * WP + c, src);
    } else {
      ring::copy4(rows + r * WP + c, src);
    }
  }
}

template <class P, int R>
__global__ void __launch_bounds__(kThreads, 4)
chase_smem_kernel(const int32_t* __restrict__ port, long long n,
                  const int32_t* __restrict__ state0,
                  int32_t* __restrict__ out_addr,
                  int32_t* __restrict__ out_val, long long m, int max_steps,
                  int vec16) {
  constexpr int S = P::S, W = P::W;
  constexpr int WP = row_pitch(W), SP = state_pitch(S), ITEMS = 32 * R;
  constexpr bool kRegs = state_in_registers(S, R);
  constexpr long long kWarpWords = warp_smem_bytes(S, W, R) / 4;
  constexpr long long kRowWords = round4((long long)ITEMS * WP);
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long base =
      ((long long)blockIdx.x * (blockDim.x / 32) + warp) * ITEMS;
  if (base >= m) return;                    // no item of this warp
  int32_t* rows = smem + warp * kWarpWords;
  int32_t* addrs = rows + kRowWords;
  int32_t* shared_st = addrs + ITEMS;       // [ITEMS][SP] when !kRegs
  int32_t st[kRegs ? R : 1][S];

#pragma unroll
  for (int j = 0; j < R; ++j) {
    long long item = base + j * 32 + lane;
    if (item >= m) item = m - 1;
    if constexpr (kRegs) {
#pragma unroll
      for (int q = 0; q < S; ++q) st[j][q] = __ldg(state0 + item * S + q);
    } else {
      int32_t* s = shared_st + (j * 32 + lane) * SP;
      for (int q = 0; q < S; ++q) s[q] = __ldg(state0 + item * S + q);
    }
  }
  for (int level = 0; level < max_steps; ++level) {
#pragma unroll
    for (int j = 0; j < R; ++j) {           // access: every address
      const int slot = j * 32 + lane;
      long long a;
      if constexpr (kRegs) {
        a = P::addr(st[j]);
      } else {
        const int32_t* s = shared_st + slot * SP;
        a = P::addr(s);
      }
      addrs[slot] = (int32_t)(a < 0 ? 0 : (a >= n ? n - 1 : a));
    }
    __syncwarp();
    if constexpr (W % 4 == 0) {             // every request of the level
      if (vec16) {
        copy_rows<W, WP, ITEMS, 4>(rows, addrs, port, lane);
      } else {
        copy_rows<W, WP, ITEMS, 1>(rows, addrs, port, lane);
      }
    } else {
      copy_rows<W, WP, ITEMS, 1>(rows, addrs, port, lane);
    }
    ring::commit();
    ring::wait_group<0>();
    __syncwarp();                           // every lane's copies landed
    if constexpr (kRegs) {
#pragma unroll
      for (int j = 0; j < R; ++j) {         // execute: every response
        const int32_t* row = rows + (j * 32 + lane) * WP;
        int32_t next[S];
        P::step(st[j], row, next);
#pragma unroll
        for (int q = 0; q < S; ++q) st[j][q] = next[q];
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < R; ++j) {
        const int32_t* row = rows + (j * 32 + lane) * WP;
        int32_t* s = shared_st + (j * 32 + lane) * SP;
        P::step(s, row, s);                 // in place
      }
    }
    __syncwarp();                           // rows free for the next level
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long item = base + j * 32 + lane;
    if (item < m) {
      int32_t oa, ov;
      if constexpr (kRegs) {
        P::out(st[j], oa, ov);
      } else {
        const int32_t* s = shared_st + (j * 32 + lane) * SP;
        P::out(s, oa, ov);
      }
      out_addr[item] = oa;
      out_val[item] = ov;
    }
  }
}

template <class P, int R>
int launch_smem(const void* port, long long n, const void* state0,
                void* out_addr, void* out_val, long long m, int max_steps,
                void* stream) {
  constexpr long long per_warp = warp_smem_bytes(P::S, P::W, R);
  if constexpr (per_warp > kSmemOptin) {
    return (int)cudaErrorInvalidValue;      // never fits: not built
  } else {
    int device = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (e != cudaSuccess) return (int)e;
    if (per_warp > optin) return (int)cudaErrorInvalidValue;
    long long warps = optin / per_warp;
    if (warps > kThreads / 32) warps = kThreads / 32;
    const long long bytes = warps * per_warp;
    const auto kernel = chase_smem_kernel<P, R>;
    if (bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    const long long per_cta = warps * 32 * R;
    const long long grid = (m + per_cta - 1) / per_cta;
    const int vec16 = (reinterpret_cast<uintptr_t>(port) % 16 == 0) ? 1 : 0;
    kernel<<<(unsigned)grid, (unsigned)(warps * 32), (size_t)bytes,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(port), n,
        static_cast<const int32_t*>(state0),
        static_cast<int32_t*>(out_addr), static_cast<int32_t*>(out_val), m,
        max_steps, vec16);
    return (int)cudaGetLastError();
  }
}

// -- the streamed path ------------------------------------------------------

// A warp's rows of one level, streamed through d + 1 window buffers of
// its region: window J of the step's sequence (P::kWindows[J], 32 words
// of each of the 32 rows) lands in buffer J % (D + 1).  begin() issues
// the first D windows, window<I>() issues window I + D into the buffer
// window I - 1 left and waits for window I, unit<U>() reads this lane's
// 16-byte unit U of its row from the current window.  Every window<I>()
// commits one group (empty past the last window), so after D + I + 1
// commits, at most D pending means window I has landed.
template <class P, int D>
struct StagedRow {
  static constexpr int W = P::W;
  static constexpr int kBuf = 32 * kStreamPitch;     // words of a buffer
  int32_t* buf;                  // the warp's buffers
  int32_t* rows;                 // the warp's 32 row numbers
  const int32_t* __restrict__ port;
  const int32_t* mine;           // this lane's row in buffer 0
  int lane, vec16, off;

  __device__ __forceinline__ StagedRow(int32_t* region,
                                       const int32_t* __restrict__ p, int l,
                                       int v)
      : buf(region), rows(region + (D + 1) * kBuf), port(p),
        mine(region + l * kStreamPitch), lane(l), vec16(v), off(0) {}

  // Copy window P::kWindows[J] of the 32 rows: 16-byte units spread over
  // the lanes (8 lanes a 128-byte row piece) where vec16, else words
  template <int J>
  __device__ __forceinline__ void issue() const {
    constexpr int first = P::kWindows[J] * kWindowWords;
    constexpr int words =
        W - first < kWindowWords ? W - first : kWindowWords;
    int32_t* dst = buf + (J % (D + 1)) * kBuf;
    if (vec16) {
      constexpr int units = (words + 3) / 4;
#pragma unroll
      for (int v = lane; v < 32 * units; v += 32) {
        const int r = v / units, c = 4 * (v - r * units);
        copy16_l1(dst + r * kStreamPitch + c,
                  port + (long long)rows[r] * W + first + c);
      }
    } else {
#pragma unroll 4
      for (int v = lane; v < 32 * words; v += 32) {
        const int r = v / words, c = v - r * words;
        ring::copy4(dst + r * kStreamPitch + c,
                    port + (long long)rows[r] * W + first + c);
      }
    }
  }

  template <int J>
  __device__ __forceinline__ void prologue() const {
    if constexpr (J < D) {
      if constexpr (J < P::kNumWindows) issue<J>();
      ring::commit();
      prologue<J + 1>();
    }
  }

  __device__ __forceinline__ void begin(long long row) {
    rows[lane] = (int32_t)row;
    __syncwarp();
    prologue<0>();
  }

  template <int I>
  __device__ __forceinline__ void window() {
    __syncwarp();                        // every lane is done with I - 1
    if constexpr (I + D < P::kNumWindows) issue<I + D>();
    ring::commit();
    ring::wait_group<D>();
    __syncwarp();                        // every lane's copies of I landed
    off = (I % (D + 1)) * kBuf - P::kWindows[I] * kWindowWords;
  }

  template <int U>
  __device__ __forceinline__ Unit unit() const {
    const int4 v = *reinterpret_cast<const int4*>(mine + off + 4 * U);
    return Unit{v.x, v.y, v.z, v.w};
  }

  __device__ __forceinline__ void end() const {
    __syncwarp();                        // buffers and rows free again
  }
};

// A state in the global scratch: word q of lane l of a warp at
// q * 32 + l, so a warp's reads and writes of one word coalesce
struct LaneMajor {
  int32_t* p;
  __device__ __forceinline__ int32_t& operator[](int q) const {
    return p[q * 32];
  }
};

template <class P, class Row, class St>
__device__ __forceinline__ void stream_walk(Row& row, St& st, long long n,
                                            int max_steps) {
  for (int level = 0; level < max_steps; ++level) {
    const long long a = P::addr(st);
    row.begin(a < 0 ? 0 : (a >= n ? n - 1 : a));
    P::stream_step(st, row, st);         // in place
    row.end();
  }
}

// One item a lane, 32 a warp; items past m shadow item m - 1
template <class P, int D>
__global__ void __launch_bounds__(kThreads)
chase_stream_kernel(const int32_t* __restrict__ port, long long n,
                    const int32_t* __restrict__ state0,
                    int32_t* __restrict__ out_addr,
                    int32_t* __restrict__ out_val, long long m, int max_steps,
                    int vec16, int32_t* __restrict__ scratch) {
  constexpr int S = P::S;
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long base =
      ((long long)blockIdx.x * (blockDim.x / 32) + warp) * 32;
  if (base >= m) return;                     // no item of this warp
  const long long item = base + lane < m ? base + lane : m - 1;
  StagedRow<P, D> row(smem + warp * (stream_warp_bytes(D) / 4), port, lane,
                      vec16);
  int32_t oa, ov;
  if constexpr (stream_state_in_registers(S)) {
    int32_t st[S];
#pragma unroll
    for (int q = 0; q < S; ++q) st[q] = __ldg(state0 + item * S + q);
    stream_walk<P>(row, st, n, max_steps);
    P::out(st, oa, ov);
  } else {
    LaneMajor st{scratch + base * S + lane};
    for (int q = 0; q < S; ++q) st[q] = __ldg(state0 + item * S + q);
    stream_walk<P>(row, st, n, max_steps);
    P::out(st, oa, ov);
  }
  if (base + lane < m) {
    out_addr[base + lane] = oa;
    out_val[base + lane] = ov;
  }
}

template <class P, int D>
int launch_stream(const void* port, long long n, const void* state0,
                  void* out_addr, void* out_val, long long m, int max_steps,
                  void* scratch, void* stream) {
  if (!stream_state_in_registers(P::S) && scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec16 =
      (P::W % 4 == 0 && reinterpret_cast<uintptr_t>(port) % 16 == 0) ? 1 : 0;
  constexpr long long bytes = (kThreads / 32) * stream_warp_bytes(D);
  const auto kernel = chase_stream_kernel<P, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = (m + kThreads - 1) / kThreads;
  kernel<<<(unsigned)grid, kThreads, (size_t)bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(port), n,
      static_cast<const int32_t*>(state0), static_cast<int32_t*>(out_addr),
      static_cast<int32_t*>(out_val), m, max_steps, vec16,
      static_cast<int32_t*>(scratch));
  return (int)cudaGetLastError();
}

// The streamed launch at `depth` windows in flight, among the depths
// D .. kStreamMaxDepth that stream_depth_built names
template <class P, int D = 1>
int launch_depth(int depth, const void* port, long long n, const void* state0,
                 void* out_addr, void* out_val, long long m, int max_steps,
                 void* scratch, void* stream) {
  if constexpr (D > kStreamMaxDepth) {
    return (int)cudaErrorInvalidValue;
  } else {
    if constexpr (stream_depth_built(D)) {
      if (depth == D) {
        return launch_stream<P, D>(port, n, state0, out_addr, out_val, m,
                                   max_steps, scratch, stream);
      }
    }
    return launch_depth<P, D + 1>(depth, port, n, state0, out_addr, out_val,
                                  m, max_steps, scratch, stream);
  }
}

// the launch's path: kernels/compiled/kernel.py CHASE_PATHS
enum Path : int { kRegisterPath = 0, kSmemPath = 1, kStreamPath = 2 };

template <class P>
int launch(const void* port, long long n, const void* state0, void* out_addr,
           void* out_val, long long m, int items, int max_steps, int path,
           void* scratch, void* stream) {
  static_assert(P::S >= 1 && P::W >= 1, "state and row widths");
  if (m <= 0) return 0;
  if (n < 1 || max_steps < 0) return (int)cudaErrorInvalidValue;
  if (path == kStreamPath) {
    if constexpr (stream_built(P::S, P::W)) {
      return launch_depth<P>(items, port, n, state0, out_addr, out_val, m,
                             max_steps, scratch, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (path != (register_path(P::S, P::W) ? kRegisterPath : kSmemPath)) {
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (register_path(P::S, P::W)) {
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
  } else {
#define REPRO_CHASE_R(R)                                                  \
  case R: return launch_smem<P, R>(port, n, state0, out_addr, out_val, m, \
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
}

}  // namespace chase

// The C entry point of one program's library: port (N, W) int32 rows;
// state0 (M, S) int32 row-major; out_addr and out_val (M,) int32; `path`
// one of chase::Path; on the register and shared-memory paths each
// thread walks `items` items (1 .. 16, kernels/ring.py MAX_RIF), on the
// streamed path `items` is the windows in flight (kStreamDepth)
// and `scratch` holds (M rounded up to 32) x S int32 where the states
// do not fit registers (else it may be null).  S and W are the
// program's own.
#define REPRO_CHASE_ENTRY(PROG)                                              \
  extern "C" int ring_chase_items(const void* port, long long n,            \
                                  const void* state0, void* out_addr,       \
                                  void* out_val, long long m, int items,    \
                                  int max_steps, int path, void* scratch,   \
                                  void* stream) {                           \
    return chase::launch<PROG>(port, n, state0, out_addr, out_val, m, items, \
                               max_steps, path, scratch, stream);           \
  }

#endif  // __CUDACC__
