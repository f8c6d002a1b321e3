// Lock-step dependent chase for Hopper, driven by a traced ChaseSpec.
//
// Replaces src/repro/kernels/compiled/kernel.py::ring_chase (_chase_kernel),
// the compiler's template for a DEPENDENT stream: per item an int32
// state of width S, `max_steps` levels of addr_fn -> load of one port
// row of W int32 -> step_fn, then out_fn gives (store_addr, store_value).
//
// Bound on this card: the latency of dependent loads, and bytes.  Each
// level's load waits on the previous level's step, so what the card can
// do is set by how many independent loads are in flight (Little's law:
// ~3.35 TB/s x ~1 us, some 100,000 random 32-byte sectors); the floor
// counted for a run is its distinct rows read once plus the state read
// and the outputs written, over 3.35 TB/s.
//
// Design.  The TPU kernel traces addr_fn/step_fn/out_fn into its body
// (kernel.py:180-209); CUDA cannot call Python.  compile/chase.py traces
// them once into a flat register program of int32 instructions
// (5 words each: op, dst, a, b, c), which this kernel interprets:
//   * the CTA copies the program into shared memory;
//   * each thread owns `rif` items (item j of thread t in CTA c is
//     c * blockDim * rif + j * blockDim + t) and keeps their states in
//     registers spilled to local memory;
//   * per level it runs the address program of each of its items and
//     issues all `rif` row copies (4-byte cp.async, or 16-byte where W is
//     4 or 8) into its own shared-memory rows before it consumes any:
//     those are its requests in flight; one cp.async.wait_group 0, then
//     the step program per item.  A thread reads only its own rows, so no
//     barrier is needed;
//   * every item walks exactly max_steps levels, clipped tail loads
//     included (Listing 5, kernel.py:192-200), which keeps the results
//     equal to the reference's.
// Arithmetic is numpy's int32: + - * wrap (done in uint32), // and %
// round toward minus infinity, x // 0 and x % 0 are 0, compares give 0/1.
// The program format is compile/chase.py's; kMax* below are its limits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "ring.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxState = 8;     // chase.py MAX_STATE
constexpr int kMaxRow = 8;       // chase.py MAX_ROW
constexpr int kMaxRegs = 64;     // chase.py MAX_REGS
constexpr int kMaxInstr = 512;   // chase.py MAX_INSTR
constexpr int kHeader = 7 + kMaxState + 2;

enum Op : int {
  kConst, kAdd, kSub, kMul, kFdiv, kFmod, kLt, kLe, kGt, kGe, kEq,
  kNe, kAnd, kOr, kXor, kNot, kLnot, kNeg, kWhere, kMin, kMax
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  if (b == 0) return 0;
  if (b == -1) return (int32_t)(0u - (uint32_t)a);   // INT_MIN / -1 wraps
  int32_t q = a / b;
  const int32_t r = a - q * b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t b) {
  if (b == 0 || b == -1) return 0;
  int32_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// Run `n` instructions of `prog` over the register file `r`.
__device__ __forceinline__ void run(const int32_t* prog, int n, int32_t* r) {
  for (int i = 0; i < n; ++i) {
    const int32_t* ins = prog + 5 * i;
    const int op = ins[0], d = ins[1];
    if (op == kConst) {
      r[d] = ins[2];
      continue;
    }
    const int32_t x = r[ins[2]], y = r[ins[3]];
    int32_t v;
    switch (op) {
      case kAdd: v = wrap_add(x, y); break;
      case kSub: v = (int32_t)((uint32_t)x - (uint32_t)y); break;
      case kMul: v = (int32_t)((uint32_t)x * (uint32_t)y); break;
      case kFdiv: v = floor_div(x, y); break;
      case kFmod: v = floor_mod(x, y); break;
      case kLt: v = x < y; break;
      case kLe: v = x <= y; break;
      case kGt: v = x > y; break;
      case kGe: v = x >= y; break;
      case kEq: v = x == y; break;
      case kNe: v = x != y; break;
      case kAnd: v = x & y; break;
      case kOr: v = x | y; break;
      case kXor: v = x ^ y; break;
      case kNot: v = ~x; break;
      case kLnot: v = x == 0; break;
      case kNeg: v = (int32_t)(0u - (uint32_t)x); break;
      case kWhere: v = r[ins[4]] != 0 ? x : y; break;
      case kMin: v = x < y ? x : y; break;
      case kMax: v = x > y ? x : y; break;
      default: v = 0; break;
    }
    r[d] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
ring_chase_kernel(const int32_t* __restrict__ port, long long n,
                  const int32_t* __restrict__ state0,
                  int32_t* __restrict__ out_addr,
                  int32_t* __restrict__ out_val, long long m, int rif,
                  int max_steps, const int32_t* __restrict__ prog_g,
                  int prog_words) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* prog = smem;                                   // prog_words
  for (int i = threadIdx.x; i < prog_words; i += blockDim.x) {
    prog[i] = __ldg(prog_g + i);
  }
  __syncthreads();
  const int s = prog[0], w = prog[1];
  const int n_addr = prog[3], n_step = prog[4], n_out = prog[5];
  const int addr_out = prog[6];
  const int32_t* body = prog + kHeader;
  const int32_t* p_addr = body;
  const int32_t* p_step = body + 5 * n_addr;
  const int32_t* p_out = p_step + 5 * n_step;
  // this thread's landed rows: rif * w words, 16-byte aligned
  int32_t* my_rows = smem + ((prog_words + 3) / 4 * 4) +
                     (size_t)threadIdx.x * rif * w;

  const long long first = (long long)blockIdx.x * blockDim.x * rif +
                          threadIdx.x;
  int cnt = 0;                    // this thread's items: first + j * blockDim
  while (cnt < rif && first + (long long)cnt * blockDim.x < m) ++cnt;

  int32_t st[ring::kMaxRif * kMaxState];
  int32_t r[kMaxRegs];
  for (int j = 0; j < cnt; ++j) {
    const long long item = first + (long long)j * blockDim.x;
    for (int q = 0; q < s; ++q) st[j * s + q] = __ldg(state0 + item * s + q);
  }

  const bool vec = (w & 3) == 0;
  for (int level = 0; level < max_steps; ++level) {
    for (int j = 0; j < cnt; ++j) {               // access: all requests
      for (int q = 0; q < s; ++q) r[q] = st[j * s + q];
      run(p_addr, n_addr, r);
      long long a = r[addr_out];
      a = a < 0 ? 0 : (a >= n ? n - 1 : a);
      const int32_t* src = port + a * w;
      int32_t* dst = my_rows + j * w;
      if (vec) {
        for (int q = 0; q < w; q += 4) ring::copy16(dst + q, src + q);
      } else {
        for (int q = 0; q < w; ++q) ring::copy4(dst + q, src + q);
      }
    }
    ring::commit();
    ring::wait_group<0>();
    for (int j = 0; j < cnt; ++j) {               // execute: every response
      for (int q = 0; q < s; ++q) r[q] = st[j * s + q];
      for (int q = 0; q < w; ++q) r[s + q] = my_rows[j * w + q];
      run(p_step, n_step, r);
      for (int q = 0; q < s; ++q) st[j * s + q] = r[prog[7 + q]];
    }
  }

  for (int j = 0; j < cnt; ++j) {
    const long long item = first + (long long)j * blockDim.x;
    for (int q = 0; q < s; ++q) r[q] = st[j * s + q];
    run(p_out, n_out, r);
    out_addr[item] = r[prog[7 + kMaxState]];
    out_val[item] = r[prog[8 + kMaxState]];
  }
}

}  // namespace

// port (N, W) int32 rows; state0 (M, S) int32 row-major; out_addr and
// out_val (M,) int32; prog the traced program (compile/chase.py) of
// prog_words int32 on the device.  Each thread walks `rif` items.
extern "C" int ring_chase_items(const void* port, long long n, int w,
                                const void* state0, void* out_addr,
                                void* out_val, long long m, int s, int rif,
                                int max_steps, const void* prog,
                                int prog_words, int n_instr, int n_regs,
                                void* stream) {
  if (m <= 0) return 0;
  if (n < 1 || w < 1 || w > kMaxRow || s < 1 || s > kMaxState || rif < 1 ||
      rif > ring::kMaxRif || max_steps < 0 || n_instr > kMaxInstr ||
      n_regs > kMaxRegs || s + w > kMaxRegs ||
      prog_words != kHeader + 5 * n_instr) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)((prog_words + 3) / 4 * 4) * 4 +
                      (size_t)kThreads * rif * w * 4;
  cudaError_t e = cudaFuncSetAttribute(
      ring_chase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long per_cta = (long long)kThreads * rif;
  const long long grid = (m + per_cta - 1) / per_cta;
  ring_chase_kernel<<<(unsigned)grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(port), n,
      static_cast<const int32_t*>(state0), static_cast<int32_t*>(out_addr),
      static_cast<int32_t*>(out_val), m, rif, max_steps,
      static_cast<const int32_t*>(prog), prog_words);
  return (int)cudaGetLastError();
}
