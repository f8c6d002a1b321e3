// The explicit-decoupling ring on Hopper: the CUDA form of RingChannel /
// access_execute / ring_step in src/repro/kernels/ring.py.
//
// On the TPU the ring is a rif-deep VMEM scratch with one DMA semaphore
// per slot, and ring_step spans grid steps because TPU scratch persists
// across them.  CUDA shared memory does not persist across blocks, so
// here one CTA owns a whole request stream of n indices and walks it in
// a loop, holding a rif-stage ring in dynamic shared memory:
//
//   prologue      request k = 0 .. min(rif, n)
//   steady state  for each k: wait on k (response), execute(k), then
//                 request k + rif
//   drain         implicit: nothing is requested for k + rif >= n
//
// A request is a set of 16-byte cp.async copies issued by the CTA's
// threads, closed by one cp.async commit group.  Every loop iteration
// commits exactly one group (empty when there is nothing to request), so
// when the CTA waits on k, rif + k groups were committed and group k is
// done once at most rif - 1 remain pending.  cp.async groups are
// per-thread, so a __syncthreads after the wait makes every thread's
// copies for k visible, and one before the re-request frees slot k % rif.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

// Largest ring depth the wait dispatch below covers (kernels/ring.py
// MAX_RIF; the wrappers clamp to it).
constexpr int kMaxRif = 16;

__device__ __forceinline__ void copy16(void* smem_dst, const void* gmem_src) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem_src) : "memory");
}

// One 4-byte element, for windows that start at any element offset
// (cp.async moves 16 bytes only through L2 with .cg; sizes 4 and 8 take
// .ca).  Both addresses 4-byte aligned.
__device__ __forceinline__ void copy4(void* smem_dst, const void* gmem_src) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(gmem_src) : "memory");
}

// copy16, or 16 zero bytes where `valid` is false (a ragged tile edge):
// the plain store lands before the consume like the copies do, since the
// consume waits behind a __syncthreads.  `gmem_src` is not read then.
__device__ __forceinline__ void copy16_or_zero(void* smem_dst,
                                               const void* gmem_src,
                                               bool valid) {
  if (valid) {
    copy16(smem_dst, gmem_src);
  } else {
    *static_cast<uint4*>(smem_dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// cp.async.wait_group takes an immediate; dispatch the runtime depth.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: wait_group<0>(); break;
    case 1: wait_group<1>(); break;
    case 2: wait_group<2>(); break;
    case 3: wait_group<3>(); break;
    case 4: wait_group<4>(); break;
    case 5: wait_group<5>(); break;
    case 6: wait_group<6>(); break;
    case 7: wait_group<7>(); break;
    case 8: wait_group<8>(); break;
    case 9: wait_group<9>(); break;
    case 10: wait_group<10>(); break;
    case 11: wait_group<11>(); break;
    case 12: wait_group<12>(); break;
    case 13: wait_group<13>(); break;
    case 14: wait_group<14>(); break;
    case 15: wait_group<15>(); break;
    default: wait_group<0>(); break;   // deeper than kMaxRif: wait for all
  }
}

// Copy `rows` rows of `row_bytes` (a multiple of 16; every row start
// 16-byte aligned on both sides) from global memory, rows `src_pitch`
// bytes apart, into shared memory, rows `dst_pitch` bytes apart; spread
// over the CTA's threads.  Part of one request.
__device__ __forceinline__ void request_rows(void* smem_dst, int dst_pitch,
                                             const void* gmem_src,
                                             long long src_pitch, int rows,
                                             int row_bytes) {
  char* dst = static_cast<char*>(smem_dst);
  const char* src = static_cast<const char*>(gmem_src);
  const int chunks = row_bytes / 16;
  for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
    const int row = c / chunks;
    const int col = (c - row * chunks) * 16;
    copy16(dst + row * dst_pitch + col, src + row * src_pitch + col);
  }
}

// Bulk copies (TMA without a tensor map) completing on an mbarrier: one
// lane asks for a whole contiguous block, and the waiting threads spin on
// the barrier's phase instead of meeting at a __syncthreads.  A barrier
// of count 1 completes a phase when its one arrival (the expect_tx of the
// issuing lane) is in and every byte it announced has landed.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Make mbar_init visible to the bulk-copy unit; then a CTA barrier.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The calling lane's arrival, announcing `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// The calling thread's arrival, with no bytes announced (a consumer
// releasing a stage).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival on `bar` once every cp.async the calling thread issued
// before it has landed (the arrival counts against the barrier's init
// count: .noinc), so a waiter on the phase sees those copies too.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// Order this thread's earlier shared-memory reads before a later bulk
// copy into the same bytes (the copy writes through the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory as one bulk copy that completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* smem_dst, const void* gmem_src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(smem_dst)), "l"(gmem_src), "r"(bytes),
         "r"(smem_u32(bar))
      : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// shared to global memory as one bulk copy in the calling thread's bulk
// group; bulk_commit closes the group.  bulk_wait_read<N> returns once at
// most N of the thread's latest groups still read their shared memory
// (so the slot may be refilled), bulk_wait<N> once at most N still write.
__device__ __forceinline__ void bulk_store(void* gmem_dst, const void* smem_src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(gmem_dst), "r"(smem_u32(smem_src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// One CTA's access/execute loop over n sequence indices with a rif-deep
// ring.  fetch(k, slot) issues request k's copies into ring slot `slot`;
// execute(k, slot) consumes them once they have landed.
template <class Fetch, class Execute>
__device__ __forceinline__ void access_execute(int n, int rif, Fetch fetch,
                                               Execute execute) {
  for (int k = 0; k < rif; ++k) {          // prologue
    if (k < n) fetch(k, k);
    commit();
  }
  for (int k = 0; k < n; ++k) {            // steady state
    const int slot = k % rif;
    wait_pending(rif - 1);                 // response(k), this thread
    __syncthreads();                       // ... and every thread
    execute(k, slot);
    __syncthreads();                       // slot k % rif is free again
    if (k + rif < n) fetch(k + rif, slot);
    commit();
  }
  wait_pending(0);                         // drain (only empty groups)
}

}  // namespace ring
