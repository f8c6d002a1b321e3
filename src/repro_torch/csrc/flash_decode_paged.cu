// One-token GQA decode attention over a paged KV cache, for Hopper: the
// split-KV body of split_decode.cuh over a page table.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_decode_paged
// (_paged_decode_kernel): the G query rows of one KV head against the K/V
// pages the page table names.  What bounds it (bytes) and how the design
// answers are in split_decode.cuh.
#include "exports.cuh"
#include "split_decode.cuh"

// q (B, KVH, G, D); pages (NP, KVH, PAGE, D); page_table (B, NPB) int32;
// lengths (B,) int32.  part: B x KVH x nsplit x split_decode_partial f32
// scratch (unused when nsplit is 1); counters: B x KVH int32, zero before
// the call and zero again after it.
extern "C" int flash_decode_paged(const void* q, const void* k, const void* v,
                                  const void* page_table, const void* lengths,
                                  void* out, void* part, void* counters,
                                  int batch, int kvh, int g_rows, int d,
                                  int npb, int page, int pps, int nsplit,
                                  int depth, float scale, int bf16,
                                  void* stream) {
  const split::Shape s{batch, kvh, g_rows, d, npb, page, npb * page,
                       pps, nsplit, depth};
  const split::Table addr{static_cast<const int32_t*>(page_table)};
  return split::launch_dtype(q, k, v, addr, lengths, out, part, counters, s,
                             scale, bf16, stream);
}
