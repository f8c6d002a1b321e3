// One-token GQA decode attention over a contiguous KV cache, for Hopper:
// the split-KV body of split_decode.cuh with an implicit page table.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_decode
// (_decode_kernel, through _decode_step): the G query rows of one KV head
// against its K/V blocks, f32 online softmax, cols >= len masked to
// -1e30, and acc / max(l, 1e-30) at the end.  Block j of (b, h) is the
// contiguous run of bk rows starting at row (b KVH + h) S + j bk, so the
// decode takes, unchanged, the paged decode's splits, bulk copies,
// warp-owned blocks and in-launch merge (one launch per call); what
// bounds it (bytes) and how the design answers are in split_decode.cuh.
// The TPU wrapper pads the cache to a multiple of bk with a full copy
// each call; here the last block of a request is copied only up to len.
#include "exports.cuh"
#include "split_decode.cuh"

// q (B, KVH, G, D); caches (B, KVH, S, D); lengths (B,) int32; blocks of
// bk tokens, split as flash_decode_paged's pages are (part and counters
// likewise).
extern "C" int flash_decode_contig(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, void* part,
                                   void* counters, int batch, int kvh,
                                   int g_rows, int d, int s, int bk, int pps,
                                   int nsplit, int depth, float scale,
                                   int bf16, void* stream) {
  if (bk < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const split::Shape shape{batch, kvh, g_rows, d, (s + bk - 1) / bk, bk,
                           s, pps, nsplit, depth};
  const split::Contig addr{s};
  return split::launch_dtype(q, k, v, addr, lengths, out, part, counters,
                             shape, scale, bf16, stream);
}
