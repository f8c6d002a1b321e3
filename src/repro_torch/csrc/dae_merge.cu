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
// Bound on this card: bytes.  Each input element is read once and each
// output written once over 3.35 TB/s; the merge itself is T compares a
// tile.
//
// Design: spans streamed through a ring, merged by serial merges.
//  * A CTA is 8 consumer warps and one producer warp, persistent: it
//    walks spans of `span` consecutive tiles (blockIdx.x, + gridDim.x,
//    ...) through a ring of `stages` shared-memory stages, full and
//    empty mbarriers a stage.  This is the paper's access/execute split:
//    the producer runs up to `stages` spans ahead of the merges.
//  * The producer (one lane a tile) reads the span's splits one span
//    ahead of its copies, and reduces them to the union of the span's
//    windows in each run.  With merge-path splits that is what the span
//    consumes plus at most T of overhang, so each input byte is read
//    about once instead of twice (neighbouring tiles' windows overlap).
//    When `a` and `b` are one tensor (a merge-sort pass) and the two
//    unions touch, they are one interval.  An interval moves as one
//    bulk copy of its 16-byte-aligned interior on the stage's full
//    barrier, and its ragged head and tail (at most 3 elements each) as
//    4-byte cp.async copies whose landing the barrier also waits for:
//    nothing outside [lo, hi) is read, so a view's unaligned base or the
//    tensor's last bytes are safe.
//  * If the intervals do not fit a stage (starts that are not merge-path
//    splits, or windows far apart), the producer says so in the stage's
//    mode, copies nothing, and the consumers take the per-tile path: each
//    tile's two windows loaded by its own threads, with sentinels, a round
//    of tiles at a time.  The choice is made on the card from the splits,
//    span by span.
//  * Merging: each consumer thread owns K = 8 consecutive outputs of a
//    tile (T / 8 threads a tile).  It finds its split on diagonal k by
//    binary search over the tile's windows in shared memory (the
//    reference's rule: the smallest i with A[i] > B[k - i - 1], so ties
//    take from a first), merges its K outputs serially in registers, and
//    stores them as two 16-byte vectors (element by element at the
//    ragged n_out edge).  T compares a tile instead of the network's
//    T log T, and no CTA barrier between them.
// The output equals the bitonic network's wherever equal keys are equal
// bits (every int32 key); float -0 and +0 compare equal and land in the
// stable order, ties from a first.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

#include "exports.cuh"
#include "ring.cuh"

namespace {

constexpr int kMaxTile = 1024;
constexpr int kConsumers = 256;            // threads that merge
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kK = 8;                      // outputs a consumer thread
constexpr int kMaxSpan = 32;               // tiles a span, a lane each
constexpr int kMaxStages = 4;
// per-stage metadata behind the stages: kMaxSpan int4 a stage, the modes,
// then the full and empty barriers
constexpr int kMetaBytes =
    kMaxStages * kMaxSpan * 16 + 16 + 2 * kMaxStages * 8;

enum : int { kSpan = 0, kPerTile = 1 };

struct Params {
  const unsigned char* a;
  const unsigned char* b;
  const int32_t* sa;
  const int32_t* ea;
  const int32_t* sb;
  const int32_t* eb;
  unsigned char* out;
  long long n_out;
  int n_tiles, tile, span, stages, stage_bytes, n_spans;
};

// One tile's windows as the producer read them: starts and the number of
// real elements in each window, clamp(end - start, 0, T).
struct Split {
  long long sa, sb;
  int na, nb;
};

__device__ __forceinline__ long long floor16(long long x) { return x & ~15LL; }
__device__ __forceinline__ long long ceil16(long long x) {
  return (x + 15) & ~15LL;
}
__device__ __forceinline__ long long addr(const void* p) {
  return (long long)reinterpret_cast<uintptr_t>(p);
}

__device__ __forceinline__ long long warp_min(long long v) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ long long warp_max(long long v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

__device__ __forceinline__ Split load_split(const Params& p, int span,
                                            int lane) {
  Split s{0, 0, 0, 0};
  const long long t = (long long)span * p.span + lane;
  if (span < p.n_spans && lane < p.span && t < p.n_tiles) {
    const long long sa = __ldg(p.sa + t), sb = __ldg(p.sb + t);
    s.sa = sa;
    s.sb = sb;
    s.na = (int)max(0LL, min((long long)p.tile, __ldg(p.ea + t) - sa));
    s.nb = (int)max(0LL, min((long long)p.tile, __ldg(p.eb + t) - sb));
  }
  return s;
}

// The producer warp fills stage `stage` for one span: meta[j] is tile j's
// {a window, na, b window, nb}, the windows as element indices into the
// stage (span mode) or as run positions (per-tile mode).
__device__ void issue(const Params& p, const Split& s, int lane,
                      unsigned char* stage, int4* meta, int* mode,
                      uint64_t* full) {
  const long long lo_a = warp_min(s.na > 0 ? s.sa : LLONG_MAX);
  const long long hi_a = warp_max(s.na > 0 ? s.sa + s.na : LLONG_MIN);
  const long long lo_b = warp_min(s.nb > 0 ? s.sb : LLONG_MAX);
  const long long hi_b = warp_max(s.nb > 0 ? s.sb + s.nb : LLONG_MIN);
  // up to two intervals [lo, hi) of elements, each of tensor g
  // (a's interval first where it has one; b's second, or first alone,
  // or merged into a's when both are one tensor and they touch)
  const bool has_a = lo_a < hi_a, has_b = lo_b < hi_b;
  const bool merged = has_a && has_b && p.a == p.b && lo_b <= hi_a &&
                      lo_a <= hi_b;
  const unsigned char* g[2] = {has_a ? p.a : p.b, p.b};
  const long long lo[2] = {
      has_a ? (merged ? min(lo_a, lo_b) : lo_a) : lo_b, lo_b};
  const long long hi[2] = {
      has_a ? (merged ? max(hi_a, hi_b) : hi_a) : hi_b, hi_b};
  const int n_iv = has_a && has_b && !merged ? 2 : (has_a || has_b ? 1 : 0);
  const int ib = n_iv == 2 ? 1 : 0;  // a's is the first where it has one
  long long base[2] = {0, 0}, off[2] = {0, 0}, total = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < n_iv) {
      base[i] = floor16(addr(g[i]) + 4 * lo[i]);
      off[i] = total;
      total += ceil16(addr(g[i]) + 4 * hi[i]) - base[i];
    }
  }
  const bool fits = total <= p.stage_bytes;
  int4 m = make_int4((int)s.sa, s.na, (int)s.sb, s.nb);
  if (fits) {
    const long long at_a = off[0] - base[0];
    const long long at_b = ib ? off[1] - base[1] : off[0] - base[0];
    m.x = s.na > 0 ? (int)((at_a + addr(p.a) + 4 * s.sa) / 4) : 0;
    m.z = s.nb > 0 ? (int)((at_b + addr(p.b) + 4 * s.sb) / 4) : 0;
  }
  if (lane < p.span) meta[lane] = m;
  long long c0[2] = {0, 0}, c1[2] = {0, 0};
  uint32_t bulk = 0;
  const int n_copy = fits ? n_iv : 0;  // per-tile: the consumers load
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < n_copy) {
      c0[i] = ceil16(addr(g[i]) + 4 * lo[i]);
      c1[i] = floor16(addr(g[i]) + 4 * hi[i]);
      if (c1[i] > c0[i]) bulk += (uint32_t)(c1[i] - c0[i]);
    }
  }
  if (lane == 0) {
    *mode = fits ? kSpan : kPerTile;
    ring::mbar_expect(full, bulk);     // lane 0's arrival, with the bytes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i < n_copy && c1[i] > c0[i]) {
        ring::bulk_copy(stage + off[i] + (c0[i] - base[i]),
                        reinterpret_cast<const void*>(c0[i]),
                        (uint32_t)(c1[i] - c0[i]), full);
      }
    }
  }
  // lane l copies edge element l % 8 of interval l / 8: the head before
  // the interior's first 16-byte boundary, then the tail after its last
  const int iv = lane >> 3, e = lane & 7;
  if (iv < n_copy) {
    const bool second = iv == 1;       // registers, not a local array
    const long long g0 = addr(second ? g[1] : g[0]);
    const long long bs = g0 + 4 * (second ? lo[1] : lo[0]);
    const long long be = g0 + 4 * (second ? hi[1] : hi[0]);
    const long long cc0 = second ? c0[1] : c0[0];
    const long long cc1 = second ? c1[1] : c1[0];
    const long long at = second ? off[1] - base[1] : off[0] - base[0];
    const long long head_end = cc1 > cc0 ? cc0 : be;
    const long long tail_from = cc1 > cc0 ? cc1 : be;
    const int n_head = (int)((head_end - bs) / 4);
    const int n_tail = (int)((be - tail_from) / 4);
    long long src = -1;
    if (e < n_head) {
      src = bs + 4 * e;
    } else if (e - n_head < n_tail) {
      src = tail_from + 4 * (e - n_head);
    }
    if (src >= 0) {
      ring::copy4(stage + at + src, reinterpret_cast<const void*>(src));
    }
  }
  if (lane != 0) ring::mbar_arrive(full);
  ring::mbar_arrive_on_copies(full);
}

template <typename T>
__device__ __forceinline__ uint32_t bits(T v);
template <>
__device__ __forceinline__ uint32_t bits<float>(float v) {
  return __float_as_uint(v);
}
template <>
__device__ __forceinline__ uint32_t bits<int32_t>(int32_t v) {
  return (uint32_t)v;
}

// Outputs k .. k + kk - 1 of a tile whose windows are A (na real
// elements, then sentinels) and B (nb), written to out[pos ..], pos <
// n_out.
template <typename T>
__device__ __forceinline__ void merge_run(const T* A, int na, const T* B,
                                          int nb, int k, int kk, T big,
                                          T* out, long long pos,
                                          long long n_out) {
  auto va = [&](int i) { return i < na ? A[i] : big; };
  auto vb = [&](int j) { return j < nb ? B[j] : big; };
  int lo = 0, hi = k;                   // the windows hold T > k elements
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (va(mid) <= vb(k - mid - 1)) lo = mid + 1; else hi = mid;
  }
  int i = lo, j = k - lo;
  T x = va(i), y = vb(j);
  T v[kK];
#pragma unroll
  for (int u = 0; u < kK; ++u) {
    if (u < kk) {
      const bool take_a = !(y < x);     // ties from a first
      v[u] = take_a ? x : y;
      if (take_a) x = va(++i); else y = vb(++j);
    }
  }
  if (kk == kK && pos + kK <= n_out) {
    uint4* dst = reinterpret_cast<uint4*>(out + pos);
    dst[0] = make_uint4(bits(v[0]), bits(v[1]), bits(v[2]), bits(v[3]));
    dst[1] = make_uint4(bits(v[4]), bits(v[5]), bits(v[6]), bits(v[7]));
  } else {
#pragma unroll
    for (int u = 0; u < kK; ++u) {
      if (u < kk && pos + u < n_out) out[pos + u] = v[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_spans_kernel(Params p, T big) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring_buf = smem;
  int4* meta = reinterpret_cast<int4*>(
      smem + (size_t)p.stages * p.stage_bytes);
  int* modes = reinterpret_cast<int*>(meta + kMaxStages * kMaxSpan);
  uint64_t* full = reinterpret_cast<uint64_t*>(modes + 4);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      ring::mbar_init(&full[s], 64);   // 32 lanes, and their cp.async
      ring::mbar_init(&empty[s], kConsumers);
    }
    ring::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {             // the producer warp
    const int lane = tid - kConsumers;
    Split cur = load_split(p, blockIdx.x, lane);
    for (int it = 0, span = blockIdx.x; span < p.n_spans;
         ++it, span += gridDim.x) {
      const int st = it % p.stages, use = it / p.stages;
      const Split nxt = load_split(p, span + gridDim.x, lane);
      if (use > 0) ring::mbar_wait(&empty[st], (uint32_t)(use - 1) & 1);
      ring::fence_proxy_async();
      issue(p, cur, lane, ring_buf + (size_t)st * p.stage_bytes,
            meta + st * kMaxSpan, modes + st, &full[st]);
      cur = nxt;
    }
    return;
  }

  const T* a = reinterpret_cast<const T*>(p.a);
  const T* b = reinterpret_cast<const T*>(p.b);
  T* out = reinterpret_cast<T*>(p.out);
  const int tile = p.tile;
  const int kk = min(kK, tile);
  const int tpt = tile / kk;                 // threads a tile
  const int per_round = kConsumers / tpt;    // tiles merged at once
  const int slot = tid / tpt;
  const int k = (tid - slot * tpt) * kk;
  for (int it = 0, span = blockIdx.x; span < p.n_spans;
       ++it, span += gridDim.x) {
    const int st = it % p.stages;
    ring::mbar_wait(&full[st], (uint32_t)(it / p.stages) & 1);
    const long long t0 = (long long)span * p.span;
    const int cnt = (int)min((long long)p.span, p.n_tiles - t0);
    const int4* mt = meta + st * kMaxSpan;
    T* buf = reinterpret_cast<T*>(ring_buf + (size_t)st * p.stage_bytes);
    if (modes[st] == kSpan) {
      for (int tl = slot; tl < cnt; tl += per_round) {
        const int4 m = mt[tl];
        merge_run(buf + m.x, m.y, buf + m.z, m.w, k, kk, big, out,
                  (t0 + tl) * tile + k, p.n_out);
      }
    } else {
      // per-tile path: a round of tiles, each window pair loaded by the
      // tile's threads into the stage with its sentinels
      T* w = buf + (size_t)slot * 2 * tile;
      for (int r0 = 0; r0 < cnt; r0 += per_round) {
        const int tl = r0 + slot;
        if (r0 > 0) consumers_sync();        // the last round is merged
        if (tl < cnt) {
          const int4 m = mt[tl];
          for (int e = k / kk; e < tile; e += tpt) {
            w[e] = e < m.y ? a[(long long)m.x + e] : big;
            w[tile + e] = e < m.w ? b[(long long)m.z + e] : big;
          }
        }
        consumers_sync();
        if (tl < cnt) {
          merge_run(w, tile, w + tile, tile, k, kk, big, out,
                    (t0 + tl) * tile + k, p.n_out);
        }
      }
      ring::fence_proxy_async();   // before a later bulk copy into the stage
    }
    ring::mbar_arrive(&empty[st]);
  }
}

template <typename T>
int launch(const Params& p, T big, cudaStream_t stream) {
  const size_t smem = (size_t)p.stages * p.stage_bytes + kMetaBytes;
  cudaError_t e = cudaFuncSetAttribute(
      merge_spans_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, merge_spans_kernel<T>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = min(p.n_spans, per_sm * sms);
  merge_spans_kernel<T><<<grid, kThreads, smem, stream>>>(p, big);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b int32 or float32 (is_float) runs; sa, ea, sb, eb (n_tiles,) int32
// window starts and run ends, in elements; out (n_out,), 16-byte
// aligned, n_out <= n_tiles * tile.  tile a power of two, 2 .. 1024;
// `span` tiles a span (1 .. 32), `stages` ring stages (1 .. 4) of
// `stage_bytes` (a multiple of 16, at least one round of per-tile
// windows: (256 / (tile / min(8, tile))) * 2 * tile * 4 bytes).
extern "C" int dae_merge_tiles(const void* a, const void* b, const void* sa,
                               const void* ea, const void* sb, const void* eb,
                               void* out, long long n_out, int n_tiles,
                               int tile, int span, int stages,
                               int stage_bytes, int is_float, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile < 2 || tile > kMaxTile || (tile & (tile - 1)) != 0 || span < 1 ||
      span > kMaxSpan || stages < 1 || stages > kMaxStages ||
      stage_bytes % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int kk = tile < kK ? tile : kK;
  const long long round_bytes = (long long)(kConsumers / (tile / kk)) * 2 *
                                tile * 4;
  if (stage_bytes < round_bytes) return (int)cudaErrorInvalidValue;
  Params p{static_cast<const unsigned char*>(a),
           static_cast<const unsigned char*>(b),
           static_cast<const int32_t*>(sa), static_cast<const int32_t*>(ea),
           static_cast<const int32_t*>(sb), static_cast<const int32_t*>(eb),
           static_cast<unsigned char*>(out), n_out, n_tiles, tile, span,
           stages, stage_bytes, (n_tiles + span - 1) / span};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_float ? launch<float>(p, INFINITY, st)
                  : launch<int32_t>(p, INT32_MAX, st);
}
