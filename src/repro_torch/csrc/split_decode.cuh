// One-token GQA decode attention for Hopper, split across CTAs: the body
// both decodes share.  flash_decode_paged.cu instantiates it over a page
// table, flash_decode.cu over a contiguous cache.
//
// Replaces, in src/repro/kernels/flash_attention/kernel.py,
// flash_decode_paged (_paged_decode_kernel) and flash_decode
// (_decode_kernel): the G query rows of one KV head against the K/V
// blocks of its request, f32 online softmax, cols >= len masked, and
// acc / max(l, 1e-30) at the end.
//
// Bound on this card: bytes.  Each (b, kv head) reads len_b * D K values
// and as many V values once and does 4 * G * D flops per token, about
// G flops per byte in bf16, far below where the tensor cores would set
// the time.  The floor is the visible tokens' K/V bytes over 3.35 TB/s.
//
// Design:
//  * one body, two address policies.  A block is `page` consecutive
//    tokens of one (b, kv head): a pool page the table names (Table), or
//    rows ((b KVH + h) S + j page ...) of a contiguous cache, computed
//    and read from no table (Contig: a contiguous cache is a paged cache
//    with an implicit table);
//  * split-KV fills the card.  A CTA takes one (split, kv head, b), a
//    split being `pps` consecutive blocks of the request.  The wrapper
//    picks pps from the request's width in blocks and the card's SM count
//    so that B x KVH x splits puts about four CTAs on every SM; it never
//    reads `lengths` on the host.  CTAs whose blocks all lie past len
//    exit at once, so short requests cost nothing;
//  * no dependent load before a request: with a table the CTA first reads
//    its split's slice into shared memory in one coalesced read; after
//    that every block address is known before any copy is issued (the
//    paper's decoupled request stream);
//  * bulk copies: a block of one head is one contiguous run of K and one
//    of V.  Lane 0 of a warp brings each in with one cp.async.bulk
//    completing on the mbarrier of its ring stage, so no thread spends
//    registers or instructions on the copy.  The last block of a request
//    is copied only up to len (rows x D x esize stays a multiple of 16);
//  * each warp owns whole blocks (blocks warp, warp + warps, ... of the
//    split) and its own `depth` ring stages, so it waits only on its own
//    mbarriers and needs no CTA barrier per block.  Requests in flight:
//    warps x depth blocks per CTA (`rif` in the wrapper); Little's law
//    wants ~25 KB (three K+V pages of 16 x 128 bf16) per SM, and four
//    CTAs of 4 warps keep 16 blocks in flight even at depth 1;
//  * per 16-token sub-block a warp puts two lanes on each token: lane
//    (t, half) sums half of the 16-byte chunks of K row t against q,
//    starting at chunk (t + half) and stepping by 2 modulo the row's
//    chunks, so the eight rows a quarter-warp reads at once fall in
//    different banks although bulk-copied rows carry no padding (rows of
//    128, 192, 256 or 384 bytes).  q sits in shared memory as f32, its
//    chunks' two float4 halves swapped every four chunks, which keeps
//    those reads conflict-free too.  The two halves meet in one shuffle
//    and the sub-block's max in four; the warp's online softmax (in base
//    2) stays in registers, each lane summing its own tokens' p until the
//    warp's blocks are done; p goes through shared memory to the p @ v
//    update, where lane l owns the column pairs l, l + 32, l + 64 (PPL of
//    them: one pair to D 64, two to D 128, three to D 192), so a warp
//    reads a V row as 32 consecutive 4-byte (bf16) or 8-byte (f32) words,
//    aligned at every D;
//  * at the end the CTA merges its warps' (m, l, acc) once in shared
//    memory, one thread per query row computing the weights and every
//    thread a float4 of columns.  With one active split it writes the
//    output; otherwise it writes an f32 partial (acc[G, D], m, l), and
//    the last CTA of the (b, kv head) to finish, found through a
//    per-(b, h) counter that it resets, merges the partials by
//    log-sum-exp in the same launch, each thread's loads of the splits
//    independent of each other.
//    Only rows with index < len are scored or read, and an all-masked
//    warp or split carries m = -1e30 and weight 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "numerics.cuh"
#include "ring.cuh"

namespace split {

constexpr int kWarps = 4;        // per CTA (kernel.py PAGED_WARPS)
constexpr int kMaxD = 192;       // PPL <= 3 column pairs per lane
constexpr int kSub = 16;         // tokens per softmax sub-block: 2 lanes each
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

using num::from_f32;
using num::to_f32;

// Block j of (b, h) in a page pool (NP, KVH, page, d): the page the
// split's slice of the table, already in shared memory, names.
struct Table {
  static constexpr bool kTable = true;
  const int32_t* table;          // (B, nblk) int32 pool pages
  __device__ __forceinline__ long long offset(const int32_t* tbl, int jl,
                                              int, int, int h, int kvh,
                                              int page, int d) const {
    return ((long long)tbl[jl] * kvh + h) * page * d;
  }
};

// Block j of (b, h) in a contiguous cache (B, KVH, s, d).
struct Contig {
  static constexpr bool kTable = false;
  long long s;
  __device__ __forceinline__ long long offset(const int32_t*, int, int j,
                                              int b, int h, int kvh,
                                              int page, int d) const {
    return (((long long)b * kvh + h) * s + (long long)j * page) * d;
  }
};

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Floats before the warps' acc in the warp merge: wm, wl, weights (each
// kWarps x G) and the CTA's (m, l), rounded to whole float4s.
__host__ __device__ constexpr int merge_head(int g) {
  return (3 * kWarps * g + 2 * g + 3) / 4 * 4;
}

// Floats of one split's partial: acc (G, d), m (G), l (G), rounded so
// every split's acc starts 16-byte aligned.
__host__ __device__ constexpr size_t partial_floats(int g, int d) {
  return (size_t)g * d + ((size_t)2 * g + 3) / 4 * 4;
}

// Shared memory: the ring (warps x depth stages of a K and a V block),
// which the merges reuse after the block loop (the warps' (m, l, weight,
// acc), then the splits' weights); the stages' mbarriers; q as f32; each
// warp's p; the split's page ids; one flag.
struct Layout {
  size_t region, bars, q, p, tbl, flag, total;
  __host__ __device__ Layout(int g, int d, int page, int depth, int pps,
                             int nsplit, int esize) {
    const size_t ring = (size_t)kWarps * depth * 2 * page * d * esize;
    const size_t warp_merge =
        ((size_t)merge_head(g) + (size_t)kWarps * g * d) * 4;
    const size_t split_merge = (size_t)nsplit * 2 * g * 4;
    const size_t top = ring > warp_merge ? ring : warp_merge;
    region = round16(top > split_merge ? top : split_merge);
    bars = region;
    q = bars + round16((size_t)kWarps * depth * sizeof(uint64_t));
    p = q + round16((size_t)g * d * sizeof(float));
    tbl = p + round16((size_t)kWarps * g * kSub * sizeof(float));
    flag = tbl + round16((size_t)pps * sizeof(int32_t));
    total = flag + 16;
  }
};

// One 16-byte chunk of a shared-memory row, widened to float.
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Two consecutive values of a shared-memory V row (even column), as
// floats.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Four consecutive output values from f32.
__device__ __forceinline__ void store4(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a) {
  uint2 v;
  v.x = num::pack(a.x, a.y);
  v.y = num::pack(a.z, a.w);
  *reinterpret_cast<uint2*>(p) = v;
}

template <typename T, int G, int PPL, class Addr>
__global__ void __launch_bounds__(32 * kWarps)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, Addr addr,
              const int32_t* __restrict__ lengths, T* __restrict__ out,
              float* __restrict__ part, int32_t* __restrict__ counters,
              int kvh, int d, int nblk, int page, int cap, int pps,
              int nsplit, int depth, float scale) {
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte chunk
  constexpr int kSwz = kVec / 4 - 1;        // q's float4 halves: bf16 only
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int len = max(0, min(lengths[b], cap));
  const int nblocks = (len + page - 1) / page;
  const int nactive = max(1, (nblocks + pps - 1) / pps);
  if (split >= nactive) return;             // every block past len
  const int first = split * pps;
  const int mine = max(0, min(pps, nblocks - first));

  const Layout lay(G, d, page, depth, pps, nsplit, sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  float* q_sh = reinterpret_cast<float*>(smem + lay.q);
  float* p_sh = reinterpret_cast<float*>(smem + lay.p);
  int32_t* tbl = reinterpret_cast<int32_t*>(smem + lay.tbl);
  int* flag = reinterpret_cast<int*>(smem + lay.flag);

  if constexpr (Addr::kTable) {
    for (int i = threadIdx.x; i < mine; i += blockDim.x) {
      tbl[i] = addr.table[(long long)b * nblk + first + i];
    }
  }
  const long long qoff = ((long long)b * kvh + h) * G * d;
  for (int i = threadIdx.x; i < G * d; i += blockDim.x) {
    const int g = i / d, col = i % d, c = col / kVec, e = col % kVec;
    const int sw = (c >> 2) & kSwz;
    q_sh[g * d + c * kVec + (((e >> 2) ^ sw) << 2) + (e & 3)] =
        to_f32(q[qoff + i]);
  }
  uint64_t* wbars = bars + warp * depth;
  if (lane == 0) {
    for (int s = 0; s < depth; ++s) ring::mbar_init(&wbars[s], 1);
    ring::mbar_init_fence();
  }
  __syncthreads();

  // this warp's blocks of the split: warp, warp + warps, ...
  const int cnt = mine > warp ? (mine - warp + kWarps - 1) / kWarps : 0;
  const int block_elems = page * d;
  T* wring = ring + (size_t)warp * depth * 2 * block_elems;
  auto request = [&](int u) {               // lane 0: the warp's u-th block
    const int jl = warp + u * kWarps, j = first + jl;
    const long long off = addr.offset(tbl, jl, j, b, h, kvh, page, d);
    const uint32_t bytes =
        (uint32_t)min(page, len - j * page) * d * sizeof(T);
    const int s = u % depth;
    T* dst = wring + (size_t)s * 2 * block_elems;
    ring::mbar_expect(&wbars[s], 2 * bytes);
    ring::bulk_copy(dst, kp + off, bytes, &wbars[s]);
    ring::bulk_copy(dst + block_elems, vp + off, bytes, &wbars[s]);
  };
  if (lane == 0) {
    for (int u = 0; u < min(depth, cnt); ++u) request(u);
  }

  float m[G], l[G], acc[G][2 * PPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * PPL; ++c) acc[g][c] = 0.f;
  }
  // scores in log2 units: exp(x * scale) = exp2(x * scale * log2(e))
  const float scale2 = scale * 1.4426950408889634f;
  const int tl = lane & (kSub - 1);
  const int half = lane / kSub;
  const int nchunks = d / kVec;
  const int c_first = nchunks > 0 ? (half + tl) % nchunks : 0;
  const int npairs = d / 2;
  float* pw = p_sh + warp * G * kSub;

  for (int u = 0; u < cnt; ++u) {
    const int s = u % depth;
    ring::mbar_wait(&wbars[s], (u / depth) & 1);
    const T* ks = wring + (size_t)s * 2 * block_elems;
    const T* vs = ks + block_elems;
    const int visible = min(page, len - (first + warp + u * kWarps) * page);
    for (int sb = 0; sb < visible; sb += kSub) {
      const int rows = min(kSub, visible - sb);
      const bool valid = tl < rows;
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      if (valid) {
        const T* krow = ks + (sb + tl) * d;
        int c = c_first;
        for (int pc = half; pc < nchunks; pc += 2) {
          float kv[kVec];
          load_chunk(krow + c * kVec, kv);
          const int sw = (c >> 2) & kSwz;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float* qc = q_sh + g * d + c * kVec;
#pragma unroll
            for (int x = 0; x < kVec / 4; ++x) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qc + ((x ^ sw) << 2));
              dot[g] = fmaf(qv.x, kv[4 * x], dot[g]);
              dot[g] = fmaf(qv.y, kv[4 * x + 1], dot[g]);
              dot[g] = fmaf(qv.z, kv[4 * x + 2], dot[g]);
              dot[g] = fmaf(qv.w, kv[4 * x + 3], dot[g]);
            }
          }
          c += 2;
          if (c >= nchunks) c -= nchunks;
        }
      }
      float alpha[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sc = dot[g] + __shfl_xor_sync(kFull, dot[g], kSub);
        sc = valid ? sc * scale2 : kNegInf;
        float mx = sc;
#pragma unroll
        for (int o = kSub / 2; o > 0; o >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        }
        const float m_new = fmaxf(m[g], mx);
        const float p = valid ? exp2f(sc - m_new) : 0.f;
        alpha[g] = exp2f(m[g] - m_new);
        l[g] = l[g] * alpha[g] + p;         // this lane's token; summed below
        m[g] = m_new;
        if (half == 0) pw[g * kSub + tl] = p;
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int c = 0; c < 2 * PPL; ++c) acc[g][c] *= alpha[g];
      }
      for (int t4 = 0; t4 < rows; t4 += 4) {
        float4 pv[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          pv[g] = *reinterpret_cast<const float4*>(pw + g * kSub + t4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (t4 + e < rows) {                // rows past len: never read
            const T* vrow = vs + (sb + t4 + e) * d;
#pragma unroll
            for (int i = 0; i < PPL; ++i) {
              const int pair = lane + 32 * i;
              if (pair < npairs) {
                const float2 v = load_pair(vrow + 2 * pair);
#pragma unroll
                for (int g = 0; g < G; ++g) {
                  const float pe = e == 0 ? pv[g].x : e == 1 ? pv[g].y
                                   : e == 2 ? pv[g].z : pv[g].w;
                  acc[g][2 * i] = fmaf(pe, v.x, acc[g][2 * i]);
                  acc[g][2 * i + 1] = fmaf(pe, v.y, acc[g][2 * i + 1]);
                }
              }
            }
          }
        }
      }
      __syncwarp();                         // pw is rewritten next
    }
    if (lane == 0 && u + depth < cnt) {     // stage s is free again
      ring::fence_proxy_async();
      request(u + depth);
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {             // the warp's l: its 16 tokens
#pragma unroll
    for (int o = kSub / 2; o > 0; o >>= 1) {
      l[g] += __shfl_xor_sync(kFull, l[g], o);
    }
  }

  // merge the warps once: the ring becomes (m, l, weight, acc) per warp
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);      // (warps, G)
  float* wl = wm + kWarps * G;                      // (warps, G)
  float* wgt = wl + kWarps * G;                     // (warps, G)
  float* stat = wgt + kWarps * G;                   // m, l: (2, G)
  float* wacc = wm + merge_head(G);                 // (warps, G, d)
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
  }
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int pair = lane + 32 * i;
    if (pair < npairs) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float* dst = wacc + (warp * G + g) * d + 2 * pair;
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[g][2 * i], acc[g][2 * i + 1]);
      }
    }
  }
  __syncthreads();
  const bool direct = nactive == 1;
  if (threadIdx.x < G) {                    // one thread per query row
    const int g = threadIdx.x;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      wgt[w * G + g] = exp2f(wm[w * G + g] - mx);
      sum += wl[w * G + g] * wgt[w * G + g];
    }
    if (direct) {                           // fold 1 / l into the weights
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      for (int w = 0; w < kWarps; ++w) wgt[w * G + g] *= inv;
    }
    stat[g] = mx;
    stat[G + g] = sum;
  }
  __syncthreads();

  // partials: acc (G, d), then m (G) and l (G), 16-byte aligned per split
  const size_t pstride = partial_floats(G, d);
  const long long bh = (long long)b * kvh + h;
  float* my_part = part + ((size_t)bh * nsplit + split) * pstride;
  for (int i = threadIdx.x; i < G * d / 4; i += blockDim.x) {
    const int g = i * 4 / d;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 x =
          *reinterpret_cast<const float4*>(wacc + w * G * d + i * 4);
      const float k = wgt[w * G + g];
      a.x = fmaf(k, x.x, a.x); a.y = fmaf(k, x.y, a.y);
      a.z = fmaf(k, x.z, a.z); a.w = fmaf(k, x.w, a.w);
    }
    if (direct) {
      store4(out + qoff + i * 4, a);
    } else {
      __stcg(reinterpret_cast<float4*>(my_part) + i, a);
    }
  }
  if (direct) return;
  if (threadIdx.x < 2 * G) {
    __stcg(my_part + G * d + threadIdx.x, stat[threadIdx.x]);
  }

  // the last active split of (b, h) to finish merges all of them: the
  // splits' weights exp(m_s - m) / l first, then each thread's float4
  // columns of every split's acc, its loads independent of each other
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(&counters[bh], 1);
    *flag = done == nactive - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* parts = part + (size_t)bh * nsplit * pstride;
  float* sm = reinterpret_cast<float*>(smem);      // (nactive, G): m, weight
  float* sl = sm + nactive * G;                     // (nactive, G): l
  for (int i = threadIdx.x; i < nactive * 2 * G; i += blockDim.x) {
    const int s = i / (2 * G), k = i % (2 * G);
    (k < G ? sm : sl)[s * G + k % G] = __ldcg(parts + s * pstride + G * d + k);
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = kNegInf;
    for (int s = 0; s < nactive; ++s) mx = fmaxf(mx, sm[s * G + g]);
    float sum = 0.f;
    for (int s = 0; s < nactive; ++s) {
      const float k = exp2f(sm[s * G + g] - mx);
      sm[s * G + g] = k;
      sum += sl[s * G + g] * k;
    }
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    for (int s = 0; s < nactive; ++s) sm[s * G + g] *= inv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * d / 4; i += blockDim.x) {
    const int g = i * 4 / d;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < nactive; ++s) {
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(parts + s * pstride) + i);
      const float k = sm[s * G + g];
      a.x = fmaf(k, x.x, a.x); a.y = fmaf(k, x.y, a.y);
      a.z = fmaf(k, x.z, a.z); a.w = fmaf(k, x.w, a.w);
    }
    store4(out + qoff + i * 4, a);
  }
  if (threadIdx.x == 0) counters[bh] = 0;   // ready for the next call
}

// The geometry of one call: nblk blocks of `page` tokens per request, at
// most `cap` visible tokens, splits of `pps` blocks, `depth` stages a warp.
struct Shape {
  int batch, kvh, g, d, nblk, page, cap, pps, nsplit, depth;
};

template <typename T, int G, int PPL, class Addr>
int launch_g(const void* q, const void* k, const void* v, Addr addr,
             const void* lengths, void* out, void* part, void* counters,
             const Shape& s, float scale, void* stream) {
  const Layout lay(G, s.d, s.page, s.depth, s.pps, s.nsplit, sizeof(T));
  auto kernel = decode_kernel<T, G, PPL, Addr>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(s.nsplit, s.kvh, s.batch);
  kernel<<<grid, 32 * kWarps, lay.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), addr, static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int32_t*>(counters), s.kvh, s.d, s.nblk, s.page, s.cap,
      s.pps, s.nsplit, s.depth, scale);
  return (int)cudaGetLastError();
}

template <typename T, int G, class Addr>
int launch_ppl(const void* q, const void* k, const void* v, Addr addr,
               const void* lengths, void* out, void* part, void* counters,
               const Shape& s, float scale, void* stream) {
  // column pairs per lane in the p @ v update: the fewest that cover D
  if (s.d <= 64) {
    return launch_g<T, G, 1>(q, k, v, addr, lengths, out, part, counters, s,
                             scale, stream);
  }
  if (s.d <= 128) {
    return launch_g<T, G, 2>(q, k, v, addr, lengths, out, part, counters, s,
                             scale, stream);
  }
  return launch_g<T, G, 3>(q, k, v, addr, lengths, out, part, counters, s,
                           scale, stream);
}

template <typename T, class Addr>
int launch(const void* q, const void* k, const void* v, Addr addr,
           const void* lengths, void* out, void* part, void* counters,
           const Shape& s, float scale, void* stream) {
  if (s.d < 1 || s.d > kMaxD || (s.d * (int)sizeof(T)) % 16 != 0 ||
      s.page < 1 || s.nblk < 1 || s.pps < 1 || s.nsplit < 1 ||
      (long long)s.pps * s.nsplit < s.nblk || s.depth < 1 ||
      kWarps * s.depth > ring::kMaxRif || s.cap < 0 ||
      (long long)s.nblk * s.page < s.cap) {
    return (int)cudaErrorInvalidValue;
  }
  // every group size from 1 to 8 (granite-moe-3b-a800m has G = 3, MLA
  // decodes with G = 1)
#define REPRO_SPLIT_G(G)                                                    \
  case G: return launch_ppl<T, G>(q, k, v, addr, lengths, out, part,        \
                                  counters, s, scale, stream);
  switch (s.g) {
    REPRO_SPLIT_G(1) REPRO_SPLIT_G(2) REPRO_SPLIT_G(3) REPRO_SPLIT_G(4)
    REPRO_SPLIT_G(5) REPRO_SPLIT_G(6) REPRO_SPLIT_G(7) REPRO_SPLIT_G(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SPLIT_G
}

template <class Addr>
int launch_dtype(const void* q, const void* k, const void* v, Addr addr,
                 const void* lengths, void* out, void* part, void* counters,
                 const Shape& s, float scale, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(q, k, v, addr, lengths, out, part,
                                      counters, s, scale, stream)
              : launch<float>(q, k, v, addr, lengths, out, part, counters, s,
                              scale, stream);
}

}  // namespace split

// Shared memory one CTA of the kernel takes, in bytes.
extern "C" long long split_decode_smem(int g_rows, int d, int page, int depth,
                                       int pps, int nsplit, int bf16) {
  return (long long)split::Layout(g_rows, d, page, depth, pps, nsplit,
                                  bf16 ? 2 : 4).total;
}

// Floats of one split's partial in the `part` scratch.
extern "C" long long split_decode_partial(int g_rows, int d) {
  return (long long)split::partial_floats(g_rows, d);
}
