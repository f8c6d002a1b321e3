// One-token GQA decode attention for Hopper over a contiguous KV cache.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_decode
// (_decode_kernel, through _decode_step): the G query rows of one KV head
// against K/V blocks streamed through RingChannels, f32 online softmax,
// cols >= len masked to -1e30, and acc / max(l, 1e-30) at the end.  The
// paged decode has its own design in flash_decode_paged.cu.
//
// Bound on this card: bytes.  Each (b, kv head) reads len_b * D K values
// and as many V values once and does 4 * G * D flops per token, about
// G = 4 flops per byte in bf16, far below the ~295 flops per byte where
// the H100's tensor cores would become the limit.  The floor is the K/V
// bytes of the visible tokens over 3.35 TB/s.
//
// Design:
//  * one CTA per (b, kv head): the G query rows and the G x D f32
//    accumulator stay on chip (q and the scores in shared memory, the
//    accumulator in registers), so the K/V stream is read exactly once;
//  * K/V blocks of bk tokens stream through the ring.cuh ring, rif deep,
//    rif from the port's plan_rif clamped to shared memory; block k is
//    rows k * bk .. of (b, h) in the cache (the Addr policy below);
//  * only blocks with k * bk < len are visited, and only their visible
//    rows are copied and read.  For len >= 1 this is exact: a fully
//    masked block contributes exp(-1e30 - m) = 0 with alpha = 1.  The
//    TPU kernel visits every block of the horizon, and its wrapper pads
//    the contiguous cache to a multiple of bk with a full copy each call;
//    this kernel needs no padding;
//  * per block the CTA's threads work without warp-wide reductions: the
//    G x bk scores are split over all threads, a few adjacent lanes per
//    score each summing part of the 16-byte chunks of one K row (rows sit
//    one chunk apart in shared memory, so the rows a warp reads at once
//    fall in different banks); the accumulator gives each thread one
//    head-dim column for all G rows.  G is a template parameter (every G
//    from 1 to 8), so the per-row loops unroll.  Below D = 128 the
//    threads past column D own no accumulator column: they still copy,
//    score and reduce, and skip only the p @ v update and the store;
//  * at small batch the card is under-filled: B x KVH CTAs (64 for 8
//    slots x 8 KV heads) on 132 SMs, and the longest sequence sets the
//    time.  flash_decode_paged.cu splits the KV stream across CTAs; this
//    body keeps one CTA per (b, kv head).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "numerics.cuh"
#include "ring.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = kThreads;   // one head-dim column per thread
constexpr float kNegInf = -1e30f;

using num::from_f32;
using num::to_f32;

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

// Block addressing of the contiguous cache.
struct Contig {                  // caches (B, KVH, S, D)
  long long s;
  __device__ long long first_row(int b, int h, int kvh, int k, int bk) const {
    return ((long long)b * kvh + h) * s + (long long)k * bk;
  }
  __device__ int max_tokens() const { return (int)s; }
};

template <typename T, int G, class Addr>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int32_t* __restrict__ lengths,
              T* __restrict__ out, int kvh, int d, int bk, int rif,
              int split, float scale, Addr addr) {
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte chunk
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nvec = d / kVec;                // chunks per K/V row
  const int pitch = d + kVec;               // shared row pitch, elements
  const int tile = bk * pitch;              // one K or V block, elements
  const int qp = d + 4;                     // q row pitch: rows 4 banks apart

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring_buf = reinterpret_cast<T*>(smem);           // rif x [K | V]
  float* q_sh = reinterpret_cast<float*>(
      smem + (size_t)rif * 2 * tile * sizeof(T));     // (G, qp)
  float* s_sh = q_sh + G * qp;                        // (G, bk) scores / p
  float* m_sh = s_sh + G * bk;                        // running max
  float* l_sh = m_sh + G;                             // running sum
  float* a_sh = l_sh + G;                             // this block's alpha

  const int len = max(0, min(lengths[b], addr.max_tokens()));
  const int n = (len + bk - 1) / bk;        // blocks holding a visible row

  const long long qoff = ((long long)b * kvh + h) * G * d;
  for (int i = tid; i < G * d; i += kThreads) {
    q_sh[i / d * qp + i % d] = to_f32(q[qoff + i]);
  }
  if (tid < G) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  __syncthreads();

  // Access: request block k (its visible rows of K and V) into `slot`.
  auto fetch = [&](int k, int slot) {
    const int rows = min(bk, len - k * bk);
    const long long row0 = addr.first_row(b, h, kvh, k, bk);
    T* dst = ring_buf + (size_t)slot * 2 * tile;
    const int row_bytes = d * (int)sizeof(T);
    const int dst_pitch = pitch * (int)sizeof(T);
    ring::request_rows(dst, dst_pitch, kc + row0 * d, row_bytes, rows,
                       row_bytes);
    ring::request_rows(dst + tile, dst_pitch, vc + row0 * d, row_bytes, rows,
                       row_bytes);
  };

  // Execute: the online-softmax update for block k.
  auto execute = [&](int k, int slot) {
    const T* ks = ring_buf + (size_t)slot * 2 * tile;
    const T* vs = ks + tile;
    const int rows = min(bk, len - k * bk);

    // scores: item w = ((t * G + g) * split + part); the `split` lanes of
    // one (t, g) are adjacent and sum disjoint chunks of K row t
    const int items = bk * G * split;
    for (int base = 0; base < items; base += kThreads) {
      const int w = base + tid;
      const int part = w % split;
      const int t = w / split / G;
      const int g = w / split % G;
      float dot = 0.f;
      if (w < items && t < rows) {
        const T* krow = ks + t * pitch;
        const float* qrow = q_sh + g * qp;
        for (int c = part; c < nvec; c += split) {
          float kv[kVec];
          load_chunk(krow + c * kVec, kv);
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot += qrow[c * kVec + e] * kv[e];
        }
      }
      for (int o = split / 2; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (w < items && t < rows && part == 0) s_sh[g * bk + t] = dot * scale;
    }
    __syncthreads();

    // softmax statistics: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* srow = s_sh + g * bk;
      float mx = kNegInf;
      for (int t = lane; t < rows; t += 32) mx = fmaxf(mx, srow[t]);
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_prev = m_sh[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < rows; t += 32) {
        const float p = expf(srow[t] - m_new);
        srow[t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_sh[g] = alpha;
        l_sh[g] = l_sh[g] * alpha + sum;
        m_sh[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v: thread tid owns column tid of all G rows
    if (tid < d) {
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] *= a_sh[g];
      for (int t = 0; t < rows; ++t) {
        const float v = to_f32(vs[t * pitch + tid]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += s_sh[g * bk + t] * v;
      }
    }
  };

  ring::access_execute(n, rif, fetch, execute);

  if (tid < d) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      out[qoff + g * d + tid] = from_f32<T>(acc[g] / fmaxf(l_sh[g], 1e-30f));
    }
  }
}

template <typename T, int G, class Addr>
int launch_g(const void* q, const void* k, const void* v, const void* lengths,
             void* out, int batch, int kvh, int d, int bk, int rif,
             float scale, Addr addr, void* stream) {
  // lanes per score: the largest power of two that keeps the G x bk
  // scores of a block within one pass of the CTA's threads
  int split = 1;
  while (split < 32 && bk * G * split * 2 <= kThreads) split *= 2;
  const int pitch = d + 16 / (int)sizeof(T);
  const size_t smem = (size_t)rif * 2 * bk * pitch * sizeof(T) +
      (size_t)(G * (d + 4) + G * bk + 3 * G) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<T, G, Addr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(kvh, batch);
  decode_kernel<T, G, Addr><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), kvh, d, bk, rif, split, scale, addr);
  return (int)cudaGetLastError();
}

template <typename T, class Addr>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int batch, int kvh, int g_rows, int d, int bk, int rif,
           float scale, Addr addr, void* stream) {
  if (d < 1 || d > kMaxD || (d * (int)sizeof(T)) % 16 != 0 || rif < 1 ||
      rif > ring::kMaxRif || bk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // every group size from 1 to 8 (granite-moe-3b-a800m has G = 3)
#define REPRO_DECODE_G(G)                                                  \
  case G: return launch_g<T, G>(q, k, v, lengths, out, batch, kvh, d, bk,  \
                                rif, scale, addr, stream);
  switch (g_rows) {
    REPRO_DECODE_G(1) REPRO_DECODE_G(2) REPRO_DECODE_G(3) REPRO_DECODE_G(4)
    REPRO_DECODE_G(5) REPRO_DECODE_G(6) REPRO_DECODE_G(7) REPRO_DECODE_G(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_G
}

}  // namespace

// q (B, KVH, G, D); caches (B, KVH, S, D); lengths (B,) int32.
extern "C" int flash_decode_contig(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, int batch,
                                   int kvh, int g_rows, int d, long long s,
                                   int bk, int rif, float scale, int bf16,
                                   void* stream) {
  const Contig addr{s};
  return bf16 ? launch<__nv_bfloat16>(q, k, v, lengths, out, batch, kvh,
                                      g_rows, d, bk, rif, scale, addr, stream)
              : launch<float>(q, k, v, lengths, out, batch, kvh, g_rows, d, bk,
                              rif, scale, addr, stream);
}
