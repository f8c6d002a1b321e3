// Forward (prefill) GQA flash attention for Hopper, causal and sliding
// window, without a KV cache.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash
// (_flash_kernel): a (b, h, q-block, k-block) grid where the k-block axis
// runs in order and carries the f32 online softmax (running max, sum and
// accumulator) in scratch; head h reads KV head h // G; masks cols < s_real,
// cols <= rows (causal) and cols >= rows - window + 1; NEG_INF = -1e30;
// the output is acc / max(l, 1e-30).
//
// Bound on this card: operations at a prefill's lengths.  A q block of 64
// rows against S keys does 4 x 64 x S x D flops for 2 x S x D x 2 bytes of
// K/V, about 64 flops per byte, and the tensor cores are the limit only
// above ~295; but K/V blocks are shared by the q blocks and heads of one
// KV head through the L2, so the floor is the visible (row, col) pairs x
// 4 x D flops over 989 TFLOP/s.
//
// Design:
//  * one CTA per (b, h, 64-row q block); the k-block axis of the TPU grid
//    becomes a loop inside the CTA, so the online-softmax state stays in
//    registers (CUDA blocks run in no order and share no scratch);
//  * K/V blocks stream through the ring.cuh cp.async ring, rif deep;
//    rows past Sk are zero-filled, where the TPU wrapper pads S to a
//    multiple of the block with a copy of q, k and v;
//  * only k blocks holding a visible column for some row of the q block
//    are visited: up to the diagonal when causal, from the window's start
//    when windowed.  This is exact: a fully masked block gives p = 0 and
//    alpha = 1 once a row has seen a visible column, and what it adds
//    before that (p = 1 against m = -1e30) is wiped by the first visible
//    block's alpha = exp(-1e30 - m) = 0.  The TPU kernel walks all blocks;
//  * bf16 runs on the tensor cores (mma.sync m16n8k16): each warp owns
//    16 q rows, S = Q K^T and the f32 accumulator O stay in registers,
//    the softmax is reduced over the four lanes that share a row, and P
//    enters P V as two bf16 operands, its head and its remainder, so it
//    keeps 16 mantissa bits (one bf16 P would move an output by up to
//    2^-9 of the largest term, more than the one-ulp tolerance allows
//    where terms cancel).  float32 runs as plain FMAs in float32: two
//    threads per q row, each with half the head dimension.
//    A row without any visible column (only with Sk = 0) comes out 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "numerics.cuh"
#include "ring.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int BQ = 64;            // query rows per CTA
constexpr int BK_MMA = 64;        // keys per stage, tensor-core path
constexpr int BK_FMA = 32;        // keys per stage, float32 path
constexpr float kNegInf = -1e30f;

template <typename T> __host__ __device__ constexpr int block_keys() {
  return sizeof(T) == 2 ? BK_MMA : BK_FMA;
}
// K/V rows one 16-byte chunk apart in shared memory, so the rows a warp
// reads at once fall in different banks
template <typename T> __host__ __device__ constexpr int pitch(int d) {
  return d + 16 / (int)sizeof(T);
}

struct Args {
  int h, kvh, sq, sk, causal, window;
  float scale;
  int rif;
};

__device__ __forceinline__ bool visible(int row, int col, const Args& a) {
  return col < a.sk && (!a.causal || col <= row) &&
         (a.window <= 0 || col >= row - a.window + 1);
}

// The k blocks [lo, lo + n) holding a visible column for some row of the
// q block starting at q0.
__device__ __forceinline__ void key_blocks(int q0, int bk, const Args& a,
                                           int& lo, int& n) {
  const int q_last = min(q0 + BQ, a.sq) - 1;
  const int hi = a.causal ? min(a.sk, q_last + 1) : a.sk;   // exclusive
  const int first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  lo = first / bk;
  n = hi > first ? (hi + bk - 1) / bk - lo : 0;
}

// Access: request keys [k0, k0 + bk) of K and V into one ring slot.
template <typename T, int D>
__device__ __forceinline__ void fetch_kv(T* ks, const T* kh, const T* vh,
                                         int k0, int bk, int sk) {
  constexpr int P = pitch<T>(D);
  constexpr int chunks = D * (int)sizeof(T) / 16;
  T* vs = ks + bk * P;
  const int rows = min(bk, sk - k0);
  for (int c = threadIdx.x; c < bk * chunks; c += kThreads) {
    const int r = c / chunks;
    const int col = c % chunks * (16 / (int)sizeof(T));
    const long long src = (long long)(k0 + r) * D + col;
    ring::copy16_or_zero(ks + r * P + col, kh + src, r < rows);
    ring::copy16_or_zero(vs + r * P + col, vh + src, r < rows);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, Args a) {
  constexpr int P = pitch<bf16>(D);
  constexpr int BK = BK_MMA;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv = head / (a.h / a.kvh);
  const bf16* qh = q + ((long long)b * a.h + head) * a.sq * D;
  const bf16* kh = k + ((long long)b * a.kvh + kv) * a.sk * D;
  const bf16* vh = v + ((long long)b * a.kvh + kv) * a.sk * D;
  bf16* oh = out + ((long long)b * a.h + head) * a.sq * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r_lo = q0 + 16 * warp + g;     // this thread's two query rows
  const int r_hi = r_lo + 8;

  // Q as A fragments, read once
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 16 * kk + 2 * tq;
    qa[kk][0] = r_lo < a.sq ? num::ld_pair(qh + (long long)r_lo * D + c) : 0u;
    qa[kk][1] = r_hi < a.sq ? num::ld_pair(qh + (long long)r_hi * D + c) : 0u;
    qa[kk][2] = r_lo < a.sq ? num::ld_pair(qh + (long long)r_lo * D + c + 8)
                            : 0u;
    qa[kk][3] = r_hi < a.sq ? num::ld_pair(qh + (long long)r_hi * D + c + 8)
                            : 0u;
  }
  // O: [nj][0..1] row r_lo, [nj][2..3] row r_hi, columns 8 nj + 2 tq + {0,1}
  float o[D / 8][4] = {};
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  int lo, n;
  key_blocks(q0, BK, a, lo, n);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring_buf = reinterpret_cast<bf16*>(smem);     // rif x [K | V]

  auto fetch = [&](int i, int slot) {
    fetch_kv<bf16, D>(ring_buf + (size_t)slot * 2 * BK * P, kh, vh,
                      (lo + i) * BK, BK, a.sk);
  };

  auto execute = [&](int i, int slot) {
    const bf16* ks = ring_buf + (size_t)slot * 2 * BK * P;
    const bf16* vs = ks + BK * P;
    const int k0 = (lo + i) * BK;
    // S = Q K^T: [nj] covers keys 8 nj .. 8 nj + 7 of the block
    float s[BK / 8][4];
#pragma unroll
    for (int nj = 0; nj < BK / 8; ++nj) {
      s[nj][0] = s[nj][1] = s[nj][2] = s[nj][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* kr = ks + (8 * nj + g) * P + 16 * kk + 2 * tq;
        const uint32_t kb[2] = {num::ld_pair(kr), num::ld_pair(kr + 8)};
        num::mma_bf16(s[nj], qa[kk], kb);
      }
    }
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int nj = 0; nj < BK / 8; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * nj + 2 * tq + (e & 1);
        const bool vis = visible(e < 2 ? r_lo : r_hi, col, a);
        s[nj][e] = vis ? s[nj][e] * a.scale : kNegInf;
        if (e < 2) mx_lo = fmaxf(mx_lo, s[nj][e]);
        else mx_hi = fmaxf(mx_hi, s[nj][e]);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {   // the four lanes of a row
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o_));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o_));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nj = 0; nj < BK / 8; ++nj) {
      s[nj][0] = expf(s[nj][0] - mn_lo);
      s[nj][1] = expf(s[nj][1] - mn_lo);
      s[nj][2] = expf(s[nj][2] - mn_hi);
      s[nj][3] = expf(s[nj][3] - mn_hi);
      sum_lo += s[nj][0] + s[nj][1];
      sum_hi += s[nj][2] + s[nj][3];
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o_);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o_);
    }
    const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int nj = 0; nj < D / 8; ++nj) {
      o[nj][0] *= al_lo;
      o[nj][1] *= al_lo;
      o[nj][2] *= al_hi;
      o[nj][3] *= al_hi;
    }
    // O += P V: the S accumulators of keys 16 kk .. 16 kk + 15 are the A
    // fragment of P for that k step, split into a bf16 head and a bf16
    // remainder so P keeps 16 bits of mantissa
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int nj = 2 * kk + r / 2, e = 2 * (r % 2);
        num::split(s[nj][e], s[nj][e + 1], ph[r], pl[r]);
      }
#pragma unroll
      for (int nj = 0; nj < D / 8; ++nj) {
        const bf16* vc = vs + (16 * kk + 2 * tq) * P + 8 * nj + g;
        const uint32_t vb[2] = {num::pack(vc[0], vc[P]),
                                num::pack(vc[8 * P], vc[9 * P])};
        num::mma_bf16(o[nj], ph, vb);
        num::mma_bf16(o[nj], pl, vb);
      }
    }
  };

  ring::access_execute(n, a.rif, fetch, execute);

  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int nj = 0; nj < D / 8; ++nj) {
    const int c = 8 * nj + 2 * tq;
    if (r_lo < a.sq) {
      *reinterpret_cast<__nv_bfloat162*>(oh + (long long)r_lo * D + c) =
          __floats2bfloat162_rn(o[nj][0] / den_lo, o[nj][1] / den_lo);
    }
    if (r_hi < a.sq) {
      *reinterpret_cast<__nv_bfloat162*>(oh + (long long)r_hi * D + c) =
          __floats2bfloat162_rn(o[nj][2] / den_hi, o[nj][3] / den_hi);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Args a) {
  constexpr int P = pitch<T>(D);
  constexpr int BK = BK_FMA;
  constexpr int HD = D / 2;                // columns per thread
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv = head / (a.h / a.kvh);
  const T* qh = q + ((long long)b * a.h + head) * a.sq * D;
  const T* kh = k + ((long long)b * a.kvh + kv) * a.sk * D;
  const T* vh = v + ((long long)b * a.kvh + kv) * a.sk * D;
  T* oh = out + ((long long)b * a.h + head) * a.sq * D;
  const int row = q0 + threadIdx.x / 2;    // two threads per query row
  const int c0 = threadIdx.x % 2 * HD;     // ... each with half of D

  float qv[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qv[c] = row < a.sq ? num::to_f32(qh[(long long)row * D + c0 + c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int lo, n;
  key_blocks(q0, BK, a, lo, n);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring_buf = reinterpret_cast<T*>(smem);

  auto fetch = [&](int i, int slot) {
    fetch_kv<T, D>(ring_buf + (size_t)slot * 2 * BK * P, kh, vh,
                   (lo + i) * BK, BK, a.sk);
  };

  auto execute = [&](int i, int slot) {
    const T* ks = ring_buf + (size_t)slot * 2 * BK * P;
    const T* vs = ks + BK * P;
    const int k0 = (lo + i) * BK;
    float s[BK];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        dot = fmaf(qv[c], num::to_f32(ks[j * P + c0 + c]), dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      s[j] = visible(row, k0 + j, a) ? dot * a.scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - mn);
      sum += s[j];
    }
    const float alpha = expf(m - mn);
    l = l * alpha + sum;
    m = mn;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        acc[c] = fmaf(s[j], num::to_f32(vs[j * P + c0 + c]), acc[c]);
      }
    }
  };

  ring::access_execute(n, a.rif, fetch, execute);

  if (row < a.sq) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      oh[(long long)row * D + c0 + c] = num::from_f32<T>(acc[c] / den);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             const Args& a, void* stream) {
  const size_t smem =
      (size_t)a.rif * 2 * block_keys<T>() * pitch<T>(D) * sizeof(T);
  const dim3 grid((a.sq + BQ - 1) / BQ, a.h, b);
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_mma_kernel<D><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), a);
  } else {
    err = cudaFuncSetAttribute(flash_fma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fma_kernel<T, D><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int d, const Args& a, void* stream) {
  if (b < 1 || a.h < 1 || a.kvh < 1 || a.h % a.kvh != 0 || a.sq < 1 ||
      a.sk < 0 || a.rif < 1 || a.rif > ring::kMaxRif || a.h > 65535 ||
      b > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, out, b, a, stream);
    case 32: return launch_d<T, 32>(q, k, v, out, b, a, stream);
    case 64: return launch_d<T, 64>(q, k, v, out, b, a, stream);
    case 128: return launch_d<T, 128>(q, k, v, out, b, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Keys per ring stage, and the bytes of one stage (K and V blocks).
extern "C" int flash_prefill_block_keys(int bf16) {
  return bf16 ? BK_MMA : BK_FMA;
}
extern "C" int flash_prefill_stage_bytes(int d, int bf16) {
  return bf16 ? 2 * BK_MMA * pitch<__nv_bfloat16>(d) * 2
              : 2 * BK_FMA * pitch<float>(d) * 4;
}

// q (B, H, Sq, D); k, v (B, KVH, Sk, D); out (B, H, Sq, D); window 0 = none.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int b, int h, int kvh, int sq, int sk,
                             int d, int causal, int window, float scale,
                             int rif, int bf16, void* stream) {
  const Args a{h, kvh, sq, sk, causal, window, scale, rif};
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, b, d, a, stream)
              : launch<float>(q, k, v, out, b, d, a, stream);
}
