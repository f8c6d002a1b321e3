// Grouped (MoE expert) matmul for Hopper:
//   out[T, F] = x[T, D] @ w[block_expert[t / bt], D, F],
// f32 accumulation over D, the result in x's dtype.
//
// Replaces src/repro/kernels/grouped_matmul/kernel.py::gmm (_gmm_kernel):
// tokens sorted by expert in blocks of bt rows, one expert id per block,
// and the expert weight tiles streamed rif ahead through a RingChannel
// while the MXU multiplies the tile that has landed.
//
// Bound on this card: at decode, bytes.  8 slots x top-8 = 64 (token,
// expert) pairs touch about 32 of granite's 40 experts, each block holds
// a row or two, and every hit expert's D x F weights must be read once
// (about 50 MB per call) for 2 x 64 x D x F flops.  At a prefill of
// thousands of tokens each block is full and the work is operations:
// 2 x T x top_k x D x F flops on the tensor cores.
//
// Design:
//  * one CTA per (token block, 64-column tile of F), a block of more than
//    128 rows split into 128-row slices.  The CTA reads its block's expert
//    id from block_expert itself (the decoupled, data-dependent request)
//    and streams that expert's D x 64 slice in 32-deep stages through
//    the ring.cuh cp.async ring, rif stages in flight; the x rows of the
//    block ride the same stages, so a block's x and w are both read once
//    per column tile;
//  * block_rows (optional) gives the real rows of each block: the MoE
//    dispatch pads every expert group to whole blocks with zero rows and
//    ends with blocks that hold none.  The CTA copies and multiplies only
//    the real rows, writes exact zeros for the rest (what zero rows
//    multiply to), and streams no weight at all for a block without real
//    rows.  The TPU kernel multiplies every padded row and streams a
//    padding block's expert in full;
//  * ragged edges are masked (zero-filled stages past D, columns past F
//    never stored): nothing pads x or w to the tile sizes, where the TPU
//    wrapper pads both with copies;
//  * bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulators
//    in registers; each warp owns 32 rows x 64 columns and skips its
//    rows when none of them is real).  float32 runs as plain FMAs in
//    float32, so it matches the plain float32 product to rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "exports.cuh"
#include "numerics.cuh"
#include "ring.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BM = 128;   // token rows per CTA
constexpr int BN = 64;    // output columns per CTA
constexpr int BK = 32;    // depth of one ring stage

template <typename T>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16 bytes
  // row pitches one 16-byte chunk wider than the tile, so the rows a warp
  // reads at once fall in different banks
  static constexpr int XP = BK + kVec;
  static constexpr int WP = BN + kVec;
  static constexpr int X = BM * XP;             // x stage, elements
  static constexpr int STAGE = X + BK * WP;     // x and w stages
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const int32_t* __restrict__ block_expert,
           const int32_t* __restrict__ block_rows, T* __restrict__ out,
           int t_rows, int d, int f, int e, int bt, int slices, int rif) {
  using L = Layout<T>;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int blk = blockIdx.y / slices;
  const int r0 = blockIdx.y % slices * BM;          // first row in the block
  const long long row0 = (long long)blk * bt + r0;  // first token row
  // rows of this CTA inside its block and inside T, and the real ones
  const int rows = (int)max(0LL, min((long long)min(BM, bt - r0),
                                     (long long)t_rows - row0));
  int real = rows;
  if (block_rows != nullptr) real = max(0, min(rows, block_rows[blk] - r0));
  const int cols = min(BN, f - n0);

  for (int i = tid; i < (rows - real) * cols; i += kThreads) {
    out[(row0 + real + i / cols) * f + n0 + i % cols] = num::from_f32<T>(0.f);
  }
  if (real == 0) return;                   // nothing real: stream nothing

  const int ex = min(max(block_expert[blk], 0), e - 1);
  const T* wx = w + (long long)ex * d * f;
  const int n_stages = (d + BK - 1) / BK;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring_buf = reinterpret_cast<T*>(smem);

  // Access: stage k = x[real rows, k*BK : +BK] and w[ex, k*BK : +BK, tile]
  auto fetch = [&](int k, int slot) {
    T* xs = ring_buf + (size_t)slot * L::STAGE;
    T* ws = xs + L::X;
    const int k0 = k * BK;
    constexpr int xc = BK / L::kVec;       // chunks per x stage row
    for (int i = tid; i < real * xc; i += kThreads) {
      const int r = i / xc, c = i % xc * L::kVec;
      ring::copy16_or_zero(xs + r * L::XP + c, x + (row0 + r) * d + k0 + c,
                           k0 + c < d);
    }
    constexpr int wc = BN / L::kVec;       // chunks per w stage row
    for (int i = tid; i < BK * wc; i += kThreads) {
      const int r = i / wc, c = i % wc * L::kVec;
      ring::copy16_or_zero(ws + r * L::WP + c,
                           wx + (long long)(k0 + r) * f + n0 + c,
                           k0 + r < d && n0 + c < f);
    }
  };

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // warp `warp` owns rows 32 * warp + 16 * mi + {g, g + 8} and columns
    // 8 * nj + 2 * tq + {0, 1} of the 128 x 64 tile
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
    const int wr = 32 * warp;
    float acc[2][8][4] = {};
    auto execute = [&](int k, int slot) {
      if (wr >= real) return;   // this warp's rows are all padding
      const T* xs = ring_buf + (size_t)slot * L::STAGE;
      const T* ws = xs + L::X;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const T* xr = xs + (wr + 16 * mi + g) * L::XP + kk + 2 * tq;
          a[mi][0] = num::ld_pair(xr);
          a[mi][1] = num::ld_pair(xr + 8 * L::XP);
          a[mi][2] = num::ld_pair(xr + 8);
          a[mi][3] = num::ld_pair(xr + 8 * L::XP + 8);
        }
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const T* wcol = ws + (kk + 2 * tq) * L::WP + 8 * nj + g;
          const uint32_t b[2] = {num::pack(wcol[0], wcol[L::WP]),
                                 num::pack(wcol[8 * L::WP], wcol[9 * L::WP])};
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (wr + 16 * mi < real) num::mma_bf16(acc[mi][nj], a[mi], b);
          }
        }
      }
    };
    ring::access_execute(n_stages, rif, fetch, execute);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr + 16 * mi + g + 8 * half;
        if (r >= real) continue;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const int c = 8 * nj + 2 * tq;           // f is a multiple of 8
          if (c >= cols) continue;
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r) * f + n0 + c) =
              __floats2bfloat162_rn(acc[mi][nj][2 * half],
                                    acc[mi][nj][2 * half + 1]);
        }
      }
    }
  } else {
    // float32: thread (ty, tx) owns rows ty + 8 * i, columns 4 * tx + j
    const int tx = tid % 16, ty = tid / 16;
    const int n_i = min(16, max(0, (real - ty + 7) / 8));
    float acc[16][4] = {};
    auto execute = [&](int k, int slot) {
      const float* xs = ring_buf + (size_t)slot * L::STAGE;
      const float* ws = xs + L::X;
      for (int kk = 0; kk < BK; ++kk) {
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + kk * L::WP + 4 * tx);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (i < n_i) {
            const float xv = xs[(ty + 8 * i) * L::XP + kk];
            acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
            acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
            acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
            acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
          }
        }
      }
    };
    ring::access_execute(n_stages, rif, fetch, execute);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i >= n_i) continue;
      const long long r = row0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j;
        if (c < cols) out[r * f + n0 + c] = acc[i][j];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* block_expert,
           const void* block_rows, void* out, int t_rows, int d, int f,
           int e, int bt, int n_blocks, int rif, void* stream) {
  const int slices = (bt + BM - 1) / BM;
  const long long grid_y = (long long)n_blocks * slices;
  if (d < 1 || f < 1 || e < 1 || bt < 1 || n_blocks < 1 ||
      (d * (int)sizeof(T)) % 16 != 0 || (f * (int)sizeof(T)) % 16 != 0 ||
      rif < 1 || rif > ring::kMaxRif || grid_y > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)rif * Layout<T>::STAGE * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f + BN - 1) / BN, (unsigned)grid_y);
  gmm_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int32_t*>(block_expert),
      static_cast<const int32_t*>(block_rows), static_cast<T*>(out), t_rows,
      d, f, e, bt, slices, rif);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of one ring stage (the wrapper sizes the ring depth from it).
extern "C" int grouped_matmul_stage_bytes(int bf16) {
  return bf16 ? Layout<__nv_bfloat16>::STAGE * 2 : Layout<float>::STAGE * 4;
}

// x (T, D); w (E, D, F); block_expert (n_blocks,) int32; block_rows
// (n_blocks,) int32 or null (every row real); out (T, F).
extern "C" int grouped_matmul(const void* x, const void* w,
                              const void* block_expert, const void* block_rows,
                              void* out, int t_rows, int d, int f, int e,
                              int bt, int n_blocks, int rif, int bf16,
                              void* stream) {
  return bf16 ? launch<__nv_bfloat16>(x, w, block_expert, block_rows, out,
                                      t_rows, d, f, e, bt, n_blocks, rif,
                                      stream)
              : launch<float>(x, w, block_expert, block_rows, out, t_rows, d,
                              f, e, bt, n_blocks, rif, stream);
}
