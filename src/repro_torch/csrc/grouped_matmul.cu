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
// expert) pairs touch about 33 of granite's 40 experts, each block holds
// 1 to 8 real rows, and every hit expert's D x F weights must be read
// once (about 52 MB per call) for 2 x 64 x D x F flops.  At a forward of
// thousands of tokens each block is full and bytes and operations are
// about even: 2 x T x top_k x D x F flops on the tensor cores against
// the weights read once and x read once.
//
// Design (bf16): one persistent launch whose work list runs over items
// (token block, 128-row slice of it, BN-column tile of F).
// A CTA is three warpgroups: warpgroup 0 is the producer (it gives its
// registers up and one thread keeps TMA loads in flight), warpgroups 1
// and 2 are consumers of 64 rows each.
//  * the producer is the decoupled Access: for each item it reads the
//    block's expert and real rows (block_expert, block_rows: the
//    data-dependent request of the TPU kernel's RingChannel) and fills a
//    rif-stage ring with full and empty mbarriers.  A stage is 64 deep
//    in D: the block's x rows (maps over x (D, T), 128-byte swizzle: a
//    wide block's 128 rows in two 64-row boxes, a narrow one's
//    round_up(real, 16) rows in 16-row boxes) and the weight tile as
//    BN / 64 boxes of 64 x 64 (a 3-D map over w (F, D, E) at (n0, k0,
//    expert)).  The ring runs on across items, so
//    the next item's loads overlap this item's products and epilogue;
//  * each consumer warpgroup issues wgmma m64nBNk16 with A (x, K-major)
//    and B (w, MN-major) in shared memory, f32 accumulators in
//    registers;
//  * the path is chosen per block on the device from block_rows.  Wide
//    (more than 64 real rows): both warpgroups multiply, each keeping
//    one group in flight while it issues the next stage's (with a ring
//    of one stage, each group is waited for and its stage freed).  Narrow (1 to
//    64 real rows, all of decode's blocks): only the first multiplies
//    and frees each stage as soon as its group is done, the second only
//    passes the stages on, and the producer fetches just the real rows,
//    so the bytes in flight are the weights.  A block without a real
//    row fetches nothing and is written as exact zeros, as are the rows
//    past a block's real ones.  One launch per call, no host sync;
//  * ragged edges: TMA zero-fills x and w past D, T and F; columns past
//    F and rows past a block's end are never stored, so bt need not be a
//    multiple of anything.
//
// float32 runs as plain FMAs in float32 on the CUDA cores over the
// ring.cuh cp.async ring (one CTA per (block, 128-row slice, 64 columns)),
// so it matches the plain float32 product to rounding.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exports.cuh"
#include "ring.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma over a TMA ring
// ---------------------------------------------------------------------------

constexpr int kRows = 128;        // rows of a slice: two warpgroups of 64
constexpr int kDepth = 64;        // D of one stage: one 128-byte swizzle row
constexpr int kBoxRows = 16;      // x rows per TMA box of a narrow block
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr uint32_t kXBytes = kRows * kDepth * 2;      // x part of a stage
constexpr uint32_t kBox = kDepth * 64 * 2;             // one 64 x 64 box

__host__ __device__ constexpr uint32_t w_bytes(int bn) {
  return (uint32_t)kDepth * bn * 2;
}
__host__ __device__ constexpr uint32_t stage_bytes(int bn) {
  return kXBytes + w_bytes(bn);
}
// alignment slack and the full and empty mbarriers of up to kMaxRif
// stages
__host__ __device__ constexpr uint32_t extra_bytes() {
  return 1024 + 2 * ring::kMaxRif * 8;
}

struct Geo {
  int t_rows, d, f, e, bt, slices, n_tiles, n_k, rif, n_items;
};

// Item i of the work list: the column tile fastest, then the slice and
// the block, so the tiles of one block (one x) run on neighbouring CTAs.
struct Item {
  long long row0;   // first token row of the slice
  int blk;
  int n0;           // first column of the tile
  int rows;         // rows of the slice inside its block and inside T
  int real;         // the real ones among them
  int nk;           // stages of D to fetch (0: nothing)
};

template <int BN>
__device__ __forceinline__ Item item_of(int i, const Geo& g,
                                        const int32_t* block_rows) {
  Item x;
  x.n0 = i % g.n_tiles * BN;
  const int r = i / g.n_tiles;
  const int slice = r % g.slices;
  x.blk = r / g.slices;
  const int r0 = slice * kRows;
  x.row0 = (long long)x.blk * g.bt + r0;
  x.rows = (int)max(0LL, min((long long)min(kRows, g.bt - r0),
                             (long long)g.t_rows - x.row0));
  x.real = x.rows;
  if (block_rows != nullptr) {
    x.real = max(0, min(x.rows, __ldg(block_rows + x.blk) - r0));
  }
  x.nk = x.real > 0 ? g.n_k : 0;
  return x;
}

// One warpgroup's products over stages it .. it + nk - 1 of the ring at
// `base` into acc: A the 64 x rows `a_off` bytes into each stage, B its
// weight tile.  HOLD 1 keeps one group in flight while the next stage's
// is issued and frees a stage one group late (wide items: the tensor
// cores stay fed); HOLD 0 waits for each group and frees its stage at
// once (narrow items, whose time is the weights': one more stage in
// flight).
template <int BN, int HOLD>
__device__ __forceinline__ void products(float (&acc)[BN / 2], uint32_t base,
                                         uint32_t a_off, int it, int nk,
                                         const Geo& g, uint64_t* full,
                                         uint64_t* empty, int lane) {
  constexpr uint32_t kStage = stage_bytes(BN);
  auto release = [&](int i) {                  // one arrival a warp
    if (lane == 0) ring::mbar_arrive(&empty[i % g.rif]);
  };
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int s = (it + k) % g.rif;
    ring::mbar_wait(&full[s], ((it + k) / g.rif) & 1);
    const uint32_t xs = base + s * kStage + a_off;
    const uint32_t ws = base + s * kStage + kXBytes;
    wg::pin(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      const uint64_t da = wg::desc(xs + kk * 32, 16, 1024, 1);
      const uint64_t db = wg::desc(ws + kk * 16 * 128, kDepth * 128, 1024, 1);
      wg::MmaSST<BN>::run(acc, da, db, 1);
    }
    wg::commit();
    wg::wait<HOLD>();
    wg::pin(acc);
    if (HOLD == 0) {
      release(it + k);
    } else if (k > 0) {
      release(it + k - 1);
    }
  }
  if (HOLD) {
    wg::wait<0>();
    wg::pin(acc);
    release(it + nk - 1);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx16,
                 const __grid_constant__ CUtensorMap tx64,
                 const __grid_constant__ CUtensorMap tw,
                 const int32_t* __restrict__ block_expert,
                 const int32_t* __restrict__ block_rows,
                 bf16* __restrict__ out, Geo g) {
  constexpr uint32_t kStage = stage_bytes(BN);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = ring::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + (size_t)g.rif * kStage);
  uint64_t* empty = full + g.rif;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.rif; ++s) {
      ring::mbar_init(&full[s], 1);
      ring::mbar_init(&empty[s], 4 * kConsumers);   // one per warp
    }
    ring::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every copy ----
    wg::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;                              // stages issued so far
      for (int i = blockIdx.x; i < g.n_items; i += gridDim.x) {
        const Item x = item_of<BN>(i, g, block_rows);
        if (x.nk == 0) continue;
        const int ex = min(max(__ldg(block_expert + x.blk), 0), g.e - 1);
        // x: a wide block's 128 rows in two 64-row boxes, a narrow one's
        // real rows in 16-row boxes; w: the tile's 64-column boxes
        const bool wide = x.real > 64;
        const int xbox = wide ? 2 : (x.real + kBoxRows - 1) / kBoxRows;
        const int xrows = wide ? 64 : kBoxRows;
        const CUtensorMap* xmap = wide ? &tx64 : &tx16;
        const int wbox = min(BN / 64, (g.f - x.n0 + 63) / 64);
        const uint32_t bytes = xbox * xrows * kDepth * 2 + wbox * kBox;
        for (int k = 0; k < x.nk; ++k, ++it) {
          const int s = it % g.rif;
          if (it >= g.rif) ring::mbar_wait(&empty[s], (it / g.rif - 1) & 1);
          const uint32_t xs = base + s * kStage, ws = xs + kXBytes;
          const uint32_t bar = ring::smem_u32(&full[s]);
          const int k0 = k * kDepth;
          ring::mbar_expect(&full[s], bytes);
          for (int b = 0; b < xbox; ++b) {
            wg::tma_load_3d(xs + b * xrows * 128, xmap, k0,
                            (int)x.row0 + b * xrows, 0, bar);
          }
          for (int j = 0; j < wbox; ++j) {
            wg::tma_load_3d(ws + j * kBox, &tw, x.n0 + 64 * j, k0, ex, bar);
          }
        }
      }
    }
  } else {
    // ---- consumers: two warpgroups ----
    wg::reg_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x - 128;          // 0 .. 255
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, g8 = lane / 4, q = lane % 4;
    // the accumulator's rows 16 warp + g8 (+ 8) of the 64 at row `r0`
    // of the slice and its columns 8j + 2q (+ 1) of the tile, for the
    // rows below `real`
    auto store = [&](const float (&acc)[BN / 2], const Item& x, int r0) {
      const int r_lo = r0 + 16 * warp + g8, r_hi = r_lo + 8;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cc = x.n0 + 8 * j + 2 * q;
        if (cc >= g.f) continue;               // f is a multiple of 8
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = hi ? r_hi : r_lo;
          if (r >= x.real) continue;
          const long long off = (x.row0 + r) * g.f + cc;
          *reinterpret_cast<__nv_bfloat162*>(out + off) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hi],
                                    acc[4 * j + 2 * hi + 1]);
        }
      }
    };
    int it = 0;                                // stages consumed so far
    for (int i = blockIdx.x; i < g.n_items; i += gridDim.x) {
      const Item x = item_of<BN>(i, g, block_rows);
      // rows past the real ones: exact zeros, 16 bytes a store
      const int chunks = min(BN, g.f - x.n0) / 8;   // F: a multiple of 8
      const int n = (x.rows - x.real) * chunks;
      for (int v = ct; v < n; v += 128 * kConsumers) {
        const long long r = x.row0 + x.real + v / chunks;
        *reinterpret_cast<uint4*>(out + r * g.f + x.n0 + v % chunks * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      if (x.nk == 0) continue;

      float acc[BN / 2];
      if (x.real > 64) {
        // wide: both warpgroups, 64 rows each; a one-stage ring frees
        // each stage at once (holding its group would wait on itself)
        if (g.rif > 1) {
          products<BN, 1>(acc, base, 64 * c * 128, it, x.nk, g, full,
                          empty, lane);
        } else {
          products<BN, 0>(acc, base, 64 * c * 128, it, x.nk, g, full,
                          empty, lane);
        }
        store(acc, x, 64 * c);
      } else if (c == 0) {
        // narrow: the first warpgroup multiplies ...
        products<BN, 0>(acc, base, 0, it, x.nk, g, full, empty, lane);
        store(acc, x, 0);
      } else {
        // ... and the second passes the stages on
        for (int k = 0; k < x.nk; ++k) {
          const int s = (it + k) % g.rif;
          ring::mbar_wait(&full[s], ((it + k) / g.rif) & 1);
          if (lane == 0) ring::mbar_arrive(&empty[s]);
        }
      }
      it += x.nk;
    }
  }
}

// x (T, D) as a 3-D map (D, T, 1) with 64 x box_rows boxes; w (E, D, F)
// as (F, D, E) with 64 x 64 boxes; both 128-byte swizzled.
bool encode(CUtensorMap* map, wg::EncodeTiled fn, const void* ptr,
            long long inner, long long rows, long long planes, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)(inner * rows * 2)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_wgmma(const void* x, const void* w, const void* block_expert,
                 const void* block_rows, void* out, Geo g, void* stream) {
  wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tx16, tx64, tw;
  if (!encode(&tx16, fn, x, g.d, g.t_rows, 1, kBoxRows) ||
      !encode(&tx64, fn, x, g.d, g.t_rows, 1, 64) ||
      !encode(&tw, fn, w, g.f, g.d, g.e, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const size_t smem = extra_bytes() + (size_t)g.rif * stage_bytes(BN);
  auto kernel = gmm_wgmma_kernel<BN>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one CTA per SM walks items blockIdx.x, + gridDim.x, ...
  kernel<<<g.n_items < sms ? g.n_items : sms, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      tx16, tx64, tw, static_cast<const int32_t*>(block_expert),
      static_cast<const int32_t*>(block_rows), static_cast<bf16*>(out), g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores over the cp.async ring
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 128;
constexpr int BM = 128;       // token rows per CTA
constexpr int BN_FMA = 64;    // output columns per CTA
constexpr int BK = 32;        // depth of one ring stage

// row pitches one 16-byte chunk wider than the tile, so the rows a warp
// reads at once fall in different banks
constexpr int XP = BK + 4;
constexpr int WP = BN_FMA + 4;
constexpr int X_ELEMS = BM * XP;              // x stage, elements
constexpr int STAGE_FMA = X_ELEMS + BK * WP;  // x and w stages

__global__ void __launch_bounds__(kFmaThreads)
gmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int32_t* __restrict__ block_expert,
               const int32_t* __restrict__ block_rows, float* __restrict__ out,
               int t_rows, int d, int f, int e, int bt, int slices, int rif) {
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN_FMA;
  const int blk = blockIdx.y / slices;
  const int r0 = blockIdx.y % slices * BM;          // first row in the block
  const long long row0 = (long long)blk * bt + r0;  // first token row
  // rows of this CTA inside its block and inside T, and the real ones
  const int rows = (int)max(0LL, min((long long)min(BM, bt - r0),
                                     (long long)t_rows - row0));
  int real = rows;
  if (block_rows != nullptr) real = max(0, min(rows, block_rows[blk] - r0));
  const int cols = min(BN_FMA, f - n0);

  for (int i = tid; i < (rows - real) * cols; i += kFmaThreads) {
    out[(row0 + real + i / cols) * f + n0 + i % cols] = 0.f;
  }
  if (real == 0) return;                   // nothing real: stream nothing

  const int ex = min(max(block_expert[blk], 0), e - 1);
  const float* wx = w + (long long)ex * d * f;
  const int n_stages = (d + BK - 1) / BK;

  extern __shared__ __align__(16) unsigned char smem[];
  float* ring_buf = reinterpret_cast<float*>(smem);

  // Access: stage k = x[real rows, k*BK : +BK] and w[ex, k*BK : +BK, tile]
  auto fetch = [&](int k, int slot) {
    float* xs = ring_buf + (size_t)slot * STAGE_FMA;
    float* ws = xs + X_ELEMS;
    const int k0 = k * BK;
    constexpr int xc = BK / 4;             // chunks per x stage row
    for (int i = tid; i < real * xc; i += kFmaThreads) {
      const int r = i / xc, c = i % xc * 4;
      ring::copy16_or_zero(xs + r * XP + c, x + (row0 + r) * d + k0 + c,
                           k0 + c < d);
    }
    constexpr int wc = BN_FMA / 4;         // chunks per w stage row
    for (int i = tid; i < BK * wc; i += kFmaThreads) {
      const int r = i / wc, c = i % wc * 4;
      ring::copy16_or_zero(ws + r * WP + c,
                           wx + (long long)(k0 + r) * f + n0 + c,
                           k0 + r < d && n0 + c < f);
    }
  };

  // thread (ty, tx) owns rows ty + 8 * i, columns 4 * tx + j
  const int tx = tid % 16, ty = tid / 16;
  const int n_i = min(16, max(0, (real - ty + 7) / 8));
  float acc[16][4] = {};
  auto execute = [&](int k, int slot) {
    const float* xs = ring_buf + (size_t)slot * STAGE_FMA;
    const float* ws = xs + X_ELEMS;
    for (int kk = 0; kk < BK; ++kk) {
      const float4 wv =
          *reinterpret_cast<const float4*>(ws + kk * WP + 4 * tx);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i < n_i) {
          const float xv = xs[(ty + 8 * i) * XP + kk];
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

int launch_fma(const void* x, const void* w, const void* block_expert,
               const void* block_rows, void* out, int t_rows, int d, int f,
               int e, int bt, int n_blocks, int rif, void* stream) {
  const int slices = (bt + BM - 1) / BM;
  const long long grid_y = (long long)n_blocks * slices;
  if (grid_y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rif * STAGE_FMA * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f + BN_FMA - 1) / BN_FMA, (unsigned)grid_y);
  gmm_fma_kernel<<<grid, kFmaThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(block_expert),
      static_cast<const int32_t*>(block_rows), static_cast<float*>(out),
      t_rows, d, f, e, bt, slices, rif);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of one ring stage: bf16 at a column tile of `bn` (128 or 256),
// float32 (bn ignored).
extern "C" int grouped_matmul_stage_bytes(int bf16, int bn) {
  return bf16 ? (int)stage_bytes(bn) : STAGE_FMA * 4;
}
// Bytes of the weight tile in a bf16 stage: the wrapper plans the ring
// depth over it, as the TPU wrapper plans it over one (bd, bf) tile, and
// clamps it to the stages that fit.
extern "C" int grouped_matmul_weight_bytes(int bn) { return (int)w_bytes(bn); }
// Shared memory beside the ring (bf16; nothing for float32).
extern "C" int grouped_matmul_extra_bytes(int bf16) {
  return bf16 ? (int)extra_bytes() : 0;
}

// x (T, D); w (E, D, F); block_expert (n_blocks,) int32; block_rows
// (n_blocks,) int32 or null (every row real); out (T, F).  `bn`, bf16
// only: columns per tile (128 or 256).
extern "C" int grouped_matmul(const void* x, const void* w,
                              const void* block_expert, const void* block_rows,
                              void* out, int t_rows, int d, int f, int e,
                              int bt, int n_blocks, int bn, int rif, int bf16,
                              void* stream) {
  if (t_rows < 1 || d < 1 || f < 1 || e < 1 || bt < 1 || n_blocks < 1 ||
      (d * (bf16 ? 2 : 4)) % 16 != 0 || (f * (bf16 ? 2 : 4)) % 16 != 0 ||
      rif < 1 || rif > ring::kMaxRif) {
    return (int)cudaErrorInvalidValue;
  }
  if (!bf16) {
    return launch_fma(x, w, block_expert, block_rows, out, t_rows, d, f, e,
                      bt, n_blocks, rif, stream);
  }
  Geo g;
  g.t_rows = t_rows;
  g.d = d;
  g.f = f;
  g.e = e;
  g.bt = bt;
  g.slices = (bt + kRows - 1) / kRows;
  g.n_tiles = (f + bn - 1) / bn;
  g.n_k = (d + kDepth - 1) / kDepth;
  g.rif = rif;
  const long long items = (long long)n_blocks * g.slices * g.n_tiles;
  if (items > (1LL << 30)) return (int)cudaErrorInvalidValue;
  g.n_items = (int)items;
  if (bn == 128) {
    return launch_wgmma<128>(x, w, block_expert, block_rows, out, g, stream);
  }
  if (bn == 256) {
    return launch_wgmma<256>(x, w, block_expert, block_rows, out, g, stream);
  }
  return (int)cudaErrorInvalidValue;
}
