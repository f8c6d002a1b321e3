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
// Bound on this card: operations at a prefill's lengths.  A q block of
// 128 rows against S keys does 4 x 128 x S x D flops for 2 x S x D x 2
// bytes of K/V, about 128 flops per byte, and K/V blocks are shared by
// the q blocks and heads of one KV head through the L2, so the floor is
// the visible (row, col) pairs x 4 x D flops over 989 TFLOP/s.  Only
// wgmma reaches that rate; mma.sync, scalar shared loads of its operands
// and copies issued by the threads that also do the math do not.
//
// Design (bf16):
//  * warp specialisation: a CTA of three warpgroups works on a tile of
//    128 query rows of one (b, h).  Warpgroup 0 is the producer: it gives
//    its registers up (setmaxnreg) and one thread keeps TMA loads in
//    flight; warpgroups 1 and 2 are consumers, each owning 64 query rows,
//    with the registers;
//  * persistent: one CTA per SM walks the tiles in rounds of gridDim.x,
//    forwards and backwards in turn (tiles numbered with the q-block index
//    slowest and, when causal, reversed, so a CTA that drew a heavy tile
//    draws a light one next and the SMs finish together).  Q has two
//    buffers and the K/V ring runs on across tiles, so
//    the producer loads the next tile while the consumers finish this
//    one and store its output, and no CTA start or end sits between
//    tiles;
//  * TMA: q, k and v are 3-D tensor maps (D, S, B x heads) passed as
//    __grid_constant__ parameters, so a box never crosses into the next
//    head, and rows past Sq or Sk arrive as zeros (the TPU wrapper pads S
//    to a multiple of the block with a copy of q, k and v).  Boxes are one
//    swizzle atom wide: 64 columns with 128-byte swizzle where D is a
//    multiple of 64 (64, 128, 192: one, two, three boxes), 32 with 64-byte
//    swizzle for D 32 and 96, 16 with 32-byte swizzle for D 16.  Q comes
//    once a tile; K and V blocks of BK keys fill a ring of `rif` stages,
//    with a full and an empty mbarrier for each K and each V block: the
//    product with K starts before V lands, K is released once its scores
//    are in and V once its product is, and the producer refills either as
//    soon as both consumers released it (one arrival per warp);
//  * S = Q K^T is wgmma.m64nBKk16 with both operands in shared memory; O
//    += P V is wgmma.m64nDk16 with P from registers (the S accumulator's
//    layout is the A operand's) and V as the MN-major B operand.  P enters
//    as two bf16 operands, its head and its remainder, so it keeps 16
//    mantissa bits (one bf16 P would move an output by up to 2^-9 of the
//    largest term, more than the one-ulp tolerance allows where terms
//    cancel); O and the softmax state stay in registers;
//  * each warpgroup overlaps its own work: it issues the scores of block
//    i + 1 before it rescales O and issues block i's P V, and runs the
//    softmax of block i + 1 while that product is on the tensor cores, so
//    its exponentials and conversions hide behind wgmma (the next block's
//    scores and this block's P are live at once).  The two warpgroups
//    take turns to issue (two named barriers), so one's products run
//    while the other's softmax does;
//  * the softmax runs in base 2, scale x log2(e) folded into the FMA that
//    subtracts the running max before ex2, and the masks are evaluated
//    only on blocks that cross the diagonal, the window's edge or Sk for
//    the warpgroup's rows: interior blocks skip them;
//  * only k blocks holding a visible column for some row of the q block
//    are visited: up to the diagonal when causal, from the window's start
//    when windowed.  This is exact: a masked score is -inf and gives
//    p = 0 whatever the running max (which starts at -1e30, so alpha
//    stays finite).  The TPU kernel walks all blocks.
// A row without any visible column (only with Sk = 0) comes out 0.
//
// float32 is not on a full-width path and runs as plain FMAs on the CUDA
// cores, K/V blocks through the ring.cuh cp.async ring: TPR threads per
// query row (2, or 4 above D 128 so the registers do not spill), each
// with D / TPR of the columns.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "exports.cuh"
#include "numerics.cuh"
#include "ring.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;           // query rows per CTA, tensor-core path
constexpr int kConsumers = 2;     // warpgroups of 64 query rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int BQ_FMA = 64;        // query rows per CTA, float32 path
constexpr int BK_FMA = 32;        // keys per stage, float32 path
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  int h, kvh, sq, sk, causal, window;
  float scale;
  int rif, bh, nqb;
};

__device__ __forceinline__ bool visible(int row, int col, const Args& a) {
  return col < a.sk && (!a.causal || col <= row) &&
         (a.window <= 0 || col >= row - a.window + 1);
}

// The k blocks [lo, lo + n) holding a visible column for some row of the
// q block of `bq` rows starting at q0.
__device__ __forceinline__ void key_blocks(int q0, int bq, int bk,
                                           const Args& a, int& lo, int& n) {
  const int q_last = min(q0 + bq, a.sq) - 1;
  const int hi = a.causal ? min(a.sk, q_last + 1) : a.sk;   // exclusive
  const int first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  lo = first / bk;
  n = hi > first ? (hi + bk - 1) / bk - lo : 0;
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma over a TMA ring
// ---------------------------------------------------------------------------

// Columns of one swizzle atom (one TMA box): the widest of 64, 32, 16
// that divides D.
__host__ __device__ constexpr int atom_cols(int d) {
  return d % 64 == 0 ? 64 : d % 32 == 0 ? 32 : 16;
}

// Shared memory: 1024 bytes of slack to align the base for the swizzle,
// two Q buffers (BQ x D), rif stages of K and V (BK x D each), then the
// mbarriers (Q-full and Q-empty per buffer, and K-full, V-full, K-empty,
// V-empty per stage).
__host__ __device__ constexpr size_t q_bytes(int d) {
  return (size_t)BQ * d * 2;
}
__host__ __device__ constexpr size_t stage_bytes(int d, int bk) {
  return (size_t)2 * bk * d * 2;
}
__host__ __device__ constexpr size_t extra_bytes(int d, int rif) {
  return 1024 + 2 * q_bytes(d) + (size_t)(4 + 4 * rif) * 8;
}

// Fast 2^x (MUFU.EX2; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2 pass the turn between the two consumer
// warpgroups: a warpgroup waits on its own until the other arrived.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(128 * kConsumers)
               : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(128 * kConsumers)
               : "memory");
}

// Issue S = Q K^T for one warpgroup (64 rows at q_w) against the K block
// at ks: D / 16 products into sc, committed as one group.
template <int D, int BK>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2],
                                             uint32_t q_w, uint32_t ks) {
  constexpr int A = atom_cols(D);
  constexpr uint32_t ROWB = A * 2, SBO = 8 * ROWB;
  constexpr int LAYOUT = wg::layout_type(ROWB);
  wg::fence();
#pragma unroll
  for (int c = 0; c < D / A; ++c) {
#pragma unroll
    for (int kk = 0; kk < A / 16; ++kk) {
      const uint64_t da =
          wg::desc(q_w + c * BQ * ROWB + kk * 32, 16, SBO, LAYOUT);
      const uint64_t db =
          wg::desc(ks + c * BK * ROWB + kk * 32, 16, SBO, LAYOUT);
      wg::MmaSS<BK>::run(sc, da, db, (c | kk) != 0);
    }
  }
  wg::commit();
}

// Issue O += P V for one warpgroup against the V block at vs: per 16
// keys, the head and the remainder of P, committed as one group.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&ph)[BK / 16][4],
                                         uint32_t (&pl)[BK / 16][4],
                                         uint32_t vs) {
  constexpr uint32_t ROWB = atom_cols(D) * 2, SBO = 8 * ROWB;
  constexpr int LAYOUT = wg::layout_type(ROWB);
  wg::pin(o);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = wg::desc(vs + kk * 16 * ROWB, BK * ROWB, SBO, LAYOUT);
    wg::MmaRS<D>::run(o, ph[kk], dv, 1);
    wg::MmaRS<D>::run(o, pl[kk], dv, 1);
  }
  wg::commit();
}

// The online softmax of one block's scores for this thread's two rows,
// in log2 units: masked scores (only tested where the block crosses Sk,
// the diagonal or the window's edge) become -inf and p = 0; sc becomes
// p; m and l move on, and alpha is the factor O must take before this
// block's p @ v.  l holds this thread's columns only.
template <int BK>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], bool edge,
                                        int k0, int r_lo, int r_hi, int tq4,
                                        const Args& a, float scale2,
                                        float (&m)[2], float (&l)[2],
                                        float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge && !visible(e < 2 ? r_lo : r_hi,
                           k0 + 8 * j + 2 * tq4 + (e & 1), a)) {
        sc[4 * j + e] = -INFINITY;
      }
      mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {      // the four lanes of a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], x));
    }
    const float mn = fmaxf(m[r], mx[r] * scale2);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale2, -m[e / 2]));
      sum[e / 2] += sc[4 * j + e];
    }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// P's A fragments for keys 16 kk .. 16 kk + 15: chunks 2 kk and 2 kk + 1
// of the accumulator, as a bf16 head and remainder.
template <int BK>
__device__ __forceinline__ void to_fragments(const float (&sc)[BK / 2],
                                             uint32_t (&ph)[BK / 16][4],
                                             uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 2 * kk + r / 2, e = 2 * (r % 2);
      num::split(sc[4 * j + e], sc[4 * j + e + 1], ph[kk][r], pl[kk][r]);
    }
  }
}

// One work tile: the q block of 128 rows starting at q0 of head `head`
// of batch row b (plane bh of q), its KV plane, and its key blocks
// [lo, lo + n).  Tiles are numbered with the q-block index slowest and,
// when causal, reversed: the heaviest first.
struct Tile {
  int bh, head, b, q0, kvrow, lo, n;
};

template <int BK>
__device__ __forceinline__ Tile tile_of(int t, const Args& a) {
  Tile x;
  x.bh = t % a.bh;
  const int qi = t / a.bh;
  x.q0 = (a.causal ? a.nqb - 1 - qi : qi) * BQ;
  x.head = x.bh % a.h;
  x.b = x.bh / a.h;
  x.kvrow = x.b * a.kvh + x.head / (a.h / a.kvh);
  key_blocks(x.q0, BQ, BK, a, x.lo, x.n);
  return x;
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ out, Args a) {
  constexpr int A = atom_cols(D);            // columns of a swizzle atom
  constexpr int NA = D / A;                  // atom columns of a row
  constexpr uint32_t ROWB = A * 2;           // bytes of an atom row
  constexpr uint32_t kQ = BQ * D * 2, kK = BK * D * 2;
  const int tiles = a.bh * a.nqb;
  // this CTA's u-th tile: round u of gridDim.x tiles, walked forwards in
  // even rounds and backwards in odd ones, so the CTA that took one of the
  // heaviest tiles takes one of the lightest of the next round
  auto tile_at = [&](int u) {
    return u * (int)gridDim.x +
           ((u & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = ring::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;                 // shared addresses: Q x 2
  const uint32_t kv_s = base + 2 * kQ;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + 2 * kQ + (size_t)a.rif * 2 * kK);
  uint64_t* q_full = bars;                   // per Q buffer
  uint64_t* q_empty = bars + 2;
  uint64_t* k_full = bars + 4;
  uint64_t* v_full = k_full + a.rif;
  uint64_t* k_empty = v_full + a.rif;
  uint64_t* v_empty = k_empty + a.rif;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      ring::mbar_init(&q_full[i], 1);
      ring::mbar_init(&q_empty[i], 4 * kConsumers);  // one per warp
    }
    for (int s = 0; s < a.rif; ++s) {
      ring::mbar_init(&k_full[s], 1);
      ring::mbar_init(&v_full[s], 1);
      ring::mbar_init(&k_empty[s], 4 * kConsumers);
      ring::mbar_init(&v_empty[s], 4 * kConsumers);
    }
    ring::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every copy ----
    wg::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;                            // blocks issued so far
      for (int u = 0, t = blockIdx.x; t < tiles; t = tile_at(++u)) {
        const Tile x = tile_of<BK>(t, a);
        // Q of tile u goes to buffer u % 2 once tile u - 2 is done with it
        const int qb = u & 1;
        if (u >= 2) ring::mbar_wait(&q_empty[qb], ((u >> 1) - 1) & 1);
        ring::mbar_expect(&q_full[qb], kQ);
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          wg::tma_load_3d(q_s + qb * kQ + c * BQ * ROWB, &tq, c * A, x.q0,
                          x.bh, ring::smem_u32(&q_full[qb]));
        }
        for (int i = 0; i < x.n; ++i, ++it) {
          const int s = it % a.rif;
          const uint32_t ks = kv_s + s * 2 * kK, vs = ks + kK;
          const int k0 = (x.lo + i) * BK;
          // K and V of a stage are released apart: K once its scores are
          // in, V once its product is
          if (it >= a.rif) {
            ring::mbar_wait(&k_empty[s], (it / a.rif - 1) & 1);
          }
          ring::mbar_expect(&k_full[s], kK);
#pragma unroll
          for (int c = 0; c < NA; ++c) {
            wg::tma_load_3d(ks + c * BK * ROWB, &tk, c * A, k0, x.kvrow,
                            ring::smem_u32(&k_full[s]));
          }
          if (it >= a.rif) {
            ring::mbar_wait(&v_empty[s], (it / a.rif - 1) & 1);
          }
          ring::mbar_expect(&v_full[s], kK);
#pragma unroll
          for (int c = 0; c < NA; ++c) {
            wg::tma_load_3d(vs + c * BK * ROWB, &tv, c * A, k0, x.kvrow,
                            ring::smem_u32(&v_full[s]));
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    wg::reg_alloc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, g = lane / 4, tq4 = lane % 4;
    const float scale2 = a.scale * kLog2e;   // scores in log2 units
    auto stage = [&](int it) { return kv_s + (it % a.rif) * 2 * kK; };
    auto phase = [&](int it) { return (uint32_t)(it / a.rif) & 1; };
    auto release = [&](uint64_t* bar) {      // one arrival a warp
      if (lane == 0) ring::mbar_arrive(bar);
    };
    // the two warpgroups take turns to issue their products (named
    // barriers 1 and 2), so one's wgmmas run while the other's softmax
    // does; warpgroup 0 goes first
    const int mine = 1 + w, theirs = 2 - w;
    if (w == 1) named_arrive(1);

    int it0 = 0;                             // blocks of earlier tiles
    for (int u = 0, tile = blockIdx.x; tile < tiles; tile = tile_at(++u)) {
      const Tile x = tile_of<BK>(tile, a);
      const int n = x.n, lo = x.lo;
      const int r0 = x.q0 + 64 * w;          // first row of the warpgroup
      const int r_lo = r0 + 16 * warp + g;   // this thread's two rows
      const int r_hi = r_lo + 8;
      const int qb = u & 1;
      const uint32_t q_w = q_s + qb * kQ + 64 * w * ROWB;
      auto edge = [&](int i) {
        const int k0 = (lo + i) * BK;
        return k0 + BK > a.sk || (a.causal && k0 + BK - 1 > r0) ||
               (a.window > 0 && k0 < r0 + 63 - a.window + 1);
      };

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
      auto rescale = [&]() {                 // O into the next block's scale
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
      };
      ring::mbar_wait(&q_full[qb], (u >> 1) & 1);
      if (n > 0) {
        // the scores of block i + 1 run on the tensor cores while this
        // warpgroup rescales O, and the product of block i while it runs
        // the softmax of block i + 1
        float sc[BK / 2];
        uint32_t ph[BK / 16][4], pl[BK / 16][4];
        ring::mbar_wait(&k_full[it0 % a.rif], phase(it0));
        issue_scores<D, BK>(sc, q_w, stage(it0));
        wg::wait<0>();
        wg::pin(sc);
        release(&k_empty[it0 % a.rif]);
        softmax<BK>(sc, edge(0), lo * BK, r_lo, r_hi, tq4, a, scale2, m, l,
                    alpha);
        to_fragments<BK>(sc, ph, pl);
        // every wgmma of the loop body is unconditional, so the compiler
        // sees where each group ends and keeps them asynchronous
        for (int i = 0; i + 1 < n; ++i) {
          const int it = it0 + i;
          named_sync(mine);
          ring::mbar_wait(&k_full[(it + 1) % a.rif], phase(it + 1));
          issue_scores<D, BK>(sc, q_w, stage(it + 1));
          rescale();
          ring::mbar_wait(&v_full[it % a.rif], phase(it));
          issue_pv<D, BK>(o, ph, pl, stage(it) + kK);
          named_arrive(theirs);
          wg::wait<1>();                     // the scores of i + 1
          wg::pin(sc);
          release(&k_empty[(it + 1) % a.rif]);
          softmax<BK>(sc, edge(i + 1), (lo + i + 1) * BK, r_lo, r_hi, tq4,
                      a, scale2, m, l, alpha);
          wg::wait<0>();                     // the product of i
          wg::pin(o);
          wg::pin(ph);
          wg::pin(pl);
          release(&v_empty[it % a.rif]);
          to_fragments<BK>(sc, ph, pl);
        }
        const int last = it0 + n - 1;        // the last block's product
        named_sync(mine);
        rescale();
        ring::mbar_wait(&v_full[last % a.rif], phase(last));
        issue_pv<D, BK>(o, ph, pl, stage(last) + kK);
        named_arrive(theirs);
        wg::wait<0>();
        wg::pin(o);
        release(&v_empty[last % a.rif]);
      }
      release(&q_empty[qb]);                 // every product read Q
      it0 += n;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int x2 = 1; x2 < 4; x2 <<= 1) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], x2);
        }
      }
      const float inv_lo = 1.f / fmaxf(l[0], 1e-30f);
      const float inv_hi = 1.f / fmaxf(l[1], 1e-30f);
      bf16* oh = out + ((long long)x.b * a.h + x.head) * a.sq * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * tq4;
        if (r_lo < a.sq) {
          *reinterpret_cast<__nv_bfloat162*>(oh + (long long)r_lo * D + c) =
              __floats2bfloat162_rn(o[4 * j] * inv_lo,
                                    o[4 * j + 1] * inv_lo);
        }
        if (r_hi < a.sq) {
          *reinterpret_cast<__nv_bfloat162*>(oh + (long long)r_hi * D + c) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv_hi,
                                    o[4 * j + 3] * inv_hi);
        }
      }
    }
    if (w == 0) named_sync(1);               // warpgroup 1's last turn
  }
}

// A (planes, s, d) bf16 tensor as a 3-D map with boxes of `cols` x `rows`
// x 1, swizzled by the box's row bytes.
bool encode(CUtensorMap* map, wg::EncodeTiled fn, const void* base, int d,
            int s, int planes, int cols, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int b, const Args& a0, void* stream) {
  wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  constexpr int A = atom_cols(D);
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, fn, q, D, a0.sq, b * a0.h, A, BQ) ||
      !encode(&tk, fn, k, D, a0.sk, b * a0.kvh, A, BK) ||
      !encode(&tv, fn, v, D, a0.sk, b * a0.kvh, A, BK)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = a0;
  a.bh = b * a.h;
  a.nqb = (a.sq + BQ - 1) / BQ;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const int tiles = a.bh * a.nqb;
  const size_t smem = extra_bytes(D, a.rif) + a.rif * stage_bytes(D, BK);
  auto kernel = flash_wgmma_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one CTA per SM walks tiles blockIdx.x, + gridDim.x, ...
  kernel<<<tiles < sms ? tiles : sms, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(tq, tk, tv,
                                                static_cast<bf16*>(out), a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores over the cp.async ring
// ---------------------------------------------------------------------------

// rows one 16-byte chunk apart; threads per query row
__host__ __device__ constexpr int fma_pitch(int d) { return d + 4; }
__host__ __device__ constexpr int fma_tpr(int d) { return d > 128 ? 4 : 2; }

template <int D>
__global__ void __launch_bounds__(BQ_FMA * fma_tpr(D))
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 Args a) {
  constexpr int P = fma_pitch(D);
  constexpr int BK = BK_FMA;
  constexpr int TPR = fma_tpr(D);            // threads per query row
  constexpr int HD = D / TPR;                // columns per thread
  constexpr int kChunks = D / 4;
  const int q0 = blockIdx.x * BQ_FMA;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv = head / (a.h / a.kvh);
  const float* qh = q + ((long long)b * a.h + head) * a.sq * D;
  const float* kh = k + ((long long)b * a.kvh + kv) * a.sk * D;
  const float* vh = v + ((long long)b * a.kvh + kv) * a.sk * D;
  float* oh = out + ((long long)b * a.h + head) * a.sq * D;
  const int row = q0 + threadIdx.x / TPR;
  const int c0 = threadIdx.x % TPR * HD;

  float qv[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qv[c] = row < a.sq ? qh[(long long)row * D + c0 + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int lo, n;
  key_blocks(q0, BQ_FMA, BK, a, lo, n);
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring_buf = reinterpret_cast<float*>(smem);   // rif x [K | V]

  // Access: request keys [k0, k0 + BK) of K and V into one ring slot.
  auto fetch = [&](int i, int slot) {
    float* ks = ring_buf + (size_t)slot * 2 * BK * P;
    float* vs = ks + BK * P;
    const int k0 = (lo + i) * BK;
    const int rows = min(BK, a.sk - k0);
    for (int c = threadIdx.x; c < BK * kChunks; c += blockDim.x) {
      const int r = c / kChunks, col = c % kChunks * 4;
      const long long src = (long long)(k0 + r) * D + col;
      ring::copy16_or_zero(ks + r * P + col, kh + src, r < rows);
      ring::copy16_or_zero(vs + r * P + col, vh + src, r < rows);
    }
  };

  auto execute = [&](int i, int slot) {
    const float* ks = ring_buf + (size_t)slot * 2 * BK * P;
    const float* vs = ks + BK * P;
    const int k0 = (lo + i) * BK;
    float s[BK];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) dot = fmaf(qv[c], ks[j * P + c0 + c], dot);
#pragma unroll
      for (int x = 1; x < TPR; x <<= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, x);
      }
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
        acc[c] = fmaf(s[j], vs[j * P + c0 + c], acc[c]);
      }
    }
  };

  ring::access_execute(n, a.rif, fetch, execute);

  if (row < a.sq) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      oh[(long long)row * D + c0 + c] = acc[c] / den;
    }
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* out, int b,
               const Args& a, void* stream) {
  const size_t smem = (size_t)a.rif * 2 * BK_FMA * fma_pitch(D) * 4;
  const dim3 grid((a.sq + BQ_FMA - 1) / BQ_FMA, a.h, b);
  if (a.h > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fma_kernel<D><<<grid, BQ_FMA * fma_tpr(D), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), a);
  return (int)cudaGetLastError();
}

// Keys per stage each (D, dtype) takes: bf16 instantiates two, the
// default (the faster in tools/ring_sweep.py on an H100) first; float32
// one.
int block_keys(int d, int bf16, int which) {
  if (!bf16) return which == 0 ? BK_FMA : 0;
  switch (d) {
    case 16: case 32: return which == 0 ? 128 : 0;
    case 64: case 96: case 128: return which == 0 ? 128 : which == 1 ? 64 : 0;
    case 192: return which == 0 ? 64 : which == 1 ? 96 : 0;
    default: return 0;
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int b,
           int d, int bk, const Args& a, int bf16, void* stream) {
  if (b < 1 || a.h < 1 || a.kvh < 1 || a.h % a.kvh != 0 || a.sq < 1 ||
      a.sk < 0 || a.rif < 1 || a.rif > ring::kMaxRif ||
      (bk != block_keys(d, bf16, 0) && bk != block_keys(d, bf16, 1)) ||
      bk == 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.sk == 0) {          // no visible column anywhere: the output is 0
    const size_t bytes = (size_t)b * a.h * a.sq * d * (bf16 ? 2 : 4);
    cudaMemsetAsync(out, 0, bytes, static_cast<cudaStream_t>(stream));
    return (int)cudaGetLastError();
  }
  if (!bf16) {
    switch (d) {
      case 16: return launch_fma<16>(q, k, v, out, b, a, stream);
      case 32: return launch_fma<32>(q, k, v, out, b, a, stream);
      case 64: return launch_fma<64>(q, k, v, out, b, a, stream);
      case 96: return launch_fma<96>(q, k, v, out, b, a, stream);
      case 128: return launch_fma<128>(q, k, v, out, b, a, stream);
      case 192: return launch_fma<192>(q, k, v, out, b, a, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#define REPRO_FLASH(D, BK)                                                 \
  if (d == D && bk == BK) return launch_wgmma<D, BK>(q, k, v, out, b, a,   \
                                                     stream);
  REPRO_FLASH(16, 128)
  REPRO_FLASH(32, 128)
  REPRO_FLASH(64, 128) REPRO_FLASH(64, 64)
  REPRO_FLASH(96, 128) REPRO_FLASH(96, 64)
  REPRO_FLASH(128, 128) REPRO_FLASH(128, 64)
  REPRO_FLASH(192, 64) REPRO_FLASH(192, 96)
#undef REPRO_FLASH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The keys per stage flash_prefill takes at head dim d: `which` 0 is the
// default, 1 the other instantiated size; 0 where there is none.
extern "C" int flash_prefill_block_keys(int d, int bf16, int which) {
  return block_keys(d, bf16, which);
}

// Bytes of one ring stage (a K and a V block of bk keys).
extern "C" long long flash_prefill_stage_bytes(int d, int bk, int bf16) {
  return bf16 ? (long long)stage_bytes(d, bk)
              : (long long)2 * bk * fma_pitch(d) * 4;
}

// Shared memory beside the ring: alignment slack, Q and the mbarriers of
// up to ring::kMaxRif stages (bf16); nothing for float32.
extern "C" long long flash_prefill_extra_bytes(int d, int bf16) {
  return bf16 ? (long long)extra_bytes(d, ring::kMaxRif) : 0;
}

// q (B, H, Sq, D); k, v (B, KVH, Sk, D); out (B, H, Sq, D); window 0 =
// none; bk keys per ring stage (flash_prefill_block_keys), rif stages.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int b, int h, int kvh, int sq, int sk,
                             int d, int causal, int window, float scale,
                             int bk, int rif, int bf16, void* stream) {
  const Args a{h, kvh, sq, sk, causal, window, scale, rif, 0, 0};
  return launch(q, k, v, out, b, d, bk, a, bf16, stream);
}
