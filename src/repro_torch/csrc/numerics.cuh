// Number formats and the bf16 tensor-core product the kernels share.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace num {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);     // round to nearest even, as astype does
}

// Two bf16 in one 32-bit register, the lower k index in the low half.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16(lo), __float2bfloat16(hi));
}

// Two floats as one register of two bf16, a in the low half (round to
// nearest even).
__device__ __forceinline__ uint32_t pack_rn(float a, float b) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(b), "f"(a));
  return r;
}

// Two floats as bf16 pairs hi + lo: hi their bf16 rounding, lo the
// rounding of what is left, together 16 bits of mantissa (a in the low
// halves).
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack_rn(a, b);
  lo = pack_rn(a - __uint_as_float(hi << 16),
               b - __uint_as_float(hi & 0xffff0000u));
}

// c += a @ b on the tensor cores: PTX mma.m16n8k16, A 16x16 and B 16x8 in
// bf16, C 16x8 in f32 (bf16 products are exact in f32).  With
// g = lane / 4 and t = lane % 4, thread `lane` holds
//   a[0] = A[g][2t..2t+1]    a[1] = A[g+8][2t..2t+1]
//   a[2] = A[g][2t+8..2t+9]  a[3] = A[g+8][2t+8..2t+9]
//   b[0] = B[2t..2t+1][g]    b[1] = B[2t+8..2t+9][g]
//   c[0..1] = C[g][2t..2t+1] c[2..3] = C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace num
