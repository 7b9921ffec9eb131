// Shared helpers of the port's CUDA kernels: io-type conversion, rounding
// to the io type at the points where the JAX reference rounds, exact gelu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sf {

// dtype codes passed by the Python wrappers
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// value as the io type would hold it, back in f32
template <typename T>
__device__ __forceinline__ float round_io(float x) {
  return to_f(from_f<T>(x));
}

// exact (erf) gelu, torch F.gelu / jax.nn.gelu(approximate=False)
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ldmatrix: four 8x8 b16 matrices from shared memory, rows addressed per
// lane (lanes 8i..8i+7 give the rows of matrix i); .trans transposes each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D += A (16x16, row) . B (16x8, col), bf16 in, f32 accumulate. Fragment
// layouts (g = lane/4, t = lane%4): A regs {a0a1, a2a3, a4a5, a6a7} hold
// rows {g, g+8, g, g+8} x cols {2t, 2t, 2t+8, 2t+8}(+1); B regs hold
// k = 2t(+1) and 2t+8(+1) of column g; D holds rows g, g+8 x cols 2t(+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + rows) of a row-major (n, D) bf16 matrix into shared memory
// (row stride LD elements) by the block's NTH threads, zeros past row n
template <int D, int LD, int NTH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int n) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CPR; e += NTH) {
    int r = e / CPR, ch = e % CPR;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D +
                                            ch * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + ch * 8) = val;
  }
}

}  // namespace sf
