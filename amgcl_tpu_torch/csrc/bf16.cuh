// bfloat16 arithmetic of the port's kernels: bfloat16 in memory, float
// in registers, one rounding to bfloat16 where the TPU kernel's bfloat16
// dtype rounds.
//
// A value in a float register here always holds a bfloat16 value. The
// product of two bfloat16 values is exact in float (8 + 8 significant
// bits), so __fmul_rn and then one rounding to bfloat16 is bfloat16's own
// product; a sum is formed in float and then rounded, as torch and XLA
// form a bfloat16 sum. The operations are written out (__fmul_rn,
// __fadd_rn, __fsub_rn), so nvcc contracts nothing into an fma.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace amgcl_port {
namespace {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

// the type a kernel sums in: float32 for bfloat16 data, else the data's
template <typename T>
using Acc = std::conditional_t<kIsBf16<T>, float, T>;

__device__ __forceinline__ float bf_load(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ bf16 bf_store(float v) {
  return __float2bfloat16_rn(v);
}
// float to the nearest bfloat16, kept in float
__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf_mul(float a, float b) {
  return bf_round(__fmul_rn(a, b));
}
__device__ __forceinline__ float bf_add(float a, float b) {
  return bf_round(__fadd_rn(a, b));
}
__device__ __forceinline__ float bf_sub(float a, float b) {
  return bf_round(__fsub_rn(a, b));
}

// Four consecutive bfloat16 values from an 8-byte boundary (a row of the
// windowed-ELL and gather kernels, K a multiple of 4), as one 8-byte
// load through the read-only path, widened to float
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&a.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

}  // namespace
}  // namespace amgcl_port
