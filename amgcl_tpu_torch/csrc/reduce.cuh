// Deterministic reductions shared by the port's CUDA kernels.
//
// Two-stage, two launches (`block_reduce_store` + `reduce_partials`):
// every block reduces its per-thread values in shared memory in a fixed
// tree order and writes one partial per dot to `partials[block * ND + j]`;
// then one block per dot sums the partials at a fixed stride and runs the
// same fixed tree. No floating-point atomics anywhere, so the same inputs
// give bit-identical dots on every run — iteration counts of the Krylov
// loops that feed on these dots do not drift from run to run.
//
// The same order in one launch (`warp_tree256`, `tree256`, `lane_sums`
// or `lane_sums_once`, `last_block`; the DIA dot kernels and the Krylov
// tails): a block's 256 values go through that tree in one warp
// (one barrier, not eight), each partial is fenced, the grid's last block
// (an atomic ticket) sums the partials — lane t adds partials t, t+256, …
// to 0 in that order, then the 256-tree — and writes the dots. The
// operations are written out (`add_rn`, `fma_rn`, `mul_rn`), so no
// contraction changes a rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace amgcl_port {
// internal linkage: each source that includes it carries its own copy
namespace {

constexpr int kBlock = 256;          // threads per block of every kernel

constexpr int kGroup = 256;          // values of one partial (a block's)
constexpr int kUnroll = 8;           // partials a lane loads at once

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// The tree of block_reduce_store over 256 values (s[t] += s[t+stride] for
// stride = 128, 64, …, 1), lane l of a warp holding positions 4l+q in
// lo[q] and 128+4l+q in hi[q]: the first level inside the lane, the next
// five (64 … 4) as __shfl_down_sync by 16 … 1, the last two inside lane 0,
// which returns the sum.
template <typename T>
__device__ __forceinline__ T warp_tree256(const T (&lo)[4],
                                          const T (&hi)[4]) {
  T u[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) u[q] = add_rn(lo[q], hi[q]);    // stride 128
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {                           // 64 … 4
#pragma unroll
    for (int q = 0; q < 4; ++q)
      u[q] = add_rn(u[q], __shfl_down_sync(0xffffffffu, u[q], s));
  }
  return add_rn(add_rn(u[0], u[2]), add_rn(u[1], u[3]));       // 2, 1
}

// the same tree over s[0 … 255], by one warp
template <typename T>
__device__ __forceinline__ T tree256(const T* s, int lane) {
  T lo[4], hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lo[q] = s[4 * lane + q];
    hi[q] = s[kGroup / 2 + 4 * lane + q];
  }
  return warp_tree256(lo, hi);
}

// Lane t's sums of reduce_partials for dots j0 … j0+NJ−1 (those below
// ndots), the partials laid out dot by dot (`partials[j * ngroups + g]`):
// partials t, t+256, … added to 0 in order, kUnroll of each dot in
// flight; into s[j][t].
template <typename T, int NJ>
__device__ __forceinline__ void lane_sums(const T* partials, int ngroups,
                                          int ndots, int j0, int t,
                                          T (*s)[kGroup]) {
  T c[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) c[j] = T(0);
  int idx = t;
  for (; idx + (kUnroll - 1) * kGroup < ngroups; idx += kUnroll * kGroup) {
    T v[NJ][kUnroll];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[j][u] = j0 + j < ndots
                      ? __ldcg(partials + static_cast<size_t>(j0 + j) *
                               ngroups + idx + u * kGroup)
                      : T(0);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) c[j] = add_rn(c[j], v[j][u]);
    }
  }
  for (; idx < ngroups; idx += kGroup) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j0 + j < ndots)
        c[j] = add_rn(c[j], __ldcg(partials + static_cast<size_t>(j0 + j) *
                                   ngroups + idx));
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j0 + j < ndots) s[j0 + j][t] = c[j];
}

// lane_sums of NJ dots for at most P partials a lane (ngroups ≤ P · 256),
// in the same order, in one round: the lane's partials of every dot
// loaded at once, then added. lane_sums loads whole rounds of kUnroll and
// the rest one at a time, an L2 round trip each, which at a few partials
// a lane is most of the last block's time; the DIA dot kernels keep it,
// since this form there changed the stencil body's registers and cost it
// 2.5 µs (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W).
template <typename T, int NJ, int P>
__device__ __forceinline__ void lane_sums_once(const T* partials,
                                               int ngroups, int t,
                                               T (*s)[kGroup]) {
  T v[NJ][P];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      v[j][p] = t + p * kGroup < ngroups
                    ? __ldcg(partials + static_cast<size_t>(j) * ngroups +
                             t + p * kGroup)
                    : T(0);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    T c = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (t + p * kGroup < ngroups) c = add_rn(c, v[j][p]);
    s[j][t] = c;
  }
}

// Whether this block is the grid's last to finish. Call it from every
// thread of the block once its partials are written, each by a thread
// that fenced it (__threadfence) after the write. The ticket is
// atomicInc'd modulo the grid, so the last block leaves it at 0 and no
// host reset is needed; the last block fences before it reads the
// partials. Ends with a barrier, so the block's shared memory is free.
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __shared__ bool s_last;
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  const bool last = s_last;
  if (last) __threadfence();
  return last;
}

template <typename A, int ND>
__device__ __forceinline__ void block_reduce_store(const A (&v)[ND],
                                                   A* __restrict__ partials) {
  __shared__ A s[ND][kBlock];
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < ND; ++j) s[j][t] = v[j];
  __syncthreads();
#pragma unroll
  for (int stride = kBlock / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
#pragma unroll
      for (int j = 0; j < ND; ++j) s[j][t] += s[j][t + stride];
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
      partials[static_cast<size_t>(blockIdx.x) * ND + j] = s[j][0];
  }
}

// Sum of one value per lane over a full warp by a fixed xor-shuffle tree:
// every lane ends with the same bit pattern on every run.
template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// a sum of type A as an output of type O: bfloat16 rounded once to the
// nearest, any other type as it is
template <typename O, typename A>
__device__ __forceinline__ O narrow(A v) {
  if constexpr (std::is_same<O, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else
    return v;
}

template <typename A, typename O = A>
__global__ void __launch_bounds__(kBlock)
reduce_partials(const A* __restrict__ partials, int nblocks, int ndots,
                O* __restrict__ out) {
  __shared__ A s[kBlock];
  const int t = threadIdx.x;
  const int j = blockIdx.x;
  A acc = A(0);
  for (int b = t; b < nblocks; b += kBlock)
    acc += partials[static_cast<size_t>(b) * ndots + j];
  s[t] = acc;
  __syncthreads();
  for (int stride = kBlock / 2; stride > 0; stride >>= 1) {
    if (t < stride) s[t] += s[t + stride];
    __syncthreads();
  }
  if (t == 0) out[j] = narrow<O>(s[0]);
}

template <typename A, typename O = A>
inline void launch_reduce(const A* partials, int nblocks, int ndots, O* out,
                          cudaStream_t stream) {
  reduce_partials<A, O><<<ndots, kBlock, 0, stream>>>(partials, nblocks,
                                                      ndots, out);
}

}  // namespace
}  // namespace amgcl_port
