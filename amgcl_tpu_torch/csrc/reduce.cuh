// Deterministic two-stage reduction shared by the port's CUDA kernels.
//
// Stage 1 (inside each kernel): every block reduces its per-thread values
// in shared memory in a fixed tree order and writes one partial per dot
// to `partials[block * ND + j]`. Stage 2 (`reduce_partials`, one block
// per dot): a fixed-stride serial sum over the partials followed by the
// same fixed tree. No floating-point atomics anywhere, so the same inputs
// give bit-identical dots on every run — iteration counts of the Krylov
// loops that feed on these dots do not drift from run to run.
#pragma once

#include <cuda_runtime.h>

namespace amgcl_port {
// internal linkage: dia.cu and vec.cu each carry their own copy
namespace {

constexpr int kBlock = 256;          // threads per block of every kernel

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

template <typename A>
__global__ void __launch_bounds__(kBlock)
reduce_partials(const A* __restrict__ partials, int nblocks, int ndots,
                A* __restrict__ out) {
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
  if (t == 0) out[j] = s[0];
}

template <typename A>
inline void launch_reduce(const A* partials, int nblocks, int ndots, A* out,
                          cudaStream_t stream) {
  reduce_partials<A><<<ndots, kBlock, 0, stream>>>(partials, nblocks, ndots,
                                                   out);
}

}  // namespace
}  // namespace amgcl_port
