// Windowed-ELL sparse kernels for Hopper (sm_90a): SpMV, residual,
// SPAI-0/Jacobi correction and SpMV + dots over b×b block values, b = 1
// for scalar values — one gather loop, four epilogues.
//
// Replaces the Pallas TPU kernels of amgcl_tpu/ops/unstructured.py:
//   scalar (b = 1): windowed_ell_spmv (SPMV), windowed_ell_fused
//   (RESIDUAL, CORRECTION), windowed_ell_spmv_dots (SPMV_DOTS);
//   block: windowed_ell_block_spmv (SPMV), windowed_ell_block_fused
//   (RESIDUAL, CORRECTION), windowed_ell_block_spmv_dots (SPMV_DOTS).
//
// Storage: block row (node) i of tile t = i / tile holds the b×b block
// vals[((i*K + k)*b + r)*b + c] at block column starts[t] + cols[i*K + k];
// x and every vector hold b entries per node, so the block column j reads
// x[j*b .. j*b + b). Scalar values are the case b = 1: the reference's
// (n_tiles, tile, K) layout is its (n_tiles, tile, K, 1, 1) one. Padding
// slots hold local column 0 and a zero block.
//
// What bounds it on the H100: memory traffic. A slot does b² multiply-adds
// (2b² operations) against 4 + b²·sizeof(T) bytes of index and values
// (40 B for 3×3 float32, 8 B for a scalar): 0.25–0.45 operations per byte
// in float32, far below the card's balance point, so the least time is
// (format + vectors) bytes / 3.35 TB/s.
//
// Design (simple and correct first): one thread per node, holding its b
// row sums in registers, walks its K slots in order, as the reference's
// row sum does; each slot reads one int32 column, the slot's b² values and
// b contiguous x entries. The TPU DMAs each tile's x window (b entries per
// block column) into VMEM because it cannot gather from HBM; the H100
// gathers natively and x (1.3 MB in float32 at the 110,592-node 3×3
// level, 343 KB at the 85,623-row scalar one) stays in the 50 MB L2, so
// nothing is staged. The reference's layout is kept: a thread reads its
// K·b² values contiguously, neighbouring threads sit K·b²·sizeof(T) bytes
// apart, and a slot's b² values are not 16-byte aligned (36 B for 3×3
// float32), so the loads are scalar — correct, not coalesced; a
// slot-major layout or a warp per node is later work. An empty tile
// points at the block-column count, so its padding may address one past
// x: every absolute block column is checked against ncols and an
// out-of-range slot contributes nothing (the TPU pads x with zeros). The
// correction reads x both as the gather source and as x[i]; the output is
// a separate buffer, so no thread sees another's update. Offsets are
// 64-bit. The dots sum each node's b components in a fixed order, then go
// through the deterministic two-stage reduction of reduce.cuh, in T as the
// TPU kernel accumulates (float32 for float32, float64 for float64).
// Block sizes 1 (scalar) and 2, 3 and 4 (square) are instantiated; the
// wrapper refuses any other shape.
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace amgcl_port {
namespace {

enum Mode { SPMV = 0, RESIDUAL = 1, CORRECTION = 2, SPMV_DOTS = 3 };

template <typename T, int B, int MODE>
__global__ void __launch_bounds__(kBlock)
well_block_kernel(long long n_out, long long ncols, int tile, int K,
                  const int* __restrict__ starts,
                  const int* __restrict__ cols, const T* __restrict__ vals,
                  const T* __restrict__ x, const T* __restrict__ f,
                  const T* __restrict__ w, T* __restrict__ y,
                  T* __restrict__ partials) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  T d0 = T(0), d1 = T(0), d2 = T(0);
  if (i < n_out) {
    const long long s = starts[i / tile];
    const long long base = i * K;
    T acc[B];
#pragma unroll
    for (int r = 0; r < B; ++r) acc[r] = T(0);
    for (int k = 0; k < K; ++k) {
      const long long j = s + __ldg(cols + base + k);
      if (j >= ncols) continue;
      const T* v = vals + (base + k) * (B * B);
      const T* xj = x + j * B;
      T xv[B];
#pragma unroll
      for (int c = 0; c < B; ++c) xv[c] = __ldg(xj + c);
#pragma unroll
      for (int r = 0; r < B; ++r) {
#pragma unroll
        for (int c = 0; c < B; ++c) acc[r] += __ldg(v + r * B + c) * xv[c];
      }
    }
    const long long o = i * B;
    if constexpr (MODE == SPMV || MODE == SPMV_DOTS) {
#pragma unroll
      for (int r = 0; r < B; ++r) y[o + r] = acc[r];
    } else if constexpr (MODE == RESIDUAL) {
#pragma unroll
      for (int r = 0; r < B; ++r) y[o + r] = f[o + r] - acc[r];
    } else {
      // x + S_i (f − A x) with the node's b×b scale S_i = w[i]; for
      // b = 1 this is x + w·(f − A x), one fused multiply-add
      T res[B];
#pragma unroll
      for (int r = 0; r < B; ++r) res[r] = f[o + r] - acc[r];
      const T* S = w + i * (B * B);
#pragma unroll
      for (int r = 0; r < B; ++r) {
        T c_r = S[r * B] * res[0];
#pragma unroll
        for (int c = 1; c < B; ++c) c_r += S[r * B + c] * res[c];
        y[o + r] = x[o + r] + c_r;
      }
    }
    if constexpr (MODE == SPMV_DOTS) {
#pragma unroll
      for (int r = 0; r < B; ++r) {
        d0 += acc[r] * acc[r];
        d1 += acc[r] * x[o + r];
        if (w != nullptr) d2 += acc[r] * w[o + r];
      }
    }
  }
  if constexpr (MODE == SPMV_DOTS) {
    const T v[3] = {d0, d1, d2};
    block_reduce_store<T, 3>(v, partials);
  }
}

template <typename T, int B>
cudaError_t launch(int mode, long long n_out, long long ncols, int tile,
                   int K, const int* starts, const int* cols, const T* vals,
                   const T* x, const T* f, const T* w, T* y, T* partials,
                   T* dots, int nblocks, cudaStream_t s) {
  switch (mode) {
    case SPMV:
      well_block_kernel<T, B, SPMV><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y, partials);
      break;
    case RESIDUAL:
      well_block_kernel<T, B, RESIDUAL><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y, partials);
      break;
    case CORRECTION:
      well_block_kernel<T, B, CORRECTION><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y, partials);
      break;
    case SPMV_DOTS:
      well_block_kernel<T, B, SPMV_DOTS><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y, partials);
      launch_reduce<T>(partials, nblocks, 3, dots, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int mode, int b, long long n_out, long long ncols, int tile,
                int K, const int* starts, const int* cols, const T* vals,
                const T* x, const T* f, const T* w, T* y, T* partials,
                T* dots, int nblocks, cudaStream_t s) {
  if (tile <= 0 || K <= 0) return cudaErrorInvalidValue;
  switch (b) {
    case 1:
      return launch<T, 1>(mode, n_out, ncols, tile, K, starts, cols, vals,
                          x, f, w, y, partials, dots, nblocks, s);
    case 2:
      return launch<T, 2>(mode, n_out, ncols, tile, K, starts, cols, vals,
                          x, f, w, y, partials, dots, nblocks, s);
    case 3:
      return launch<T, 3>(mode, n_out, ncols, tile, K, starts, cols, vals,
                          x, f, w, y, partials, dots, nblocks, s);
    case 4:
      return launch<T, 4>(mode, n_out, ncols, tile, K, starts, cols, vals,
                          x, f, w, y, partials, dots, nblocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 1 = float64; b: the block size (1, 2, 3 or 4). n_out
// nodes are computed (one thread each, nblocks blocks of kBlock threads);
// x has ncols·b entries, f, y (and w for SPMV_DOTS) n_out·b. `f` is read
// by RESIDUAL and CORRECTION; `w` by CORRECTION as the (n_out, b, b) scale
// and optionally by SPMV_DOTS as the third dot's vector. `partials` holds
// nblocks * 3 values and `dots` 3 values of the data type (SPMV_DOTS
// only). Returns the cudaError_t of the launches.
extern "C" int amgcl_well_block(int dtype, int mode, int b, long long n_out,
                                long long ncols, int tile, int K,
                                const void* starts, const void* cols,
                                const void* vals, const void* x,
                                const void* f, const void* w, void* y,
                                void* partials, void* dots, int nblocks,
                                void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* cl = static_cast<const int*>(cols);
  if (dtype == 0)
    return run<float>(mode, b, n_out, ncols, tile, K, st, cl,
                      static_cast<const float*>(vals),
                      static_cast<const float*>(x),
                      static_cast<const float*>(f),
                      static_cast<const float*>(w), static_cast<float*>(y),
                      static_cast<float*>(partials),
                      static_cast<float*>(dots), nblocks, s);
  if (dtype == 1)
    return run<double>(mode, b, n_out, ncols, tile, K, st, cl,
                       static_cast<const double*>(vals),
                       static_cast<const double*>(x),
                       static_cast<const double*>(f),
                       static_cast<const double*>(w),
                       static_cast<double*>(y),
                       static_cast<double*>(partials),
                       static_cast<double*>(dots), nblocks, s);
  return cudaErrorInvalidValue;
}
