// Windowed-ELL sparse kernels for Hopper (sm_90a): SpMV, residual,
// SPAI-0/Jacobi correction and SpMV + dots — one gather loop, four
// epilogues.
//
// Replaces the scalar Pallas TPU kernels of amgcl_tpu/ops/unstructured.py:
//   windowed_ell_spmv (SPMV), windowed_ell_fused (RESIDUAL, CORRECTION),
//   windowed_ell_spmv_dots (SPMV_DOTS).
//
// Storage: row i of tile t = i / tile holds vals[i*K + k] at column
// starts[t] + cols[i*K + k]; padding entries hold local column 0 and
// value 0.
//
// What bounds it on the H100: memory traffic. A row does K multiply-adds
// (2K operations) against K·(sizeof(T) + 4) bytes of values and indices
// plus its share of the vector streams: about 0.25 operations per byte in
// float32, far below the card's balance point, so the least time is
// (vals + cols + x + vectors) bytes / 3.35 TB/s.
//
// Design (simple and correct first): one thread per output row, which
// walks its K slots in order, as the reference's row sum does. The TPU
// DMAs each tile's x window into VMEM because it cannot gather from HBM;
// the H100 gathers natively and x (343 KB in float32 at the 85,623-row
// level) stays in the 50 MB L2, so nothing is staged. The reference's
// (n_tiles, tile, K) layout is kept, so a thread reads its K values and
// indices contiguously but neighbouring threads sit K elements apart:
// correct, not coalesced — a slot-major layout or a sub-warp per row is
// later work. A tile without entries points at the column count, so its
// padding may address one past x: every absolute column is checked
// against ncols and an out-of-range entry contributes nothing (the TPU
// pads x with zeros instead). Offsets are 64-bit. The dots go through
// the deterministic two-stage reduction of reduce.cuh and accumulate in T,
// as the TPU kernel does (float32 for float32, float64 for float64).
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace amgcl_port {
namespace {

enum Mode { SPMV = 0, RESIDUAL = 1, CORRECTION = 2, SPMV_DOTS = 3 };

template <typename T, int MODE>
__global__ void __launch_bounds__(kBlock)
well_kernel(long long n_out, long long ncols, int tile, int K,
            const int* __restrict__ starts, const int* __restrict__ cols,
            const T* __restrict__ vals, const T* __restrict__ x,
            const T* __restrict__ f, const T* __restrict__ w,
            T* __restrict__ y, T* __restrict__ partials) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  T d0 = T(0), d1 = T(0), d2 = T(0);
  if (i < n_out) {
    const long long s = starts[i / tile];
    const long long base = i * K;
    T acc = T(0);
    for (int k = 0; k < K; ++k) {
      const long long j = s + __ldg(cols + base + k);
      if (j < ncols) acc += __ldg(vals + base + k) * __ldg(x + j);
    }
    if constexpr (MODE == SPMV || MODE == SPMV_DOTS) {
      y[i] = acc;
    } else if constexpr (MODE == RESIDUAL) {
      y[i] = f[i] - acc;
    } else {
      y[i] = x[i] + w[i] * (f[i] - acc);
    }
    if constexpr (MODE == SPMV_DOTS) {
      d0 = acc * acc;
      d1 = acc * x[i];
      if (w != nullptr) d2 = acc * w[i];
    }
  }
  if constexpr (MODE == SPMV_DOTS) {
    const T v[3] = {d0, d1, d2};
    block_reduce_store<T, 3>(v, partials);
  }
}

template <typename T>
cudaError_t run(int mode, long long n_out, long long ncols, int tile, int K,
                const int* starts, const int* cols, const T* vals,
                const T* x, const T* f, const T* w, T* y, T* partials,
                T* dots, int nblocks, cudaStream_t s) {
  if (tile <= 0 || K <= 0) return cudaErrorInvalidValue;
  switch (mode) {
    case SPMV:
      well_kernel<T, SPMV><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y, partials);
      break;
    case RESIDUAL:
      well_kernel<T, RESIDUAL><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y, partials);
      break;
    case CORRECTION:
      well_kernel<T, CORRECTION><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y, partials);
      break;
    case SPMV_DOTS:
      well_kernel<T, SPMV_DOTS><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y, partials);
      launch_reduce<T>(partials, nblocks, 3, dots, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 1 = float64. n_out rows are computed (one thread
// each, nblocks blocks of kBlock threads); x has ncols entries. `f` is
// read by RESIDUAL and CORRECTION, `w` by CORRECTION (scale) and
// optionally SPMV_DOTS (third dot). `partials` holds nblocks * 3 values
// and `dots` 3 values of the data type (SPMV_DOTS only). Returns the
// cudaError_t of the launches.
extern "C" int amgcl_well(int dtype, int mode, long long n_out,
                          long long ncols, int tile, int K,
                          const void* starts, const void* cols,
                          const void* vals, const void* x, const void* f,
                          const void* w, void* y, void* partials, void* dots,
                          int nblocks, void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* cl = static_cast<const int*>(cols);
  if (dtype == 0)
    return run<float>(mode, n_out, ncols, tile, K, st, cl,
                      static_cast<const float*>(vals),
                      static_cast<const float*>(x),
                      static_cast<const float*>(f),
                      static_cast<const float*>(w), static_cast<float*>(y),
                      static_cast<float*>(partials),
                      static_cast<float*>(dots), nblocks, s);
  if (dtype == 1)
    return run<double>(mode, n_out, ncols, tile, K, st, cl,
                       static_cast<const double*>(vals),
                       static_cast<const double*>(x),
                       static_cast<const double*>(f),
                       static_cast<const double*>(w),
                       static_cast<double*>(y),
                       static_cast<double*>(partials),
                       static_cast<double*>(dots), nblocks, s);
  return cudaErrorInvalidValue;
}
