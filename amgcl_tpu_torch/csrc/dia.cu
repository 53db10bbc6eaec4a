// DIA sparse kernels for Hopper (sm_90a): SpMV, residual, SPAI-0/Jacobi
// correction, SpMV + dots, residual + norm — one template, five modes.
//
// Replaces the Pallas TPU kernels of amgcl_tpu/ops/pallas_spmv.py:
//   dia_spmv (SPMV), _dia_fused (RESIDUAL, CORRECTION), dia_spmv_dots
//   (SPMV_DOTS), dia_residual_dot (RESIDUAL_DOT).
//
// What bounds it on the H100: memory traffic. Per row the kernel does
// ndiag multiply-adds (2·ndiag operations) against ndiag·sizeof(T) bytes
// of diagonal data plus ~2-4 vectors — about 0.25 operations per byte at
// the 7-diagonal fine level, far below the card's ~20 (float32) balance
// point, so the least time is bytes / 3.35 TB/s.
//
// Design (simple and correct first): one thread per row. The offsets sit
// in shared memory (up to kMaxDiag); the loop over diagonals reads
// data[k, i] and x[i + off_k], both coalesced across a warp because
// consecutive threads take consecutive rows. The x index is guarded
// against [0, m) explicitly, which also covers rectangular operators.
// x is re-read once per diagonal from L2/L1 (the ±n² z-halo of the fine
// level is 64 KB per float32 plane, so neighbouring planes stay cached);
// staging the x window in shared memory with cp.async/TMA is later work.
// Dots use the deterministic two-stage reduction of reduce.cuh and
// accumulate in T: float32 for float32 data, float64 for float64 data,
// as the TPU kernels do (pallas_spmv.py:429-430).
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace amgcl_port {
namespace {

constexpr int kMaxDiag = 512;

enum Mode { SPMV = 0, RESIDUAL = 1, CORRECTION = 2, SPMV_DOTS = 3,
            RESIDUAL_DOT = 4 };

template <typename T, int MODE>
__global__ void __launch_bounds__(kBlock)
dia_kernel(long long n, long long m, int ndiag,
           const int* __restrict__ offsets, const T* __restrict__ data,
           const T* __restrict__ x, const T* __restrict__ f,
           const T* __restrict__ w, T* __restrict__ y,
           T* __restrict__ partials) {
  __shared__ int s_off[kMaxDiag];
  for (int k = threadIdx.x; k < ndiag; k += kBlock) s_off[k] = offsets[k];
  __syncthreads();

  constexpr bool from_f =
      MODE == RESIDUAL || MODE == CORRECTION || MODE == RESIDUAL_DOT;
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  T d0 = T(0), d1 = T(0), d2 = T(0);
  if (i < n) {
    T acc = from_f ? f[i] : T(0);
    for (int k = 0; k < ndiag; ++k) {
      const long long j = i + s_off[k];
      if (j >= 0 && j < m) {
        const T v = data[static_cast<size_t>(k) * n + i] * x[j];
        if (from_f) acc -= v; else acc += v;
      }
    }
    if constexpr (MODE == CORRECTION) {
      y[i] = x[i] + w[i] * acc;
    } else {
      y[i] = acc;
    }
    if constexpr (MODE == SPMV_DOTS) {
      d0 = acc * acc;
      d1 = acc * x[i];
      if (w != nullptr) d2 = acc * w[i];
    }
    if constexpr (MODE == RESIDUAL_DOT) d0 = acc * acc;
  }
  if constexpr (MODE == SPMV_DOTS) {
    const T v[3] = {d0, d1, d2};
    block_reduce_store<T, 3>(v, partials);
  } else if constexpr (MODE == RESIDUAL_DOT) {
    const T v[1] = {d0};
    block_reduce_store<T, 1>(v, partials);
  }
}

template <typename T>
cudaError_t run(int mode, long long n, long long m, int ndiag,
                const int* offsets, const T* data, const T* x, const T* f,
                const T* w, T* y, T* partials, T* dots, int nblocks,
                cudaStream_t s) {
  if (ndiag > kMaxDiag) return cudaErrorInvalidValue;
  switch (mode) {
    case SPMV:
      dia_kernel<T, SPMV><<<nblocks, kBlock, 0, s>>>(
          n, m, ndiag, offsets, data, x, f, w, y, partials);
      break;
    case RESIDUAL:
      dia_kernel<T, RESIDUAL><<<nblocks, kBlock, 0, s>>>(
          n, m, ndiag, offsets, data, x, f, w, y, partials);
      break;
    case CORRECTION:
      dia_kernel<T, CORRECTION><<<nblocks, kBlock, 0, s>>>(
          n, m, ndiag, offsets, data, x, f, w, y, partials);
      break;
    case SPMV_DOTS:
      dia_kernel<T, SPMV_DOTS><<<nblocks, kBlock, 0, s>>>(
          n, m, ndiag, offsets, data, x, f, w, y, partials);
      launch_reduce<T>(partials, nblocks, 3, dots, s);
      break;
    case RESIDUAL_DOT:
      dia_kernel<T, RESIDUAL_DOT><<<nblocks, kBlock, 0, s>>>(
          n, m, ndiag, offsets, data, x, f, w, y, partials);
      launch_reduce<T>(partials, nblocks, 1, dots, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 1 = float64. `f` is read by the residual-shaped
// modes, `w` by CORRECTION (scale) and optionally SPMV_DOTS (third dot).
// `partials` holds nblocks * ndots values and `dots` ndots values of the
// data type (ndots = 3 for SPMV_DOTS, 1 for RESIDUAL_DOT). Returns the
// cudaError_t of the launches.
extern "C" int amgcl_dia(int dtype, int mode, long long n, long long m,
                         int ndiag, const void* offsets, const void* data,
                         const void* x, const void* f, const void* w,
                         void* y, void* partials, void* dots, int nblocks,
                         void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (dtype == 0)
    return run<float>(mode, n, m, ndiag, off,
                      static_cast<const float*>(data),
                      static_cast<const float*>(x),
                      static_cast<const float*>(f),
                      static_cast<const float*>(w), static_cast<float*>(y),
                      static_cast<float*>(partials),
                      static_cast<float*>(dots), nblocks, s);
  if (dtype == 1)
    return run<double>(mode, n, m, ndiag, off,
                       static_cast<const double*>(data),
                       static_cast<const double*>(x),
                       static_cast<const double*>(f),
                       static_cast<const double*>(w),
                       static_cast<double*>(y),
                       static_cast<double*>(partials),
                       static_cast<double*>(dots), nblocks, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* amgcl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
