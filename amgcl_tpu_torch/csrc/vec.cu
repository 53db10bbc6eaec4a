// The CG iteration tail for Hopper (sm_90a): x' = x + αp, r' = r − αq and
// ⟨r', r'⟩ in one pass.
//
// Replaces amgcl_tpu/ops/fused_vec.py:_fused_pass in mode "xr".
//
// What bounds it on the H100: memory traffic — four vectors read and two
// written per element against 5 operations, so the least time is
// 6·n·sizeof(T) bytes / 3.35 TB/s.
//
// Design: one grid-stride elementwise pass with a fixed block count, so
// the per-thread sums and the per-block partials fall in the same order
// on every run; the ⟨r', r'⟩ partials go through the deterministic
// two-stage reduction of reduce.cuh (no float atomics), accumulated in T.
// α arrives as a pointer to a 0-d device tensor, so the host never waits
// for the device to learn it.
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace amgcl_port {
namespace {

template <typename T>
__global__ void __launch_bounds__(kBlock)
xr_kernel(long long n, const T* __restrict__ alpha, const T* __restrict__ p,
          const T* __restrict__ q, const T* __restrict__ x,
          const T* __restrict__ r, T* __restrict__ x_out,
          T* __restrict__ r_out, T* __restrict__ partials) {
  const T a = *alpha;
  T acc = T(0);
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock +
                     threadIdx.x;
       i < n; i += stride) {
    const T rn = r[i] - a * q[i];
    x_out[i] = x[i] + a * p[i];
    r_out[i] = rn;
    acc += rn * rn;
  }
  const T v[1] = {acc};
  block_reduce_store<T, 1>(v, partials);
}

template <typename T>
cudaError_t run(long long n, const T* alpha, const T* p, const T* q,
                const T* x, const T* r, T* x_out, T* r_out, T* partials,
                T* dot, int nblocks, cudaStream_t s) {
  xr_kernel<T><<<nblocks, kBlock, 0, s>>>(n, alpha, p, q, x, r, x_out,
                                          r_out, partials);
  launch_reduce<T>(partials, nblocks, 1, dot, s);
  return cudaGetLastError();
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 1 = float64; `alpha` points to one device value of
// the data type; `partials` holds nblocks values, `dot` one.
extern "C" int amgcl_xr(int dtype, long long n, const void* alpha,
                        const void* p, const void* q, const void* x,
                        const void* r, void* x_out, void* r_out,
                        void* partials, void* dot, int nblocks,
                        void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(n, static_cast<const float*>(alpha),
                      static_cast<const float*>(p),
                      static_cast<const float*>(q),
                      static_cast<const float*>(x),
                      static_cast<const float*>(r),
                      static_cast<float*>(x_out), static_cast<float*>(r_out),
                      static_cast<float*>(partials),
                      static_cast<float*>(dot), nblocks, s);
  if (dtype == 1)
    return run<double>(n, static_cast<const double*>(alpha),
                       static_cast<const double*>(p),
                       static_cast<const double*>(q),
                       static_cast<const double*>(x),
                       static_cast<const double*>(r),
                       static_cast<double*>(x_out),
                       static_cast<double*>(r_out),
                       static_cast<double*>(partials),
                       static_cast<double*>(dot), nblocks, s);
  return cudaErrorInvalidValue;
}
