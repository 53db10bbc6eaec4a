// The Krylov iteration tails for Hopper (sm_90a), one kernel, three modes:
//   XR (CG):          x' = x + αp, r' = r − αq, and ⟨r', r'⟩;
//   BICG_TAIL:        x' = x + α·p̂ + ω·ŝ, r' = s − ω·t, and ⟨r', r'⟩,
//                     ⟨r̂, r'⟩ (the next iteration's ρ);
//   AXPBY_DOT:        z = a·x + b·y and ⟨z, z⟩ (BiCGStab(L)'s residual
//                     update with its norm).
//
// Replaces amgcl_tpu/ops/fused_vec.py:_fused_pass in modes "xr",
// "bicg_tail" and "axpby_dot".
//
// What bounds it on the H100: memory traffic — XR reads four vectors and
// writes two per element against 5 operations (least time
// 6·n·sizeof(T) / 3.35 TB/s); BICG_TAIL reads six and writes two against
// 10 operations (8·n·sizeof(T) / 3.35 TB/s); AXPBY_DOT reads two and
// writes one against 5 operations (3·n·sizeof(T) / 3.35 TB/s: 0.0003 ms
// at n = 85,623 in float32, so a launch, not the bytes, is its cost).
//
// Design: one grid-stride elementwise pass with a fixed block count, so
// the per-thread sums and the per-block partials fall in the same order
// on every run; the partials go through the deterministic two-stage
// reduction of reduce.cuh (no float atomics), accumulated in T. α and ω
// (a and b) arrive as pointers to 0-d device tensors, so the host never
// waits for the device to learn them.
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace amgcl_port {
namespace {

enum TailMode { XR = 0, BICG_TAIL = 1, AXPBY_DOT = 2 };

// XR:        v0..v3 = p, q, x, r
// BICG_TAIL: v0..v5 = p̂, ŝ, s, t, x, r̂
// AXPBY_DOT: v0, v1 = x, y; alpha, omega = a, b; x_out = z
template <typename T, int MODE>
__global__ void __launch_bounds__(kBlock)
tail_kernel(long long n, const T* __restrict__ alpha,
            const T* __restrict__ omega, const T* __restrict__ v0,
            const T* __restrict__ v1, const T* __restrict__ v2,
            const T* __restrict__ v3, const T* __restrict__ v4,
            const T* __restrict__ v5, T* __restrict__ x_out,
            T* __restrict__ r_out, T* __restrict__ partials) {
  const T a = *alpha;
  const T w = MODE == XR ? T(0) : *omega;
  T acc0 = T(0), acc1 = T(0);
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock +
                     threadIdx.x;
       i < n; i += stride) {
    if constexpr (MODE == XR) {
      const T rn = v3[i] - a * v1[i];
      x_out[i] = v2[i] + a * v0[i];
      r_out[i] = rn;
      acc0 += rn * rn;
    } else if constexpr (MODE == AXPBY_DOT) {
      const T z = a * v0[i] + w * v1[i];
      x_out[i] = z;
      acc0 += z * z;
    } else {
      const T rn = v2[i] - w * v3[i];
      x_out[i] = v4[i] + a * v0[i] + w * v1[i];
      r_out[i] = rn;
      acc0 += rn * rn;
      acc1 += v5[i] * rn;
    }
  }
  if constexpr (MODE != BICG_TAIL) {
    const T v[1] = {acc0};
    block_reduce_store<T, 1>(v, partials);
  } else {
    const T v[2] = {acc0, acc1};
    block_reduce_store<T, 2>(v, partials);
  }
}

template <typename T>
cudaError_t run(int mode, long long n, const T* alpha, const T* omega,
                const T* const* v, T* x_out, T* r_out, T* partials,
                T* dots, int nblocks, cudaStream_t s) {
  if (mode == XR) {
    tail_kernel<T, XR><<<nblocks, kBlock, 0, s>>>(
        n, alpha, omega, v[0], v[1], v[2], v[3], nullptr, nullptr, x_out,
        r_out, partials);
    launch_reduce<T>(partials, nblocks, 1, dots, s);
  } else if (mode == BICG_TAIL) {
    tail_kernel<T, BICG_TAIL><<<nblocks, kBlock, 0, s>>>(
        n, alpha, omega, v[0], v[1], v[2], v[3], v[4], v[5], x_out, r_out,
        partials);
    launch_reduce<T>(partials, nblocks, 2, dots, s);
  } else if (mode == AXPBY_DOT) {
    tail_kernel<T, AXPBY_DOT><<<nblocks, kBlock, 0, s>>>(
        n, alpha, omega, v[0], v[1], nullptr, nullptr, nullptr, nullptr,
        x_out, nullptr, partials);
    launch_reduce<T>(partials, nblocks, 1, dots, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int mode, long long n, const void* alpha,
                     const void* omega, const void* const* vecs, void* x_out,
                     void* r_out, void* partials, void* dots, int nblocks,
                     cudaStream_t s) {
  const T* v[6];
  for (int j = 0; j < 6; ++j) v[j] = static_cast<const T*>(vecs[j]);
  return run<T>(mode, n, static_cast<const T*>(alpha),
                static_cast<const T*>(omega), v, static_cast<T*>(x_out),
                static_cast<T*>(r_out), static_cast<T*>(partials),
                static_cast<T*>(dots), nblocks, s);
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
  const void* vecs[6] = {p, q, x, r, nullptr, nullptr};
  if (dtype == 0)
    return dispatch<float>(XR, n, alpha, nullptr, vecs, x_out, r_out,
                           partials, dot, nblocks, s);
  if (dtype == 1)
    return dispatch<double>(XR, n, alpha, nullptr, vecs, x_out, r_out,
                            partials, dot, nblocks, s);
  return cudaErrorInvalidValue;
}

// dtype as above; `alpha` and `omega` point to one device value each;
// `partials` holds nblocks * 2 values and `dots` two: ⟨r', r'⟩, ⟨r̂, r'⟩.
extern "C" int amgcl_bicg_tail(int dtype, long long n, const void* alpha,
                               const void* omega, const void* phat,
                               const void* shat, const void* s_vec,
                               const void* t, const void* x,
                               const void* rhat, void* x_out, void* r_out,
                               void* partials, void* dots, int nblocks,
                               void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* vecs[6] = {phat, shat, s_vec, t, x, rhat};
  if (dtype == 0)
    return dispatch<float>(BICG_TAIL, n, alpha, omega, vecs, x_out, r_out,
                           partials, dots, nblocks, s);
  if (dtype == 1)
    return dispatch<double>(BICG_TAIL, n, alpha, omega, vecs, x_out, r_out,
                            partials, dots, nblocks, s);
  return cudaErrorInvalidValue;
}

// dtype as above; `a` and `b` point to one device value each; `partials`
// holds nblocks values and `dot` one: ⟨z, z⟩.
extern "C" int amgcl_axpby_dot(int dtype, long long n, const void* a,
                               const void* b, const void* x, const void* y,
                               void* z, void* partials, void* dot,
                               int nblocks, void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* vecs[6] = {x, y, nullptr, nullptr, nullptr, nullptr};
  if (dtype == 0)
    return dispatch<float>(AXPBY_DOT, n, a, b, vecs, z, nullptr, partials,
                           dot, nblocks, s);
  if (dtype == 1)
    return dispatch<double>(AXPBY_DOT, n, a, b, vecs, z, nullptr, partials,
                            dot, nblocks, s);
  return cudaErrorInvalidValue;
}
