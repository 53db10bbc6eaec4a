// The Krylov iteration tails for Hopper (sm_90a), three modes:
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
// 10 operations (8·n·sizeof(T) / 3.35 TB/s: 0.0008 ms at n = 85,623 in
// float32); AXPBY_DOT reads two and writes one against 5 operations
// (3·n·sizeof(T) / 3.35 TB/s: 0.0003 ms). At the BiCGStab paths' n the
// launch, and not the bytes, is the cost.
//
// Every mode: one grid-stride elementwise pass (`tail_pass`) over a fixed
// grid of min(ceil(n / 256), 1056) blocks of 256 threads, element i in
// thread i mod (grid · 256), so the per-thread sums (acc += v·v, in
// element order) and the per-block partials fall in the same order on
// every run; accumulated in T. α and ω (a and b) arrive as pointers to
// 0-d device tensors, so the host never waits for the device to learn
// them.
//
// XR sums its partials in a second launch (reduce.cuh's
// block_reduce_store + reduce_partials). BICG_TAIL and AXPBY_DOT
// (`tail_dots_kernel`) do the same sums in one launch, bit for bit: at
// the paths' n the second launch and the first design's eight-barrier
// tree were most of their time. A block writes its threads' sums to
// shared memory and, after one barrier, warp j runs dot j's 256-tree in
// block_reduce_store's pairing (tree256) and fences its partial; the
// grid's last block (an atomic ticket, last_block) sums each dot's
// partials in reduce_partials' order (lane_sums_once: a lane's at most
// five partials of every dot loaded at once, then added in order; then
// tree256) and writes the dots. The ticket is atomicInc'd
// modulo the grid, so the last block leaves it at 0; the wrapper keeps
// one per (device, stream).
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace amgcl_port {
namespace {

enum TailMode { XR = 0, BICG_TAIL = 1, AXPBY_DOT = 2 };

// the fixed grid: 8 blocks of 256 on each of the H100's 132 SMs
constexpr long long kMaxBlocks = 1056;
// partials a lane of the last block sums: all of them in one round
constexpr int kLaneRound = (kMaxBlocks + kGroup - 1) / kGroup;

// The elementwise pass of every mode, in its first design's expressions
// (nvcc contracts them to the same fmas in every kernel that inlines it):
// thread g of the grid takes elements g, g + grid·256, …; its sums go to
// acc0 and acc1.
// XR:        v0..v3 = p, q, x, r
// BICG_TAIL: v0..v5 = p̂, ŝ, s, t, x, r̂
// AXPBY_DOT: v0, v1 = x, y; alpha, omega = a, b; x_out = z
template <typename T, int MODE>
__device__ __forceinline__ void tail_pass(
    long long n, const T* __restrict__ alpha, const T* __restrict__ omega,
    const T* __restrict__ v0, const T* __restrict__ v1,
    const T* __restrict__ v2, const T* __restrict__ v3,
    const T* __restrict__ v4, const T* __restrict__ v5,
    T* __restrict__ x_out, T* __restrict__ r_out, T& acc0, T& acc1) {
  const T a = *alpha;
  const T w = MODE == XR ? T(0) : *omega;
  acc0 = T(0);
  acc1 = T(0);
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
}

// XR: the pass and each block's partial; reduce_partials sums them.
template <typename T>
__global__ void __launch_bounds__(kBlock)
tail_kernel(long long n, const T* __restrict__ alpha,
            const T* __restrict__ p, const T* __restrict__ q,
            const T* __restrict__ x, const T* __restrict__ r,
            T* __restrict__ x_out, T* __restrict__ r_out,
            T* __restrict__ partials) {
  T acc0, acc1;
  tail_pass<T, XR>(n, alpha, nullptr, p, q, x, r, nullptr, nullptr, x_out,
                   r_out, acc0, acc1);
  const T v[1] = {acc0};
  block_reduce_store<T, 1>(v, partials);
}

// BICG_TAIL and AXPBY_DOT in one launch: the pass, each block's partials
// (partials[j * gridDim.x + block]), and in the last block the dots.
template <typename T, int MODE>
__global__ void __launch_bounds__(kBlock)
tail_dots_kernel(long long n, const T* __restrict__ alpha,
                 const T* __restrict__ omega, const T* __restrict__ v0,
                 const T* __restrict__ v1, const T* __restrict__ v2,
                 const T* __restrict__ v3, const T* __restrict__ v4,
                 const T* __restrict__ v5, T* __restrict__ x_out,
                 T* __restrict__ r_out, T* __restrict__ partials,
                 T* __restrict__ dots, unsigned int* __restrict__ ticket) {
  constexpr int ND = MODE == BICG_TAIL ? 2 : 1;
  __shared__ T s[ND][kGroup];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  T acc[2];
  tail_pass<T, MODE>(n, alpha, omega, v0, v1, v2, v3, v4, v5, x_out, r_out,
                     acc[0], acc[1]);
#pragma unroll
  for (int j = 0; j < ND; ++j) s[j][t] = acc[j];
  __syncthreads();
  if (warp < ND) {
    const T p = tree256(s[warp], lane);
    if (lane == 0) {
      partials[static_cast<size_t>(warp) * gridDim.x + blockIdx.x] = p;
      __threadfence();
    }
  }
  if (!last_block(ticket)) return;
  lane_sums_once<T, ND, kLaneRound>(partials, gridDim.x, t, s);
  __syncthreads();
  if (warp < ND) {
    const T d = tree256(s[warp], lane);
    if (lane == 0) dots[warp] = d;
  }
}

template <typename T>
cudaError_t run(int mode, long long n, const T* alpha, const T* omega,
                const T* const* v, T* x_out, T* r_out, T* partials,
                T* dots, unsigned int* ticket, int nblocks, cudaStream_t s) {
  const long long groups = (n + kBlock - 1) / kBlock;
  if (n < 1 || nblocks != (groups < kMaxBlocks ? groups : kMaxBlocks))
    return cudaErrorInvalidValue;
  if (mode == XR) {
    tail_kernel<T><<<nblocks, kBlock, 0, s>>>(n, alpha, v[0], v[1], v[2],
                                              v[3], x_out, r_out, partials);
    launch_reduce<T>(partials, nblocks, 1, dots, s);
  } else if (mode == BICG_TAIL || mode == AXPBY_DOT) {
    if (ticket == nullptr) return cudaErrorInvalidValue;
    if (mode == BICG_TAIL)
      tail_dots_kernel<T, BICG_TAIL><<<nblocks, kBlock, 0, s>>>(
          n, alpha, omega, v[0], v[1], v[2], v[3], v[4], v[5], x_out, r_out,
          partials, dots, ticket);
    else
      tail_dots_kernel<T, AXPBY_DOT><<<nblocks, kBlock, 0, s>>>(
          n, alpha, omega, v[0], v[1], nullptr, nullptr, nullptr, nullptr,
          x_out, nullptr, partials, dots, ticket);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int mode, long long n, const void* alpha,
                     const void* omega, const void* const* vecs, void* x_out,
                     void* r_out, void* partials, void* dots, void* ticket,
                     int nblocks, cudaStream_t s) {
  const T* v[6];
  for (int j = 0; j < 6; ++j) v[j] = static_cast<const T*>(vecs[j]);
  return run<T>(mode, n, static_cast<const T*>(alpha),
                static_cast<const T*>(omega), v, static_cast<T*>(x_out),
                static_cast<T*>(r_out), static_cast<T*>(partials),
                static_cast<T*>(dots), static_cast<unsigned int*>(ticket),
                nblocks, s);
}

}  // namespace
}  // namespace amgcl_port

// Every entry: dtype 0 = float32, 1 = float64; nblocks must be
// min(ceil(n / 256), 1056), n at least 1. Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue, launching nothing, for a grid it
// refuses.

// `alpha` points to one device value of the data type; `partials` holds
// nblocks values, `dot` one. Two launches.
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
                           partials, dot, nullptr, nblocks, s);
  if (dtype == 1)
    return dispatch<double>(XR, n, alpha, nullptr, vecs, x_out, r_out,
                            partials, dot, nullptr, nblocks, s);
  return cudaErrorInvalidValue;
}

// `alpha` and `omega` point to one device value each; `partials` holds
// nblocks * 2 values and `dots` two: ⟨r', r'⟩, ⟨r̂, r'⟩; `ticket` is a
// device counter at 0, left at 0. One launch.
extern "C" int amgcl_bicg_tail(int dtype, long long n, const void* alpha,
                               const void* omega, const void* phat,
                               const void* shat, const void* s_vec,
                               const void* t, const void* x,
                               const void* rhat, void* x_out, void* r_out,
                               void* partials, void* dots, void* ticket,
                               int nblocks, void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* vecs[6] = {phat, shat, s_vec, t, x, rhat};
  if (dtype == 0)
    return dispatch<float>(BICG_TAIL, n, alpha, omega, vecs, x_out, r_out,
                           partials, dots, ticket, nblocks, s);
  if (dtype == 1)
    return dispatch<double>(BICG_TAIL, n, alpha, omega, vecs, x_out, r_out,
                            partials, dots, ticket, nblocks, s);
  return cudaErrorInvalidValue;
}

// `a` and `b` point to one device value each; `partials` holds nblocks
// values and `dot` one: ⟨z, z⟩; `ticket` as above. One launch.
extern "C" int amgcl_axpby_dot(int dtype, long long n, const void* a,
                               const void* b, const void* x, const void* y,
                               void* z, void* partials, void* dot,
                               void* ticket, int nblocks, void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* vecs[6] = {x, y, nullptr, nullptr, nullptr, nullptr};
  if (dtype == 0)
    return dispatch<float>(AXPBY_DOT, n, a, b, vecs, z, nullptr, partials,
                           dot, ticket, nblocks, s);
  if (dtype == 1)
    return dispatch<double>(AXPBY_DOT, n, a, b, vecs, z, nullptr, partials,
                            dot, ticket, nblocks, s);
  return cudaErrorInvalidValue;
}
