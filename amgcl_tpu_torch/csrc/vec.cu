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
// every run; accumulated in T (float32 for bfloat16). α and ω (a and b) arrive as pointers to
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
//
// The bfloat16 mode of every tail (a bfloat16 Krylov loop): vectors and
// scalars in bfloat16, each product and each sum rounded to bfloat16 in
// the TPU body's order (fused_vec.py:216-241: x + a·p; r − a·q;
// (x + a·p̂) + w·ŝ; s − w·t; a·x + b·y), as the JAX package's interpret
// mode and the plain versions' torch operations round; the dots summed
// in float32 in the order above (products of bfloat16 values are exact
// in float32) and rounded once to bfloat16 (fused_vec.py:267), by the
// same launches as in float32. Bound: bytes, at 2 bytes a value.
#include <cuda_runtime.h>

#include "bf16.cuh"
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
template <typename T, int MODE, typename A = Acc<T>>
__device__ __forceinline__ void tail_pass(
    long long n, const T* __restrict__ alpha, const T* __restrict__ omega,
    const T* __restrict__ v0, const T* __restrict__ v1,
    const T* __restrict__ v2, const T* __restrict__ v3,
    const T* __restrict__ v4, const T* __restrict__ v5,
    T* __restrict__ x_out, T* __restrict__ r_out, A& acc0, A& acc1) {
  acc0 = A(0);
  acc1 = A(0);
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  if constexpr (kIsBf16<T>) {
    // every operation rounded to bfloat16, the sums in float32
    const float a = bf_load(*alpha);
    const float w = MODE == XR ? 0.f : bf_load(*omega);
    for (long long i = static_cast<long long>(blockIdx.x) * kBlock +
                       threadIdx.x;
         i < n; i += stride) {
      if constexpr (MODE == XR) {
        const float rn = bf_sub(bf_load(v3[i]), bf_mul(a, bf_load(v1[i])));
        x_out[i] = bf_store(bf_add(bf_load(v2[i]),
                                   bf_mul(a, bf_load(v0[i]))));
        r_out[i] = bf_store(rn);
        acc0 = fma_rn(rn, rn, acc0);
      } else if constexpr (MODE == AXPBY_DOT) {
        const float z = bf_add(bf_mul(a, bf_load(v0[i])),
                               bf_mul(w, bf_load(v1[i])));
        x_out[i] = bf_store(z);
        acc0 = fma_rn(z, z, acc0);
      } else {
        const float rn = bf_sub(bf_load(v2[i]), bf_mul(w, bf_load(v3[i])));
        const float xa = bf_add(bf_load(v4[i]), bf_mul(a, bf_load(v0[i])));
        x_out[i] = bf_store(bf_add(xa, bf_mul(w, bf_load(v1[i]))));
        r_out[i] = bf_store(rn);
        acc0 = fma_rn(rn, rn, acc0);
        acc1 = fma_rn(bf_load(v5[i]), rn, acc1);
      }
    }
  } else {
    const T a = *alpha;
    const T w = MODE == XR ? T(0) : *omega;
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
}

// XR: the pass and each block's partial, in the sums' type;
// reduce_partials sums them.
template <typename T>
__global__ void __launch_bounds__(kBlock)
tail_kernel(long long n, const T* __restrict__ alpha,
            const T* __restrict__ p, const T* __restrict__ q,
            const T* __restrict__ x, const T* __restrict__ r,
            T* __restrict__ x_out, T* __restrict__ r_out,
            Acc<T>* __restrict__ partials) {
  Acc<T> acc0, acc1;
  tail_pass<T, XR>(n, alpha, nullptr, p, q, x, r, nullptr, nullptr, x_out,
                   r_out, acc0, acc1);
  const Acc<T> v[1] = {acc0};
  block_reduce_store<Acc<T>, 1>(v, partials);
}

// BICG_TAIL and AXPBY_DOT in one launch: the pass, each block's partials
// (partials[j * gridDim.x + block], in the sums' type), and in the last
// block the dots (rounded once to bfloat16 in the bfloat16 mode).
template <typename T, int MODE>
__global__ void __launch_bounds__(kBlock)
tail_dots_kernel(long long n, const T* __restrict__ alpha,
                 const T* __restrict__ omega, const T* __restrict__ v0,
                 const T* __restrict__ v1, const T* __restrict__ v2,
                 const T* __restrict__ v3, const T* __restrict__ v4,
                 const T* __restrict__ v5, T* __restrict__ x_out,
                 T* __restrict__ r_out, Acc<T>* __restrict__ partials,
                 T* __restrict__ dots, unsigned int* __restrict__ ticket) {
  using A = Acc<T>;
  constexpr int ND = MODE == BICG_TAIL ? 2 : 1;
  __shared__ A s[ND][kGroup];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  A acc[2];
  tail_pass<T, MODE>(n, alpha, omega, v0, v1, v2, v3, v4, v5, x_out, r_out,
                     acc[0], acc[1]);
#pragma unroll
  for (int j = 0; j < ND; ++j) s[j][t] = acc[j];
  __syncthreads();
  if (warp < ND) {
    const A p = tree256(s[warp], lane);
    if (lane == 0) {
      partials[static_cast<size_t>(warp) * gridDim.x + blockIdx.x] = p;
      __threadfence();
    }
  }
  if (!last_block(ticket)) return;
  lane_sums_once<A, ND, kLaneRound>(partials, gridDim.x, t, s);
  __syncthreads();
  if (warp < ND) {
    const A d = tree256(s[warp], lane);
    if (lane == 0) dots[warp] = narrow<T>(d);
  }
}

template <typename T>
cudaError_t run(int mode, long long n, const T* alpha, const T* omega,
                const T* const* v, T* x_out, T* r_out, Acc<T>* partials,
                T* dots, unsigned int* ticket, int nblocks, cudaStream_t s) {
  const long long groups = (n + kBlock - 1) / kBlock;
  if (n < 1 || nblocks != (groups < kMaxBlocks ? groups : kMaxBlocks))
    return cudaErrorInvalidValue;
  if (mode == XR) {
    tail_kernel<T><<<nblocks, kBlock, 0, s>>>(n, alpha, v[0], v[1], v[2],
                                              v[3], x_out, r_out, partials);
    launch_reduce<Acc<T>, T>(partials, nblocks, 1, dots, s);
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
                static_cast<T*>(r_out), static_cast<Acc<T>*>(partials),
                static_cast<T*>(dots), static_cast<unsigned int*>(ticket),
                nblocks, s);
}

}  // namespace
}  // namespace amgcl_port

// Every entry: dtype 0 = float32, 1 = float64, 2 = bfloat16; nblocks
// must be min(ceil(n / 256), 1056), n at least 1; `partials` are of the
// data type, float32 for bfloat16. Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue, launching nothing, for a grid it
// refuses.
template <typename... Args>
int by_dtype(int dtype, Args... args) {
  using namespace amgcl_port;
  if (dtype == 0) return dispatch<float>(args...);
  if (dtype == 1) return dispatch<double>(args...);
  if (dtype == 2) return dispatch<bf16>(args...);
  return cudaErrorInvalidValue;
}

// `alpha` points to one device value of the data type; `partials` holds
// nblocks values, `dot` one. Two launches.
extern "C" int amgcl_xr(int dtype, long long n, const void* alpha,
                        const void* p, const void* q, const void* x,
                        const void* r, void* x_out, void* r_out,
                        void* partials, void* dot, int nblocks,
                        void* stream) {
  using namespace amgcl_port;
  const void* vecs[6] = {p, q, x, r, nullptr, nullptr};
  return by_dtype(dtype, XR, n, alpha, nullptr, vecs, x_out, r_out,
                  partials, dot, nullptr, nblocks,
                  static_cast<cudaStream_t>(stream));
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
  const void* vecs[6] = {phat, shat, s_vec, t, x, rhat};
  return by_dtype(dtype, BICG_TAIL, n, alpha, omega, vecs, x_out, r_out,
                  partials, dots, ticket, nblocks,
                  static_cast<cudaStream_t>(stream));
}

// `a` and `b` point to one device value each; `partials` holds nblocks
// values and `dot` one: ⟨z, z⟩; `ticket` as above. One launch.
extern "C" int amgcl_axpby_dot(int dtype, long long n, const void* a,
                               const void* b, const void* x, const void* y,
                               void* z, void* partials, void* dot,
                               void* ticket, int nblocks, void* stream) {
  using namespace amgcl_port;
  const void* vecs[6] = {x, y, nullptr, nullptr, nullptr, nullptr};
  return by_dtype(dtype, AXPBY_DOT, n, a, b, vecs, z, nullptr, partials,
                  dot, ticket, nblocks, static_cast<cudaStream_t>(stream));
}
