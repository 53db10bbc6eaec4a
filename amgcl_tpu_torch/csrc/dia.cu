// DIA sparse kernels for Hopper (sm_90a): SpMV, residual, SPAI-0/Jacobi
// correction (dia_kernel), and SpMV + dots, residual + norm (dots_kernel,
// dots_kernel_batched).
//
// Replaces the Pallas TPU kernels of amgcl_tpu/ops/pallas_spmv.py:
//   dia_spmv (SPMV), _dia_fused (RESIDUAL, CORRECTION), dia_spmv_dots
//   (SPMV_DOTS), dia_residual_dot (RESIDUAL_DOT).
//
// What bounds them on the H100: memory traffic. Per row a kernel does
// ndiag multiply-adds (2·ndiag operations) against ndiag·sizeof(T) bytes
// of diagonal data plus ~2-4 vectors — about 0.25 operations per byte at
// the 7-diagonal fine level, far below the card's ~20 (float32) balance
// point, so the least time is bytes / 3.35 TB/s.
//
// dia_kernel (SPMV, RESIDUAL, CORRECTION): one thread per row. The
// offsets sit in shared memory (up to kMaxDiag); the loop over diagonals
// reads data[k, i] and x[i + off_k], both coalesced across a warp because
// consecutive threads take consecutive rows. The x index is guarded
// against [0, m) explicitly, which also covers rectangular operators.
// Its bfloat16 mode loads bfloat16 and rounds each product and each sum
// to bfloat16 in diagonal order (bf16.cuh), where the TPU kernel's
// bfloat16 accumulator rounds (pallas_spmv.py:311, :367): bit for bit
// with the plain version, which rounds each torch operation alike.
//
// dots_kernel / dots_kernel_batched (SPMV_DOTS, RESIDUAL_DOT; square
// operators): one launch a call. Its results are bit for bit those of the first design (a
// thread-per-row pass writing one partial per 256 rows, then a reduction
// kernel), whose order this kernel keeps:
//   1. Row value: acc = 0 (SPMV_DOTS) or f[i] (RESIDUAL_DOT); for k = 0 …
//      ndiag−1 in order, acc = fma(±data[k, i], x[i + off_k], acc); a term
//      whose column falls outside [0, m) is skipped, not added as 0 (the
//      first design's `acc += data * x` under nvcc's default --fmad=true
//      is this fma; written out here).
//   2. Products, each rounded alone (no contraction): d0 = acc·acc,
//      d1 = acc·x[i], d2 = acc·w[i]; rows ≥ n give 0.
//   3. Partial of group g, rows [256g, 256g+256): the tree
//      s[t] += s[t+stride] for stride = 128, 64, …, 1.
//   4. Each dot: lane t of 256 adds partials t, t+256, t+512, … to 0 in
//      that order, then the same 128 … 1 tree.
// The design, against what held the first one back:
//   - A thread per row, each batch of loads issued before its ordered fma
//     chain: all 7 diagonals of the stencil fine level (dots_kernel's
//     instantiation), batches of kBatch otherwise (dots_kernel_batched,
//     capped at 32 registers in float32 so that a 33-diagonal level's
//     1,024 groups fit on the card at once); f, x[i] and w[i] are loaded
//     with the first batch. The first design issued one load at a time
//     behind a bounds test.
//   - Interior groups (the host's [lo, hi): every row < n, every column
//     in [0, m)) run without a bounds test; edge groups test each term.
//   - The offsets are a kernel parameter (__grid_constant__), not staged.
//   - A block of 256 threads walks the groups blockIdx.x + k · gridDim.x,
//     the grid as many blocks as fit on the card at once. Per group it
//     writes its rows' products to shared memory, one barrier, and warp j
//     runs dot j's tree while the others go on to the next group (two
//     buffers): the tree's first level (stride 128) inside a lane that
//     holds positions 4l … 4l+3 and 128+4l … 131+4l, the next five
//     (64 … 4) as __shfl_down_sync by 16 … 1, the last two inside lane 0
//     (reduce.cuh's tree256). One barrier a group, not eight.
//   - The last block to finish (a __threadfence and an atomic ticket,
//     once a block; reduce.cuh's last_block) sums the partials
//     (lane_sums, then tree256), so one launch does both stages. The
//     ticket is atomicInc'd modulo the grid: the last block leaves it at
//     0, so no host reset is needed. The wrapper keeps one zeroed ticket
//     per (device, stream).
// Dots accumulate in T: float32 for float32 data, float64 for float64,
// as the TPU kernels do (pallas_spmv.py:429-430).
//
// Their bfloat16 mode (a bfloat16 Krylov loop, the TPU kernels' bfloat16
// dtype): the row value as dia_kernel's bfloat16 mode forms it, each
// product and each sum rounded to bfloat16 in diagonal order (a term
// outside [0, m) skipped), y stored in bfloat16; the products, partials
// and lane sums in float32 in the order above (a product of two bfloat16
// values is exact in float32), and each dot rounded once to bfloat16,
// as the TPU kernel's float32 SMEM sums are cast to the out dtype
// (pallas_spmv.py:470-474, :527-529): float32 partials, bfloat16 dots.
// Bound: bytes again, at 2 bytes a value.
#include <cuda_runtime.h>

#include "bf16.cuh"
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
           const T* __restrict__ w, T* __restrict__ y) {
  __shared__ int s_off[kMaxDiag];
  for (int k = threadIdx.x; k < ndiag; k += kBlock) s_off[k] = offsets[k];
  __syncthreads();

  constexpr bool from_f = MODE == RESIDUAL || MODE == CORRECTION;
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (i >= n) return;
  if constexpr (kIsBf16<T>) {
    // bfloat16: each product and each sum rounded to bfloat16, in
    // diagonal order, as the plain version and the TPU kernel round
    float acc = from_f ? bf_load(f[i]) : 0.f;
    for (int k = 0; k < ndiag; ++k) {
      const long long j = i + s_off[k];
      if (j >= 0 && j < m) {
        const float v = bf_mul(bf_load(data[static_cast<size_t>(k) * n + i]),
                               bf_load(x[j]));
        acc = from_f ? bf_sub(acc, v) : bf_add(acc, v);
      }
    }
    if constexpr (MODE == CORRECTION)
      acc = bf_add(bf_load(x[i]), bf_mul(bf_load(w[i]), acc));
    y[i] = bf_store(acc);
  } else {
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
  }
}

template <typename T>
cudaError_t run(int mode, long long n, long long m, int ndiag,
                const int* offsets, const T* data, const T* x, const T* f,
                const T* w, T* y, int nblocks, cudaStream_t s) {
  if (ndiag > kMaxDiag) return cudaErrorInvalidValue;
  switch (mode) {
    case SPMV:
      dia_kernel<T, SPMV><<<nblocks, kBlock, 0, s>>>(
          n, m, ndiag, offsets, data, x, f, w, y);
      break;
    case RESIDUAL:
      dia_kernel<T, RESIDUAL><<<nblocks, kBlock, 0, s>>>(
          n, m, ndiag, offsets, data, x, f, w, y);
      break;
    case CORRECTION:
      dia_kernel<T, CORRECTION><<<nblocks, kBlock, 0, s>>>(
          n, m, ndiag, offsets, data, x, f, w, y);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- SPMV_DOTS / RESIDUAL_DOT ------------------------------------------

constexpr int kStencilDiag = 7;       // the unrolled instantiation
constexpr int kBatch = 11;            // diagonals a batch otherwise

template <typename T>
struct DotsArgs {
  long long n, m;
  int ndiag, ndots, ngroups, lo, hi;          // interior groups [lo, hi)
  const T* data;
  const T* x;
  const T* f;
  const T* w;
  T* y;
  Acc<T>* partials;       // ndots × ngroups, in the sums' type
  T* dots;                // ndots, in the data type
  unsigned int* ticket;
  int off[kMaxDiag];
};

// one value of the data, in the dots' type
template <typename T>
__device__ __forceinline__ Acc<T> ld(const T* p) {
  if constexpr (kIsBf16<T>) return bf_load(__ldg(p));
  else return __ldg(p);
}

// acc ± d·x: one fma in float32 and float64; in bfloat16 the product
// and then the sum rounded to bfloat16
template <typename T, bool SUB, typename A>
__device__ __forceinline__ A term(A d, A x, A acc) {
  if constexpr (kIsBf16<T>) {
    const A v = bf_mul(d, x);
    return SUB ? bf_sub(acc, v) : bf_add(acc, v);
  } else {
    return fma_rn(SUB ? -d : d, x, acc);
  }
}

// The row value of row i < n (point 1). Each batch issues its loads of
// data and x together, then adds them in order. CHECK false: the caller
// found every column of the row in [0, m), so no term is tested.
template <typename T, bool SUB, bool CHECK, int ND, typename A = Acc<T>>
__device__ __forceinline__ A row_value(const DotsArgs<T>& a, long long i,
                                       A acc) {
  constexpr int KB = ND > 0 ? ND : kBatch;
  const int nd = ND > 0 ? ND : a.ndiag;
  for (int k0 = 0; k0 < nd; k0 += KB) {
    A dv[KB], xv[KB];
    bool in[KB];
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const int k = k0 + b;
      const long long j = i + ((ND > 0 || k < nd) ? a.off[k] : 0);
      in[b] = (ND > 0 || k < nd) && (!CHECK || (j >= 0 && j < a.m));
      dv[b] = in[b] ? ld(a.data + static_cast<size_t>(k) * a.n + i) : A(0);
      xv[b] = in[b] ? ld(a.x + j) : A(0);
    }
#pragma unroll
    for (int b = 0; b < KB; ++b)
      if (in[b]) acc = term<T, SUB>(dv[b], xv[b], acc);
  }
  return acc;
}

template <typename T, int MODE, int ND>
__device__ __forceinline__ void dots_body(const DotsArgs<T>& a) {
  using A = Acc<T>;
  constexpr bool SUB = MODE == RESIDUAL_DOT;
  constexpr int NDOT = MODE == SPMV_DOTS ? 3 : 1;
  __shared__ A s_d[2][NDOT][kGroup];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  A* partials = a.partials;

  // groups blockIdx.x, + gridDim.x, …: a thread a row (points 1 and 2,
  // 0 past n), then warp j sums dot j's 256 products (point 3) while the
  // other warps go on to the next group (two buffers of products)
  int buf = 0;
  for (int g = blockIdx.x; g < a.ngroups; g += gridDim.x, buf ^= 1) {
    const long long i = static_cast<long long>(g) * kGroup + t;
    const bool interior = g >= a.lo && g < a.hi;
    A d[NDOT];
#pragma unroll
    for (int j = 0; j < NDOT; ++j) d[j] = A(0);
    if (interior || i < a.n) {
      A xi = A(0), wi = A(0);
      A acc = SUB ? ld(a.f + i) : A(0);
      if constexpr (MODE == SPMV_DOTS) {
        xi = ld(a.x + i);
        if (a.ndots == 3) wi = ld(a.w + i);
      }
      acc = interior ? row_value<T, SUB, false, ND>(a, i, acc)
                     : row_value<T, SUB, true, ND>(a, i, acc);
      a.y[i] = narrow<T>(acc);
      d[0] = mul_rn(acc, acc);
      if constexpr (MODE == SPMV_DOTS) {
        d[1] = mul_rn(acc, xi);
        if (a.ndots == 3) d[2] = mul_rn(acc, wi);
      }
    }
#pragma unroll
    for (int j = 0; j < NDOT; ++j) s_d[buf][j][t] = d[j];
    __syncthreads();
    if (warp < a.ndots) {
      const A p = tree256(s_d[buf][warp], lane);
      if (lane == 0) partials[static_cast<size_t>(warp) * a.ngroups + g] = p;
    }
  }
  if (warp < a.ndots && lane == 0) __threadfence();

  // point 4, in the last block to finish (reduce.cuh)
  if (!last_block(a.ticket)) return;
  // lane t of 256: every dot's partials in flight together at the
  // stencil, one dot's at a time in the batched body, whose registers
  // are capped
  if constexpr (ND > 0) {
    lane_sums<A, NDOT>(partials, a.ngroups, a.ndots, 0, t, s_d[0]);
  } else {
#pragma unroll 1
    for (int j = 0; j < a.ndots; ++j)
      lane_sums<A, 1>(partials, a.ngroups, a.ndots, j, t, s_d[0]);
  }
  __syncthreads();
  if (warp < a.ndots) {
    const A s = tree256(s_d[0][warp], lane);
    if (lane == 0) a.dots[warp] = narrow<T>(s);
  }
}

// The stencil's instantiation (ND 7) takes the registers ptxas gives it;
// the batched one (ND 0) is capped at 32 in float32 and bfloat16 and 64
// in float64, so that a 33-diagonal level's 1,024 groups fit on the card
// at once (PERF.md §6).
template <typename T, int MODE, int ND>
__global__ void __launch_bounds__(kGroup)
dots_kernel(const __grid_constant__ DotsArgs<T> a) {
  dots_body<T, MODE, ND>(a);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kGroup, sizeof(T) == 8 ? 4 : 8)
dots_kernel_batched(const __grid_constant__ DotsArgs<T> a) {
  dots_body<T, MODE, 0>(a);
}

// blocks that fit on the card at once: the kernel's grid (at most one per
// group), so each block walks its groups and fences and takes a ticket
// once
template <typename T, int MODE, int ND>
int dots_slots() {
  static const int slots = [] {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if constexpr (ND > 0)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, dots_kernel<T, MODE, ND>, kGroup, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, dots_kernel_batched<T, MODE>, kGroup, 0);
    return sms * per > 0 ? sms * per : 1;
  }();
  return slots;
}

template <typename T, int MODE, int ND>
cudaError_t launch_dots(const DotsArgs<T>& a, cudaStream_t s) {
  const int slots = dots_slots<T, MODE, ND>();
  const int grid = a.ngroups < slots ? a.ngroups : slots;
  if constexpr (ND > 0)
    dots_kernel<T, MODE, ND><<<grid, kGroup, 0, s>>>(a);
  else
    dots_kernel_batched<T, MODE><<<grid, kGroup, 0, s>>>(a);
  return cudaGetLastError();
}

// Refuses a group count other than ceil(n / 256), or an interior group
// with a row past n or a term outside [0, m).
template <typename T>
cudaError_t run_dots(int mode, long long n, long long m, int ndiag,
                     const int* offsets, const T* data, const T* x,
                     const T* f, const T* w, T* y, Acc<T>* partials,
                     T* dots, unsigned int* ticket, int ngroups, int lo, int hi,
                     cudaStream_t s) {
  if ((mode != SPMV_DOTS && mode != RESIDUAL_DOT) || ndiag < 0 ||
      ndiag > kMaxDiag || n < 1 || m != n || ticket == nullptr ||
      partials == nullptr || dots == nullptr ||
      ngroups != (n + kGroup - 1) / kGroup ||
      (mode == RESIDUAL_DOT && f == nullptr) || lo < 0 || hi > ngroups)
    return cudaErrorInvalidValue;
  DotsArgs<T> a;
  a.n = n;
  a.m = m;
  a.ndiag = ndiag;
  a.ndots = mode == RESIDUAL_DOT ? 1 : (w != nullptr ? 3 : 2);
  a.ngroups = ngroups;
  a.lo = lo;
  a.hi = hi > lo ? hi : lo;
  a.data = data;
  a.x = x;
  a.f = f;
  a.w = w;
  a.y = y;
  a.partials = partials;
  a.dots = dots;
  a.ticket = ticket;
  int omin = 0, omax = 0;
  for (int k = 0; k < ndiag; ++k) {
    a.off[k] = offsets[k];
    omin = k ? (offsets[k] < omin ? offsets[k] : omin) : offsets[k];
    omax = k ? (offsets[k] > omax ? offsets[k] : omax) : offsets[k];
  }
  if (a.hi > a.lo) {
    const long long first = static_cast<long long>(a.lo) * kGroup;
    const long long end = static_cast<long long>(a.hi) * kGroup;
    if (end > n || first + omin < 0 || end + omax > m)
      return cudaErrorInvalidValue;
  }
  const bool stencil = ndiag == kStencilDiag;
  if (mode == SPMV_DOTS)
    return stencil ? launch_dots<T, SPMV_DOTS, kStencilDiag>(a, s)
                   : launch_dots<T, SPMV_DOTS, 0>(a, s);
  return stencil ? launch_dots<T, RESIDUAL_DOT, kStencilDiag>(a, s)
                 : launch_dots<T, RESIDUAL_DOT, 0>(a, s);
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 1 = float64, 2 = bfloat16 (every operation rounded
// to bfloat16). Modes SPMV, RESIDUAL, CORRECTION: `f`
// is read by the residual-shaped modes, `w` by CORRECTION (scale).
// Returns the cudaError_t of the launch.
extern "C" int amgcl_dia(int dtype, int mode, long long n, long long m,
                         int ndiag, const void* offsets, const void* data,
                         const void* x, const void* f, const void* w,
                         void* y, int nblocks, void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (dtype == 0)
    return run<float>(mode, n, m, ndiag, off,
                      static_cast<const float*>(data),
                      static_cast<const float*>(x),
                      static_cast<const float*>(f),
                      static_cast<const float*>(w), static_cast<float*>(y),
                      nblocks, s);
  if (dtype == 1)
    return run<double>(mode, n, m, ndiag, off,
                       static_cast<const double*>(data),
                       static_cast<const double*>(x),
                       static_cast<const double*>(f),
                       static_cast<const double*>(w),
                       static_cast<double*>(y), nblocks, s);
  if (dtype == 2)
    return run<bf16>(mode, n, m, ndiag, off, static_cast<const bf16*>(data),
                     static_cast<const bf16*>(x), static_cast<const bf16*>(f),
                     static_cast<const bf16*>(w), static_cast<bf16*>(y),
                     nblocks, s);
  return cudaErrorInvalidValue;
}

// Modes SPMV_DOTS (`w` optional: the third dot) and RESIDUAL_DOT (`f`),
// square operators; dtype 0, 1 or 2 (bfloat16). `offsets` are host ints.
// `partials` holds ndots × ceil(n / 256) values of the data type, float32
// for bfloat16, and `dots` ndots values of the data type (ndots = 3 for
// SPMV_DOTS with w, 2 without, 1 for RESIDUAL_DOT); `ticket` is a device
// counter at 0, left at 0. ngroups = ceil(n / 256); groups [lo, hi) run
// unchecked. Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue, launching nothing, for a geometry it refuses.
extern "C" int amgcl_dia_dots(int dtype, int mode, long long n, long long m,
                              int ndiag, const int* offsets, const void* data,
                              const void* x, const void* f, const void* w,
                              void* y, void* partials, void* dots,
                              void* ticket,
                              int ngroups, int lo, int hi, void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  if (dtype == 0)
    return run_dots<float>(mode, n, m, ndiag, offsets,
                           static_cast<const float*>(data),
                           static_cast<const float*>(x),
                           static_cast<const float*>(f),
                           static_cast<const float*>(w),
                           static_cast<float*>(y),
                           static_cast<float*>(partials),
                           static_cast<float*>(dots), tk, ngroups, lo, hi,
                           s);
  if (dtype == 1)
    return run_dots<double>(mode, n, m, ndiag, offsets,
                            static_cast<const double*>(data),
                            static_cast<const double*>(x),
                            static_cast<const double*>(f),
                            static_cast<const double*>(w),
                            static_cast<double*>(y),
                            static_cast<double*>(partials),
                            static_cast<double*>(dots), tk, ngroups, lo,
                            hi, s);
  if (dtype == 2)
    return run_dots<bf16>(mode, n, m, ndiag, offsets,
                          static_cast<const bf16*>(data),
                          static_cast<const bf16*>(x),
                          static_cast<const bf16*>(f),
                          static_cast<const bf16*>(w), static_cast<bf16*>(y),
                          static_cast<float*>(partials),
                          static_cast<bf16*>(dots), tk, ngroups, lo, hi, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* amgcl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
