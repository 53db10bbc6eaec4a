// Gather SpMV for Hopper (sm_90a): y = A x for a scalar windowed-ELL
// operator of narrow K (4, 8, 12 or 16 column slots), the reduction over
// the slots unrolled at compile time.
//
// Replaces the Pallas TPU kernel amgcl_tpu/ops/pallas_gather.py::
// gather_spmv, which the reference's WindowedEllMatrix.mv runs for scalar
// operators with K <= 16 instead of windowed_ell_spmv.
//
// Storage: row i of tile t = i / tile holds vals[i*K + k] at column
// starts[t] + cols[i*K + k]; padding slots hold local column 0 and value
// 0. A tile without entries starts at the column count, so its padding
// addresses one past x: an absolute column >= ncols contributes nothing,
// as the TPU's window of x padded with zeros gives.
//
// What bounds it on the H100: memory traffic. A slot is one multiply-add
// (2 operations) against 4 + sizeof(T) bytes of index and value, 0.25
// operations per byte in float32, far below the card's balance point, so
// the least time is (cols + vals + x + y) bytes / 3.35 TB/s.
//
// The sum, which every path's iteration counts depend on (G1's IDR(s)
// moved from 65 to 70 iterations under another order): one thread runs
// the row's chain in slot order, acc = 0, then acc = fma(v_k, x_j, acc)
// for each slot k whose column j is below ncols; a slot past ncols is
// skipped (not added as 0: fma(0, x, -0) is +0), padding slots below
// ncols are not. That is the first design's `acc += v[k] * x[j]` under
// nvcc's default contraction, written out.
//
// Design: nothing is staged. The first design staged each 128-row
// block's cols and then its vals through shared memory in two strided
// loops, a barrier, then gathered x: two serial phases of memory latency
// in a life of a few microseconds. Here a thread takes a row: it loads
// the row's K / 4 4-slot vectors straight from device memory, 16 bytes at
// a time (int4 columns; a float4 or two double2 values: the wrapper
// checks that cols and vals start on 16-byte boundaries, and K is a
// multiple of 4, so every row does), all of them issued before the first
// x gather, and the row's tile start beside them; then all the row's x
// gathers through the read-only path (x stays in the 50 MB L2: 343 KB at
// the 85,623-row FE level in float32; the TPU's window DMA has no use
// here), then the chain. Blocks of `threads` rows
// (`gather_kernels.launch_geometry`) cover the rows once, every row of an
// 85,623-row level in flight in one wave. Two or four lanes a row, each
// loading a vector and handing its pairs to the row's first lane by
// shuffles, were no faster (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W).
// Offsets are 64-bit; the tile index takes a 32-bit division where n_out
// allows.
//
// The bfloat16 mode (a bfloat16 hierarchy's stored transfers and SPAI-1
// or ILU products of K <= 16): the TPU kernel accumulates in the values'
// dtype slot by slot (pallas_gather.py:70-74), so each product and each
// sum is rounded to bfloat16 (bf16.cuh), acc = 0 then acc = bf(acc +
// bf(v_k · x_j)) for every slot in order, a slot past ncols adding the
// product of its value and 0, as the TPU's zero-padded window gives. A
// row's 4-slot vector of values is one 8-byte load. Bound: bytes, at 2
// bytes a value.
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "reduce.cuh"

namespace amgcl_port {
namespace {

constexpr int kMaxThreads = 256;     // threads (rows) per block, at most

// One 4-slot vector of values, 16 bytes at a time: a float4, two double2.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
gather_kernel(long long n_out, long long ncols, int tile, bool narrow,
              const int* __restrict__ starts, const int* __restrict__ cols,
              const T* __restrict__ vals, const T* __restrict__ x,
              T* __restrict__ y) {
  using A = Acc<T>;
  constexpr int NQ = K / 4;                  // 4-slot vectors a row
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n_out) return;
  // the row's columns and values, every vector issued before any use
  int4 c[NQ];
  A v[NQ][4], xv[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    c[q] = __ldg(reinterpret_cast<const int4*>(cols + i * K) + q);
    load4(vals + i * K + 4 * q, v[q]);
  }
  const long long t =
      narrow ? static_cast<long long>(static_cast<unsigned>(i) /
                                      static_cast<unsigned>(tile))
             : i / tile;
  const long long s = __ldg(starts + t);
  // then every x gather of a slot whose column is below ncols
  bool in[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const long long j[4] = {s + c[q].x, s + c[q].y, s + c[q].z,
                            s + c[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      in[q][e] = j[e] < ncols;
      if constexpr (kIsBf16<T>)
        xv[q][e] = in[q][e] ? bf_load(__ldg(x + j[e])) : 0.f;
      else
        xv[q][e] = in[q][e] ? __ldg(x + j[e]) : T(0);
    }
  }
  A acc = A(0);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kIsBf16<T>)
        acc = bf_add(acc, bf_mul(v[q][e], xv[q][e]));
      else if (in[q][e])
        acc = fma_rn(v[q][e], xv[q][e], acc);
    }
  }
  if constexpr (kIsBf16<T>) y[i] = bf_store(acc);
  else y[i] = acc;
}

template <typename T, int K>
cudaError_t launch_k(int threads, int nblocks, long long n_out,
                     long long ncols, int tile, const int* starts,
                     const int* cols, const T* vals, const T* x, T* y,
                     cudaStream_t s) {
  gather_kernel<T, K><<<nblocks, threads, 0, s>>>(
      n_out, ncols, tile, n_out <= 0x7fffffffLL, starts, cols, vals, x, y);
  return cudaGetLastError();
}

// Refuses K other than 4, 8, 12 or 16, a block that is not whole warps of
// at most kMaxThreads threads, and a grid that does not cover n_out.
template <typename T>
cudaError_t run(int K, int threads, int nblocks, long long n_out,
                long long ncols, int tile, const int* starts,
                const int* cols, const T* vals, const T* x, T* y,
                cudaStream_t s) {
  if (tile <= 0 || n_out <= 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || nblocks < 1 ||
      static_cast<long long>(nblocks) * threads < n_out)
    return cudaErrorInvalidValue;
  switch (K) {
    case 4:
      return launch_k<T, 4>(threads, nblocks, n_out, ncols, tile, starts,
                            cols, vals, x, y, s);
    case 8:
      return launch_k<T, 8>(threads, nblocks, n_out, ncols, tile, starts,
                            cols, vals, x, y, s);
    case 12:
      return launch_k<T, 12>(threads, nblocks, n_out, ncols, tile, starts,
                             cols, vals, x, y, s);
    case 16:
      return launch_k<T, 16>(threads, nblocks, n_out, ncols, tile, starts,
                             cols, vals, x, y, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 1 = float64, 2 = bfloat16; K: the column slots (4,
// 8, 12 or 16);
// blocks of `threads` threads, a row each, `nblocks` blocks covering
// n_out rows. cols and vals hold at least n_out * K entries from 16-byte
// boundaries, x ncols, y n_out. Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue, launching nothing, for a geometry it refuses.
extern "C" int amgcl_gather_spmv(int dtype, int K, int threads,
                                 long long n_out, long long ncols, int tile,
                                 const void* starts, const void* cols,
                                 const void* vals, const void* x, void* y,
                                 int nblocks, void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* cl = static_cast<const int*>(cols);
  if (dtype == 0)
    return run<float>(K, threads, nblocks, n_out, ncols, tile, st, cl,
                      static_cast<const float*>(vals),
                      static_cast<const float*>(x), static_cast<float*>(y),
                      s);
  if (dtype == 1)
    return run<double>(K, threads, nblocks, n_out, ncols, tile, st, cl,
                       static_cast<const double*>(vals),
                       static_cast<const double*>(x),
                       static_cast<double*>(y), s);
  if (dtype == 2)
    return run<bf16>(K, threads, nblocks, n_out, ncols, tile, st, cl,
                     static_cast<const bf16*>(vals),
                     static_cast<const bf16*>(x), static_cast<bf16*>(y), s);
  return cudaErrorInvalidValue;
}
