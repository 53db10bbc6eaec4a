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
// Design (simple and correct first): a block of kRows consecutive rows
// stages its contiguous (rows x K) slab of cols and vals in shared memory
// with coalesced 16-byte loads (int4; float4 or double2), then each
// thread sums its row from shared memory in slot order, the K loop
// unrolled, reading x through the read-only path. The shared row stride
// is K + 1 words (K + 1 doubles): K + 1 is odd, so the 32 rows a warp
// reads at one slot fall in distinct banks. The TPU's window DMA into
// VMEM has no use here: the H100 gathers from L2, which holds x (343 KB
// at the 85,623-row FE level in float32). Where B.8's kernel
// (well_block.cu) lets each thread walk its row at stride K, so that a
// warp's loads of one slot touch 32 rows K words apart, this one reads the
// slab once, coalesced. kRows = 128 keeps the float64 slab at K = 16
// (128 x 17 x 12 bytes) under the 48 KB of static shared memory. Offsets
// are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace amgcl_port {
namespace {

constexpr int kRows = 128;           // rows (and threads) per block

// Copy n consecutive elements of a row-major (rows, K) slab from device
// memory into shared memory at row stride K + 1, 16 bytes a load where
// the source is 16-byte aligned (n is a multiple of K, hence of the 4 or
// 2 elements such a load holds).
template <typename E, int K>
__device__ __forceinline__ void stage(const E* __restrict__ g,
                                      E* __restrict__ s, int n) {
  constexpr int V = 16 / sizeof(E);
  static_assert(K % V == 0, "a 16-byte load must not cross a row");
  if ((reinterpret_cast<std::uintptr_t>(g) & 15) == 0) {
    union {
      int4 raw;
      E e[V];
    } u;
    for (int q = threadIdx.x; q < n / V; q += kRows) {
      u.raw = __ldg(reinterpret_cast<const int4*>(g) + q);
      const int e = q * V;
      E* d = s + (e / K) * (K + 1) + e % K;
#pragma unroll
      for (int v = 0; v < V; ++v) d[v] = u.e[v];
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kRows)
      s[(e / K) * (K + 1) + e % K] = g[e];
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kRows)
gather_kernel(long long n_out, long long ncols, int tile,
              const int* __restrict__ starts, const int* __restrict__ cols,
              const T* __restrict__ vals, const T* __restrict__ x,
              T* __restrict__ y) {
  __shared__ int s_cols[kRows * (K + 1)];
  __shared__ T s_vals[kRows * (K + 1)];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long left = n_out - row0;
  const int rows = left < kRows ? static_cast<int>(left) : kRows;
  stage<int, K>(cols + row0 * K, s_cols, rows * K);
  stage<T, K>(vals + row0 * K, s_vals, rows * K);
  __syncthreads();
  if (threadIdx.x >= rows) return;
  const long long i = row0 + threadIdx.x;
  const long long s = starts[i / tile];
  const int* c = s_cols + threadIdx.x * (K + 1);
  const T* v = s_vals + threadIdx.x * (K + 1);
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long j = s + c[k];
    if (j < ncols) acc += v[k] * __ldg(x + j);
  }
  y[i] = acc;
}

template <typename T>
cudaError_t run(int K, long long n_out, long long ncols, int tile,
                const int* starts, const int* cols, const T* vals,
                const T* x, T* y, cudaStream_t s) {
  if (tile <= 0 || n_out <= 0) return cudaErrorInvalidValue;
  const long long blocks = (n_out + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (K) {
    case 4:
      gather_kernel<T, 4><<<grid, kRows, 0, s>>>(n_out, ncols, tile, starts,
                                                  cols, vals, x, y);
      break;
    case 8:
      gather_kernel<T, 8><<<grid, kRows, 0, s>>>(n_out, ncols, tile, starts,
                                                  cols, vals, x, y);
      break;
    case 12:
      gather_kernel<T, 12><<<grid, kRows, 0, s>>>(n_out, ncols, tile,
                                                   starts, cols, vals, x, y);
      break;
    case 16:
      gather_kernel<T, 16><<<grid, kRows, 0, s>>>(n_out, ncols, tile,
                                                   starts, cols, vals, x, y);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 1 = float64; K: the column slots (4, 8, 12 or 16).
// n_out rows are computed, ceil(n_out / 128) blocks of 128 threads; cols
// and vals hold at least n_out * K entries, x ncols, y n_out. Returns the
// cudaError_t of the launch.
extern "C" int amgcl_gather_spmv(int dtype, int K, long long n_out,
                                 long long ncols, int tile,
                                 const void* starts, const void* cols,
                                 const void* vals, const void* x, void* y,
                                 void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* cl = static_cast<const int*>(cols);
  if (dtype == 0)
    return run<float>(K, n_out, ncols, tile, st, cl,
                      static_cast<const float*>(vals),
                      static_cast<const float*>(x), static_cast<float*>(y),
                      s);
  if (dtype == 1)
    return run<double>(K, n_out, ncols, tile, st, cl,
                       static_cast<const double*>(vals),
                       static_cast<const double*>(x),
                       static_cast<double*>(y), s);
  return cudaErrorInvalidValue;
}
