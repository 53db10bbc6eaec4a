// Dense-window kernels for Hopper (sm_90a): SpMV, residual and the
// SPAI-0/Jacobi correction over dense row-tile blocks — one gather-free
// loop, three epilogues.
//
// Replaces the Pallas TPU kernels of amgcl_tpu/ops/densewin.py:
//   dense_window_spmv (SPMV) and dense_window_fused (RESIDUAL,
//   CORRECTION).
//
// Storage: row r of tile t = r / tile holds the dense window slice
// blocks[r*win + j] = A[r, starts[t] + j], j < win, with starts[t] a
// multiple of 1,024 and win a multiple of 1,024; entries outside the
// matrix (rows >= n_out of the last tile, columns >= ncols) are zero.
//
// What bounds it on the H100: memory traffic. Every stored entry is one
// multiply-add (2 operations) against sizeof(T) bytes, 0.5 operations per
// byte in float32, far below the card's balance point, so the least time
// is (blocks + x + vectors) bytes / 3.35 TB/s. The blocks are mostly
// zeros (3.86 GB for the 2.37M nonzeros of the 85,623-row FE level under
// RCM): the format trades device memory for the TPU's slow gathers, a
// trade this card, which gathers from L2, does not need.
//
// Design (simple and correct first): one thread block per tile, eight
// warps, warp w taking rows w, w + 8, ...; each lane walks its row in
// 16-byte vectors (float4, double2) at vector index lane, lane + 32, ...,
// so a warp reads 512 contiguous, aligned bytes a step (rows start on
// 16-byte boundaries: win is a multiple of 1,024 and the wrapper checks
// the base). x is read through the read-only path at starts[t] + j; a
// tile's rows share one window, so after its first row x comes from L1
// or L2. The TPU's window DMA into VMEM and its scalar prefetch of the
// starts have no use here: a block reads its own start, and nothing is
// staged in shared memory. A window may reach past x: columns >= ncols
// are skipped (the TPU pads x with win zeros; the block entries there are
// zero). Rows >= n_out are not written. Each lane sums its products in
// column order, then a fixed xor-shuffle tree (reduce.cuh) sums the warp,
// so results repeat bit for bit. Offsets are 64-bit: the blocks of the FE
// level hold 964,558,848 entries, whose byte offsets pass 2^32.
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace amgcl_port {
namespace {

enum Mode { SPMV = 0, RESIDUAL = 1, CORRECTION = 2 };

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int N = 4;
  __device__ static float get(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int N = 2;
  __device__ static double get(const double2& v, int k) {
    return k == 0 ? v.x : v.y;
  }
};

template <typename T, int MODE>
__global__ void __launch_bounds__(kBlock)
densewin_kernel(long long n_out, long long ncols, int tile, int win,
                const int* __restrict__ starts, const T* __restrict__ blocks,
                const T* __restrict__ x, const T* __restrict__ f,
                const T* __restrict__ w, T* __restrict__ y) {
  using V = typename Vec16<T>::type;
  constexpr int N = Vec16<T>::N;
  constexpr int kWarps = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const long long t = blockIdx.x;
  const long long s = starts[t];
  // columns of the window that lie inside x
  const long long inside = ncols - s;
  const int nvec = win / N;
  for (int rr = threadIdx.x >> 5; rr < tile; rr += kWarps) {
    const long long row = t * tile + rr;
    if (row >= n_out) break;
    const V* b = reinterpret_cast<const V*>(blocks + row * win);
    T acc = T(0);
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      const V bv = __ldg(b + v);
      const long long j = static_cast<long long>(v) * N;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (j + k < inside) acc += Vec16<T>::get(bv, k) * __ldg(x + s + j + k);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      if constexpr (MODE == SPMV) {
        y[row] = acc;
      } else if constexpr (MODE == RESIDUAL) {
        y[row] = f[row] - acc;
      } else {
        y[row] = x[row] + w[row] * (f[row] - acc);
      }
    }
  }
}

template <typename T>
cudaError_t run(int mode, long long n_out, long long ncols, int n_tiles,
                int tile, int win, const int* starts, const T* blocks,
                const T* x, const T* f, const T* w, T* y, cudaStream_t s) {
  if (n_tiles <= 0 || tile <= 0 || win <= 0 || win % Vec16<T>::N)
    return cudaErrorInvalidValue;
  switch (mode) {
    case SPMV:
      densewin_kernel<T, SPMV><<<n_tiles, kBlock, 0, s>>>(
          n_out, ncols, tile, win, starts, blocks, x, f, w, y);
      break;
    case RESIDUAL:
      densewin_kernel<T, RESIDUAL><<<n_tiles, kBlock, 0, s>>>(
          n_out, ncols, tile, win, starts, blocks, x, f, w, y);
      break;
    case CORRECTION:
      densewin_kernel<T, CORRECTION><<<n_tiles, kBlock, 0, s>>>(
          n_out, ncols, tile, win, starts, blocks, x, f, w, y);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 1 = float64. One thread block per tile of `tile`
// rows; `blocks` holds n_tiles * tile * win values starting on a 16-byte
// boundary, `starts` n_tiles ints; x has ncols entries, f, w and y n_out.
// `f` is read by RESIDUAL and CORRECTION, `w` by CORRECTION. Returns the
// cudaError_t of the launch.
extern "C" int amgcl_densewin(int dtype, int mode, long long n_out,
                              long long ncols, int n_tiles, int tile,
                              int win, const void* starts, const void* blocks,
                              const void* x, const void* f, const void* w,
                              void* y, void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  if (dtype == 0)
    return run<float>(mode, n_out, ncols, n_tiles, tile, win, st,
                      static_cast<const float*>(blocks),
                      static_cast<const float*>(x),
                      static_cast<const float*>(f),
                      static_cast<const float*>(w), static_cast<float*>(y),
                      s);
  if (dtype == 1)
    return run<double>(mode, n_out, ncols, n_tiles, tile, win, st,
                       static_cast<const double*>(blocks),
                       static_cast<const double*>(x),
                       static_cast<const double*>(f),
                       static_cast<const double*>(w),
                       static_cast<double*>(y), s);
  return cudaErrorInvalidValue;
}
