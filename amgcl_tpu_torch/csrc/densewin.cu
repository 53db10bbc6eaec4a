// Dense-window kernels for Hopper (sm_90a): SpMV, residual and the
// SPAI-0/Jacobi correction over dense row-tile blocks — one gather-free
// loop, three epilogues.
//
// Replaces the Pallas TPU kernels of amgcl_tpu/ops/densewin.py:
//   dense_window_spmv (SPMV) and dense_window_fused (RESIDUAL,
//   CORRECTION).
//
// Storage: row r of tile t = r / 64 holds the dense window slice
// blocks[r*win + j] = A[r, starts[t] + j], j < win, with starts[t] a
// multiple of 1,024; entries outside the matrix (rows >= n_out of the
// last tile, columns >= ncols) are zero.
//
// What bounds it on the H100: memory traffic. Every stored entry is one
// multiply-add (2 operations) against sizeof(T) bytes, 0.5 operations per
// byte in float32, far below the card's balance point, so the least time
// is (blocks + x + vectors) bytes / 3.35 TB/s. The blocks are mostly
// zeros (3.86 GB for the 2.37M nonzeros of the 85,623-row FE level under
// RCM): the format trades device memory for the TPU's slow gathers, a
// trade this card, which gathers from L2, does not need.
//
// What held the first design (a warp per row, x read with a scalar
// __ldg behind a column test for every entry) below the blocks' stream:
// per 16 bytes of blocks a lane issued one vector load, four scalar x
// loads and four compares, and the tile's x window (45 KB at D2's L0)
// was reread from L1/L2 by each of the tile's 64 rows — as many bytes
// again as the blocks, from eight resident windows that L1 cannot hold.
//
// Design: one block of eight warps per 64-row tile, warp w owning rows
// w, w + 8, ..., w + 56 and their eight row sums (registers, across the
// chunks). The tile's x window is copied into shared memory once, as the
// TPU copies it into VMEM, in chunks of `chunk` columns (a multiple of
// 128, chosen by the wrapper: `densewin_kernels.launch_geometry`),
// double-buffered with cp.async so that the copy of chunk c + 1 overlaps
// the products of chunk c; columns at or past ncols are zero-filled by
// the copy, as the TPU pads x with zeros, so no entry is tested. Within a
// chunk the warp walks its rows one after another, each lane reading a
// 16-byte vector of the row from device memory (a warp: 512 contiguous,
// aligned bytes; rows start on 16-byte boundaries, the wrapper checks
// win and the base) and the vector of x at the same columns from shared
// memory, four steps unrolled so that four loads are in flight a lane.
// At D2's L0 this brings the SpMV level with torch.bmm over pre-gathered
// windows (PERF.md §6; NVIDIA H100 80GB HBM3 at 700 W). Variants tried
// on the card and dropped: only removing the column test (slower), eight
// rows a step with x read once for all eight (no faster, and it spills
// in float64 at 64 registers), streaming loads (slower), chunks of 512 to
// 4,096 columns (the same), fewer than four blocks an SM (slower). 2,048
// float32 or 1,024 float64 columns a chunk keep the two buffers at 16 KB,
// under the 48 KB of default dynamic shared memory, with 64 registers at
// four blocks an SM.
//
// Sum order: a lane takes the vectors lane, lane + 32, ... of each row,
// in column order across the chunks (chunk / vector width is a multiple
// of 32), and a fixed xor-shuffle tree (reduce.cuh) sums the warp: the
// first design's order, so results are bit-identical to it (a zero-filled
// column adds b·0 = ±0 to a sum that started at +0, which leaves it
// unchanged where the first design skipped the column). Rows >= n_out of
// the last tile are summed (their entries are zero) and not written.
// Offsets are 64-bit: the blocks of the FE level hold 964,558,848
// entries, whose byte offsets pass 2^32.
//
// The bfloat16 mode (a bfloat16 hierarchy in the dense-window format):
// the blocks read as 16-byte vectors of eight values, the x window
// staged in bfloat16 (2,048-4,096 columns a chunk, a multiple of 256 so
// that a lane keeps the vectors lane, lane + 32, ... across chunks), each
// product of two bfloat16 values exact in float, the lane and warp sums
// in float in the order above, the row sum rounded once to bfloat16,
// then f − A x, w ∘ r and x + w ∘ r each rounded: the TPU kernel's
// bfloat16 product and `jnp.sum` (densewin.py:231-233, :270-277) as the
// JAX package forms them on the CPU, in interpret mode and on its XLA
// path alike (the product kept in float32), and its bfloat16 epilogue.
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "reduce.cuh"

namespace amgcl_port {
namespace {

enum Mode { SPMV = 0, RESIDUAL = 1, CORRECTION = 2 };

constexpr int kTile = 64;                    // rows per tile (and block)
constexpr int kWarps = kBlock / 32;          // 8
constexpr int kRowsPerWarp = kTile / kWarps; // 8
static_assert(kTile % kWarps == 0, "a warp owns whole rows");

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
// eight bfloat16 values, each widened to float (exact)
template <>
struct Vec16<bf16> {
  using type = uint4;
  static constexpr int N = 8;
  __device__ static float get(const uint4& v, int k) {
    const unsigned u = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
    return __uint_as_float((k & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};

// Copy `len` entries of x from column c0 on into shared memory, one entry
// a thread a step; entries at or past ncols are zero-filled (src-size 0).
// bfloat16 entries (2 bytes, under cp.async's least size of 4) are loaded
// and stored; a group is committed all the same.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ x,
                                      long long c0, int len,
                                      long long ncols) {
  if constexpr (kIsBf16<T>) {
    for (int e = threadIdx.x; e < len; e += kBlock)
      dst[e] = c0 + e < ncols ? __ldg(x + c0 + e) : T(0);
  } else {
    for (int e = threadIdx.x; e < len; e += kBlock) {
      const long long j = c0 + e;
      const bool in = j < ncols;
      const unsigned d =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + e));
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                   ::"r"(d), "l"(in ? x + j : x), "n"(sizeof(T)),
                   "r"(in ? static_cast<int>(sizeof(T)) : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kBlock, 4)
densewin_kernel(long long n_out, long long ncols, int win, int chunk,
                const int* __restrict__ starts, const T* __restrict__ blocks,
                const T* __restrict__ x, const T* __restrict__ f,
                const T* __restrict__ w, T* __restrict__ y) {
  using V = typename Vec16<T>::type;
  constexpr int N = Vec16<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);        // two buffers of `chunk`
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t = blockIdx.x;
  const long long s = starts[t];
  const long long row0 = t * kTile + warp;   // rows row0 + 8 r
  const T* b0 = blocks + row0 * win;
  const long long rstride = static_cast<long long>(kWarps) * win;
  Acc<T> acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = Acc<T>(0);
  const int nchunks = (win + chunk - 1) / chunk;
  stage(xs, x, s, min(chunk, win), ncols);
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * chunk;
    if (c + 1 < nchunks) {
      stage(xs + ((c + 1) & 1) * chunk, x, s + c0 + chunk,
            min(chunk, win - c0 - chunk), ncols);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);   // an empty group
    }
    // this thread's copies of chunk c are done; then everyone's are
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const V* xc = reinterpret_cast<const V*>(xs + (c & 1) * chunk);
    const int nv = min(chunk, win - c0) / N;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const V* br = reinterpret_cast<const V*>(b0 + r * rstride + c0);
#pragma unroll 4
      for (int v = lane; v < nv; v += 32) {
        const V bv = __ldg(br + v);
        const V xv = xc[v];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          // bfloat16: the exact product, the sum in float
          if constexpr (kIsBf16<T>)
            acc[r] = __fadd_rn(acc[r], __fmul_rn(Vec16<T>::get(bv, k),
                                                 Vec16<T>::get(xv, k)));
          else
            acc[r] += Vec16<T>::get(bv, k) * Vec16<T>::get(xv, k);
        }
      }
    }
    // the buffer read here is refilled at step c + 1
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const Acc<T> a = warp_sum(acc[r]);
    const long long row = row0 + r * kWarps;
    if constexpr (kIsBf16<T>) {
      // the row sum rounded once, then each operation of the epilogue
      if (lane == 0 && row < n_out) {
        float out = bf_round(a);
        if constexpr (MODE == RESIDUAL) {
          out = bf_sub(bf_load(f[row]), out);
        } else if constexpr (MODE == CORRECTION) {
          out = bf_add(bf_load(x[row]),
                       bf_mul(bf_load(w[row]), bf_sub(bf_load(f[row]), out)));
        }
        y[row] = bf_store(out);
      }
    } else if (lane == 0 && row < n_out) {
      if constexpr (MODE == SPMV) {
        y[row] = a;
      } else if constexpr (MODE == RESIDUAL) {
        y[row] = f[row] - a;
      } else {
        y[row] = x[row] + w[row] * (f[row] - a);
      }
    }
  }
}

template <typename T, int MODE>
cudaError_t launch(long long n_out, long long ncols, int n_tiles, int win,
                   int chunk, const int* starts, const T* blocks, const T* x,
                   const T* f, const T* w, T* y, cudaStream_t s) {
  const int smem = 2 * chunk * static_cast<int>(sizeof(T));
  densewin_kernel<T, MODE><<<n_tiles, kBlock, smem, s>>>(
      n_out, ncols, win, chunk, starts, blocks, x, f, w, y);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int mode, long long n_out, long long ncols, int n_tiles,
                int tile, int win, int chunk, const int* starts,
                const T* blocks, const T* x, const T* f, const T* w, T* y,
                cudaStream_t s) {
  // the two chunk buffers stay within the default 48 KB of dynamic
  // shared memory
  if (n_tiles <= 0 || tile != kTile || win <= 0 || win % Vec16<T>::N ||
      chunk <= 0 || chunk % 128 || chunk % (32 * Vec16<T>::N) ||
      2 * static_cast<long long>(chunk) * sizeof(T) > 48 * 1024 ||
      static_cast<long long>(n_tiles) * kTile < n_out)
    return cudaErrorInvalidValue;
  switch (mode) {
    case SPMV:
      return launch<T, SPMV>(n_out, ncols, n_tiles, win, chunk, starts,
                             blocks, x, f, w, y, s);
    case RESIDUAL:
      return launch<T, RESIDUAL>(n_out, ncols, n_tiles, win, chunk, starts,
                                 blocks, x, f, w, y, s);
    case CORRECTION:
      return launch<T, CORRECTION>(n_out, ncols, n_tiles, win, chunk,
                                   starts, blocks, x, f, w, y, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 1 = float64, 2 = bfloat16. One thread block per
// tile of 64 rows (`tile` must be 64), 2 · chunk · sizeof(T) bytes of
// dynamic shared memory, at most 48 KB (chunk a multiple of 128 columns,
// and of 256 in bfloat16: 32 vectors of 8); `blocks` holds
// n_tiles * 64 * win values starting on a 16-byte boundary, `starts`
// n_tiles ints; x has ncols entries, f, w and y n_out. `f` is read by
// RESIDUAL and CORRECTION, `w` by CORRECTION. Returns the cudaError_t of
// the launch.
extern "C" int amgcl_densewin(int dtype, int mode, long long n_out,
                              long long ncols, int n_tiles, int tile,
                              int win, int chunk, const void* starts,
                              const void* blocks, const void* x,
                              const void* f, const void* w, void* y,
                              void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  if (dtype == 0)
    return run<float>(mode, n_out, ncols, n_tiles, tile, win, chunk, st,
                      static_cast<const float*>(blocks),
                      static_cast<const float*>(x),
                      static_cast<const float*>(f),
                      static_cast<const float*>(w), static_cast<float*>(y),
                      s);
  if (dtype == 1)
    return run<double>(mode, n_out, ncols, n_tiles, tile, win, chunk, st,
                       static_cast<const double*>(blocks),
                       static_cast<const double*>(x),
                       static_cast<const double*>(f),
                       static_cast<const double*>(w),
                       static_cast<double*>(y), s);
  if (dtype == 2)
    return run<bf16>(mode, n_out, ncols, n_tiles, tile, win, chunk, st,
                     static_cast<const bf16*>(blocks),
                     static_cast<const bf16*>(x),
                     static_cast<const bf16*>(f),
                     static_cast<const bf16*>(w), static_cast<bf16*>(y), s);
  return cudaErrorInvalidValue;
}
