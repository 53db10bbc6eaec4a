// Windowed-ELL sparse kernels for Hopper (sm_90a): SpMV, residual,
// SPAI-0/Jacobi correction and SpMV + dots, each over scalar values (its
// own loop, a sub-warp loading each row) and over b×b block values, b =
// 2, 3, 4 (a sub-warp loading each node, a lane summing each of its b
// rows) — two gather loops, four epilogues each.
//
// Replaces the Pallas TPU kernels of amgcl_tpu/ops/unstructured.py:
//   scalar: windowed_ell_spmv (SPMV), windowed_ell_fused (RESIDUAL,
//   CORRECTION), windowed_ell_spmv_dots (SPMV_DOTS);
//   block: windowed_ell_block_spmv (SPMV), windowed_ell_block_fused
//   (RESIDUAL, CORRECTION), windowed_ell_block_spmv_dots (SPMV_DOTS).
//
// Storage: block row (node) i of tile t = i / tile holds the b×b block
// vals[((i*K + k)*b + r)*b + c] at block column starts[t] + cols[i*K + k];
// x and every vector hold b entries per node, so the block column j reads
// x[j*b .. j*b + b). Scalar values are the case b = 1: the reference's
// (n_tiles, tile, K) layout. Padding slots hold local column 0 and a zero
// block. An empty tile points at the block-column count, so its padding
// may address one past x: every absolute block column is checked against
// ncols and an out-of-range slot contributes nothing (the TPU pads x with
// zeros). Offsets are 64-bit.
//
// What bounds them on the H100: memory traffic. A slot does b²
// multiply-adds (2b² operations) against 4 + b²·sizeof(T) bytes of index
// and values (8 B for a scalar, 40 B for 3×3 float32): 0.25–0.45
// operations per byte in float32, far below the card's balance point, so
// the least time is (format + vectors) bytes / 3.35 TB/s. What the card
// reaches depends on how the format is walked: the rows are K slots long
// (K = 48 at the 85,623-row FE level), so a thread per row puts
// neighbouring threads K·4 bytes apart, and each warp load touches 32
// lines for 128 useful bytes.
//
// Scalar design (`well_scalar_kernel`): G lanes load a row, 32/G rows
// a warp, kBlock/G rows a block. K is a multiple of 4 (the packing rounds
// it up) and the wrapper checks that cols and vals start on 16-byte
// boundaries, so every row starts on one too; at each step lane l of a
// row reads the row's next 4-slot vector as one int4 of columns and one
// float4 (two double2) of values, and gathers the vector's four x
// entries. A warp load thus reads G·16 contiguous bytes of each of its
// 32/G neighbouring rows: whole sectors in place of one word of 32
// lines. The lanes leave their (value, x) pairs in shared memory and the
// row's first lane sums the step's slots in slot order, multiply-adds
// with the thread-per-row kernel's rounding: results are bit-identical to
// it, so every path's iterations and residuals repeat. (Summing each
// lane's slots and then the lanes by a shuffle tree is faster but rounds
// otherwise: it moved G1's IDR(s) from 65 to 70 iterations, outside the
// 60 ± 10% that chip_smoke.py holds it to.) A slot past ncols leaves a
// zero pair, which adds nothing, where the first design skipped it. The
// wrapper (`well_kernels.launch_geometry`) gives a row one lane per
// 4-slot vector, rounded up to a power of two and at most 4 (K 4: 1, 8:
// 2, from 12: 4); at K 48, 2, 8 and 16 lanes were slower than 4, and the
// SpMV beats both a thread per row and torch's CSR product (PERF.md §6;
// NVIDIA H100 80GB HBM3 at 700 W). x is gathered through the read-only
// path, one 4-byte load a slot: it stays in the 50 MB L2 (343 KB at the
// FE level in float32), and the TPU's window DMA into VMEM, which it
// needs because it cannot gather from HBM, would here copy a 45 KB window
// for each block of 64 rows. SPMV_DOTS forms its dots in a second pass
// over y, x and w (`row_dots_kernel`), a thread per row and kBlock rows
// a block, so that the per-block partials, and the dots, are the
// thread-per-row kernel's. The grid is ceil(n_out / (kBlock/G)) blocks;
// the C entry point refuses a grid that does not cover n_out.
//
// Block design (`well_block_kernel`, b = 2, 3, 4). The first design,
// a thread per node walking its K slots with scalar loads, put 13,310
// nodes (B1's L1 and restriction) on 52 blocks for 132 SMs, each thread
// K·b² dependent-address loads deep, and lost to torch's BSR product
// there. Now G = 4 or 8 lanes load a node (`well_kernels.launch_geometry`
// picks G), 256/G nodes a block. A step stages Q slots (16, or 8 or 4
// where 16 would pass 48 KB of shared memory a block; `block_chunk`): the
// lanes read the step's columns as int4 and its Q·b² values, one
// contiguous run per node, as 16-byte vectors (K a multiple of 4 and
// 16-byte aligned cols and vals, which the wrapper checks, put every run
// on a 16-byte boundary), gather the b x entries of each slot, and leave
// all of it in shared memory. Lane r < b of the node then sums row
// component r, acc_r += v[k][r][c]·x[j_k·b + c] over the slots in order
// and c within a slot, skipping a slot past ncols: the thread-per-node
// kernel's multiply-adds in its order, so results are bit-identical to it
// and B1's counts repeat. The correction's lane r takes the node's b
// residuals from its neighbour lanes by shuffles and forms
// S[r][0]·res[0] + … + S[r][b−1]·res[b−1] in c order; SPMV_DOTS forms its
// dots in a second pass a thread per node (`row_dots_kernel`), its b
// components in order, so that the per-block partials are the first
// design's. The grid is ceil(n_out / (256/G)) blocks; the C entry point
// refuses a grid that does not cover n_out.
//
// The scalar kernel's bfloat16 mode (a bfloat16 hierarchy's levels and a
// bfloat16 Krylov loop) loads a 4-slot vector of values as 8 bytes and x
// a bfloat16 at a time, sums a row's products in float in slot order
// (each product of two bfloat16 values exact in float, then __fadd_rn),
// then rounds the sum, f − A x, w ∘ r and x + w ∘ r each to bfloat16
// (bf16.cuh): the TPU kernel's product and float32 `jnp.sum` as the JAX
// package forms them on the CPU, in its interpret mode and on its XLA
// path alike (the product kept in float32), and its bfloat16 epilogue
// (unstructured.py:334-336, :389-395), in the plain version's slot
// order. Its SPMV_DOTS forms y so, then the dots in float32 over
// the bfloat16 y, x and w (row_dots_kernel's order) and rounds each once
// to bfloat16, as the TPU kernel casts its float32 SMEM sums
// (unstructured.py:451-453, :499-501). The block kernel's bfloat16 mode
// keeps the float design's staging and order with the values read as
// 8-byte vectors of four (a 3×3 node's run of K·18 bytes starts on an
// 8-byte boundary, not always on a 16-byte one), stages x and the values
// in bfloat16 and sums in float: lane r adds each exact product of its
// row in slot, then c order, rounds the sum once, and then f − A x, the
// correction's S r (b exact products summed in c order, rounded once)
// and x + S r are each rounded, as the TPU kernel's bfloat16 einsums form
// them (unstructured.py:563-565, :611-621); its SPMV_DOTS takes the dots
// as the scalar mode does. The float32 and float64 modes are those above,
// unchanged.
//
// Both: the correction reads x both as the gather source and as x[i]; the
// output is a separate buffer, so no thread sees another's update. The
// dots sum each node's b components in a fixed order, then go through the
// deterministic two-stage reduction of reduce.cuh, in T as the TPU kernel
// accumulates (float32 for float32, float64 for float64).
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "reduce.cuh"

namespace amgcl_port {
namespace {

enum Mode { SPMV = 0, RESIDUAL = 1, CORRECTION = 2, SPMV_DOTS = 3 };

// One vector of values, as the block kernel loads a node's run: a float4
// or a double2 (16 bytes), and for bfloat16 four values in 8 bytes (a
// 3x3 node's run is a multiple of 8 bytes, not of 16).
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<bf16> { using type = uint2; };
template <typename T>
constexpr int kVecN = sizeof(typename Vec16<T>::type) / sizeof(T);

// The type a thread holds a value of T in: T, and float for bfloat16.
template <typename T> struct Reg { using type = T; };
template <> struct Reg<bf16> { using type = float; };

// Shared memory of a block-kernel block that stages Q slots a step (the
// layout of well_block_kernel), and the Q it takes: 16, or 8 or 4 where
// more would pass the 48 KB of static shared memory a block may have.
template <typename T, int B, int G>
__host__ __device__ constexpr int block_stage_bytes(int Q) {
  return (kBlock / G) *
         ((Q * B * B + kVecN<T> + Q * B + 1) * static_cast<int>(sizeof(T)) +
          (Q + 4) * 4);
}
template <typename T, int B, int G>
__host__ __device__ constexpr int block_chunk() {
  return block_stage_bytes<T, B, G>(16) <= 48 * 1024  ? 16
         : block_stage_bytes<T, B, G>(8) <= 48 * 1024 ? 8
                                                      : 4;
}

template <typename T, int B, int G, int MODE>
__global__ void __launch_bounds__(kBlock)
well_block_kernel(long long n_out, long long ncols, int tile, int K,
                  const int* __restrict__ starts,
                  const int* __restrict__ cols, const T* __restrict__ vals,
                  const T* __restrict__ x, const T* __restrict__ f,
                  const T* __restrict__ w, T* __restrict__ y) {
  using V = typename Vec16<T>::type;
  using R = typename Reg<T>::type;
  constexpr int kNodes = kBlock / G;           // nodes per block
  constexpr int Q = block_chunk<T, B, G>();    // slots per step
  constexpr int kV = kVecN<T>;                 // values per vector
  constexpr int kNV = Q * B * B / kV;          // value vectors per step
  constexpr int kPer = (kNV + G - 1) / G;      // ... per lane
  constexpr int kSlots = (Q + G - 1) / G;      // x gathers per lane
  // per node: a step's values, with one vector of padding so that the
  // nodes of a warp fall on different banks; its x entries; its columns
  constexpr int SV = Q * B * B + kV, SX = Q * B + 1, SC = Q + 4;
  __shared__ __align__(16) T sv[kNodes * SV];
  __shared__ T sx[kNodes * SX];
  __shared__ __align__(16) int sc[kNodes * SC];
  const int sub = threadIdx.x % G;             // the lane's place in its node
  const int node = threadIdx.x / G;
  const long long i = static_cast<long long>(blockIdx.x) * kNodes + node;
  const bool live = i < n_out;
  const long long s = live ? starts[i / tile] : 0;
  const int* ci = cols + (live ? i * K : 0);
  const T* vi = vals + (live ? i * K * (B * B) : 0);
  T* mv = sv + node * SV;
  T* mx = sx + node * SX;
  int* mc = sc + node * SC;
  R acc = R(0);
  // the trip count is K's, the same for every lane of the block
  for (int k0 = 0; k0 < K; k0 += Q) {
    const int nq = min(Q, K - k0);             // a multiple of 4
    const int nv = nq * B * B / kV;
    if (live && sub < nq / 4)
      *reinterpret_cast<int4*>(mc + 4 * sub) =
          __ldg(reinterpret_cast<const int4*>(ci + k0) + sub);
    V buf[kPer];
    const V* vq = reinterpret_cast<const V*>(vi + k0 * (B * B));
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int v = sub + p * G;
      if (live && v < nv) buf[p] = __ldg(vq + v);
    }
    __syncwarp();
    // each lane gathers the b x entries of its slots; a slot past ncols
    // is skipped below and gathers nothing
    T xv[kSlots][B];
#pragma unroll
    for (int p = 0; p < kSlots; ++p) {
      const int k = sub + p * G;
      const long long j = s + ((live && k < nq) ? mc[k] : 0);
#pragma unroll
      for (int c = 0; c < B; ++c)
        xv[p][c] = (live && k < nq && j < ncols) ? __ldg(x + j * B + c)
                                                 : T(0);
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int v = sub + p * G;
      if (live && v < nv) reinterpret_cast<V*>(mv)[v] = buf[p];
    }
#pragma unroll
    for (int p = 0; p < kSlots; ++p) {
      const int k = sub + p * G;
      if (k < nq) {
#pragma unroll
        for (int c = 0; c < B; ++c) mx[k * B + c] = xv[p][c];
      }
    }
    __syncwarp();
    if (live && sub < B) {
      // lane r sums component r of the node's row: slot by slot, then c,
      // the thread-per-node kernel's order and rounding
      for (int k = 0; k < nq; ++k) {
        if (s + mc[k] >= ncols) continue;
        const T* v = mv + k * (B * B) + sub * B;
        const T* xk = mx + k * B;
#pragma unroll
        for (int c = 0; c < B; ++c) {
          // bfloat16: the exact product, the sum in float
          if constexpr (kIsBf16<T>)
            acc = __fadd_rn(acc, __fmul_rn(bf_load(v[c]), bf_load(xk[c])));
          else
            acc += v[c] * xk[c];
        }
      }
    }
    __syncwarp();
  }
  const long long o = i * B + sub;
  if constexpr (kIsBf16<T>) {
    // the row sum rounded to bfloat16 once, then f − A x rounded; the
    // correction's b products of S and the rounded residual exact in
    // float, summed in c order and rounded, then x + S r rounded: the
    // TPU kernel's bfloat16 einsums and epilogue (unstructured.py:
    // 563-565, :611-621) as the JAX package forms them
    const float ax = bf_round(acc);
    if constexpr (MODE == SPMV || MODE == SPMV_DOTS) {
      if (live && sub < B) y[o] = bf_store(ax);
    } else if constexpr (MODE == RESIDUAL) {
      if (live && sub < B) y[o] = bf_store(bf_sub(bf_load(f[o]), ax));
    } else {
      const float r_own =
          (live && sub < B) ? bf_sub(bf_load(f[o]), ax) : 0.0f;
      const int first = (threadIdx.x & 31) - sub;  // the node's lane 0
      float res[B];
#pragma unroll
      for (int c = 0; c < B; ++c)
        res[c] = __shfl_sync(0xffffffffu, r_own, first + c);
      if (live && sub < B) {
        const bf16* S = w + i * (B * B);
        float c_r = __fmul_rn(bf_load(S[sub * B]), res[0]);
#pragma unroll
        for (int c = 1; c < B; ++c)
          c_r = __fadd_rn(c_r, __fmul_rn(bf_load(S[sub * B + c]), res[c]));
        y[o] = bf_store(bf_add(bf_load(x[o]), bf_round(c_r)));
      }
    }
  } else if constexpr (MODE == SPMV || MODE == SPMV_DOTS) {
    if (live && sub < B) y[o] = acc;
  } else if constexpr (MODE == RESIDUAL) {
    if (live && sub < B) y[o] = f[o] - acc;
  } else {
    // x + S_i (f − A x) with the node's b×b scale S_i = w[i]: lane r
    // takes the node's b residuals from its neighbour lanes
    const T r_own = (live && sub < B) ? f[o] - acc : T(0);
    const int first = (threadIdx.x & 31) - sub;  // the node's lane 0
    T res[B];
#pragma unroll
    for (int c = 0; c < B; ++c)
      res[c] = __shfl_sync(0xffffffffu, r_own, first + c);
    if (live && sub < B) {
      const T* S = w + i * (B * B);
      T c_r = S[sub * B] * res[0];
#pragma unroll
      for (int c = 1; c < B; ++c) c_r += S[sub * B + c] * res[c];
      y[o] = x[o] + c_r;
    }
  }
}

// Four consecutive values of a row (16-byte aligned): one float4, or two
// double2, through the read-only path.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load1(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) {
  return bf_load(__ldg(p));
}

template <typename T, int G, int MODE>
__global__ void __launch_bounds__(kBlock)
well_scalar_kernel(long long n_out, long long ncols, int tile, int K,
                   const int* __restrict__ starts,
                   const int* __restrict__ cols, const T* __restrict__ vals,
                   const T* __restrict__ x, const T* __restrict__ f,
                   const T* __restrict__ w, T* __restrict__ y) {
  using S = typename Reg<T>::type;
  constexpr int kRows = kBlock / G;          // rows per block
  // each thread's four (value, x) pairs of the current step
  __shared__ __align__(16) S sv[kBlock * 4];
  __shared__ __align__(16) S sx[kBlock * 4];
  const int sub = threadIdx.x % G;           // the lane's place in its row
  const long long i = static_cast<long long>(blockIdx.x) * kRows +
                      threadIdx.x / G;
  const bool live = i < n_out;
  const long long s = live ? starts[i / tile] : 0;
  const int4* c4 = reinterpret_cast<const int4*>(cols + (live ? i * K : 0));
  const T* v = vals + (live ? i * K : 0);
  const int nq = K >> 2;
  S acc = S(0);
  // the trip count is K's, the same for every lane of the block
  for (int q0 = 0; q0 < nq; q0 += G) {
    const int q = q0 + sub;
    S vv[4] = {S(0), S(0), S(0), S(0)};
    S xv[4] = {S(0), S(0), S(0), S(0)};
    if (live && q < nq) {
      const int4 c = __ldg(c4 + q);
      load4(v + 4 * q, vv);
      const long long j[4] = {s + c.x, s + c.y, s + c.z, s + c.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a slot past ncols leaves a zero pair, whose product adds nothing
        if (j[e] < ncols) xv[e] = load1(x + j[e]);
        else vv[e] = S(0);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sv[threadIdx.x * 4 + e] = vv[e];
      sx[threadIdx.x * 4 + e] = xv[e];
    }
    __syncwarp();
    if (live && sub == 0) {
      // the row's first lane sums the step's slots in slot order
      const int nl = min(G, nq - q0);
      for (int l = 0; l < nl; ++l) {
        const S* pv = sv + (threadIdx.x + l) * 4;
        const S* px = sx + (threadIdx.x + l) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // bfloat16: the exact product, the row sum in float
          if constexpr (kIsBf16<T>)
            acc = __fadd_rn(acc, __fmul_rn(pv[e], px[e]));
          else
            acc += pv[e] * px[e];
        }
      }
    }
    __syncwarp();
  }
  if constexpr (kIsBf16<T>) {
    // the row sum rounded to bfloat16, then each operation of the
    // epilogue rounded, as the TPU kernel's bfloat16 dtype rounds
    if (live && sub == 0) {
      float out = bf_round(acc);
      if constexpr (MODE == RESIDUAL) {
        out = bf_sub(bf_load(f[i]), out);
      } else if constexpr (MODE == CORRECTION) {
        out = bf_add(bf_load(x[i]),
                     bf_mul(bf_load(w[i]), bf_sub(bf_load(f[i]), out)));
      }
      y[i] = bf_store(out);
    }
  } else if (live && sub == 0) {
    if constexpr (MODE == SPMV || MODE == SPMV_DOTS) {
      y[i] = acc;
    } else if constexpr (MODE == RESIDUAL) {
      y[i] = f[i] - acc;
    } else {
      // x + w·(f − A x), rounded as the block kernel's b = 1 case was
      const T res = f[i] - acc;
      const T c_r = w[i] * res;
      y[i] = x[i] + c_r;
    }
  }
}

// The dots of SPMV_DOTS from y = A x, a thread per row (node) and
// kBlock rows a block, as a thread-per-row kernel forms them: a node's b
// components in order, the same per-block partials, so the same dots bit
// for bit.
// In bfloat16 the sums are float32 (the products of bfloat16 values
// exact in it) and the reduction rounds each dot once to bfloat16.
template <typename T, int B>
__global__ void __launch_bounds__(kBlock)
row_dots_kernel(long long n_out, const T* __restrict__ y,
                const T* __restrict__ x, const T* __restrict__ w,
                Acc<T>* __restrict__ partials) {
  using A = Acc<T>;
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  A d0 = A(0), d1 = A(0), d2 = A(0);
  if (i < n_out) {
#pragma unroll
    for (int r = 0; r < B; ++r) {
      const long long o = i * B + r;
      if constexpr (kIsBf16<T>) {
        const float a = bf_load(y[o]);
        d0 = fma_rn(a, a, d0);
        d1 = fma_rn(a, bf_load(x[o]), d1);
        if (w != nullptr) d2 = fma_rn(a, bf_load(w[o]), d2);
      } else {
        const T a = y[o];
        d0 += a * a;
        d1 += a * x[o];
        if (w != nullptr) d2 += a * w[o];
      }
    }
  }
  const A dv[3] = {d0, d1, d2};
  block_reduce_store<A, 3>(dv, partials);
}

// The dots pass and the reduction of SPMV_DOTS, after its product.
template <typename T, int B>
void launch_dots(long long n_out, const T* y, const T* x, const T* w,
                 Acc<T>* partials, T* dots, cudaStream_t s) {
  const int dot_blocks = static_cast<int>((n_out + kBlock - 1) / kBlock);
  row_dots_kernel<T, B><<<dot_blocks, kBlock, 0, s>>>(n_out, y, x, w,
                                                      partials);
  launch_reduce<Acc<T>, T>(partials, dot_blocks, 3, dots, s);
}

template <typename T, int G>
cudaError_t launch_scalar(int mode, long long n_out, long long ncols,
                          int tile, int K, const int* starts,
                          const int* cols, const T* vals, const T* x,
                          const T* f, const T* w, T* y, Acc<T>* partials,
                          T* dots, int nblocks, cudaStream_t s) {
  switch (mode) {
    case SPMV:
      well_scalar_kernel<T, G, SPMV><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y);
      break;
    case RESIDUAL:
      well_scalar_kernel<T, G, RESIDUAL><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y);
      break;
    case CORRECTION:
      well_scalar_kernel<T, G, CORRECTION><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y);
      break;
    case SPMV_DOTS:
      well_scalar_kernel<T, G, SPMV_DOTS><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y);
      launch_dots<T, 1>(n_out, y, x, w, partials, dots, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int B, int G>
cudaError_t launch_block(int mode, long long n_out, long long ncols,
                         int tile, int K, const int* starts, const int* cols,
                         const T* vals, const T* x, const T* f, const T* w,
                         T* y, Acc<T>* partials, T* dots, int nblocks,
                         cudaStream_t s) {
  switch (mode) {
    case SPMV:
      well_block_kernel<T, B, G, SPMV><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y);
      break;
    case RESIDUAL:
      well_block_kernel<T, B, G, RESIDUAL><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y);
      break;
    case CORRECTION:
      well_block_kernel<T, B, G, CORRECTION><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y);
      break;
    case SPMV_DOTS:
      well_block_kernel<T, B, G, SPMV><<<nblocks, kBlock, 0, s>>>(
          n_out, ncols, tile, K, starts, cols, vals, x, f, w, y);
      launch_dots<T, B>(n_out, y, x, w, partials, dots, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int B>
cudaError_t launch(int mode, int lanes, long long n_out, long long ncols,
                   int tile, int K, const int* starts, const int* cols,
                   const T* vals, const T* x, const T* f, const T* w, T* y,
                   Acc<T>* partials, T* dots, int nblocks, cudaStream_t s) {
  switch (lanes) {
    case 4:
      return launch_block<T, B, 4>(mode, n_out, ncols, tile, K, starts,
                                   cols, vals, x, f, w, y, partials, dots,
                                   nblocks, s);
    case 8:
      return launch_block<T, B, 8>(mode, n_out, ncols, tile, K, starts,
                                   cols, vals, x, f, w, y, partials, dots,
                                   nblocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(int mode, int b, int lanes, long long n_out, long long ncols,
                int tile, int K, const int* starts, const int* cols,
                const T* vals, const T* x, const T* f, const T* w, T* y,
                Acc<T>* partials, T* dots, int nblocks, cudaStream_t s) {
  if (tile <= 0 || K <= 0 || lanes <= 0 || kBlock % lanes ||
      static_cast<long long>(nblocks) * (kBlock / lanes) < n_out ||
      K % 4)
    return cudaErrorInvalidValue;
  if (b == 1) {
    switch (lanes) {
      case 1:
        return launch_scalar<T, 1>(mode, n_out, ncols, tile, K, starts, cols,
                                   vals, x, f, w, y, partials, dots, nblocks,
                                   s);
      case 2:
        return launch_scalar<T, 2>(mode, n_out, ncols, tile, K, starts, cols,
                                   vals, x, f, w, y, partials, dots, nblocks,
                                   s);
      case 4:
        return launch_scalar<T, 4>(mode, n_out, ncols, tile, K, starts, cols,
                                   vals, x, f, w, y, partials, dots, nblocks,
                                   s);
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch (b) {
    case 2:
      return launch<T, 2>(mode, lanes, n_out, ncols, tile, K, starts, cols,
                          vals, x, f, w, y, partials, dots, nblocks, s);
    case 3:
      return launch<T, 3>(mode, lanes, n_out, ncols, tile, K, starts, cols,
                          vals, x, f, w, y, partials, dots, nblocks, s);
    case 4:
      return launch<T, 4>(mode, lanes, n_out, ncols, tile, K, starts, cols,
                          vals, x, f, w, y, partials, dots, nblocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 1 = float64, 2 = bfloat16 (its partials
// float32); b: the block size (1, 2, 3 or 4);
// lanes: threads per row, 1, 2 or 4 for b = 1, and per node, 4 or 8 for
// b > 1; K a multiple of 4 and cols and vals on 16-byte boundaries (the
// wrapper checks the bases). n_out nodes are
// computed by nblocks blocks of kBlock threads, kBlock / lanes nodes a
// block; a grid that does not cover n_out is refused. x has ncols·b
// entries, f, y (and w for SPMV_DOTS) n_out·b. `f` is read by RESIDUAL
// and CORRECTION; `w` by CORRECTION as the (n_out, b, b) scale and
// optionally by SPMV_DOTS as the third dot's vector. `partials` holds
// ceil(n_out / kBlock) * 3 values (the dots' partials, a thread per node)
// and `dots` 3 values of the data type (SPMV_DOTS only). Returns the
// cudaError_t of the launches.
extern "C" int amgcl_well_block(int dtype, int mode, int b, int lanes,
                                long long n_out, long long ncols, int tile,
                                int K, const void* starts, const void* cols,
                                const void* vals, const void* x,
                                const void* f, const void* w, void* y,
                                void* partials, void* dots, int nblocks,
                                void* stream) {
  using namespace amgcl_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* cl = static_cast<const int*>(cols);
  if (dtype == 0)
    return run<float>(mode, b, lanes, n_out, ncols, tile, K, st, cl,
                      static_cast<const float*>(vals),
                      static_cast<const float*>(x),
                      static_cast<const float*>(f),
                      static_cast<const float*>(w), static_cast<float*>(y),
                      static_cast<float*>(partials),
                      static_cast<float*>(dots), nblocks, s);
  if (dtype == 1)
    return run<double>(mode, b, lanes, n_out, ncols, tile, K, st, cl,
                       static_cast<const double*>(vals),
                       static_cast<const double*>(x),
                       static_cast<const double*>(f),
                       static_cast<const double*>(w),
                       static_cast<double*>(y),
                       static_cast<double*>(partials),
                       static_cast<double*>(dots), nblocks, s);
  if (dtype == 2)
    return run<bf16>(mode, b, lanes, n_out, ncols, tile, K, st, cl,
                     static_cast<const bf16*>(vals),
                     static_cast<const bf16*>(x),
                     static_cast<const bf16*>(f),
                     static_cast<const bf16*>(w), static_cast<bf16*>(y),
                     static_cast<float*>(partials),
                     static_cast<bf16*>(dots), nblocks, s);
  return cudaErrorInvalidValue;
}
