// Fused V-cycle legs for Hopper (sm_90a): the whole down leg and the
// whole up leg of a grid-aligned stencil level, each in one kernel.
//
// Replaces the Pallas TPU kernels of amgcl_tpu/ops/pallas_vcycle.py:
//   down_kernel  <- fused_down_sweep (base, zero_guess and framed modes):
//                   rc = Tᵀ (r − Mᵀ r) with r = f − A u; in zero_guess mode
//                   u = w ∘ f is formed first and written out as well.
//   up_kernel    <- fused_up_sweep (base and framed modes):
//                   out = u' + w ∘ (f − A u') with u' = u + T uc − M (T uc).
//
// T is the piecewise-constant tentative prolongation over 2×2×2 grid
// aggregates: fine point (z, y, x) belongs to coarse cell
// (z/2, y/2, x/2); fine points past the grid's end contribute nothing.
// A, M and Mᵀ are DIA operators: data[k * n + i] = Op[i, i + off[k]].
//
// What bounds them on the H100: memory traffic. Each leg reads the level's
// diagonals and a few vectors once at the least (down: nA + nM + 2 rows of
// n floats in, n/8 out; up: nA + nM + 3 rows in plus n/8, one row out) and
// does a few multiply-adds per byte, far below the card's float32 balance
// point, so the least time is bytes / 3.35 TB/s.
//
// Design. The TPU kernel DMAs a window of 2s + 2H floats per operand
// into VMEM for each coarse plane (s = one fine plane); at the 128³ fine
// level that is 384 KB per operand, more than a block's 227 KB of shared
// memory for all of them together. So each leg takes a tile of tz fine
// planes × ty rows × all f0 a block (DownTile / UpTile, chosen by
// vcycle_kernels.down_tile / up_tile) and stages what the tile's sums
// read in boxes of grid rows in shared memory (dynamic, above 48 KB by
// the attribute), each intermediate formed once a box row:
//   down: box U holds u (w ∘ f in zero-guess mode) at every row that the
//         A neighbours of R's rows reach (faster at every shape measured
//         than reading u through L1); box R holds r = f − A u at
//         every row that the tile's Mᵀ neighbours reach; each tile row
//         then forms t = r − Mᵀ r into U's space, and one thread per
//         coarse cell sums its 8 children in a fixed order: no float
//         atomics, so the same inputs give bit-identical results on
//         every run. The first design recomputed r at a row and at each
//         of its nM neighbours, (1 + nM)·nA reads of A a row; now A is
//         read (R rows / tile rows)·nA times a row, less in a cluster of
//         tiles (the planner takes pairs where they pay), where each row
//         of R is formed by one block and read by the others through
//         distributed shared memory.
//   up:   box T holds T uc at every row that the M neighbours of U's
//         rows reach; box U holds u' = u + T uc − M (T uc) at every row
//         that the tile's A neighbours reach; then each thread forms
//         out = u' + w ∘ (f − A u') for its tile rows. The first design
//         recomputed u' at a row and at each of its nA neighbours,
//         (1 + nA)·nM reads of M a row.
// A box is its inner region plus a halo of planes and rows wide enough
// for each offset's nearest (dz, dy, dx) split and the carry an x step
// past the grid row adds; its rows run on past a plane's end into the
// next, so a neighbour whose row wraps is in the box, and every neighbour
// lies at a fixed distance per offset. A warp walks a grid row, a lane a
// point; each thread issues kBatch loads of an operator before it adds
// them, since a 1,024-thread block keeps too few loads in flight
// otherwise, and a row whose every neighbour lies in the frame skips the
// per-point frame test. The arithmetic is the first designs': each sum in
// offset order from the same first term, each skipping a neighbour
// outside the frame (never a multiply by a staged 0: −0 − (+0) is +0, and
// an Inf in a diagonal would give a NaN), the zero-guess iterate the same
// rounded product u·f, the cell sum (pz, py) in order, px = 0 then 1,
// with + 0 for a child past the grid's end; so results are bit-identical
// to them. The C entries refuse a tile whose boxes do not hold the
// offsets' reach.
// Every index is guarded: r, u and T uc are 0 outside the frame below
// ([0, n) in the base mode), as the TPU kernel's zero-padded frames make
// them, and a flat offset that runs off one grid row into the next reads
// that row (its DIA entry is 0 on a stencil).
//
// Framed mode (a z-slab of a grid sharded over a mesh, framed by real rows
// of its neighbour slabs; pallas_vcycle.py:187-194 and :477-483). Down:
// A, Mᵀ, f and u (or w) are frames of L rows in which tile row i is frame
// row H + i, H any count of rows (a frame edge may cut a grid row, so a
// box row is tested point by point unless it lies wholly inside). Up: M,
// u and T uc live on a frame of fz fine planes in which tile plane z is
// frame plane z + zoff (zoff even, uc carrying zoff / 2 coarse planes on
// each side); A, f, w and the output are the tile's own. Every index
// guard below is "inside the frame", so r, u' and T uc read 0 only
// outside it. The base mode is the framed mode on a zero frame (H = 0,
// L = n; zoff = 0, fz = f2): the same operations in the same order, so
// its results are those of the kernels before the framed mode. It runs
// its own instantiation (FRAMED false), whose frame is known at compile
// time: with the frame as runtime arguments the base up leg took 16%
// longer at the 128³ main path's L0 on an H100 (0.2942 against 0.2541 ms;
// NVIDIA H100 80GB HBM3 at 700 W).
//
// bfloat16 mode (base and zero-guess down legs, base up leg; a bfloat16
// hierarchy's levels). The same tiles, boxes and order, in kernels
// templated over the element type: the boxes stage bfloat16, half the
// bytes of float32's (vcycle_kernels.down_tile / up_tile plan them in
// bytes), and each operation rounds to bfloat16 where the TPU kernel's
// bfloat16 dtype rounds (bf16.cuh): the stencil sums run from 0 in offset
// order, each product and sum rounded (pallas_vcycle.py:238, :468), and
// then r = f − Σ a·u, t = r − Σ mᵀ·r, u' = (u + T uc) − Σ m·T uc and
// u' + w ∘ (f − Σ a·u'), each step rounded; the restriction adds a cell's
// z pairs in bfloat16 and then its y pairs and x pair in float, as the
// TPU kernel's float32 pair-sum dots do (:250-263), and rounds once. The
// plain versions (ops/vcycle_kernels.py) compute the same operations in
// the same order, so the two agree bit for bit. The float32 modes are
// those described above, unchanged.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bf16.cuh"

namespace amgcl_port {
namespace {

constexpr int kMaxDiag = 512;
// threads per block: of 256, 512 and 1,024, 1,024 was the fastest at
// every level of the up leg measured on an H100 (PERF.md §6)
constexpr int kThreads = 1024;
// loads a thread issues together: of 8, 16 and 32, 16 was the fastest for
// the up leg on an H100, and 11 then beat 16 and 17 for the down leg at
// every shape measured and for the up leg at the L1 shapes (level at L0):
// the main path's 7 and 33 diagonals take one and three batches, where 16
// took a third batch for one load at L1 (PERF.md §6)
constexpr int kBatch = 11;
// the dynamic shared memory a block may take beside its static arrays
constexpr int kMaxBox = 232448 - 4 * kMaxDiag * 4;
constexpr int kMaxDevices = 16;

struct Grid {
  int f2, f1, f0;                 // fine dims (z, y, x), C order
  int c1, c0;                     // coarse y and x extents
  int n;                          // f2 * f1 * f0
};

// Flat offset o as dz·s + dy·f0 + dx with each part rounded to the
// nearest (dx in [−f0/2, f0/2), then dy likewise within a plane): the
// decomposition by which the boxes are sized and indexed.
// A truncating split would write a step of (−1, 0, +1) as
// (0, 1 − f1, 1 − f0), asking for a halo of nearly a plane.
__host__ __device__ inline int floor_div(int a, int b) {       // b > 0
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}
__host__ __device__ inline void split_nearest(int o, int s, int f0, int* dz,
                                              int* dy, int* dx) {
  *dz = floor_div(o + s / 2, s);
  const int rem = o - *dz * s;
  *dy = floor_div(rem + f0 / 2, f0);
  *dx = rem - *dy * f0;
}

// A box's halo around its inner rows: (planes below, planes above, rows
// before, rows after). Box rows are counted in extended coordinates: box
// row (bz, by) holds the grid row at plane bz0 + bz and row by0 + by,
// where a row index past [0, f1) is the row that many rows on in the
// next (or previous) plane, as a flat offset's carry gives it; so a
// neighbour at flat offset o lies at a fixed distance in the box for
// every row, wrapped rows included.
struct Halo {
  int z_lo, z_hi, y_lo, y_hi;
};

// The down leg's tile: tz fine planes × ty fine rows × all f0, tz and ty
// even and the tile at an even plane and row, so that every coarse cell
// of the tile has its children in it. Box R holds r at the rows the
// tile's Mᵀ neighbours read (the tile with Mᵀ's halo m), box U u (or
// w ∘ f) at the rows the R rows' A neighbours read (R with A's halo a).
// In a cluster of cz × cy blocks (tiles side by side, a block a tile),
// each block forms r only at the rows of R that it owns: its tile, and
// the part of the cluster's outer halo beside it (a row (Z, Y) of the
// cluster's box belongs to the tile (clamp(Z / tz), clamp(Y / ty))); it
// reads the rest of its box R from their owners' shared memory.
struct DownTile {
  int tz, ty;
  Halo m, a;
  int cz, cy;                       // the cluster's tiles (1 × 1: none)
  int a_min, a_max, m_min, m_max;   // the least and greatest offsets and 0
};

// The up leg's tile: tz fine planes × ty fine rows × all f0. Box U holds
// u' at the rows the tile's A neighbours read (the tile with A's halo a),
// box T holds T uc at the rows the U rows' M neighbours read (U with M's
// halo m).
struct UpTile {
  int tz, ty;
  Halo a, m;
  int a_min, a_max, m_min, m_max;   // the least and greatest offsets
};

// Whether a halo holds every row that offset `o` reaches from a box: the
// offset's plane step within the plane halo, and its row step, with the
// carry that x + dx past the grid row adds, within the row halo.
__host__ __device__ inline bool halo_holds(const Halo& h, int o, int s,
                                           int f0) {
  int dz, dy, dx;
  split_nearest(o, s, f0, &dz, &dy, &dx);
  return dz >= -h.z_lo && dz <= h.z_hi && dy - (dx < 0) >= -h.y_lo &&
         dy + (dx > 0) <= h.y_hi;
}

// Whether the halo holds each of the n offsets; widens [*lo, *hi] to
// them.
inline bool halo_holds_all(const Halo& h, const int* off, int n, int s,
                           int f0, int* lo, int* hi) {
  bool holds = h.z_lo >= 0 && h.z_hi >= 0 && h.y_lo >= 0 && h.y_hi >= 0;
  for (int k = 0; k < n; ++k) {
    holds = holds && halo_holds(h, off[k], s, f0);
    if (off[k] < *lo) *lo = off[k];
    if (off[k] > *hi) *hi = off[k];
  }
  return holds;
}

// The distance in a box of `rows` rows a plane to the row at offset o.
__device__ __forceinline__ int box_step(int o, int s, int f0, int rows) {
  int dz, dy, dx;
  split_nearest(o, s, f0, &dz, &dy, &dx);
  return (dz * rows + dy) * f0 + dx;
}

// Whether diagonal k < n exists and its neighbour of frame row q lies
// inside the frame of L rows, as the first designs' tests found it.
__device__ __forceinline__ bool in_frame(int k, int n, int q,
                                         const int* off, size_t L) {
  if (k >= n) return false;
  const int r = q + off[k];
  return r >= 0 && static_cast<size_t>(r) < L;
}

// One DIA row sum at frame row q: acc −= data[k][i] · nb(k) over the n
// diagonals in order, skipping a neighbour outside the frame of L rows;
// a diagonal holds ld rows of data, and nb(k) is the neighbour's value
// in a box. Each batch issues its kBatch loads
// of data together, then adds them in order. CHECK false: the caller
// found every neighbour of the row inside the frame, so no point is
// tested.
template <bool CHECK, class Nb>
__device__ __forceinline__ float row_sum(float acc, int q, int i,
                                         size_t ld, int n, const int* off,
                                         size_t L,
                                         const float* __restrict__ data,
                                         Nb nb) {
  for (int k0 = 0; k0 < n; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      v[b] = (CHECK ? in_frame(k0 + b, n, q, off, L) : k0 + b < n)
                 ? data[(k0 + b) * ld + i] : 0.f;
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (CHECK ? in_frame(k0 + b, n, q, off, L) : k0 + b < n)
        acc -= v[b] * nb(k0 + b);
  }
  return acc;
}

// The bfloat16 row sum: Σ data[k][i] · nb(k) from 0 over the n diagonals
// in order, each product and each sum rounded to bfloat16 (bf16.cuh), as
// the TPU kernel's bfloat16 accumulator sums a stencil
// (pallas_vcycle.py:238, :468); loads and frame tests as row_sum's.
template <bool CHECK, class Nb>
__device__ __forceinline__ float row_dot_bf16(int q, int i, size_t ld,
                                              int n, const int* off,
                                              size_t L,
                                              const bf16* __restrict__ data,
                                              Nb nb) {
  float acc = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      v[b] = (CHECK ? in_frame(k0 + b, n, q, off, L) : k0 + b < n)
                 ? bf_load(data[(k0 + b) * ld + i]) : 0.f;
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (CHECK ? in_frame(k0 + b, n, q, off, L) : k0 + b < n)
        acc = bf_add(acc, bf_mul(v[b], nb(k0 + b)));
  }
  return acc;
}

// A staged value of T as a float (a bfloat16 widened), and a float as T.
__device__ __forceinline__ float as_f(float v) { return v; }
__device__ __forceinline__ float as_f(bf16 v) { return bf_load(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (kIsBf16<T>) return bf_store(v); else return v;
}

// h, len: the frame (tile row i is frame row H + i of L); a, mt, f and u
// are frames, u_out and rc the tile's own. Without FRAMED the frame is the
// tile (H = 0, L = n), known at compile time. Cluster c of cz × cy blocks
// takes the tiles (c / nsy, c % nsy) of ceil(f1 / (cy·ty)) cluster tiles a
// band of cz·tz planes; its block of rank iz·cy + iy the tile (iz, iy).
template <typename T, bool ZERO, bool FRAMED>
__global__ void __launch_bounds__(kThreads, 1)
down_kernel(Grid g, int h, int len, DownTile t, int na, int nm,
            const int* __restrict__ a_off, const T* __restrict__ a,
            const int* __restrict__ m_off, const T* __restrict__ mt,
            const T* __restrict__ f, const T* __restrict__ u,
            T* __restrict__ u_out, T* __restrict__ rc) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  T* s_box = reinterpret_cast<T*>(s_dyn);
  __shared__ int s_a[kMaxDiag], s_ad[kMaxDiag];   // A: offset, U distance
  __shared__ int s_m[kMaxDiag], s_md[kMaxDiag];   // Mᵀ: offset, R distance
  const int s = g.f1 * g.f0;
  const int RY = t.ty + t.m.y_lo + t.m.y_hi;      // R: RZ planes × RY rows
  const int RZ = t.tz + t.m.z_lo + t.m.z_hi;
  // block (iz, iy) of its cluster owns R's rows [oz0, oz1) × [oy0, oy1)
  const int nc = t.cz * t.cy, rank = blockIdx.x % nc;
  const int iz = rank / t.cy, iy = rank % t.cy;
  const int oz0 = iz == 0 ? 0 : t.m.z_lo;
  const int oz1 = iz == t.cz - 1 ? RZ : t.m.z_lo + t.tz;
  const int oy0 = iy == 0 ? 0 : t.m.y_lo;
  const int oy1 = iy == t.cy - 1 ? RY : t.m.y_lo + t.ty;
  const int OY = oy1 - oy0;
  const int UY = OY + t.a.y_lo + t.a.y_hi;        // U: UZ planes × UY rows
  const int UZ = oz1 - oz0 + t.a.z_lo + t.a.z_hi;
  T* s_r = s_box;
  T* s_u = s_box + RZ * RY * g.f0;                // U, then the tile's t
  for (int k = threadIdx.x; k < na; k += kThreads) {
    s_a[k] = a_off[k];
    s_ad[k] = box_step(s_a[k], s, g.f0, UY);
  }
  for (int k = threadIdx.x; k < nm; k += kThreads) {
    s_m[k] = m_off[k];
    s_md[k] = box_step(s_m[k], s, g.f0, RY);
  }

  const int H = FRAMED ? h : 0;
  const int L = FRAMED ? len : g.n;
  const int nsy = (g.f1 + t.cy * t.ty - 1) / (t.cy * t.ty);
  const int cl = blockIdx.x / nc;              // the cluster
  const int z0 = ((cl / nsy) * t.cz + iz) * t.tz;   // the tile's 1st plane
  const int y0 = ((cl % nsy) * t.cy + iy) * t.ty;   // ... and row
  const int rz0 = z0 - t.m.z_lo, ry0 = y0 - t.m.y_lo;   // R's row (0, 0)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int nwarps = kThreads / 32;

  // 0. u (w ∘ f) at every U row, 0 outside the frame (never read)
  const int uz0 = rz0 + oz0 - t.a.z_lo, uy0 = ry0 + oy0 - t.a.y_lo;
  for (int r = warp; r < UZ * UY; r += nwarps) {
    const int q0 = H + ((uz0 + r / UY) * g.f1 + uy0 + r % UY) * g.f0;
    T* row = s_u + r * g.f0;
    for (int x = lane; x < g.f0; x += 32) {
      const int q = q0 + x;
      if constexpr (kIsBf16<T>)
        row[x] = from_f<T>(q >= 0 && q < L ? (ZERO ? bf_mul(as_f(u[q]),
                                                            as_f(f[q]))
                                                   : as_f(u[q]))
                                           : 0.f);
      else
        row[x] = q >= 0 && q < L ? (ZERO ? u[q] * f[q] : u[q]) : 0.f;
    }
  }
  __syncthreads();

  // 1. r = f − A u at every R row the block owns inside the frame, A's
  // sum in offset order, skipping neighbours outside the frame; in
  // zero-guess mode the tile rows also write w ∘ f
  for (int r = warp; r < (oz1 - oz0) * OY; r += nwarps) {
    const int bz = oz0 + r / OY, by = oy0 + r % OY;
    const int q0 = H + ((rz0 + bz) * g.f1 + ry0 + by) * g.f0;
    T* row = s_r + (bz * RY + by) * g.f0;
    const T* urow =
        s_u + ((bz - oz0 + t.a.z_lo) * UY + by - oy0 + t.a.y_lo) * g.f0;
    const int lz = bz - t.m.z_lo, ly = by - t.m.y_lo;
    const bool own = ZERO && lz >= 0 && lz < t.tz && ly >= 0 &&
                     ly < t.ty && z0 + lz < g.f2 && y0 + ly < g.f1;
    const bool inside = q0 + t.a_min >= 0 && q0 + g.f0 - 1 + t.a_max < L;
    for (int x = lane; x < g.f0; x += 32) {
      const int q = q0 + x;
      if (!inside && (q < 0 || q >= L)) {
        row[x] = from_f<T>(0.f);
        continue;
      }
      auto nb = [&](int k) { return as_f(urow[x + s_ad[k]]); };
      if constexpr (kIsBf16<T>) {
        // the TPU kernel's r = f − Σ a·u, the sum from 0
        const float ax =
            inside ? row_dot_bf16<false>(q, q, L, na, s_a, L, a, nb)
                   : row_dot_bf16<true>(q, q, L, na, s_a, L, a, nb);
        row[x] = bf_store(bf_sub(as_f(f[q]), ax));
      } else {
        row[x] = inside ? row_sum<false>(f[q], q, q, L, na, s_a, L, a, nb)
                        : row_sum<true>(f[q], q, q, L, na, s_a, L, a, nb);
      }
      if (own) u_out[q - H] = urow[x];
    }
  }
  __syncthreads();

  // 1b. in a cluster: the rest of R from its owners' boxes
  if (nc > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int r = warp; r < RZ * RY; r += nwarps) {
      const int bz = r / RY, by = r % RY;
      if (bz >= oz0 && bz < oz1 && by >= oy0 && by < oy1) continue;
      // the row's place in the cluster's box, its owner, and its row there
      const int Z = bz - t.m.z_lo + iz * t.tz, Y = by - t.m.y_lo + iy * t.ty;
      const int jz = min(max(floor_div(Z, t.tz), 0), t.cz - 1);
      const int jy = min(max(floor_div(Y, t.ty), 0), t.cy - 1);
      const T* src = cluster.map_shared_rank(s_r, jz * t.cy + jy) +
                     ((Z - jz * t.tz + t.m.z_lo) * RY + Y - jy * t.ty +
                      t.m.y_lo) * g.f0;
      T* row = s_r + r * g.f0;
      for (int x = lane; x < g.f0; x += 32) row[x] = src[x];
    }
    cluster.sync();        // no block leaves while another reads its box
  }

  // 2. t = r − Mᵀ r at each tile row into U's space, Mᵀ's sum in offset
  // order, skipping neighbours outside the frame; 0 past the grid's end
  T* s_t = s_u;
  for (int r = warp; r < t.tz * t.ty; r += nwarps) {
    const int lz = r / t.ty, ly = r % t.ty;
    const int z = z0 + lz, y = y0 + ly;
    T* trow = s_t + r * g.f0;
    if (z >= g.f2 || y >= g.f1) {
      for (int x = lane; x < g.f0; x += 32) trow[x] = from_f<T>(0.f);
      continue;
    }
    const T* rrow = s_r + ((lz + t.m.z_lo) * RY + ly + t.m.y_lo) * g.f0;
    const int q0 = H + (z * g.f1 + y) * g.f0;
    const bool inside = q0 + t.m_min >= 0 && q0 + g.f0 - 1 + t.m_max < L;
    for (int x = lane; x < g.f0; x += 32) {
      auto nb = [&](int k) { return as_f(rrow[x + s_md[k]]); };
      const int q = q0 + x;
      if constexpr (kIsBf16<T>) {
        // the TPU kernel's t = r − Σ mᵀ·r, the sum from 0
        const float mr =
            inside ? row_dot_bf16<false>(q, q, L, nm, s_m, L, mt, nb)
                   : row_dot_bf16<true>(q, q, L, nm, s_m, L, mt, nb);
        trow[x] = bf_store(bf_sub(as_f(rrow[x]), mr));
      } else {
        trow[x] = inside
                      ? row_sum<false>(rrow[x], q, q, L, nm, s_m, L, mt, nb)
                      : row_sum<true>(rrow[x], q, q, L, nm, s_m, L, mt, nb);
      }
    }
  }
  __syncthreads();

  // 3. rc = Tᵀ t: a thread per coarse cell sums its children, (pz, py) in
  // order and px = 0 then 1, a child past the grid's end adding 0
  const int ncy = t.ty / 2;
  const int c2 = (g.f2 + 1) / 2;
  for (int c = threadIdx.x; c < t.tz / 2 * ncy * g.c0; c += kThreads) {
    const int cx = c % g.c0, lc = c / g.c0;
    const int lcy = lc % ncy, lcz = lc / ncy;
    const int cz = z0 / 2 + lcz, cy = y0 / 2 + lcy;
    if (cz >= c2 || cy >= g.c1) continue;
    if constexpr (kIsBf16<T>) {
      // the TPU kernel's Tᵀ: the z pair added in bfloat16, then the y
      // pairs and the x pair in float (its float32 HIGHEST dots,
      // pallas_vcycle.py:250-263), then rounded; a child past the grid's
      // end adds 0
      float p2[2][2];
      for (int py = 0; py < 2; ++py) {
        const T* lo = s_t + ((2 * lcz) * t.ty + 2 * lcy + py) * g.f0;
        const T* hi = lo + t.ty * g.f0;
        for (int px = 0; px < 2; ++px) {
          const int x = 2 * cx + px;
          p2[py][px] = x < g.f0 ? bf_add(as_f(lo[x]), as_f(hi[x])) : 0.f;
        }
      }
      rc[(cz * g.c1 + cy) * g.c0 + cx] =
          bf_store(__fadd_rn(__fadd_rn(p2[0][0], p2[1][0]),
                             __fadd_rn(p2[0][1], p2[1][1])));
    } else {
      float sum = 0.f;
      for (int p = 0; p < 4; ++p) {
        const float* trow =
            s_t + ((2 * lcz + (p >> 1)) * t.ty + 2 * lcy + (p & 1)) * g.f0;
        sum += trow[2 * cx] + (2 * cx + 1 < g.f0 ? trow[2 * cx + 1] : 0.f);
      }
      rc[(cz * g.c1 + cy) * g.c0 + cx] = sum;
    }
  }
}

// z_off, f_z: the frame (tile plane z is frame plane z + zoff of fz); m, u
// and uc are frames, a, w, f and out the tile's own. Without FRAMED the
// frame is the tile (zoff = 0, fz = f2), known at compile time. Block b
// takes tile (b / nty, b % nty) of ceil(f1 / ty) tiles a plane band; each
// phase walks whole grid rows, a warp a row and a lane an x.
template <typename T, bool FRAMED>
__global__ void __launch_bounds__(kThreads, 1)
up_kernel(Grid g, int z_off, int f_z, UpTile t, int na, int nm,
          const int* __restrict__ a_off, const T* __restrict__ a,
          const int* __restrict__ m_off, const T* __restrict__ m,
          const T* __restrict__ w, const T* __restrict__ f,
          const T* __restrict__ u, const T* __restrict__ uc,
          T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  T* s_box = reinterpret_cast<T*>(s_dyn);
  __shared__ int s_a[kMaxDiag], s_ad[kMaxDiag];   // A: offset, U distance
  __shared__ int s_m[kMaxDiag], s_md[kMaxDiag];   // M: offset, T distance
  const int s = g.f1 * g.f0;
  const int BY = t.ty + t.a.y_lo + t.a.y_hi;      // U: BZ planes × BY rows
  const int BZ = t.tz + t.a.z_lo + t.a.z_hi;
  const int TY = BY + t.m.y_lo + t.m.y_hi;        // T: TZ planes × TY rows
  const int TZ = BZ + t.m.z_lo + t.m.z_hi;
  T* s_u = s_box;
  T* s_t = s_box + BZ * BY * g.f0;
  for (int k = threadIdx.x; k < na; k += kThreads) {
    s_a[k] = a_off[k];
    s_ad[k] = box_step(s_a[k], s, g.f0, BY);
  }
  for (int k = threadIdx.x; k < nm; k += kThreads) {
    s_m[k] = m_off[k];
    s_md[k] = box_step(s_m[k], s, g.f0, TY);
  }

  const int zoff = FRAMED ? z_off : 0;
  const int fz = FRAMED ? f_z : g.f2;
  const size_t Lm = FRAMED ? static_cast<size_t>(fz) * s
                           : static_cast<size_t>(g.n);
  const int nty = (g.f1 + t.ty - 1) / t.ty;
  const int z0 = (blockIdx.x / nty) * t.tz;    // the tile's first plane
  const int y0 = (blockIdx.x % nty) * t.ty;    // ... and row
  const int bz0 = z0 + zoff - t.a.z_lo;        // frame plane of U's plane 0
  const int by0 = y0 - t.a.y_lo;               // extended row of U's row 0
  const int frame_rows = fz * g.f1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int nwarps = kThreads / 32;

  // 0. T uc at every T row inside the frame (the rest is never read):
  // fine row (z, y, x) takes the coarse cell (z/2, y/2, x/2)
  for (int r = warp; r < TZ * TY; r += nwarps) {
    const int R = (bz0 - t.m.z_lo + r / TY) * g.f1 + by0 - t.m.y_lo + r % TY;
    T* row = s_t + r * g.f0;
    if (R >= 0 && R < frame_rows) {
      const int qz = R / g.f1;
      const T* cu = uc + ((qz >> 1) * g.c1 + ((R - qz * g.f1) >> 1)) * g.c0;
#pragma unroll 4
      for (int x = lane; x < g.f0; x += 32) row[x] = cu[x >> 1];
    } else {
      for (int x = lane; x < g.f0; x += 32) row[x] = from_f<T>(0.f);
    }
  }
  __syncthreads();

  // 1. u' = u + T uc − M (T uc) at every U row inside the frame, M's sum
  // in offset order, skipping neighbours outside the frame
  for (int r = warp; r < BZ * BY; r += nwarps) {
    const int bz = r / BY, by = r % BY;
    const int R = (bz0 + bz) * g.f1 + by0 + by;
    T* row = s_u + r * g.f0;
    if (R < 0 || R >= frame_rows) {
      for (int x = lane; x < g.f0; x += 32) row[x] = from_f<T>(0.f);
      continue;
    }
    const T* trow = s_t + ((bz + t.m.z_lo) * TY + by + t.m.y_lo) * g.f0;
    const int q0 = R * g.f0;
    const bool inside = q0 + t.m_min >= 0 &&
                        static_cast<size_t>(q0 + g.f0 - 1 + t.m_max) < Lm;
    for (int x = lane; x < g.f0; x += 32) {
      auto nb = [&](int k) { return as_f(trow[x + s_md[k]]); };
      if constexpr (kIsBf16<T>) {
        // the TPU kernel's u' = (u + T uc) − Σ m·(T uc), the sum from 0
        const float mt =
            inside ? row_dot_bf16<false>(q0 + x, q0 + x, Lm, nm, s_m, Lm, m,
                                         nb)
                   : row_dot_bf16<true>(q0 + x, q0 + x, Lm, nm, s_m, Lm, m,
                                        nb);
        row[x] = bf_store(
            bf_sub(bf_add(as_f(u[q0 + x]), as_f(trow[x])), mt));
      } else {
        const float uq = u[q0 + x];
        const float p =
            inside ? row_sum<false>(trow[x], q0 + x, q0 + x, Lm, nm, s_m, Lm,
                                    m, nb)
                   : row_sum<true>(trow[x], q0 + x, q0 + x, Lm, nm, s_m, Lm,
                                   m, nb);
        row[x] = uq + p;
      }
    }
  }
  __syncthreads();

  // 2. out = u' + w ∘ (f − A u') at each tile row, A's sum in offset
  // order, skipping neighbours outside the frame
  for (int r = warp; r < t.tz * t.ty; r += nwarps) {
    const int lz = r / t.ty, ly = r % t.ty;
    const int z = z0 + lz, y = y0 + ly;
    if (z >= g.f2 || y >= g.f1) continue;
    const T* urow = s_u + ((lz + t.a.z_lo) * BY + ly + t.a.y_lo) * g.f0;
    const int i0 = (z * g.f1 + y) * g.f0;
    const int q0 = i0 + zoff * s;              // the frame row of x = 0
    const bool inside = q0 + t.a_min >= 0 &&
                        static_cast<size_t>(q0 + g.f0 - 1 + t.a_max) < Lm;
    for (int x = lane; x < g.f0; x += 32) {
      auto nb = [&](int k) { return as_f(urow[x + s_ad[k]]); };
      if constexpr (kIsBf16<T>) {
        // the TPU kernel's u' + w ∘ (f − Σ a·u'), the sum from 0
        const float au =
            inside ? row_dot_bf16<false>(q0 + x, i0 + x, g.n, na, s_a, Lm,
                                         a, nb)
                   : row_dot_bf16<true>(q0 + x, i0 + x, g.n, na, s_a, Lm, a,
                                        nb);
        out[i0 + x] = bf_store(bf_add(
            as_f(urow[x]),
            bf_mul(as_f(w[i0 + x]), bf_sub(as_f(f[i0 + x]), au))));
      } else {
        const float wi = w[i0 + x];
        const float acc =
            inside ? row_sum<false>(f[i0 + x], q0 + x, i0 + x, g.n, na, s_a,
                                    Lm, a, nb)
                   : row_sum<true>(f[i0 + x], q0 + x, i0 + x, g.n, na, s_a,
                                   Lm, a, nb);
        out[i0 + x] = urow[x] + wi * acc;
      }
    }
  }
}

Grid make_grid(int f2, int f1, int f0) {
  Grid g;
  g.f2 = f2; g.f1 = f1; g.f0 = f0;
  g.c1 = (f1 + 1) / 2; g.c0 = (f0 + 1) / 2;
  g.n = f2 * f1 * f0;
  return g;
}

// Lets `kernel` take kMaxBox bytes of dynamic shared memory beside its
// static arrays: above 48 KB (static and dynamic together) only by the
// attribute, set once per instantiation (`raised`) and device.
template <class Kernel>
cudaError_t allow_box(Kernel kernel, bool (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kMaxDevices && raised[dev]) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kMaxBox);
  if (rc == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return rc;
}

// The down leg's launch in element type T (the C entry below checks the
// tile; box: the bytes of its two boxes).
template <typename T>
cudaError_t launch_down(int zero_guess, const Grid& g, int H, int L,
                        const DownTile& t, int na, int nm, long long box,
                        const void* a_off, const void* a, const void* m_off,
                        const void* mt, const void* f, const void* u,
                        void* u_out, void* rc, void* stream) {
  const bool framed = H != 0 || L != g.n;
  const int which = (zero_guess ? 2 : 0) + (framed ? 1 : 0);
  using DownFn = void (*)(Grid, int, int, DownTile, int, int, const int*,
                          const T*, const int*, const T*, const T*,
                          const T*, T*, T*);
  // down_kernel<T, ZERO, FRAMED> at ZERO·2 + FRAMED
  static const DownFn kernels[4] = {
      down_kernel<T, false, false>, down_kernel<T, false, true>,
      down_kernel<T, true, false>, down_kernel<T, true, true>};
  static bool raised[4][kMaxDevices] = {};
  cudaError_t err = allow_box(kernels[which], raised[which]);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(((g.f2 + t.cz * t.tz - 1) / (t.cz * t.tz)) *
                        ((g.f1 + t.cy * t.ty - 1) / (t.cy * t.ty)) * t.cz *
                        t.cy);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(box);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = t.cz * t.cy;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = t.cz * t.cy > 1 ? 1 : 0;
  return cudaLaunchKernelEx(
      &config, kernels[which], g, H, L, t, na, nm,
      static_cast<const int*>(a_off), static_cast<const T*>(a),
      static_cast<const int*>(m_off), static_cast<const T*>(mt),
      static_cast<const T*>(f), static_cast<const T*>(u),
      static_cast<T*>(u_out), static_cast<T*>(rc));
}

// The up leg's launch in element type T, as launch_down.
template <typename T>
cudaError_t launch_up(const Grid& g, int zoff, int fz, const UpTile& t,
                      int na, int nm, long long box, const void* a_off,
                      const void* a, const void* m_off, const void* m,
                      const void* w, const void* f, const void* u,
                      const void* uc, void* out, void* stream) {
  const bool framed = zoff != 0 || fz != g.f2;
  auto kernel = framed ? up_kernel<T, true> : up_kernel<T, false>;
  static bool raised[2][kMaxDevices] = {};
  cudaError_t rc = allow_box(kernel, raised[framed]);
  if (rc != cudaSuccess) return rc;
  const int blocks = ((g.f2 + t.tz - 1) / t.tz) * ((g.f1 + t.ty - 1) / t.ty);
  kernel<<<blocks, kThreads, static_cast<size_t>(box),
           static_cast<cudaStream_t>(stream)>>>(
      g, zoff, fz, t, na, nm, static_cast<const int*>(a_off),
      static_cast<const T*>(a), static_cast<const int*>(m_off),
      static_cast<const T*>(m), static_cast<const T*>(w),
      static_cast<const T*>(f), static_cast<const T*>(u),
      static_cast<const T*>(uc), static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace
}  // namespace amgcl_port

// dtype: 0 = float32, 2 = bfloat16 (the base and zero-guess modes, each
// operation rounded to bfloat16 where the TPU kernel's dtype rounds; not
// framed). Down leg on the tile of fine dims (f2, f1, f0), n rows, inside
// a frame of L rows at offset H (base mode: H = 0, L = n). a/mt: (na, L)
// and (nm, L) DIA data of the dtype with int32 offsets a_off and m_off
// on the device, and a_host and m_host the same offsets on the host; f,
// u: (L,); with zero_guess != 0, u is the smoother scale w and u_out (n,)
// receives w ∘ f. rc: (nc,) with nc = ceil(f2/2)·ceil(f1/2)·ceil(f0/2).
// Blocks of kThreads threads take tiles of tz planes × ty rows (both
// even), in clusters of cz × cy tiles (at most 8; 1 × 1 launches no
// cluster); `halos` holds Mᵀ's halo and then A's (planes below, above,
// rows before, after: DownTile). The call is refused if tz or ty is odd,
// an Mᵀ offset reaches outside R, an A offset outside U, or the boxes
// (their rows of f0 elements of the dtype) pass kMaxBox bytes. The caller
// guarantees L < 2^30, na, nm ≤ 512 and, in a frame, H at least the
// reach of A plus that of Mᵀ. Returns the launch's cudaError_t.
extern "C" int amgcl_fused_down(int dtype, int zero_guess, int f2, int f1,
                                int f0, int H, int L, int na, int nm,
                                const int* a_host, const int* m_host,
                                int tz, int ty, int cz, int cy,
                                const int* halos, const void* a_off,
                                const void* a, const void* m_off,
                                const void* mt, const void* f,
                                const void* u, void* u_out, void* rc,
                                void* stream) {
  using namespace amgcl_port;
  const Grid g = make_grid(f2, f1, f0);
  const bool framed = H != 0 || L != g.n;
  if (na < 1 || na > kMaxDiag || nm < 1 || nm > kMaxDiag || tz < 2 ||
      ty < 2 || tz % 2 || ty % 2 || cz < 1 || cy < 1 || cz * cy > 8 ||
      !(dtype == 0 || (dtype == 2 && !framed)))
    return cudaErrorInvalidValue;
  DownTile t{tz, ty, {halos[0], halos[1], halos[2], halos[3]},
             {halos[4], halos[5], halos[6], halos[7]}, cz, cy, 0, 0, 0, 0};
  const int s = f1 * f0;
  if (!halo_holds_all(t.m, m_host, nm, s, f0, &t.m_min, &t.m_max) ||
      !halo_holds_all(t.a, a_host, na, s, f0, &t.a_min, &t.a_max))
    return cudaErrorInvalidValue;
  const long long rz = tz + t.m.z_lo + t.m.z_hi;
  const long long ry = ty + t.m.y_lo + t.m.y_hi;
  // the most rows of R a block of the cluster forms, and U around them
  // (which the tile's t then takes, as it holds the tile)
  const long long oz =
      cz == 1 ? rz : tz + (t.m.z_lo > t.m.z_hi ? t.m.z_lo : t.m.z_hi);
  const long long oy =
      cy == 1 ? ry : ty + (t.m.y_lo > t.m.y_hi ? t.m.y_lo : t.m.y_hi);
  const long long box =
      (rz * ry + (oz + t.a.z_lo + t.a.z_hi) * (oy + t.a.y_lo + t.a.y_hi)) *
      f0 * (dtype == 2 ? 2LL : 4LL);
  if (box > kMaxBox) return cudaErrorInvalidValue;
  if (dtype == 2)
    return launch_down<bf16>(zero_guess, g, H, L, t, na, nm, box, a_off, a,
                             m_off, mt, f, u, u_out, rc, stream);
  return launch_down<float>(zero_guess, g, H, L, t, na, nm, box, a_off, a,
                            m_off, mt, f, u, u_out, rc, stream);
}

// dtype: 0 = float32, 2 = bfloat16 (the base mode, as amgcl_fused_down).
// Up leg on the tile of fine dims (f2, f1, f0), n rows, inside a frame of
// fz fine planes at plane offset zoff (base mode: zoff = 0, fz = f2).
// a: (na, n) and m: (nm, fz·f1·f0) DIA data of the dtype with int32
// offsets a_off and m_off on the device, and a_host and m_host the same
// offsets on the host; w, f, out: (n,); u: (fz·f1·f0,); uc: the coarse
// vector of the frame, ceil(fz/2) coarse planes. Blocks of kThreads
// threads take tiles of tz planes × ty rows; `halos` holds A's halo
// and then M's (planes below, above, rows before, after: UpTile). The
// call is refused if an A offset reaches outside U, an M offset outside
// T, or the two boxes (rows of f0 elements of the dtype) pass kMaxBox
// bytes. The caller guarantees fz·f1·f0 < 2^30, na, nm ≤ 512 and, in a
// frame, an even zoff and f2 and zoff · f1 · f0 at least the reach of A
// plus that of M.
extern "C" int amgcl_fused_up(int dtype, int f2, int f1, int f0, int zoff,
                              int fz, int na, int nm, const int* a_host,
                              const int* m_host, int tz, int ty,
                              const int* halos,
                              const void* a_off, const void* a,
                              const void* m_off, const void* m,
                              const void* w, const void* f, const void* u,
                              const void* uc, void* out, void* stream) {
  using namespace amgcl_port;
  const bool framed = zoff != 0 || fz != f2;
  if (na < 1 || na > kMaxDiag || nm < 1 || nm > kMaxDiag || tz < 1 ||
      ty < 1 || !(dtype == 0 || (dtype == 2 && !framed)))
    return cudaErrorInvalidValue;
  const Grid g = make_grid(f2, f1, f0);
  UpTile t{tz, ty, {halos[0], halos[1], halos[2], halos[3]},
           {halos[4], halos[5], halos[6], halos[7]},
           a_host[0], a_host[0], m_host[0], m_host[0]};
  if (!halo_holds_all(t.a, a_host, na, f1 * f0, f0, &t.a_min, &t.a_max) ||
      !halo_holds_all(t.m, m_host, nm, f1 * f0, f0, &t.m_min, &t.m_max))
    return cudaErrorInvalidValue;
  const long long bz = tz + t.a.z_lo + t.a.z_hi, by = ty + t.a.y_lo + t.a.y_hi;
  const long long box =
      (bz * by + (bz + t.m.z_lo + t.m.z_hi) * (by + t.m.y_lo + t.m.y_hi)) *
      f0 * (dtype == 2 ? 2LL : 4LL);
  if (box > kMaxBox) return cudaErrorInvalidValue;
  if (dtype == 2)
    return launch_up<bf16>(g, zoff, fz, t, na, nm, box, a_off, a, m_off, m,
                           w, f, u, uc, out, stream);
  return launch_up<float>(g, zoff, fz, t, na, nm, box, a_off, a, m_off, m,
                          w, f, u, uc, out, stream);
}
